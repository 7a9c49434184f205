"""One short run of each cell on the card, through the command the
benchmark's checks run. Skips without a CUDA card."""

import json
import subprocess
import sys

import pytest

from portbench.harness import spec
from portbench.tests import tiny

CELLS = [w['name'] for w in
         spec.read_json(tiny.ROOT / 'BENCHMARK.json')['workloads']]


@pytest.fixture
def card():
  import torch
  if not torch.cuda.is_available():
    pytest.skip('needs an NVIDIA GPU: the port runs its CUDA kernels there')


@pytest.mark.cuda
@pytest.mark.parametrize('name', CELLS)
def test_a_short_run_is_correct(card, name):
  out = subprocess.run(
      [sys.executable, 'portbench/run.py', '--workload', name, '--seed',
       str(2**31 + 99), '--seconds', '2', '--trace', '0'],
      capture_output=True, text=True, timeout=1200, cwd=tiny.ROOT,
      check=True).stdout
  result = json.loads(out.strip().splitlines()[-1])
  assert result['correct'], result['compared']
  assert result['device']['platform'] == 'gpu'
