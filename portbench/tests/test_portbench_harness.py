"""The harness as data, its imports, and a run's verdict with the timed path
broken underneath (on the CPU: the look for a card skipped)."""

import json
import shutil
import subprocess
import sys
import time

import pytest
import torch

from portbench import calibrate
from portbench.harness import core, port, spec
from portbench.tests import tiny

ROOT = tiny.ROOT
CELLS = [w['name'] for w in
         spec.read_json(ROOT / 'BENCHMARK.json')['workloads']]
SEED = 2**31 + 4242


def run_tiny(cell, seconds=0.5):
  result, numbers, _ = core.run(cell, SEED, seconds, False,
                                torch.device('cpu'), time.perf_counter())
  return result, {n['name']: n for n in numbers}


def test_forbidden_names_are_compared_whole(monkeypatch):
  for name in ('last_torch_tpu_torch', 'last_torch_tpu_torch.ops',
               'jaxtyping', 'flaxen'):
    monkeypatch.setitem(sys.modules, name, sys)
  assert core.forbidden_modules() == []
  for name in ('jax', 'jaxlib.xla_client', 'flax.linen',
               'last_torch_tpu.ops'):
    monkeypatch.setitem(sys.modules, name, sys)
  assert core.forbidden_modules() == ['flax.linen', 'jax',
                                      'jaxlib.xla_client',
                                      'last_torch_tpu.ops']


IMPORTS = '''
import sys, time, torch
sys.path.insert(0, {root!r})
from portbench.harness import core
from portbench.tests import tiny
cell = tiny.cell({name!r})
core.run(cell, 5, 0.2, False, torch.device('cpu'), time.perf_counter())
print(sorted(n for n in sys.modules if n.split('.')[0] in
             ('jax', 'jaxlib', 'flax', 'last_torch_tpu')))
'''


@pytest.mark.parametrize('name', CELLS)
def test_a_cells_run_loads_no_jax(name):
  out = subprocess.run([sys.executable, '-c', IMPORTS.format(
      root=str(ROOT), name=name)], capture_output=True, text=True,
      timeout=600, check=True, cwd=ROOT).stdout
  assert out.strip().splitlines()[-1] == '[]'


REFERENCE = '''
import sys, torch
sys.path.insert(0, {root!r})
from portbench.reference import gnat
x = torch.randn(2, 5, 3)
print(gnat.layer_norm(x, 1.0, 0.0).shape, gnat.rounded(x, torch.bfloat16).dtype)
print(sorted(n for n in sys.modules if n.split('.')[0] in
             ('jax', 'jaxlib', 'flax', 'last_torch_tpu',
              'last_torch_tpu_torch')))
'''


def test_the_reference_loads_nothing_of_the_program():
  out = subprocess.run([sys.executable, '-c', REFERENCE.format(
      root=str(ROOT))], capture_output=True, text=True, timeout=300,
      check=True, cwd=ROOT).stdout
  assert out.strip().splitlines()[-1] == '[]'


def test_new_pieces_are_found_by_name(tmp_path):
  """A configuration, mix, metric, limits and cell added as files and
  BENCHMARK.json entries are picked up with no edit to a file there."""
  root = tmp_path / 'checkout'
  shutil.copytree(ROOT / 'portbench', root / 'portbench',
                  ignore=shutil.ignore_patterns('__pycache__'))
  shutil.copy(ROOT / 'BENCHMARK.json', root / 'BENCHMARK.json')
  before = {p: p.read_bytes() for p in (root / 'portbench').rglob('*')
            if p.is_file()}
  bench_dir = root / 'portbench'
  config = spec.read_json(bench_dir / 'configs' /
                          'gnat_global_bigram_v1024.json')
  config.update(tiny.TINY_CONFIG, name='tiny_bigram')
  (bench_dir / 'configs' / 'tiny_bigram.json').write_text(json.dumps(config))
  mix = spec.read_json(bench_dir / 'traffic' / 'decode_b384.json')
  mix.update(batch=2, pool=3, max_frames=16, check_utterances=3)
  mix['lengths'].update(low=5, high=16)
  (bench_dir / 'traffic' / 'tiny_decode.json').write_text(json.dumps(mix))
  (bench_dir / 'metrics' / 'calls.decode.py').write_text(
      'def read(ctx):\n  return ctx.window["units"]\n')
  (bench_dir / 'limits' / 'tiny_cell.json').write_text(json.dumps(
      {'malformed': {'limit': 0}, 'weight_gap': {'limit': 1e-4},
       'rescore_gap': {'limit': 1e-4}}))
  bench = spec.read_json(root / 'BENCHMARK.json')
  bench['configs'].append({'name': 'tiny_bigram', 'source': 'a test',
                           'file': 'portbench/configs/tiny_bigram.json',
                           'reduced': [], 'why': 'a test'})
  bench['workloads'].append({'name': 'tiny_cell', 'config': 'tiny_bigram',
                             'traffic': 'tiny_decode', 'chips': 1,
                             'why': 'a test'})
  bench['per_layer'].append({'name': 'calls.decode', 'unit': 'calls',
                             'better': 'higher', 'source': 'host_clock',
                             'layer': 'model step',
                             'moves': 'decode_frames_per_s',
                             'workloads': ['tiny_cell']})
  for metric in bench['end_to_end']:
    if metric['name'].startswith('decode_'):
      metric['workloads'].append('tiny_cell')
  (root / 'BENCHMARK.json').write_text(json.dumps(bench))

  cell = spec.load_cell('tiny_cell', root, bench_dir)
  assert cell.config['vocab_size'] == tiny.TINY_CONFIG['vocab_size']
  assert cell.traffic['pool'] == 3
  # Metrics that list their cells keep to them.
  assert {m['name'] for m in cell.per_layer} == {'calls.decode'}
  assert {m['name'] for m in cell.end_to_end} == {
      'decode_frames_per_s', 'setup_s'}
  result, numbers = run_tiny(cell, seconds=0.3)
  assert result['correct'], numbers
  reader = spec.metric_reader(cell, 'calls.decode')
  assert reader(core.Context(cell, None, {'units': 7}, None, 'cpu')) == 7
  for path, data in before.items():
    assert path.read_bytes() == data


@pytest.mark.parametrize('name', CELLS)
def test_sound_tiny_runs_are_correct(name):
  result, numbers = run_tiny(tiny.cell(name))
  assert result['correct'], numbers
  assert result['failed'] == 0 and result['attempted'] > 0


@pytest.mark.parametrize('name', CELLS)
@pytest.mark.parametrize('fault', ['label', 'weight', 'half_batch'])
def test_decode_faults_fail(monkeypatch, name, fault):
  gnat = port.gnat()
  decode = gnat.GNATModel.decode

  def broken(self, params, frames, num_frames):
    if fault == 'half_batch':
      # The first half of the batch decoded, the rest left as zeros.
      half = frames.shape[0] // 2
      part = decode(self, params, frames[:half], num_frames[:half])
      return tuple(torch.cat([x, torch.zeros_like(x[:1]).expand(
          frames.shape[0] - half, *x.shape[1:])]) for x in part)
    labels, num_labels, weights = decode(self, params, frames, num_frames)
    labels, weights = labels.clone(), weights.clone()
    if fault == 'label':
      # The first frame's first slot: another label than it holds.
      labels[:, 0] = labels[:, 0] % self.config.vocab_size + 1
    else:
      weights += 1.0
    return labels, num_labels, weights

  monkeypatch.setattr(gnat.GNATModel, 'decode', broken)
  result, numbers = run_tiny(tiny.cell(name))
  assert not result['correct'], numbers


@pytest.mark.parametrize('name', CELLS)
def test_a_nan_reference_fails(monkeypatch, name):
  """A NaN on the reference's side reads as not correct, wherever among
  the compared utterances it falls."""
  from portbench.reference import gnat as reference
  viterbi = reference.viterbi

  def nan_first(*args, **kwargs):
    best, path = viterbi(*args, **kwargs)
    best = best.clone()
    best[0] = float('nan')
    return best, path

  monkeypatch.setattr(reference, 'viterbi', nan_first)
  result, numbers = run_tiny(tiny.cell(name))
  assert not result['correct'], numbers
  assert numbers['weight_gap']['value'] != numbers['weight_gap']['value']


@pytest.mark.parametrize('name', CELLS)
def test_the_control_fails_the_limits(name):
  """The reference one precision below the configuration's, in the
  program's place, fails at least one of the cell's numbers."""
  cell = tiny.cell(name)
  driver = spec.driver(cell)
  control = cell.config['controls'][cell.traffic['driver']]
  numbers = calibrate.control_decode(cell, driver, SEED, torch.device('cpu'),
                                     control, 0.2)
  assert any(n['value'] > cell.limits[n['name']]['limit'] for n in numbers)
