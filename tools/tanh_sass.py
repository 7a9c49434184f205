#!/usr/bin/env python3
# Copyright 2026.
#
# Licensed under the Apache License, Version 2.0 (the "License");
# you may not use this file except in compliance with the License.
# You may obtain a copy of the License at
#
#     http://www.apache.org/licenses/LICENSE-2.0
#
# Unless required by applicable law or agreed to in writing, software
# distributed under the License is distributed on an "AS IS" BASIS,
# WITHOUT WARRANTIES OR CONDITIONS OF ANY KIND, either express or implied.
# See the License for the specific language governing permissions and
# limitations under the License.

"""The MUFU operations of one ``tanhf`` in the port's build, from the SASS.

Run on a machine with the CUDA toolkit::

  python3 tools/tanh_sass.py [--library last_torch_tpu_torch/_build/X.so]

It compiles a kernel whose only work is one ``tanhf`` with the port's
``nvcc`` flags (``ops/build.py``), disassembles it with ``cuobjdump
-sass`` and prints its MUFU instructions (``chip_smoke.py::bound`` counts
``MUFU_PER_TANH`` of them per joint entry, at 16 a clock per SM). With
``--library`` it also prints the MUFU instructions per kernel of a built
library. Prints the card's SM clock as ``nvidia-smi`` reports it.
"""

import argparse
import collections
import pathlib
import re
import shutil
import subprocess
import sys
import tempfile

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
from last_torch_tpu_torch.ops import build  # pylint: disable=C0413

PROBE = r'''
extern "C" __global__ void tanh_probe(const float* x, float* y) {
  y[threadIdx.x] = tanhf(x[threadIdx.x]);
}
'''


def cuobjdump():
  nvcc = pathlib.Path(build._nvcc())  # pylint: disable=protected-access
  found = nvcc.parent / 'cuobjdump'
  return str(found) if found.exists() else shutil.which('cuobjdump')


def mufu_by_kernel(sass):
  """{kernel: Counter of MUFU operations} of cuobjdump's SASS listing."""
  out, name = {}, None
  for line in sass.splitlines():
    m = re.search(r'Function : (\S+)', line)
    if m:
      name = m.group(1)
      out[name] = collections.Counter()
    m = re.search(r'\bMUFU\.(\w+)', line)
    if m and name is not None:
      out[name][m.group(1)] += 1
  return out


def main():
  parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  parser.add_argument('--library', help='a built .so to count as well')
  args = parser.parse_args()
  clock = subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit,clocks.max.sm,clocks.sm',
       '--format=csv,noheader'], capture_output=True, text=True,
      check=False).stdout.strip()
  print(f'card (name, power limit, max SM clock, SM clock): {clock}')
  with tempfile.TemporaryDirectory() as tmp:
    src = pathlib.Path(tmp) / 'tanh_probe.cu'
    src.write_text(PROBE)
    cubin = pathlib.Path(tmp) / 'tanh_probe.cubin'
    flags = [f for f in build.NVCC_FLAGS
             if f not in ('-shared', '-Xcompiler', '-fPIC')]
    nvcc = build._nvcc()  # pylint: disable=protected-access
    subprocess.run([nvcc, *flags, '-cubin', '-o', str(cubin), str(src)],
                   check=True, capture_output=True, text=True)
    sass = subprocess.run([cuobjdump(), '-sass', str(cubin)], check=True,
                          capture_output=True, text=True).stdout
  counts = mufu_by_kernel(sass)['tanh_probe']
  print(f'tanhf: {sum(counts.values())} MUFU operations '
        f'({", ".join(f"{k} {v}" for k, v in sorted(counts.items()))})')
  if args.library:
    sass = subprocess.run([cuobjdump(), '-sass', args.library], check=True,
                          capture_output=True, text=True).stdout
    for name, counts in sorted(mufu_by_kernel(sass).items()):
      if counts:
        print(f'{name[:110]}: MUFU '
              + ', '.join(f'{k} {v}' for k, v in sorted(counts.items())))


if __name__ == '__main__':
  main()
