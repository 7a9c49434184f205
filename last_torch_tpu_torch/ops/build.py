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

"""Builds the package's CUDA sources into plain-C shared libraries.

Each source under ``csrc/`` is compiled with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with ``ctypes`` (no
PyTorch headers, so a build takes seconds). Builds happen at first use, into
``_build/`` beside this package (listed in ``.gitignore``), named by a hash
of the source, the ``csrc/`` headers it includes and the flags: an edited
source or header rebuilds, an unchanged one loads the library already built.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import re
import subprocess
import tempfile

CSRC = pathlib.Path(__file__).resolve().parent.parent / 'csrc'
BUILD_DIR = pathlib.Path(__file__).resolve().parent.parent / '_build'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')


def _nvcc() -> str:
  from torch.utils import cpp_extension  # finds CUDA_HOME, nvcc on PATH
  if cpp_extension.CUDA_HOME is None:
    raise RuntimeError('nvcc not found: set CUDA_HOME or put nvcc on PATH '
                       'to build the CUDA kernels')
  return os.path.join(cpp_extension.CUDA_HOME, 'bin', 'nvcc')


_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _sources(source: str) -> list[str]:
  """``source`` and the ``csrc/`` headers it includes, transitively."""
  found, todo = [], [source]
  while todo:
    name = todo.pop()
    if name not in found:
      found.append(name)
      todo.extend(m.decode() for m in
                  _LOCAL_INCLUDE.findall((CSRC / name).read_bytes()))
  return found


def library_path(source: str) -> pathlib.Path:
  """Where the library built from ``csrc/<source>`` lives."""
  digest = hashlib.sha256()
  for name in _sources(source):
    digest.update(name.encode() + b'\0' + (CSRC / name).read_bytes())
  digest.update(' '.join(NVCC_FLAGS).encode())
  return BUILD_DIR / f'{pathlib.Path(source).stem}-{digest.hexdigest()[:16]}.so'


def load(source: str) -> ctypes.CDLL:
  """Builds ``csrc/<source>`` if needed and loads it.

  The compiler's output (``-Xptxas -v``: registers, shared memory, spills
  per kernel) is kept beside the library as ``<name>.log``.
  """
  out = library_path(source)
  if not out.exists():
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # Build under a temporary name and rename: concurrent first uses never
    # load a half-written library.
    fd, tmp = tempfile.mkstemp(suffix='.so', dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, '-o', tmp, str(CSRC / source)]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    out.with_suffix('.log').write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
      if os.path.exists(tmp):  # nvcc removes its output when it fails
        os.unlink(tmp)
      raise RuntimeError(f'nvcc failed ({proc.returncode}) building '
                         f'{source}:\n{proc.stderr[-4000:]}')
    os.replace(tmp, out)
  return ctypes.CDLL(str(out))
