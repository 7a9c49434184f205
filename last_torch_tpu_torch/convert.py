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

"""Parameters of the JAX package as parameters of the port.

The port keeps the JAX package's parameter layout (nested dictionaries and
lists, same keys, same array shapes), so conversion is a walk of the tree.
It takes numpy only: pass ``jax.tree.map(np.asarray, params)``.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


def from_jax_params(tree: Any, device='cuda') -> Any:
  """Turns a tree of numpy arrays (dicts, lists, tuples) into tensors.

  Float arrays become float32 tensors on ``device`` (the card unless the
  caller asks for 'cpu'); integer arrays keep their type. Each leaf is
  copied, so the result owns its memory.
  """
  if isinstance(tree, dict):
    return {k: from_jax_params(v, device) for k, v in tree.items()}
  if isinstance(tree, (list, tuple)):
    return type(tree)(from_jax_params(v, device) for v in tree)
  if not isinstance(tree, (np.ndarray, np.generic)):
    raise TypeError(f'expected numpy arrays, got {type(tree).__name__}')
  array = np.array(tree)  # a copy, also for 0-d leaves
  if np.issubdtype(array.dtype, np.floating):
    array = array.astype(np.float32)
  return torch.from_numpy(array).to(device)
