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

"""Checkpoint and resume for GNAT training state, PyTorch port.

Counterpart of ``last_torch_tpu/utils/checkpoint.py``, on
``torch.distributed.checkpoint`` where the JAX package uses orbax. A
checkpoint is one directory per step (``<directory>/<step>``), written to a
temporary directory and renamed into place, so a crash never leaves a
partial step behind. It holds a flat dictionary of tensors: for a
``models.gnat.GNATTrainState``, the parameters, AdamW's moments and step
counts, the number of updates (the schedule's position), the accumulated
gradients and micro-step count when gradients accumulate, and the step.
Every rank of a process group calls ``save`` and ``restore``: replicated
leaves are written once, and the shards of a sharded state
(``GNATTrainState.shard``: the vocab head and the Megatron encoder leaves
of ``parallel.sharding.GNAT_PARAM_RULES``) each under a key of their own,
so each rank reads its shard back. A tensor-parallel checkpoint written
when those rules sharded the vocab head alone does not restore into a
state of these rules: its encoder leaves have no shard keys. Orbax checkpoints of the JAX package are not read:
``convert.from_jax_params`` is the bridge between the packages.
"""

from __future__ import annotations

import contextlib
import os
import shutil
import warnings
from typing import Any, Optional

import torch
import torch.distributed as dist
import torch.distributed.checkpoint as dcp
from torch.utils import _pytree as pytree

from last_torch_tpu_torch.parallel import sharding


def _distributed() -> bool:
  return dist.is_available() and dist.is_initialized()


def _barrier() -> None:
  if _distributed():
    dist.barrier()


@contextlib.contextmanager
def _single_process_quiet():
  """Silences DCP's notice that it runs in one process (it is told so)."""
  with warnings.catch_warnings():
    if not _distributed():
      warnings.filterwarnings('ignore', message='torch.distributed is '
                              'disabled, unavailable or uninitialized')
    yield


def _is_writer() -> bool:
  """Rank 0 of the group (or the only process) renames and deletes."""
  return not _distributed() or dist.get_rank() == 0


def _flat_tree(tree: Any, prefix: str) -> dict[str, torch.Tensor]:
  """{prefix/leaf path: the leaf's tensor, detached (same storage)}."""
  return {f'{prefix}/{sharding._path_str(path)}': leaf.detach()
          for path, leaf in pytree.tree_flatten_with_path(tree)[0]}


def _is_train_state(state: Any) -> bool:
  return all(hasattr(state, a) for a in ('params', 'opt_state', 'step'))


def _train_state_tensors(state) -> tuple[dict[str, torch.Tensor],
                                         dict[str, torch.Tensor]]:
  """(checkpoint entries, scalar counters) of a GNATTrainState.

  The entries are the state's own tensors (loading writes into them); AdamW
  moments that do not exist yet (no update taken) are created as zeros, the
  state a fresh AdamW starts from. The counters are 0-d int64 tensors read
  back after a load.
  """
  params = state.params
  opt = state.opt_state
  sharded = set()
  suffix = ''
  if state.shard is not None:
    sharded = {name for name, dim in sharding.param_shardings(params).items()
               if dim is not None}
    suffix = '.shard{}of{}'.format(*state.shard)
  key = lambda name: name + suffix if name in sharded else name
  flat: dict[str, torch.Tensor] = {}
  named = [(sharding._path_str(path), leaf) for path, leaf in
           pytree.tree_flatten_with_path(params)[0]]
  for i, (name, leaf) in enumerate(named):
    moments = opt.adamw.state[leaf]
    if not moments:
      moments.update(step=torch.tensor(0.0),
                     exp_avg=torch.zeros_like(leaf, requires_grad=False),
                     exp_avg_sq=torch.zeros_like(leaf, requires_grad=False))
    flat[f'params/{key(name)}'] = leaf.detach()
    for field in ('exp_avg', 'exp_avg_sq', 'step'):
      flat[f'opt/{field}/{key(name)}'] = moments[field]
    if opt.acc is not None:
      flat[f'opt/acc/{key(name)}'] = opt.acc[i]
  counters = {'step': torch.tensor(int(state.step)),
              'opt/updates': torch.tensor(opt.schedule.last_epoch),
              'opt/mini_step': torch.tensor(opt.mini_step)}
  return flat, counters


def _tensors(state: Any):
  """(entries, counters) of a train state or of a tree of tensors."""
  if _is_train_state(state):
    return _train_state_tensors(state)
  return _flat_tree(state, 'tree'), {}


def _save(path: str, state: Any) -> None:
  """Writes state to path atomically (a collective under a process
  group)."""
  entries, counters = _tensors(state)
  tmp = path + '.tmp'
  if _is_writer():
    shutil.rmtree(tmp, ignore_errors=True)
  _barrier()
  with _single_process_quiet():
    dcp.save({**entries, **counters}, checkpoint_id=tmp,
             no_dist=not _distributed())
  _barrier()
  if _is_writer():
    shutil.rmtree(path, ignore_errors=True)
    os.replace(tmp, path)
  _barrier()


def _load_train_state(path: str, template):
  """Loads path into template (a GNATTrainState) in place."""
  entries, counters = _train_state_tensors(template)
  with torch.no_grad(), _single_process_quiet():
    dcp.load({**entries, **counters}, checkpoint_id=path,
             no_dist=not _distributed())
  opt = template.opt_state
  opt.mini_step = int(counters['opt/mini_step'])
  # A schedule at update n: rebuilt with last_epoch n - 1, whose first step
  # sets the learning rate of update n.
  opt.schedule = torch.optim.lr_scheduler.LambdaLR(
      opt.adamw, opt.schedule.lr_lambdas[0],
      last_epoch=int(counters['opt/updates']) - 1)
  template.step = int(counters['step'])
  return template


class CheckpointManager:
  """Saves and restores training state with retention.

  Example:
    manager = CheckpointManager('/tmp/run1', max_to_keep=3)
    manager.save(step, state)
    state = manager.restore(template=state)  # the latest step
  """

  def __init__(self, directory: str, max_to_keep: int = 3):
    self._directory = os.path.abspath(directory)
    self._max_to_keep = max_to_keep
    if _is_writer():
      os.makedirs(self._directory, exist_ok=True)
    _barrier()

  @property
  def directory(self) -> str:
    return self._directory

  def save(self, step: int, state: Any) -> None:
    """Saves the state (a GNATTrainState or a tree of tensors) under
    step, then deletes the oldest steps beyond max_to_keep."""
    _save(os.path.join(self._directory, str(int(step))), state)
    if _is_writer() and self._max_to_keep:
      for old in self.all_steps()[:-self._max_to_keep]:
        shutil.rmtree(os.path.join(self._directory, str(old)))
    _barrier()

  def latest_step(self) -> Optional[int]:
    steps = self.all_steps()
    return steps[-1] if steps else None

  def all_steps(self) -> list[int]:
    """The saved steps, ascending."""
    if not os.path.isdir(self._directory):
      return []
    return sorted(int(name) for name in os.listdir(self._directory)
                  if name.isdigit())

  def restore(self, template: Any, step: Optional[int] = None) -> Any:
    """Restores a state shaped like template.

    Args:
      template: A GNATTrainState (e.g. a freshly initialized one, sharded
        as the saved one was), which is loaded in place and returned: its
        parameters, AdamW moments and counts, schedule, accumulated
        gradients and step; or a tree of tensors, for which a new tree is
        returned.
      step: The step to restore; the latest if None.
    """
    if step is None:
      step = self.latest_step()
    if step is None:
      raise ValueError(f'No checkpoints found in {self._directory}')
    path = os.path.join(self._directory, str(int(step)))
    if _is_train_state(template):
      return _load_train_state(path, template)
    return restore_pytree(path, template)

  def close(self) -> None:
    """Nothing is left open: every save finishes before it returns."""


def save_pytree(path: str, tree: Any) -> None:
  """One-shot save of a tree of tensors to a directory."""
  _save(os.path.abspath(path), tree)


def restore_pytree(path: str, template: Any) -> Any:
  """One-shot restore of a tree saved by ``save_pytree``: a new tree of
  the template's structure, shapes, types and devices."""
  flat, spec = pytree.tree_flatten_with_path(template)
  out = [torch.empty_like(leaf, requires_grad=False) for _, leaf in flat]
  entries = {f'tree/{sharding._path_str(path)}': leaf
             for (path, _), leaf in zip(flat, out)}
  with _single_process_quiet():
    dcp.load(entries, checkpoint_id=os.path.abspath(path),
             no_dist=not _distributed())
  return pytree.tree_unflatten(out, spec)
