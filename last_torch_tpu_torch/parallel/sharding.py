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

"""Data- and tensor-parallel GNAT training over a ('data', 'model') mesh.

Counterpart of ``last_torch_tpu/parallel/sharding.py``, on
``torch.distributed``: the caller starts the processes and initializes the
default process group (``init_process_group`` with its address, world size
and rank), and ``make_mesh`` lays the world out as a ``DeviceMesh``.

* data axis: each data rank trains on its own rows of the batch
  (``shard_batch``); gradients are summed over it explicitly. The
  expected-risk step (``make_shard_map_risk_train_step``) is data parallel
  alone.
* model axis: tensor parallelism over the vocabulary. The joint network's
  vocab head ``[h, V]`` (and its bias) is sharded (``GNAT_PARAM_RULES``,
  ``shard_params``), and the lattice loss runs
  ``ops/sharded_scan.py::tp_lattice_loss``: each rank reduces its own shard
  per frame in the ``frame_reduce`` kernels, and only the [B, V/D]
  reductions are gathered.

Where the JAX package lets ``shard_map`` transpose its collectives, the
steps here follow one gradient rule (``TrainStep``): every model rank
computes the same replicated loss, and the gather's VJP sums the
cotangents of all D model ranks, so each rank backpropagates its loss
scaled by 1 / D. Then the vocab shards' gradients are exact on every model
rank and are summed over the data group only; the replicated parameters'
gradients are partial sums that add up over the whole world. The mean is
global: each rank divides its own loss sum by the feasible count summed
over the data group. The clip's global norm takes each vocab shard once.

The encoder stays replicated in the tensor-parallel step, which computes
the same function as the JAX package's Megatron-sharded encoder
(ROADMAP queue 1, item 10, keeps that sharding for
``make_sharded_train_step``).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Optional

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from last_torch_tpu_torch import risk as risk_lib
from last_torch_tpu_torch.models import gnat
from last_torch_tpu_torch.ops import sharded_scan

Params = Any

# Parameter sharding rules: (regex over the leaf path, the mesh axis of each
# dimension). First match wins; everything else is replicated. The JAX
# package's encoder rules (ffn*/qkv/attn_out over 'model') are not ported:
# the tensor-parallel step keeps the encoder replicated.
GNAT_PARAM_RULES = (
    # Joint network vocab head: shard the vocabulary.
    (r'.*weight_fn.*vocab_w$', (None, 'model')),
    (r'.*weight_fn.*vocab_b$', ('model',)),
)


def make_mesh(num_devices: Optional[int] = None, model_parallel: int = 1,
              device_type: str = 'cuda'):
  """A ('data', 'model') ``DeviceMesh`` over the initialized world.

  Args:
    num_devices: The world size, if given (the mesh always spans the
      world: start the processes accordingly).
    model_parallel: Size of the model axis (must divide the world size).
    device_type: 'cuda' (an NCCL group, one card per rank), unless the
      caller asks for 'cpu' (a gloo group).

  Returns:
    A ``torch.distributed.device_mesh.DeviceMesh`` of shape (world /
    model_parallel, model_parallel); rank r sits at (r // model_parallel,
    r % model_parallel).
  """
  from torch.distributed.device_mesh import init_device_mesh
  if not dist.is_initialized():
    raise RuntimeError('make_mesh needs the default process group: call '
                       'torch.distributed.init_process_group first')
  world = dist.get_world_size()
  if num_devices is not None and num_devices != world:
    raise ValueError(f'num_devices={num_devices} is not the world size '
                     f'{world}')
  if model_parallel < 1 or world % model_parallel:
    raise ValueError(f'model_parallel={model_parallel} must divide the '
                     f'device count {world}')
  return init_device_mesh(device_type, (world // model_parallel,
                                        model_parallel),
                          mesh_dim_names=('data', 'model'))


def _axis_size(mesh, name: str) -> int:
  return mesh.shape[mesh.mesh_dim_names.index(name)]


def _path_str(path) -> str:
  parts = []
  for entry in path:
    if hasattr(entry, 'key'):
      parts.append(str(entry.key))
    elif hasattr(entry, 'idx'):
      parts.append(str(entry.idx))
    else:
      parts.append(str(entry))
  return '/'.join(parts)


def _sharded_dim(name: str, leaf) -> Optional[int]:
  for pattern, spec in GNAT_PARAM_RULES:
    if re.match(pattern, name) and leaf.ndim == len(spec):
      return spec.index('model') if 'model' in spec else None
  return None


def param_shardings(params: Params) -> dict[str, Optional[int]]:
  """{leaf path ('lattice/weight_fn/vocab_w', ...): the dimension
  ``GNAT_PARAM_RULES`` shard over the model axis, or None for a replicated
  leaf}."""
  return {_path_str(path): _sharded_dim(_path_str(path), leaf)
          for path, leaf in pytree.tree_flatten_with_path(params)[0]}


def shard_params(params: Params, mesh) -> Params:
  """This rank's parameters: for each sharded leaf the slice at the rank's
  model coordinate, the others whole; every leaf a new contiguous tensor."""
  shards = _axis_size(mesh, 'model')
  index = mesh.get_local_rank('model')
  flat, spec = pytree.tree_flatten_with_path(params)
  out = []
  for path, leaf in flat:
    dim = _sharded_dim(_path_str(path), leaf)
    leaf = leaf.detach()
    if dim is not None:
      if leaf.shape[dim] % shards:
        raise ValueError(f'{_path_str(path)}: dimension {dim} of '
                         f'{tuple(leaf.shape)} does not split into {shards} '
                         'shards')
      size = leaf.shape[dim] // shards
      leaf = leaf.narrow(dim, index * size, size)
    out.append(leaf.contiguous().clone())
  return pytree.tree_unflatten(out, spec)


def gather_params(params: Params, mesh) -> Params:
  """The whole parameters from this rank's ``shard_params`` shards: each
  sharded leaf gathered over the mesh's model axis (a collective: every
  rank calls it), the others as they are; detached."""
  group = mesh.get_group('model')
  shards = _axis_size(mesh, 'model')
  flat, spec = pytree.tree_flatten_with_path(params)
  out = []
  for path, leaf in flat:
    leaf = leaf.detach()
    dim = _sharded_dim(_path_str(path), leaf)
    if dim is not None and shards > 1:
      parts = [torch.empty_like(leaf) for _ in range(shards)]
      dist.all_gather(parts, leaf.contiguous(), group=group)
      leaf = torch.cat(parts, dim=dim)
    out.append(leaf)
  return pytree.tree_unflatten(out, spec)


def shard_batch(batch: Params, mesh) -> Params:
  """This rank's rows of each batch-leading array (tensors or numpy),
  split over the data axis."""
  parts = _axis_size(mesh, 'data')
  index = mesh.get_local_rank('data')

  def rows(x):
    x = torch.as_tensor(x)
    if x.shape[0] % parts:
      raise ValueError(f'a batch of {x.shape[0]} rows does not split over '
                       f'{parts} data ranks')
    size = x.shape[0] // parts
    return x[index * size:(index + 1) * size]

  return pytree.tree_map(rows, batch)


class TrainStep:
  """A GNAT train step over a mesh, as ``gnat.train_step``:
  ``step(state, frames, num_frames, labels, num_labels) -> (state, loss)``
  with this rank's batch rows (``shard_batch``), returning the mean loss of
  the global batch before the update. Parameters update in place.

  Tensor parallel (``make_tp_train_step``): the vocab head is sharded over
  the mesh's model axis and the lattice loss is ``tp_lattice_loss``; data
  parallel (``make_shard_map_train_step``): every parameter is replicated
  and each rank runs ``model.loss``. The gradient rule is the module
  docstring's.
  """

  def __init__(self, model, optimizer, mesh, tensor_parallel: bool):
    self.model = model
    self.optimizer = optimizer
    self.data_group = mesh.get_group('data')
    self.model_group = mesh.get_group('model') if tensor_parallel else None

  def _per_seq_loss(self, params, frames, num_frames, labels, num_labels):
    if self.model_group is None:
      return self.model.loss(params, frames, num_frames, labels, num_labels)
    device = self.model.device
    frames = torch.as_tensor(frames, dtype=torch.float32, device=device)
    num_frames = torch.as_tensor(num_frames, device=device)
    encoded = self.model.encoder.apply(params['encoder'], frames, num_frames)
    return sharded_scan.tp_lattice_loss(
        self.model.lattice, params['lattice'], encoded, num_frames,
        torch.as_tensor(labels, device=device),
        torch.as_tensor(num_labels, device=device), group=self.model_group)

  def _leaves(self, params):
    """[(leaf, sharded over the model axis)]."""
    return [(leaf, self.model_group is not None and
             _sharded_dim(_path_str(path), leaf) is not None)
            for path, leaf in pytree.tree_flatten_with_path(params)[0]]

  def loss_and_grads(self, state: gnat.GNATTrainState, frames, num_frames,
                     labels, num_labels) -> torch.Tensor:
    """The global batch's mean loss; leaves this rank's gradients, reduced
    over the mesh and not yet clipped, in the parameters' ``.grad``."""
    state.opt_state.adamw.zero_grad(set_to_none=True)
    per_seq = self._per_seq_loss(state.params, frames, num_frames, labels,
                                 num_labels)
    finite = torch.isfinite(per_seq)
    count = finite.sum()
    dist.all_reduce(count, group=self.data_group)
    local = torch.where(finite, per_seq, 0.0).sum() / count.clamp(min=1)
    shards = 1 if self.model_group is None else self.model_group.size()
    (local / shards).backward()
    for leaf, sharded in self._leaves(state.params):
      if leaf.grad is None:
        leaf.grad = torch.zeros_like(leaf)
      # Replicated leaves of the tensor-parallel step sum over the world
      # (the default group); everything else over the data axis.
      replicated_tp = self.model_group is not None and not sharded
      dist.all_reduce(leaf.grad,
                      group=None if replicated_tp else self.data_group)
    loss = local.detach().clone()
    dist.all_reduce(loss, group=self.data_group)
    return loss

  def __call__(self, state: gnat.GNATTrainState, frames, num_frames, labels,
               num_labels) -> tuple[gnat.GNATTrainState, torch.Tensor]:
    loss = self.loss_and_grads(state, frames, num_frames, labels, num_labels)
    total_norm = None
    if self.model_group is not None:

      def total_norm():
        """The global norm of the gradients the update runs on (the mean
        over the micro-steps when they accumulate): each shard once."""
        squares = {True: 0.0, False: 0.0}
        for leaf, sharded in self._leaves(state.params):
          squares[sharded] = squares[sharded] + leaf.grad.square().sum()
        shard_squares = torch.as_tensor(squares[True], device=loss.device)
        dist.all_reduce(shard_squares, group=self.model_group)
        return (squares[False] + shard_squares).sqrt()

    self.optimizer.apply_gradients(state.opt_state, total_norm)
    return dataclasses.replace(state, step=state.step + 1), loss


def make_tp_train_step(model, optimizer, mesh):
  """Tensor-parallel train step with the lattice loss vocab-sharded.

  Each rank holds its shard of the joint network's vocab head and computes
  the denominator with the per-frame ``frame_reduce`` kernels
  (``ops/sharded_scan.py``), gathering only the [B, V/D] reductions over
  the model axis; the numerator runs on the gathered head. The encoder is
  replicated.

  Args:
    model: ``models.gnat.GNATModel``; its lattice must be covered by
      ``sharded_scan.tp_supported``.
    optimizer: ``gnat.make_optimizer``'s AdamW.
    mesh: ('data', 'model') mesh from ``make_mesh``.

  Returns:
    (train_step_fn, shard_state_fn): the ``TrainStep``, and a function that
    turns a fresh ``GNATTrainState`` (full parameters, no step taken) into
    this rank's sharded state with its own optimizer state.
  """
  if not sharded_scan.tp_supported(model.lattice):
    raise ValueError('model.lattice is not covered by the tensor-parallel '
                     'lattice loss')

  def shard_state(state: gnat.GNATTrainState) -> gnat.GNATTrainState:
    if state.step:
      raise ValueError('shard_state takes a state before its first step: '
                       'AdamW moments are not sharded')
    params = shard_params(state.params, mesh)
    for leaf in pytree.tree_leaves(params):
      leaf.requires_grad_(True)
    return gnat.GNATTrainState(
        params=params, opt_state=optimizer.init(params), step=0,
        shard=(mesh.get_local_rank('model'), _axis_size(mesh, 'model')))

  return TrainStep(model, optimizer, mesh, tensor_parallel=True), shard_state


def make_shard_map_train_step(model, optimizer, mesh) -> TrainStep:
  """Data-parallel train step: each rank runs the loss and its gradient
  (through the lattice kernels) on its own batch rows, and the loss sum,
  the feasible count and the gradients are summed over the mesh's data
  axis. Parameters and optimizer state are replicated: every rank starts
  from the same state."""
  return TrainStep(model, optimizer, mesh, tensor_parallel=False)


class RiskTrainStep:
  """The data-parallel expected-risk (MWER) step
  (``make_shard_map_risk_train_step``): ``step(state, frames, num_frames,
  labels, num_labels, generator) -> (state, metrics)`` with this rank's
  batch rows, metrics as ``gnat.risk_train_step``'s."""

  def __init__(self, model, optimizer, mesh, num_samples: int,
               estimator: str, nll_weight: float):
    self.model = model
    self.optimizer = optimizer
    self.data_group = mesh.get_group('data')
    self.data_rank = mesh.get_local_rank('data')
    self.data_size = _axis_size(mesh, 'data')
    self.num_samples = num_samples
    self.estimator = estimator
    self.nll_weight = nll_weight

  def loss_and_grads(self, state: gnat.GNATTrainState, frames, num_frames,
                     labels, num_labels, generator) -> dict:
    """The global batch's metrics; leaves this rank's gradients, summed
    over the data axis and not yet clipped, in the parameters' ``.grad``."""
    model, device = self.model, self.model.device
    frames = torch.as_tensor(frames, dtype=torch.float32, device=device)
    num_frames = torch.as_tensor(num_frames, device=device)
    labels = torch.as_tensor(labels, device=device)
    num_labels = torch.as_tensor(num_labels, device=device)
    params = state.params
    state.opt_state.adamw.zero_grad(set_to_none=True)
    local_batch = num_frames.shape[0]
    global_batch = local_batch * self.data_size
    encoded = model.encoder.apply(params['encoder'], frames, num_frames)
    cache = model.lattice.build_cache(params['lattice'])
    # The rows' generators from their global indices: the samples are the
    # single-device step's.
    row_keys = risk_lib.per_example_keys(generator, local_batch,
                                         offset=self.data_rank * local_batch)
    er, aux = risk_lib.sampled_risk_loss_per_example(
        model.lattice, params['lattice'], encoded, num_frames, labels,
        num_labels, row_keys, num_samples=self.num_samples,
        estimator=self.estimator, cache=cache)
    sums = [aux['mean_risk'].sum().detach()]
    local = er.sum() / global_batch
    if self.nll_weight:
      per_seq = model.lattice(params['lattice'], frames=encoded,
                              num_frames=num_frames, labels=labels,
                              num_labels=num_labels, cache=cache)
      finite = torch.isfinite(per_seq)
      count = finite.sum()
      dist.all_reduce(count, group=self.data_group)
      nll_local = torch.where(finite, per_seq, 0.0).sum() / count.clamp(min=1)
      sums.append(nll_local.detach())
      local = local + self.nll_weight * nll_local
    local.backward()
    for leaf in pytree.tree_leaves(params):
      if leaf.grad is None:
        leaf.grad = torch.zeros_like(leaf)
      dist.all_reduce(leaf.grad, group=self.data_group)
    sums = torch.stack(sums + [local.detach()])
    dist.all_reduce(sums, group=self.data_group)
    metrics = {'mean_risk': sums[0] / global_batch, 'loss': sums[-1]}
    if self.nll_weight:
      metrics['nll'] = sums[1]
    return metrics

  def __call__(self, state: gnat.GNATTrainState, frames, num_frames, labels,
               num_labels, generator) -> tuple[gnat.GNATTrainState, dict]:
    metrics = self.loss_and_grads(state, frames, num_frames, labels,
                                  num_labels, generator)
    self.optimizer.apply_gradients(state.opt_state)
    return dataclasses.replace(state, step=state.step + 1), metrics


def make_shard_map_risk_train_step(model, optimizer, mesh,
                                   num_samples: int = 4,
                                   estimator: str = 'mwer',
                                   nll_weight: float = 0.0) -> RiskTrainStep:
  """Data-parallel expected-risk (MWER) train step.

  Each rank encodes its rows of the batch, draws exact posterior path
  samples with one generator per global batch row
  (``risk.per_example_keys`` with ``offset = data rank * local batch``,
  every rank's ``generator`` in the same state), and computes its share of
  the expected risk (and of the NLL term, over the feasible count summed
  over the data axis). The gradients and the metrics are summed over the
  data axis, so the step equals the single-device
  ``gnat.risk_train_step(..., per_example_keys=True)`` up to the order of
  the float sums. Parameters and optimizer state are replicated.

  Returns:
    A ``RiskTrainStep``: ``step(state, frames, num_frames, labels,
    num_labels, generator) -> (state, metrics)``.
  """
  return RiskTrainStep(model, optimizer, mesh, num_samples, estimator,
                       nll_weight)
