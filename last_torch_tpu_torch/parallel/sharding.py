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
* model axis: tensor parallelism by ``GNAT_PARAM_RULES``. The joint
  network's vocab head ``[h, V]`` (and its bias) is sharded over the
  vocabulary, and the encoder Megatron style: each rank holds the columns
  of ``qkv`` of its H / D heads (from each of q, k and v: a contiguous 1/D
  of [d, 3d] would cross them) and the matching rows of ``attn_out``, and
  1/D of the FFN columns (``ffn_in``, ``ffn1_in``) and rows (``ffn_out``,
  ``ffn1_out``). ``make_tp_train_step`` runs the lattice loss through
  ``ops/sharded_scan.py::tp_lattice_loss`` (each rank reduces its own
  vocab shard per frame in the ``frame_reduce`` kernels, and only the
  [B, V/D] reductions are gathered); ``make_sharded_train_step`` runs
  ``model.lattice`` by its own route on every model rank, on the vocab head
  gathered from the shards.

Where the JAX package lets ``shard_map`` and XLA transpose its
collectives, the steps here follow one gradient rule (``TrainStep``):
every model rank computes the same replicated loss and backpropagates it
scaled by 1 / D, so the cotangent of a replicated activation on each rank
is a partial, and the ranks' partials add up to it. Each vocab gather's
VJP sums the model ranks' cotangents, and so does the sum that closes each
row-parallel product of the encoder (``_ModelSum``: an all-reduce whose
backward is an all-reduce); the replicated input of the column-parallel
products needs no collective, its backward being the identity. Then the
sharded leaves' gradients are exact on every model rank and are summed
over the data group only; the replicated leaves' gradients are partial
sums that add up over the whole world. The mean is global: each rank
divides its own loss sum by the feasible count summed over the data group.
The clip's global norm takes each shard once.

The time-sharded steps are ``parallel/sequence.py``'s, the pipelined ones
``parallel/pipeline.py``'s.
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
# dimension). First match wins; everything else is replicated.
GNAT_PARAM_RULES = (
    # Joint network vocab head: shard the vocabulary.
    (r'.*weight_fn.*vocab_w$', (None, 'model')),
    (r'.*weight_fn.*vocab_b$', ('model',)),
    # Encoder: Megatron-style FFN / attention sharding. The Conformer
    # macaron FFN (ffn1) shards the same way; its convolution-module
    # parameters (conv_in/conv_depth/conv_out) stay replicated on
    # purpose: conv_in's GLU pairs columns [0:d] with [d:2d], which a
    # contiguous column split would cross-shard, and the three tensors
    # together are small relative to the FFNs.
    (r'.*ffn1?_in$', (None, 'model')),
    (r'.*ffn1?_out$', ('model', None)),
    (r'.*qkv$', (None, 'model')),
    (r'.*attn_out$', ('model', None)),
)

# Leaves that split into equal blocks along their sharded dimension, each
# block sharded alike: qkv's q, k and v, so that a shard holds whole heads.
_BLOCKS = {'qkv': 3}


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


def _blocks(name: str) -> int:
  return _BLOCKS.get(name.rsplit('/', 1)[-1], 1)


def param_shardings(params: Params) -> dict[str, Optional[int]]:
  """{leaf path ('lattice/weight_fn/vocab_w', ...): the dimension
  ``GNAT_PARAM_RULES`` shard over the model axis, or None for a replicated
  leaf}."""
  return {_path_str(path): _sharded_dim(_path_str(path), leaf)
          for path, leaf in pytree.tree_flatten_with_path(params)[0]}


def shard_params(params: Params, mesh) -> Params:
  """This rank's parameters: for each sharded leaf the slice at the rank's
  model coordinate (of each of q, k and v for ``qkv``: whole heads), the
  others whole; every leaf a new contiguous tensor."""
  shards = _axis_size(mesh, 'model')
  index = mesh.get_local_rank('model')
  flat, spec = pytree.tree_flatten_with_path(params)
  out = []
  for path, leaf in flat:
    name = _path_str(path)
    dim = _sharded_dim(name, leaf)
    leaf = leaf.detach()
    if dim is not None:
      blocks = _blocks(name)
      if leaf.shape[dim] % (blocks * shards):
        raise ValueError(f'{name}: dimension {dim} of {tuple(leaf.shape)} '
                         f'does not split into {blocks} x {shards} shards')
      size = leaf.shape[dim] // (blocks * shards)
      leaf = torch.cat([block.narrow(dim, index * size, size)
                        for block in leaf.chunk(blocks, dim)], dim)
    out.append(leaf.contiguous().clone())
  return pytree.tree_unflatten(out, spec)


def join_shards(name: str, parts, dim: int) -> torch.Tensor:
  """The whole leaf ``name`` from its ``shard_params`` shards, in model
  rank order, sharded along ``dim`` (``gather_params`` of one leaf)."""
  blocks = _blocks(name)
  pieces = [part.chunk(blocks, dim) for part in parts]
  return torch.cat([piece[b] for b in range(blocks) for piece in pieces],
                   dim)


def gather_params(params: Params, mesh) -> Params:
  """The whole parameters (or any tree of their shape, e.g. gradients) from
  this rank's ``shard_params`` shards: each sharded leaf gathered over the
  mesh's model axis (a collective: every rank calls it), the others as
  they are; detached. ``gather_params(shard_params(p))`` is p exactly."""
  group = mesh.get_group('model')
  shards = _axis_size(mesh, 'model')
  flat, spec = pytree.tree_flatten_with_path(params)
  out = []
  for path, leaf in flat:
    name = _path_str(path)
    leaf = leaf.detach()
    dim = _sharded_dim(name, leaf)
    if dim is not None and shards > 1:
      parts = [torch.empty_like(leaf) for _ in range(shards)]
      dist.all_gather(parts, leaf.contiguous(), group=group)
      leaf = join_shards(name, parts, dim)
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


class _ModelSum(torch.autograd.Function):
  """Sum over the model group; its VJP sums the ranks' cotangents (each a
  partial under the module docstring's rule)."""

  @staticmethod
  def forward(ctx, x, group):
    ctx.group = group
    x = x.contiguous().clone()
    dist.all_reduce(x, group=group)
    return x

  @staticmethod
  def backward(ctx, g):
    g = g.contiguous().clone()
    dist.all_reduce(g, group=ctx.group)
    return g, None


def _check_rules(model, rules, shards: int):
  """Raises unless ``rules`` are ``GNAT_PARAM_RULES`` (the vocab head and
  the Megatron encoder: the one layout the sharded block computes) and the
  model axis divides the heads and the FFN width."""
  if tuple(rules) != GNAT_PARAM_RULES:
    raise ValueError('the sharded steps take GNAT_PARAM_RULES alone: the '
                     'vocab head and the Megatron layout of the encoder')
  heads, ffn = model.encoder.num_heads, model.encoder.ffn_size
  if heads % shards or ffn % shards:
    raise ValueError(f'the Megatron encoder needs num_heads={heads} and '
                     f'ffn_size={ffn} divisible by the model axis size '
                     f'{shards}')


class TrainStep:
  """A GNAT train step over a mesh, as ``gnat.train_step``:
  ``step(state, frames, num_frames, labels, num_labels) -> (state, loss)``
  with this rank's batch rows (``shard_batch``), returning the mean loss of
  the global batch before the update. Parameters update in place.

  Model parallel (``model_parallel``): the leaves ``GNAT_PARAM_RULES``
  shard are this rank's shards, the encoder runs Megatron-sharded, and the
  lattice loss is ``tp_lattice_loss`` (``tp_lattice``:
  ``make_tp_train_step``) or ``model.lattice`` on the gathered shards
  (``make_sharded_train_step``). Data parallel
  (``make_shard_map_train_step``): every parameter is replicated and each
  rank runs ``model.loss``. The gradient rule is the module docstring's.
  """

  def __init__(self, model, optimizer, mesh, model_parallel: bool = False,
               tp_lattice: bool = False):
    self.model = model
    self.optimizer = optimizer
    self.tp_lattice = tp_lattice
    self.data_group = mesh.get_group('data')
    self.model_group = mesh.get_group('model') if model_parallel else None
    self.encoder_hooks = {}
    if model_parallel:
      group = self.model_group
      self.encoder_hooks = dict(
          heads=model.encoder.num_heads // group.size(),
          model_sum=lambda x: _ModelSum.apply(x, group))

  def _lattice_params(self, params):
    """The lattice parameters with every sharded leaf gathered from the
    model ranks (differentiably)."""
    flat, spec = pytree.tree_flatten_with_path(params['lattice'])
    out = []
    for path, leaf in flat:
      dim = _sharded_dim('lattice/' + _path_str(path), leaf)
      out.append(leaf if dim is None else
                 sharded_scan.gather(leaf, dim, self.model_group))
    return pytree.tree_unflatten(out, spec)

  def _per_seq_loss(self, params, frames, num_frames, labels, num_labels):
    if self.model_group is None:
      return self.model.loss(params, frames, num_frames, labels, num_labels)
    device = self.model.device
    frames = torch.as_tensor(frames, dtype=torch.float32, device=device)
    num_frames = torch.as_tensor(num_frames, device=device)
    labels = torch.as_tensor(labels, device=device)
    num_labels = torch.as_tensor(num_labels, device=device)
    encoded = self.model.encoder.apply(params['encoder'], frames, num_frames,
                                       **self.encoder_hooks)
    if self.tp_lattice:
      return sharded_scan.tp_lattice_loss(
          self.model.lattice, params['lattice'], encoded, num_frames, labels,
          num_labels, group=self.model_group)
    return self.model.lattice(self._lattice_params(params), frames=encoded,
                              num_frames=num_frames, labels=labels,
                              num_labels=num_labels)

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
      # Replicated leaves of a model-parallel step sum over the world (the
      # default group); everything else over the data axis.
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


def _model_parallel_step(model, optimizer, mesh, rules, tp_lattice: bool):
  """(``TrainStep``, shard_state) of a model-parallel step."""
  shards = _axis_size(mesh, 'model')
  _check_rules(model, rules, shards)

  def shard_state(state: gnat.GNATTrainState) -> gnat.GNATTrainState:
    if state.step:
      raise ValueError('shard_state takes a state before its first step: '
                       'AdamW moments are not sharded')
    params = shard_params(state.params, mesh)
    for leaf in pytree.tree_leaves(params):
      leaf.requires_grad_(True)
    return gnat.GNATTrainState(
        params=params, opt_state=optimizer.init(params), step=0,
        shard=(mesh.get_local_rank('model'), shards))

  step = TrainStep(model, optimizer, mesh, model_parallel=True,
                   tp_lattice=tp_lattice)
  return step, shard_state


def make_sharded_train_step(model, optimizer, mesh, rules=GNAT_PARAM_RULES):
  """A mesh-sharded GNAT train step for any lattice.

  The parameters are sharded by ``GNAT_PARAM_RULES`` over the model axis
  (the Megatron encoder and the vocab head); the encoder runs
  Megatron-sharded, and ``model.lattice`` runs on every model rank by its
  own route (``fused`` as the caller set it) on the vocab head gathered
  with ``sharded_scan.gather``, whose VJP sums the model ranks'
  cotangents. The batch rows split over the data axis. The gradient rule
  is the module docstring's. This is the step ``models.train.train`` takes
  where the lattice has no tensor-parallel plan (``sharded_scan.tp_plan``:
  a trigram, an S = 1 lattice, ``fused='never'``).

  Args:
    model: ``models.gnat.GNATModel``.
    optimizer: ``gnat.make_optimizer``'s AdamW.
    mesh: ('data', 'model') mesh from ``make_mesh``.
    rules: Parameter sharding rules: ``GNAT_PARAM_RULES``, the one layout
      the port computes (any other raises ``ValueError``).

  Returns:
    (train_step_fn, shard_state_fn): the ``TrainStep``, and a function that
    turns a fresh ``GNATTrainState`` (full parameters, no step taken) into
    this rank's sharded state with its own optimizer state.
  """
  return _model_parallel_step(model, optimizer, mesh, rules,
                              tp_lattice=False)


def make_tp_train_step(model, optimizer, mesh, rules=GNAT_PARAM_RULES):
  """Tensor-parallel train step with the lattice loss vocab-sharded.

  Each rank holds its shard of the joint network's vocab head and computes
  the denominator with the per-frame ``frame_reduce`` kernels
  (``ops/sharded_scan.py``), gathering only the [B, V/D] reductions over
  the model axis; the numerator runs on the gathered head. The encoder is
  Megatron-sharded, as in ``make_sharded_train_step``.

  Args:
    model: ``models.gnat.GNATModel``; its lattice must be covered by
      ``sharded_scan.tp_supported``.
    optimizer: ``gnat.make_optimizer``'s AdamW.
    mesh: ('data', 'model') mesh from ``make_mesh``.
    rules: Parameter sharding rules: ``GNAT_PARAM_RULES`` alone, as in
      ``make_sharded_train_step``.

  Returns:
    (train_step_fn, shard_state_fn), as ``make_sharded_train_step``.
  """
  if not sharded_scan.tp_supported(model.lattice):
    raise ValueError('model.lattice is not covered by the tensor-parallel '
                     'lattice loss; use make_sharded_train_step')
  return _model_parallel_step(model, optimizer, mesh, rules,
                              tp_lattice=True)


def make_shard_map_train_step(model, optimizer, mesh) -> TrainStep:
  """Data-parallel train step: each rank runs the loss and its gradient
  (through the lattice kernels) on its own batch rows, and the loss sum,
  the feasible count and the gradients are summed over the mesh's data
  axis. Parameters and optimizer state are replicated: every rank starts
  from the same state."""
  return TrainStep(model, optimizer, mesh)


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
