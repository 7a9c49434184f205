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

"""Sequence (time-axis) sharded lattice computations: the alpha relay.

Counterpart of ``last_torch_tpu/parallel/sequence.py``, on
``torch.distributed``. The recognition-lattice forward recursion is
sequential in time, but its carry is small: ``[batch, num_context_states]``.
For sequences too long for one card's memory, the frames are split into D
consecutive blocks over the ranks of a ``DeviceMesh`` dimension (the time
axis, ``axis_name``), and the alpha carry is relayed between neighbouring
ranks with point-to-point ``send`` / ``recv``. Each rank stores only its
``T / D`` frames' per-frame state; arc weights are recomputed inside each
block, so nothing O(T * S * V) is ever materialized.

This is a memory-scaling construct: the recursion stays serial in T, so
wall-clock stays O(T), but the alpha history saved for the backward and
every per-frame temporary drop by D. Rank r waits for the carry of rank
r - 1, advances its own block once, and sends the carry on to rank r + 1; the
last rank's final carry is broadcast over the axis. Every block runs once
forward and once backward (``_relay``'s ``torch.autograd.Function``): the
backward runs in reverse, rank D - 1 first, each rank receiving the carry's
cotangent (the generic relay) or the log-space beta (the kernel relay,
``ops/fused_scan.py``'s ``beta0``) from rank r + 1, recomputing its block
from the carry it saved, and sending d(carry in) to rank r - 1.

The gradient rule. Every rank computes the same replicated result (a loss,
a log Z). The backward of sharing the final carry passes rank D - 1's own
cotangent without summing it over the axis, and each rank's block gives the
partial gradients of what the block reads: the weight-function parameters
and cache through its own frames, and its own frames' rows. The gradient of
the replicated result with respect to a parameter is therefore the SUM over
the axis of the ranks' gradients (not their mean: no rank's gradient is
scaled by 1 / D), and the train steps here (``make_time_sharded_train_step``,
``make_tp_seq_train_step``) all-reduce every parameter gradient over the
time axis, and over the data axis when ``batch_axis`` is given. The encoder
runs replicated on every rank; its gradients come only through the local
block's frames. Under seq x tp (``tp_shortest_distance_time_sharded``) the
model ranks of one time block share it: each holds the whole parameters,
runs its vocabulary shard through ``frame_reduce`` and gathers the
reductions; the block's backward sums its gradients over the model axis
(the parameters' and the carry's), so that from outside it is one block of
the relay with the same rule, and the steps never sum over the model axis.

``batch_axis`` composes data parallelism: the caller passes this rank's
batch rows (``parallel.sharding.shard_batch`` on that axis) and gets this
rank's rows back; the relay runs within each data slice.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` whose dimension
names include ``axis_name`` (and ``batch_axis`` / ``model_axis`` where
given), over an initialized default process group; its dimension groups
carry every collective, so each must be created on every rank
(``init_device_mesh``).
"""

from __future__ import annotations

import dataclasses
from collections.abc import Callable
from typing import Any, Optional

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from last_torch_tpu_torch import alignments, lattices, semirings, weight_fns
from last_torch_tpu_torch.models import gnat
from last_torch_tpu_torch.ops import fused_scan, sharded_scan


def _axis_size(mesh, name: str) -> int:
  return mesh.shape[mesh.mesh_dim_names.index(name)]


def _check_batch_axis(mesh, batch_axis: Optional[str]):
  """``batch_axis``, if given, must name a mesh dimension: the caller split
  the batch rows over it (the relay itself runs within each data slice)."""
  if batch_axis is not None and batch_axis not in mesh.mesh_dim_names:
    raise ValueError(f'batch_axis {batch_axis!r} is not a dimension of the '
                     f'mesh {mesh.mesh_dim_names}')


def _init_alpha(lattice, batch: int, semiring, dtype, device,
                num_states=None, start=None):
  """The one-hot [batch, num_states] alpha before the first frame in
  ``semiring`` (``dtype`` a pytree of dtypes for a tuple-valued one): the
  context's start state, or position ``start`` of a string DP's
  ``num_states`` label positions."""
  if num_states is None:
    num_states = lattice.context.shape()[0]
  if start is None:
    start = lattice.context.start()
  return lattices._init_context_state_weights((batch,), num_states, start,
                                              semiring, dtype, device)


def _check_divisible(frames: torch.Tensor, num_devices: int,
                     axis_name: str) -> int:
  max_t = frames.shape[-2]
  if max_t % num_devices != 0:
    raise ValueError(f'max_num_frames={max_t} must be divisible by the '
                     f'{axis_name!r} axis size {num_devices}')
  return max_t // num_devices


@dataclasses.dataclass(frozen=True)
class _Axis:
  """This rank's place on a mesh dimension: its process group, size and
  index (``rank``), and the global ranks of its neighbours."""
  group: Any
  size: int
  rank: int

  @classmethod
  def of(cls, mesh, name: str) -> '_Axis':
    return cls(mesh.get_group(name), _axis_size(mesh, name),
               mesh.get_local_rank(name))

  def global_rank(self, index: int) -> int:
    return dist.get_global_rank(self.group, index)

  def send(self, leaves, index: int):
    for x in leaves:
      dist.send(x.contiguous(), self.global_rank(index), group=self.group)

  def recv(self, like, index: int) -> list[torch.Tensor]:
    out = []
    for x in like:
      buf = torch.empty(x.shape, dtype=x.dtype, device=x.device)
      dist.recv(buf, self.global_rank(index), group=self.group)
      out.append(buf)
    return out

  def broadcast(self, leaves, index: int) -> list[torch.Tensor]:
    """Rank ``index``'s ``leaves`` on every rank of the axis (its shapes and
    types are every rank's)."""
    out = [x.contiguous().clone() for x in leaves]
    if self.size > 1:
      for x in out:
        dist.broadcast(x, self.global_rank(index), group=self.group)
    return out

  def all_reduce(self, tensors, op=dist.ReduceOp.SUM):
    """Sums (``op``) each of ``tensors`` over the axis, in place, through
    one flat buffer per dtype."""
    if self.size == 1:
      return
    by_dtype = {}
    for x in tensors:
      by_dtype.setdefault(x.dtype, []).append(x)
    for group in by_dtype.values():
      flat = torch.cat([x.reshape(-1) for x in group])
      dist.all_reduce(flat, op=op, group=self.group)
      offset = 0
      for x in group:
        x.copy_(flat[offset:offset + x.numel()].view_as(x))
        offset += x.numel()


def _zeros_if_none(grads, like):
  return [torch.zeros_like(x) if g is None else g for g, x in zip(grads, like)]


class _RelayFn(torch.autograd.Function):
  """One call of a ``_Relay`` (see ``_relay``). Inputs: the flattened
  carry0, block tree and ``diff_args`` leaves, with their pytree ``specs``;
  outputs: the final carry's leaves."""

  @staticmethod
  def forward(ctx, relay, specs, *leaves):
    n_carry, n_block = specs[0].num_leaves, specs[1].num_leaves
    carry0 = list(leaves[:n_carry])
    block = list(leaves[n_carry:n_carry + n_block])
    diff = list(leaves[n_carry + n_block:])
    axis = relay.axis
    carry_in = carry0 if axis.rank == 0 else axis.recv(carry0, axis.rank - 1)
    out = relay.advance(specs, carry_in, block, diff)
    if axis.rank < axis.size - 1:
      axis.send(out, axis.rank + 1)
    final = axis.broadcast(out, axis.size - 1)
    # Each rank keeps only the carry its block consumed.
    ctx.relay, ctx.specs = relay, specs
    ctx.carry_in = [x.detach() for x in carry_in]
    ctx.save_for_backward(*block, *diff)
    return tuple(final)

  @staticmethod
  def backward(ctx, *cts):
    relay, specs = ctx.relay, ctx.specs
    n_carry, n_block = specs[0].num_leaves, specs[1].num_leaves
    axis = relay.axis
    saved = list(ctx.saved_tensors)
    block, diff = saved[:n_block], saved[n_block:]
    if axis.rank == axis.size - 1:
      # Rank D - 1's own cotangent of the shared final carry, unsummed.
      ct = _zeros_if_none(cts, ctx.carry_in)
    else:
      ct = axis.recv(ctx.carry_in, axis.rank + 1)
    wants = ctx.needs_input_grad[2 + n_carry:]
    with torch.enable_grad():
      carry_in = [x.detach().requires_grad_(x.is_floating_point())
                  for x in ctx.carry_in]
      inputs = [x if x is None or not want else
                x.detach().requires_grad_() for x, want in
                zip(block + diff, wants)]
      out = relay.advance(specs, carry_in, inputs[:n_block],
                          inputs[n_block:])
      if relay.model is not None:
        # The model ranks share the block: their gathers' VJP sums the
        # cotangents of every model rank, so each backpropagates 1 / Dm.
        ct = [c / relay.model.size for c in ct]
      wrt = [x for x in carry_in + inputs
             if x is not None and x.requires_grad]
      pairs = [(o, c) for o, c in zip(out, ct) if o.requires_grad]
      grads = iter(torch.autograd.grad(
          [o for o, _ in pairs], wrt, [c for _, c in pairs],
          allow_unused=True) if pairs and wrt else [None] * len(wrt))
    grads = [None if x is None or not x.requires_grad else next(grads)
             for x in carry_in + inputs]
    d_carry = _zeros_if_none(grads[:n_carry], ctx.carry_in)
    d_inputs = [g if g is not None or x is None or not want else
                torch.zeros_like(x) for g, x, want in
                zip(grads[n_carry:], block + diff, wants)]
    if relay.model is not None:
      relay.model.all_reduce(d_carry +
                             [g for g in d_inputs if g is not None])
    if axis.rank > 0:
      axis.send(d_carry, axis.rank - 1)
    # carry0 is a constant start: no gradient.
    return (None, None) + (None,) * n_carry + tuple(d_inputs)


@dataclasses.dataclass(frozen=True)
class _Relay:
  """A differentiable relay of ``local_fn`` over the ranks of ``axis``;
  ``model``, the model axis of seq x tp, or None."""
  axis: _Axis
  local_fn: Callable
  model: Optional[_Axis] = None

  def advance(self, specs, carry, block, diff):
    """The carry's leaves after this rank's block."""
    carry, block, diff = (pytree.tree_unflatten(list(leaves), spec)
                          for leaves, spec in zip((carry, block, diff),
                                                  specs))
    out = self.local_fn(carry, block, self.axis.rank, diff)
    return [x.contiguous() for x in pytree.tree_leaves(out)]

  def __call__(self, carry0, block, diff_args):
    flat = [pytree.tree_flatten(tree) for tree in (carry0, block, diff_args)]
    carry_leaves = [x.contiguous() for x in flat[0][0]]
    final = _RelayFn.apply(self, tuple(spec for _, spec in flat),
                           *carry_leaves, *flat[1][0], *flat[2][0])
    return pytree.tree_unflatten(list(final), flat[0][1])


def _relay(mesh, axis_name: str, local_fn: Callable,
           model_axis: Optional[str] = None) -> _Relay:
  """Builds a differentiable time-block relay over ``axis_name``.

  ``local_fn(carry, block, my_idx, diff_args)`` advances the recursion
  carry over this rank's block of frames (``my_idx`` its index on the
  axis). It must be differentiable in ``carry``, ``block`` (a pytree of
  this rank's [B, T/D, ...] blocks: its frames and any per-frame riders,
  e.g. an additive decode mask) and ``diff_args`` (a pytree of tensors or
  None: the parameters and the cache); anything else it reads (frame
  counts, labels) it closes over.

  Returns ``run(carry0, block, diff_args) -> final``: the carry after all D
  blocks, the same on every rank of the axis, differentiable (``_RelayFn``):
  its backward relays the carry cotangent in reverse and gives each rank's
  partial gradients (module docstring). ``carry0`` is a constant start.
  ``model_axis`` (seq x tp) makes the model ranks of a block share it: its
  backward scales the cotangent by 1 / Dm and sums the gradients over the
  model axis.
  """
  model = None if model_axis is None else _Axis.of(mesh, model_axis)
  return _Relay(_Axis.of(mesh, axis_name), local_fn, model)


def _local_block(x: torch.Tensor, axis: _Axis, local_t: int) -> torch.Tensor:
  """This rank's block of a [B, T, ...] tensor (differentiable)."""
  return x.narrow(1, axis.rank * local_t, local_t)


def shortest_distance_time_sharded(lattice, params, frames, num_frames,
                                   mesh, axis_name: str,
                                   semiring=semirings.Log, cache=None,
                                   fused: str = 'never', weight_lift=None,
                                   batch_axis=None,
                                   lexical_mask=None) -> torch.Tensor:
  """Shortest distance with frames sharded over a time (sequence) axis.

  Differentiable: gradients flow to ``params`` and ``frames`` through the
  reverse relay (module docstring; each rank's are partial). The generic
  relay takes any differentiable semiring (Log marginals, MaxTropical
  one-hot paths, a tuple-valued one with a ``weight_lift``); ``fused='auto'``
  runs each block through the log-partition kernels chained by their
  ``alpha0`` / ``beta0`` seeds (``_fused_relay``) where the lattice's own
  kernel route would (Log semiring, no lift, no mask, ``fused_scan``'s
  gate), the plain versions on CPU tensors.

  Args:
    lattice: ``RecognitionLattice``.
    params: Lattice parameters.
    frames: [batch, max_num_frames, feature_size], the same on every rank of
      the axis (this rank's rows under ``batch_axis``); max_num_frames
      must be divisible by the axis size.
    num_frames: [batch] frame counts.
    mesh: ``DeviceMesh`` with a dimension ``axis_name``.
    axis_name: The mesh dimension to shard time over.
    semiring: Semiring of the shortest distance.
    cache: Optional prebuilt weight-function cache.
    fused: 'never' (the generic relay) or 'auto'.
    weight_lift: Optional lifting of plain weights into semiring values.
    batch_axis: Optional data-parallel dimension (module docstring).
    lexical_mask: Optional additive [batch, max_num_frames,
      num_alignment_states, vocab_size] arc mask; each rank reads (and
      differentiates) its own block of it. Generic relay only.

  Returns:
    [batch] shortest distance, the same on every rank of the axis.
  """
  if fused not in ('auto', 'never'):
    raise ValueError(f"fused should be 'auto' or 'never', but got {fused!r}")
  _check_batch_axis(mesh, batch_axis)
  if cache is None:
    cache = lattice.build_cache(params)
  axis = _Axis.of(mesh, axis_name)
  local_t = _check_divisible(frames, axis.size, axis_name)
  num_frames = torch.as_tensor(num_frames, device=frames.device)
  use_kernel = (fused != 'never' and lexical_mask is None and
                semiring is semirings.Log and weight_lift is None and
                lattice._kernels_take(fused_scan, frames))
  if use_kernel:
    return _fused_relay(lattice, mesh, axis_name, local_t,
                        params['weight_fn'], cache, frames, num_frames)
  num_align_states = lattice.alignment.num_states()
  if lexical_mask is not None and (
      lexical_mask.ndim != 4 or
      tuple(lexical_mask.shape[:2]) != tuple(frames.shape[:2]) or
      lexical_mask.shape[2] != num_align_states):
    raise ValueError(
        'lexical_mask must be [batch, max_num_frames, '
        f'num_alignment_states={num_align_states}, vocab_size], got '
        f'{tuple(lexical_mask.shape)} for frames {tuple(frames.shape)}')
  block = {'frames': _local_block(frames, axis, local_t)}
  if lexical_mask is not None:
    block['lexical_mask'] = _local_block(lexical_mask, axis, local_t)
  return _distance_relay(lattice, params, cache, block, num_frames, mesh,
                         axis_name, semiring, weight_lift)


def _distance_relay(lattice, params, cache, block, num_frames, mesh,
                    axis_name, semiring, weight_lift):
  """The generic relay of ``shortest_distance_time_sharded`` on this rank's
  ``block`` ({'frames': [B, Tl, F], optionally 'lexical_mask'})."""
  local_t = block['frames'].shape[1]

  def local_fn(alpha, block, my_idx, diff_args):
    wf_params, cache = diff_args
    return lattice._forward_block(
        {'weight_fn': wf_params}, cache, block['frames'], num_frames,
        semiring, alpha, t_offset=my_idx * local_t,
        lexical_mask=block.get('lexical_mask'), weight_lift=weight_lift)

  frames = block['frames']
  lift = weight_lift if weight_lift is not None else (lambda w: w)
  dtype = semirings.value_dtype(lift(torch.zeros((), dtype=frames.dtype,
                                                 device=frames.device)))
  carry0 = _init_alpha(lattice, frames.shape[0], semiring, dtype,
                       frames.device)
  run = _relay(mesh, axis_name, local_fn)
  final = run(carry0, block, (params['weight_fn'], cache))
  return semiring.sum(final, axis=-1)


class _FusedRelayFn(torch.autograd.Function):
  """log Z through the log-partition kernels chained over the time axis
  (``_fused_relay``). Inputs: the ``_FusedRelay``, the [B] frame counts,
  the cache, this rank's [B, Tl, F] frames and the ``JointWeightFn``
  leaves of ``_HEAD_NAMES``."""

  @staticmethod
  def forward(ctx, relay, num_frames, cache, frames, *leaves):
    axis = relay.axis
    pf, pc, head, is_pad = relay.stage(num_frames, cache, frames, leaves)
    batch, num_states = frames.shape[0], pc.shape[0]
    if axis.rank == 0:
      alpha = fused_scan.initial_alpha(1, batch, num_states, None,
                                       frames.device)[0]
    else:
      (alpha,) = axis.recv([pf.new_empty(batch, num_states)], axis.rank - 1)
    # Nothing O(Tl * S) is kept: the backward recomputes the history.
    _, out, _, _ = fused_scan.fused_forward(
        pf, pc, head, is_pad, alpha0=alpha, with_residuals=False,
        **relay.options)
    if axis.rank < axis.size - 1:
      axis.send([out], axis.rank + 1)
    (final,) = axis.broadcast([out], axis.size - 1)
    log_z = torch.logsumexp(final, dim=-1)
    ctx.relay = relay
    ctx.alpha_in = alpha
    ctx.save_for_backward(num_frames, cache, frames, log_z, *leaves)
    return log_z

  @staticmethod
  def backward(ctx, g):
    relay = ctx.relay
    axis = relay.axis
    num_frames, cache, frames, log_z, *leaves = ctx.saved_tensors
    pf, pc, head, is_pad = relay.stage(num_frames, cache, frames, leaves)
    # Rank D - 1's cotangent of the shared log Z, and the beta after this
    # block from rank r + 1 (zeros, the semiring's ones, after the last).
    (g,) = axis.broadcast([g.float()], axis.size - 1)
    beta0 = None
    if axis.rank < axis.size - 1:
      (beta0,) = axis.recv([ctx.alpha_in], axis.rank + 1)
    _, _, hist, slabs = fused_scan.fused_forward(
        pf, pc, head, is_pad, alpha0=ctx.alpha_in, with_residuals=True,
        **relay.options)
    # The block's posteriors are global: the whole sequence's log Z.
    dpf, dpc, dvw, dvb, dbw, dbb, beta_out = fused_scan.fused_backward(
        pf, pc, head, is_pad, log_z, g, hist, slabs, beta0=beta0,
        **relay.options)
    if axis.rank > 0:
      axis.send([beta_out], axis.rank - 1)
    frame_proj, context_proj = leaves[:2]
    d_frame_proj = torch.einsum('btf,tbh->fh', frames, dpf)
    d_context_proj = cache.t() @ dpc
    d_cache = dpc @ context_proj.t()
    d_frames = torch.einsum('tbh,fh->btf', dpf, frame_proj)
    return (None, None, d_cache, d_frames, d_frame_proj, d_context_proj, dvw,
            dvb, dbw, dbb)


_HEAD_NAMES = ('frame_proj', 'context_proj', 'vocab_w', 'vocab_b', 'blank_w',
               'blank_b')


@dataclasses.dataclass(frozen=True)
class _FusedRelay:
  """The kernel relay of one lattice over ``axis``: its blocks of
  ``local_t`` frames and the kernels' keyword ``options``."""
  axis: _Axis
  local_t: int
  options: dict

  def stage(self, num_frames, cache, frames, leaves):
    """pf [Tl, B, h], pc [S, h], the head and is_pad [Tl, B] of this rank's
    block, as the kernels take them: its frame t is frame rank * Tl + t of
    the sequence."""
    frame_proj, context_proj, *head = leaves
    pf = torch.einsum('btf,fh->tbh', frames, frame_proj).contiguous()
    pc = (cache @ context_proj).contiguous()
    t = (self.axis.rank * self.local_t +
         torch.arange(self.local_t, device=frames.device))
    return (pf, pc, dict(zip(_HEAD_NAMES[2:], head)),
            t[:, None] >= num_frames[None, :])


def _fused_relay(lattice, mesh, axis_name: str, local_t: int, wf_params,
                 cache, frames, num_frames) -> torch.Tensor:
  """[B] log Z through per-block log-partition kernels chained over the
  axis, from the whole [B, T, F] frames.

  Forward: each rank's block runs ``fused_scan.fused_forward`` with
  ``alpha0`` from rank r - 1 and no residuals (nothing O(Tl * S) is kept).
  Backward: rank r receives beta after its block from rank r + 1 (the
  semiring's ones on the last), recomputes its block's alpha history and
  expansion slabs from the saved incoming alpha (memory: [B, T/D, S] a
  rank, the point of time sharding), runs ``fused_scan.fused_backward``
  with that ``beta0`` and the whole sequence's log Z, and sends its
  ``beta_out`` to rank r - 1. The bigram kernels' mode is
  ``fused_scan.plan``'s for the block's shapes; the compute type is the
  lattice's (bfloat16 on the card).
  """
  frame_dependent = isinstance(lattice.alignment, alignments.FrameDependent)
  num_states, vocab = lattice.context.shape()
  compute_dtype = fused_scan.compute_dtype_for(frames.device)
  options = dict(
      max_expansions=(0 if frame_dependent else
                      lattice.alignment.max_expansions),
      frame_dependent=frame_dependent, compute_dtype=compute_dtype,
      mode=fused_scan.plan(frames.shape[0], num_states, vocab,
                           compute_dtype))
  relay = _FusedRelay(_Axis.of(mesh, axis_name), local_t, options)
  lattice._last_path = 'kernel' if frames.is_cuda else 'plain'
  return _FusedRelayFn.apply(relay, num_frames, cache,
                             _local_block(frames, relay.axis, local_t),
                             *(wf_params[n] for n in _HEAD_NAMES))


def shortest_path_time_sharded(lattice, params, frames, num_frames, mesh,
                               axis_name: str, cache=None, batch_axis=None,
                               reference_compat: bool = False):
  """Viterbi decode with frames sharded over a time (sequence) axis.

  The time-sharded realization of ``RecognitionLattice.shortest_path``'s
  generic route: the MaxTropical shortest distance runs through the relay
  with a zero additive lexical mask on each rank's block, and the one-hot
  tropical gradient of that mask, through the relay's reverse cotangents,
  marks exactly one best path. Each rank's mask and its gradient are
  [B, T/D, A, V]; only the decoded labels, [B, T * A], are gathered.

  Args:
    lattice, params, frames, num_frames, mesh, axis_name, cache,
      batch_axis: As ``shortest_distance_time_sharded``.
    reference_compat: Emit the reference's raw argmax label values (see
      ``RecognitionLattice.shortest_path``).

  Returns:
    (alignment_labels [batch, max_num_frames * num_alignment_states] int32,
    num_alignment_labels [batch] int32, path_weights [batch]), the same on
    every rank of the axis: those of the single-device generic route.
  """
  _check_batch_axis(mesh, batch_axis)
  if cache is None:
    cache = lattice.build_cache(params)
  axis = _Axis.of(mesh, axis_name)
  local_t = _check_divisible(frames, axis.size, axis_name)
  num_frames = torch.as_tensor(num_frames, device=frames.device)
  batch = frames.shape[0]
  num_align_states = lattice.alignment.num_states()
  vocab = lattice.context.shape()[1]
  params = pytree.tree_map(torch.Tensor.detach, params)
  cache = None if cache is None else cache.detach()
  local_frames = _local_block(frames.detach(), axis, local_t)
  mask = torch.zeros((batch, local_t, num_align_states, vocab),
                     dtype=frames.dtype, device=frames.device,
                     requires_grad=True)
  with torch.enable_grad():
    path_weights = _distance_relay(
        lattice, params, cache, {'frames': local_frames,
                                 'lexical_mask': mask},
        num_frames, mesh, axis_name, semirings.MaxTropical, None)
    (viterbi_mask,) = torch.autograd.grad(path_weights.sum(), mask)
  is_blank = torch.all(viterbi_mask == 0, dim=-1)
  labels = torch.where(is_blank, 0, 1 + torch.argmax(viterbi_mask, dim=-1))
  labels = labels.reshape(batch, -1).to(torch.int32).contiguous()
  if axis.size > 1:
    parts = [torch.empty_like(labels) for _ in range(axis.size)]
    dist.all_gather(parts, labels, group=axis.group)
    labels = torch.cat(parts, dim=1)
  if reference_compat:
    labels = torch.where(labels == 0, 0, labels - 1)
  return (labels, (num_align_states * num_frames).to(torch.int32),
          path_weights.detach())


def _string_relay(lattice, params, cache, frames, num_frames, labels,
                  num_labels, mesh, axis_name, semiring, mask=None):
  """The string-forward relay on this rank's block; returns the [B] final
  gather. ``mask``: an additive [B, Tl, U+1] mask on this block's
  per-position lexical weights (the alignment's differentiation hook)."""
  axis = _Axis.of(mesh, axis_name)
  local_t = _check_divisible(frames, axis.size, axis_name)
  num_frames, num_labels, labels = lattice._check_string_args(
      frames, num_frames, labels, num_labels)
  num_positions = labels.shape[-1] + 1

  def local_fn(alpha, block, my_idx, diff_args):
    wf_params, cache = diff_args
    blank_w, lexical_w = lattice._string_weights(
        {'weight_fn': wf_params}, cache, block['frames'], labels)
    if 'mask' in block:
      # [B, Tl, U+1] -> time-major [Tl, B, U+1], as _string_weights.
      lexical_w = lexical_w + block['mask'].movedim(1, 0)
    return lattice._string_dp(
        blank_w, lexical_w, num_frames, num_labels, semiring, alpha0=alpha,
        t_offset=my_idx * local_t, final_gather=False)

  block = {'frames': _local_block(frames, axis, local_t)}
  if mask is not None:
    block['mask'] = mask
  carry0 = _init_alpha(lattice, frames.shape[0], semiring, frames.dtype,
                       frames.device, num_states=num_positions, start=0)
  run = _relay(mesh, axis_name, local_fn)
  final = run(carry0, block, (params['weight_fn'], cache))
  is_final = num_labels[..., None] == torch.arange(num_positions,
                                                   device=frames.device)
  zero = semirings.zeros_like(semiring, final, ())
  return semiring.sum(semirings.where(is_final, final, zero), axis=-1)


def align_time_sharded(lattice, params, frames, num_frames, labels,
                       num_labels, mesh, axis_name: str, cache=None,
                       batch_axis=None):
  """Forced alignment with frames sharded over a time axis.

  The relay realization of ``RecognitionLattice.align``: the string DP
  runs under MaxTropical through the generic relay with a zero additive
  [B, T/D, U+1] mask on each rank's per-position lexical weights; the
  mask's one-hot tropical gradient marks, for each label position, the
  frame where the best constrained path emits it. Each rank finds the
  emissions in its block; a max over the axis joins them.

  Returns:
    (emit_frames [batch, max_num_labels] int32, -1 beyond ``num_labels``;
    path_weights [batch], -inf for an infeasible transcript), the same on
    every rank of the axis: the single-device ``align``'s.
  """
  _check_batch_axis(mesh, batch_axis)
  if cache is None:
    cache = lattice.build_cache(params)
  axis = _Axis.of(mesh, axis_name)
  local_t = _check_divisible(frames, axis.size, axis_name)
  num_frames, num_labels, labels = lattice._check_string_args(
      frames, num_frames, labels, num_labels)
  params = pytree.tree_map(torch.Tensor.detach, params)
  cache = None if cache is None else cache.detach()
  frames = frames.detach()
  mask = torch.zeros((frames.shape[0], local_t, labels.shape[-1] + 1),
                     dtype=frames.dtype, device=frames.device,
                     requires_grad=True)
  with torch.enable_grad():
    scores = _string_relay(lattice, params, cache, frames, num_frames,
                           labels, num_labels, mesh, axis_name,
                           semirings.MaxTropical, mask=mask)
    (marks,) = torch.autograd.grad(scores.sum(), mask)
  # [B, Tl, U+1] -> [B, U, Tl]: at most one winning frame per position.
  marks = marks.movedim(1, -1)[..., :labels.shape[-1], :]
  if local_t:
    emit = torch.argmax(marks, dim=-1).to(torch.int32) + axis.rank * local_t
    emit = torch.where(marks.amax(dim=-1) > 0, emit, -1)
  else:
    emit = torch.full(marks.shape[:-1], -1, dtype=torch.int32,
                      device=marks.device)
  emit = emit.contiguous()
  axis.all_reduce([emit], op=dist.ReduceOp.MAX)
  return emit, scores.detach()


def string_forward_time_sharded(lattice, params, frames, num_frames,
                                labels, num_labels, mesh, axis_name: str,
                                semiring=semirings.Log, cache=None,
                                batch_axis=None) -> torch.Tensor:
  """Numerator (string forward) with frames sharded over a time axis.

  The string-forward carry is [batch, max_num_labels + 1], smaller than the
  denominator's, so the same relay applies: each rank computes its block's
  per-(frame, label-position) weights (labels are replicated) and advances
  the label-position recursion. Differentiable through the generic relay.

  Returns:
    [batch] string shortest distance, the same on every rank of the axis.
  """
  _check_batch_axis(mesh, batch_axis)
  if cache is None:
    cache = lattice.build_cache(params)
  return _string_relay(lattice, params, cache, frames, num_frames, labels,
                       num_labels, mesh, axis_name, semiring)


def loss_time_sharded(lattice, params, frames, num_frames, labels,
                      num_labels, mesh, axis_name: str, cache=None,
                      fused: str = 'never',
                      batch_axis=None) -> torch.Tensor:
  """GNAT loss (negative log-probability) under time sharding.

  ``denominator - numerator`` with both DPs relayed over ``axis_name``; a
  locally normalized weight function returns minus the numerator (the type
  gate of ``RecognitionLattice.loss``). Differentiable: the training loss
  for utterances too long for one card.

  Returns:
    [batch] loss, the same on every rank of the axis.
  """
  if cache is None:
    cache = lattice.build_cache(params)
  numerator = string_forward_time_sharded(
      lattice, params, frames, num_frames, labels, num_labels, mesh,
      axis_name, cache=cache, batch_axis=batch_axis)
  if isinstance(lattice.weight_fn, weight_fns.LocallyNormalizedWeightFn):
    return -numerator
  denominator = shortest_distance_time_sharded(
      lattice, params, frames, num_frames, mesh, axis_name, cache=cache,
      fused=fused, batch_axis=batch_axis)
  return denominator - numerator


def tp_shortest_distance_time_sharded(lattice, params, frames, num_frames,
                                      mesh, seq_axis: str = 'seq',
                                      model_axis: str = 'model',
                                      batch_axis=None,
                                      cache=None) -> torch.Tensor:
  """Log partition with time sharded over ``seq_axis`` AND the vocabulary
  sharded over ``model_axis`` (seq x tp).

  Each (seq, model) rank holds the whole parameters and advances the frames
  of its time block through ``sharded_scan.sharded_shortest_distance`` on
  its [h, V/Dm] slice of the vocab head (the per-frame ``frame_reduce``
  kernels, reductions gathered over ``model_axis``), chained through its
  ``alpha0`` / ``t_offset`` / ``return_alpha``. The alpha relay runs over
  ``seq_axis`` as in ``shortest_distance_time_sharded``; the model ranks of
  a block share it (``_relay``'s ``model_axis``), so each rank's gradients
  follow the module docstring's rule with the model axis already summed.

  Args:
    lattice: ``RecognitionLattice`` covered by ``sharded_scan.tp_supported``
      (a bigram ``FullNGram`` + ``JointWeightFn``).
    params: Lattice parameters (whole: each rank slices its shard).
    frames: [batch, max_num_frames, feature]; max_num_frames must divide by
      the ``seq_axis`` size.
    num_frames: [batch] frame counts.
    mesh: ``DeviceMesh`` with dimensions ``seq_axis`` and ``model_axis``.
    seq_axis / model_axis: The dimension names.
    batch_axis: Optional data-parallel dimension (module docstring).
    cache: Optional prebuilt weight-function cache.

  The JAX function's ``batch_tile`` and ``interpret`` have no counterpart:
  the kernels choose their own tiles, and CPU tensors run the plain
  versions.

  Returns:
    [batch] log-partition values, the same on every rank.
  """
  _check_batch_axis(mesh, batch_axis)
  if cache is None:
    cache = lattice.build_cache(params)
  axis = _Axis.of(mesh, seq_axis)
  model = _Axis.of(mesh, model_axis)
  local_t = _check_divisible(frames, axis.size, seq_axis)
  num_frames = torch.as_tensor(num_frames, device=frames.device)
  num_states, vocab = lattice.context.shape()
  if vocab % model.size:
    raise ValueError(f'the vocabulary of {vocab} does not split over '
                     f'{model.size} model ranks')
  shard = vocab // model.size
  frame_dependent = isinstance(lattice.alignment, alignments.FrameDependent)

  def local_fn(alpha, block, my_idx, diff_args):
    wf_params, cache = diff_args
    wf_local = dict(
        wf_params,
        vocab_w=wf_params['vocab_w'].narrow(
            1, model.rank * shard, shard).contiguous(),
        vocab_b=wf_params['vocab_b'].narrow(0, model.rank * shard, shard))
    return sharded_scan.sharded_shortest_distance(
        wf_local, cache, block['frames'], num_frames,
        max_expansions=(0 if frame_dependent else
                        lattice.alignment.max_expansions),
        frame_dependent=frame_dependent, num_context_states=num_states,
        group=model.group if model.size > 1 else None, alpha0=alpha,
        t_offset=my_idx * local_t, return_alpha=True)

  carry0 = _init_alpha(lattice, frames.shape[0], semirings.Log,
                       frames.dtype, frames.device)
  run = _relay(mesh, seq_axis, local_fn, model_axis=model_axis)
  final = run(carry0, {'frames': _local_block(frames, axis, local_t)},
              (params['weight_fn'], cache))
  return semirings.Log.sum(final, axis=-1)


def tp_loss_time_sharded(lattice, params, frames, num_frames, labels,
                         num_labels, mesh, seq_axis: str = 'seq',
                         model_axis: str = 'model', batch_axis=None,
                         cache=None) -> torch.Tensor:
  """GNAT loss with seq x tp sharding.

  The denominator, the O(B * S * V) pass whose alpha history dominates
  memory, runs ``tp_shortest_distance_time_sharded``. The numerator relays
  over ``seq_axis`` on the whole head (the cheap pass; the flat
  tensor-parallel loss, ``sharded_scan.tp_lattice_loss``, decides the
  same), the same on every model rank. A locally normalized weight function
  returns minus the numerator, as ``RecognitionLattice.loss``.

  Returns:
    [batch] loss, the same on every rank.
  """
  if not sharded_scan.tp_supported(lattice):
    raise ValueError('lattice is not covered by the tensor-parallel '
                     'lattice loss; use loss_time_sharded')
  if cache is None:
    cache = lattice.build_cache(params)
  numerator = string_forward_time_sharded(
      lattice, params, frames, num_frames, labels, num_labels, mesh,
      seq_axis, cache=cache, batch_axis=batch_axis)
  if isinstance(lattice.weight_fn, weight_fns.LocallyNormalizedWeightFn):
    return -numerator
  denominator = tp_shortest_distance_time_sharded(
      lattice, params, frames, num_frames, mesh, seq_axis=seq_axis,
      model_axis=model_axis, batch_axis=batch_axis, cache=cache)
  return denominator - numerator


def mean_over_feasible(per_seq: torch.Tensor, data: Optional[_Axis]):
  """(this rank's objective, the global batch's mean loss, detached): the
  loss sum of ``per_seq``'s feasible rows over the feasible count summed
  over the data axis ``data`` (None: this rank's rows are the batch)."""
  finite = torch.isfinite(per_seq)
  count = finite.sum()
  if data is not None:
    data.all_reduce([count])
  local = torch.where(finite, per_seq, 0.0).sum() / count.clamp(min=1)
  loss = local.detach().clone()
  if data is not None:
    data.all_reduce([loss])
  return local, loss


class ReplicatedTrainStep:
  """A GNAT train step on a state that every rank holds whole:
  ``step(state, frames, num_frames, labels, num_labels) -> (state, loss)``
  as ``sharding.TrainStep``, returning the global batch's mean loss before
  the update. Parameters and optimizer state update in place.

  ``objective(params, frames, num_frames, labels, num_labels)`` gives
  (this rank's objective to backpropagate, the replicated loss)
  (``mean_over_feasible``). After its backward, each part of the
  parameters ('encoder', 'lattice') has its gradients summed over the
  ``_Axis`` list ``axes[part]``, by the module docstring's rule here and by
  ``parallel/pipeline.py``'s for the pipelined steps. Every rank then holds
  the same gradients, and the AdamW update (clip and schedule included) is
  ``gnat.train_step``'s.
  """

  def __init__(self, optimizer, objective: Callable, axes: dict):
    self.optimizer = optimizer
    self.objective = objective
    self.axes = axes

  def loss_and_grads(self, state: gnat.GNATTrainState, frames, num_frames,
                     labels, num_labels) -> torch.Tensor:
    """The global batch's mean loss; leaves the summed gradients, not yet
    clipped, in the parameters' ``.grad``."""
    state.opt_state.adamw.zero_grad(set_to_none=True)
    local, loss = self.objective(state.params, frames, num_frames, labels,
                                 num_labels)
    local.backward()
    for part, axes in self.axes.items():
      leaves = pytree.tree_leaves(state.params[part])
      for leaf in leaves:
        if leaf.grad is None:
          leaf.grad = torch.zeros_like(leaf)
      for axis in axes:
        axis.all_reduce([leaf.grad for leaf in leaves])
    return loss

  def __call__(self, state: gnat.GNATTrainState, frames, num_frames, labels,
               num_labels) -> tuple[gnat.GNATTrainState, torch.Tensor]:
    loss = self.loss_and_grads(state, frames, num_frames, labels, num_labels)
    self.optimizer.apply_gradients(state.opt_state)
    return dataclasses.replace(state, step=state.step + 1), loss


def _replicated_encoder_step(model, optimizer, mesh, axis_name: str,
                             batch_axis, loss_fn: Callable):
  """A ``ReplicatedTrainStep`` with this rank's batch rows (all of them
  without ``batch_axis``), the whole frames on every rank of the time axis
  and the encoder run replicated; ``loss_fn(params, encoded, num_frames,
  labels, num_labels)`` gives the per-sequence lattice loss. Every
  gradient is summed over the time axis and the data axis."""
  data = None if batch_axis is None else _Axis.of(mesh, batch_axis)
  axes = [_Axis.of(mesh, axis_name)] + ([] if data is None else [data])

  def objective(params, frames, num_frames, labels, num_labels):
    device = model.device
    frames = torch.as_tensor(frames, dtype=torch.float32, device=device)
    num_frames = torch.as_tensor(num_frames, device=device)
    labels = torch.as_tensor(labels, device=device)
    num_labels = torch.as_tensor(num_labels, device=device)
    encoded = model.encoder.apply(params['encoder'], frames, num_frames)
    return mean_over_feasible(
        loss_fn(params['lattice'], encoded, num_frames, labels, num_labels),
        data)

  return ReplicatedTrainStep(optimizer, objective,
                             {'encoder': axes, 'lattice': axes})


def make_time_sharded_train_step(model, optimizer, mesh,
                                 axis_name: str = 'seq',
                                 fused: str = 'never',
                                 batch_axis=None) -> ReplicatedTrainStep:
  """A train step whose lattice DPs are time-sharded.

  The encoder runs replicated (its activations are [B, T, H]; for the long
  T this construct targets, pair it with the banded local attention so that
  encoder memory is O(T * W)); the lattice loss, the memory-dominant part,
  whose backward needs per-frame alpha residuals, runs through
  ``loss_time_sharded`` (``fused='auto'``: its denominator through the
  kernel relay where the lattice's kernels would run).

  Returns ``step(state, frames, num_frames, labels, num_labels) ->
  (state, loss)`` (``ReplicatedTrainStep``).
  """

  def loss_fn(params, encoded, num_frames, labels, num_labels):
    return loss_time_sharded(model.lattice, params, encoded, num_frames,
                             labels, num_labels, mesh, axis_name,
                             fused=fused, batch_axis=batch_axis)

  return _replicated_encoder_step(model, optimizer, mesh, axis_name,
                                  batch_axis, loss_fn)


def make_tp_seq_train_step(model, optimizer, mesh, seq_axis: str = 'seq',
                           model_axis: str = 'model',
                           batch_axis=None) -> ReplicatedTrainStep:
  """A train step composing sequence (time) and tensor (vocabulary)
  parallelism: the lattice denominator shards frames over ``seq_axis`` and
  the vocab head over ``model_axis`` at once
  (``tp_loss_time_sharded``). Every rank holds the whole parameters; the
  gradient rule is the module docstring's (nothing is summed over the model
  axis by the step: the blocks did it).

  Returns ``step(state, frames, num_frames, labels, num_labels) ->
  (state, loss)`` (``ReplicatedTrainStep``).
  """
  if not sharded_scan.tp_supported(model.lattice):
    raise ValueError('model.lattice is not covered by the tensor-parallel '
                     'lattice loss')

  def loss_fn(params, encoded, num_frames, labels, num_labels):
    return tp_loss_time_sharded(model.lattice, params, encoded, num_frames,
                                labels, num_labels, mesh, seq_axis=seq_axis,
                                model_axis=model_axis, batch_axis=batch_axis)

  return _replicated_encoder_step(model, optimizer, mesh, seq_axis,
                                  batch_axis, loss_fn)
