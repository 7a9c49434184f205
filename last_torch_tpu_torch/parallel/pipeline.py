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

"""Pipeline parallelism (GPipe) for the GNAT encoder over a 'pipe' axis.

Counterpart of ``last_torch_tpu/parallel/pipeline.py``, on
``torch.distributed``. The encoder's blocks are staged across the ranks of
a ``DeviceMesh`` dimension (``pipe_axis``): stage p holds the work of
blocks [p L / P, (p + 1) L / P), and the batch streams through the stages
in M microbatches. Stage 0 embeds microbatch j (``encoder.embed``), every
stage applies its blocks, and the [mbs, T, d] activation goes to stage
p + 1 by ``send`` / ``recv`` on the pipe group; the last stage runs
``encoder.finalize`` and the lattice loss of the microbatch (or, for
``make_pp_encode_fn``, keeps its encoding).

Where the JAX package differentiates one checkpointed scan of M + P - 1
ticks through ``ppermute``, the schedule here is explicit and is one
``torch.autograd.Function`` a call (``_GPipeFn``): all M forwards, then all
M backwards in reverse order. The forward keeps only each microbatch's
stage input (as ``jax.checkpoint(tick)`` does); the backward recomputes the
stage's blocks from it (on the last stage the lattice loss too), takes the
cotangent received from stage p + 1 (on the last stage the loss's own),
and sends d(input) to stage p - 1. Live memory is one microbatch's
activations a stage.

The gradient rule. The loss is replicated: each rank's loss sum is summed
over the pipe and data axes, then divided by the global feasible count.
Only the last stage's own cotangent of it is used (stage p < P - 1 has no
loss term of its own); a rank's gradients are those of its own data rows'
share. So each block leaf's gradient is nonzero on its stage alone,
``input_proj``'s on stage 0 alone, and the final layer norm's and the
lattice's on the last stage alone, and the gradient of the replicated loss
is the SUM of every rank's over the pipe and data axes
(``make_pp_train_step``), after which every rank applies the same AdamW
update (``gnat.make_optimizer``, clip included) to a whole state. Parameter
and optimizer memory are therefore not divided in this port (every rank
holds all of them); activation memory is.

``make_pp_encode_fn`` returns the encoding replicated over the pipe axis
(broadcast from the last stage, whose backward takes the last stage's own
cotangent). Under pp x seq (``make_pp_seq_train_step``) every pipe rank
then runs the same time-sharded loss (``parallel/sequence.py``): the
lattice leaves' gradients are partial over the time axis and identical
over the pipe axis, the encoder leaves' partial over both. So the step sums
the encoder's over pipe and time, the lattice's over time alone (a sum over
the pipe axis would make them P-fold).

The loss and encode functions take the whole batch on every rank, as the
JAX package's jitted functions take a global array: each rank takes its
rows of the data axis (``data_axis``), then cuts them into microbatches.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Callable
from typing import Any, Optional

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from last_torch_tpu_torch.parallel import sequence

Params = Any
_Axis = sequence._Axis


def stack_layers(layers) -> Params:
  """[num_layers] list of per-block parameter dicts -> dict of [L, ...]
  tensors."""
  return pytree.tree_map(lambda *xs: torch.stack(xs), *layers)


def unstack_layers(stacked: Params, num_layers: int):
  """Inverse of ``stack_layers``."""
  return [pytree.tree_map(lambda x, i=i: x[i], stacked)
          for i in range(num_layers)]


def make_pp_mesh(num_devices: Optional[int] = None,
                 pipeline_parallel: int = 2, device_type: str = 'cuda'):
  """A ('data', 'pipe') ``DeviceMesh`` over the initialized world: rank r
  sits at (r // pipeline_parallel, r % pipeline_parallel). ``device_type``
  'cuda' (NCCL, one card a rank) unless the caller asks for 'cpu'
  (gloo)."""
  from torch.distributed.device_mesh import init_device_mesh
  if not dist.is_initialized():
    raise RuntimeError('make_pp_mesh needs the default process group: call '
                       'torch.distributed.init_process_group first')
  world = dist.get_world_size()
  if num_devices is not None and num_devices != world:
    raise ValueError(f'num_devices={num_devices} is not the world size '
                     f'{world}')
  if pipeline_parallel < 1 or world % pipeline_parallel:
    raise ValueError(f'pipeline_parallel={pipeline_parallel} must divide '
                     f'the device count {world}')
  return init_device_mesh(device_type,
                          (world // pipeline_parallel, pipeline_parallel),
                          mesh_dim_names=('data', 'pipe'))


def _size(mesh, name: Optional[str]) -> int:
  return 1 if name is None else mesh.shape[mesh.mesh_dim_names.index(name)]


def _stage_layers(encoder, mesh, pipe_axis: str) -> range:
  """The layer indices of this rank's stage."""
  num_stages = _size(mesh, pipe_axis)
  num_layers = encoder.num_layers
  if num_layers % num_stages != 0:
    raise ValueError(f'encoder_layers={num_layers} must divide across '
                     f'{pipe_axis}={num_stages} stages')
  per_stage = num_layers // num_stages
  stage = mesh.get_local_rank(pipe_axis)
  return range(stage * per_stage, (stage + 1) * per_stage)


def _data_rows(mesh, data_axis: Optional[str], m: int, device, *arrays):
  """This rank's rows of the whole batch's ``arrays``, on ``device``; the
  batch must divide into data x M."""
  data_parallel = _size(mesh, data_axis)
  batch = len(arrays[0])
  if batch % (m * data_parallel) != 0:
    raise ValueError(f'batch {batch} must divide into data_parallel='
                     f'{data_parallel} x num_microbatches={m}')
  size = batch // data_parallel
  start = 0 if data_axis is None else mesh.get_local_rank(data_axis) * size
  return [torch.as_tensor(x, device=device)[start:start + size]
          for x in arrays]


@dataclasses.dataclass(frozen=True)
class _Schedule:
  """One call's GPipe schedule on this rank.

  ``tail(params, y, j)`` turns the last stage's output of microbatch j into
  that microbatch's result; ``finish(results)`` joins the M results into
  the call's output (on the last stage; others pass None) and makes it the
  same on every pipe rank; ``tail_cotangent(ct, j)`` is microbatch j's
  share of the output's cotangent ``ct`` on the last stage."""
  encoder: Any
  pipe: _Axis
  layers: range
  num_microbatches: int
  frames: torch.Tensor
  num_frames: torch.Tensor
  tail: Callable
  finish: Callable
  tail_cotangent: Callable

  @property
  def last(self) -> bool:
    return self.pipe.rank == self.pipe.size - 1

  def rows(self, x: torch.Tensor, j: int) -> torch.Tensor:
    mbs = x.shape[0] // self.num_microbatches
    return x.narrow(0, j * mbs, mbs)

  def mask(self, j: int) -> torch.Tensor:
    max_t = self.frames.shape[1]
    return (torch.arange(max_t, device=self.frames.device) <
            self.rows(self.num_frames, j)[:, None])

  def stage(self, params: Params, x: Optional[torch.Tensor], j: int):
    """This stage's blocks on microbatch j; stage 0 embeds it first."""
    enc = params['encoder']
    if x is None:
      x = self.encoder.embed(enc['input_proj'], self.rows(self.frames, j))
    mask = self.mask(j)
    use_banded, attn_bias = self.encoder.attention_inputs(mask)
    for i in self.layers:
      x = self.encoder.block(enc['layers'][i], x, mask, attn_bias,
                             use_banded)
    return x

  def carrier(self) -> torch.Tensor:
    """A buffer of one microbatch's activation."""
    mbs = self.frames.shape[0] // self.num_microbatches
    return torch.empty((mbs, self.frames.shape[1], self.encoder.model_size),
                       dtype=self.encoder.dtype, device=self.frames.device)


class _GPipeFn(torch.autograd.Function):
  """One pipelined call (``_Schedule``). Inputs: the flattened parameter
  leaves with their pytree ``spec``; output: ``finish``'s."""

  @staticmethod
  def forward(ctx, sched, spec, *leaves):
    params = pytree.tree_unflatten(list(leaves), spec)
    pipe = sched.pipe
    inputs, results = [], []
    for j in range(sched.num_microbatches):
      x = None if pipe.rank == 0 else pipe.recv([sched.carrier()],
                                                pipe.rank - 1)[0]
      inputs.append(x)
      y = sched.stage(params, x, j)
      if sched.last:
        results.append(sched.tail(params, y, j))
      else:
        pipe.send([y], pipe.rank + 1)
    ctx.sched, ctx.spec, ctx.inputs = sched, spec, inputs
    ctx.save_for_backward(*leaves)
    return sched.finish(results if sched.last else None)

  @staticmethod
  def backward(ctx, ct):
    sched, pipe = ctx.sched, ctx.sched.pipe
    saved = ctx.saved_tensors
    wants = ctx.needs_input_grad[2:]
    grads = [None] * len(saved)
    for j in reversed(range(sched.num_microbatches)):
      with torch.enable_grad():
        leaves = [x.detach().requires_grad_(want)
                  for x, want in zip(saved, wants)]
        params = pytree.tree_unflatten(leaves, ctx.spec)
        x = ctx.inputs[j]
        if x is not None:
          x = x.detach().requires_grad_()
        y = sched.stage(params, x, j)
        if sched.last:
          out, g = sched.tail(params, y, j), sched.tail_cotangent(ct, j)
        else:
          out = y
          (g,) = pipe.recv([y.detach()], pipe.rank + 1)
        wrt = [leaf for leaf in leaves if leaf.requires_grad]
        if x is not None:
          wrt.append(x)
        got = iter(torch.autograd.grad(out, wrt, g, allow_unused=True))
      for i, leaf in enumerate(leaves):
        if leaf.requires_grad:
          g_leaf = next(got)
          if g_leaf is not None:
            grads[i] = g_leaf if grads[i] is None else grads[i] + g_leaf
      if x is not None:
        d_x = next(got)
        pipe.send([torch.zeros_like(x) if d_x is None else d_x],
                  pipe.rank - 1)
    return (None, None) + tuple(grads)


def _run(sched: _Schedule, params: Params):
  leaves, spec = pytree.tree_flatten(params)
  return _GPipeFn.apply(sched, spec, *leaves)


def _sum_over(axes, tensors):
  for axis in axes:
    axis.all_reduce(tensors)


def make_pp_loss_fn(model, mesh, num_microbatches: int,
                    pipe_axis: str = 'pipe',
                    data_axis: Optional[str] = None):
  """Builds the pipelined mean-loss callable.

  Args:
    model: ``models.gnat.GNATModel``; its encoder's ``num_layers`` must
      divide evenly across the 'pipe' axis.
    mesh: ``DeviceMesh`` with ``pipe_axis`` (and optionally ``data_axis``).
    num_microbatches: GPipe microbatch count M; each data rank's rows must
      divide by M. Larger M shrinks the pipeline bubble ((P - 1) / (M + P -
      1) of the ticks) at the cost of smaller products.
    pipe_axis: The mesh dimension carrying the stages.
    data_axis: Optional mesh dimension to also split the batch over.

  Returns:
    ``loss_fn(params, frames, num_frames, labels, num_labels) -> scalar``,
    the whole batch on every rank: the mean loss over feasible sequences,
    the same on every rank and equal (up to float summation order) to
    ``model.mean_loss``; ``.backward()`` leaves each rank's gradients by the
    module docstring's rule.
  """
  encoder = model.encoder
  layers = _stage_layers(encoder, mesh, pipe_axis)
  m = num_microbatches
  pipe = _Axis.of(mesh, pipe_axis)
  axes = [pipe] + ([_Axis.of(mesh, data_axis)] if data_axis else [])

  def loss_fn(params, frames, num_frames, labels, num_labels):
    frames, num_frames, labels, num_labels = _data_rows(
        mesh, data_axis, m, model.device, frames, num_frames, labels,
        num_labels)
    frames = frames.to(torch.float32)
    count = []

    def tail(params, y, j):
      """[loss sum, feasible count] of microbatch j."""
      enc = params['encoder']
      nf = sched.rows(num_frames, j)
      encoded = encoder.finalize(enc['final_ln_scale'], enc['final_ln_bias'],
                                 y, sched.mask(j))
      per_seq = model.lattice(params['lattice'], frames=encoded,
                              num_frames=nf, labels=sched.rows(labels, j),
                              num_labels=sched.rows(num_labels, j))
      finite = torch.isfinite(per_seq)
      return torch.stack([torch.where(finite, per_seq, 0.0).sum(),
                          finite.sum().to(per_seq.dtype)])

    def finish(results):
      total = (torch.stack(results).sum(0) if results is not None else
               torch.zeros(2, device=frames.device))
      _sum_over(axes, [total])
      count.append(total[1].clamp(min=1))
      return total[0] / count[0]

    def tail_cotangent(ct, j):
      return torch.stack([ct / count[0], torch.zeros_like(ct)])

    sched = _Schedule(encoder, pipe, layers, m, frames, num_frames, tail,
                      finish, tail_cotangent)
    return _run(sched, params)

  return loss_fn


def make_pp_encode_fn(model, mesh, num_microbatches: int,
                      pipe_axis: str = 'pipe',
                      data_axis: Optional[str] = None):
  """Builds a pipelined ENCODE callable (no loss consumption).

  The same GPipe schedule as ``make_pp_loss_fn``, but the last stage keeps
  each finished microbatch's final-LN output instead of consuming it with
  the lattice: the composition hook for pairing pipeline-parallel encoding
  with a differently sharded lattice loss (pp x seq:
  ``make_pp_seq_train_step``). The output is broadcast over the pipe axis
  from the last stage; its backward takes the last stage's own cotangent.

  Returns:
    ``encode(encoder_params, frames, num_frames) -> [rows, max_t,
    model_size]``: the whole batch in, this rank's rows of the data axis
    encoded (all of them without ``data_axis``; padding frames zero), the
    same on every pipe rank.
  """
  encoder = model.encoder
  layers = _stage_layers(encoder, mesh, pipe_axis)
  m = num_microbatches
  pipe = _Axis.of(mesh, pipe_axis)

  def encode(encoder_params, frames, num_frames):
    frames, num_frames = _data_rows(mesh, data_axis, m, model.device, frames,
                                    num_frames)
    frames = frames.to(torch.float32)

    def tail(params, y, j):
      enc = params['encoder']
      return encoder.finalize(enc['final_ln_scale'], enc['final_ln_bias'], y,
                              sched.mask(j))

    def finish(results):
      out = (torch.cat(results) if results is not None else
             torch.empty(frames.shape[:2] + (encoder.model_size,),
                         device=frames.device))
      return pipe.broadcast([out], pipe.size - 1)[0]

    sched = _Schedule(encoder, pipe, layers, m, frames, num_frames, tail,
                      finish, lambda ct, j: sched.rows(ct, j))
    return _run(sched, {'encoder': encoder_params})

  return encode


def make_pp_seq_train_step(model, optimizer, mesh, num_microbatches: int,
                           pipe_axis: str = 'pipe', seq_axis: str = 'seq',
                           data_axis: Optional[str] = None,
                           fused: str = 'never'
                           ) -> sequence.ReplicatedTrainStep:
  """A train step composing pipeline and sequence parallelism.

  The encoder runs GPipe-pipelined over ``pipe_axis``
  (``make_pp_encode_fn``); the lattice loss, whose backward needs the
  per-frame alpha history, runs through the time-sharded relay over
  ``seq_axis`` (``parallel.sequence.loss_time_sharded``; ``fused='auto'``:
  its denominator through the kernel relay), so the encoder's activations
  and the lattice's scale down with their axes. Gradients follow the module
  docstring's pp x seq rule.

  Returns ``step(state, frames, num_frames, labels, num_labels) ->
  (state, loss)`` (``sequence.ReplicatedTrainStep``), the whole batch on
  every rank.
  """
  encode = make_pp_encode_fn(model, mesh, num_microbatches,
                             pipe_axis=pipe_axis, data_axis=data_axis)
  pipe, seq = _Axis.of(mesh, pipe_axis), _Axis.of(mesh, seq_axis)
  data = _Axis.of(mesh, data_axis) if data_axis else None
  lattice_axes = [seq] + ([data] if data else [])

  def objective(params, frames, num_frames, labels, num_labels):
    encoded = encode(params['encoder'], frames, num_frames)
    num_frames, labels, num_labels = _data_rows(
        mesh, data_axis, num_microbatches, model.device, num_frames, labels,
        num_labels)
    return sequence.mean_over_feasible(sequence.loss_time_sharded(
        model.lattice, params['lattice'], encoded, num_frames, labels,
        num_labels, mesh, seq_axis, fused=fused, batch_axis=data_axis), data)

  return sequence.ReplicatedTrainStep(
      optimizer, objective,
      {'encoder': [pipe] + lattice_axes, 'lattice': lattice_axes})


def make_pp_train_step(model, optimizer, mesh, num_microbatches: int,
                       pipe_axis: str = 'pipe',
                       data_axis: Optional[str] = None
                       ) -> sequence.ReplicatedTrainStep:
  """Builds a pipeline-parallel GNAT train step.

  Signature matches the other ``make_*_train_step`` factories:
  ``(state, frames, num_frames, labels, num_labels) -> (state, loss)``,
  the whole batch on every rank. The loss is ``make_pp_loss_fn``'s; every
  gradient is summed over the pipe and data axes (the module docstring's
  rule), and every rank applies the same update to the whole parameters.
  """
  loss_fn = make_pp_loss_fn(model, mesh, num_microbatches,
                            pipe_axis=pipe_axis, data_axis=data_axis)
  axes = [_Axis.of(mesh, pipe_axis)] + (
      [_Axis.of(mesh, data_axis)] if data_axis else [])

  def objective(params, *batch):
    loss = loss_fn(params, *batch)
    return loss, loss.detach()

  return sequence.ReplicatedTrainStep(optimizer, objective,
                                      {'encoder': axes, 'lattice': axes})
