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

"""Vocab-sharded (tensor-parallel) recognition-lattice computations, for
Hopper, with the plain versions of their kernels.

Counterpart of ``last_torch_tpu/ops/sharded_scan.py``. With the joint
network's vocabulary head ``[h, V]`` sharded over the ranks of a model
process group, the lattice's log partition runs as a per-frame loop:

* each frame's reduction ``red[b, y] = logsumexp_s(vec[b, s] + lex[b, s,
  y])`` over the rank's own vocab shard, and the blank head, run in
  ``frame_reduce`` (a ``torch.autograd.Function``): on a CUDA tensor the
  kernels of ``csrc/sharded_scan.cu`` (the ports of
  ``_frame_reduce_fwd_kernel`` and ``_frame_reduce_bwd_kernel``), which
  never store the [B, S, Vl] lexical block in the forward; on a CPU tensor
  their plain versions ``frame_reduce_plain`` /
  ``frame_reduce_backward_plain``;
* a differentiable all-gather of the [B, Vl] reduction along the vocab axis
  (``gather``) per within-frame expansion; in the bigram the gathered
  reduction is the next lexical-destination alpha block;
* the FrameDependent / FrameLabelDependent recursion around it, ordinary
  ``semirings.Log`` algebra on [B, S] tensors (``sharded_shortest_distance``).

``tp_lattice_loss`` adds the numerator on the gathered head, and
``parallel/sharding.py::make_tp_train_step`` drives it. The model axis is a
``torch.distributed`` process group; with no group there is one shard.

Rounding, as the TPU kernels: the joint is formed in float32 and rounded to
the compute type for the head products, whose sums are float32; the
backward rounds ``d_lex = d_red * p`` to the compute type for the vocab
head's products and keeps the blank terms in float32. Compute type as
``fused_scan.compute_dtype_for``: bfloat16 on the card, float32 on the CPU
(the JAX package: bfloat16 compiled, float32 interpreted).

What the TPU kernels needed and the Hopper kernels do not: the tile-major
``[NV, h, Vt]`` / ``[NS, Bt, s_tile]`` layouts and ``fori_loop`` spill
workarounds, the 128-lane alignment of ``S_pad`` and ``V_local`` and a
VMEM limit. The port's kernels take any B, S, h and Vl, so the states are
not padded to 128: vectors and alphas are [B, S].
"""

from __future__ import annotations

import ctypes
import functools
from typing import Any, Optional

import torch

from last_torch_tpu_torch import semirings
from last_torch_tpu_torch.ops import fused_scan
from last_torch_tpu_torch.ops import joint_head

# Calls that launched the CUDA forward / backward kernels, for runs that must
# show which kernels they went through. Only CUDA tensors count.
forward_launches = 0
backward_launches = 0

_LIB = None
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# The forward's state tile (its (max, sum) partials are per state tile) and
# the rows of d_lex summed per partial of d_vb, as csrc/sharded_scan.cu.
_STATE_TILE = 64
_COLUMN_CHUNK = 64
# The float32 backward's joint_backward (csrc/joint_tiles.cuh): its tile
# (rows, labels or hidden units; also the depth slice its head-gradient
# contraction is split in) and the blocks an SM holds at once, which that
# split fills.
_F32_TILE, _F32_BLOCKS_PER_SM = 64, 4


def f32_backward_scratch(batch: int, num_states: int, hidden: int, vocab: int,
                         sms: int) -> tuple[int, dict]:
  """(splits, name -> shape) of joint_tiles.cuh's ``joint_backward``
  scratch, all float32: per 64-state tile partials of d_pf and d_blank_w,
  and ``splits`` partials of d_vocab_w, split over the (batch row, state
  tile) pairs into as many parts as one wave of blocks holds."""
  tiles = lambda n: -(-n // _F32_TILE)
  slices = max(1, batch * tiles(num_states))
  splits = max(1, min(slices, _F32_BLOCKS_PER_SM * sms //
                      max(1, tiles(hidden) * tiles(vocab))))
  splits = -(-slices // -(-slices // splits))  # no empty split
  t64 = tiles(num_states)
  return splits, {'dpf_part': (t64, batch, hidden),
                  'dbw_part': (t64, hidden),
                  'dw_part': (splits, hidden, vocab)}


def _check_inputs(vec, pf_t, pc, vw, vb, bw, compute_dtype, **others):
  """Checks what the kernels take; returns (B, S, h, Vl)."""
  if vec.ndim != 2 or pc.ndim != 2 or vw.ndim != 2:
    raise ValueError('expected vec [B, S], pc [S, h] and vw [h, Vl], got '
                     f'{tuple(vec.shape)}, {tuple(pc.shape)} and '
                     f'{tuple(vw.shape)}')
  (batch, num_states), hidden, vocab = vec.shape, pc.shape[1], vw.shape[1]
  expected = {
      'vec': (vec, (batch, num_states)),
      'pf_t': (pf_t, (batch, hidden)),
      'pc': (pc, (num_states, hidden)),
      'vw': (vw, (hidden, vocab)),
      'vb': (vb, (vocab,)),
      'bw': (bw, (hidden,)),
      **others,
  }
  for name, (x, shape) in expected.items():
    shape = tuple(shape)
    if tuple(x.shape) != shape or x.dtype != torch.float32:
      raise ValueError(f'{name} should be torch.float32 of shape {shape}, '
                       f'got {x.dtype} of shape {tuple(x.shape)}')
    if x.device != vec.device:
      raise ValueError(f'{name} is on {x.device}, vec on {vec.device}')
    if not x.is_contiguous():
      raise ValueError(f'{name} must be contiguous')
  if vocab < 1:
    raise ValueError('the vocab shard is empty')
  if compute_dtype not in _DTYPE_CODES:
    raise ValueError('compute_dtype must be float32 or bfloat16, got '
                     f'{compute_dtype}')
  return batch, num_states, hidden, vocab


def library() -> ctypes.CDLL:
  """The kernel library, built from csrc/sharded_scan.cu at first use."""
  global _LIB
  if _LIB is None:
    from last_torch_tpu_torch.ops import build
    lib = build.load('sharded_scan.cu')
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.frame_reduce_forward.argtypes = [i] + [p] * 11 + [i] * 4 + [
        p, p, i, p]
    lib.frame_reduce_forward.restype = i
    lib.frame_reduce_backward.argtypes = [i] + [p] * 27 + [i] * 6 + [p]
    lib.frame_reduce_backward.restype = i
    lib.frame_reduce_error_string.argtypes = [i]
    lib.frame_reduce_error_string.restype = ctypes.c_char_p
    _LIB = lib
  return _LIB


def _launch(device, what, call):
  """Runs ``call(lib, stream)`` on the current stream of ``device`` and
  raises on a launch error."""
  if device.type != 'cuda':
    raise ValueError(f'no frame_reduce kernel for device {device}')
  lib = library()
  with torch.cuda.device(device):
    status = call(lib, torch.cuda.current_stream(device).cuda_stream)
  if status != 0:
    raise RuntimeError(f'frame_reduce {what} kernel launch failed: '
                       f'{lib.frame_reduce_error_string(status).decode()}')


def frame_reduce_forward(vec: torch.Tensor, pf_t: torch.Tensor,
                         pc: torch.Tensor, vw: torch.Tensor, vb: torch.Tensor,
                         bw: torch.Tensor, bb: torch.Tensor, *,
                         compute_dtype: torch.dtype):
  """One frame's vocab-shard reduction and blank head: the kernel on CUDA,
  the plain version on CPU.

  Args:
    vec: [B, S] float32 source-state vector (alpha or an expansion; -inf at
      dead states).
    pf_t: [B, h] float32 projected frame.
    pc: [S, h] float32 projected context states.
    vw, vb: The local vocab-head shard, [h, Vl] and [Vl], float32.
    bw, bb: The blank head, [h] and [], float32.
    compute_dtype: torch.float32 or torch.bfloat16, the type the joint and
      the head weights are rounded to before the float32 products.

  Returns:
    (red [B, Vl], blank [B, S]), float32: red[b, y] = logsumexp_s(vec[b, s]
    + lex[b, s, y]), -inf where every term is.
  """
  global forward_launches
  batch, num_states, _, vocab = _check_inputs(vec, pf_t, pc, vw, vb, bw,
                                              compute_dtype, bb=(bb, ()))
  if vec.device.type == 'cpu':
    return frame_reduce_plain(vec, pf_t, pc, vw, vb, bw, bb,
                              compute_dtype=compute_dtype)
  device = vec.device
  if device.type != 'cuda':
    raise ValueError(f'no frame_reduce kernel for device {device}')
  red = torch.empty((batch, vocab), device=device)
  blank = torch.empty((batch, num_states), device=device)
  # The scratch in one buffer: the call runs once per frame and expansion,
  # where each allocation costs host time.
  max_blocks, offsets, size = _forward_workspace(
      batch, num_states, pc.shape[1], vocab, compute_dtype,
      joint_head.sm_count(device))
  workspace = torch.empty(size, dtype=torch.uint8, device=device)
  ptr = lambda name: (workspace.data_ptr() + offsets[name]
                      if name in offsets else None)
  _launch(device, 'forward', lambda lib, stream: lib.frame_reduce_forward(
      _DTYPE_CODES[compute_dtype], vec.data_ptr(), pf_t.data_ptr(),
      pc.data_ptr(), vw.data_ptr(), vb.data_ptr(), bw.data_ptr(),
      bb.data_ptr(), ptr('part_m'), ptr('part_s'), red.data_ptr(),
      blank.data_ptr(), batch, num_states, pc.shape[1], vocab, ptr('joint'),
      ptr('vw16'), max_blocks, stream))
  forward_launches += 1
  return red, blank


def frame_reduce_plain(vec: torch.Tensor, pf_t: torch.Tensor,
                       pc: torch.Tensor, vw: torch.Tensor, vb: torch.Tensor,
                       bw: torch.Tensor, bb: torch.Tensor, *,
                       compute_dtype: torch.dtype):
  """``frame_reduce_forward`` in plain PyTorch, in the inputs' own type."""
  rnd = joint_head._rounding(compute_dtype)
  joint = rnd(torch.tanh(pc[None] + pf_t[:, None]))  # [B, S, h]
  lex = joint @ rnd(vw) + vb  # [B, S, Vl]
  blank = joint @ rnd(bw) + bb
  return torch.logsumexp(vec[:, :, None] + lex, dim=1), blank


def backward_scratch(batch: int, num_states: int, hidden: int, vocab: int,
                     grid: fused_scan.WgmmaGrid) -> dict:
  """name -> (shape, dtype) of the scratch of the bfloat16 backward kernels
  (``csrc/sharded_scan.cu``, namespace ``hopper``) on ``grid``
  (``fused_scan.wgmma_grid``): d_lex reaches device memory once, in
  bfloat16; the joint twice, in bfloat16 for the products and in float32
  for the tanh derivative."""
  hp, vp = grid.hidden_pad, grid.vocab_pad
  t64 = -(-num_states // 64)
  f32, bf16 = torch.float32, torch.bfloat16
  return {
      'd_lex': ((batch, num_states, vp), bf16),
      'joint': ((batch, num_states, hp), bf16),
      'joint32': ((batch, num_states, hidden), f32),
      'vw16': ((hp, vp), bf16),
      'dvec_part': ((grid.strips, batch, num_states), f32),
      'dvb_part': ((batch * t64, vocab), f32),
      'dbb_part': ((batch * t64,), f32),
      'dpf_part': ((t64, batch, hidden), f32),
      'dbw_part': ((batch * t64, hidden), f32),
      'dpc_part': ((grid.dsplits, num_states, hidden), f32),
      'dw_part': ((grid.ksplits, hidden, vocab), f32),
  }


def forward_scratch(batch: int, num_states: int, hidden: int, vocab: int,
                    compute_dtype: torch.dtype,
                    plan: Optional[joint_head.ReducePlan] = None) -> dict:
  """name -> (shape, dtype) of the forward's scratch: the (max, sum)
  partials per 64-state tile and, in bfloat16 (on ``plan``,
  ``joint_head.reduce_plan``), the padded bfloat16 joint and head of
  csrc/head_product.cuh's column reduction."""
  part = ((-(-num_states // _STATE_TILE), batch, vocab), torch.float32)
  scratch = {'part_m': part, 'part_s': part}
  if compute_dtype == torch.bfloat16:
    scratch['joint'] = ((batch, num_states, plan.hidden_pad), torch.bfloat16)
    scratch['vw16'] = ((plan.hidden_pad, plan.vocab_pad), torch.bfloat16)
  return scratch


@functools.lru_cache(maxsize=64)
def _forward_workspace(batch, num_states, hidden, vocab, compute_dtype, sms):
  """(largest persistent grid, byte offsets, total bytes) of the forward's
  scratch in one buffer (``forward_scratch``)."""
  plan = (joint_head.reduce_plan(batch, num_states, hidden, vocab, sms)
          if compute_dtype == torch.bfloat16 else None)
  return ((plan.max_blocks if plan else 0),
          *joint_head.layout(forward_scratch(batch, num_states, hidden, vocab,
                                   compute_dtype, plan)))


@functools.lru_cache(maxsize=64)
def _workspace(batch, num_states, hidden, vocab, sms):
  """((splits, dsplits), byte offsets, total bytes) of the bfloat16
  backward's scratch in one buffer (``backward_scratch``, each buffer
  256-byte aligned)."""
  grid = fused_scan.wgmma_grid(batch, num_states, hidden, vocab, sms)
  return ((grid.ksplits, grid.dsplits),
          *joint_head.layout(backward_scratch(batch, num_states, hidden,
                                              vocab, grid)))


def frame_reduce_backward(vec: torch.Tensor, pf_t: torch.Tensor,
                          pc: torch.Tensor, vw: torch.Tensor,
                          vb: torch.Tensor, bw: torch.Tensor,
                          red: torch.Tensor, d_red: torch.Tensor,
                          d_blank: torch.Tensor, *,
                          compute_dtype: torch.dtype):
  """The VJP of ``frame_reduce_forward``: the kernel on CUDA, the plain
  version on CPU.

  Args:
    vec, pf_t, pc, vw, vb, bw: As ``frame_reduce_forward``.
    red: [B, Vl] the forward's reduction.
    d_red: [B, Vl] float32 cotangent of red.
    d_blank: [B, S] float32 cotangent of blank.
    compute_dtype: As ``frame_reduce_forward``.

  Returns:
    (d_vec [B, S], d_pf [B, h], d_pc [S, h], d_vw [h, Vl], d_vb [Vl], d_bw
    [h], d_bb []), float32; d_vec is 0 at the -inf states of vec.
  """
  global backward_launches
  batch, num_states, hidden, vocab = _check_inputs(
      vec, pf_t, pc, vw, vb, bw, compute_dtype,
      red=(red, (vec.shape[0], vw.shape[1])),
      d_red=(d_red, (vec.shape[0], vw.shape[1])),
      d_blank=(d_blank, tuple(vec.shape)))
  if vec.device.type == 'cpu':
    return frame_reduce_backward_plain(vec, pf_t, pc, vw, vb, bw, red, d_red,
                                       d_blank, compute_dtype=compute_dtype)
  device = vec.device
  empty = lambda *shape: torch.empty(shape, device=device)
  grads = (empty(batch, num_states), empty(batch, hidden),
           empty(num_states, hidden), empty(hidden, vocab), empty(vocab),
           empty(hidden), empty())
  if compute_dtype == torch.bfloat16:
    # The scratch in one buffer: the call runs once per frame and
    # expansion, where each allocation costs host time.
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    (splits, dsplits), offsets, size = _workspace(batch, num_states, hidden,
                                                  vocab, sms)
    workspace = torch.empty(size, dtype=torch.uint8, device=device)
    ptr = lambda name: workspace.data_ptr() + offsets[name]
  else:  # float32: the CUDA-core kernels, d_lex in float32
    splits, tiles = f32_backward_scratch(batch, num_states, hidden, vocab,
                                         joint_head.sm_count(device))
    scratch = dict(
        d_lex=empty(batch, num_states, vocab),
        dvb_part=empty(-(-batch * num_states // _COLUMN_CHUNK), vocab),
        **{name: empty(*shape) for name, shape in tiles.items()})
    dsplits = 0
    ptr = lambda name: (scratch[name].data_ptr() if name in scratch else
                        None)
  _launch(device, 'backward', lambda lib, stream: lib.frame_reduce_backward(
      _DTYPE_CODES[compute_dtype], vec.data_ptr(), pf_t.data_ptr(),
      pc.data_ptr(), vw.data_ptr(), vb.data_ptr(), bw.data_ptr(),
      red.data_ptr(), d_red.data_ptr(), d_blank.data_ptr(),
      *(ptr(n) for n in ('d_lex', 'dvb_part', 'dpf_part', 'dbw_part',
                         'dpc_part', 'dw_part')),
      *(g.data_ptr() for g in grads),
      *(ptr(n) for n in ('joint', 'joint32', 'vw16', 'dvec_part',
                         'dbb_part')),
      batch, num_states, hidden, vocab, splits, dsplits, stream))
  backward_launches += 1
  return grads


def frame_reduce_backward_plain(vec: torch.Tensor, pf_t: torch.Tensor,
                                pc: torch.Tensor, vw: torch.Tensor,
                                vb: torch.Tensor, bw: torch.Tensor,
                                red: torch.Tensor, d_red: torch.Tensor,
                                d_blank: torch.Tensor, *,
                                compute_dtype: torch.dtype):
  """``frame_reduce_backward`` in plain PyTorch, in the inputs' own type:
  the lexical block recomputed, ``d_lex`` rounded to the compute type for
  the vocab head's products, the blank terms unrounded, as the kernel."""
  rnd = joint_head._rounding(compute_dtype)
  joint = torch.tanh(pc[None] + pf_t[:, None])  # [B, S, h]
  rounded = rnd(joint)
  lex = rounded @ rnd(vw) + vb
  safe_red = torch.where(torch.isfinite(red), red, torch.zeros_like(red))
  # The clip guards compute-type rounding; true exponents are <= 0.
  p = torch.exp(torch.clamp(vec[:, :, None] + lex - safe_red[:, None],
                            max=60.0))
  d_lex = rnd(d_red[:, None] * p)
  d_joint = d_lex @ rnd(vw).t() + d_blank[..., None] * bw
  du = d_joint * (1 - joint * joint)
  return (d_lex.sum(-1), du.sum(1), du.sum(0),
          torch.einsum('bsh,bsv->hv', rounded, d_lex), d_lex.sum((0, 1)),
          torch.einsum('bsh,bs->h', joint, d_blank), d_blank.sum())


class _FrameReduce(torch.autograd.Function):
  """(red, blank) with the backward kernel as its VJP."""

  @staticmethod
  def forward(ctx, vec, pf_t, pc, vw, vb, bw, bb, compute_dtype):
    red, blank = frame_reduce_forward(vec, pf_t, pc, vw, vb, bw, bb,
                                      compute_dtype=compute_dtype)
    ctx.compute_dtype = compute_dtype
    ctx.save_for_backward(vec, pf_t, pc, vw, vb, bw, red)
    return red, blank

  @staticmethod
  def backward(ctx, d_red, d_blank):
    vec, pf_t, pc, vw, vb, bw, red = ctx.saved_tensors
    if d_red is None:
      d_red = torch.zeros_like(red)
    if d_blank is None:
      d_blank = torch.zeros_like(vec)
    grads = frame_reduce_backward(vec, pf_t, pc, vw, vb, bw, red,
                                  d_red.contiguous(), d_blank.contiguous(),
                                  compute_dtype=ctx.compute_dtype)
    return (*grads, None)


def frame_reduce(vec: torch.Tensor, pf_t: torch.Tensor, pc: torch.Tensor,
                 vw: torch.Tensor, vb: torch.Tensor, bw: torch.Tensor,
                 bb: torch.Tensor, compute_dtype: Optional[torch.dtype] = None):
  """One frame's blank head and vocab-shard logsumexp reduction,
  differentiable through the backward kernel (the arguments and results of
  ``frame_reduce_forward``). ``compute_dtype`` None takes
  ``fused_scan.compute_dtype_for(vec.device)``."""
  if compute_dtype is None:
    compute_dtype = fused_scan.compute_dtype_for(vec.device)
  return _FrameReduce.apply(vec, pf_t, pc, vw, vb, bw, bb, compute_dtype)


class _Gather(torch.autograd.Function):
  """All-gather along ``dim`` over a process group; its VJP sums the
  cotangents of every rank and keeps this rank's slice."""

  @staticmethod
  def forward(ctx, x, dim, group):
    import torch.distributed as dist
    ctx.dim, ctx.group, ctx.size = dim, group, x.shape[dim]
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim)

  @staticmethod
  def backward(ctx, g):
    import torch.distributed as dist
    g = g.contiguous().clone()
    dist.all_reduce(g, group=ctx.group)
    rank = dist.get_rank(ctx.group)
    return g.narrow(ctx.dim, rank * ctx.size, ctx.size), None, None


def gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
  """``x`` of every rank of ``group`` concatenated along ``dim`` in rank
  order (differentiable); ``x`` itself when ``group`` is None."""
  if group is None:
    return x
  return _Gather.apply(x, dim, group)


def tp_supported(lattice) -> bool:
  """Whether the tensor-parallel lattice loss covers this lattice: any
  ``LocallyNormalizedWeightFn`` (its loss is the numerator alone, run on the
  gathered head), or exactly a ``JointWeightFn`` over a bigram
  ``FullNGram`` with a FrameDependent or FrameLabelDependent alignment."""
  from last_torch_tpu_torch import alignments, contexts, weight_fns
  weight_fn = lattice.weight_fn
  if isinstance(weight_fn, weight_fns.LocallyNormalizedWeightFn):
    return True
  if type(weight_fn) is not weight_fns.JointWeightFn:
    return False
  if not isinstance(lattice.context, contexts.FullNGram):
    return False
  if lattice.context.context_size != 1:
    return False
  return isinstance(
      lattice.alignment,
      (alignments.FrameDependent, alignments.FrameLabelDependent))


def tp_plan(lattice, vocab_size: int, model_parallel: int,
            device='cuda') -> Optional[str]:
  """Whether this configuration can run the tensor-parallel lattice loss,
  and through what.

  Keeps the JAX package's structural gate (``tp_supported``) and its rules
  that ``fused == 'never'`` and a vocabulary that ``model_parallel`` does
  not divide take no plan. Its 128-lane rule on the local shard and its
  TPU-backend rule are gone: the port's kernels take any shard width, and
  ``frame_reduce`` chooses the kernels or their plain versions by device,
  so on the CPU the plan is the plain route, where the JAX package has
  none off the TPU without interpret mode.

  Returns:
    None when the configuration takes no tensor-parallel plan; otherwise
    'kernel' (``device`` is a CUDA device) or 'plain'.
  """
  if lattice.fused == 'never' or not tp_supported(lattice):
    return None
  if model_parallel < 1 or vocab_size % model_parallel:
    return None
  return 'kernel' if torch.device(device).type == 'cuda' else 'plain'


def sharded_shortest_distance(wf_params: dict[str, Any], cache: torch.Tensor,
                              frames: torch.Tensor, num_frames, *,
                              max_expansions: int, frame_dependent: bool,
                              num_context_states: int, group=None,
                              alpha0: Optional[torch.Tensor] = None,
                              t_offset: int = 0,
                              return_alpha: bool = False,
                              reduce=None) -> torch.Tensor:
  """Log-semiring shortest distance with the vocab head sharded.

  Each rank runs this on its own vocab shard (``wf_params['vocab_w']`` /
  ``['vocab_b']``) with every other argument the same as on the other ranks
  of ``group`` (or its batch rows, under data parallelism). Differentiable
  through the ``frame_reduce`` kernels' VJP and the gathers'. Per frame it
  runs ``frame_reduce`` once under FrameDependent and ``max_expansions``
  times under FrameLabelDependent, each followed by a gather of the [B, Vl]
  reduction over ``group``.

  Args:
    wf_params: JointWeightFn parameters; the vocab head holds this rank's
      shard.
    cache: [S, embedding] context embeddings.
    frames: [B, T, feature] frames.
    num_frames: [B] frame counts.
    max_expansions: k of FrameLabelDependent.
    frame_dependent: FrameDependent vs FrameLabelDependent recursion.
    num_context_states: S = 1 + the global vocabulary (a bigram).
    group: The ``torch.distributed`` process group the vocabulary is
      sharded over (ranks in vocab order); None for one shard.
    alpha0: Optional [B, S] initial alpha (log space); the one-hot start
      state by default. With ``t_offset`` and ``return_alpha`` it chains
      blocks of frames.
    t_offset: Global frame index of ``frames[:, 0]`` for the padding test
      (frames at t >= num_frames leave alpha unchanged).
    return_alpha: Return the final [B, S] alpha instead of its log-sum.
    reduce: The differentiable (vec, pf_t, pc, vw, vb, bw, bb) -> (red,
      blank) of each frame; ``frame_reduce`` (the kernels on the card) by
      default. E.g. a float64 reference on the card runs
      ``frame_reduce_plain`` here.

  Returns:
    [B] log-partition values, or the final alpha when ``return_alpha``.
  """
  batch, max_t, _ = frames.shape
  num_frames = torch.as_tensor(num_frames, device=frames.device)
  vocab = num_context_states - 1
  shards = 1 if group is None else group.size()
  v_local = wf_params['vocab_w'].shape[-1]
  if v_local * shards != vocab:
    raise ValueError(
        f'sharded_shortest_distance: {shards} vocab shards of {v_local} do '
        f'not make the global vocabulary of {vocab}')
  pf = torch.einsum('btf,fh->tbh', frames,
                    wf_params['frame_proj']).contiguous()
  pc = (cache @ wf_params['context_proj']).contiguous()
  head = [wf_params[n] for n in ('vocab_w', 'vocab_b', 'blank_w', 'blank_b')]
  log = semirings.Log
  start_col = frames.new_full((batch, 1), float('-inf'))
  reduce = reduce or frame_reduce

  def reduce_gather(vec, pf_t):
    red, blank = reduce(vec, pf_t, pc, *head)
    return torch.cat([start_col, gather(red, 1, group)], dim=1), blank

  if alpha0 is None:
    alpha0 = frames.new_full((batch, num_context_states), float('-inf'))
    alpha0[:, 0] = 0.0
  alpha = alpha0
  for t in range(max_t):
    expanded, blank = reduce_gather(alpha, pf[t])
    if frame_dependent:
      next_alpha = log.plus(alpha + blank, expanded)
    else:
      next_alpha = alpha + blank
      for i in range(1, max_expansions + 1):
        next_alpha = log.plus(next_alpha, expanded + blank)
        if i < max_expansions:
          expanded, _ = reduce_gather(expanded, pf[t])
    alpha = torch.where((t_offset + t >= num_frames)[:, None], alpha,
                        next_alpha)
  if return_alpha:
    return alpha
  return log.sum(alpha, axis=-1)


def tp_lattice_loss(lattice, params: dict[str, Any], frames: torch.Tensor,
                    num_frames, labels, num_labels, *, group=None,
                    reduce=None) -> torch.Tensor:
  """The recognition-lattice loss with the vocab head sharded over
  ``group``: ``RecognitionLattice.loss`` computed from this rank's shard.

  The numerator (the string forward) runs on the vocab head gathered from
  every shard, whose gathers' VJP routes the head gradients back to the
  shards; the globally normalized denominator runs
  ``sharded_shortest_distance`` on the local shard. A
  ``LocallyNormalizedWeightFn`` returns minus the numerator.

  Args:
    lattice: The RecognitionLattice (``tp_supported``).
    params: Lattice parameters whose vocab head holds this rank's shard.
    frames: [B, T, feature] encoded frames.
    num_frames, labels, num_labels: As ``RecognitionLattice.loss``.
    group, reduce: As ``sharded_shortest_distance``.

  Returns:
    [B] per-sequence loss.
  """
  from last_torch_tpu_torch import alignments, weight_fns
  wf_local = params['weight_fn']
  full_params = dict(params, weight_fn=dict(
      wf_local, vocab_w=gather(wf_local['vocab_w'], 1, group),
      vocab_b=gather(wf_local['vocab_b'], 0, group)))
  cache = lattice.build_cache(params)
  num_frames, num_labels, labels = lattice._check_string_args(
      frames, num_frames, labels, num_labels)
  numerator = lattice._string_forward(full_params, cache, frames, num_frames,
                                      labels, num_labels, semirings.Log)
  if isinstance(lattice.weight_fn, weight_fns.LocallyNormalizedWeightFn):
    return -numerator
  frame_dependent = isinstance(lattice.alignment, alignments.FrameDependent)
  denominator = sharded_shortest_distance(
      wf_local, cache, frames, num_frames,
      max_expansions=(0 if frame_dependent else
                      lattice.alignment.max_expansions),
      frame_dependent=frame_dependent,
      num_context_states=lattice.context.shape()[0], group=group,
      reduce=reduce)
  return denominator - numerator
