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

"""The joint network and its heads over every context state, for Hopper,
and its plain versions.

Counterpart of ``last_torch_tpu/ops/joint_head.py``: ``JointWeightFn.apply``
with ``state=None`` computes ``tanh(pc[s] + pf[b])`` through the blank and
vocabulary heads for every (batch row, context state) pair, once per frame
on the lattice's generic routes (the forward algorithm, the backward
algorithm's weight VJP, the generic decode and posteriors). The forward
(``_fwd_kernel`` there) and its VJP (``_bwd_kernel``) are the CUDA kernels
of ``csrc/joint_head.cu``, reached through ``joint_head_forward`` and
``joint_head_backward``: on a CUDA tensor they launch the kernels, on a CPU
tensor they run ``joint_head_forward_plain`` / ``joint_head_backward_plain``.
``blank_lexical``, the drop-in for the ``state=None`` branch, joins them in
a ``torch.autograd.Function``, as the JAX package's custom VJP does; the
projections ``frame @ frame_proj`` and ``cache @ context_proj`` stay
``torch.matmul`` through ``JointWeightFn._mm``, and autograd carries their
gradients. The bfloat16 forward forms the joint once per call into a
bfloat16 scratch and runs the head product on wgmma over a persistent grid
(``forward_plan``); the bfloat16 backward stages the joint, the head and
the cotangent in bfloat16 for its two wgmma products (``backward_plan``).
float32 forms the joint once per call too, into a float32 scratch padded
to the tiles, beside a padded copy of the head, and runs its products on
register-blocked FMA tiles (64 x 256 a block, 8 x 8 entries a thread):
rows-major, or labels-major where a 256-label tile would be mostly
padding (``f32_labels_major``). The tiles run faster where a product reads
its operands along their rows, so the rows-major forward reads the joint
transposed and the backward's d_joint product the head transposed. The
forward's plan is ``f32_forward_plan``, the backward's ``backward_plan``
(its d_joint product over the flattened B S rows, its d_vocab_w product
split over them).

Rounding, as the TPU kernels: the joint is formed in float32 and rounded to
the compute type for the head products, whose sums are float32; the
backward rounds the cotangents to the compute type for both of its
products (d_joint and the head gradient), and the bias gradients are plain
float32 sums of the cotangents.

The gate (``supported``) keeps the JAX package's structural conditions:
``state is None``, a 2-D frame ([B, feature]) and a 2-D cache ([S,
embedding]), compute type None, float32 or bfloat16, float32 frame and
cache, and at least ``MIN_STATES`` (1024) context states, below which the
per-frame einsums are cheap. The TPU's VMEM limits (B <= 64, hidden a
multiple of 128 and <= 1024, V + 1 padded to 128 <= 2048) are not needed
by the Hopper design: a block stages one slice of each operand (16 or 64
deep) in shared memory whatever B, S, h and V are, so it sets no limit of
its own.
Outside the gate, on any device, ``JointWeightFn.apply`` takes its einsum
route, as the JAX package takes XLA.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import math
from typing import Any, Optional

import torch

# Calls that launched the CUDA forward / backward kernels, for runs that must
# show which kernels they went through. Only CUDA tensors count.
forward_launches = 0
backward_launches = 0

# The gate's least number of context states.
MIN_STATES = 1024

_LIB = None
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# The float32 FMA tiles (csrc/simt_tiles.cuh): 64 x 256 output tiles,
# 16-deep slices, two blocks an SM. The scratch pads rows, hidden units and
# labels to 64. Labels-major tiles (64 labels by 256 rows) where V is at
# most _F32_LABELS_MAJOR_VOCAB, and at least _F32_MIN_SPLIT_SLICES slices in
# each split of the d_vocab_w contraction.
_F32_ROWS, _F32_COLS, _F32_DEPTH, _F32_BLOCKS_PER_SM = 64, 256, 16, 2
_F32_LABELS_MAJOR_VOCAB = 128
_F32_MIN_SPLIT_SLICES = 32
# The bfloat16 forward's wgmma product (csrc/joint_head.cu, namespace
# hopper): 128-row, 128-label output tiles (two warpgroups of 64 rows),
# 64-deep stages, two blocks an SM.
_WG_ROWS, _WG_COLS, _WG_DEPTH, _WG_BLOCKS_PER_SM = 128, 128, 64, 2
# The (forward, backward) pair blank_lexical runs; None runs the kernel
# wrappers below. ``using`` swaps in another pair.
_PAIR = None


def supported(weight_fn, cache: torch.Tensor, frame: torch.Tensor,
              state: Optional[torch.Tensor]) -> bool:
  """Whether ``blank_lexical`` covers a ``JointWeightFn.apply`` call (the
  module docstring's gate), from shapes and types alone."""
  if state is not None:
    return False
  if frame.ndim != 2 or cache.ndim != 2:
    return False
  if weight_fn.compute_dtype not in (None, torch.float32, torch.bfloat16):
    return False
  if frame.dtype != torch.float32 or cache.dtype != torch.float32:
    return False
  return cache.shape[0] >= MIN_STATES


def blank_lexical(weight_fn, params: dict[str, Any], cache: torch.Tensor,
                  frame: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
  """Drop-in for the ``state=None`` branch of ``JointWeightFn.apply``.

  Returns (blank [B, S], lexical [B, S, V]), float32: the einsum route's
  values up to the products' summation order.
  """
  compute_dtype = weight_fn.compute_dtype or torch.float32
  pf = weight_fn._mm(frame, params['frame_proj'])
  pc = weight_fn._mm(cache, params['context_proj'])
  return _JointHead.apply(pc, pf, params['vocab_w'], params['blank_w'],
                          params['vocab_b'], params['blank_b'], compute_dtype)


@contextlib.contextmanager
def using(forward, backward):
  """Runs ``blank_lexical`` through the given (forward, backward) pair
  inside the block, e.g. the plain versions on CUDA tensors for an A/B
  against the kernels."""
  global _PAIR
  saved, _PAIR = _PAIR, (forward, backward)
  try:
    yield
  finally:
    _PAIR = saved


class _JointHead(torch.autograd.Function):
  """(blank, lexical) with the backward kernel as its VJP."""

  @staticmethod
  def forward(ctx, pc, pf, vocab_w, blank_w, vocab_b, blank_b,
              compute_dtype):
    forward, _ = _PAIR or (joint_head_forward, joint_head_backward)
    blank, lexical = forward(pc, pf, vocab_w, blank_w, vocab_b, blank_b,
                             compute_dtype=compute_dtype)
    ctx.compute_dtype = compute_dtype
    ctx.pair = _PAIR
    ctx.save_for_backward(pc, pf, vocab_w, blank_w)
    return blank, lexical

  @staticmethod
  def backward(ctx, g_blank, g_lexical):
    pc, pf, vocab_w, blank_w = ctx.saved_tensors
    _, backward = ctx.pair or (joint_head_forward, joint_head_backward)
    shape = (pf.shape[0], pc.shape[0])
    if g_blank is None:
      g_blank = pc.new_zeros(shape)
    if g_lexical is None:
      g_lexical = pc.new_zeros(shape + (vocab_w.shape[1],))
    d_pc, d_pf, d_vocab_w, d_blank_w = backward(
        pc, pf, vocab_w, blank_w, g_blank.contiguous(),
        g_lexical.contiguous(), compute_dtype=ctx.compute_dtype)
    return (d_pc, d_pf, d_vocab_w, d_blank_w, g_lexical.sum(dim=(0, 1)),
            g_blank.sum(), None)


def _check_inputs(pc, pf, vocab_w, blank_w, compute_dtype, **others):
  """Checks what the kernels take; returns (B, S, h, V)."""
  if pc.ndim != 2 or pf.ndim != 2:
    raise ValueError('expected pc [S, h] and pf [B, h], got '
                     f'{tuple(pc.shape)} and {tuple(pf.shape)}')
  (num_states, hidden), batch = pc.shape, pf.shape[0]
  vocab = vocab_w.shape[-1]
  expected = {
      'pc': (pc, (num_states, hidden)),
      'pf': (pf, (batch, hidden)),
      'vocab_w': (vocab_w, (hidden, vocab)),
      'blank_w': (blank_w, (hidden,)),
      **others,
  }
  for name, (x, shape) in expected.items():
    shape = tuple(shape)
    if tuple(x.shape) != shape or x.dtype != torch.float32:
      raise ValueError(f'{name} should be torch.float32 of shape {shape}, '
                       f'got {x.dtype} of shape {tuple(x.shape)}')
    if x.device != pc.device:
      raise ValueError(f'{name} is on {x.device}, pc on {pc.device}')
    if not x.is_contiguous():
      raise ValueError(f'{name} must be contiguous')
  if compute_dtype not in _DTYPE_CODES:
    raise ValueError('compute_dtype must be float32 or bfloat16, got '
                     f'{compute_dtype}')
  return batch, num_states, hidden, vocab


@dataclasses.dataclass(frozen=True)
class ForwardPlan:
  """The bfloat16 forward's scratch and grid (``forward_plan``).

  Attributes:
    hidden_pad, vocab_pad: h and V rounded up to the 64-deep stages; the
      joint scratch is [B S, hidden_pad], the head's bfloat16 copy
      [hidden_pad, vocab_pad], both bfloat16 and zero past h and V.
    tiles: the product's (128-row, 128-label) output tiles.
    blocks: its persistent grid: each block walks over tiles blocks apart.
  """
  hidden_pad: int
  vocab_pad: int
  tiles: int
  blocks: int


@functools.lru_cache(maxsize=64)
def forward_plan(batch: int, num_states: int, hidden: int, vocab: int,
                 sms: int) -> ForwardPlan:
  """The ``ForwardPlan`` of a bfloat16 forward on ``sms`` SMs: one block per
  output tile up to two blocks an SM."""
  cdiv = lambda n, m: -(-n // m)
  hp = cdiv(hidden, _WG_DEPTH) * _WG_DEPTH
  vp = cdiv(vocab, _WG_DEPTH) * _WG_DEPTH
  tiles = cdiv(batch * num_states, _WG_ROWS) * cdiv(vp, _WG_COLS)
  return ForwardPlan(hp, vp, tiles,
                     max(1, min(tiles, _WG_BLOCKS_PER_SM * sms)))


def f32_labels_major(vocab: int) -> bool:
  """Whether the float32 products put labels on the tiles' 64-wide side
  (a 256-label tile would be at least half padding)."""
  return vocab <= _F32_LABELS_MAJOR_VOCAB


def _cdiv(n: int, m: int) -> int:
  return -(-n // m)


def _f32_pads(batch: int, num_states: int, hidden: int, vocab: int):
  """(rows, hidden, labels) of the float32 scratch: B S, h and V rounded up
  to 64."""
  pad = lambda n: _cdiv(n, _F32_ROWS) * _F32_ROWS
  return pad(batch * num_states), pad(hidden), pad(vocab)


@dataclasses.dataclass(frozen=True)
class F32ForwardPlan:
  """The float32 forward's scratch and grid (``f32_forward_plan``).

  Attributes:
    labels_major: the product's orientation (``f32_labels_major``).
    rows_pad, hidden_pad, vocab_pad: B S, h and V rounded up to 64; the
      joint scratch is [rows_pad, hidden_pad], the head's copy [hidden_pad,
      vocab_pad], both float32 and zero past B S, h and V; rows-major also
      keeps the joint transposed, 'joint_t' [hidden_pad, rows_pad] (its
      product contracts over h and reads both operands along their rows).
    grid: the product's (x, y) blocks: (row tiles, 256-label strips)
      rows-major, (64-label tiles, 256-row strips) labels-major.
    offsets: name -> byte offset of each scratch buffer, 256-byte aligned.
    size: the workspace's bytes.
  """
  labels_major: bool
  rows_pad: int
  hidden_pad: int
  vocab_pad: int
  grid: tuple
  offsets: dict
  size: int


@functools.lru_cache(maxsize=64)
def f32_forward_plan(batch: int, num_states: int, hidden: int,
                     vocab: int) -> F32ForwardPlan:
  """The ``F32ForwardPlan`` of a float32 forward."""
  mp, hp, vp = _f32_pads(batch, num_states, hidden, vocab)
  labels_major = f32_labels_major(vocab)
  if labels_major:
    grid = (vp // _F32_ROWS, _cdiv(batch * num_states, _F32_COLS))
  else:
    grid = (mp // _F32_ROWS, _cdiv(vp, _F32_COLS))
  f32 = torch.float32
  scratch = {'joint': ((mp, hp), f32), 'head': ((hp, vp), f32)}
  if not labels_major:
    scratch['joint_t'] = ((hp, mp), f32)
  return F32ForwardPlan(labels_major, mp, hp, vp, grid, *layout(scratch))


@dataclasses.dataclass(frozen=True)
class ReducePlan:
  """The column-reduce product's scratch and grid (``reduce_plan``): the
  bfloat16 head product of the log-partition forward ('cache' mode) and of
  frame_reduce's forward, with lex reduced over each 64-state unit of a
  batch row in its epilogue.

  Attributes:
    hidden_pad, vocab_pad: h and V rounded up to the 64-deep stages; the
      joint scratch is [B, S, hidden_pad], the head's bfloat16 copy
      [hidden_pad, vocab_pad], both bfloat16 and zero past h and V.
    state_tiles: a row's 64-state units: its (max, sum) partials per label
      ([state_tiles, B, V] each).
    units: the 64-state units of every row, which the two warpgroups of a
      block take in consecutive pairs (a pair may span two rows).
    tiles: the product's output tiles (unit pairs by 128-label strips)
      with every row live.
    blocks: its persistent grid then, one block per tile up to two an SM.
    max_blocks: two blocks an SM, the grid's bound with fewer live rows.
  """
  hidden_pad: int
  vocab_pad: int
  state_tiles: int
  units: int
  tiles: int
  blocks: int
  max_blocks: int


@functools.lru_cache(maxsize=64)
def reduce_plan(batch: int, num_states: int, hidden: int, vocab: int,
                sms: int) -> ReducePlan:
  """The ``ReducePlan`` of ``batch`` live rows on ``sms`` SMs."""
  cdiv = lambda n, m: -(-n // m)
  hp = cdiv(hidden, _WG_DEPTH) * _WG_DEPTH
  vp = cdiv(vocab, _WG_DEPTH) * _WG_DEPTH
  t64 = cdiv(num_states, _WG_ROWS // 2)  # a warpgroup's 64 rows a unit
  units = batch * t64
  tiles = cdiv(units, 2) * cdiv(vp, _WG_COLS)
  max_blocks = _WG_BLOCKS_PER_SM * sms
  return ReducePlan(hp, vp, t64, units, tiles,
                    max(1, min(tiles, max_blocks)), max_blocks)


def library() -> ctypes.CDLL:
  """The kernel library, built from csrc/joint_head.cu at first use."""
  global _LIB
  if _LIB is None:
    from last_torch_tpu_torch.ops import build
    lib = build.load('joint_head.cu')
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.joint_head_forward.argtypes = ([i] + [p] * 8 + [i] * 4 + [p] * 3 +
                                       [i, i, p])
    lib.joint_head_forward.restype = i
    lib.joint_head_backward.argtypes = ([i] + [p] * 14 + [i] * 5 + [p] * 4 +
                                        [i, i, p])
    lib.joint_head_backward.restype = i
    lib.joint_head_error_string.argtypes = [i]
    lib.joint_head_error_string.restype = ctypes.c_char_p
    _LIB = lib
  return _LIB


@functools.lru_cache(maxsize=None)
def sm_count(device) -> int:
  """The SM count of a CUDA device."""
  return torch.cuda.get_device_properties(device).multi_processor_count


def _launch(device, what, call):
  """Runs ``call(lib, stream)`` on the current stream of ``device`` and
  raises on a launch error."""
  lib = library()
  with torch.cuda.device(device):
    status = call(lib, torch.cuda.current_stream(device).cuda_stream)
  if status != 0:
    raise RuntimeError(f'joint_head {what} kernel launch failed: '
                       f'{lib.joint_head_error_string(status).decode()}')


def joint_head_forward(pc: torch.Tensor, pf: torch.Tensor,
                       vocab_w: torch.Tensor, blank_w: torch.Tensor,
                       vocab_b: torch.Tensor, blank_b: torch.Tensor, *,
                       compute_dtype: torch.dtype):
  """The joint and heads for every (batch row, state): the kernel on CUDA,
  the plain version on CPU.

  Args:
    pc: [S, h] float32 projected context states (``cache @ context_proj``).
    pf: [B, h] float32 projected frame (``frame @ frame_proj``).
    vocab_w, blank_w, vocab_b, blank_b: JointWeightFn head parameters,
      float32 ([h, V], [h], [V], []).
    compute_dtype: torch.float32 or torch.bfloat16, the type the joint and
      the head weights are rounded to before the float32 products.

  Returns:
    (blank [B, S], lexical [B, S, V]), float32, each contiguous.
  """
  global forward_launches
  batch, num_states, hidden, vocab = _check_inputs(
      pc, pf, vocab_w, blank_w, compute_dtype,
      vocab_b=(vocab_b, (vocab_w.shape[-1],)), blank_b=(blank_b, ()))
  if pc.device.type == 'cpu':
    return joint_head_forward_plain(pc, pf, vocab_w, blank_w, vocab_b,
                                    blank_b, compute_dtype=compute_dtype)
  if pc.device.type != 'cuda':
    raise ValueError(f'no joint_head kernel for device {pc.device}')
  blank = torch.empty((batch, num_states), device=pc.device)
  lexical = torch.empty((batch, num_states, vocab), device=pc.device)
  blocks = route = 0
  joint_t = None
  if compute_dtype == torch.bfloat16:
    plan = forward_plan(batch, num_states, hidden, vocab, sm_count(pc.device))
    # One allocation: the joint [B S, hp], then the head [hp, Vp] (2 bytes
    # an entry).
    rows = batch * num_states * plan.hidden_pad
    scratch = torch.empty(rows + plan.hidden_pad * plan.vocab_pad,
                          dtype=torch.bfloat16, device=pc.device)
    joint = scratch.data_ptr()
    head = joint + 2 * rows
    blocks = plan.blocks
  else:
    plan = f32_forward_plan(batch, num_states, hidden, vocab)
    scratch = torch.empty(plan.size, dtype=torch.uint8, device=pc.device)
    joint = scratch.data_ptr() + plan.offsets['joint']
    head = scratch.data_ptr() + plan.offsets['head']
    if not plan.labels_major:
      joint_t = scratch.data_ptr() + plan.offsets['joint_t']
    route = int(plan.labels_major)
  _launch(pc.device, 'forward', lambda lib, stream: lib.joint_head_forward(
      _DTYPE_CODES[compute_dtype], pc.data_ptr(), pf.data_ptr(),
      vocab_w.data_ptr(), blank_w.data_ptr(), vocab_b.data_ptr(),
      blank_b.data_ptr(), blank.data_ptr(), lexical.data_ptr(), batch,
      num_states, hidden, vocab, joint, head, joint_t, blocks, route,
      stream))
  forward_launches += 1
  return blank, lexical


def _rounding(compute_dtype: torch.dtype):
  """x rounded to the compute type in x's own type (the identity for
  float32, so that float64 references stay float64)."""
  if compute_dtype == torch.float32:
    return lambda x: x
  return lambda x: x.to(compute_dtype).to(x.dtype)


def joint_head_forward_plain(pc: torch.Tensor, pf: torch.Tensor,
                             vocab_w: torch.Tensor, blank_w: torch.Tensor,
                             vocab_b: torch.Tensor, blank_b: torch.Tensor, *,
                             compute_dtype: torch.dtype):
  """``joint_head_forward`` in plain PyTorch, in the inputs' own type."""
  rnd = _rounding(compute_dtype)
  joint = rnd(torch.tanh(pc[None] + pf[:, None]))  # [B, S, h]
  blank = joint @ rnd(blank_w) + blank_b
  lexical = joint @ rnd(vocab_w) + vocab_b
  return blank, lexical


def joint_head_backward(pc: torch.Tensor, pf: torch.Tensor,
                        vocab_w: torch.Tensor, blank_w: torch.Tensor,
                        g_blank: torch.Tensor, g_lexical: torch.Tensor, *,
                        compute_dtype: torch.dtype):
  """The VJP of ``joint_head_forward`` with respect to pc, pf and the head
  weights: the kernel on CUDA, the plain version on CPU.

  Args:
    pc, pf, vocab_w, blank_w: As ``joint_head_forward``.
    g_blank: [B, S] float32 cotangent of blank.
    g_lexical: [B, S, V] float32 cotangent of lexical.
    compute_dtype: As ``joint_head_forward``.

  Returns:
    (d_pc [S, h], d_pf [B, h], d_vocab_w [h, V], d_blank_w [h]), float32.
    The bias gradients are the cotangents' sums, left to the caller.
  """
  global backward_launches
  batch, num_states, hidden, vocab = _check_inputs(
      pc, pf, vocab_w, blank_w, compute_dtype,
      g_blank=(g_blank, (pf.shape[0], pc.shape[0])),
      g_lexical=(g_lexical, (pf.shape[0], pc.shape[0], vocab_w.shape[-1])))
  if pc.device.type == 'cpu':
    return joint_head_backward_plain(pc, pf, vocab_w, blank_w, g_blank,
                                     g_lexical, compute_dtype=compute_dtype)
  if pc.device.type != 'cuda':
    raise ValueError(f'no joint_head kernel for device {pc.device}')
  if hidden == 0 or vocab == 0:
    raise ValueError('the backward kernels need hidden and vocab sizes >= 1, '
                     f'got {hidden} and {vocab}')
  empty = lambda *shape: torch.empty(shape, device=pc.device)
  plan = backward_plan(batch, num_states, hidden, vocab, compute_dtype,
                       sm_count(pc.device))
  # The scratch in one buffer: the generic routes call the backward once a
  # frame, where each allocation costs host time.
  workspace = torch.empty(plan.size, dtype=torch.uint8, device=pc.device)
  ptr = lambda name: (workspace.data_ptr() + plan.offsets[name]
                      if name in plan.offsets else None)
  d_pc, d_pf = empty(num_states, hidden), empty(batch, hidden)
  d_vocab_w, d_blank_w = empty(hidden, vocab), empty(hidden)
  _launch(pc.device, 'backward', lambda lib, stream: lib.joint_head_backward(
      _DTYPE_CODES[compute_dtype], pc.data_ptr(), pf.data_ptr(),
      vocab_w.data_ptr(), blank_w.data_ptr(), g_blank.data_ptr(),
      g_lexical.data_ptr(), ptr('dpf_part'), ptr('dbw_part'),
      ptr('du' if compute_dtype == torch.float32 else 'dpc_part'),
      ptr('dw_part'), d_pc.data_ptr(),
      d_pf.data_ptr(), d_vocab_w.data_ptr(), d_blank_w.data_ptr(), batch,
      num_states, hidden, vocab, plan.splits, ptr('joint'), ptr('joint32'),
      ptr('d_lex'), ptr('head'), plan.dsplits, int(plan.labels_major),
      stream))
  backward_launches += 1
  return d_pc, d_pf, d_vocab_w, d_blank_w


def backward_scratch(batch: int, num_states: int, hidden: int, vocab: int,
                     compute_dtype: torch.dtype, splits: int,
                     dsplits: int) -> dict:
  """name -> (shape, dtype) of the backward's scratch
  (``joint_head_backward`` in ``csrc/joint_head.cu``).

  float32 (the FMA tiles): the joint [rows_pad, hidden_pad] and the head
  transposed [vocab_pad, hidden_pad] (``_f32_pads``, zeros past B S, h and
  V), du [B S, hidden_pad], per 64-row tile partials of d_pf (one per
  batch row the tile touches, at most ``batch_slots``) and of d_blank_w,
  and ``splits`` partials of d_vocab_w ([h, V] rows-major, [V, h]
  labels-major). bfloat16 (the wgmma route): the staged operands, padded
  to hidden_pad and vocab_pad (h and V rounded up to 64, zero past them),
  the float32 joint for the tanh derivative, the cotangent rounded to
  bfloat16, and the partials of the two head_grads.cuh products
  (``dsplits`` of d_pc, ``splits`` of d_vocab_w).
  """
  f32, bf16 = torch.float32, torch.bfloat16
  rows = batch * num_states
  if compute_dtype == torch.float32:
    mp, hp, vp = _f32_pads(batch, num_states, hidden, vocab)
    tiles = mp // _F32_ROWS
    part = ((splits, vocab, hidden) if f32_labels_major(vocab) else
            (splits, hidden, vocab))
    return {'joint32': ((mp, hp), f32), 'head': ((vp, hp), f32),
            'du': ((rows, hp), f32),
            'dpf_part': ((tiles, batch_slots(batch, num_states), hidden),
                         f32),
            'dbw_part': ((tiles, hidden), f32), 'dw_part': (part, f32)}
  t64 = -(-num_states // 64)
  hp = -(-hidden // _WG_DEPTH) * _WG_DEPTH
  vp = -(-vocab // _WG_DEPTH) * _WG_DEPTH
  return {'joint': ((rows, hp), bf16), 'joint32': ((rows, hidden), f32),
          'd_lex': ((rows, vp), bf16), 'head': ((hp, vp), bf16),
          'dpf_part': ((t64, batch, hidden), f32),
          'dbw_part': ((batch * t64, hidden), f32),
          'dpc_part': ((dsplits, num_states, hidden), f32),
          'dw_part': ((splits, hidden, vocab), f32)}


def batch_slots(batch: int, num_states: int) -> int:
  """The most batch rows a 64-row tile of the flattened B S rows touches
  (the float32 backward's d_pf partials per tile)."""
  return min(batch, (_F32_ROWS - 1) // max(1, num_states) + 2)


def f32_split_slices(batch: int, num_states: int, splits: int) -> list:
  """The [begin, end) 16-row depth slices of each split of the float32
  d_vocab_w contraction over the B S rows (``split_range`` in
  ``csrc/joint_head.cu``)."""
  steps = _cdiv(batch * num_states, _F32_DEPTH)
  return [(steps * z // splits, steps * (z + 1) // splits)
          for z in range(splits)]


@dataclasses.dataclass(frozen=True)
class BackwardPlan:
  """The backward's grid and workspace (``backward_plan``).

  Attributes:
    splits: the d_vocab_w contraction's splits (float32: over the 16-row
      slices of the flattened B S rows, ``f32_split_slices``; bfloat16:
      over the (batch row, 64-state) depth tiles of head_grads.cuh's
      product).
    dsplits: bfloat16: the batch-row splits of the d_joint product, whose
      blocks keep d_pc in registers (0 in float32).
    labels_major: float32: the d_vocab_w product's orientation
      (``f32_labels_major``; False in bfloat16).
    offsets: name -> byte offset of each ``backward_scratch`` buffer in the
      workspace, 256-byte aligned.
    size: the workspace's bytes.
  """
  splits: int
  dsplits: int
  labels_major: bool
  offsets: dict
  size: int


@functools.lru_cache(maxsize=64)
def backward_plan(batch: int, num_states: int, hidden: int, vocab: int,
                  compute_dtype: torch.dtype, sms: int) -> BackwardPlan:
  """The ``BackwardPlan`` on ``sms`` SMs: the d_vocab_w product split into
  as many parts as one wave of blocks holds (float32: two blocks an SM, at
  least ``_F32_MIN_SPLIT_SLICES`` 16-row slices a split; bfloat16: two
  blocks an SM, as ``fused_scan.wgmma_grid`` plans the other wgmma
  backwards)."""
  labels_major = False
  if compute_dtype == torch.float32:
    _, hp, vp = _f32_pads(batch, num_states, hidden, vocab)
    labels_major = f32_labels_major(vocab)
    tiles = ((vp // _F32_ROWS) * _cdiv(hp, _F32_COLS) if labels_major else
             (hp // _F32_ROWS) * _cdiv(vp, _F32_COLS))
    slices = _cdiv(batch * num_states, _F32_DEPTH)
    splits = max(1, min(_F32_BLOCKS_PER_SM * sms // max(1, tiles),
                        slices // _F32_MIN_SPLIT_SLICES))
    dsplits = 0
  else:
    from last_torch_tpu_torch.ops import fused_scan  # it imports this module
    grid = fused_scan.wgmma_grid(batch, num_states, hidden, vocab, sms)
    splits, dsplits = grid.ksplits, grid.dsplits
  return BackwardPlan(splits, dsplits, labels_major, *layout(
      backward_scratch(batch, num_states, hidden, vocab, compute_dtype,
                       splits, dsplits)))


def layout(scratch: dict):
  """(byte offsets, total bytes) of ``scratch``'s buffers (name ->
  (shape, dtype)) in one buffer, each 256-byte aligned."""
  offsets, size = {}, 0
  for name, (shape, dtype) in scratch.items():
    offsets[name] = size
    itemsize = torch.empty((), dtype=dtype).element_size()
    size += -(-math.prod(shape) * itemsize // 256) * 256
  return offsets, size


def joint_head_backward_plain(pc: torch.Tensor, pf: torch.Tensor,
                              vocab_w: torch.Tensor, blank_w: torch.Tensor,
                              g_blank: torch.Tensor, g_lexical: torch.Tensor,
                              *, compute_dtype: torch.dtype):
  """``joint_head_backward`` in plain PyTorch, in the inputs' own type: the
  joint recomputed, the cotangents rounded to the compute type for both
  products, as the kernel."""
  rnd = _rounding(compute_dtype)
  joint = torch.tanh(pc[None] + pf[:, None])  # [B, S, h]
  g_blank, g_lexical = rnd(g_blank), rnd(g_lexical)
  d_joint = g_lexical @ rnd(vocab_w).t() + g_blank[..., None] * rnd(blank_w)
  du = d_joint * (1 - joint * joint)
  joint = rnd(joint)
  d_vocab_w = torch.einsum('bsh,bsv->hv', joint, g_lexical)
  d_blank_w = torch.einsum('bsh,bs->h', joint, g_blank)
  return du.sum(dim=0), du.sum(dim=1), d_vocab_w, d_blank_w
