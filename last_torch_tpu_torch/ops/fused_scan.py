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

"""Log-partition (GN loss denominator) and per-frame posterior kernels for
Hopper, and their plain versions.

Counterpart of ``last_torch_tpu/ops/fused_scan.py``. The per-frame forward
scan (``_fused_forward_kernel`` there, and its vocabulary-tiled variant
``_online_forward_kernel``), the reverse beta scan with the head and tanh
gradients (``_fused_backward_kernel``, ``_online_backward_kernel``) and the
reverse scan that emits posteriors (``_fused_marginals_kernel``) are the
CUDA kernels of ``csrc/fused_scan.cu``, reached through ``fused_forward``,
``fused_backward`` and ``fused_marginals``: on a CUDA tensor they launch
the kernels, on a CPU tensor they run ``fused_forward_plain`` /
``fused_backward_plain`` / ``fused_marginals_plain``, the same functions in
plain PyTorch. ``log_partition`` joins the first two in a
``torch.autograd.Function``, as the JAX package's custom VJP does;
``label_marginals`` runs the forward and the marginals scan. The four
frame-independent products around them (``frames @ frame_proj``,
``cache @ context_proj`` and their gradients) stay ``torch.matmul``. The
plain scans (``forward_scan_plain``, ``backward_scan_plain``) take the
context's arc reduction and destinations, and the autograd wrapper
(``scan_log_partition``) takes the kernel pair, so ``ops/trigram_scan.py``
(whose kernels are the trigram mode of the same library) reuses both.

Modes. 'cache' stages [B, S, V] buffers of a frame in device memory: the
forward's lexical weights (float32) for its reductions after the first, and
the backward's d_lex in the compute type; 'online' keeps no [B, S, V] buffer
and recomputes the head product for every reduction, for vocabularies whose
staged buffers grow too large (they grow as V^2): its backward forms d_lex
for ``ONLINE_CHUNK_STATES`` states at a time. In bfloat16 the forward of
either mode runs on wgmma over each frame's live rows
(``csrc/head_product.cuh``: ``joint_head.reduce_plan``,
``forward_scratch``), and so does the backward of either mode, which
recomputes the lexical weights for each reduction (``wgmma_grid``,
``backward_scratch``). ``plan`` picks one for
``mode='auto'`` from the staged bytes. Both modes compute the same function,
so on CPU tensors both run the same plain versions. The marginals scan
has no mode: in bfloat16 it runs the backward's wgmma row reductions, lex
recomputed by each (``marginals_scratch``: no [B, S, V] buffer); in float32
it stages lex, as the JAX package's runs only in its 'cache' mode.

Scope is the structural half of the JAX package's gate (``supported``): Log
semiring, bigram ``FullNGram``, ``JointWeightFn``, ``FrameDependent`` /
``FrameLabelDependent``, one batch dimension. Its TPU rules do not apply
here: the small-vocabulary cut-off and the VMEM planner that sends V past
~1500 to the online kernels and refuses ``label_marginals`` there
(``_plan``, ``marginals_supported``). Every bigram vocabulary takes the
kernels, in the mode ``plan`` picks.
"""

from __future__ import annotations

import ctypes
import dataclasses
from collections.abc import Callable
from typing import Any, Optional

import torch

from last_torch_tpu_torch import alignments, contexts, weight_fns
from last_torch_tpu_torch.ops import joint_head

# Calls that launched the CUDA kernels, for runs that must show which
# kernels they went through: the forward and backward in 'cache' and in
# 'online' mode, and the marginals scan. Only CUDA tensors count.
forward_launches = 0
backward_launches = 0
online_forward_launches = 0
online_backward_launches = 0
marginals_launches = 0

_LIB = None
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# The kernels' tile (csrc/tile_product.cuh: 64 states x 64 labels or hidden
# units), and how many blocks per SM the reductions and the head-gradient
# product aim for by splitting their work across blocks.
_TILE = 64
_BLOCKS_PER_SM = 4
NEG_INF = float('-inf')

MODES = ('cache', 'online')
# The online backward forms d_lex for this many states at a time, a multiple
# of the wgmma kernels' 64-state tile: [B, 1024, V] in bfloat16 (67 MB at
# B=8, V=4096) is as large as the backward's float32 joint [B, S, h] at
# h=512, and it halves the gradient products' split d_pc buffer against 512
# states, so the peak stays where 512 put it. 1024 states took 7.3-7.4%
# less time than 512 at V=4096, B=8 (tools/ab_kernels.py, lp9o against
# lp9o512, H100 80GB HBM3 at 700 W; PERF.md).
ONLINE_CHUNK_STATES = 1024
# 'auto' picks 'cache' while the [B, S, V] buffers that mode stages (the
# forward's lex in float32 and the backward's d_lex in the compute type) fit
# this many bytes, 'online' beyond. At V=4096, B=8 (805 MB staged) the
# cache kernels took 1.34-1.35x less time than the online ones (the
# forwards 1.6x, the backwards 1.05x), for a peak of 727 against 516 MiB
# (chip_smoke.py phase 9b, H100 80GB HBM3 at 700 W, before the bfloat16
# 'cache' forward moved to wgmma, which made its forward 4.7x faster than
# the online one; PERF.md): staging wins wherever the memory is there, so
# the budget is a memory one, a tenth of the card's.
LEX_STAGE_BUDGET = 8 * 1024**3


def plan(batch: int, num_states: int, vocab: int,
         compute_dtype: torch.dtype) -> str:
  """The mode ``mode='auto'`` takes: 'cache' or 'online'."""
  itemsize = torch.empty((), dtype=compute_dtype).element_size()
  staged = batch * num_states * vocab * (4 + itemsize)
  return 'cache' if staged <= LEX_STAGE_BUDGET else 'online'


def compute_dtype_for(device) -> torch.dtype:
  """The type the lattice rounds the joint and head inputs to: bfloat16 on
  the card, as the TPU kernels; float32 elsewhere, as the JAX package off
  the TPU."""
  return torch.bfloat16 if torch.device(device).type == 'cuda' else (
      torch.float32)


def _check_mode(mode: str, allowed=MODES):
  if mode not in allowed:
    raise ValueError(f'mode must be one of {allowed}, got {mode!r}')


def supported(lattice, frames: torch.Tensor, weight_fn=None) -> bool:
  """Whether the kernels (and their plain versions) cover a lattice call.

  The structural half of ``last_torch_tpu.ops.fused_scan.supported``; the
  TPU's small-vocabulary and VMEM rules do not apply here. The Viterbi
  kernel shares the gate: ``weight_fn`` overrides ``lattice.weight_fn``
  there with the ``JointWeightFn`` inside a ``LocallyNormalizedWeightFn``,
  which it normalizes in the kernel.
  """
  if weight_fn is None:
    weight_fn = lattice.weight_fn
  return (type(weight_fn) is weight_fns.JointWeightFn and
          isinstance(lattice.context, contexts.FullNGram) and
          lattice.context.context_size == 1 and
          isinstance(lattice.alignment, (alignments.FrameDependent,
                                         alignments.FrameLabelDependent)) and
          frames.ndim == 3)


def num_passes(max_expansions: int, frame_dependent: bool) -> int:
  """Label reductions per frame: 1 for FD, k for FLD(k)."""
  return 1 if frame_dependent else max_expansions


def check_inputs(pf, pc, params, is_pad, compute_dtype, kernel: str,
                 context_size: int = 1):
  """Checks what the kernels take: types, shapes, devices, contiguity, and
  the state count of a FullNGram of ``context_size`` (1 bigram, 2 trigram).
  """
  device = pf.device
  if pf.ndim != 3 or pc.ndim != 2 or is_pad.ndim != 2:
    raise ValueError('expected pf [T, B, h], pc [S, h] and is_pad [T, B], '
                     f'got {tuple(pf.shape)}, {tuple(pc.shape)} and '
                     f'{tuple(is_pad.shape)}')
  max_t, batch, hidden = pf.shape
  num_states = pc.shape[0]
  vocab = params['vocab_w'].shape[-1]
  expected = {
      'pf': (pf, (max_t, batch, hidden), torch.float32),
      'pc': (pc, (num_states, hidden), torch.float32),
      'is_pad': (is_pad, (max_t, batch), torch.bool),
      'vocab_w': (params['vocab_w'], (hidden, vocab), torch.float32),
      'vocab_b': (params['vocab_b'], (vocab,), torch.float32),
      'blank_w': (params['blank_w'], (hidden,), torch.float32),
      'blank_b': (params['blank_b'], (), torch.float32),
  }
  for name, (x, shape, dtype) in expected.items():
    if tuple(x.shape) != shape or x.dtype != dtype:
      raise ValueError(f'{name} should be {dtype} of shape {shape}, got '
                       f'{x.dtype} of shape {tuple(x.shape)}')
    if x.device != device:
      raise ValueError(f'{name} is on {x.device}, pf on {device}')
    if not x.is_contiguous():
      raise ValueError(f'{name} must be contiguous')
  expected_states = sum(vocab**i for i in range(context_size + 1))
  if num_states != expected_states:
    name, formula = {1: ('bigram', 'V + 1'),
                     2: ('trigram', '1 + V + V^2')}[context_size]
    raise ValueError(f'the {kernel} kernel needs a {name} FullNGram '
                     f'(S = {formula}), got S={num_states}, V={vocab}')
  if compute_dtype not in _DTYPE_CODES:
    raise ValueError(f'compute_dtype must be float32 or bfloat16, got '
                     f'{compute_dtype}')


def library() -> ctypes.CDLL:
  """The kernel library, built from csrc/fused_scan.cu at first use (it
  also holds the trigram kernels of ``ops/trigram_scan.py``)."""
  global _LIB
  if _LIB is None:
    from last_torch_tpu_torch.ops import build
    lib = build.load('fused_scan.cu')
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fused_forward.argtypes = [i] + [p] * 16 + [i] * 9 + [p] * 3 + [
        i, p]
    lib.fused_forward.restype = i
    lib.fused_backward.argtypes = [i] + [p] * 33 + [i] * 11 + [p] * 2 + [
        i, p, p]
    lib.fused_backward.restype = i
    lib.fused_marginals.argtypes = [i] + [p] * 20 + [i] * 8 + [p] * 3
    lib.fused_marginals.restype = i
    lib.trigram_forward.argtypes = [i] + [p] * 14 + [i] * 7 + [p]
    lib.trigram_forward.restype = i
    lib.trigram_backward.argtypes = [i] + [p] * 33 + [i] * 9 + [p]
    lib.trigram_backward.restype = i
    lib.trigram_segment_smem.argtypes = [i] * 3
    lib.trigram_segment_smem.restype = i
    lib.trigram_segment_forward.argtypes = [p] * 13 + [i] * 7 + [p]
    lib.trigram_segment_forward.restype = i
    lib.trigram_segment_backward.argtypes = [p] * 27 + [i] * 7 + [p]
    lib.trigram_segment_backward.restype = i
    lib.fused_error_string.argtypes = [i]
    lib.fused_error_string.restype = ctypes.c_char_p
    _LIB = lib
  return _LIB


def _ptr(x: Optional[torch.Tensor]):
  return None if x is None else x.data_ptr()


@dataclasses.dataclass(frozen=True)
class WgmmaGrid:
  """Tiles and splits of the wgmma kernels of a frame's backward
  (``csrc/wgmma_tiles.cuh``, ``csrc/head_grads.cuh``): a pure function of
  the shapes and the card's SM count (``wgmma_grid``).

  Attributes:
    hidden_pad, vocab_pad: h and V rounded up to the 64-deep stages; the
      joint, the head and d_lex are padded to them with zeros.
    strips: 128-label strips of the lexical products (the row partials).
    chunk: states whose d_lex the last row reduction forms at a time, and
      over which the two gradient products run: all S in 'cache' mode,
      ``ONLINE_CHUNK_STATES`` (at most S) in 'online' mode.
    ksplits: splits of d_vocab_w's (batch row, state) contraction.
    dsplits: splits of the batch rows whose d_pc one block carries.
    blocks: blocks of each product's launch on a frame with every row live:
      'lexical' (a reduction over all S states), 'head_grad' and
      'joint_grad' (over one full chunk).
  """
  hidden_pad: int
  vocab_pad: int
  strips: int
  chunk: int
  ksplits: int
  dsplits: int
  blocks: dict


# The wgmma kernels' tiles (csrc/wgmma_tiles.cuh): 64 rows (one
# warpgroup), 128 columns, 64-deep stages; two blocks fit on an SM.
_WG_ROWS, _WG_COLS, _WG_DEPTH, _WG_BLOCKS_PER_SM = 64, 128, 64, 2


def wgmma_grid(batch: int, num_states: int, hidden: int, vocab: int,
               sms: int, mode: str = 'cache') -> WgmmaGrid:
  """The ``WgmmaGrid`` of a frame of ``batch`` rows on ``sms`` SMs in
  ``mode``: each gradient product split into as many parts as keep its
  blocks (over one chunk of states) within one wave (two per SM), at least
  one."""
  _check_mode(mode)
  cdiv = lambda n, m: -(-n // m)
  hp = cdiv(hidden, _WG_DEPTH) * _WG_DEPTH
  vp = cdiv(vocab, _WG_DEPTH) * _WG_DEPTH
  strips = cdiv(vp, _WG_COLS)
  chunk = (num_states if mode == 'cache' else
           min(num_states, ONLINE_CHUNK_STATES))
  chunk_tiles = cdiv(chunk, _WG_ROWS)
  wave = _WG_BLOCKS_PER_SM * sms
  head_tiles = hp // _WG_ROWS * strips
  ksplits = max(1, min(batch * chunk_tiles, wave // head_tiles))
  joint_tiles = chunk_tiles * cdiv(hp, _WG_COLS)
  dsplits = max(1, min(batch, wave // joint_tiles))
  return WgmmaGrid(hp, vp, strips, chunk, ksplits, dsplits, {
      'lexical': batch * cdiv(num_states, _WG_ROWS) * strips,
      'head_grad': head_tiles * ksplits,
      'joint_grad': joint_tiles * dsplits})


def backward_scratch(batch: int, num_states: int, hidden: int, vocab: int,
                     grid: WgmmaGrid) -> dict:
  """name -> (shape, dtype) of the buffers the bfloat16 backward on wgmma
  allocates in place of the other routes' (``launch_backward``), in the mode
  ``grid`` was planned for. No float32 [B, S, V] lex: every row reduction
  recomputes the head product, which measured faster than staging lex at
  B=8 and at B=32 (PERF.md). d_lex holds one chunk of states, [B, chunk,
  Vp]: in 'online' mode no buffer grows as B S V."""
  hp, vp = grid.hidden_pad, grid.vocab_pad
  part = ((grid.strips, batch, num_states), torch.float32)
  return {
      'vocab_w': ((hp, vp), torch.bfloat16),
      'joint': ((batch, num_states, hp), torch.bfloat16),
      'joint32': ((batch, num_states, hidden), torch.float32),
      'd_lex': ((batch, grid.chunk, vp), torch.bfloat16),
      'part_m': part,
      'part_l': part,
      'dpc_acc': ((grid.dsplits, num_states, hidden), torch.float32),
      'dvw_acc': ((grid.ksplits, hidden, vocab), torch.float32),
  }


def forward_scratch(batch: int, num_states: int, hidden: int, vocab: int,
                    plan: joint_head.ReducePlan, reductions: int,
                    mode: str = 'cache') -> dict:
  """name -> (shape, dtype) of the buffers of the bfloat16 forward on
  csrc/head_product.cuh's column reduction (``fused_forward``) in ``mode``:
  the padded bfloat16 joint and head, the (max, sum) partials per 64-state
  unit and, in 'cache' mode with two or more ``reductions`` a frame, the
  float32 lex [B, S, V] that the first of them stages for the others
  (faster than recomputing the product at B=8, B=32 and V=4096: PERF.md).
  'online' holds no [B, S, V] buffer: every reduction runs the product."""
  _check_mode(mode)
  hp, vp = plan.hidden_pad, plan.vocab_pad
  part = ((plan.state_tiles, batch, vocab), torch.float32)
  scratch = {
      'joint': ((batch, num_states, hp), torch.bfloat16),
      'vocab_w': ((hp, vp), torch.bfloat16),
      'part_m': part,
      'part_l': part,
  }
  if reductions >= 2 and mode == 'cache':
    scratch['lex'] = ((batch, num_states, vocab), torch.float32)
  return scratch


def marginals_scratch(batch: int, num_states: int, hidden: int, vocab: int,
                      compute_dtype: torch.dtype, reductions: int,
                      ysplits: int = 1) -> dict:
  """name -> (shape, dtype) of the marginals scan's scratch
  (``fused_marginals``) with ``reductions`` row reductions a frame. In
  bfloat16 with at least one, the frames run the bfloat16 backward's wgmma
  row reductions (``hopper::run_marginals`` in csrc/fused_scan.cu): the
  padded bfloat16 joint and head and a (max, sum) partial per 128-label
  strip, and no float32 lex [B, S, V] (every reduction recomputes the head
  product). Otherwise (float32, FLD(0)) tile_product.cuh's route: the joint
  in the compute type, lex [B, S, V] float32 staged for the frame and
  partials per one of ``ysplits`` label splits."""
  hp = -(-hidden // _WG_DEPTH) * _WG_DEPTH
  vp = -(-vocab // _WG_DEPTH) * _WG_DEPTH
  f32, bs = torch.float32, (batch, num_states)
  common = {
      'blank': (bs, f32),
      'nb': ((max(reductions, 1),) + bs, f32),
      'beta': ((2,) + bs, f32),
      'lp_part': ((batch, -(-num_states // _TILE), vocab), f32),
  }
  if compute_dtype == torch.bfloat16 and reductions >= 1:
    part = ((-(-vp // _WG_COLS),) + bs, f32)
    return {'vocab_w': ((hp, vp), torch.bfloat16),
            'joint': (bs + (hp,), torch.bfloat16),
            'part_m': part, 'part_l': part, **common}
  part = ((ysplits,) + bs, f32)
  return {'joint': (bs + (hidden,), compute_dtype),
          'lex': (bs + (vocab,), f32), 'part_m': part, 'part_l': part,
          **common}


def live_rows(is_pad: torch.Tensor):
  """(live [T] int32 on the host, rows [T, B] int32 on is_pad's device):
  each frame's real rows, counted on the host (one synchronisation per
  call), and their batch indices listed first, in order, then the padding
  rows'; what the wgmma routes walk instead of every row."""
  live = (~is_pad).sum(1, dtype=torch.int32).cpu()
  rows = torch.argsort(is_pad.to(torch.uint8), dim=1,
                       stable=True).to(torch.int32)
  return live, rows


def grid_splits(work_blocks: int, max_splits: int, device) -> int:
  """How many ways (at most max_splits) to split the work of a grid of
  work_blocks blocks so that it fills the card with ~4 blocks per SM."""
  sms = torch.cuda.get_device_properties(device).multi_processor_count
  return max(1, min(max_splits, -(-_BLOCKS_PER_SM * sms // work_blocks)))


def _raise_on(status: int, what: str):
  if status != 0:
    raise RuntimeError(f'{what} kernel launch failed: '
                       f'{library().fused_error_string(status).decode()}')


def fused_forward(pf: torch.Tensor, pc: torch.Tensor, params: dict[str, Any],
                  is_pad: torch.Tensor, *, max_expansions: int,
                  frame_dependent: bool, compute_dtype: torch.dtype,
                  with_residuals: bool, mode: str = 'cache',
                  alpha0: Optional[torch.Tensor] = None):
  """Log-semiring forward scan: the kernel on CUDA, the plain version on CPU.

  Args:
    pf: [T, B, h] float32 projected frames (``frames @ frame_proj``).
    pc: [S, h] float32 projected context states (``cache @ context_proj``).
    params: JointWeightFn parameters (``vocab_w``, ``vocab_b``,
      ``blank_w``, ``blank_b``), float32.
    is_pad: [T, B] bool, True on padding frames.
    max_expansions: k of FrameLabelDependent (ignored for FrameDependent).
    frame_dependent: FrameDependent (True) or FrameLabelDependent (False).
    compute_dtype: torch.float32 or torch.bfloat16, the type the joint and
      the head weights are rounded to before the float32 products.
    with_residuals: Also write what the backward reads: the alpha history
      and, for FrameLabelDependent, the expansion slabs. A primal-only call
      leaves both unwritten.
    mode: 'cache' (a frame's later reductions read its staged lex) or
      'online' (each recomputes the head product; no [B, S, V] buffer).
    alpha0: Optional [B, S] float32 log-space alpha before frame 0; the
      one-hot start at state 0 by default. With the final alpha returned,
      it chains the scan over consecutive blocks of frames (the time-sharded
      relay, ``parallel/sequence.py``).

  Returns:
    (log_z [B], final alpha [B, S], history [T, B, S] or None, slabs
    [k, T, B, S] or None). history[t] is alpha before frame t (held on
    padding frames); slabs[j, t] is the (j+1)-th expansion alpha of frame
    t, expand(reduce)^(j+1) of alpha, -inf on padding frames.
  """
  global forward_launches, online_forward_launches
  _check_mode(mode)
  check_inputs(pf, pc, params, is_pad, compute_dtype, 'log-partition')
  _check_seed(pf, pc, alpha0, 'alpha0')
  kw = dict(max_expansions=max_expansions, frame_dependent=frame_dependent,
            compute_dtype=compute_dtype, with_residuals=with_residuals,
            alpha0=alpha0)
  if pf.device.type == 'cpu':
    return fused_forward_plain(pf, pc, params, is_pad, **kw)
  if pf.device.type != 'cuda':
    raise ValueError(f'no log-partition kernel for device {pf.device}')

  lib = library()
  max_t, batch, hidden = pf.shape
  num_states = pc.shape[0]
  vocab = params['vocab_w'].shape[-1]
  k = num_passes(max_expansions, frame_dependent)
  device = pf.device
  empty = lambda *shape, dtype=torch.float32: torch.empty(
      shape, dtype=dtype, device=device)
  pad = is_pad.to(torch.int32)
  online = mode == 'online'
  vw, bw = params['vocab_w'], params['blank_w']  # float32 on both routes
  if compute_dtype == torch.bfloat16:
    # The column-reduce product of csrc/head_product.cuh on wgmma, over each
    # frame's live rows: counted on the host (one synchronisation per
    # call) and listed first on the device.
    rplan = joint_head.reduce_plan(batch, num_states, hidden, vocab,
                                   joint_head.sm_count(device))
    buf = {name: empty(*shape, dtype=dtype) for name, (shape, dtype) in
           forward_scratch(batch, num_states, hidden, vocab, rplan, k,
                           mode).items()}
    joint, lex = buf['joint'], buf.get('lex')
    part_m, part_l = buf['part_m'], buf['part_l']
    splits = 0
    live, rows = live_rows(is_pad)
    route_args = (_ptr(live), _ptr(rows), _ptr(buf['vocab_w']),
                  rplan.max_blocks)
  else:
    joint = empty(batch, num_states, hidden)
    # In 'cache' mode, with two or more reductions per frame the
    # first stages the frame's lexical weights for the others.
    lex = empty(batch, num_states, vocab) if k >= 2 and not online else None
    strips = -(-vocab // _TILE)
    tiles = -(-num_states // _TILE)
    splits = grid_splits(strips * batch, tiles, device)
    part_m = empty(splits, batch, vocab)
    part_l = empty(splits, batch, vocab)
    route_args = (None, None, None, 0)
  blank = empty(batch, num_states)
  hist = empty(max_t, batch, num_states) if with_residuals else None
  slabs = (empty(k, max_t, batch, num_states)
           if with_residuals and not frame_dependent and k else None)
  last = None if slabs is not None else empty(max(k, 1), batch, num_states)
  alpha = initial_alpha(2, batch, num_states, alpha0, device)
  with torch.cuda.device(device):
    stream = torch.cuda.current_stream(device).cuda_stream
    status = lib.fused_forward(
        _DTYPE_CODES[compute_dtype], _ptr(pf), _ptr(pc), _ptr(vw),
        _ptr(params['vocab_b']), _ptr(bw), _ptr(params['blank_b']),
        _ptr(pad), _ptr(joint), _ptr(blank), _ptr(lex), _ptr(part_m),
        _ptr(part_l), _ptr(last), _ptr(alpha), _ptr(hist), _ptr(slabs),
        max_t, batch, num_states, hidden, vocab, max_expansions,
        int(frame_dependent), int(online), splits, *route_args, stream)
  _raise_on(status, 'log-partition forward')
  if online:
    online_forward_launches += 1
  else:
    forward_launches += 1
  final = alpha[max_t % 2]
  return torch.logsumexp(final, dim=-1), final, hist, slabs


def fused_forward_plain(pf: torch.Tensor, pc: torch.Tensor,
                        params: dict[str, Any], is_pad: torch.Tensor, *,
                        max_expansions: int, frame_dependent: bool,
                        compute_dtype: torch.dtype, with_residuals: bool,
                        mode: str = 'cache',
                        alpha0: Optional[torch.Tensor] = None):
  """The forward kernel's function in plain PyTorch (same arguments and
  outputs), in either mode: both compute the same function.

  With compute_dtype bfloat16 the joint and the head weights are rounded to
  bfloat16 and back, then multiplied in float32, so on the card this and
  the kernel differ only in summation order (TF32 off). It computes in the
  type of its inputs: given float64 ones, it is a float64 reference of the
  same rounded products.
  """
  _check_mode(mode)
  return forward_scan_plain(
      pf, pc, params, is_pad, max_expansions=max_expansions,
      frame_dependent=frame_dependent, compute_dtype=compute_dtype,
      with_residuals=with_residuals, reduce_arcs=_bigram_reduce_arcs,
      alpha0=alpha0)


def _bigram_reduce_arcs(weights):
  """[B, S, V] arc weights into their destinations, [B, S]: label y + 1
  from every state reaches state y + 1; nothing reaches the start state."""
  red = torch.logsumexp(weights, dim=1)
  return torch.cat([torch.full_like(red[:, :1], NEG_INF), red], dim=1)


def _bigram_dests(vec):
  """[B, S] state values at each arc's destination, [B, 1, V] broadcast
  over the source states (the destinations do not depend on them)."""
  return vec[:, None, 1:]


def forward_scan_plain(pf, pc, params, is_pad, *, max_expansions,
                       frame_dependent, compute_dtype, with_residuals,
                       reduce_arcs, alpha0=None):
  """The log-semiring forward scan in plain PyTorch, for any context whose
  arcs ``reduce_arcs`` log-sums into their destinations ([B, S, V] -> [B,
  S]); arguments and outputs as ``fused_forward``'s."""
  max_t, batch, _ = pf.shape
  num_states = pc.shape[0]
  k = num_passes(max_expansions, frame_dependent)
  rnd = lambda x: x.to(compute_dtype).to(pf.dtype)
  vw, vb = rnd(params['vocab_w']), params['vocab_b']
  bw, bb = rnd(params['blank_w']), params['blank_b']
  empty = lambda *shape: torch.empty(shape, dtype=pf.dtype, device=pf.device)
  alpha = initial_alpha(1, batch, num_states, alpha0, pf.device,
                        pf.dtype)[0]
  hist = slabs = None
  if with_residuals:
    hist = empty(max_t, batch, num_states)
    if not frame_dependent and k:
      slabs = empty(k, max_t, batch, num_states)

  for t in range(max_t):
    joint = rnd(torch.tanh(pc[None] + pf[t][:, None]))  # [B, S, h]
    lex = joint @ vw + vb  # [B, S, V]
    blank = joint @ bw + bb  # [B, S]

    def expand_reduce(vec):
      return reduce_arcs(vec[:, :, None] + lex)

    if hist is not None:
      hist[t] = alpha
    pad = is_pad[t][:, None]
    if frame_dependent:
      alpha_new = torch.logaddexp(alpha + blank, expand_reduce(alpha))
    else:
      acc, last = alpha + blank, alpha
      for j in range(k):
        last = expand_reduce(last)
        if slabs is not None:
          slabs[j, t] = torch.where(pad, NEG_INF, last)
        acc = torch.logaddexp(acc, last + blank)
      alpha_new = acc
    alpha = torch.where(pad, alpha, alpha_new)
  return torch.logsumexp(alpha, dim=-1), alpha, hist, slabs


def initial_alpha(slots: int, batch: int, num_states: int,
                  alpha0: Optional[torch.Tensor], device,
                  dtype=torch.float32) -> torch.Tensor:
  """[slots, B, S] alpha buffer whose slot 0 holds ``alpha0`` (the one-hot
  start at state 0 when None) and the others -inf."""
  alpha = torch.full((slots, batch, num_states), NEG_INF, dtype=dtype,
                     device=device)
  if alpha0 is None:
    alpha[0, :, 0] = 0.0
  else:
    alpha[0] = alpha0
  return alpha


def _check_seed(pf, pc, seed: Optional[torch.Tensor], name: str):
  """Checks a relay seed (``alpha0`` / ``beta0``): None or [B, S] float32
  on the frames' device."""
  if seed is None:
    return
  shape = (pf.shape[1], pc.shape[0])
  if tuple(seed.shape) != shape or seed.dtype != torch.float32:
    raise ValueError(f'{name} should be float32 of shape {shape}, got '
                     f'{seed.dtype} {tuple(seed.shape)}')
  if seed.device != pf.device:
    raise ValueError(f'{name} must be on {pf.device}')


def _check_residuals(pf, pc, max_expansions, frame_dependent, **residuals):
  """Checks the forward's outputs (and a cotangent) that a reverse scan
  reads: log_z [B], g [B], hist [T, B, S], slabs [k, T, B, S] (FLD only)."""
  max_t, batch, _ = pf.shape
  num_states = pc.shape[0]
  k = num_passes(max_expansions, frame_dependent)
  shapes = {'log_z': (batch,), 'g': (batch,),
            'hist': (max_t, batch, num_states),
            'slabs': (k, max_t, batch, num_states)}
  for name, x in residuals.items():
    if name == 'slabs' and (frame_dependent or not k):
      continue
    if x is None or tuple(x.shape) != shapes[name] or x.dtype != torch.float32:
      raise ValueError(f'{name} should be float32 of shape {shapes[name]}')
    if x.device != pf.device or not x.is_contiguous():
      raise ValueError(f'{name} must be contiguous on {pf.device}')


def fused_backward(pf: torch.Tensor, pc: torch.Tensor, params: dict[str, Any],
                   is_pad: torch.Tensor, log_z: torch.Tensor, g: torch.Tensor,
                   hist: torch.Tensor, slabs: Optional[torch.Tensor], *,
                   max_expansions: int, frame_dependent: bool,
                   compute_dtype: torch.dtype, mode: str = 'cache',
                   beta0: Optional[torch.Tensor] = None):
  """Reverse beta scan with head and tanh gradients: the kernel on CUDA,
  the plain version on CPU.

  Args:
    pf, pc, params, is_pad, max_expansions, frame_dependent, compute_dtype,
      mode: as ``fused_forward``. 'online' recomputes lex for every
      reduction and forms d_lex ``ONLINE_CHUNK_STATES`` states at a time.
    log_z: [B] float32 from ``fused_forward``: over a block of a longer
      sequence, the whole sequence's log Z.
    g: [B] float32 cotangent of log_z.
    hist: [T, B, S] alpha history from ``fused_forward``.
    slabs: [k, T, B, S] expansion slabs (FrameLabelDependent), else None.
    beta0: Optional [B, S] float32 log-space beta after the last frame;
      zeros (the semiring's ones) by default. With ``beta_out`` it chains
      the reverse scan over consecutive blocks, right to left.

  Returns:
    (dpf [T, B, h], dpc [S, h], d_vocab_w [h, V], d_vocab_b [V],
    d_blank_w [h], d_blank_b [], beta_out [B, S]): the gradients of
    sum(g * log_z) with respect to pf, pc and the head parameters, and
    beta at frame 0. Padding frames get exactly zero gradient.
  """
  global backward_launches, online_backward_launches
  _check_mode(mode)
  check_inputs(pf, pc, params, is_pad, compute_dtype, 'log-partition')
  _check_residuals(pf, pc, max_expansions, frame_dependent, log_z=log_z, g=g,
                   hist=hist, slabs=slabs)
  _check_seed(pf, pc, beta0, 'beta0')
  kw = dict(max_expansions=max_expansions, frame_dependent=frame_dependent,
            compute_dtype=compute_dtype, beta0=beta0)
  if pf.device.type == 'cpu':
    return fused_backward_plain(pf, pc, params, is_pad, log_z, g, hist,
                                slabs, **kw)
  if pf.device.type != 'cuda':
    raise ValueError(f'no log-partition kernel for device {pf.device}')

  online = mode == 'online'
  grads = launch_backward('fused_backward', pf, pc, params, is_pad, log_z, g,
                          hist, slabs, online=online, **kw)
  if online:
    online_backward_launches += 1
  else:
    backward_launches += 1
  return grads


def launch_backward(entry: str, pf, pc, params, is_pad, log_z, g, hist,
                    slabs, *, max_expansions, frame_dependent, compute_dtype,
                    online=False, beta0=None):
  """Allocates the reverse scan's scratch and outputs and launches the
  library's ``entry``: 'fused_backward' (in either mode) or
  'trigram_backward' (cache mode), which take the same buffers. Inputs as
  checked by ``fused_backward``; returns its outputs."""
  lib = library()
  max_t, batch, hidden = pf.shape
  num_states = pc.shape[0]
  vocab = params['vocab_w'].shape[-1]
  k = num_passes(max_expansions, frame_dependent)
  device = pf.device
  empty = lambda *shape, dtype=torch.float32: torch.empty(
      shape, dtype=dtype, device=device)
  zeros = lambda *shape: torch.zeros(shape, device=device)
  tiles = -(-num_states // _TILE)
  # The library runs the bigram's bfloat16 backward with at least one row
  # reduction per frame, in either mode, on its wgmma kernels (the rule of
  # csrc/fused_scan.cu's backward_entry), which take their own scratch.
  wgmma = (entry == 'fused_backward' and compute_dtype == torch.bfloat16 and
           k >= 1)
  # The states whose d_lex is formed at a time: all of them in 'cache' mode.
  chunk = min(num_states, ONLINE_CHUNK_STATES) if online else num_states
  if wgmma:
    grid = wgmma_grid(
        batch, num_states, hidden, vocab,
        torch.cuda.get_device_properties(device).multi_processor_count,
        'online' if online else 'cache')
    buf = {name: empty(*shape, dtype=dtype) for name, (shape, dtype) in
           backward_scratch(batch, num_states, hidden, vocab, grid).items()}
    buf['vocab_w'].zero_()[:hidden, :vocab] = params['vocab_w']
    buf['dpc_acc'].zero_()
    buf['dvw_acc'].zero_()
    ysplits, ksplits = grid.strips, grid.ksplits
    live, rows = live_rows(is_pad)
    route_args = (_ptr(live), _ptr(rows), grid.dsplits,
                  _ptr(buf['joint32']))
  else:
    strips = -(-vocab // _TILE)
    ysplits = grid_splits(tiles * batch, strips, device)
    ksplits = grid_splits(strips * -(-hidden // _TILE),
                          -(-batch * chunk // _TILE), device)
    buf = {'vocab_w': params['vocab_w'].to(compute_dtype).contiguous(),
           'joint': empty(batch, num_states, hidden, dtype=compute_dtype),
           'lex': None if online else empty(batch, num_states, vocab),
           'd_lex': empty(batch, chunk, vocab, dtype=compute_dtype),
           'part_m': empty(ysplits, batch, num_states),
           'part_l': empty(ysplits, batch, num_states),
           'dpc_acc': zeros(batch, num_states, hidden),
           'dvw_acc': zeros(ksplits, hidden, vocab)}
    route_args = (None, None, 0, None)
  bw = params['blank_w'].to(compute_dtype).contiguous()
  pad = is_pad.to(torch.int32)
  blank, d_blank = empty(batch, num_states), empty(batch, num_states)
  nb = empty(max(k, 1), batch, num_states)
  beta = initial_beta(batch, num_states, beta0, device)
  dpf = empty(max_t, batch, hidden)
  dpf_part = empty(tiles, batch, hidden)
  # Accumulators carried across frames, each element owned by one block
  # per frame (no atomics), reduced to the outputs at the end.
  dvb_acc = zeros(batch, tiles, vocab)
  dbw_acc = zeros(batch, tiles, hidden)
  dbb_acc = zeros(batch, num_states)
  dpc, dvw = empty(num_states, hidden), empty(hidden, vocab)
  dvb, dbw, dbb = empty(vocab), empty(hidden), empty(1)
  # The bigram entry point also takes its mode, d_lex chunk and the
  # arguments of its wgmma route.
  bigram_args = ((int(online), chunk) if entry == 'fused_backward' else ())
  tail_args = route_args if entry == 'fused_backward' else ()
  with torch.cuda.device(device):
    stream = torch.cuda.current_stream(device).cuda_stream
    status = getattr(lib, entry)(
        _DTYPE_CODES[compute_dtype], _ptr(pf), _ptr(pc),
        _ptr(buf['vocab_w']), _ptr(params['vocab_b']), _ptr(bw),
        _ptr(params['blank_w']), _ptr(params['blank_b']), _ptr(pad),
        _ptr(log_z), _ptr(g), _ptr(hist), _ptr(slabs), _ptr(buf['joint']),
        _ptr(blank), _ptr(buf.get('lex')), _ptr(buf['d_lex']), _ptr(d_blank),
        _ptr(buf['part_m']), _ptr(buf['part_l']), _ptr(nb), _ptr(beta),
        _ptr(dpf), _ptr(dpf_part), _ptr(buf['dpc_acc']),
        _ptr(buf['dvw_acc']), _ptr(dvb_acc), _ptr(dbw_acc), _ptr(dbb_acc),
        _ptr(dpc), _ptr(dvw), _ptr(dvb), _ptr(dbw), _ptr(dbb), max_t, batch,
        num_states, hidden, vocab, max_expansions, int(frame_dependent),
        *bigram_args, ysplits, ksplits, *tail_args, stream)
  _raise_on(status, f'{entry} (log-partition backward)')
  return dpf, dpc, dvw, dvb, dbw, dbb[0], beta[max_t % 2]


def initial_beta(batch: int, num_states: int, beta0: Optional[torch.Tensor],
                 device) -> torch.Tensor:
  """[2, B, S] beta buffer whose slot 0 holds ``beta0`` (zeros, the
  semiring's ones, when None)."""
  beta = torch.zeros((2, batch, num_states), device=device)
  if beta0 is not None:
    beta[0] = beta0
  return beta


def _reverse_frame(pc, pf_t, is_pad_t, hist_t, slabs_t, beta, rnd, head,
                   frame_dependent, k, dests=_bigram_dests):
  """One frame of the plain reverse scans (backward and marginals).

  ``dests`` gives a [B, S] state value at each arc's destination, [B, S or
  1, V] (the bigram's, or a context's ``backward_broadcast``).

  Returns (joint32, joint, lex, blank, a_list, pairs, next beta): the
  frame's unrounded and rounded joint, its lexical and blank weights, the
  alphas a_0..a_k, the (a_j, nb_j) pairs of the lexical marginals, and the
  beta that the frame before reads (held on padding rows).
  """
  vw, vb, bw, bb = head
  joint32 = torch.tanh(pc[None] + pf_t[:, None])  # [B, S, h]
  joint = rnd(joint32)
  lex = joint @ vw + vb  # [B, S, V]
  blank = joint @ bw + bb  # [B, S]

  def lse_y(nb):  # out[b, s] = logsumexp_y(lex[b, s, y] + nb[b, dest])
    return torch.logsumexp(lex + dests(nb), dim=-1)

  a_list = [hist_t]
  if frame_dependent:
    pairs = [(hist_t, beta)]
    final_nb = torch.logaddexp(blank + beta, lse_y(beta))
  else:
    a_list += [slabs_t[j] for j in range(k)]
    pairs, nb = [], blank + beta
    for j in range(k - 1, -1, -1):
      pairs.append((a_list[j], nb))
      nb = torch.logaddexp(blank + beta, lse_y(nb))
    final_nb = nb
  next_beta = torch.where(is_pad_t[:, None], beta, final_nb)
  return joint32, joint, lex, blank, a_list, pairs, next_beta


def fused_backward_plain(pf: torch.Tensor, pc: torch.Tensor,
                         params: dict[str, Any], is_pad: torch.Tensor,
                         log_z: torch.Tensor, g: torch.Tensor,
                         hist: torch.Tensor, slabs: Optional[torch.Tensor],
                         *, max_expansions: int, frame_dependent: bool,
                         compute_dtype: torch.dtype, mode: str = 'cache',
                         beta0: Optional[torch.Tensor] = None):
  """The backward kernel's function in plain PyTorch (same arguments and
  outputs), in either mode.

  It rounds at the kernel's points: the joint and the head weights for the
  products, and the lexical cotangent ``d_lex`` (as the TPU kernel did);
  the tanh derivative, the blank-head gradient and the blank part of
  d(joint) use the float32 joint and ``blank_w``.
  """
  _check_mode(mode)
  return backward_scan_plain(
      pf, pc, params, is_pad, log_z, g, hist, slabs,
      max_expansions=max_expansions, frame_dependent=frame_dependent,
      compute_dtype=compute_dtype, dests=_bigram_dests, beta0=beta0)


def backward_scan_plain(pf, pc, params, is_pad, log_z, g, hist, slabs, *,
                        max_expansions, frame_dependent, compute_dtype,
                        dests, beta0=None):
  """The reverse beta scan with head and tanh gradients in plain PyTorch,
  for any context whose arc destinations ``dests`` gathers (as
  ``_reverse_frame`` takes it); arguments and outputs as
  ``fused_backward``'s. Computes in the type of its inputs."""
  max_t, batch, hidden = pf.shape
  num_states = pc.shape[0]
  k = num_passes(max_expansions, frame_dependent)
  rnd = lambda x: x.to(compute_dtype).to(pf.dtype)
  vw, vb = rnd(params['vocab_w']), params['vocab_b']
  bw, bb = rnd(params['blank_w']), params['blank_b']
  bw32 = params['blank_w']
  zeros = lambda *shape: torch.zeros(shape, dtype=pf.dtype, device=pf.device)
  beta = zeros(batch, num_states) if beta0 is None else beta0.to(pf.dtype)
  dpf = zeros(max_t, batch, hidden)
  dpc = zeros(num_states, hidden)
  dvw = torch.zeros_like(params['vocab_w'])
  dvb = torch.zeros_like(params['vocab_b'])
  dbw = torch.zeros_like(params['blank_w'])
  dbb = zeros()
  lz = log_z[:, None]

  for t in range(max_t - 1, -1, -1):
    g_eff = torch.where(is_pad[t], 0.0, g)
    joint32, joint, lex, blank, a_list, pairs, next_beta = _reverse_frame(
        pc, pf[t], is_pad[t], hist[t], None if slabs is None else slabs[:, t],
        beta, rnd, (vw, vb, bw, bb), frame_dependent, k, dests)
    bm_total = sum(torch.exp(a + blank + beta - lz) for a in a_list)
    d_blank = g_eff[:, None] * bm_total
    lm = torch.zeros_like(lex)
    for a, nb in pairs:
      lm += torch.exp(a[:, :, None] + lex + (dests(nb) - lz[:, None]))
    d_lex = rnd(g_eff[:, None, None] * lm)

    dvw += torch.einsum('bsh,bsv->hv', joint, d_lex)
    dvb += d_lex.sum(dim=(0, 1))
    dbw += (joint32 * d_blank[..., None]).sum(dim=(0, 1))
    dbb += d_blank.sum()
    d_joint = d_lex @ vw.t() + d_blank[..., None] * bw32
    d_pre = d_joint * (1.0 - joint32 * joint32)
    dpf[t] = d_pre.sum(dim=1)
    dpc += d_pre.sum(dim=0)
    beta = next_beta
  return dpf, dpc, dvw, dvb, dbw, dbb, beta


def fused_marginals(pf: torch.Tensor, pc: torch.Tensor,
                    params: dict[str, Any], is_pad: torch.Tensor,
                    log_z: torch.Tensor, hist: torch.Tensor,
                    slabs: Optional[torch.Tensor], *, max_expansions: int,
                    frame_dependent: bool, compute_dtype: torch.dtype):
  """Reverse scan emitting per-frame posteriors: the kernel on CUDA, the
  plain version on CPU.

  Args:
    pf, pc, params, is_pad, max_expansions, frame_dependent, compute_dtype:
      as ``fused_forward``.
    log_z, hist, slabs: from ``fused_forward(..., with_residuals=True)``.

  Returns:
    (bm [T, B, S], lp [T, B, V]) float32: the posterior of the blank arc
    leaving each state, summed over the alignment's expansions, and the
    posterior of emitting label y + 1, summed over source states and
    expansions. Padding frames give exact zeros.
  """
  global marginals_launches
  check_inputs(pf, pc, params, is_pad, compute_dtype, 'marginals')
  _check_residuals(pf, pc, max_expansions, frame_dependent, log_z=log_z,
                   hist=hist, slabs=slabs)
  kw = dict(max_expansions=max_expansions, frame_dependent=frame_dependent,
            compute_dtype=compute_dtype)
  if pf.device.type == 'cpu':
    return fused_marginals_plain(pf, pc, params, is_pad, log_z, hist, slabs,
                                 **kw)
  if pf.device.type != 'cuda':
    raise ValueError(f'no marginals kernel for device {pf.device}')

  lib = library()
  max_t, batch, hidden = pf.shape
  num_states = pc.shape[0]
  vocab = params['vocab_w'].shape[-1]
  k = num_passes(max_expansions, frame_dependent)
  device = pf.device
  ysplits = grid_splits(-(-num_states // _TILE) * batch, -(-vocab // _TILE),
                        device)
  # Scratch, held until the call has enqueued every launch (a buffer freed
  # earlier could be handed to the next allocation).
  buf = {name: torch.empty(shape, dtype=dtype, device=device)
         for name, (shape, dtype) in marginals_scratch(
             batch, num_states, hidden, vocab, compute_dtype, k,
             ysplits).items()}
  buf['beta'].zero_()  # slot 0: semiring ones
  if 'vocab_w' in buf:  # the wgmma route: the padded bfloat16 head
    buf['vocab_w'].zero_()[:hidden, :vocab] = params['vocab_w']
    live, rows = live_rows(is_pad)
  else:
    buf['vocab_w'] = params['vocab_w'].to(compute_dtype).contiguous()
    live = rows = None
  bw = params['blank_w'].to(compute_dtype).contiguous()
  pad = is_pad.to(torch.int32)
  bm = torch.empty((max_t, batch, num_states), device=device)
  lp = torch.empty((max_t, batch, vocab), device=device)
  with torch.cuda.device(device):
    stream = torch.cuda.current_stream(device).cuda_stream
    status = lib.fused_marginals(
        _DTYPE_CODES[compute_dtype], _ptr(pf), _ptr(pc),
        _ptr(buf['vocab_w']), _ptr(params['vocab_b']), _ptr(bw),
        _ptr(params['blank_b']), _ptr(pad), _ptr(log_z), _ptr(hist),
        _ptr(slabs), _ptr(buf['joint']), _ptr(buf['blank']),
        _ptr(buf.get('lex')), _ptr(buf['part_m']), _ptr(buf['part_l']),
        _ptr(buf['nb']), _ptr(buf['beta']), _ptr(buf['lp_part']), _ptr(bm),
        _ptr(lp), max_t, batch, num_states, hidden, vocab, max_expansions,
        int(frame_dependent), ysplits, _ptr(live), _ptr(rows), stream)
  _raise_on(status, 'marginals')
  marginals_launches += 1
  return bm, lp


def fused_marginals_plain(pf: torch.Tensor, pc: torch.Tensor,
                          params: dict[str, Any], is_pad: torch.Tensor,
                          log_z: torch.Tensor, hist: torch.Tensor,
                          slabs: Optional[torch.Tensor], *,
                          max_expansions: int, frame_dependent: bool,
                          compute_dtype: torch.dtype):
  """The marginals kernel's function in plain PyTorch (same arguments and
  outputs): the backward's recurrence with a unit cotangent, no gradients.
  Computes in the type of its inputs, as ``fused_forward_plain``.
  """
  max_t, batch, _ = pf.shape
  k = num_passes(max_expansions, frame_dependent)
  rnd = lambda x: x.to(compute_dtype).to(pf.dtype)
  head = (rnd(params['vocab_w']), params['vocab_b'], rnd(params['blank_w']),
          params['blank_b'])
  zeros = lambda *shape: torch.zeros(shape, dtype=pf.dtype, device=pf.device)
  beta = zeros(batch, pc.shape[0])
  bm = zeros(max_t, batch, pc.shape[0])
  lp = zeros(max_t, batch, head[0].shape[-1])
  lz = log_z[:, None]
  for t in range(max_t - 1, -1, -1):
    _, _, lex, blank, a_list, pairs, next_beta = _reverse_frame(
        pc, pf[t], is_pad[t], hist[t], None if slabs is None else slabs[:, t],
        beta, rnd, head, frame_dependent, k)
    real = ~is_pad[t][:, None]
    bm_t = sum(torch.exp(a + blank + beta - lz) for a in a_list)
    lp_t = sum(torch.exp(a[:, :, None] + lex + (nb[:, None, 1:] -
                                                lz[:, None])).sum(dim=1)
               for a, nb in pairs)
    bm[t] = torch.where(real, bm_t, 0.0)
    lp[t] = torch.where(real, lp_t, 0.0)
    beta = next_beta
  return bm, lp


@dataclasses.dataclass(frozen=True)
class _Config:
  forward: Callable
  backward: Callable
  options: dict[str, Any]  # keyword arguments of both


def _stage(cache, frames, num_frames, frame_proj, context_proj):
  """pf [T, B, h], pc [S, h] and is_pad [T, B], as the kernels take them."""
  pf = torch.einsum('btf,fh->tbh', frames, frame_proj).contiguous()
  pc = (cache @ context_proj).contiguous()
  is_pad = (torch.arange(frames.shape[1], device=frames.device)[:, None] >=
            num_frames[None, :])
  return pf, pc, is_pad


class _LogPartition(torch.autograd.Function):
  """log Z with the backward kernel as its gradient (the custom VJP)."""

  @staticmethod
  def forward(ctx, cache, frames, num_frames, frame_proj, context_proj,
              vocab_w, vocab_b, blank_w, blank_b, config):
    pf, pc, is_pad = _stage(cache, frames, num_frames, frame_proj,
                            context_proj)
    head = {'vocab_w': vocab_w, 'vocab_b': vocab_b, 'blank_w': blank_w,
            'blank_b': blank_b}
    log_z, _, hist, slabs = config.forward(pf, pc, head, is_pad,
                                           with_residuals=True,
                                           **config.options)
    ctx.config = config
    ctx.save_for_backward(cache, frames, frame_proj, context_proj, vocab_w,
                          vocab_b, blank_w, blank_b, pf, pc, is_pad, log_z,
                          hist, slabs)
    return log_z

  @staticmethod
  def backward(ctx, g):
    (cache, frames, frame_proj, context_proj, vocab_w, vocab_b, blank_w,
     blank_b, pf, pc, is_pad, log_z, hist, slabs) = ctx.saved_tensors
    config = ctx.config
    head = {'vocab_w': vocab_w, 'vocab_b': vocab_b, 'blank_w': blank_w,
            'blank_b': blank_b}
    dpf, dpc, dvw, dvb, dbw, dbb, _ = config.backward(
        pf, pc, head, is_pad, log_z, g.float().contiguous(), hist, slabs,
        **config.options)
    d_frame_proj = torch.einsum('btf,tbh->fh', frames, dpf)
    d_context_proj = cache.t() @ dpc
    d_cache = dpc @ context_proj.t()
    d_frames = torch.einsum('tbh,fh->btf', dpf, frame_proj)
    return (d_cache, d_frames, None, d_frame_proj, d_context_proj, dvw, dvb,
            dbw, dbb, None)


def scan_log_partition(wf_params: dict[str, Any], cache: torch.Tensor,
                       frames: torch.Tensor, num_frames, *,
                       forward: Callable, backward: Callable,
                       **options) -> torch.Tensor:
  """[B] log Z of a forward scan ``forward`` whose gradient is the reverse
  scan ``backward``, both called with ``options`` (the body of
  ``log_partition`` and of ``trigram_scan.log_partition``). The forward
  writes its residuals only when autograd needs them."""
  config = _Config(forward, backward, options)
  num_frames = torch.as_tensor(num_frames, device=frames.device)
  names = ('frame_proj', 'context_proj', 'vocab_w', 'vocab_b', 'blank_w',
           'blank_b')
  tensors = (cache, frames) + tuple(wf_params[n] for n in names)
  if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
    return _LogPartition.apply(cache, frames, num_frames,
                               *(wf_params[n] for n in names), config)
  pf, pc, is_pad = _stage(cache, frames, num_frames, wf_params['frame_proj'],
                          wf_params['context_proj'])
  head = {n: wf_params[n] for n in names[2:]}
  log_z, _, _, _ = forward(pf, pc, head, is_pad, with_residuals=False,
                           **options)
  return log_z


def log_partition(wf_params: dict[str, Any], cache: torch.Tensor,
                  frames: torch.Tensor, num_frames: torch.Tensor, *,
                  max_expansions: int, frame_dependent: bool,
                  compute_dtype: torch.dtype, mode: str = 'auto',
                  forward: Callable = fused_forward,
                  backward: Callable = fused_backward) -> torch.Tensor:
  """Differentiable log-partition (GN loss denominator), [B] log Z.

  The forward runs ``forward``; when autograd needs the result, it writes
  the alpha history and expansion slabs, and ``backward`` turns them into
  the gradients of ``wf_params``, ``cache`` and ``frames``. The defaults
  launch the kernels on CUDA tensors and run the plain versions on CPU
  tensors; ``fused_forward_plain`` / ``fused_backward_plain`` run the plain
  versions on the card too. ``mode`` is 'cache', 'online' or 'auto'
  (``plan``'s choice for these shapes).
  """
  _check_mode(mode, MODES + ('auto',))
  if mode == 'auto':
    mode = plan(frames.shape[0], cache.shape[0],
                wf_params['vocab_w'].shape[-1], compute_dtype)
  return scan_log_partition(
      wf_params, cache, frames, num_frames, forward=forward,
      backward=backward, max_expansions=max_expansions,
      frame_dependent=frame_dependent, compute_dtype=compute_dtype,
      mode=mode)


@torch.no_grad()
def label_marginals(wf_params: dict[str, Any], cache: torch.Tensor,
                    frames: torch.Tensor, num_frames: torch.Tensor, *,
                    max_expansions: int, frame_dependent: bool,
                    compute_dtype: torch.dtype,
                    forward: Callable = fused_forward,
                    marginals: Callable = fused_marginals):
  """Per-frame posteriors (counterpart of the JAX package's
  ``fused_label_marginals``): the forward with its residuals, then the
  marginals scan. No gradient (the JAX function has none either).

  The defaults launch the kernels on CUDA tensors and run the plain
  versions on CPU tensors; ``fused_forward_plain`` /
  ``fused_marginals_plain`` run the plain versions on the card too.

  Returns:
    (blank_marginals [B, T, S], label_marginals [B, T, V]) float32, zero on
    padding frames.
  """
  num_frames = torch.as_tensor(num_frames, device=frames.device)
  pf, pc, is_pad = _stage(cache, frames, num_frames, wf_params['frame_proj'],
                          wf_params['context_proj'])
  head = {n: wf_params[n] for n in ('vocab_w', 'vocab_b', 'blank_w',
                                    'blank_b')}
  kw = dict(max_expansions=max_expansions, frame_dependent=frame_dependent,
            compute_dtype=compute_dtype)
  log_z, _, hist, slabs = forward(pf, pc, head, is_pad, with_residuals=True,
                                  **kw)
  bm, lp = marginals(pf, pc, head, is_pad, log_z, hist, slabs, **kw)
  return bm.transpose(0, 1).contiguous(), lp.transpose(0, 1).contiguous()
