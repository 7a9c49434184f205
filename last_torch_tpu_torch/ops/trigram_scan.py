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

"""Log-partition kernels of the trigram lattice (``FullNGram`` with
``context_size=2``) for Hopper, and their plain versions.

Counterpart of ``last_torch_tpu/ops/trigram_scan.py``. Its forward scan
(``_trigram_forward_kernel``) and reverse beta scan with the head and tanh
gradients (``_trigram_backward_kernel``) are the trigram mode of
``csrc/fused_scan.cu`` (``trigram_forward``, ``trigram_backward``), reached
through ``trigram_forward`` and ``trigram_backward``: on a CUDA tensor they
launch the kernels, on a CPU tensor they run ``trigram_forward_plain`` /
``trigram_backward_plain``. ``log_partition`` joins the two in the
``torch.autograd.Function`` of ``ops/fused_scan.py``.

States keep FullNGram's own order (0 the start, 1..V the unigrams, 1 + V +
(q - 1) V + (p - 1) the bigram (q, p)), in and out: the alpha history and
the expansion slabs the forward writes are in that order. The label-y arc of
a state whose last symbol is p reaches the bigram (p, y), so each
destination sums over one segment of V + 1 source states and each segment's
destinations are contiguous; the kernels need none of the TPU kernels'
segment-major layout, transposes or blank folding.

In bfloat16 with FD or FLD(k >= 1) and V <= 128 (``segment_route``) the
kernels run by segment on wgmma (``trigram_segment_forward`` /
``trigram_segment_backward`` of ``csrc/fused_scan.cu``): a block owns
segment p and a group of batch rows, forms the joint in the product's
operand (never in memory: no [B, S, h] buffer in either direction, and no
[B, S, V] d_lex), and reduces over its sources in registers. The float32
comparison mode, FLD(0), V > 128 and hidden sizes whose buffers pass a
block's shared memory keep the first design's kernels on
``tile_product.cuh``'s tiles.

Scope is the structural half of the JAX package's gate (``supported``): a
``JointWeightFn`` (exactly), ``FullNGram(context_size=2)``,
``FrameDependent`` / ``FrameLabelDependent``, one batch dimension. The TPU's
small-vocabulary and VMEM rules are replaced by the port's memory rule: the
design stages each frame's lexical weights, [B, S, V] in float32, and the
backward's lexical cotangent d_lex, [B, S, V] in the compute type, and these
must fit ``fused_scan.LEX_STAGE_BUDGET`` (8 GiB), counted as
``fused_scan.plan`` counts them. With S = 1 + V + V^2 that is B S V (4 + 2)
bytes on the card (bfloat16 d_lex): 8.5 MB at V=64, B=8 (4161 states), and
the budget at B=8 is first passed at V=564 (S = 318,661); in float32 (the
CPU's compute type) at V=512. Past it the lattice takes the generic route,
as the JAX package's takes XLA past its VMEM budget. There is no 'online'
mode: the lexical work per frame grows as V^3 and the generic route is what
remains beyond the budget.

Both scans take the relay seeds of the bigram pair: ``alpha0`` (alpha before
the first frame) and ``beta0`` (beta after the last), so that blocks of
frames chain into one sequence, forward left to right and backward right to
left with the whole sequence's log Z, as the JAX kernels chain.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Callable
from typing import Any, Optional

import torch

from last_torch_tpu_torch import alignments, contexts, semirings, weight_fns
from last_torch_tpu_torch.ops import fused_scan

# Calls that launched the CUDA kernels, for runs that must show which
# kernels they went through. Only CUDA tensors count.
forward_launches = 0
backward_launches = 0


def _context(vocab: int) -> contexts.FullNGram:
  return contexts.FullNGram(vocab_size=vocab, context_size=2)


def staged_bytes(batch: int, vocab: int, compute_dtype: torch.dtype) -> int:
  """Bytes the kernels stage per frame: lex in float32 and d_lex in the
  compute type, [B, S, V] each."""
  itemsize = torch.empty((), dtype=compute_dtype).element_size()
  return batch * _context(vocab).num_states() * vocab * (4 + itemsize)


@dataclasses.dataclass(frozen=True)
class SegmentPlan:
  """Grid of the segment kernels (``segment_plan``).

  Attributes:
    hidden_pad, vocab_pad: h and V rounded up to 64; the bfloat16 head is
      padded to [hidden_pad, vocab_pad] with zeros.
    strips: 64-label strips of the product (1 for V <= 64, else 2).
    group: batch rows a block owns, one warpgroup each (4 with one strip,
      2 with two: a warpgroup's float32 sums, strips tiles of 64 x 64, and
      the block's registers fit).
    groups: blocks along the batch, ceil(B / group).
    blocks: blocks of a launch, (V + 1) segments x groups.
  """
  hidden_pad: int
  vocab_pad: int
  strips: int
  group: int
  groups: int
  blocks: int


def segment_plan(batch: int, vocab: int, hidden: int) -> SegmentPlan:
  """The ``SegmentPlan`` of a call that the segment kernels run (V <= 128:
  ``segment_route`` says which calls they run)."""
  cdiv = lambda n, m: -(-n // m)
  vp, hp = cdiv(vocab, 64) * 64, cdiv(hidden, 64) * 64
  if vp > 128:
    raise ValueError(f'the segment kernels take V <= 128, not {vocab}')
  strips = vp // 64
  group = 4 // strips
  groups = cdiv(batch, group)
  return SegmentPlan(hp, vp, strips, group, groups, (vocab + 1) * groups)


def segment_route(batch: int, vocab: int, hidden: int,
                  compute_dtype: torch.dtype,
                  passes: int) -> Optional[SegmentPlan]:
  """The ``SegmentPlan`` of a call on the card, or None where the segment
  kernels do not run it and the first design's on ``tile_product.cuh`` do:
  float32, and what the library's ``trigram_segment_smem`` refuses (FLD(0)
  with ``passes`` 0, more than 8 reductions a frame, V > 128, or a hidden
  size whose buffers pass a block's shared memory: h > 1024 at V <= 64, h >
  704 at V <= 128)."""
  if compute_dtype != torch.bfloat16:
    return None
  if not fused_scan.library().trigram_segment_smem(hidden, vocab, passes):
    return None
  return segment_plan(batch, vocab, hidden)


def segment_forward_scratch(plan: SegmentPlan, batch: int, vocab: int,
                            passes: int, with_slabs: bool) -> dict:
  """name -> (shape, dtype) of the segment forward's buffers: the padded
  head, blank, the float32 lex [B, S, V] that later expansions read (two
  or more reductions a frame; within ``staged_bytes``) and, without the
  slabs, the expansions of two frames."""
  states = _context(vocab).num_states()
  scratch = {'vocab_w': ((plan.hidden_pad, plan.vocab_pad), torch.bfloat16),
             'blank': ((batch, states), torch.float32)}
  if passes >= 2:
    scratch['lex'] = ((batch, states, vocab), torch.float32)
  if not with_slabs:
    scratch['last'] = ((2, passes, batch, states), torch.float32)
  return scratch


def segment_backward_scratch(plan: SegmentPlan, batch: int, vocab: int,
                             hidden: int, passes: int) -> dict:
  """name -> (shape, dtype) of the segment backward's buffers: the padded
  head, blank and the float32 lex [B, S, V] of a frame, the earlier
  reductions' nb, d(pf)'s per-segment partials and the cross-frame
  accumulators (d_pc per group of rows, the head's per block). No [B, S,
  h] buffer and no d_lex in device memory."""
  states = _context(vocab).num_states()
  f32 = torch.float32
  return {
      'vocab_w': ((plan.hidden_pad, plan.vocab_pad), torch.bfloat16),
      'blank': ((batch, states), f32),
      'lex': ((batch, states, vocab), f32),
      'nb': ((max(passes - 1, 1), batch, states), f32),
      'dpf_part': ((vocab + 1, batch, hidden), f32),
      'dpc_acc': ((plan.groups, states, hidden), f32),
      'dvw_acc': ((plan.blocks, hidden, vocab), f32),
      'dvb_acc': ((plan.blocks, vocab), f32),
      'dbw_acc': ((plan.blocks, hidden), f32),
      'dbb_acc': ((plan.blocks,), f32),
  }


def supported(lattice, frames: torch.Tensor) -> bool:
  """Whether the trigram kernels (and their plain versions) cover a lattice
  call: the structural half of ``last_torch_tpu.ops.trigram_scan.supported``
  and the port's memory rule (module docstring), computed from shapes."""
  context = lattice.context
  if not (type(lattice.weight_fn) is weight_fns.JointWeightFn and
          type(context) is contexts.FullNGram and
          context.context_size == 2 and
          isinstance(lattice.alignment, (alignments.FrameDependent,
                                         alignments.FrameLabelDependent)) and
          frames.ndim == 3):
    return False
  return staged_bytes(frames.shape[0], context.vocab_size,
                      fused_scan.compute_dtype_for(frames.device)) <= (
                          fused_scan.LEX_STAGE_BUDGET)


def trigram_forward(pf: torch.Tensor, pc: torch.Tensor,
                    params: dict[str, Any], is_pad: torch.Tensor, *,
                    max_expansions: int, frame_dependent: bool,
                    compute_dtype: torch.dtype, with_residuals: bool,
                    alpha0: Optional[torch.Tensor] = None):
  """Trigram log-semiring forward scan: the kernel on CUDA, the plain
  version on CPU.

  Args:
    pf: [T, B, h] float32 projected frames (``frames @ frame_proj``).
    pc: [S, h] float32 projected context states, S = 1 + V + V^2.
    params: JointWeightFn parameters (``vocab_w``, ``vocab_b``,
      ``blank_w``, ``blank_b``), float32.
    is_pad: [T, B] bool, True on padding frames.
    max_expansions: k of FrameLabelDependent (ignored for FrameDependent).
    frame_dependent: FrameDependent (True) or FrameLabelDependent (False).
    compute_dtype: torch.float32 or torch.bfloat16, the type the joint and
      the head weights are rounded to before the float32 products.
    with_residuals: Also write what the backward reads: the alpha history
      and, for FrameLabelDependent, the expansion slabs.
    alpha0: Optional [B, S] float32 alpha before frame 0, as
      ``fused_scan.fused_forward`` takes it.

  Returns:
    (log_z [B], final alpha [B, S], history [T, B, S] or None, slabs
    [k, T, B, S] or None), states in FullNGram's order, as
    ``fused_scan.fused_forward`` returns them.
  """
  global forward_launches
  fused_scan.check_inputs(pf, pc, params, is_pad, compute_dtype,
                          'trigram log-partition', context_size=2)
  fused_scan._check_seed(pf, pc, alpha0, 'alpha0')
  kw = dict(max_expansions=max_expansions, frame_dependent=frame_dependent,
            compute_dtype=compute_dtype, with_residuals=with_residuals,
            alpha0=alpha0)
  if pf.device.type == 'cpu':
    return trigram_forward_plain(pf, pc, params, is_pad, **kw)
  if pf.device.type != 'cuda':
    raise ValueError(f'no trigram log-partition kernel for device '
                     f'{pf.device}')

  lib = fused_scan.library()
  max_t, batch, hidden = pf.shape
  states = pc.shape[0]
  vocab = params['vocab_w'].shape[-1]
  k = fused_scan.num_passes(max_expansions, frame_dependent)
  device = pf.device
  empty = lambda *shape, dtype=torch.float32: torch.empty(
      shape, dtype=dtype, device=device)
  ptr = fused_scan._ptr
  hist = empty(max_t, batch, states) if with_residuals else None
  slabs = (empty(k, max_t, batch, states)
           if with_residuals and not frame_dependent and k else None)
  alpha = fused_scan.initial_alpha(2, batch, states, alpha0, device)
  plan = segment_route(batch, vocab, hidden, compute_dtype, k)
  if plan is not None:
    # Scratch, held until the call has enqueued every launch.
    buf = {name: empty(*shape, dtype=dtype) for name, (shape, dtype) in
           segment_forward_scratch(plan, batch, vocab, k,
                                   slabs is not None).items()}
    buf['vocab_w'].zero_()[:hidden, :vocab] = params['vocab_w']
    buf['is_pad'] = is_pad.to(torch.int32)
    with torch.cuda.device(device):
      stream = torch.cuda.current_stream(device).cuda_stream
      status = lib.trigram_segment_forward(
          ptr(pf), ptr(pc), ptr(buf['vocab_w']), ptr(params['vocab_b']),
          ptr(params['blank_w']), ptr(params['blank_b']),
          ptr(buf['is_pad']), ptr(buf['blank']),
          ptr(buf.get('lex')), ptr(buf.get('last')), ptr(alpha), ptr(hist),
          ptr(slabs), max_t, batch, states, hidden, vocab, max_expansions,
          int(frame_dependent), stream)
    fused_scan._raise_on(status, 'trigram log-partition forward')
    forward_launches += 1
    final = alpha[max_t % 2]
    return torch.logsumexp(final, dim=-1), final, hist, slabs

  # Scratch, held until the call has enqueued every launch.
  vw = params['vocab_w'].to(compute_dtype).contiguous()
  bw = params['blank_w'].to(compute_dtype).contiguous()
  pad = is_pad.to(torch.int32)
  joint = empty(batch, states, hidden, dtype=compute_dtype)
  blank = empty(batch, states)
  lex = empty(batch, states, vocab) if k else None
  last = None if slabs is not None else empty(max(k, 1), batch, states)
  with torch.cuda.device(device):
    stream = torch.cuda.current_stream(device).cuda_stream
    status = lib.trigram_forward(
        fused_scan._DTYPE_CODES[compute_dtype], ptr(pf), ptr(pc), ptr(vw),
        ptr(params['vocab_b']), ptr(bw), ptr(params['blank_b']), ptr(pad),
        ptr(joint), ptr(blank), ptr(lex), ptr(last), ptr(alpha), ptr(hist),
        ptr(slabs), max_t, batch, states, hidden, vocab, max_expansions,
        int(frame_dependent), stream)
  fused_scan._raise_on(status, 'trigram log-partition forward')
  forward_launches += 1
  final = alpha[max_t % 2]
  return torch.logsumexp(final, dim=-1), final, hist, slabs


def trigram_forward_plain(pf: torch.Tensor, pc: torch.Tensor,
                          params: dict[str, Any], is_pad: torch.Tensor, *,
                          max_expansions: int, frame_dependent: bool,
                          compute_dtype: torch.dtype, with_residuals: bool,
                          alpha0: Optional[torch.Tensor] = None):
  """The forward kernel's function in plain PyTorch (same arguments and
  outputs): each expansion is ``FullNGram.forward_reduce`` of the frame's
  [B, S, V] arc weights. Rounds where the kernel rounds and computes in the
  type of its inputs (float64 inputs give a float64 reference)."""
  reduce_arcs = _context(params['vocab_w'].shape[-1]).forward_reduce
  return fused_scan.forward_scan_plain(
      pf, pc, params, is_pad, max_expansions=max_expansions,
      frame_dependent=frame_dependent, compute_dtype=compute_dtype,
      with_residuals=with_residuals,
      reduce_arcs=lambda weights: reduce_arcs(weights, semirings.Log),
      alpha0=alpha0)


def trigram_backward(pf: torch.Tensor, pc: torch.Tensor,
                     params: dict[str, Any], is_pad: torch.Tensor,
                     log_z: torch.Tensor, g: torch.Tensor, hist: torch.Tensor,
                     slabs: Optional[torch.Tensor], *, max_expansions: int,
                     frame_dependent: bool, compute_dtype: torch.dtype,
                     beta0: Optional[torch.Tensor] = None):
  """Trigram reverse beta scan with head and tanh gradients: the kernel on
  CUDA, the plain version on CPU.

  Args:
    pf, pc, params, is_pad, max_expansions, frame_dependent, compute_dtype:
      as ``trigram_forward``.
    log_z: [B] float32 from ``trigram_forward``.
    g: [B] float32 cotangent of log_z.
    hist: [T, B, S] alpha history from ``trigram_forward``.
    slabs: [k, T, B, S] expansion slabs (FrameLabelDependent), else None.
    beta0: Optional [B, S] float32 beta after the last frame, as
      ``fused_scan.fused_backward`` takes it (``log_z`` then the whole
      sequence's).

  Returns:
    (dpf [T, B, h], dpc [S, h], d_vocab_w [h, V], d_vocab_b [V],
    d_blank_w [h], d_blank_b [], beta_out [B, S]): the gradients of
    sum(g * log_z) with respect to pf, pc and the head parameters, and beta
    at frame 0. Padding frames, empty rows and g = 0 rows get exactly zero
    gradient.
  """
  global backward_launches
  fused_scan.check_inputs(pf, pc, params, is_pad, compute_dtype,
                          'trigram log-partition', context_size=2)
  fused_scan._check_residuals(pf, pc, max_expansions, frame_dependent,
                              log_z=log_z, g=g, hist=hist, slabs=slabs)
  fused_scan._check_seed(pf, pc, beta0, 'beta0')
  kw = dict(max_expansions=max_expansions, frame_dependent=frame_dependent,
            compute_dtype=compute_dtype, beta0=beta0)
  if pf.device.type == 'cpu':
    return trigram_backward_plain(pf, pc, params, is_pad, log_z, g, hist,
                                  slabs, **kw)
  if pf.device.type != 'cuda':
    raise ValueError(f'no trigram log-partition kernel for device '
                     f'{pf.device}')

  max_t, batch, hidden = pf.shape
  vocab = params['vocab_w'].shape[-1]
  plan = segment_route(batch, vocab, hidden, compute_dtype,
                       fused_scan.num_passes(max_expansions, frame_dependent))
  if plan is None:
    grads = fused_scan.launch_backward('trigram_backward', pf, pc, params,
                                       is_pad, log_z, g, hist, slabs, **kw)
  else:
    grads = _segment_backward(plan, pf, pc, params, is_pad, log_z, g, hist,
                              slabs, max_expansions, frame_dependent, beta0)
  backward_launches += 1
  return grads


def _segment_backward(plan, pf, pc, params, is_pad, log_z, g, hist, slabs,
                      max_expansions, frame_dependent, beta0=None):
  """Launches ``trigram_segment_backward``; arguments and outputs as
  ``trigram_backward``'s."""
  lib = fused_scan.library()
  max_t, batch, hidden = pf.shape
  states = pc.shape[0]
  vocab = params['vocab_w'].shape[-1]
  passes = fused_scan.num_passes(max_expansions, frame_dependent)
  device = pf.device
  empty = lambda *shape, dtype=torch.float32: torch.empty(
      shape, dtype=dtype, device=device)
  # Scratch, held until the call has enqueued every launch; the
  # accumulators start at zero.
  buf = {name: empty(*shape, dtype=dtype) for name, (shape, dtype) in
         segment_backward_scratch(plan, batch, vocab, hidden,
                                  passes).items()}
  buf['vocab_w'].zero_()[:hidden, :vocab] = params['vocab_w']
  for name in ('dpc_acc', 'dvw_acc', 'dvb_acc', 'dbw_acc', 'dbb_acc'):
    buf[name].zero_()
  buf['is_pad'] = is_pad.to(torch.int32)
  beta = fused_scan.initial_beta(batch, states, beta0, device)
  dpf = empty(max_t, batch, hidden)
  dpc, dvw = empty(states, hidden), empty(hidden, vocab)
  dvb, dbw, dbb = empty(vocab), empty(hidden), empty(1)
  ptr = fused_scan._ptr
  with torch.cuda.device(device):
    stream = torch.cuda.current_stream(device).cuda_stream
    status = lib.trigram_segment_backward(
        ptr(pf), ptr(pc), ptr(buf['vocab_w']), ptr(params['vocab_b']),
        ptr(params['blank_w']), ptr(params['blank_b']),
        ptr(buf['is_pad']), ptr(log_z), ptr(g), ptr(hist),
        ptr(slabs), ptr(buf['blank']), ptr(buf['lex']), ptr(buf['nb']),
        ptr(beta), ptr(dpf), ptr(buf['dpf_part']), ptr(buf['dpc_acc']),
        ptr(buf['dvw_acc']), ptr(buf['dvb_acc']), ptr(buf['dbw_acc']),
        ptr(buf['dbb_acc']), ptr(dpc), ptr(dvw), ptr(dvb), ptr(dbw),
        ptr(dbb), max_t, batch, states, hidden, vocab, max_expansions,
        int(frame_dependent), stream)
  fused_scan._raise_on(status, 'trigram log-partition backward')
  return dpf, dpc, dvw, dvb, dbw, dbb[0], beta[max_t % 2]


def trigram_backward_plain(pf: torch.Tensor, pc: torch.Tensor,
                           params: dict[str, Any], is_pad: torch.Tensor,
                           log_z: torch.Tensor, g: torch.Tensor,
                           hist: torch.Tensor, slabs: Optional[torch.Tensor],
                           *, max_expansions: int, frame_dependent: bool,
                           compute_dtype: torch.dtype,
                           beta0: Optional[torch.Tensor] = None):
  """The backward kernel's function in plain PyTorch (same arguments and
  outputs): each arc reads the next beta at its destination through
  ``FullNGram.backward_broadcast``. Rounds at the kernel's points, as
  ``fused_scan.fused_backward_plain``."""
  return fused_scan.backward_scan_plain(
      pf, pc, params, is_pad, log_z, g, hist, slabs,
      max_expansions=max_expansions, frame_dependent=frame_dependent,
      compute_dtype=compute_dtype,
      dests=_context(params['vocab_w'].shape[-1]).backward_broadcast,
      beta0=beta0)


def log_partition(wf_params: dict[str, Any], cache: torch.Tensor,
                  frames: torch.Tensor, num_frames: torch.Tensor, *,
                  max_expansions: int, frame_dependent: bool,
                  compute_dtype: torch.dtype,
                  forward: Callable = trigram_forward,
                  backward: Callable = trigram_backward) -> torch.Tensor:
  """Differentiable trigram log-partition (GN loss denominator), [B] log Z.

  Gradients flow to ``wf_params``, ``cache`` and ``frames``; ``num_frames``
  gets none. The defaults launch the kernels on CUDA tensors and run the
  plain versions on CPU tensors; ``forward=trigram_forward_plain,
  backward=trigram_backward_plain`` run the plain versions on the card.
  """
  return fused_scan.scan_log_partition(
      wf_params, cache, frames, num_frames, forward=forward,
      backward=backward, max_expansions=max_expansions,
      frame_dependent=frame_dependent, compute_dtype=compute_dtype)
