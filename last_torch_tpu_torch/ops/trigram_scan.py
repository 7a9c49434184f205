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
remains beyond the budget. The time-sharded relay's ``alpha0`` / ``beta0``
chaining of the JAX kernels (``parallel/sequence.py``'s) is not ported
(ROADMAP queue 1, item 10).
"""

from __future__ import annotations

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
                    compute_dtype: torch.dtype, with_residuals: bool):
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

  Returns:
    (log_z [B], final alpha [B, S], history [T, B, S] or None, slabs
    [k, T, B, S] or None), states in FullNGram's order, as
    ``fused_scan.fused_forward`` returns them.
  """
  global forward_launches
  fused_scan.check_inputs(pf, pc, params, is_pad, compute_dtype,
                          'trigram log-partition', context_size=2)
  kw = dict(max_expansions=max_expansions, frame_dependent=frame_dependent,
            compute_dtype=compute_dtype, with_residuals=with_residuals)
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
  # Scratch, held until the call has enqueued every launch.
  vw = params['vocab_w'].to(compute_dtype).contiguous()
  bw = params['blank_w'].to(compute_dtype).contiguous()
  pad = is_pad.to(torch.int32)
  joint = empty(batch, states, hidden, dtype=compute_dtype)
  blank = empty(batch, states)
  lex = empty(batch, states, vocab) if k else None
  hist = empty(max_t, batch, states) if with_residuals else None
  slabs = (empty(k, max_t, batch, states)
           if with_residuals and not frame_dependent and k else None)
  last = None if slabs is not None else empty(max(k, 1), batch, states)
  alpha = torch.full((2, batch, states), fused_scan.NEG_INF, device=device)
  alpha[0, :, 0] = 0.0
  ptr = fused_scan._ptr
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
                          compute_dtype: torch.dtype, with_residuals: bool):
  """The forward kernel's function in plain PyTorch (same arguments and
  outputs): each expansion is ``FullNGram.forward_reduce`` of the frame's
  [B, S, V] arc weights. Rounds where the kernel rounds and computes in the
  type of its inputs (float64 inputs give a float64 reference)."""
  reduce_arcs = _context(params['vocab_w'].shape[-1]).forward_reduce
  return fused_scan.forward_scan_plain(
      pf, pc, params, is_pad, max_expansions=max_expansions,
      frame_dependent=frame_dependent, compute_dtype=compute_dtype,
      with_residuals=with_residuals,
      reduce_arcs=lambda weights: reduce_arcs(weights, semirings.Log))


def trigram_backward(pf: torch.Tensor, pc: torch.Tensor,
                     params: dict[str, Any], is_pad: torch.Tensor,
                     log_z: torch.Tensor, g: torch.Tensor, hist: torch.Tensor,
                     slabs: Optional[torch.Tensor], *, max_expansions: int,
                     frame_dependent: bool, compute_dtype: torch.dtype):
  """Trigram reverse beta scan with head and tanh gradients: the kernel on
  CUDA, the plain version on CPU.

  Args:
    pf, pc, params, is_pad, max_expansions, frame_dependent, compute_dtype:
      as ``trigram_forward``.
    log_z: [B] float32 from ``trigram_forward``.
    g: [B] float32 cotangent of log_z.
    hist: [T, B, S] alpha history from ``trigram_forward``.
    slabs: [k, T, B, S] expansion slabs (FrameLabelDependent), else None.

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
  kw = dict(max_expansions=max_expansions, frame_dependent=frame_dependent,
            compute_dtype=compute_dtype)
  if pf.device.type == 'cpu':
    return trigram_backward_plain(pf, pc, params, is_pad, log_z, g, hist,
                                  slabs, **kw)
  if pf.device.type != 'cuda':
    raise ValueError(f'no trigram log-partition kernel for device '
                     f'{pf.device}')

  grads = fused_scan.launch_backward('trigram_backward', pf, pc, params,
                                     is_pad, log_z, g, hist, slabs, **kw)
  backward_launches += 1
  return grads


def trigram_backward_plain(pf: torch.Tensor, pc: torch.Tensor,
                           params: dict[str, Any], is_pad: torch.Tensor,
                           log_z: torch.Tensor, g: torch.Tensor,
                           hist: torch.Tensor, slabs: Optional[torch.Tensor],
                           *, max_expansions: int, frame_dependent: bool,
                           compute_dtype: torch.dtype):
  """The backward kernel's function in plain PyTorch (same arguments and
  outputs): each arc reads the next beta at its destination through
  ``FullNGram.backward_broadcast``. Rounds at the kernel's points, as
  ``fused_scan.fused_backward_plain``."""
  return fused_scan.backward_scan_plain(
      pf, pc, params, is_pad, log_z, g, hist, slabs,
      max_expansions=max_expansions, frame_dependent=frame_dependent,
      compute_dtype=compute_dtype,
      dests=_context(params['vocab_w'].shape[-1]).backward_broadcast)


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
