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

"""Viterbi forward kernel for Hopper, its plain version, and the backtrace.

Counterpart of ``last_torch_tpu/ops/viterbi.py``. The tropical forward scan
(``_viterbi_forward_kernel`` there, a Pallas TPU kernel) is
``csrc/viterbi.cu`` here, reached through ``viterbi_forward``: on a CUDA
tensor it launches the kernel, on a CPU tensor it runs
``viterbi_forward_plain``, the same function in plain PyTorch. In bfloat16
the kernel runs on ``csrc/head_product.cuh``'s wgmma products over each
frame's live rows (``forward_scratch``, ``joint_head.reduce_plan``); in
float32 on CUDA-core tiles, for exact comparison with the plain version.
The backtrace is plain PyTorch on the device, a reverse loop of gathers, as
the JAX package's is plain XLA.

Scope matches the JAX package's decode gate (``fused_scan.supported``):
MaxTropical over a bigram ``FullNGram`` with ``JointWeightFn`` and
``FrameDependent`` / ``FrameLabelDependent``, one batch dimension, and
``normalize`` 'none', 'hat' (``hat_normalize``) or 'log_softmax'
(``log_softmax_normalize``), the local normalization of a
``LocallyNormalizedWeightFn`` computed inside the kernel.
"""

from __future__ import annotations

import ctypes
from collections.abc import Callable
from typing import Any, Optional

import torch

from last_torch_tpu_torch.ops import fused_scan, joint_head
from last_torch_tpu_torch.utils import profiling

# Forward calls that launched the CUDA kernel, for runs that must show the
# decode went through it. Only ``viterbi_forward`` on a CUDA tensor counts.
launches = 0

_LIB = None
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
NORMALIZE_CODES = {'none': 0, 'hat': 1, 'log_softmax': 2}
# The float32 kernel's tile sizes (csrc/tile_product.cuh: kBM, kBN); its
# max-pass grid splits the states across blocks to fill the card.
_STATES_PER_TILE = 64
_LABELS_PER_BLOCK = 64
# The bfloat16 products' label strips (csrc/head_product.cuh: kBN).
_STRIP_LABELS = 128


def num_tables(max_expansions: int, frame_dependent: bool) -> int:
  """K, the max-passes per frame: one argmax table [V] per pass."""
  return 1 if frame_dependent else max(max_expansions, 1)


def _ptr(x: Optional[torch.Tensor]):
  return None if x is None else x.data_ptr()


def forward_scratch(batch: int, num_states: int, hidden: int, vocab: int,
                    plan: joint_head.ReducePlan, passes: int,
                    normalize: str) -> dict:
  """name -> (shape, dtype) of the buffers of the bfloat16 forward on
  csrc/head_product.cuh (``viterbi_forward``), with ``passes`` max-passes a
  frame: the padded bfloat16 joint and head; a (max, argmax) partial per
  64-state unit; the float32 lex [B, S, V] staged for the max-passes that
  read it (the second and later ones, and every one under normalization);
  with normalization a (max, sum) row partial per 128-label strip and the
  per-state normalizers."""
  hp, vp = plan.hidden_pad, plan.vocab_pad
  units = (plan.state_tiles, batch, vocab)
  scratch = {
      'joint': ((batch, num_states, hp), torch.bfloat16),
      'vocab_w': ((hp, vp), torch.bfloat16),
      'part_v': (units, torch.float32),
      'part_s': (units, torch.int32),
  }
  if passes >= 2 or normalize != 'none':
    scratch['lex'] = ((batch, num_states, vocab), torch.float32)
  if normalize != 'none':
    strips = (-(-vp // _STRIP_LABELS), batch, num_states)
    scratch['part_m'] = scratch['part_l'] = (strips, torch.float32)
    scratch['cnorm'] = ((batch, num_states), torch.float32)
  return scratch


def viterbi_forward(pf: torch.Tensor, pc: torch.Tensor, params: dict[str, Any],
                    is_pad: torch.Tensor, *, max_expansions: int,
                    frame_dependent: bool, compute_dtype: torch.dtype,
                    normalize: str = 'none'):
  """Tropical forward scan: the kernel on CUDA, the plain version on CPU.

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
    normalize: 'none', or the local normalization of the arc weights:
      'hat' or 'log_softmax'.

  Returns:
    (arg [T, B, K, V] int32, jstar [T, B, S] int32, alpha [B, S] float32):
    the best source state per (pass, label), the winning expansion count
    per state, and the final forward weights. Padding frames hold alpha
    and have jstar and arg 0 (the backtrace never reads their arg; the TPU
    kernel computed it anyway, the kernel here skips their work).
  """
  global launches
  with profiling.span('viterbi.forward'):
    fused_scan.check_inputs(pf, pc, params, is_pad, compute_dtype, 'Viterbi')
    if normalize not in NORMALIZE_CODES:
      raise ValueError(f'normalize must be one of {tuple(NORMALIZE_CODES)}, '
                       f'got {normalize!r}')
    if pf.device.type == 'cpu':
      return viterbi_forward_plain(
          pf, pc, params, is_pad, max_expansions=max_expansions,
          frame_dependent=frame_dependent, compute_dtype=compute_dtype,
          normalize=normalize)
    if pf.device.type != 'cuda':
      raise ValueError(f'no Viterbi kernel for device {pf.device}')

    lib = library()
    max_t, batch, hidden = pf.shape
    num_states = pc.shape[0]
    vocab = params['vocab_w'].shape[-1]
    k = num_tables(max_expansions, frame_dependent)
    device = pf.device
    pad = is_pad.to(torch.int32)
    vw, bw = params['vocab_w'], params['blank_w']  # float32 on both routes
    if compute_dtype == torch.bfloat16:
      # The products of csrc/head_product.cuh on wgmma over each frame's live
      # rows: counted on the host (one synchronisation per call) and listed
      # first on the device.
      rplan = joint_head.reduce_plan(batch, num_states, hidden, vocab,
                                     joint_head.sm_count(device))
      buf = {name: torch.empty(shape, dtype=dtype, device=device)
             for name, (shape, dtype) in forward_scratch(
                 batch, num_states, hidden, vocab, rplan, k, normalize).items()}
      joint = buf['joint']
      splits = ysplits = 0
      live, rows = fused_scan.live_rows(is_pad)
      route_args = (_ptr(live), _ptr(rows), _ptr(buf['vocab_w']),
                    rplan.max_blocks)
    else:
      joint = torch.empty((batch, num_states, hidden), device=device)
      # With two or more max-passes per frame the first stages the frame's
      # lexical scores for the others; with normalization the normalizing
      # pass stages them for every max-pass.
      buf = {}
      if k >= 2 or normalize != 'none':
        buf['lex'] = torch.empty((batch, num_states, vocab), device=device)
      strips = -(-vocab // _LABELS_PER_BLOCK)
      tiles = -(-num_states // _STATES_PER_TILE)
      splits = fused_scan.grid_splits(strips * batch, tiles, device)
      ysplits = fused_scan.grid_splits(tiles * batch, strips, device)
      buf['part_v'] = torch.empty((splits, batch, vocab), device=device)
      buf['part_s'] = torch.empty((splits, batch, vocab), dtype=torch.int32,
                                  device=device)
      if normalize != 'none':
        for name in ('part_m', 'part_l'):
          buf[name] = torch.empty((ysplits, batch, num_states), device=device)
        buf['cnorm'] = torch.empty((batch, num_states), device=device)
      route_args = (None, None, None, 0)
    blank = torch.empty((batch, num_states), device=device)
    last = torch.empty((k, batch, num_states), device=device)
    alpha = torch.full((2, batch, num_states), float('-inf'), device=device)
    alpha[0, :, 0] = 0.0
    arg = torch.empty((max_t, batch, k, vocab), dtype=torch.int32,
                      device=device)
    jstar = torch.empty((max_t, batch, num_states), dtype=torch.int32,
                        device=device)
    with torch.cuda.device(device):
      stream = torch.cuda.current_stream(device).cuda_stream
      status = lib.viterbi_forward(
          _DTYPE_CODES[compute_dtype], _ptr(pf), _ptr(pc), _ptr(vw),
          _ptr(params['vocab_b']), _ptr(bw), _ptr(params['blank_b']),
          _ptr(pad), _ptr(joint), _ptr(blank),
          *(_ptr(buf.get(name)) for name in (
              'lex', 'part_v', 'part_s', 'part_m', 'part_l', 'cnorm')),
          _ptr(last), _ptr(alpha), _ptr(arg), _ptr(jstar), max_t, batch,
          num_states, hidden, vocab, max_expansions, int(frame_dependent),
          NORMALIZE_CODES[normalize], splits, ysplits, *route_args, stream)
    if status != 0:
      raise RuntimeError('Viterbi kernel launch failed: '
                         f'{lib.viterbi_error_string(status).decode()}')
    launches += 1
    return arg, jstar, alpha[max_t % 2]


def library() -> ctypes.CDLL:
  """The kernel library, built from csrc/viterbi.cu at first use."""
  global _LIB
  if _LIB is None:
    from last_torch_tpu_torch.ops import build
    lib = build.load('viterbi.cu')
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.viterbi_forward.argtypes = ([i] + [p] * 19 + [i] * 10 + [p] * 3 +
                                    [i, p])
    lib.viterbi_forward.restype = i
    lib.viterbi_error_string.argtypes = [i]
    lib.viterbi_error_string.restype = ctypes.c_char_p
    _LIB = lib
  return _LIB


def viterbi_forward_plain(pf: torch.Tensor, pc: torch.Tensor,
                          params: dict[str, Any], is_pad: torch.Tensor, *,
                          max_expansions: int, frame_dependent: bool,
                          compute_dtype: torch.dtype,
                          normalize: str = 'none'):
  """The kernel's function in plain PyTorch (same arguments and outputs).

  With compute_dtype bfloat16 the joint and the head weights are rounded to
  bfloat16 and back, then multiplied in float32, so on the card this and
  the kernel differ only in summation order, provided float32 matmuls do
  not use TF32 (``torch.backends.cuda.matmul.allow_tf32 = False``, the
  default). Normalization subtracts each state's normalizer from the
  state's score before the lexical weights are added, as the kernel does.
  """
  max_t, batch, _ = pf.shape
  num_states = pc.shape[0]
  k = num_tables(max_expansions, frame_dependent)
  rnd = lambda x: x.to(compute_dtype).float()
  vw, vb = rnd(params['vocab_w']), params['vocab_b']
  bw, bb = rnd(params['blank_w']), params['blank_b']
  vocab = vw.shape[-1]
  alpha = torch.full((batch, num_states), float('-inf'), device=pf.device)
  alpha[:, 0] = 0.0
  arg = torch.empty((max_t, batch, k, vocab), dtype=torch.int32,
                    device=pf.device)
  jstar = torch.empty((max_t, batch, num_states), dtype=torch.int32,
                      device=pf.device)
  start_col = torch.full((batch, 1), float('-inf'), device=pf.device)

  for t in range(max_t):
    joint = rnd(torch.tanh(pc[None] + pf[t][:, None]))  # [B, S, h]
    lex = joint @ vw + vb  # [B, S, V]
    blank = joint @ bw + bb  # [B, S]
    cnorm = None
    if normalize == 'hat':
      cnorm = torch.logsumexp(lex, dim=-1) + _softplus(blank)
      blank = -_softplus(-blank)
    elif normalize == 'log_softmax':
      cnorm = torch.logaddexp(blank, torch.logsumexp(lex, dim=-1))
      blank = blank - cnorm

    def max_pass(vec):
      # First index among equal maxima, as jnp.argmax; returned expanded.
      if cnorm is not None:
        vec = vec - cnorm
      red, best = torch.max(vec[:, :, None] + lex, dim=1)
      return torch.cat([start_col, red], dim=1), best.to(torch.int32)

    last, arg[t, :, 0] = max_pass(alpha)
    if frame_dependent:
      stay = alpha + blank
      alpha_new = torch.maximum(stay, last)
      js = (last > stay).to(torch.int32)
    else:
      acc = alpha + blank
      js = torch.zeros_like(alpha, dtype=torch.int32)
      for j in range(1, max_expansions + 1):
        cand = last + blank
        better = cand > acc
        acc = torch.where(better, cand, acc)
        js = torch.where(better, j, js)
        if j < max_expansions:
          last, arg[t, :, j] = max_pass(last)
      alpha_new = acc
    pad = is_pad[t][:, None]
    alpha = torch.where(pad, alpha, alpha_new)
    jstar[t] = torch.where(pad, 0, js)
  arg.masked_fill_(is_pad[:, :, None, None], 0)
  return arg, jstar, alpha


def _softplus(x: torch.Tensor) -> torch.Tensor:
  return torch.logaddexp(x, torch.zeros_like(x))


def backtrace(arg: torch.Tensor, jstar: torch.Tensor, alpha: torch.Tensor,
              is_pad: torch.Tensor, *, max_expansions: int,
              frame_dependent: bool):
  """Recovers the best alignment from the forward's argmax tables.

  Plain PyTorch gathers on the tables' device. The frame-local part runs
  for all frames and end states at once: walking a frame's expansion chain
  backwards from each state q it may end in gives the state it started in
  and its labels. What stays sequential is a reverse loop of one gather
  per frame, from the final state back to the start.

  Returns:
    (alignment_labels [B, T * A] int32, path_weights [B] float32), with A
    label slots per frame: expansions 1..k, then the trailing blank (FLD),
    or the single slot (FD).
  """
  with profiling.span('viterbi.backtrace'):
    max_t, batch, num_states = jstar.shape
    path_weights, q = torch.max(alpha, dim=-1)  # q: first argmax, as JAX
    steps = 1 if frame_dependent else max_expansions
    real = ~is_pad[:, :, None]
    # start[t, b, q]: the state frame t began in, given it ended in q.
    start = torch.arange(num_states, device=alpha.device).expand(
        max_t, batch, num_states)
    slots = []
    for i in range(steps, 0, -1):
      active = (jstar >= i) & real
      # Bigram: the label that enters state q (q in 1..V) is q itself.
      slots.append(torch.where(active, start, 0).to(torch.int32))
      src = arg[:, :, i - 1].gather(2, (start - 1).clamp(min=0))
      start = torch.where(active, src.long(), start)
    slots.reverse()  # slot order: expansion 1..k, then the trailing blank
    if not frame_dependent:
      slots.append(torch.zeros_like(start, dtype=torch.int32))
    table = torch.stack(slots, dim=-1)  # [T, B, S, A]

    ends = []  # the state each frame ended in, last frame first
    for t in range(max_t - 1, -1, -1):
      ends.append(q)
      q = start[t].gather(1, q[:, None])[:, 0]
    ends = torch.stack(ends[::-1]) if ends else q.new_zeros((0, batch))
    labels = table.gather(
        2, ends[:, :, None, None].expand(-1, -1, 1, table.shape[-1]))[:, :, 0]
    return labels.transpose(0, 1).reshape(batch, -1), path_weights


def viterbi_decode(wf_params: dict[str, Any], cache: torch.Tensor,
                   frames: torch.Tensor, num_frames: torch.Tensor, *,
                   max_expansions: int, frame_dependent: bool,
                   compute_dtype: torch.dtype, normalize: str = 'none',
                   forward: Callable = viterbi_forward):
  """Viterbi forward + backtrace: ``RecognitionLattice.shortest_path``.

  ``forward`` is ``viterbi_forward`` (kernel on CUDA, plain on CPU) or
  ``viterbi_forward_plain`` (to run the plain version on the card too);
  ``normalize`` is the local normalization ('none', 'hat', 'log_softmax').

  Returns:
    (alignment_labels [B, T * A] int32, num_alignment_labels [B] int32,
    path_weights [B] float32).
  """
  max_t = frames.shape[1]
  with profiling.span('viterbi.project'):
    pf = torch.einsum('btf,fh->tbh', frames,
                      wf_params['frame_proj']).contiguous()
    pc = (cache @ wf_params['context_proj']).contiguous()
    is_pad = (torch.arange(max_t, device=frames.device)[:, None] >=
              num_frames[None, :])
  arg, jstar, alpha = forward(
      pf, pc, wf_params, is_pad, max_expansions=max_expansions,
      frame_dependent=frame_dependent, compute_dtype=compute_dtype,
      normalize=normalize)
  labels, path_weights = backtrace(
      arg, jstar, alpha, is_pad, max_expansions=max_expansions,
      frame_dependent=frame_dependent)
  num_align = 1 if frame_dependent else max_expansions + 1
  num_labels = (num_align * num_frames).to(torch.int32)
  return labels, num_labels, path_weights
