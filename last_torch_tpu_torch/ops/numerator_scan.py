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

"""Locally normalized numerator kernels for Hopper and their plain versions.

Counterpart of ``last_torch_tpu/ops/numerator_scan.py``. For every frame
and (batch, label position) row the full vocabulary head runs to give the
local normalizer, and the normalized weights of blank and of the next label
are kept (``hat_normalize`` or ``log_softmax_normalize``). The forward
(``_fwd_kernel`` there) and its VJP (``_bwd_kernel``) are the CUDA kernels
of ``csrc/numerator_scan.cu``, reached through ``numerator_forward`` and
``numerator_backward``: on a CUDA tensor they launch the kernels, on a CPU
tensor they run ``numerator_forward_plain`` / ``numerator_backward_plain``,
frame-major loops computing the same functions in plain PyTorch.
``label_weights`` joins them in a ``torch.autograd.Function``, as the JAX
package's custom VJP does; the prologue around them (``frames @
frame_proj``, ``(cache @ context_proj)[states]`` and the gathered label
columns of the vocabulary head) stays plain PyTorch, and autograd carries
its gradients into the parameters.

Scope is the structural half of the JAX package's gate (``supported``
there): ``label_weights`` flattens any leading batch dimensions into the
kernels' one, and the compute type must be None, float32 or bfloat16 (else
ValueError). The TPU's ``hidden % 128`` rule and VMEM plan do not apply,
and the hidden size has no limit: the kernels keep a block's 64-row joint
tile in shared memory at most 512 (float32) or 1024 (bfloat16) hidden units
wide, and sum the products of a wider joint chunk by chunk.
"""

from __future__ import annotations

import ctypes
import dataclasses
from collections.abc import Callable
from typing import Any, Optional

import torch
from torch.nn.functional import logsigmoid

from last_torch_tpu_torch.ops import fused_scan

# Calls that launched the CUDA forward / backward kernels, for runs that must
# show the numerator went through them. Only CUDA tensors count.
forward_launches = 0
backward_launches = 0

_LIB = None
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# The kernels' tiles (csrc/numerator_scan.cu: 64 rows, 64 labels or hidden
# units), and the device memory the backward may spend on the joint and ds
# it stages for a chunk of frames.
_TILE = 64
_CHUNK_BYTES = 512 * 2**20
_HEAD = ('vocab_w', 'vocab_b', 'blank_w', 'blank_b')


def _check_inputs(pc, pf, head, wy, by, compute_dtype):
  """Checks what the kernels take; returns (T, B, U1, h, V)."""
  if pc.ndim != 2 or pf.ndim != 3:
    raise ValueError('expected pc [R, h] and pf [T, B, h], got '
                     f'{tuple(pc.shape)} and {tuple(pf.shape)}')
  num_rows, hidden = pc.shape
  max_t, batch, _ = pf.shape
  if batch == 0 or num_rows % batch:
    raise ValueError(f'{num_rows} rows do not split into {batch} batch rows')
  vocab = head['vocab_w'].shape[-1]
  expected = {
      'pc': (pc, (num_rows, hidden)),
      'pf': (pf, (max_t, batch, hidden)),
      'vocab_w': (head['vocab_w'], (hidden, vocab)),
      'vocab_b': (head['vocab_b'], (vocab,)),
      'blank_w': (head['blank_w'], (hidden,)),
      'blank_b': (head['blank_b'], ()),
      'wy': (wy, (num_rows, hidden)),
      'by': (by, (num_rows,)),
  }
  for name, (x, shape) in expected.items():
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
  return max_t, batch, num_rows // batch, hidden, vocab


def library() -> ctypes.CDLL:
  """The kernel library, built from csrc/numerator_scan.cu at first use."""
  global _LIB
  if _LIB is None:
    from last_torch_tpu_torch.ops import build
    lib = build.load('numerator_scan.cu')
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.numerator_forward.argtypes = [i] + [p] * 14 + [i] * 7 + [p]
    lib.numerator_forward.restype = i
    lib.numerator_backward.argtypes = [i] + [p] * 29 + [i] * 10 + [p]
    lib.numerator_backward.restype = i
    lib.numerator_head_smem_bytes.argtypes = [i, i]
    lib.numerator_head_smem_bytes.restype = ctypes.c_size_t
    lib.numerator_error_string.argtypes = [i]
    lib.numerator_error_string.restype = ctypes.c_char_p
    _LIB = lib
  return _LIB


def _ptr(x: Optional[torch.Tensor]):
  return None if x is None else x.data_ptr()


def _launch(device, what, call):
  """Runs ``call(lib, stream)`` on the current stream of ``device`` and
  raises on a launch error."""
  lib = library()
  with torch.cuda.device(device):
    status = call(lib, torch.cuda.current_stream(device).cuda_stream)
  if status != 0:
    raise RuntimeError(f'numerator {what} kernel launch failed: '
                       f'{lib.numerator_error_string(status).decode()}')


def numerator_forward(pc: torch.Tensor, pf: torch.Tensor,
                      head: dict[str, Any], wy: torch.Tensor,
                      by: torch.Tensor, *, hat: bool,
                      compute_dtype: torch.dtype):
  """Normalized numerator weights: the kernel on CUDA, the plain version on
  CPU.

  Args:
    pc: [R, h] float32 projected context of each row r = b * U1 + u.
    pf: [T, B, h] float32 projected frames.
    head: JointWeightFn head parameters (``vocab_w`` [h, V], ``vocab_b``,
      ``blank_w``, ``blank_b``), float32.
    wy: [R, h] float32 vocabulary-head column of each row's next label.
    by: [R] float32 its bias.
    hat: ``hat_normalize`` (True) or ``log_softmax_normalize`` (False).
    compute_dtype: torch.float32 or torch.bfloat16, the type the joint and
      ``vocab_w`` are rounded to for the head product (float32 sums).

  Returns:
    (nb, nl, z, blank), each [T, R] float32: the normalized blank and label
    weights, and the logsumexp of the logits and the raw blank weight that
    the backward reads.
  """
  global forward_launches
  max_t, batch, u1, hidden, vocab = _check_inputs(pc, pf, head, wy, by,
                                                  compute_dtype)
  if pc.device.type == 'cpu':
    return numerator_forward_plain(pc, pf, head, wy, by, hat=hat,
                                   compute_dtype=compute_dtype)
  if pc.device.type != 'cuda':
    raise ValueError(f'no numerator kernel for device {pc.device}')
  num_rows = batch * u1
  empty = lambda *shape: torch.empty(shape, device=pc.device)
  if max_t == 0:  # no frames: nothing to launch
    return tuple(empty(0, num_rows) for _ in range(4))
  strips = -(-vocab // _TILE)
  splits = fused_scan.grid_splits(max_t * -(-num_rows // _TILE), strips,
                                  pc.device)
  part_m, part_l = empty(splits, max_t, num_rows), empty(splits, max_t,
                                                         num_rows)
  nb, nl, z, blank = (empty(max_t, num_rows) for _ in range(4))
  w = head['vocab_w'].to(compute_dtype).contiguous()
  _launch(pc.device, 'forward',
          lambda lib, stream: lib.numerator_forward(
              _DTYPE_CODES[compute_dtype], _ptr(pc), _ptr(pf), _ptr(w),
              _ptr(head['vocab_b']), _ptr(head['blank_w']),
              _ptr(head['blank_b']), _ptr(wy), _ptr(by), _ptr(part_m),
              _ptr(part_l), _ptr(nb), _ptr(nl), _ptr(z), _ptr(blank), max_t,
              batch, u1, hidden, vocab, int(hat), splits, stream))
  forward_launches += 1
  return nb, nl, z, blank


def _rows_joint(pc, pf_t, batch):
  """tanh(pc[r] + pf_t[b(r)]) for every row r = b * U1 + u: [R, h]."""
  num_rows, hidden = pc.shape
  return torch.tanh(pc.view(batch, num_rows // batch, hidden) +
                    pf_t[:, None]).view(num_rows, hidden)


def numerator_forward_plain(pc: torch.Tensor, pf: torch.Tensor,
                            head: dict[str, Any], wy: torch.Tensor,
                            by: torch.Tensor, *, hat: bool,
                            compute_dtype: torch.dtype):
  """The forward kernel's function in plain PyTorch, frame by frame (same
  arguments and outputs).

  It rounds where the kernel does: the joint and ``vocab_w`` for the head
  product; the blank and label scores use the float32 joint.
  """
  max_t, batch, _ = pf.shape
  rnd = lambda x: x.to(compute_dtype).float()
  w, vb = rnd(head['vocab_w']), head['vocab_b']
  bw, bb = head['blank_w'], head['blank_b']
  outputs = []
  for t in range(max_t):
    joint = _rows_joint(pc, pf[t], batch)
    z = torch.logsumexp(rnd(joint) @ w + vb, dim=-1)
    ly = (joint * wy).sum(-1) + by
    blank = joint @ bw + bb
    if hat:
      nb, nl = logsigmoid(blank), ly - z + logsigmoid(-blank)
    else:
      za = torch.logaddexp(blank, z)
      nb, nl = blank - za, ly - za
    outputs.append((nb, nl, z, blank))
  if not outputs:
    empty = pc.new_zeros((0, pc.shape[0]))
    return empty, empty, empty, empty
  return tuple(torch.stack(x) for x in zip(*outputs))


def _chunk_frames(max_t, num_rows, hidden, vocab, compute_dtype):
  """Frames per chunk of the backward, so that the staged joint and ds
  ([chunk, R, h] and [chunk, R, V] in the compute type) fit _CHUNK_BYTES."""
  item = torch.finfo(compute_dtype).bits // 8
  per_frame = max(num_rows * (hidden + vocab) * item, 1)
  return max(1, min(max_t, _CHUNK_BYTES // per_frame))


def numerator_backward(pc: torch.Tensor, pf: torch.Tensor,
                       head: dict[str, Any], wy: torch.Tensor,
                       by: torch.Tensor, z: torch.Tensor, blank: torch.Tensor,
                       g_b: torch.Tensor, g_l: torch.Tensor, *, hat: bool,
                       compute_dtype: torch.dtype):
  """The forward's VJP: the kernel on CUDA, the plain version on CPU.

  Args:
    pc, pf, head, wy, by, hat, compute_dtype: as ``numerator_forward``.
    z, blank: [T, R] from ``numerator_forward``.
    g_b, g_l: [T, R] float32 cotangents of its nb and nl.

  Returns:
    (d_pc [R, h], d_pf [T, B, h], d_vocab_w [h, V], d_vocab_b [V],
    d_blank_w [h], d_blank_b [], d_wy [R, h], d_by [R]). Rows and frames
    whose cotangents are zero contribute exactly zero.
  """
  global backward_launches
  max_t, batch, u1, hidden, vocab = _check_inputs(pc, pf, head, wy, by,
                                                  compute_dtype)
  num_rows = batch * u1
  for name, x in (('z', z), ('blank', blank), ('g_b', g_b), ('g_l', g_l)):
    if tuple(x.shape) != (max_t, num_rows) or x.dtype != torch.float32:
      raise ValueError(f'{name} should be torch.float32 of shape '
                       f'{(max_t, num_rows)}, got {x.dtype} of shape '
                       f'{tuple(x.shape)}')
    if x.device != pc.device or not x.is_contiguous():
      raise ValueError(f'{name} must be contiguous on {pc.device}')
  kw = dict(hat=hat, compute_dtype=compute_dtype)
  if pc.device.type == 'cpu':
    return numerator_backward_plain(pc, pf, head, wy, by, z, blank, g_b, g_l,
                                    **kw)
  if pc.device.type != 'cuda':
    raise ValueError(f'no numerator kernel for device {pc.device}')
  device = pc.device
  empty = lambda *shape, dtype=torch.float32: torch.empty(
      shape, dtype=dtype, device=device)
  zeros = lambda *shape: torch.zeros(shape, device=device)
  strips = -(-vocab // _TILE)
  row_tiles = -(-num_rows // _TILE)
  h_tiles = -(-hidden // _TILE)
  utiles = -(-u1 // _TILE)
  chunk = _chunk_frames(max_t, num_rows, hidden, vocab, compute_dtype)
  splits = fused_scan.grid_splits(chunk * row_tiles, strips, device)
  ksplits = fused_scan.grid_splits(strips * h_tiles,
                                   -(-chunk * num_rows // _TILE), device)
  fsplits = fused_scan.grid_splits(h_tiles * batch * utiles, chunk, device)
  w = head['vocab_w'].to(compute_dtype).contiguous()
  jc = empty(chunk, num_rows, hidden, dtype=compute_dtype)
  ds = empty(chunk, num_rows, vocab, dtype=compute_dtype)
  dvb_part = empty(chunk, row_tiles, vocab)
  dpf_part = empty(utiles, chunk, batch, hidden)
  db_row = empty(num_rows)
  # Accumulators, each element owned by one block per launch.
  dw_acc = zeros(ksplits, hidden, vocab)
  dpc_acc = zeros(fsplits, num_rows, hidden)
  dwy_acc = zeros(fsplits, num_rows, hidden)
  dbw_acc = zeros(fsplits, batch * utiles, hidden)
  d_pf = empty(max_t, batch, hidden)
  d_pc, d_wy = empty(num_rows, hidden), empty(num_rows, hidden)
  d_w, d_vb, d_bw = empty(hidden, vocab), empty(vocab), empty(hidden)
  d_by, d_bb = empty(num_rows), empty(1)
  _launch(device, 'backward',
          lambda lib, stream: lib.numerator_backward(
              _DTYPE_CODES[compute_dtype], _ptr(pc), _ptr(pf), _ptr(w),
              _ptr(head['vocab_b']), _ptr(head['blank_w']),
              _ptr(head['blank_b']), _ptr(wy), _ptr(by), _ptr(z),
              _ptr(blank), _ptr(g_b), _ptr(g_l), _ptr(jc), _ptr(ds),
              _ptr(dvb_part), _ptr(dw_acc), _ptr(dpc_acc), _ptr(dwy_acc),
              _ptr(dbw_acc), _ptr(dpf_part), _ptr(db_row), _ptr(d_pf),
              _ptr(d_pc), _ptr(d_wy), _ptr(d_w), _ptr(d_vb), _ptr(d_bw),
              _ptr(d_by), _ptr(d_bb), max_t, batch, u1, hidden, vocab,
              int(hat), chunk, splits, ksplits, fsplits, stream))
  backward_launches += 1
  return d_pc, d_pf, d_w, d_vb, d_bw, d_bb[0], d_wy, d_by


def numerator_backward_plain(pc: torch.Tensor, pf: torch.Tensor,
                             head: dict[str, Any], wy: torch.Tensor,
                             by: torch.Tensor, z: torch.Tensor,
                             blank: torch.Tensor, g_b: torch.Tensor,
                             g_l: torch.Tensor, *, hat: bool,
                             compute_dtype: torch.dtype):
  """The backward kernel's function in plain PyTorch, frame by frame (same
  arguments and outputs).

  It rounds where the kernel does: the joint, ``vocab_w`` and ds for the
  two head-gradient products; the tanh derivative, the blank and label
  terms of d(joint), and d(vocab_b) use float32.
  """
  del by  # the bias enters the gradients only through its cotangent
  max_t, batch, hidden = pf.shape
  rnd = lambda x: x.to(compute_dtype).float()
  w, vb = rnd(head['vocab_w']), head['vocab_b']
  bw = head['blank_w']
  d_pf = torch.zeros_like(pf)
  d_pc, d_wy = torch.zeros_like(pc), torch.zeros_like(pc)
  d_w = torch.zeros_like(head['vocab_w'])
  d_vb = torch.zeros_like(vb)
  d_bw = torch.zeros_like(bw)
  d_bb = torch.zeros((), device=pc.device)
  for t in range(max_t):
    joint = _rows_joint(pc, pf[t], batch)
    joint_c = rnd(joint)
    logits = joint_c @ w + vb
    gb, gl = g_b[t], g_l[t]
    if hat:
      ds = -gl[:, None] * torch.exp(logits - z[t][:, None])
      sig = torch.sigmoid(blank[t])
      d_blank = gb * (1.0 - sig) - gl * sig
    else:
      za = torch.logaddexp(blank[t], z[t])
      ds = -(gb + gl)[:, None] * torch.exp(logits - za[:, None])
      d_blank = gb - (gb + gl) * torch.exp(blank[t] - za)
    ds_c = rnd(ds)
    d_joint = ds_c @ w.t() + gl[:, None] * wy + d_blank[:, None] * bw
    du = d_joint * (1.0 - joint * joint)
    d_pf[t] = du.view(batch, -1, hidden).sum(1)
    d_pc += du
    d_wy += gl[:, None] * joint
    d_w += joint_c.t() @ ds_c
    d_vb += ds.sum(0)
    d_bw += (d_blank[:, None] * joint).sum(0)
    d_bb += d_blank.sum()
  return d_pc, d_pf, d_w, d_vb, d_bw, d_bb, d_wy, g_l.sum(0)


@dataclasses.dataclass(frozen=True)
class _Config:
  hat: bool
  compute_dtype: torch.dtype
  forward: Callable
  backward: Callable


class _Numerator(torch.autograd.Function):
  """(nb, nl) with the backward kernel as their gradient (the custom VJP)."""

  @staticmethod
  def forward(ctx, pc, pf, vocab_w, vocab_b, blank_w, blank_b, wy, by,
              config):
    head = dict(zip(_HEAD, (vocab_w, vocab_b, blank_w, blank_b)))
    nb, nl, z, blank = config.forward(pc, pf, head, wy, by, hat=config.hat,
                                      compute_dtype=config.compute_dtype)
    ctx.config = config
    ctx.save_for_backward(pc, pf, vocab_w, vocab_b, blank_w, blank_b, wy, by,
                          z, blank)
    return nb, nl

  @staticmethod
  def backward(ctx, g_nb, g_nl):
    pc, pf, vocab_w, vocab_b, blank_w, blank_b, wy, by, z, blank = (
        ctx.saved_tensors)
    config = ctx.config
    cotangent = lambda g: (torch.zeros_like(z) if g is None else
                           g.float().contiguous())
    head = dict(zip(_HEAD, (vocab_w, vocab_b, blank_w, blank_b)))
    d_pc, d_pf, d_w, d_vb, d_bw, d_bb, d_wy, d_by = config.backward(
        pc, pf, head, wy, by, z, blank, cotangent(g_nb), cotangent(g_nl),
        hat=config.hat, compute_dtype=config.compute_dtype)
    return d_pc, d_pf, d_w, d_vb, d_bw, d_bb, d_wy, d_by, None


def stage(weight_fn, params: dict[str, Any], cache: torch.Tensor,
          frames: torch.Tensor, states: torch.Tensor,
          next_labels: torch.Tensor):
  """The prologue: (pc [R, h], pf [T, B, h], wy [R, h], by [R]) as the
  kernels take them, from a JointWeightFn's parameters, the cache, frames
  [B, T, F], states and next labels [B, U1] (label 0 reads column 0). The
  two projections round their inputs to the compute type, as the JAX
  package's prologue does."""
  batch, u1 = states.shape
  y = next_labels.long().clamp(min=1) - 1  # [B, U1]
  pf = weight_fn._mm(frames, params['frame_proj']).transpose(0, 1)
  pf = pf.contiguous()  # [T, B, h]
  pc = weight_fn._mm(cache, params['context_proj'])[states.long()]
  pc = pc.reshape(batch * u1, -1).contiguous()
  wy = params['vocab_w'].t()[y].reshape(batch * u1, -1).contiguous()
  by = params['vocab_b'][y].reshape(batch * u1).contiguous()
  return pc, pf, wy, by


def label_weights(weight_fn, params: dict[str, Any], cache: torch.Tensor,
                  frames: torch.Tensor, states: torch.Tensor,
                  next_labels: torch.Tensor, *, hat: bool,
                  forward: Callable = numerator_forward,
                  backward: Callable = numerator_backward):
  """``LocallyNormalizedWeightFn.label_weights`` through the kernels.

  ``forward`` / ``backward`` default to the kernels on CUDA tensors and
  the plain versions on CPU tensors; ``numerator_forward_plain`` /
  ``numerator_backward_plain`` run the plain versions on the card too.

  Leading batch dimensions of frames [batch_dims..., T, F] and of states
  and next labels [batch_dims..., U+1] are flattened into one for the
  kernels and restored on the outputs.

  Returns:
    (blank, lexical), each [batch_dims..., U+1, max_num_frames].
  """
  compute_dtype = weight_fn.compute_dtype or torch.float32
  batch_dims, (max_t, features) = frames.shape[:-2], frames.shape[-2:]
  u1 = states.shape[-1]
  if states.shape[:-1] != batch_dims or next_labels.shape != states.shape:
    raise ValueError(f'frames {tuple(frames.shape)}, states '
                     f'{tuple(states.shape)} and next_labels '
                     f'{tuple(next_labels.shape)} differ in batch dimensions')
  batch = batch_dims.numel()
  pc, pf, wy, by = stage(weight_fn, params, cache,
                         frames.reshape(batch, max_t, features),
                         states.reshape(batch, u1),
                         next_labels.reshape(batch, u1))
  config = _Config(hat, compute_dtype, forward, backward)
  nb, nl = _Numerator.apply(pc, pf, params['vocab_w'], params['vocab_b'],
                            params['blank_w'], params['blank_b'], wy, by,
                            config)
  # [T, B * U1] -> [batch_dims..., U1, T]
  to_batch_major = lambda x: x.view(max_t, batch, u1).permute(
      1, 2, 0).reshape(batch_dims + (u1, max_t))
  return to_batch_major(nb), to_batch_major(nl)
