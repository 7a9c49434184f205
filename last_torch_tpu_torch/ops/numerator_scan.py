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
and the hidden size has no limit: both directions stage 64-deep slices of
a joint of any width.

Both walk (frame, 64-row tile) items in chunks of frames whose staging
fits ``_CHUNK_BYTES``, with their scratch in one workspace: the forward
every item (it has no lengths; ``forward_plan``, ``forward_scratch``), the
backward the live ones alone, those whose rows hold a nonzero cotangent
(``live_tiles``), listed on the device so that the host never waits
(``backward_plan``, ``backward_scratch``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from collections.abc import Callable
import math
from typing import Any, Optional

import torch
from torch.nn.functional import logsigmoid

from last_torch_tpu_torch.ops import joint_head

# Calls that launched the CUDA forward / backward kernels, for runs that must
# show the numerator went through them. Only CUDA tensors count.
forward_launches = 0
backward_launches = 0

_LIB = None
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# The kernels' tiles (csrc/numerator_scan.cu: 64 rows, 64 labels or hidden
# units; the padding of the operands), and the device memory either
# direction may spend on what it stages for a chunk of frames.
_TILE = 64
_CHUNK_BYTES = 512 * 2**20
# The products (csrc/numerator_scan.cu): label strips of the forward's
# product and of the backward's ds product, hidden strips of its d_joint
# product (wgmma 128, float32 256), and the blocks an SM holds.
_STRIPS = {torch.bfloat16: 128, torch.float32: 256}
_BLOCKS_PER_SM = 2
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
    lib.numerator_forward.argtypes = [i] + [p] * 14 + [i] * 8 + [p] * 3
    lib.numerator_forward.restype = i
    lib.numerator_backward.argtypes = [i] + [p] * 33 + [i] * 11 + [p]
    lib.numerator_backward.restype = i
    lib.numerator_live_tiles.argtypes = [p] * 6 + [i] * 3 + [p]
    lib.numerator_live_tiles.restype = i
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
  device = pc.device
  empty = lambda *shape: torch.empty(shape, device=device)
  if max_t == 0:  # no frames: nothing to launch
    return tuple(empty(0, num_rows) for _ in range(4))
  if hidden == 0 or vocab == 0:
    raise ValueError('the numerator forward kernel needs hidden and vocab '
                     f'sizes >= 1, got {hidden} and {vocab}')
  plan = forward_plan(max_t, batch, u1, hidden, vocab, compute_dtype,
                      joint_head.sm_count(device))
  # The scratch in one buffer (``forward_scratch``).
  workspace = torch.empty(plan.size, dtype=torch.uint8, device=device)
  at = lambda name: workspace.data_ptr() + plan.offsets[name]
  nb, nl, z, blank = (empty(max_t, num_rows) for _ in range(4))
  _launch(device, 'forward',
          lambda lib, stream: lib.numerator_forward(
              _DTYPE_CODES[compute_dtype], _ptr(pc), _ptr(pf),
              _ptr(head['vocab_w']), _ptr(head['vocab_b']),
              _ptr(head['blank_w']), _ptr(head['blank_b']), _ptr(wy),
              _ptr(by), at('part_m'), at('part_l'), _ptr(nb), _ptr(nl),
              _ptr(z), _ptr(blank), max_t, batch, u1, hidden, vocab,
              int(hat), plan.chunk, plan.blocks, at('wp'), at('joint'),
              stream))
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


def rows_per_tile(batch: int, u1: int) -> int:
  """J: the most batch rows that one 64-row tile of the flattened [B * U1]
  rows holds (the backward's d_pf partials per tile)."""
  rows = batch * u1
  return max(((min(rows, k + _TILE) - 1) // u1 - k // u1 + 1
              for k in range(0, rows, _TILE)), default=1)


def forward_scratch(batch: int, u1: int, hidden: int, vocab: int,
                    compute_dtype: torch.dtype, chunk: int) -> dict:
  """name -> (shape, dtype) of the forward's scratch (``numerator_forward``
  in ``csrc/numerator_scan.cu``): the padded head and a chunk's joint in the
  compute type (every (frame, row tile) of ``chunk`` frames), and the
  float32 (max, sum) partials of each row per label strip (128 labels in
  bfloat16, 256 in float32). No logits [T, R, V] are held."""
  rows = batch * u1
  r64 = -(-rows // _TILE)
  hp = -(-hidden // _TILE) * _TILE
  vp = -(-vocab // _TILE) * _TILE
  part = ((-(-vp // _STRIPS[compute_dtype]), chunk * rows), torch.float32)
  return {'wp': ((hp, vp), compute_dtype),
          'joint': ((chunk * r64, _TILE, hp), compute_dtype),
          'part_m': part, 'part_l': part}


@dataclasses.dataclass(frozen=True)
class ForwardPlan:
  """The forward's chunks, grid and workspace (``forward_plan``).

  Attributes:
    chunk: frames a chunk: its joint and partials (``forward_scratch``)
      fit _CHUNK_BYTES.
    blocks: the head product's persistent blocks per label strip.
    offsets: name -> byte offset of each scratch buffer in the workspace.
    size: the workspace's bytes.
  """
  chunk: int
  blocks: int
  offsets: dict
  size: int


@functools.lru_cache(maxsize=64)
def forward_plan(max_t: int, batch: int, u1: int, hidden: int, vocab: int,
                 compute_dtype: torch.dtype, sms: int) -> ForwardPlan:
  """The ``ForwardPlan`` on ``sms`` SMs: the product's grid one wave of two
  blocks an SM."""
  per_frame = sum(
      math.prod(shape) * torch.empty((), dtype=dtype).element_size()
      for name, (shape, dtype) in forward_scratch(
          batch, u1, hidden, vocab, compute_dtype, 1).items()
      if name != 'wp')
  chunk = max(1, min(max_t, _CHUNK_BYTES // per_frame))
  vp = -(-vocab // _TILE) * _TILE
  blocks = max(1, _BLOCKS_PER_SM * sms // -(-vp // _STRIPS[compute_dtype]))
  scratch = forward_scratch(batch, u1, hidden, vocab, compute_dtype, chunk)
  return ForwardPlan(chunk, blocks, *joint_head.layout(scratch))


def backward_scratch(max_t: int, batch: int, u1: int, hidden: int,
                     vocab: int, compute_dtype: torch.dtype, chunk: int,
                     blocks: int, jgrid: int, ksplits: int) -> dict:
  """name -> (shape, dtype) of the backward's scratch (``numerator_backward``
  in ``csrc/numerator_scan.cu``): the live list (int32), the padded head and
  a chunk's staged joint and ds in the compute type (every (frame, row tile)
  of ``chunk`` frames live; bfloat16 adds the float32 joint for the tanh
  derivative, float32 the du of the chunk's items), and the float32
  partials of the cross-frame sums (``jgrid`` of d_pc in bfloat16, whose
  d_joint blocks keep it in registers; one in float32)."""
  rows = batch * u1
  r64 = -(-rows // _TILE)
  hp = -(-hidden // _TILE) * _TILE
  vp = -(-vocab // _TILE) * _TILE
  chunks = -(-max_t // chunk)
  cap = chunk * r64
  i32, f32 = torch.int32, torch.float32
  scratch = {
      'pos_of': ((max_t, r64), i32), 'items': ((max_t * r64,), i32),
      'groups': ((chunks * r64 + 1,), i32), 'count': ((chunks,), i32),
      'wp': ((hp, vp), compute_dtype),
      'joint': ((cap, _TILE, hp), compute_dtype),
      'joint32': ((cap, _TILE, hidden), f32),
      'ds': ((cap, _TILE, vp), compute_dtype),
      'du': ((cap, _TILE, hidden), f32),
      'dpf_part': ((cap, rows_per_tile(batch, u1), hidden), f32),
      'dvb_part': ((blocks, vocab), f32), 'dbw_part': ((r64, hidden), f32),
      'dpc_part': ((jgrid if compute_dtype == torch.bfloat16 else 1, rows,
                    hidden), f32),
      'dw_part': ((ksplits, hidden, vocab), f32), 'db_row': ((rows,), f32),
  }
  # float32 stages du, and its staged joint is float32 already.
  del scratch['joint32' if compute_dtype == torch.float32 else 'du']
  return scratch


@dataclasses.dataclass(frozen=True)
class BackwardPlan:
  """The backward's chunks, grids and workspace (``backward_plan``).

  Attributes:
    chunk: frames a chunk: its staging (``backward_scratch`` with every
      (frame, row tile) live) fits _CHUNK_BYTES.
    blocks: the ds product's blocks per label strip (a persistent grid
      over the chunk's live items).
    jgrid: bfloat16: the d_joint product's splits of each row tile's
      items (its blocks keep d_pc in registers); float32: its persistent
      blocks per hidden strip (each item's du is stored, then summed).
    ksplits: the d_W product's splits of the chunk's items.
    rows_per_tile: J, the most batch rows a 64-row tile holds.
    offsets: name -> byte offset of each scratch buffer in the workspace.
    size: the workspace's bytes.
  """
  chunk: int
  blocks: int
  jgrid: int
  ksplits: int
  rows_per_tile: int
  offsets: dict
  size: int


@functools.lru_cache(maxsize=64)
def backward_plan(max_t: int, batch: int, u1: int, hidden: int, vocab: int,
                  compute_dtype: torch.dtype, sms: int) -> BackwardPlan:
  """The ``BackwardPlan`` on ``sms`` SMs: each product's grid about one
  wave of two blocks an SM."""
  cdiv = lambda n, m: -(-n // m)
  r64 = cdiv(batch * u1, _TILE)
  hp, vp = cdiv(hidden, _TILE) * _TILE, cdiv(vocab, _TILE) * _TILE
  strip = _STRIPS[compute_dtype]
  wave = _BLOCKS_PER_SM * sms
  per_frame = sum(
      math.prod(shape) * torch.empty((), dtype=dtype).element_size()
      for name, (shape, dtype) in backward_scratch(
          1, batch, u1, hidden, vocab, compute_dtype, 1, 1, 1, 1).items()
      if name in ('joint', 'joint32', 'ds', 'du', 'dpf_part'))
  chunk = max(1, min(max_t, _CHUNK_BYTES // per_frame))
  blocks = max(1, wave // cdiv(vp, strip))
  if compute_dtype == torch.bfloat16:
    jgrid = max(1, min(chunk, cdiv(wave, r64 * cdiv(hp, strip))))
  else:
    jgrid = max(1, wave // cdiv(hp, strip))
  ksplits = max(1, cdiv(wave, hp // _TILE * cdiv(vp, strip)))
  scratch = backward_scratch(max_t, batch, u1, hidden, vocab, compute_dtype,
                             chunk, blocks, jgrid, ksplits)
  return BackwardPlan(chunk, blocks, jgrid, ksplits,
                      rows_per_tile(batch, u1), *joint_head.layout(scratch))


def live_tiles(g_b: torch.Tensor, g_l: torch.Tensor, chunk: int):
  """The backward's live list: the (frame t, 64-row tile k) items whose
  rows hold a nonzero g_b or g_l at t, on CUDA through the backward's own
  kernels, on CPU in plain PyTorch.

  Args:
    g_b, g_l: [T, R] float32 cotangents.
    chunk: frames a chunk.

  Returns:
    (items, groups, count, pos_of), int32: items [T * R64] (R64 = ceil(R /
    64)) holds t * R64 + k of each item in the order (chunk of frames,
    tile, frame), its first count.sum() entries meaningful; groups
    [chunks * R64 + 1] the first position of each (chunk, tile) and the
    total last; count [chunks] each chunk's items; pos_of [T, R64] each
    pair's position, -1 where dead.
  """
  max_t, rows = g_b.shape
  if g_b.device.type == 'cpu':
    return live_tiles_plain(g_b, g_l, chunk)
  r64 = -(-rows // _TILE)
  chunks = -(-max_t // chunk)
  empty = lambda *shape: torch.empty(shape, dtype=torch.int32,
                                     device=g_b.device)
  pos_of, items = empty(max_t, r64), empty(max_t * r64)
  groups, count = empty(chunks * r64 + 1), empty(chunks)
  _launch(g_b.device, 'live list', lambda lib, stream:
          lib.numerator_live_tiles(_ptr(g_b), _ptr(g_l), _ptr(pos_of),
                                   _ptr(items), _ptr(groups), _ptr(count),
                                   max_t, rows, chunk, stream))
  return items, groups, count, pos_of


def live_tiles_plain(g_b: torch.Tensor, g_l: torch.Tensor, chunk: int):
  """``live_tiles`` in plain PyTorch (items past the count are 0)."""
  max_t, rows = g_b.shape
  r64 = -(-rows // _TILE)
  nonzero = torch.nn.functional.pad((g_b != 0) | (g_l != 0),
                                    (0, r64 * _TILE - rows))
  live = nonzero.view(max_t, r64, _TILE).any(-1)  # [T, R64]
  t = torch.arange(max_t)[:, None].expand(max_t, r64)
  k = torch.arange(r64)[None, :].expand(max_t, r64)
  # The list's order: chunk of frames, tile, frame.
  key = ((t // chunk) * r64 + k) * chunk + t % chunk
  flat = key.reshape(-1).argsort()
  live_flat = live.reshape(-1)[flat]
  positions = torch.cumsum(live_flat.int(), 0) - live_flat.int()
  pos_of = torch.full((max_t * r64,), -1, dtype=torch.int32)
  pos_of[flat[live_flat]] = positions[live_flat].int()
  items = torch.zeros(max_t * r64, dtype=torch.int32)
  items[positions[live_flat]] = flat[live_flat].int()
  # groups: the position of each (chunk, tile)'s first pair.
  group_of = (t // chunk * r64 + k).reshape(-1)[flat]
  chunks = -(-max_t // chunk)
  starts = torch.zeros(chunks * r64 + 1, dtype=torch.int32)
  first = torch.ones_like(group_of, dtype=torch.bool)
  first[1:] = group_of[1:] != group_of[:-1]
  starts[group_of[first]] = positions[first].int()
  starts[-1] = int(live.sum())
  count = starts[r64::r64] - starts[:-1:r64]
  return items, starts, count, pos_of.view(max_t, r64)


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
  if hidden == 0 or vocab == 0:
    raise ValueError('the numerator backward kernel needs hidden and vocab '
                     f'sizes >= 1, got {hidden} and {vocab}')
  device = pc.device
  plan = backward_plan(max_t, batch, u1, hidden, vocab, compute_dtype,
                       joint_head.sm_count(device))
  # The scratch in one buffer (``backward_scratch``).
  workspace = torch.empty(plan.size, dtype=torch.uint8, device=device)
  scratch = [workspace.data_ptr() + plan.offsets[name]
             if name in plan.offsets else None for name in _SCRATCH]
  empty = lambda *shape: torch.empty(shape, device=device)
  grads = (empty(max_t, batch, hidden), empty(num_rows, hidden),
           empty(num_rows, hidden), empty(hidden, vocab), empty(vocab),
           empty(hidden), empty(num_rows), empty(1))
  _launch(device, 'backward',
          lambda lib, stream: lib.numerator_backward(
              _DTYPE_CODES[compute_dtype], _ptr(pc), _ptr(pf),
              _ptr(head['vocab_w']), _ptr(head['vocab_b']),
              _ptr(head['blank_w']), _ptr(wy), _ptr(z), _ptr(blank),
              _ptr(g_b), _ptr(g_l), *scratch, *(_ptr(g) for g in grads),
              max_t, batch, u1, hidden, vocab, int(hat), plan.chunk,
              plan.blocks, plan.jgrid, plan.ksplits, plan.rows_per_tile,
              stream))
  backward_launches += 1
  d_pf, d_pc, d_wy, d_w, d_vb, d_bw, d_by, d_bb = grads
  return d_pc, d_pf, d_w, d_vb, d_bw, d_bb[0], d_wy, d_by


# The order of the scratch pointers numerator_backward takes.
_SCRATCH = ('pos_of', 'items', 'groups', 'count', 'wp', 'joint', 'joint32',
            'ds', 'du', 'dpf_part', 'dvb_part', 'dbw_part', 'dpc_part',
            'dw_part', 'db_row')


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
