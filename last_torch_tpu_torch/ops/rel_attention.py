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

"""Relative-position self-attention (Transformer-XL scores) for the
Conformer encoder: a Hopper kernel and its plain version.

Replaces no TPU kernel: the JAX package has no Conformer with relative
positions. For batch row b, head h, query i and key j < lengths[b]:

  s[i, j] = ((q[i] + u) . k[j] + (q[i] + v) . pos[T - 1 - i + j]) / sqrt(hd)

softmaxed over j, and out[i] = sum_j w[i, j] v[j] for i < lengths[b], 0 past
it. ``pos`` ([2T - 1, H * hd]) holds the projected encodings of the
relative positions T - 1 down to -(T - 1), ESPnet's order. On a CUDA tensor
outside autograd ``rel_attention`` launches ``csrc/rel_attention.cu``
(float32 on the CUDA cores, head size 64, a flash-style walk over key tiles
that never writes a [B, H, T, T] or [B, H, T, 2T - 1] buffer); on a CPU
tensor, or where a gradient is wanted, it runs ``rel_attention_plain``.
"""

from __future__ import annotations

import ctypes
import math

import torch

# Forward calls that launched the CUDA kernel, for runs that must show the
# encoder went through it.
launches = 0

_LIB = None
_HEAD_DIM = 64
# The additive key mask of the port's encoders (models/encoder.py).
_MASKED = -1e9


def rel_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  pos: torch.Tensor, pos_bias_u: torch.Tensor,
                  pos_bias_v: torch.Tensor,
                  lengths: torch.Tensor) -> torch.Tensor:
  """Relative-position attention; returns [B, T, H, hd] float32.

  Args:
    q, k, v: [B, T, H, hd] float32 (head-split views of one projection are
      taken as they are).
    pos: [2T - 1, H * hd] projected relative position encodings.
    pos_bias_u, pos_bias_v: [H, hd] the content and position biases.
    lengths: [B] each row's real frames (keys at or past it are masked,
      outputs at or past it are 0).
  """
  grad = torch.is_grad_enabled() and any(
      x.requires_grad for x in (q, k, v, pos, pos_bias_u, pos_bias_v))
  if q.device.type != 'cuda' or grad:
    return rel_attention_plain(q, k, v, pos, pos_bias_u, pos_bias_v, lengths)
  return _launch(q, k, v, pos, pos_bias_u, pos_bias_v, lengths)


def rel_attention_plain(q, k, v, pos, pos_bias_u, pos_bias_v, lengths):
  """``rel_attention`` in plain PyTorch: the position scores of every query
  at every distance, [B, H, T, 2T - 1], gathered at T - 1 - i + j."""
  b, t, h, hd = q.shape
  qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))  # [B, H, T, hd]
  content = (qh + pos_bias_u[:, None]) @ kh.transpose(-1, -2)
  ph = pos.reshape(2 * t - 1, h, hd).permute(1, 2, 0)  # [H, hd, 2T - 1]
  by_distance = (qh + pos_bias_v[:, None]) @ ph  # [B, H, T, 2T - 1]
  steps = torch.arange(t, device=q.device)
  index = (t - 1) - steps[:, None] + steps[None, :]
  position = by_distance.gather(-1, index.expand(b, h, t, t))
  live = steps[None, :] < lengths[:, None]  # [B, T]
  key_bias = torch.where(live, 0.0, _MASKED)[:, None, None, :]
  scores = (content + position) / math.sqrt(hd) + key_bias
  out = (torch.softmax(scores, dim=-1) @ vh).transpose(1, 2)
  return torch.where(live[:, :, None, None], out, 0.0)


def _strides_fit(x: torch.Tensor) -> bool:
  """Rows of 16-byte aligned, contiguous heads the kernel can read."""
  return (x.stride(3) == 1 and x.stride(2) == x.shape[3] and
          x.stride(1) % 4 == 0 and x.stride(0) % 4 == 0 and
          x.data_ptr() % 16 == 0)


def _launch(q, k, v, pos, pos_bias_u, pos_bias_v, lengths):
  global launches
  b, t, h, hd = q.shape
  if hd != _HEAD_DIM:
    raise ValueError(f'the rel_attention kernel takes head size {_HEAD_DIM}, '
                     f'not {hd}')
  for name, x in (('q', q), ('k', k), ('v', v), ('pos', pos),
                  ('pos_bias_u', pos_bias_u), ('pos_bias_v', pos_bias_v)):
    if x.dtype != torch.float32:
      raise ValueError(f'rel_attention: {name} is {x.dtype}, not float32')
  if k.shape != q.shape or v.shape != q.shape:
    raise ValueError(f'rel_attention: q {tuple(q.shape)}, k '
                     f'{tuple(k.shape)} and v {tuple(v.shape)} differ')
  if tuple(pos.shape) != (2 * t - 1, h * hd):
    raise ValueError(f'rel_attention: pos is {tuple(pos.shape)}, not '
                     f'{(2 * t - 1, h * hd)}')
  if not (all(_strides_fit(x) for x in (q, k, v)) and
          q.stride() == k.stride() == v.stride()):
    q, k, v = (x.contiguous() for x in (q, k, v))
  pos = pos.contiguous()
  bias_u = pos_bias_u.contiguous()
  bias_v = pos_bias_v.contiguous()
  lengths = lengths.to(torch.int32).clamp(0, t)
  out = torch.empty((b, t, h, hd), device=q.device)
  lib = library()
  with torch.cuda.device(q.device):
    stream = torch.cuda.current_stream(q.device).cuda_stream
    status = lib.rel_attention_forward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), q.stride(0), q.stride(1),
        pos.data_ptr(), bias_u.data_ptr(), bias_v.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), b, t, h, hd,
        1.0 / math.sqrt(hd), stream)
  if status != 0:
    raise RuntimeError('rel_attention kernel launch failed: '
                       f'{lib.rel_attention_error_string(status).decode()}')
  launches += 1
  return out


def library() -> ctypes.CDLL:
  """The kernel library, built from csrc/rel_attention.cu at first use."""
  global _LIB
  if _LIB is None:
    from last_torch_tpu_torch.ops import build
    lib = build.load('rel_attention.cu')
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.rel_attention_forward.argtypes = ([p] * 3 + [ll, ll] + [p] * 5 +
                                          [i] * 4 + [ctypes.c_float, p])
    lib.rel_attention_forward.restype = i
    lib.rel_attention_error_string.argtypes = [i]
    lib.rel_attention_error_string.restype = ctypes.c_char_p
    _LIB = lib
  return _LIB
