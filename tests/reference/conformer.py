"""Plain PyTorch reference of the Conformer (L) encoder's forward.

It imports torch and math alone: nothing of the port and nothing of JAX.
Its functions run with TF32 off for matmuls and cuDNN (``full_float32``).
It takes the parameter dictionary laid out as the port's
``ConformerEncoder`` (``subsample``: ``conv1`` [d, 1, 3, 3], ``conv2`` [d,
d, 3, 3], ``proj`` [d F', d]; ``layers``: one dictionary a block) and
computes the forward the straightforward dense way.

Conformer (L) after Gulati et al., arXiv:2005.08100 (Table 1: 17 blocks,
width 512, 8 heads, convolution kernel 32, feed-forward 2048), with ESPnet's
formulation of the parts the paper leaves open:

- front end: ``conv2d`` 1 -> d, 3 x 3, stride 2, ReLU, ``conv2d`` d -> d, 3
  x 3, stride 2, ReLU, flattened (channel-major) to d F', then a linear map
  to d (ESPnet's ``Conv2dSubsampling``; the paper names a convolution
  subsampling layer without its channels);
- block: x + FFN/2, x + MHSA, x + Conv, x + FFN/2, LayerNorm; FFN: LN,
  linear d -> 4d, Swish, linear 4d -> d;
- MHSA: LN, q / k / v, the sinusoids of the distances T' - 1 .. -(T' - 1)
  (sin and cos interleaved) projected per layer, scores ``((q + u) k^T +
  rel_shift((q + v) p^T)) / sqrt(hd)`` with ESPnet's ``rel_shift`` (pad a
  zero column, view, drop the first row, keep T' columns), an additive -1e9
  mask on keys past a row's length, softmax;
- Conv: LN, linear d -> 2d, GLU, frames past a row's length zeroed,
  ``conv1d(groups=d)`` of width K with padding 'same' (K // 2 - 1 frames
  before and K // 2 after for the even K = 32, as PyTorch places them),
  inference ``batch_norm`` (eps 1e-5), Swish, linear d -> d.

Departures from the paper: no biases on the linear layers and
convolutions; layer norm eps 1e-6 (the port's, JAX's default); no input
scaling by sqrt(d) and no dropout (inference); no final LayerNorm after the
last block beyond the block's own; outputs past a row's length are 0.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

MASKED = -1e9


@contextlib.contextmanager
def full_float32():
  """Matmuls and cuDNN convolutions without TF32, restored after."""
  before = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  try:
    yield
  finally:
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = before


def output_frames(num_frames: torch.Tensor) -> torch.Tensor:
  """Frames left by the two stride-2 3 x 3 convolutions (at least 0)."""
  return (((num_frames - 1) // 2 - 1) // 2).clamp(min=0)


def layer_norm(x, scale, bias, eps=1e-6):
  mean = x.mean(dim=-1, keepdim=True)
  var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
  return (x - mean) / torch.sqrt(var + eps) * scale + bias


def relative_positions(length: int, dim: int, device) -> torch.Tensor:
  """[2 length - 1, dim] sinusoids of the positions length - 1 down to
  -(length - 1), sin and cos interleaved."""
  pos = torch.arange(length - 1, -length, -1, device=device,
                     dtype=torch.float32)[:, None]
  div = torch.exp(torch.arange(0, dim, 2, device=device, dtype=torch.float32)
                  * (-math.log(10000.0) / dim))
  pe = torch.zeros((2 * length - 1, dim), device=device)
  pe[:, 0::2] = torch.sin(pos * div)
  pe[:, 1::2] = torch.cos(pos * div)
  return pe


def rel_shift(x: torch.Tensor) -> torch.Tensor:
  """ESPnet's shift of position scores [B, H, T, 2T - 1] (distance T - 1 -
  m in column m) to [B, H, T, T] (distance i - j at [i, j])."""
  b, h, t, n = x.shape
  padded = torch.cat([x.new_zeros((b, h, t, 1)), x], dim=-1)
  padded = padded.view(b, h, n + 1, t)
  return padded[:, :, 1:].reshape(b, h, t, n)[..., :n // 2 + 1]


def subsample(params, frames):
  x = F.relu(F.conv2d(frames[:, None], params['conv1'], stride=2))
  x = F.relu(F.conv2d(x, params['conv2'], stride=2))
  b, c, t, f = x.shape
  return x.transpose(1, 2).reshape(b, t, c * f) @ params['proj']


def feed_forward(layer, name, x):
  y = layer_norm(x, layer[f'{name}_ln_scale'], layer[f'{name}_ln_bias'])
  return F.silu(y @ layer[f'{name}_in']) @ layer[f'{name}_out']


def attention(layer, x, positions, key_bias, num_heads):
  b, t, d = x.shape
  hd = d // num_heads
  y = layer_norm(x, layer['attn_ln_scale'], layer['attn_ln_bias'])
  q, k, v = (z.reshape(b, t, num_heads, hd).transpose(1, 2)
             for z in (y @ layer['qkv']).split(d, dim=-1))
  p = (positions @ layer['pos_proj']).reshape(-1, num_heads, hd)
  p = p.transpose(0, 1)  # [H, 2T - 1, hd]
  u = layer['pos_bias_u'][None, :, None]
  vb = layer['pos_bias_v'][None, :, None]
  content = (q + u) @ k.transpose(-1, -2)
  position = rel_shift((q + vb) @ p.transpose(-1, -2)[None])
  scores = (content + position) / math.sqrt(hd) + key_bias
  context = torch.softmax(scores, dim=-1) @ v
  return context.transpose(1, 2).reshape(b, t, d) @ layer['attn_out']


def convolution(layer, x, mask):
  d = x.shape[-1]
  y = layer_norm(x, layer['conv_ln_scale'], layer['conv_ln_bias'])
  u = F.glu(y @ layer['conv_in'], dim=-1)
  u = torch.where(mask[..., None], u, 0.0).transpose(1, 2)
  weight = layer['conv_depth'].t()[:, None, :]  # [d, 1, K]
  c = F.conv1d(u, weight, padding='same', groups=d)
  c = F.batch_norm(c, layer['bn_mean'], layer['bn_var'], layer['bn_scale'],
                   layer['bn_bias'], training=False, eps=1e-5)
  return F.silu(c).transpose(1, 2) @ layer['conv_out']


def block(layer, x, mask, positions, key_bias, num_heads):
  x = x + 0.5 * feed_forward(layer, 'ffn1', x)
  x = x + attention(layer, x, positions, key_bias, num_heads)
  x = x + convolution(layer, x, mask)
  x = x + 0.5 * feed_forward(layer, 'ffn2', x)
  return layer_norm(x, layer['final_ln_scale'], layer['final_ln_bias'])


@torch.no_grad()
def encode(params, frames, num_frames, num_heads: int) -> torch.Tensor:
  """[B, T, F] frames to [B, output_frames(T), d] encodings."""
  with full_float32():
    x = subsample(params['subsample'], frames)
    t, d = x.shape[1], x.shape[2]
    mask = (torch.arange(t, device=x.device)[None, :] <
            output_frames(num_frames)[:, None])
    key_bias = torch.where(mask, 0.0, MASKED)[:, None, None, :]
    positions = relative_positions(t, d, x.device)
    for layer in params['layers']:
      x = block(layer, x, mask, positions, key_bias, num_heads)
    return torch.where(mask[..., None], x, 0.0)
