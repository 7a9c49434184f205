"""Plain PyTorch reference of the Conformer GNAT model the benchmark decodes
with: Conformer (L)'s encoder in front of the GN bigram lattice.

It imports torch, math and the benchmark's lattice reference
(``reference/gnat.py``) alone: nothing of the program under test and
nothing of the JAX package. The encoder is a frozen copy of the test
suite's ``tests/reference/conformer.py``: the straightforward dense
forward of Gulati et al., arXiv:2005.08100, with ESPnet's formulation where
the paper leaves a part open (its docstring lists each departure):
``conv2d`` subsampling by 4, macaron blocks with Transformer-XL
relative-position attention (position scores over all 2T' - 1 distances,
ESPnet's ``rel_shift``, an additive -1e9 key mask), a depthwise
``conv1d(groups=d)`` padded 'same' over the frames zeroed past a row's
length, inference ``batch_norm``, Swish. Linear layers and convolutions
carry no bias; layer norm eps 1e-6; no input scaling, no dropout.

The lattice's projections, Viterbi and rescoring are ``reference/gnat.py``'s,
unchanged, over the encoder's T' = ((T - 1) // 2 - 1) // 2 frames. The
encoder runs in float32 with TF32 off, or in TF32 for the control
(``tf32=True``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference import gnat as lattice_reference

MASKED = -1e9


def check_config(config: dict):
  """Raises for a configuration outside what this reference decodes."""
  wanted = {'encoder_kind': 'conformer', 'context_size': 1,
            'use_rnn_cacher': False, 'encoder_causal': False,
            'encoder_window': 0}
  for key, value in wanted.items():
    if config.get(key, value) != value:
      raise ValueError(f'the reference computes {key}={value!r}, not '
                       f'{config[key]!r}')
  if config['max_expansions'] < 1:
    raise ValueError('the reference computes FrameLabelDependent(k >= 1)')


def output_frames(num_frames: torch.Tensor) -> torch.Tensor:
  """Frames left by the two stride-2 3 x 3 convolutions (at least 0)."""
  return (((num_frames - 1) // 2 - 1) // 2).clamp(min=0)


# ---------------------------------------------------------------- encoder


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
def encode(params, frames, num_frames, num_heads: int,
           tf32: bool = False) -> torch.Tensor:
  """[B, T, F] frames to [B, output_frames(T), d] encodings, matmuls and
  convolutions in full float32 (or TF32 with ``tf32``)."""
  with lattice_reference.tf32(tf32):
    x = subsample(params['subsample'], frames)
    t, d = x.shape[1], x.shape[2]
    mask = (torch.arange(t, device=x.device)[None, :] <
            output_frames(num_frames)[:, None])
    key_bias = torch.where(mask, 0.0, MASKED)[:, None, None, :]
    positions = relative_positions(t, d, x.device)
    for layer in params['layers']:
      x = block(layer, x, mask, positions, key_bias, num_heads)
    return torch.where(mask[..., None], x, 0.0)


# ---------------------------------------------------------------- decode


def decode(config, params, frames, num_frames, head_dtype, labels=None,
           tf32: bool = False, with_path: bool = False):
  """(best path weight [B], its alignment or None, the given alignments
  rescored in float64 or None) of the model on [B, T, F] frames: the
  encoder (``tf32`` for the control), then ``reference/gnat.py``'s
  projections, Viterbi (heads in ``head_dtype``) and rescoring over the
  encoder's frames. Rescoring and the lattice run in full float32."""
  check_config(config)
  k = config['max_expansions']
  normalize = 'hat' if config['locally_normalized'] else 'none'
  encoded = encode(params['encoder'], frames, num_frames,
                   config['encoder_heads'], tf32=tf32)
  lengths = output_frames(num_frames)
  with torch.no_grad(), lattice_reference.tf32(False):
    pc, pf = lattice_reference.projections(params['lattice'], encoded)
    wf = params['lattice']['weight_fn']
    best, path = lattice_reference.viterbi(wf, pc, pf, lengths, k,
                                           head_dtype, normalize,
                                           with_path=with_path)
    rescored = None
    if labels is not None:
      rescored = lattice_reference.rescore(wf, pc, pf, lengths, labels, k,
                                           head_dtype, normalize)
  return best, path, rescored
