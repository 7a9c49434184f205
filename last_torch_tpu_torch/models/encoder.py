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

"""Speech encoder for the GNAT model family, PyTorch port.

Counterpart of ``last_torch_tpu/models/encoder.py``: the pre-LN Transformer
(and Conformer) encoder over padded frame sequences, with parameters as a
dictionary laid out as the JAX pytree. Attention is plain matmul + softmax
over dense [T, T] logits, as the JAX package writes it. The banded
causal-window attention and ``StreamingEncoder`` are still to port
(ROADMAP queue 1, item 9).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch
import torch.nn.functional as F

from last_torch_tpu_torch import initializers

Params = dict[str, Any]

# The additive mask value of the JAX encoder: -1e9, not -inf, so a row with
# no visible key still softmaxes to finite weights.
_MASKED = -1e9


def _layer_norm(x, scale, bias, eps=1e-6):
  mean = x.mean(dim=-1, keepdim=True)
  var = x.var(dim=-1, keepdim=True, correction=0)
  return (x - mean) * torch.rsqrt(var + eps) * scale + bias


def _gelu(x):
  return F.gelu(x, approximate='tanh')  # jax.nn.gelu's default


@dataclasses.dataclass(frozen=True)
class TransformerEncoder:
  """Pre-LN Transformer encoder over padded frame sequences.

  Attributes:
    feature_size: Input feature dimension.
    model_size: Transformer width.
    num_layers: Number of blocks.
    num_heads: Attention heads (model_size % num_heads == 0).
    ffn_size: Feed-forward hidden width.
    dtype: Compute dtype for activations; parameters stay float32.
    causal: Causal attention.
    window: With causal, the left-context limit in frames (0 = unlimited).
    conv_kernel: If > 0, Conformer blocks with a causal depthwise
      convolution of this width; 0 = plain Transformer blocks.
    banded_attention: The JAX encoder's blocked causal-window attention.
      None (auto) computes the same masks densely here; True is not ported.
  """

  feature_size: int
  model_size: int = 256
  num_layers: int = 4
  num_heads: int = 4
  ffn_size: int = 1024
  dtype: torch.dtype = torch.float32
  causal: bool = False
  window: int = 0
  conv_kernel: int = 0
  banded_attention: Optional[bool] = None

  def init(self, generator: torch.Generator, device='cuda') -> Params:
    """Random parameters on ``device``: the card unless the caller asks for
    'cpu'."""
    d = self.model_size

    def dense(shape):
      return initializers.lecun_normal(shape, generator, device)

    ones = lambda: torch.ones((d,), device=device)
    zeros = lambda: torch.zeros((d,), device=device)
    params = {'input_proj': dense((self.feature_size, d)), 'layers': []}
    for _ in range(self.num_layers):
      layer = {
          'ln1_scale': ones(),
          'ln1_bias': zeros(),
          'qkv': dense((d, 3 * d)),
          'attn_out': dense((d, d)),
          'ln2_scale': ones(),
          'ln2_bias': zeros(),
          'ffn_in': dense((d, self.ffn_size)),
          'ffn_out': dense((self.ffn_size, d)),
      }
      if self.conv_kernel:
        layer.update({
            'ln_ffn1_scale': ones(),
            'ln_ffn1_bias': zeros(),
            'ffn1_in': dense((d, self.ffn_size)),
            'ffn1_out': dense((self.ffn_size, d)),
            'ln_conv_scale': ones(),
            'ln_conv_bias': zeros(),
            'conv_in': dense((d, 2 * d)),
            'conv_depth': dense((self.conv_kernel, d)),
            'conv_out': dense((d, d)),
        })
      params['layers'].append(layer)
    params['final_ln_scale'] = ones()
    params['final_ln_bias'] = zeros()
    return params

  def _cast(self, x: torch.Tensor) -> torch.Tensor:
    """A parameter in the compute dtype."""
    return x.to(self.dtype)

  def _conv_module(self, layer: Params, x: torch.Tensor) -> torch.Tensor:
    """Conformer convolution module: LN, GLU, causal depthwise conv, swish."""
    d = self.model_size
    y = _layer_norm(x, self._cast(layer['ln_conv_scale']),
                    self._cast(layer['ln_conv_bias']))
    gates = y @ self._cast(layer['conv_in'])
    u = gates[..., :d] * torch.sigmoid(gates[..., d:])  # GLU
    # Zero left padding: out[t] = sum_j w[j] * ext[t + j].
    ext = F.pad(u, (0, 0, self.conv_kernel - 1, 0))
    w = self._cast(layer['conv_depth'])
    conv = sum(ext[:, j:j + x.shape[1], :] * w[j]
               for j in range(self.conv_kernel))
    return F.silu(conv) @ self._cast(layer['conv_out'])

  def embed(self, input_proj: torch.Tensor,
            frames: torch.Tensor) -> torch.Tensor:
    """Input projection + fixed sinusoidal positions (block 0's input)."""
    max_t = frames.shape[-2]
    x = self._cast(frames) @ self._cast(input_proj)
    pos = _sinusoidal_positions(max_t, self.model_size, frames.device)
    return x + self._cast(pos)

  def attention_inputs(self, mask: torch.Tensor):
    """(use_banded, attn_bias): the [batch, 1, T, T] additive mask.

    use_banded is always False here: the auto setting computes the
    causal-window masks densely, with the banded route's semantics.
    """
    if self.banded_attention:
      raise NotImplementedError(
          'banded attention is not ported to PyTorch yet: ROADMAP.md '
          'queue 1, item 9 ("models/ and support code")')
    max_t = mask.shape[-1]
    zero = torch.zeros((), dtype=self.dtype, device=mask.device)
    masked = torch.full((), _MASKED, dtype=self.dtype, device=mask.device)
    attn_bias = torch.where(mask[:, None, None, :], zero, masked)
    if self.causal:
      q_pos = torch.arange(max_t, device=mask.device)
      visible = q_pos[:, None] >= q_pos[None, :]
      if self.window:
        visible &= q_pos[:, None] - q_pos[None, :] < self.window
      attn_bias = attn_bias + torch.where(visible, zero, masked)[None, None]
    return False, attn_bias

  def block(self, layer: Params, x: torch.Tensor, mask: torch.Tensor,
            attn_bias: torch.Tensor, use_banded: bool) -> torch.Tensor:
    """One encoder block (Transformer, or Conformer when conv_kernel > 0)."""
    del mask, use_banded  # dense attention only; the bias carries the mask
    head_dim = self.model_size // self.num_heads
    ffn_scale = 0.5 if self.conv_kernel else 1.0
    if self.conv_kernel:
      y = _layer_norm(x, self._cast(layer['ln_ffn1_scale']),
                      self._cast(layer['ln_ffn1_bias']))
      y = _gelu(y @ self._cast(layer['ffn1_in']))
      x = x + 0.5 * (y @ self._cast(layer['ffn1_out']))

    y = _layer_norm(x, self._cast(layer['ln1_scale']),
                    self._cast(layer['ln1_bias']))
    qkv = y @ self._cast(layer['qkv'])
    split_heads = lambda t: t.reshape(*t.shape[:-1], self.num_heads, head_dim)
    q, k, v = (split_heads(t) for t in qkv.chunk(3, dim=-1))
    logits = torch.einsum('bqhd,bkhd->bhqk', q.float(), k.float())
    logits = logits / math.sqrt(head_dim) + attn_bias
    weights = torch.softmax(logits, dim=-1).to(self.dtype)
    context = torch.einsum('bhqk,bkhd->bqhd', weights, v)
    context = context.reshape(*context.shape[:-2], self.model_size)
    x = x + context @ self._cast(layer['attn_out'])

    if self.conv_kernel:
      x = x + self._conv_module(layer, x)

    y = _layer_norm(x, self._cast(layer['ln2_scale']),
                    self._cast(layer['ln2_bias']))
    y = _gelu(y @ self._cast(layer['ffn_in']))
    return x + ffn_scale * (y @ self._cast(layer['ffn_out']))

  def finalize(self, final_ln_scale: torch.Tensor,
               final_ln_bias: torch.Tensor, x: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
    """Final layer norm + padding zero-out (the last block's epilogue)."""
    x = _layer_norm(x, self._cast(final_ln_scale), self._cast(final_ln_bias))
    return torch.where(mask[..., None], x, 0.0).float()

  def apply(self, params: Params, frames: torch.Tensor,
            num_frames: torch.Tensor) -> torch.Tensor:
    """Encodes [batch, T, feature] frames to [batch, T, model_size]."""
    max_t = frames.shape[-2]
    mask = (torch.arange(max_t, device=frames.device) <
            num_frames[..., None])  # [batch, T]
    x = self.embed(params['input_proj'], frames)
    use_banded, attn_bias = self.attention_inputs(mask)
    for layer in params['layers']:
      x = self.block(layer, x, mask, attn_bias, use_banded)
    return self.finalize(params['final_ln_scale'], params['final_ln_bias'],
                         x, mask)


def _sinusoidal_positions(length: int, dim: int, device) -> torch.Tensor:
  """[length, dim] float32 encodings, sin and cos interleaved."""
  position = torch.arange(length, device=device, dtype=torch.float32)[:, None]
  div = torch.exp(
      torch.arange(0, dim, 2, device=device, dtype=torch.float32) *
      (-math.log(10000.0) / dim))
  pe = torch.zeros((length, dim), device=device)
  pe[:, 0::2] = torch.sin(position * div)
  pe[:, 1::2] = torch.cos(position * div)
  return pe
