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
dictionary laid out as the JAX pytree. Attention is plain matmul + softmax,
as the JAX package writes it (in XLA, not in a kernel): over dense [T, T]
logits, or, for a causal window W, over [W, 2W] logits per W-frame block
(``_banded_attention``). ``StreamingEncoder`` encodes a causal windowed
encoder chunk by chunk with key/value caches, matching one offline
``apply`` up to float summation order.

``apply`` / ``block`` also run one rank's part of a Megatron-sharded block
(``parallel/sharding.py``): ``heads`` is the rank's head count (its
columns of ``qkv``, ``ffn_in`` and ``ffn1_in`` and rows of ``attn_out``,
``ffn_out`` and ``ffn1_out``), and ``model_sum`` sums the row-parallel
products over the model ranks. With neither, a block is the whole one.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch
import torch.nn.functional as F

from last_torch_tpu_torch import initializers
from last_torch_tpu_torch.utils import profiling

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
    banded_attention: Blocked O(T * 2W) attention for a causal window
      instead of the dense O(T^2) logits. None (auto) takes it when
      ``max_t > 2 * window``; True / False force it. Same masks as the dense
      route; outputs agree up to float summation order.
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

  def _dense_attention(self, q, k, v, attn_bias):
    """Softmax attention over all keys with an additive float mask: float32
    logits (the JAX package's ``preferred_element_type``), weights in the
    compute dtype. q: [batch, Tq, heads, hd]; k, v: [batch, Tk, heads, hd];
    attn_bias broadcastable to [batch, heads, Tq, Tk]."""
    head_dim = q.shape[-1]
    logits = torch.einsum('bqhd,bkhd->bhqk', q.float(), k.float())
    logits = logits / math.sqrt(head_dim) + attn_bias
    weights = torch.softmax(logits, dim=-1).to(self.dtype)
    return torch.einsum('bhqk,bkhd->bqhd', weights, v)

  def _banded_attention(self, q, k, v, mask):
    """Blocked O(T * 2W) causal-windowed attention.

    With ``causal=True`` and ``window=W``, query t attends keys (t - W, t],
    which lie in the query's own W-frame block or the block before it. Each
    block therefore computes [W, 2W] logits instead of a [T, T] row band:
    at T=1600, W=64 that is 1/12.5 of the dense float32 logits. The masks
    are the dense route's; outputs agree up to float summation order.

    Args:
      q, k, v: [batch, T, heads, head_dim] (already head-split).
      mask: [batch, T] bool frame-validity mask.

    Returns:
      [batch, T, heads, head_dim] attention context.
    """
    b, t, h, hd = q.shape
    w = self.window
    nb = -(-t // w)
    t_pad = nb * w

    def pad(x):
      if t_pad == t:
        return x
      return torch.cat([x, x.new_zeros((b, t_pad - t) + x.shape[2:])], dim=1)

    def with_prev(x):
      """Prepends each block's left neighbour (zeros before block 0)."""
      prev = torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)
      return torch.cat([prev, x], dim=2)  # [B, nb, 2W, ...]

    qb = pad(q).reshape(b, nb, w, h, hd)
    k2 = with_prev(pad(k).reshape(b, nb, w, h, hd))
    v2 = with_prev(pad(v).reshape(b, nb, w, h, hd))
    # Block 0's zero "previous block" is masked by m2's zeros (False), which
    # also covers global key index < 0.
    m2 = with_prev(pad(mask).reshape(b, nb, w))
    q_off = torch.arange(w, device=q.device)
    k_off = torch.arange(2 * w, device=q.device) - w  # from the block start
    visible = ((q_off[:, None] >= k_off[None, :]) &
               (q_off[:, None] - k_off[None, :] < w))
    bias = torch.where(visible[None, None] & m2[:, :, None, :], 0.0,
                       _MASKED)  # [B, nb, W, 2W] float32
    logits = torch.einsum('bnqhd,bnkhd->bnhqk', qb.float(), k2.float())
    logits = logits / math.sqrt(hd) + bias[:, :, None]
    weights = torch.softmax(logits, dim=-1).to(self.dtype)
    ctx = torch.einsum('bnhqk,bnkhd->bnqhd', weights, v2)
    return ctx.reshape(b, t_pad, h, hd)[:, :t]

  def _conv_module(self, layer: Params, x: torch.Tensor,
                   history: Optional[torch.Tensor] = None):
    """Conformer convolution module: LN, GLU, causal depthwise conv, swish.

    ``history``: [batch, conv_kernel - 1, d], the previous chunk's GLU
    outputs when streaming; offline the left context is zeros. Returns
    (module output, new history).
    """
    d = self.model_size
    y = _layer_norm(x, self._cast(layer['ln_conv_scale']),
                    self._cast(layer['ln_conv_bias']))
    gates = y @ self._cast(layer['conv_in'])
    u = gates[..., :d] * torch.sigmoid(gates[..., d:])  # GLU
    if history is None:
      history = u.new_zeros((x.shape[0], self.conv_kernel - 1, d))
    ext = torch.cat([history, u], dim=1)  # [B, K-1+T, d]
    # Causal depthwise conv: out[t] = sum_j w[j] * ext[t + j].
    w = self._cast(layer['conv_depth'])
    conv = sum(ext[:, j:j + x.shape[1], :] * w[j]
               for j in range(self.conv_kernel))
    out = F.silu(conv) @ self._cast(layer['conv_out'])
    return out, ext[:, ext.shape[1] - (self.conv_kernel - 1):, :]

  def embed(self, input_proj: torch.Tensor,
            frames: torch.Tensor) -> torch.Tensor:
    """Input projection + fixed sinusoidal positions (block 0's input)."""
    max_t = frames.shape[-2]
    x = self._cast(frames) @ self._cast(input_proj)
    pos = _sinusoidal_positions(max_t, self.model_size, frames.device)
    return x + self._cast(pos)

  def attention_inputs(self, mask: torch.Tensor):
    """Per-sequence attention routing: (use_banded, attn_bias).

    ``use_banded``: banded when ``causal and window`` and ``max_t > 2 *
    window``, or as ``banded_attention`` forces it. ``attn_bias``: the
    dense [batch, 1, T, T] additive mask, None on the banded route (which
    masks inside its blocks).
    """
    max_t = mask.shape[-1]
    use_banded = bool(self.causal and self.window and (
        self.banded_attention if self.banded_attention is not None else
        max_t > 2 * self.window))
    if use_banded:
      return True, None
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

  def _layer(self, layer: Params, x: torch.Tensor, attend,
             conv_history: Optional[torch.Tensor] = None,
             heads: Optional[int] = None, model_sum=None):
    """One block, with attention as ``attend(q, k, v) -> context`` (each
    [batch, T, heads, head_dim]); returns (x, new conv history or None).

    ``heads``: the heads this block holds (all of them by default).
    ``model_sum``: applied to each row-parallel product (``attn_out``,
    ``ffn_out``, ``ffn1_out``) before it joins the residual; None for a
    whole block. The column-parallel products read the replicated input as
    it is (module docstring of ``parallel/sharding.py``)."""
    heads = heads or self.num_heads
    head_dim = self.model_size // self.num_heads
    ffn_scale = 0.5 if self.conv_kernel else 1.0
    summed = (lambda t: t) if model_sum is None else model_sum
    if self.conv_kernel:
      # Conformer macaron: first half-FFN.
      y = _layer_norm(x, self._cast(layer['ln_ffn1_scale']),
                      self._cast(layer['ln_ffn1_bias']))
      y = _gelu(y @ self._cast(layer['ffn1_in']))
      x = x + 0.5 * summed(y @ self._cast(layer['ffn1_out']))

    y = _layer_norm(x, self._cast(layer['ln1_scale']),
                    self._cast(layer['ln1_bias']))
    qkv = y @ self._cast(layer['qkv'])
    split_heads = lambda t: t.reshape(*t.shape[:-1], heads, head_dim)
    q, k, v = (split_heads(t) for t in qkv.chunk(3, dim=-1))
    context = attend(q, k, v)
    context = context.reshape(*context.shape[:-2], heads * head_dim)
    x = x + summed(context @ self._cast(layer['attn_out']))

    new_history = None
    if self.conv_kernel:
      conv_out, new_history = self._conv_module(layer, x, conv_history)
      x = x + conv_out

    y = _layer_norm(x, self._cast(layer['ln2_scale']),
                    self._cast(layer['ln2_bias']))
    y = _gelu(y @ self._cast(layer['ffn_in']))
    return (x + ffn_scale * summed(y @ self._cast(layer['ffn_out'])),
            new_history)

  def block(self, layer: Params, x: torch.Tensor, mask: torch.Tensor,
            attn_bias: Optional[torch.Tensor], use_banded: bool,
            heads: Optional[int] = None, model_sum=None) -> torch.Tensor:
    """One encoder block (Transformer, or Conformer when conv_kernel > 0);
    ``heads`` and ``model_sum`` as ``_layer``'s."""
    if use_banded:
      attend = lambda q, k, v: self._banded_attention(q, k, v, mask)
    else:
      attend = lambda q, k, v: self._dense_attention(q, k, v, attn_bias)
    return self._layer(layer, x, attend, heads=heads,
                       model_sum=model_sum)[0]

  def finalize(self, final_ln_scale: torch.Tensor,
               final_ln_bias: torch.Tensor, x: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
    """Final layer norm + padding zero-out (the last block's epilogue)."""
    x = _layer_norm(x, self._cast(final_ln_scale), self._cast(final_ln_bias))
    return torch.where(mask[..., None], x, 0.0).float()

  def apply(self, params: Params, frames: torch.Tensor,
            num_frames: torch.Tensor, heads: Optional[int] = None,
            model_sum=None) -> torch.Tensor:
    """Encodes [batch, T, feature] frames to [batch, T, model_size];
    ``heads`` and ``model_sum`` as ``_layer``'s."""
    with profiling.span('encoder.apply'):
      max_t = frames.shape[-2]
      mask = (torch.arange(max_t, device=frames.device) <
              num_frames[..., None])  # [batch, T]
      x = self.embed(params['input_proj'], frames)
      use_banded, attn_bias = self.attention_inputs(mask)
      for layer in params['layers']:
        x = self.block(layer, x, mask, attn_bias, use_banded, heads=heads,
                       model_sum=model_sum)
      return self.finalize(params['final_ln_scale'],
                           params['final_ln_bias'], x, mask)


def _sinusoidal_positions_at(position: torch.Tensor, dim: int
                             ) -> torch.Tensor:
  """[n, dim] float32 encodings of the given positions, sin and cos
  interleaved. The product ``position * div`` is float32, so a chunk's
  positions equal the offline ones bit for bit."""
  position = position.to(torch.float32)[:, None]
  div = torch.exp(
      torch.arange(0, dim, 2, device=position.device, dtype=torch.float32) *
      (-math.log(10000.0) / dim))
  pe = torch.zeros((position.shape[0], dim), device=position.device)
  pe[:, 0::2] = torch.sin(position * div)
  pe[:, 1::2] = torch.cos(position * div)
  return pe


def _sinusoidal_positions(length: int, dim: int, device) -> torch.Tensor:
  """[length, dim] float32 encodings of positions 0..length-1."""
  return _sinusoidal_positions_at(torch.arange(length, device=device), dim)


@dataclasses.dataclass(frozen=True)
class StreamingEncoder:
  """Chunked inference for a causal, left-windowed TransformerEncoder.

  Carries per-layer key/value caches of the last ``window`` frames (and the
  Conformer convolution's last ``conv_kernel - 1`` GLU outputs) plus a frame
  counter, so encoding any chunk sizes matches one offline ``encoder.apply``
  with ``causal=True, window=W`` up to float summation order.

  All streams of a batch advance together (whole chunks); pad the final
  partial chunk and mask downstream through the decoders' num_frames.
  """

  encoder: TransformerEncoder

  def __post_init__(self):
    if not (self.encoder.causal and self.encoder.window > 0):
      raise ValueError('StreamingEncoder requires a TransformerEncoder '
                       'with causal=True and window > 0')

  def init_state(self, batch_size: int, device='cuda') -> dict:
    """Zero caches on ``device`` (the card unless the caller asks for
    'cpu'). ``pos``, the absolute frame count since the stream started, is
    a Python int, so no step reads a device value back. float32
    sinusoidal encodings lose precision beyond ~1e6 frames (~3 h at 100
    frames a second): restart long streams well before that."""
    e = self.encoder
    w, hd = e.window, e.model_size // e.num_heads
    kv = torch.zeros((batch_size, e.num_layers, w, e.num_heads, hd),
                     dtype=e.dtype, device=device)
    state = {'k': kv, 'v': kv.clone(), 'pos': 0}
    if e.conv_kernel:
      state['conv'] = torch.zeros(
          (batch_size, e.num_layers, e.conv_kernel - 1, e.model_size),
          dtype=e.dtype, device=device)
    return state

  def step(self, params: Params, state: dict, frames: torch.Tensor):
    """Encodes one chunk: [batch, chunk_len, feature] ->
    (new state, [batch, chunk_len, model_size] float32)."""
    e = self.encoder
    chunk, w, t0 = frames.shape[1], e.window, state['pos']
    device = frames.device
    q_abs = t0 + torch.arange(chunk, device=device)  # [C]
    k_abs = torch.cat([t0 - w + torch.arange(w, device=device), q_abs])
    visible = ((q_abs[:, None] >= k_abs[None, :]) &
               (q_abs[:, None] - k_abs[None, :] < w) &
               (k_abs[None, :] >= 0))
    zero = torch.zeros((), dtype=e.dtype, device=device)
    masked = torch.full((), _MASKED, dtype=e.dtype, device=device)
    attn_bias = torch.where(visible, zero, masked)[None, None]  # [1,1,C,W+C]

    x = e._cast(frames) @ e._cast(params['input_proj'])
    x = x + e._cast(_sinusoidal_positions_at(q_abs, e.model_size))
    new_k, new_v, new_conv = [], [], []
    for i, layer in enumerate(params['layers']):

      def attend(q, k, v, i=i):
        k_full = torch.cat([state['k'][:, i], k], dim=1)
        v_full = torch.cat([state['v'][:, i], v], dim=1)
        new_k.append(k_full[:, -w:])
        new_v.append(v_full[:, -w:])
        return e._dense_attention(q, k_full, v_full, attn_bias)

      x, history = e._layer(layer, x, attend,
                            state['conv'][:, i] if e.conv_kernel else None)
      new_conv.append(history)
    x = _layer_norm(x, e._cast(params['final_ln_scale']),
                    e._cast(params['final_ln_bias']))
    new_state = {'k': torch.stack(new_k, dim=1),
                 'v': torch.stack(new_v, dim=1), 'pos': t0 + chunk}
    if e.conv_kernel:
      new_state['conv'] = torch.stack(new_conv, dim=1)
    return new_state, x.float()
