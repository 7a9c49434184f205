"""Plain PyTorch reference of the GNAT models the benchmark decodes with.

It imports torch and math alone: nothing of the program under test and
nothing of the JAX package. It takes the parameter dictionaries the
benchmark makes from the seed (laid out as the port's: ``encoder``,
``lattice.cacher.embedding``, ``lattice.weight_fn``) and the benchmark's
inputs, and works out everything else itself: the encoder output, the
context cache's projections, each frame's weights and the Viterbi best
path, and the weight of a given alignment.

What it computes, after the GNAT paper (arXiv:2205.13674) and the port's
plain versions, of which it is a frozen copy in plain operations:

- the encoder: a pre-LN Transformer over padded frames, sinusoidal
  positions, dense softmax attention with an additive -1e9 mask on padded
  keys, tanh-approximate GELU, layer norm eps 1e-6, padded outputs zeroed;
- the joint weight function over a bigram ``FullNGram`` context (S = V + 1
  states, state y after label y, state 0 at the start):
  ``blank, lexical = heads(tanh(cache @ context_proj + frame @ frame_proj))``;
- a FrameLabelDependent(k) alignment: each frame takes up to k labels,
  then a blank;
- globally normalized decoding scores the raw heads; HAT decoding scores
  ``logsigmoid(blank)`` and ``log_softmax(lexical) + logsigmoid(-blank)``.

``head_dtype`` is the type the Viterbi forward's head products take their
inputs in, summed in float32: the configuration's stated precision
(bfloat16 on the card), or a lower one for the control. The joint and the
head weights are rounded to it. Float32 products run with TF32 off unless a
caller turns it on (``tf32``).
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

MASKED = -1e9
NEG_INF = float('-inf')


@contextlib.contextmanager
def tf32(enabled: bool):
  """Float32 matmuls in TF32 (``enabled``) or in full float32, restored
  after."""
  before = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
  torch.backends.cuda.matmul.allow_tf32 = enabled
  torch.backends.cudnn.allow_tf32 = enabled
  try:
    yield
  finally:
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = before


def rounded(x: torch.Tensor, dtype) -> torch.Tensor:
  """x rounded to ``dtype`` and back (x itself for None)."""
  if dtype is None or dtype == x.dtype:
    return x
  return x.to(dtype).to(x.dtype)


def check_config(config: dict):
  """Raises for a configuration outside what this reference decodes."""
  wanted = {'context_size': 1, 'use_rnn_cacher': False,
            'encoder_causal': False, 'encoder_conv_kernel': 0}
  for key, value in wanted.items():
    if config.get(key, value) != value:
      raise ValueError(f'the reference computes {key}={value!r}, not '
                       f'{config[key]!r}')
  if config['max_expansions'] < 1:
    raise ValueError('the reference computes FrameLabelDependent(k >= 1)')


# ---------------------------------------------------------------- encoder


def layer_norm(x, scale, bias, eps=1e-6):
  mean = x.mean(dim=-1, keepdim=True)
  var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
  return (x - mean) / torch.sqrt(var + eps) * scale + bias


def positions(length: int, dim: int, device) -> torch.Tensor:
  """[length, dim] sinusoidal encodings, sin and cos interleaved."""
  pos = torch.arange(length, device=device, dtype=torch.float32)[:, None]
  div = torch.exp(torch.arange(0, dim, 2, device=device, dtype=torch.float32)
                  * (-math.log(10000.0) / dim))
  pe = torch.zeros((length, dim), device=device)
  pe[:, 0::2] = torch.sin(pos * div)
  pe[:, 1::2] = torch.cos(pos * div)
  return pe


def encoder_block(layer, x, key_bias, num_heads):
  b, t, d = x.shape
  hd = d // num_heads
  y = layer_norm(x, layer['ln1_scale'], layer['ln1_bias'])
  q, k, v = (z.reshape(b, t, num_heads, hd).transpose(1, 2)
             for z in (y @ layer['qkv']).split(d, dim=-1))
  logits = q @ k.transpose(-1, -2) / math.sqrt(hd) + key_bias
  context = torch.softmax(logits, dim=-1) @ v
  x = x + context.transpose(1, 2).reshape(b, t, d) @ layer['attn_out']
  y = layer_norm(x, layer['ln2_scale'], layer['ln2_bias'])
  y = F.gelu(y @ layer['ffn_in'], approximate='tanh')
  return x + y @ layer['ffn_out']


def encode(params, frames, num_frames, num_heads: int) -> torch.Tensor:
  """[B, T, F] frames to [B, T, d] encodings."""
  t = frames.shape[1]
  d = params['input_proj'].shape[1]
  mask = torch.arange(t, device=frames.device)[None, :] < num_frames[:, None]
  key_bias = torch.where(mask, 0.0, MASKED)[:, None, None, :]
  x = frames @ params['input_proj'] + positions(t, d, frames.device)
  for layer in params['layers']:
    x = encoder_block(layer, x, key_bias, num_heads)
  x = layer_norm(x, params['final_ln_scale'], params['final_ln_bias'])
  return torch.where(mask[..., None], x, 0.0)


# ---------------------------------------------------------------- lattice


def projections(lattice_params, encoded):
  """(pc [S, h], pf [B, T, h]): the context and frame projections."""
  wf = lattice_params['weight_fn']
  cache = lattice_params['cacher']['embedding']
  return cache @ wf['context_proj'], encoded @ wf['frame_proj']


def heads(wf, head_dtype):
  """The head weights as the Viterbi products take them."""
  return (rounded(wf['vocab_w'], head_dtype), wf['vocab_b'],
          rounded(wf['blank_w'], head_dtype), wf['blank_b'])


def frame_weights(pc, pf_t, wf, head_dtype):
  """(lex [B, S, V], blank [B, S]) of one frame at every context state: the
  joint and both head weights rounded to ``head_dtype``, products summed in
  float32 (the port's ``fused_forward_plain`` rounding points)."""
  joint = rounded(torch.tanh(pc[None] + pf_t[:, None]), head_dtype)
  vw, vb, bw, bb = heads(wf, head_dtype)
  return joint @ vw + vb, joint @ bw + bb


# ---------------------------------------------------------------- Viterbi


def normalized(lex, blank, normalize: str):
  """(c [.., S], blank): each lexical weight of a state loses c."""
  if normalize == 'none':
    return torch.zeros_like(blank), blank
  if normalize != 'hat':
    raise ValueError(f'normalize {normalize!r}')
  return (torch.logsumexp(lex, dim=-1) + F.softplus(blank),
          -F.softplus(-blank))


@torch.no_grad()
def viterbi(wf, pc, pf, num_frames, k: int, head_dtype, normalize: str,
            with_path: bool):
  """The best FLD(k) path's weight [B] (max-plus, float32 sums) and, with
  ``with_path``, its alignment labels [B, T * (k + 1)]: k label slots a
  frame (0 where unused), then the blank slot (0)."""
  b, max_t, _ = pf.shape
  num_states = pc.shape[0]
  alpha = torch.full((b, num_states), NEG_INF, device=pf.device)
  alpha[:, 0] = 0.0
  edge = torch.full((b, 1), NEG_INF, device=pf.device)
  args, js_all = [], []
  pf_t_major = pf.transpose(0, 1)
  for t in range(max_t):
    lex, blank = frame_weights(pc, pf_t_major[t], wf, head_dtype)
    c, blank = normalized(lex, blank, normalize)
    acc, last = alpha + blank, alpha
    js = torch.zeros_like(alpha, dtype=torch.long)
    frame_args = []
    for j in range(1, k + 1):
      red, best = torch.max((last - c)[:, :, None] + lex, dim=1)
      frame_args.append(best)
      last = torch.cat([edge, red], dim=1)
      cand = last + blank
      better = cand > acc
      acc = torch.where(better, cand, acc)
      js = torch.where(better, j, js)
    live = (t < num_frames)[:, None]
    alpha = torch.where(live, acc, alpha)
    if with_path:
      args.append(torch.stack(frame_args, dim=1))  # [B, k, V]
      js_all.append(torch.where(live, js, 0))
  best_weight, q = alpha.max(dim=-1)
  if not with_path:
    return best_weight, None
  slots = torch.zeros((b, max_t, k + 1), dtype=torch.long, device=pf.device)
  for t in range(max_t - 1, -1, -1):
    j = js_all[t].gather(1, q[:, None])[:, 0]
    for i in range(k, 0, -1):
      active = j >= i
      slots[:, t, i - 1] = torch.where(active, q, 0)
      src = args[t][:, i - 1].gather(1, (q - 1).clamp(min=0)[:, None])[:, 0]
      q = torch.where(active, src, q)
  return best_weight, slots.reshape(b, -1)


@torch.no_grad()
def rescore(wf, pc, pf, num_frames, labels, k: int, head_dtype,
            normalize: str) -> torch.Tensor:
  """[B] float64 weight of the given alignments under these weights: a
  label y read in state q scores lex[q, y] (less q's normalizer) and moves
  to state y; the frame's blank slot scores blank[q]."""
  b, max_t, _ = pf.shape
  vw, vb, bw, bb = (x.double() for x in heads(wf, head_dtype))
  slots = labels.view(b, max_t, k + 1).long()
  q = torch.zeros(b, dtype=torch.long, device=pf.device)
  score = torch.zeros(b, dtype=torch.float64, device=pf.device)
  rows = torch.arange(b, device=pf.device)
  pf_t_major = pf.transpose(0, 1)
  for t in range(max_t):
    live = t < num_frames
    for i in range(k + 1):
      joint = rounded(torch.tanh(pc[q] + pf_t_major[t]), head_dtype).double()
      lex = joint @ vw + vb  # [B, V]
      c, blank = normalized(lex, joint @ bw + bb, normalize)
      y = slots[:, t, i]
      if i < k:
        weight = torch.where(y > 0, lex[rows, (y - 1).clamp(min=0)] - c, 0.0)
        q_next = torch.where(live & (y > 0), y, q)
      else:
        weight = torch.where(y > 0, lex[rows, (y - 1).clamp(min=0)] - c,
                             blank)
        q_next = q
      score += torch.where(live, weight, 0.0)
      q = q_next
  return score
