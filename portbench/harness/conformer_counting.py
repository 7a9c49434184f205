"""Operations, bytes and least times of the Conformer GNAT: the yardstick of
``mfu.conformer_decode`` and ``rel_attention_roofline``.

Counted per utterance from its real input length n and the encoder's T' =
((n - 1) // 2 - 1) // 2 frames, forward, multiply-adds as two operations,
the matrix products and convolutions alone (layer norm, BatchNorm, GLU,
Swish and softmax are left out, as ``counting.encoder_flops`` leaves them).
The peaks and ``bound`` are ``counting.py``'s.
"""

from __future__ import annotations

from portbench.harness.counting import (PEAK_BYTES, PEAK_OPS, bound,  # noqa: F401
                                        head_product_flops, nbytes)

FLOAT32_BYTES = 4


def output_frames(n: int) -> int:
  return max(0, ((n - 1) // 2 - 1) // 2)


def subsample_flops(config: dict, n: int) -> float:
  """The two 3 x 3 stride-2 convolutions and the linear map to d."""
  f, d = config['feature_size'], config['encoder_size']
  t1, f1 = (n - 1) // 2, (f - 1) // 2
  t2, f2 = output_frames(n), (f1 - 1) // 2
  return (2.0 * t1 * f1 * d * 9 + 2.0 * t2 * f2 * d * d * 9 +
          2.0 * t2 * (d * f2) * d)


def attention_flops(config: dict, t: int) -> float:
  """One block's relative-position attention kernel over T' = t frames:
  the content and position scores and the weighted values, 6 t^2 d."""
  return 6.0 * t * t * config['encoder_size']


def block_flops(config: dict, t: int) -> float:
  """One Conformer block over t frames: two feed-forward pairs, q / k / v,
  the 2t - 1 positions' projection, the attention kernel, the output
  projection, the convolution module's two pointwise maps and its
  depthwise convolution."""
  d, ffn = config['encoder_size'], config['encoder_ffn_size']
  k = config['encoder_conv_kernel']
  if t == 0:
    return 0.0
  return (2 * 2 * 2.0 * t * d * ffn + 2.0 * t * d * 3 * d +
          2.0 * (2 * t - 1) * d * d + attention_flops(config, t) +
          2.0 * t * d * d + 2.0 * t * d * 2 * d + 2.0 * t * d * k +
          2.0 * t * d * d)


def encoder_flops(config: dict, lengths) -> float:
  """The Conformer encoder forward over utterances of real input lengths."""
  layers = config['encoder_layers']
  return sum(subsample_flops(config, n) +
             layers * block_flops(config, output_frames(n))
             for n in lengths)


def decode_least_s(config: dict, lengths) -> float:
  """The least time of one decode call's model operations: the encoder and
  the frame projection over its T' frames in float32, one Viterbi head
  product a real encoder frame-row in bfloat16."""
  frames = sum(output_frames(n) for n in lengths)
  dense = encoder_flops(config, lengths) + (
      2.0 * frames * config['encoder_size'] * config['hidden_size'])
  s, h, v = (config['vocab_size'] + 1, config['hidden_size'],
             config['vocab_size'])
  return (dense / PEAK_OPS['float32'] +
          head_product_flops(frames, s, h, v) / PEAK_OPS['bfloat16'])


def attention_bytes(config: dict, lengths) -> float:
  """One block's attention kernel: q, k, v and the output at each
  utterance's real T', the 2 T'_max - 1 projected positions, u and v, each
  counted once."""
  d = config['encoder_size']
  t_max = max(output_frames(n) for n in lengths)
  rows = sum(output_frames(n) for n in lengths)
  return FLOAT32_BYTES * (4 * rows * d + (2 * t_max - 1) * d + 2 * d)


def attention_least_ms(config: dict, lengths) -> float:
  """The least time of a decode call's attention kernels, every block,
  over utterances of real input lengths (float32, operations or bytes)."""
  flops = sum(attention_flops(config, output_frames(n)) for n in lengths)
  ms, _ = bound(flops, attention_bytes(config, lengths), 'float32')
  return config['encoder_layers'] * ms
