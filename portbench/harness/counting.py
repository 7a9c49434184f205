"""Operations, bytes and least times: the yardstick of every roofline and
``mfu`` reading.

``PEAK_OPS``, ``PEAK_BYTES``, ``bound`` and ``nbytes`` are frozen copies of
``chip_smoke.py``'s (its ``bound`` without the tanh term, which the Viterbi
bound does not take), and the kernel operation count follows its Viterbi
record (of ``main``): one head product a real frame-row. The encoder and
projection counts are this benchmark's own.
"""

from __future__ import annotations

# Published dense peaks of one H100 SXM (NVIDIA's data sheet, at 700 W):
# operations per second by input type, and device-memory bytes per second.
PEAK_OPS = {'bfloat16': 989e12, 'float32': 67e12}
PEAK_BYTES = 3.35e12


def bound(flops, nbytes, dtype):
  """(bound_ms, bound_by): the least time the card could take for flops
  operations in dtype and nbytes of device-memory traffic."""
  ops_ms = flops / PEAK_OPS[dtype] * 1e3
  bytes_ms = nbytes / PEAK_BYTES * 1e3
  return (max(ops_ms, bytes_ms),
          'operations' if ops_ms >= bytes_ms else 'bytes')


def nbytes(*tensors):
  """Bytes of the given tensors (each read or written once)."""
  return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def head_product_flops(rows, num_states, hidden, vocab):
  """One head product over every context state of ``rows`` frame-rows."""
  return 2.0 * rows * num_states * hidden * vocab


def encoder_flops(config: dict, lengths) -> float:
  """Forward operations of the Transformer encoder over utterances of the
  given real lengths: the input projection, each block's qkv, attention
  logits and context, output projection and feed-forward pair."""
  f, d = config['feature_size'], config['encoder_size']
  ffn, layers = config['encoder_ffn_size'], config['encoder_layers']
  total = 0.0
  for t in lengths:
    block = (2.0 * t * d * 3 * d + 2 * 2.0 * t * t * d + 2.0 * t * d * d +
             2 * 2.0 * t * d * ffn)
    total += 2.0 * t * f * d + layers * block
  return total


def frame_projection_flops(config: dict, lengths) -> float:
  """The joint's frame projection over the real frames (forward)."""
  return (2.0 * sum(lengths) * config['encoder_size'] *
          config['hidden_size'])


def decode_least_s(config: dict, lengths) -> float:
  """The least time of one decode call's model operations: the encoder and
  frame projection forward in float32, one Viterbi head product a real
  frame-row in bfloat16."""
  dense = encoder_flops(config, lengths) + frame_projection_flops(
      config, lengths)
  s, h, v = config['vocab_size'] + 1, config['hidden_size'], \
      config['vocab_size']
  return (dense / PEAK_OPS['float32'] +
          head_product_flops(sum(lengths), s, h, v) / PEAK_OPS['bfloat16'])
