"""rel_attention_roofline: the relative-position attention kernel's share of
its roofline in one recorded decode call of the cell's first pooled batch
(``harness/spans.py``): the least time of its work in every block
(``conformer_counting.attention_least_ms``: 6 T'^2 d float32 operations an
utterance at its real T', q, k, v, the positions, u, v and the output each
moved once) over the summed device ms of the program's
``encoder.attention`` spans, which hold the kernel call alone. Moves
decode_frames_per_s."""

from portbench.harness import conformer_counting, spans


def read(ctx):
  found = spans.recorded(ctx)
  ms = found and found['device_ms'].get('encoder.attention')
  if not ms:
    return None
  least = conformer_counting.attention_least_ms(
      ctx.cell.config, ctx.session.pool[0].lengths)
  return 100.0 * least / ms
