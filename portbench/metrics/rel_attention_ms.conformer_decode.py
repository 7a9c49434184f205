"""rel_attention_ms.conformer_decode: the device ms of the program's
``encoder.attention`` spans (each block's relative-position attention
kernel call, without its projections), summed over the blocks of one
recorded decode call of the cell's first pooled batch
(``harness/spans.py``). Moves decode_frames_per_s."""

from portbench.harness import spans


def read(ctx):
  found = spans.recorded(ctx)
  return found and found['device_ms'].get('encoder.attention')
