"""encoder_ms.decode: the device ms of the program's ``encoder.apply`` span
in one recorded decode call of the cell's first pooled batch
(``harness/spans.py``): from the CUDA event recorded where the encoder
starts to the one where it ends, so the time its kernels ran on the card.
Moves decode_frames_per_s."""

from portbench.harness import spans


def read(ctx):
  found = spans.recorded(ctx)
  return found and found['device_ms'].get('encoder.apply')
