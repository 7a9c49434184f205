"""subsample_ms.conformer_decode: the device ms of the program's
``encoder.subsample`` span (the Conformer's convolution front end through
its linear map) in one recorded decode call of the cell's first pooled
batch (``harness/spans.py``). Moves decode_frames_per_s."""

from portbench.harness import spans


def read(ctx):
  found = spans.recorded(ctx)
  return found and found['device_ms'].get('encoder.subsample')
