"""backtrace_device_ms.decode: the device ms of the program's
``viterbi.backtrace`` span in one recorded decode call of the cell's first
pooled batch (``harness/spans.py``). Its start event sits in the queue
behind the Viterbi forward's kernels, so the interval runs from the
forward's last kernel to the backtrace's last: what the backtrace adds to
the call, where ``backtrace_ms.decode`` times its host loop alone. Moves
decode_frames_per_s."""

from portbench.harness import spans


def read(ctx):
  found = spans.recorded(ctx)
  return found and found['device_ms'].get('viterbi.backtrace')
