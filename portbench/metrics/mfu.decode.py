"""mfu.decode: the decode call's share of the H100's peak. The least time
of the window's calls' model operations (``counting.decode_least_s``: the
encoder and frame projection in float32, one Viterbi head product a real
frame-row in bfloat16) over the measured window's span. Moves
decode_frames_per_s."""

from portbench.harness import counting


def read(ctx):
  window = ctx.window
  if not window.get('batches'):
    return None
  least = sum(counting.decode_least_s(ctx.cell.config,
                                      ctx.session.pool[index].lengths)
              for index in window['batches'])
  return 100.0 * least / window['span_s']
