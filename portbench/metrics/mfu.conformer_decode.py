"""mfu.conformer_decode: the Conformer decode call's share of the H100's
peak. The least time of the window's calls' model operations
(``conformer_counting.decode_least_s``: the Conformer encoder and the frame
projection in float32 over each utterance's real frames, one Viterbi head
product a real encoder frame-row in bfloat16) over the measured window's
span. Moves decode_frames_per_s."""

from portbench.harness import conformer_counting


def read(ctx):
  window = ctx.window
  if not window.get('batches'):
    return None
  least = sum(conformer_counting.decode_least_s(
      ctx.cell.config, ctx.session.pool[index].lengths)
              for index in window['batches'])
  return 100.0 * least / window['span_s']
