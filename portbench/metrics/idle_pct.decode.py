"""idle_pct.decode: 1 - busy / wall over the profiled decode calls, in %.
Busy is the union of the device activity intervals; wall the host clock
from the first profiled call's start to the last one's synchronize. Moves
decode_frames_per_s."""


def read(ctx):
  if not ctx.profile:
    return None
  return 100.0 * ctx.profile['idle_share']
