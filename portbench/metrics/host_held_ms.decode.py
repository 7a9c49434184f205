"""host_held_ms.decode: the device's idle ms in one recorded decode call of
the cell's first pooled batch (``harness/spans.py``) that falls inside a
program span, each piece of a gap put down to the innermost span open over
it on the host: the time the card waited on the program's own host code.
Prints the split by span, the ten longest gaps and the synchronising
operations by span on standard error. Moves decode_frames_per_s."""

import sys

from portbench.harness import spans


def read(ctx):
  found = spans.recorded(ctx)
  if not found or found['held_us'] is None:
    return None
  held = found['held_us']
  print('host_held_ms.decode: idle ms by span: ' + ', '.join(
      f'{name} {us / 1e3!r}' for name, us in
      sorted(held.items(), key=lambda item: -item[1])), file=sys.stderr)
  for start, ms, split in found['gaps']:
    print(f'host_held_ms.decode: gap at +{start:.1f} ms, {ms!r} ms: {split}',
          file=sys.stderr)
  print(f'host_held_ms.decode: synchronising operations by span: '
        f'{found["syncs"]}; where: {found["sync_sites"]}', file=sys.stderr)
  return sum(held.values()) / 1e3
