"""Readings that a cell's correctness limits are set from, on the card.

  python3 portbench/calibrate.py --workload <name> --seeds <n> ... \
      [--control-seeds <n> ...] [--seconds <s>] [--out <file.jsonl>]

For each ``--seeds`` seed, in one process, the numbers a run of the cell
compares, from the program as the cell runs it: a short window at the
cell's own load (``--seconds``, long enough to finish a call) against the
reference. For each ``--control-seeds`` seed the same numbers of the
control: the reference computed in the precision below the
configuration's (``controls`` in the configuration file) in the program's
place, on the utterances that seed's run compares, against the reference.
One JSON line per reading.
"""

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent


def control_decode(cell, driver, seed, device, control, seconds):
  """The reference in the control's precision, in the program's place, on
  the utterances a run of ``seed`` would compare."""
  import torch
  from portbench.harness import port
  from portbench.reference import gnat as reference
  session = driver.setup(cell, seed, device)
  driver.window(session, seconds)
  batch, _, _ = driver.sampled(session, seed)
  driver.release(session)
  config = cell.config
  normalize = 'hat' if config['locally_normalized'] else 'none'
  with torch.no_grad(), reference.tf32(False):
    encoded = reference.encode(session.params['encoder'], batch.frames,
                               batch.num_frames, config['encoder_heads'])
    pc, pf = reference.projections(session.params['lattice'], encoded)
    best, path = reference.viterbi(
        session.params['lattice']['weight_fn'], pc, pf, batch.num_frames,
        config['max_expansions'], getattr(torch, control['head_dtype']),
        normalize, with_path=True)
  gaps = driver.compare(cell, session.params, batch, path, best,
                        port.head_dtype(config, device))
  return [{'name': 'weight_gap', 'value': gaps[0]},
          {'name': 'rescore_gap', 'value': gaps[1]}]


def main():
  parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  parser.add_argument('--workload', required=True)
  parser.add_argument('--seeds', type=int, nargs='*', default=[])
  parser.add_argument('--control-seeds', type=int, nargs='*', default=[])
  parser.add_argument('--seconds', type=float, default=5.0)
  parser.add_argument('--out', default=None)
  args = parser.parse_args()
  sys.path.insert(0, str(ROOT))
  import torch
  from portbench.harness import spec
  cell = spec.load_cell(args.workload, ROOT)
  driver = spec.driver(cell)
  device = torch.device('cuda')
  out = open(args.out, 'a', encoding='utf-8') if args.out else None

  def emit(record):
    line = json.dumps(record)
    print(line, flush=True)
    if out:
      out.write(line + '\n')
      out.flush()

  for seed in args.seeds:
    started = time.perf_counter()
    session = driver.setup(cell, seed, device)
    driver.window(session, args.seconds)
    numbers = driver.check(session, seed)
    del session
    torch.cuda.empty_cache()
    emit({'workload': cell.name, 'side': 'program', 'seed': seed,
          'numbers': {n['name']: n['value'] for n in numbers},
          'seconds': time.perf_counter() - started})
  control = cell.config['controls'][cell.traffic['driver']]
  for seed in args.control_seeds:
    started = time.perf_counter()
    numbers = control_decode(cell, driver, seed, device, control,
                             args.seconds)
    torch.cuda.empty_cache()
    emit({'workload': cell.name, 'side': 'control', 'control': control,
          'seed': seed, 'numbers': {n['name']: n['value'] for n in numbers},
          'seconds': time.perf_counter() - started})
  return 0


if __name__ == '__main__':
  sys.exit(main())
