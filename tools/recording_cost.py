#!/usr/bin/env python3
# Copyright 2026.
#
# Licensed under the Apache License, Version 2.0 (the "License");
# you may not use this file except in compliance with the License.
# You may obtain a copy of the License at
#
#     http://www.apache.org/licenses/LICENSE-2.0
#
# Unless required by applicable law or agreed to in writing, software
# distributed under the License is distributed on an "AS IS" BASIS,
# WITHOUT WARRANTIES OR CONDITIONS OF ANY KIND, either express or implied.
# See the License for the specific language governing permissions and
# limitations under the License.

"""What recording the program's spans costs a decode window, on one GPU.

Run from the root of a checkout::

  python3 tools/recording_cost.py --workload gn_decode_b384 [--seed N]
      [--seconds 10] [--rounds 2]

Sets up the benchmark cell once (``portbench/``: its weights, pool and
warm-up from ``--seed``), then measures its decode window of ``--seconds``
with ``utils/profiling.recording()`` off and on, in the order off, on, on,
off per round, on the same session. Prints the card's name and power
limit, one line per window (frames/s, calls, spans recorded) and one JSON
object: each side's rates and medians, and the change of the median with
recording on, in %.
"""

import argparse
import json
import pathlib
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent


def main() -> int:
  parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  parser.add_argument('--workload', required=True)
  parser.add_argument('--seed', type=int, default=2**31 + 2024)
  parser.add_argument('--seconds', type=float, default=10.0)
  parser.add_argument('--rounds', type=int, default=2)
  args = parser.parse_args()
  sys.path.insert(0, str(ROOT))
  import torch

  from last_torch_tpu_torch.utils import profiling
  from portbench.harness import spec
  if not torch.cuda.is_available():
    print('no CUDA device is available', file=sys.stderr)
    return 3
  card = subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit',
       '--format=csv,noheader'], capture_output=True, text=True).stdout
  print(f'card: {card.strip()}', flush=True)
  cell = spec.load_cell(args.workload, ROOT)
  driver = spec.driver(cell)
  session = driver.setup(cell, args.seed, torch.device('cuda'))
  rates = {'off': [], 'on': []}
  for _ in range(args.rounds):
    for side in ('off', 'on', 'on', 'off'):
      session.calls = []
      recorded = 0
      if side == 'on':
        with profiling.recording() as record:
          window = driver.window(session, args.seconds)
        recorded = len(record.spans)
      else:
        window = driver.window(session, args.seconds)
      rate = window['metrics']['decode_frames_per_s']['value']
      rates[side].append(rate)
      print(f'{side}: {rate!r} frames/s, {window["units"]} calls, '
            f'{recorded} spans recorded', flush=True)
  medians = {side: statistics.median(values) for side, values in
             rates.items()}
  print(json.dumps({'workload': args.workload, 'seed': args.seed,
                    'rates': rates, 'medians': medians,
                    'on_vs_off_pct': 100 * (medians['on'] / medians['off']
                                            - 1)}), flush=True)
  return 0


if __name__ == '__main__':
  sys.exit(main())
