"""Closed-loop batch decoding of a Conformer GNAT: ``GNATModel.decode`` on a
pool of batches, one batch in flight, each call ending in a synchronize, as
``drivers/decode.py`` runs it, whose session, window and profile this
driver takes.

Set-up makes the model and stops at once, naming the cause, where the
program builds another encoder than its ``ConformerEncoder`` for the
configuration (a program without one cannot run the cell). Then the
benchmark's seeded Conformer weights (``harness/conformer_weights.py``),
the pool and ``warmup_batches`` decodes. The window's rate counts the real
input frames (10 ms each): audio decoded a second. Once it has closed,
every output's form is checked over the encoder's output frames (``slots
x T'``, T' = ((n - 1) // 2 - 1) // 2), and a sample of the utterances
decoded, drawn from the seed and always holding the longest, is compared
with ``reference/conformer_gnat.py``'s decode of the same weights and
frames: ``weight_gap`` and ``rescore_gap`` as ``drivers/decode.py``
reads them.

The control (the reference in the configuration's ``controls`` precision,
the encoder in TF32, in the program's place) is this driver's own, since
``calibrate.py``'s is the Transformer's:

  python3 -m portbench.drivers.conformer_decode --workload <name> \
      --control-seeds <n> ... [--seconds <s>] [--out <file.jsonl>]

from the root of a checkout, on the card; one JSON line per seed.
"""

from __future__ import annotations

import argparse
import importlib
import json
import pathlib
import sys
import time

import torch

from portbench.drivers import decode as base
from portbench.harness import conformer_weights, judge, port, traffic
from portbench.reference import conformer_gnat as reference

ROOT = pathlib.Path(__file__).resolve().parent.parent.parent

window = base.window
profile = base.profile


def conformer_model(cell, device):
  """The program's model for the cell; exits naming the cause where its
  encoder is not the program's ``ConformerEncoder``."""
  model = port.gnat().GNATModel(port.model_config(cell.config), device=device)
  encoder_lib = importlib.import_module(f'{port.PORT}.models.encoder')
  conformer = getattr(encoder_lib, 'ConformerEncoder', None)
  if conformer is None or not isinstance(model.encoder, conformer):
    raise SystemExit(
        f'{cell.name}: the program built a {type(model.encoder).__name__} '
        f'for encoder_kind {cell.config["encoder_kind"]!r}, not a '
        'ConformerEncoder: it cannot run this configuration')
  return model


def setup(cell, seed: int, device: torch.device) -> base.Session:
  model = conformer_model(cell, device)
  generator = torch.Generator(device).manual_seed(seed)
  params = conformer_weights.make(cell.config, generator, device)
  pool = traffic.make_pool(cell.traffic, cell.config, seed, device)
  session = base.Session(cell, device, model, params, pool)
  for _ in range(cell.traffic['warmup_batches']):
    session.decode()
  port.sync(device)
  return session


def compare(cell, params, batch, labels, path_weights,
            head_dtype) -> tuple[float, float]:
  """(weight gap, rescore gap) of decoded utterances against the
  reference's decode of the same weights and frames, each over max(1,
  |best|), as ``drivers/decode.py::compare``."""
  best, _, rescored = reference.decode(cell.config, params, batch.frames,
                                       batch.num_frames, head_dtype,
                                       labels=labels)
  scale = best.double().abs().clamp(min=1.0)
  path_weights = path_weights.double()
  return (judge.worst(((path_weights - best.double()).abs() / scale).tolist()),
          judge.worst(((path_weights - rescored).abs() / scale).tolist()))


def check(session: base.Session, seed: int) -> list[dict]:
  """The form of every output over the encoder's frames, then the sampled
  utterances against the reference once the program's model is dropped."""
  cell = session.cell
  config = cell.config
  slots = config['max_expansions'] + 1
  bad = 0
  for index, output in session.calls:
    frames = reference.output_frames(session.pool[index].num_frames)
    bad += int(base.malformed(output, frames, slots,
                              config['vocab_size']).sum())
  session.failed = bad
  batch, labels, path_weights = base.sampled(session, seed)
  base.release(session)
  weight_gap, rescore_gap = compare(cell, session.params, batch, labels,
                                    path_weights,
                                    port.head_dtype(config, session.device))
  limits = cell.limits
  return [judge.number('malformed', bad, limits),
          judge.number('weight_gap', weight_gap, limits),
          judge.number('rescore_gap', rescore_gap, limits)]


def control_decode(cell, seed: int, device: torch.device, control: dict,
                   seconds: float) -> list[dict]:
  """The reference in the control's precision (``encoder_precision``
  'tf32' runs its encoder in TF32; ``head_dtype`` its Viterbi heads) in the
  program's place, on the utterances a run of ``seed`` would compare."""
  session = setup(cell, seed, device)
  window(session, seconds)
  batch, _, _ = base.sampled(session, seed)
  base.release(session)
  best, path, _ = reference.decode(
      cell.config, session.params, batch.frames, batch.num_frames,
      getattr(torch, control['head_dtype']),
      tf32=control.get('encoder_precision') == 'tf32', with_path=True)
  gaps = compare(cell, session.params, batch, path, best,
                 port.head_dtype(cell.config, device))
  return [{'name': 'weight_gap', 'value': gaps[0]},
          {'name': 'rescore_gap', 'value': gaps[1]}]


def main(argv=None) -> int:
  parser = argparse.ArgumentParser(
      description='The control readings of a conformer_decode cell.')
  parser.add_argument('--workload', required=True)
  parser.add_argument('--control-seeds', type=int, nargs='+', required=True)
  parser.add_argument('--seconds', type=float, default=5.0)
  parser.add_argument('--out', default=None)
  args = parser.parse_args(argv)
  from portbench.harness import spec
  cell = spec.load_cell(args.workload, ROOT)
  control = cell.config['controls'][cell.traffic['driver']]
  device = torch.device('cuda')
  out = open(args.out, 'a', encoding='utf-8') if args.out else None
  for seed in args.control_seeds:
    started = time.perf_counter()
    numbers = control_decode(cell, seed, device, control, args.seconds)
    torch.cuda.empty_cache()
    line = json.dumps({'workload': cell.name, 'side': 'control',
                       'control': control, 'seed': seed,
                       'numbers': {n['name']: n['value'] for n in numbers},
                       'seconds': time.perf_counter() - started})
    print(line, flush=True)
    if out:
      out.write(line + '\n')
      out.flush()
  return 0


if __name__ == '__main__':
  sys.exit(main())
