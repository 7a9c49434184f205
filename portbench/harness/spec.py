"""Finds a cell's pieces by name: its configuration, traffic mix, limits,
metrics and driver.

Everything that belongs to one configuration, traffic mix, per-layer metric
or cell is a file of its own under the benchmark's folder, found from the
names in ``BENCHMARK.json``:

- ``configs/<config>.json`` (the entry's ``file``): the sizes as run;
- ``traffic/<traffic>.json``: the mix's parameters, read by
  ``harness/traffic.py``; its ``driver`` names ``drivers/<driver>.py``;
- ``metrics/<metric>.py``: the reader of one per-layer metric;
- ``limits/<workload>.json``: the limit of each number the cell's
  correctness comparison reads.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib
import sys
from typing import Any

BENCH_DIR = pathlib.Path(__file__).resolve().parent.parent


@dataclasses.dataclass
class Cell:
  """One entry of ``workloads`` with everything it names."""
  root: pathlib.Path
  bench_dir: pathlib.Path
  name: str
  chips: int
  config: dict[str, Any]
  traffic: dict[str, Any]
  limits: dict[str, Any]
  end_to_end: list[dict[str, Any]]
  per_layer: list[dict[str, Any]]


def read_json(path: pathlib.Path) -> Any:
  with open(path, encoding='utf-8') as f:
    return json.load(f)


def metric_applies(metric: dict, cell_name: str, cell_end_to_end) -> bool:
  """A metric with ``workloads`` applies to the cells it lists; one without
  to every cell (end-to-end) or every cell that reports the end-to-end
  metric it moves (per-layer)."""
  if 'workloads' in metric:
    return cell_name in metric['workloads']
  return 'moves' not in metric or metric['moves'] in cell_end_to_end


def load_cell(name: str, root: pathlib.Path,
              bench_dir: pathlib.Path = BENCH_DIR) -> Cell:
  """The cell ``name`` of ``root/BENCHMARK.json``."""
  bench = read_json(root / 'BENCHMARK.json')
  cells = {w['name']: w for w in bench['workloads']}
  if name not in cells:
    raise KeyError(f'no workload {name!r} in BENCHMARK.json (has '
                   f'{sorted(cells)})')
  cell = cells[name]
  configs = {c['name']: c for c in bench['configs']}
  config = read_json(root / configs[cell['config']]['file'])
  traffic = read_json(bench_dir / 'traffic' / f'{cell["traffic"]}.json')
  limits = read_json(bench_dir / 'limits' / f'{name}.json')
  end_to_end = [m for m in bench['end_to_end']
                if metric_applies(m, name, ())]
  names = {m['name'] for m in end_to_end}
  per_layer = [m for m in bench['per_layer']
               if metric_applies(m, name, names)]
  return Cell(root, bench_dir, name, cell['chips'], config, traffic, limits,
              end_to_end, per_layer)


def load_module(path: pathlib.Path, name: str):
  """Imports the Python file ``path`` as module ``name``."""
  spec = importlib.util.spec_from_file_location(name, path)
  module = importlib.util.module_from_spec(spec)
  sys.modules[name] = module
  spec.loader.exec_module(module)
  return module


def driver(cell: Cell):
  """The module ``drivers/<traffic['driver']>.py``."""
  kind = cell.traffic['driver']
  return load_module(cell.bench_dir / 'drivers' / f'{kind}.py',
                     f'portbench_driver_{kind}')


def metric_reader(cell: Cell, metric_name: str):
  """The ``read`` function of ``metrics/<metric_name>.py``."""
  module = load_module(cell.bench_dir / 'metrics' / f'{metric_name}.py',
                       'portbench_metric_' + metric_name.replace('.', '_'))
  return module.read
