"""The benchmark's handles on the program under test: its model built from
a configuration file, its launch counters and its route record.

The program is ``last_torch_tpu_torch`` alone, imported here when a run
starts, never when this module is imported."""

from __future__ import annotations

import dataclasses
import importlib

import torch

PORT = 'last_torch_tpu_torch'


def gnat():
  return importlib.import_module(f'{PORT}.models.gnat')


def model_config(config: dict):
  """The port's GNATConfig from the configuration file's keys."""
  module = gnat()
  names = {f.name for f in dataclasses.fields(module.GNATConfig)}
  return module.GNATConfig(**{k: v for k, v in config.items() if k in names})


def head_dtype(config: dict, device: torch.device) -> torch.dtype:
  """The type the lattice rounds its head products' inputs to: the
  configuration's on the card, float32 where the port runs its plain
  versions (the CPU)."""
  if device.type != 'cuda':
    return torch.float32
  return getattr(torch, config['head_dtype'])


class Counters:
  """The launch counters a route names (``ops.viterbi.launches``, ...),
  read before and after a stretch of calls."""

  def __init__(self, names):
    self.names = list(names)
    self.before = self.read()

  def read(self):
    values = {}
    for name in self.names:
      module, attribute = name.rsplit('.', 1)
      values[name] = getattr(importlib.import_module(f'{PORT}.{module}'),
                             attribute)
    return values

  def moved(self) -> dict:
    now = self.read()
    return {name: now[name] - self.before[name] for name in self.names}


def route_faults(route: dict, counters: Counters, calls: int, lattice,
                 device: torch.device) -> list[str]:
  """What departs from the route the configuration states for these calls:
  the lattice's ``last_path`` ('kernel' on the card is 'plain' on the CPU,
  where the port runs the kernels' plain versions), and each counter's
  launches (on the card, at least one a call)."""
  faults = []
  want = route.get('last_path')
  if want == 'kernel' and device.type != 'cuda':
    want = 'plain'
  if lattice.last_path != want:
    faults.append(f'last_path {lattice.last_path!r}, not {want!r}')
  if device.type == 'cuda':
    for name, launched in counters.moved().items():
      if launched < calls:
        faults.append(f'{name} moved by {launched} over {calls} calls')
  return faults


def sync(device: torch.device):
  if device.type == 'cuda':
    torch.cuda.synchronize()
