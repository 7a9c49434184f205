"""Tiny copies of the benchmark's cells for runs on the CPU: the same
drivers, reference and comparison, at widths and lengths a test holds."""

from __future__ import annotations

import copy
import pathlib

from portbench.harness import spec

ROOT = pathlib.Path(__file__).resolve().parent.parent.parent

TINY_CONFIG = dict(feature_size=8, vocab_size=6, encoder_size=16,
                   encoder_layers=1, encoder_heads=2, encoder_ffn_size=32,
                   hidden_size=16, embedding_size=16)


def shrink(cell: spec.Cell) -> spec.Cell:
  """``cell`` at tiny widths, batches and lengths; its limits kept."""
  cell = copy.deepcopy(cell)
  cell.config.update(TINY_CONFIG)
  cell.traffic.update(batch=3, max_frames=24, pool=5, check_utterances=4,
                      profile_batches=2)
  cell.traffic['lengths'].update(low=10, high=24)
  return cell


def cell(name: str, root: pathlib.Path = ROOT) -> spec.Cell:
  return shrink(spec.load_cell(name, root))
