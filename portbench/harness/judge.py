"""The arithmetic of the correctness comparison: the worst gap between the
program's readings and the reference's, and the verdict against each
limit."""

from __future__ import annotations

import math


def worst(values) -> float:
  """The largest of the values, NaN where any is NaN."""
  out = -math.inf
  for value in values:
    value = float(value)
    if math.isnan(value):
      return math.nan
    out = max(out, value)
  return out


def verdict(numbers: list[dict]) -> bool:
  """Whether every number lies at or under its limit (NaN never does)."""
  return all(n['value'] <= n['limit'] for n in numbers)


def number(name: str, value: float, limits: dict) -> dict:
  return {'name': name, 'value': float(value),
          'limit': float(limits[name]['limit'])}
