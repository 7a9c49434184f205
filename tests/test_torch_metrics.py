"""The port's edit distance, error-rate accumulator and
``risk.labels_from_alignment`` against the JAX package.

Integers, so everything is held exactly: random ragged label sequences made
from a seed with numpy (every padding width, empty hypotheses and
references, garbage past the counts, two batch dimensions) go through
``last_torch_tpu.models.metrics`` / ``last_torch_tpu.risk`` and their
counterparts in the port.
"""

import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

from last_torch_tpu import risk as jax_risk
from last_torch_tpu.models import metrics as jax_metrics
from last_torch_tpu_torch import risk
from last_torch_tpu_torch.models import metrics


def ragged(rng, batch_shape, max_u, max_v, vocab):
  hyp = rng.integers(0, vocab + 1, size=batch_shape + (max_u,))
  ref = rng.integers(1, vocab + 1, size=batch_shape + (max_v,))
  nh = rng.integers(0, max_u + 1, size=batch_shape)
  nr = rng.integers(0, max_v + 1, size=batch_shape)
  return hyp.astype(np.int32), nh.astype(np.int32), ref.astype(
      np.int32), nr.astype(np.int32)


@pytest.mark.parametrize('batch_shape,max_u,max_v,vocab,seed', [
    ((64,), 11, 9, 4, 0),
    ((3, 5), 7, 12, 2, 1),
    ((16,), 1, 5, 3, 2),
    ((16,), 6, 1, 3, 3),
    ((32,), 40, 17, 30, 4),
])
def test_edit_distance_matches_jax(batch_shape, max_u, max_v, vocab, seed):
  inputs = ragged(np.random.default_rng(seed), batch_shape, max_u, max_v,
                  vocab)
  want = np.asarray(jax_metrics.edit_distance(*map(jnp.asarray, inputs)))
  got = metrics.edit_distance(*map(torch.from_numpy, inputs))
  assert got.dtype == torch.int32 and tuple(got.shape) == batch_shape
  npt.assert_array_equal(got.numpy(), want)


def test_edit_distance_with_no_slots():
  # The JAX package cannot reshape a zero-width hypothesis or reference;
  # the distance is then the other's length.
  ref = torch.tensor([[1, 2, 3], [3, 0, 0]])
  out = metrics.edit_distance(torch.zeros((2, 0), dtype=torch.int32),
                              torch.tensor([0, 0]), ref, torch.tensor([3, 1]))
  npt.assert_array_equal(out.numpy(), [3, 1])
  hyp = torch.tensor([[1, 2, 3], [3, 0, 0]])
  out = metrics.edit_distance(hyp, torch.tensor([3, 1]),
                              torch.zeros((2, 0), dtype=torch.int32),
                              torch.tensor([0, 0]))
  npt.assert_array_equal(out.numpy(), [3, 1])


def test_error_rate_accumulation_matches_jax():
  rng = np.random.default_rng(5)
  state = metrics.empty_error_rate_state('cpu')
  jax_state = jax_metrics.empty_error_rate_state()
  for step in range(3):
    inputs = ragged(rng, (6,), 8, 7, 5)
    valid = rng.random(6) < 0.7 if step else None
    state = metrics.update_error_rate(
        state, *map(torch.from_numpy, inputs),
        valid=None if valid is None else torch.from_numpy(valid))
    jax_state = jax_metrics.update_error_rate(
        jax_state, *map(jnp.asarray, inputs),
        valid=None if valid is None else jnp.asarray(valid))
  for got, want in zip(state, jax_state):
    assert got.dtype == torch.int64
    assert int(got) == int(want)
  npt.assert_allclose(float(metrics.error_rate(state)),
                      float(jax_metrics.error_rate(jax_state)), rtol=1e-7)
  merged = state + state
  assert int(merged.total_edits) == 2 * int(state.total_edits)
  empty = metrics.empty_error_rate_state('cpu')
  assert float(metrics.error_rate(empty)) == 0.0


@pytest.mark.parametrize('max_labels', [None, 3, 40])
def test_labels_from_alignment_matches_jax(max_labels):
  rng = np.random.default_rng(6)
  slots = rng.integers(0, 5, size=(4, 3, 24)).astype(np.int32)
  slots[rng.random(slots.shape) < 0.5] = 0
  slots[0, 0] = 0
  labels_j, num_j = jax_risk.labels_from_alignment(jnp.asarray(slots),
                                                   max_labels)
  labels, num = risk.labels_from_alignment(torch.from_numpy(slots),
                                           max_labels)
  assert labels.dtype == torch.int32 and num.dtype == torch.int32
  npt.assert_array_equal(labels.numpy(), np.asarray(labels_j))
  npt.assert_array_equal(num.numpy(), np.asarray(num_j))


def test_row_seeds_are_fixed_and_distinct():
  # The derivation is part of the contract (data-parallel ranks compute it
  # independently): pin it.
  seeds = [risk.row_seed(1234, i) for i in range(1000)]
  assert len(set(seeds)) == 1000
  assert all(0 <= s < 2**64 for s in seeds)
  assert risk.row_seed(0, 0) == 0xe220a8397b1dcdaf
  g = torch.Generator().manual_seed(3)
  rows = risk.per_example_keys(g, 4, offset=2)
  again = risk.per_example_keys(torch.Generator().manual_seed(3), 6)
  for a, b in zip(rows, again[2:]):
    assert torch.equal(torch.rand(5, generator=a), torch.rand(5, generator=b))
