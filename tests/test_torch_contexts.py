"""The port's NextStateTable against the JAX package's.

The same numpy tables and weights through both packages, float32:
transitions and state walks exactly; ``forward_reduce`` under Log,
MaxTropical and Real on the dense one-hot route (densified FullNGram(2, 1),
a small random DFA) and on the sorted segment route (densified
FullNGram(32, 2), S = 1057; a random DFA with a skewed in-degree), values to
rtol 1e-5 (the same reductions, summed in another order) and gradients to
1e-5 of their largest; ``backward_broadcast`` exactly. A state with no
incoming arc reduces to the semiring zero with finite (zero) gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

from last_torch_tpu import contexts as jax_contexts
from last_torch_tpu import semirings as jax_semirings
from last_torch_tpu_torch import contexts, semirings

torch.set_num_threads(1)

SEMIRINGS = {'log': (semirings.Log, jax_semirings.Log),
             'max_tropical': (semirings.MaxTropical,
                              jax_semirings.MaxTropical),
             'real': (semirings.Real, jax_semirings.Real)}


def random_dfa(seed, num_states, vocab_size):
  """A random table whose destinations pile onto state 1 (skewed in-degree)
  and never reach the last state; state 0 (the start) keeps its in-degree
  0."""
  rng = np.random.default_rng(seed)
  table = np.ones((num_states, vocab_size), np.int32)
  for _ in range(num_states * 2):
    table[rng.integers(num_states), rng.integers(vocab_size)] = (
        rng.integers(1, num_states - 1))
  return table


TABLES = {
    # name: (table, route)
    'fullngram_2_1': (
        np.asarray(jax_contexts.FullNGram(2, 1).next_state_table()), 'dense'),
    'random_6x4': (random_dfa(1, 6, 4), 'dense'),
    'fullngram_32_2': (
        np.asarray(jax_contexts.FullNGram(32, 2).next_state_table()),
        'gather'),
    'random_40x50': (random_dfa(2, 40, 50), 'gather'),
}


def both(table):
  return contexts.NextStateTable(table), jax_contexts.NextStateTable(
      jnp.asarray(table))


@pytest.mark.parametrize('bad,match', [
    (np.zeros([2, 2, 2], np.int32), 'next_state_table should have shape'),
    (np.zeros([0, 2], np.int32), 'non-zero size'),
    (np.zeros([2, 2], np.float32), 'int32'),
], ids=['rank3', 'empty', 'float'])
def test_validation_matches_jax(bad, match):
  with pytest.raises(ValueError, match=match):
    jax_contexts.NextStateTable(jnp.asarray(bad))
  with pytest.raises(ValueError, match=match):
    contexts.NextStateTable(bad)
  with pytest.raises(ValueError, match=match):
    contexts.NextStateTable(torch.from_numpy(bad))


def test_table_types_convert_as_jax():
  table = np.asarray([[1, 2], [2, 0], [0, 1]], np.int64)
  port, ref = both(table)
  assert port.next_state_table.dtype == torch.int32
  assert ref.next_state_table.dtype == jnp.int32
  from_tensor = contexts.NextStateTable(torch.from_numpy(table))
  assert torch.equal(from_tensor.next_state_table, port.next_state_table)
  assert port.shape() == ref.shape() == (3, 2) and port.start() == 0


@pytest.mark.parametrize('name', sorted(TABLES))
def test_next_state_and_walk_states_match_jax(name):
  table, _ = TABLES[name]
  port, ref = both(table)
  num_states, vocab_size = table.shape
  rng = np.random.default_rng(3)
  state = rng.integers(0, num_states, size=(4, 5)).astype(np.int32)
  label = rng.integers(0, vocab_size + 1, size=(4, 5)).astype(np.int32)
  label[0] = 0  # epsilon stays in place
  got = port.next_state(torch.from_numpy(state), torch.from_numpy(label))
  npt.assert_array_equal(got.numpy(), np.asarray(ref.next_state(
      jnp.asarray(state), jnp.asarray(label))))
  npt.assert_array_equal(got[0].numpy(), state[0])
  labels = rng.integers(0, vocab_size + 1, size=(3, 7)).astype(np.int32)
  walked = port.walk_states(torch.from_numpy(labels))
  assert walked.dtype == torch.int32
  npt.assert_array_equal(walked.numpy(),
                         np.asarray(ref.walk_states(jnp.asarray(labels))))


def masked_sum(x, cot, lib):
  """sum(x * cot) over the finite entries of x (a state with no incoming
  arc reduces to -inf in Log and MaxTropical)."""
  if lib is torch:
    return torch.where(torch.isfinite(x), x * cot, 0.0).sum()
  return jnp.sum(jnp.where(jnp.isfinite(x), x * cot, 0.0))


@pytest.mark.parametrize('semiring', sorted(SEMIRINGS))
@pytest.mark.parametrize('name', sorted(TABLES))
def test_forward_reduce_matches_jax(name, semiring):
  table, route = TABLES[name]
  port, ref = both(table)
  num_states, vocab_size = table.shape
  assert (num_states * vocab_size * num_states <= 1 << 16) == (
      route == 'dense')
  sr, jax_sr = SEMIRINGS[semiring]
  rng = np.random.default_rng(4)
  weights = rng.standard_normal((2, num_states, vocab_size)).astype(
      np.float32)
  cot = rng.standard_normal((2, num_states)).astype(np.float32)

  leaf = torch.from_numpy(weights).requires_grad_(True)
  got = port.forward_reduce(leaf, sr)
  masked_sum(got, torch.from_numpy(cot), torch).backward()
  want = np.asarray(ref.forward_reduce(jnp.asarray(weights), jax_sr))
  want_grad = np.asarray(jax.grad(
      lambda w: masked_sum(ref.forward_reduce(w, jax_sr), cot, jnp))(
          jnp.asarray(weights)))
  npt.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=1e-6)
  scale = np.abs(want_grad).max()
  assert np.abs(leaf.grad.numpy() - want_grad).max() <= 1e-5 * scale


@pytest.mark.parametrize('name', sorted(TABLES))
def test_backward_broadcast_matches_jax(name):
  table, _ = TABLES[name]
  port, ref = both(table)
  rng = np.random.default_rng(5)
  weights = rng.standard_normal((3, table.shape[0])).astype(np.float32)
  got = port.backward_broadcast(torch.from_numpy(weights))
  assert tuple(got.shape) == (3,) + table.shape
  npt.assert_array_equal(got.numpy(), np.asarray(
      ref.backward_broadcast(jnp.asarray(weights))))


@pytest.mark.parametrize('semiring', ['log', 'max_tropical'])
@pytest.mark.parametrize('name', ['fullngram_2_1', 'random_40x50'])
def test_in_degree_zero_gives_the_zero_with_finite_gradients(name, semiring):
  table, _ = TABLES[name]
  port = contexts.NextStateTable(table)
  sr = SEMIRINGS[semiring][0]
  num_states, vocab_size = table.shape
  in_degree = np.bincount(table.reshape(-1), minlength=num_states)
  assert in_degree[0] == 0
  weights = torch.from_numpy(np.random.default_rng(6).standard_normal(
      (num_states, vocab_size)).astype(np.float32)).requires_grad_(True)
  out = port.forward_reduce(weights, sr)
  assert bool(torch.all(out[in_degree == 0] == float('-inf')))
  assert bool(torch.all(torch.isfinite(out[in_degree > 0])))
  # The unmasked sum: the -inf states' cotangents must not poison the rest.
  out.sum().backward()
  assert bool(torch.all(torch.isfinite(weights.grad)))
  if semiring == 'log':  # each source arc's posterior within its state
    dest = torch.from_numpy(table.astype(np.int64))
    sums = torch.zeros(num_states).index_add_(
        0, dest.reshape(-1), weights.grad.reshape(-1))
    npt.assert_allclose(sums.numpy(), (in_degree > 0).astype(np.float32),
                        rtol=1e-5)


def test_densified_bigram_matches_full_ngram():
  ngram = contexts.FullNGram(vocab_size=5, context_size=1)
  table = contexts.NextStateTable(ngram.next_state_table())
  weights = torch.randn(2, 6, 5, generator=torch.Generator().manual_seed(0))
  for sr in (semirings.Log, semirings.MaxTropical, semirings.Real):
    npt.assert_allclose(table.forward_reduce(weights, sr).numpy(),
                        ngram.forward_reduce(weights, sr).numpy(), rtol=1e-6)
  beta = torch.randn(2, 6, generator=torch.Generator().manual_seed(1))
  npt.assert_array_equal(table.backward_broadcast(beta).numpy(),
                         ngram.backward_broadcast(beta).numpy())
  labels = torch.tensor([[1, 0, 5, 2, 0]])
  npt.assert_array_equal(table.walk_states(labels).numpy(),
                         ngram.walk_states(labels).numpy())


@pytest.mark.parametrize('context_size', [0, 1, 2])
def test_full_ngram_walk_states_and_backward_broadcast_match_jax(
    context_size):
  """FullNGram's closed forms (a cummax walk and an expanded broadcast row
  at context_size <= 1) equal the JAX package's exactly."""
  port = contexts.FullNGram(vocab_size=4, context_size=context_size)
  ref = jax_contexts.FullNGram(vocab_size=4, context_size=context_size)
  rng = np.random.default_rng(7)
  labels = rng.integers(0, 5, size=(3, 2, 9)).astype(np.int32)
  labels[0, 0] = 0  # no lexical label at all
  walked = port.walk_states(torch.from_numpy(labels))
  assert walked.dtype == torch.int32
  npt.assert_array_equal(walked.numpy(), np.asarray(
      ref.walk_states(jnp.asarray(labels))))
  weights = rng.standard_normal((3, 2, port.num_states())).astype(np.float32)
  got = port.backward_broadcast(torch.from_numpy(weights))
  assert tuple(got.shape) == (3, 2) + port.shape()
  npt.assert_array_equal(got.numpy(), np.asarray(
      ref.backward_broadcast(jnp.asarray(weights))))
