"""The port's tuple-valued semirings against the JAX package's.

The Expectation cases of ``test_semirings.py`` and the axioms of
``test_semiring_axioms.py`` for ``LogLogExpectation`` and ``Cartesian(Log,
Real)``: the same checks on the port, and every value held to the JAX
package's on the same numpy inputs (float32, rtol 1e-6 / atol 1e-6: the
same elementwise arithmetic). ``semirings.cumulative_times`` (the S = 1
route's log-depth product over time) is held to a sequential fold and to
JAX's ``lax.associative_scan`` in every semiring.
"""

import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch
from torch.utils import _pytree as pytree

from last_torch_tpu import semirings as jax_semirings
from last_torch_tpu_torch import semirings

torch.set_num_threads(1)

INF = float('inf')
TUPLES = {
    'log_log_expectation': (semirings.LogLogExpectation,
                            jax_semirings.LogLogExpectation),
    'cartesian_log_real': (semirings.Cartesian(semirings.Log, semirings.Real),
                           jax_semirings.Cartesian(jax_semirings.Log,
                                                   jax_semirings.Real)),
}
ALL = dict(TUPLES, **{
    'real': (semirings.Real, jax_semirings.Real),
    'log': (semirings.Log, jax_semirings.Log),
    'max_tropical': (semirings.MaxTropical, jax_semirings.MaxTropical),
})


def t(x):
  return torch.tensor(np.asarray(x, np.float32))


def to_port(value):
  return pytree.tree_map(t, jax.tree.map(np.asarray, value))


def assert_same(got, want, rtol=1e-6, atol=1e-6):
  """A port value against a JAX value (or two port values), leaf by leaf."""
  got = [np.asarray(x) for x in pytree.tree_leaves(got)]
  want = [np.asarray(x) for x in jax.tree.leaves(want)]
  assert len(got) == len(want)
  for g, w in zip(got, want):
    npt.assert_allclose(g, w, rtol=rtol, atol=atol)


def random_value(name, seed, shape, zero_prob=0.2):
  """The same random value for both packages, with exact semiring zeros."""
  port, _ = ALL[name]
  rng = np.random.default_rng(seed)
  zeros = port.zeros(shape)
  mask = rng.random(shape) < zero_prob
  leaves = [np.where(mask, z.numpy(),
                     rng.normal(size=shape).astype(np.float32) * 2.0)
            for z in pytree.tree_leaves(zeros)]
  return leaves if len(leaves) > 1 else leaves[0]


def as_values(leaves):
  if isinstance(leaves, list):
    return tuple(t(x) for x in leaves), tuple(jnp.asarray(x) for x in leaves)
  return t(leaves), jnp.asarray(leaves)


def test_expectation_weighted_safety():
  """0 * log 0 is zero, not NaN."""
  sr = semirings.LogLogExpectation
  w, v = [-INF, 0.], [INF, 1.]
  got = sr.weighted(t(w), t(v))
  want = jax_semirings.LogLogExpectation.weighted(jnp.asarray(w),
                                                  jnp.asarray(v))
  npt.assert_array_equal(got[0].numpy(), w)
  npt.assert_array_equal(got[1].numpy(), [-INF, 1.])
  assert_same(got, want, rtol=0, atol=0)
  # The lift of the entropy route on a -inf weight leaks no NaN.
  lifted = sr.weighted(t(w), torch.log(torch.clamp(-t(w), min=1e-30)))
  assert not any(bool(torch.isnan(x).any()) for x in lifted)


def test_expectation_entropy():
  """(log p, log p + log(-log p)) summed gives (log Z, log entropy) for a
  normalized distribution."""
  sr = semirings.LogLogExpectation
  p = np.array([0.25, 0.5, 0.25])
  log_p = np.log(p).astype(np.float32)
  got = sr.sum(sr.weighted(t(log_p), torch.log(-t(log_p))), 0)
  want = jax_semirings.LogLogExpectation.sum(
      jax_semirings.LogLogExpectation.weighted(
          jnp.asarray(log_p), jnp.log(-jnp.asarray(log_p))), 0)
  npt.assert_allclose(got[0].numpy(), 0., atol=1e-6)
  npt.assert_allclose(np.exp(got[1].numpy()), -np.sum(p * np.log(p)),
                      rtol=1e-3)
  assert_same(got, want)


def test_expectation_times_product_rule():
  sr = semirings.LogLogExpectation
  a = (np.log(2.0), np.log(3.0))
  b = (np.log(5.0), np.log(7.0))
  w, x = sr.times(tuple(map(t, a)), tuple(map(t, b)))
  npt.assert_allclose(np.exp(w.numpy()), 10.0, rtol=1e-5)
  # w_a x_b + w_b x_a = 2 * 7 + 5 * 3 = 29.
  npt.assert_allclose(np.exp(x.numpy()), 29.0, rtol=1e-5)
  want = jax_semirings.LogLogExpectation.times(
      tuple(jnp.float32(v) for v in a), tuple(jnp.float32(v) for v in b))
  assert_same((w, x), want)


def test_expectation_zeros_ones():
  sr = semirings.LogLogExpectation
  zw, zx = sr.zeros([2])
  npt.assert_array_equal(zw.numpy(), [-INF, -INF])
  npt.assert_array_equal(zx.numpy(), [-INF, -INF])
  ow, ox = sr.ones([2])
  npt.assert_array_equal(ow.numpy(), [0., 0.])
  npt.assert_array_equal(ox.numpy(), [-INF, -INF])
  # A pair of dtypes and one device.
  zeros = sr.zeros((3,), (torch.float64, torch.float32), 'cpu')
  assert [z.dtype for z in zeros] == [torch.float64, torch.float32]
  assert semirings.value_dtype(zeros) == (torch.float64, torch.float32)
  like = semirings.zeros_like(sr, zeros, (1, 2))
  assert semirings.value_shape(like) == (1, 2)
  assert semirings.value_dtype(like) == (torch.float64, torch.float32)


@pytest.mark.parametrize('name', sorted(TUPLES))
@pytest.mark.parametrize('seed', [0, 1, 2])
def test_axioms(name, seed):
  port, ref = TUPLES[name]
  shape = (3, 4)
  (x, xj), (y, yj), (z, zj) = (
      as_values(random_value(name, 10 * seed + i, shape)) for i in range(3))
  zeros, ones = port.zeros(shape), port.ones(shape)
  assert_same(zeros, ref.zeros(shape), rtol=0, atol=0)
  assert_same(ones, ref.ones(shape), rtol=0, atol=0)

  # Each operation against the JAX package's on the same values.
  assert_same(port.plus(x, y), ref.plus(xj, yj))
  assert_same(port.times(x, y), ref.times(xj, yj))

  close = lambda a, b, tol=1e-5: assert_same(a, b, rtol=tol, atol=tol)
  # plus: associative, commutative, identity.
  close(port.plus(port.plus(x, y), z), port.plus(x, port.plus(y, z)))
  close(port.plus(x, y), port.plus(y, x))
  close(port.plus(x, zeros), x)
  # times: associative, identity, annihilation by zeros.
  close(port.times(port.times(x, y), z), port.times(x, port.times(y, z)))
  close(port.times(x, ones), x)
  close(port.times(ones, x), x)
  close(port.times(x, zeros), zeros)
  # distributivity.
  close(port.times(x, port.plus(y, z)),
        port.plus(port.times(x, y), port.times(x, z)), 1e-4)


@pytest.mark.parametrize('name', sorted(TUPLES))
@pytest.mark.parametrize('seed', [0, 1])
def test_sum_and_prod_match_folds(name, seed):
  port, ref = TUPLES[name]
  shape = (5, 3)
  x, xj = as_values(random_value(name, 100 + seed, shape))
  rows = [pytree.tree_map(lambda l, i=i: l[i], x) for i in range(shape[0])]
  folded = rows[0]
  for r in rows[1:]:
    folded = port.plus(folded, r)
  assert_same(port.sum(x, axis=0), folded, rtol=1e-4, atol=1e-4)
  assert_same(port.sum(x, axis=0), ref.sum(xj, axis=0))
  try:
    prod = port.prod(x, axis=0)
  except NotImplementedError:
    # As in the JAX package: the Expectation semiring has no prod.
    with pytest.raises(NotImplementedError):
      ref.prod(xj, axis=0)
    return
  folded = rows[0]
  for r in rows[1:]:
    folded = port.times(folded, r)
  assert_same(prod, folded, rtol=1e-4, atol=1e-4)
  assert_same(prod, ref.prod(xj, axis=0))


@pytest.mark.parametrize('name', sorted(ALL))
@pytest.mark.parametrize('length', [1, 5, 8, 13])
def test_cumulative_times_matches_fold_and_associative_scan(name, length):
  port, ref = ALL[name]
  if name == 'real':
    # Real products of normal draws over 13 steps stay representable but
    # lose relative precision near zero: draw away from it.
    rng = np.random.default_rng(length)
    leaves = (rng.uniform(0.5, 1.5, size=(2, length)) *
              rng.choice([-1, 1], size=(2, length))).astype(np.float32)
  else:
    leaves = random_value(name, length, (2, length))
  x, xj = as_values(leaves)
  got = semirings.cumulative_times(port, x, axis=1)
  want = jax.lax.associative_scan(ref.times, xj, axis=1)
  assert_same(got, want, rtol=1e-5, atol=1e-5)
  folded = pytree.tree_map(lambda l: l[:, 0], x)
  for i in range(length):
    if i:
      folded = port.times(folded, pytree.tree_map(lambda l, i=i: l[:, i], x))
    assert_same(pytree.tree_map(lambda l, i=i: l[:, i], got), folded,
                rtol=1e-5, atol=1e-5)


def test_cumulative_times_gradient_is_the_fold_gradient():
  """Autograd through the doubling steps gives the sequential product's
  gradient (Log: every earlier factor's entry gets 1 per later output)."""
  x = torch.randn(3, 7, requires_grad=True)
  semirings.cumulative_times(semirings.Log, x, axis=1).sum().backward()
  expected = torch.arange(7, 0, -1, dtype=torch.float32).expand(3, 7)
  npt.assert_array_equal(x.grad.numpy(), expected.numpy())
