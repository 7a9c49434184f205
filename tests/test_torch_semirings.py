"""The port's semirings against the JAX package's.

Mirrors ``test_semirings.py`` and ``test_semiring_axioms.py`` for Real, Log
and MaxTropical: the same checks on the port, values and gradients held to
the JAX package on the same numpy inputs (float32, rtol 1e-6: the same
elementwise arithmetic), and the safe-gradient contracts pinned exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

from last_torch_tpu import semirings as jax_semirings
from last_torch_tpu_torch import semirings

torch.set_num_threads(1)

NAMES = ['real', 'log', 'max_tropical']
PORT = {'real': semirings.Real, 'log': semirings.Log,
        'max_tropical': semirings.MaxTropical}
REFERENCE = {'real': jax_semirings.Real, 'log': jax_semirings.Log,
             'max_tropical': jax_semirings.MaxTropical}
INF = float('inf')


def t(x):
  return torch.tensor(np.asarray(x, np.float32))


def grad_of(fn, x):
  x = t(x).requires_grad_()
  fn(x).sum().backward()
  return x.grad.numpy()


def test_value_helpers():
  assert semirings.value_shape(torch.zeros([1, 2])) == (1, 2)
  assert semirings.value_shape(
      (torch.zeros([1, 2]), torch.zeros([1, 2]))) == (1, 2)
  assert semirings.value_shape({'a': torch.zeros([])}) == ()
  with pytest.raises(ValueError, match='common shape'):
    semirings.value_shape((torch.zeros([1, 2]), torch.zeros([2, 1])))
  with pytest.raises(ValueError, match='empty'):
    semirings.value_shape(())
  value = (torch.zeros([2]), torch.zeros([2], dtype=torch.int32))
  assert semirings.value_dtype(value) == (torch.float32, torch.int32)
  cond = torch.tensor([True, False])
  picked = semirings.where(cond, (t([1, 2]), t([3, 4])),
                           (t([5, 6]), t([7, 8])))
  npt.assert_array_equal(picked[0].numpy(), [1, 6])
  npt.assert_array_equal(picked[1].numpy(), [3, 8])
  stacked = semirings.stack([t([1, 2]), t([3, 4])], axis=1)
  npt.assert_array_equal(stacked.numpy(), [[1, 3], [2, 4]])


@pytest.mark.parametrize('name', NAMES)
def test_zero_one_and_ops_match_jax(name):
  port, reference = PORT[name], REFERENCE[name]
  rng = np.random.default_rng(0)
  a = rng.uniform(size=(3, 2)).astype(np.float32)
  b = rng.uniform(size=(3, 2)).astype(np.float32)
  zeros, ones = port.zeros((3, 2)), port.ones((3, 2))
  npt.assert_array_equal(zeros.numpy(), np.asarray(reference.zeros((3, 2))))
  npt.assert_array_equal(ones.numpy(), np.asarray(reference.ones((3, 2))))
  # a + 0 = a, a * 1 = a, a * 0 = 0, also against scalar zeros and ones.
  npt.assert_allclose(port.plus(t(a), zeros).numpy(), a)
  npt.assert_allclose(port.times(t(a), ones).numpy(), a)
  npt.assert_array_equal(port.times(t(a), zeros).numpy(), zeros.numpy())
  npt.assert_allclose(port.plus(t(a), port.zeros([])).numpy(), a)
  npt.assert_allclose(port.times(t(a), port.ones([])).numpy(), a)
  for op in ('plus', 'times'):
    npt.assert_allclose(getattr(port, op)(t(a), t(b)).numpy(),
                        np.asarray(getattr(reference, op)(a, b)), rtol=1e-6)
  for op in ('sum', 'prod'):
    for axis in (0, 1, -1):
      npt.assert_allclose(getattr(port, op)(t(a), axis).numpy(),
                          np.asarray(getattr(reference, op)(a, axis)),
                          rtol=1e-6)


@pytest.mark.parametrize('name', NAMES)
def test_sum_axis(name):
  semiring = PORT[name]
  x = t(np.random.default_rng(1).uniform(size=(2, 3, 4)))
  for axis in [0, 1, 2, -1, -2, -3]:
    expected = list(x.shape)
    expected.pop(axis if axis >= 0 else axis + 3)
    assert tuple(semiring.sum(x, axis).shape) == tuple(expected)
  with pytest.raises(ValueError, match='Invalid reduction axis'):
    semiring.sum(x, 3)
  with pytest.raises(ValueError, match='Invalid reduction axis'):
    semiring.sum(x, -4)
  with pytest.raises(ValueError, match='Only int axis'):
    semiring.sum(x, (0, 1))


@pytest.mark.parametrize('name', ['log', 'max_tropical'])
def test_sum_empty_axis_is_zeros(name):
  semiring = PORT[name]
  npt.assert_array_equal(semiring.sum(torch.zeros([0, 3]), 0).numpy(),
                         semiring.zeros([3]).numpy())
  npt.assert_array_equal(semiring.sum(torch.zeros([2, 0]), 1).numpy(),
                         semiring.zeros([2]).numpy())


def test_log_plus_gradients_match_jax_under_broadcasting():
  a = np.array([0.5, 1.0], np.float32)
  b = np.array([[0.1], [2.0]], np.float32)
  ta, tb = t(a).requires_grad_(), t(b).requires_grad_()
  semirings.Log.plus(ta, tb).sum().backward()
  ga, gb = jax.grad(lambda x, y: jnp.sum(jax_semirings.Log.plus(x, y)),
                    argnums=(0, 1))(a, b)
  npt.assert_allclose(ta.grad.numpy(), np.asarray(ga), rtol=1e-6)
  npt.assert_allclose(tb.grad.numpy(), np.asarray(gb), rtol=1e-6)


def test_log_safe_gradients():
  """The -inf/+inf contract of ``test_semirings.test_log_safe_gradients``."""
  lse = lambda x: semirings.Log.sum(x, 0)
  npt.assert_array_equal(grad_of(lse, [-INF, -INF]), [0., 0.])
  assert lse(t([-INF, -INF])).item() == -INF
  npt.assert_allclose(grad_of(lse, [0., -INF]), [1., 0.])
  assert lse(t([INF, INF])).item() == INF
  assert np.all(np.isnan(grad_of(lse, [INF, INF])))
  g = grad_of(lse, [1.0, INF])
  assert g[0] == 0. and np.isnan(g[1])
  g = grad_of(lse, [-INF, INF])
  assert g[0] == 0. and np.isnan(g[1])
  # Binary plus, same contract; plain torch.logaddexp gives NaN here.
  plus = lambda x: semirings.Log.plus(x[0], x[1])
  npt.assert_array_equal(grad_of(plus, [-INF, -INF]), [0., 0.])
  npt.assert_allclose(grad_of(plus, [0., -INF]), [1., 0.])
  assert np.all(np.isnan(grad_of(lambda x: torch.logaddexp(x[0], x[1]),
                                 [-INF, -INF])))


def test_max_tropical_tie_breaking_matches_jax():
  lse = lambda x: semirings.MaxTropical.sum(x, 0)
  npt.assert_array_equal(grad_of(lse, [1., 3., 2.]), [0., 1., 0.])
  for x in ([3., 3., 3.], [1., 2., 2.]):
    npt.assert_array_equal(
        grad_of(lse, x),
        np.asarray(jax.grad(lambda a: jax_semirings.MaxTropical.sum(a, 0))(
            np.asarray(x, np.float32))))
  # Binary plus: exactly one side gets the gradient, the first on a tie.
  g = grad_of(lambda x: semirings.MaxTropical.plus(x[0], x[1]), [2., 2.])
  npt.assert_array_equal(g, [1., 0.])
  # Multi-axis: each output picks exactly one input.
  g = grad_of(lambda x: semirings.MaxTropical.sum(x, 1),
              [[1., 1.], [2., 0.]])
  npt.assert_array_equal(g, [[1., 0.], [1., 0.]])


def random_value(semiring, rng, shape, zero_prob=0.2):
  """A random value of ``shape`` with some exact semiring zeros mixed in."""
  mask = torch.from_numpy(rng.uniform(size=shape) < zero_prob)
  values = t(rng.standard_normal(shape) * 2.0)
  return torch.where(mask, semiring.zeros(shape), values)


@pytest.mark.parametrize('name', NAMES)
@pytest.mark.parametrize('seed', [0, 1, 2])
def test_axioms(name, seed):
  semiring = PORT[name]
  shape = (3, 4)
  rng = np.random.default_rng(seed)
  x, y, z = (random_value(semiring, rng, shape) for _ in range(3))
  zeros, ones = semiring.zeros(shape), semiring.ones(shape)
  close = lambda a, b, tol=1e-5: npt.assert_allclose(
      a.numpy(), b.numpy(), rtol=tol, atol=tol)
  close(semiring.plus(semiring.plus(x, y), z),
        semiring.plus(x, semiring.plus(y, z)))
  close(semiring.plus(x, y), semiring.plus(y, x))
  close(semiring.plus(x, zeros), x)
  close(semiring.times(semiring.times(x, y), z),
        semiring.times(x, semiring.times(y, z)))
  close(semiring.times(x, ones), x)
  close(semiring.times(ones, x), x)
  close(semiring.times(x, zeros), zeros)
  close(semiring.times(x, semiring.plus(y, z)),
        semiring.plus(semiring.times(x, y), semiring.times(x, z)), 1e-4)


@pytest.mark.parametrize('name', NAMES)
def test_sum_and_prod_match_folds(name):
  semiring = PORT[name]
  x = random_value(semiring, np.random.default_rng(5), (5, 3))
  folded_sum, folded_prod = x[0], x[0]
  for row in x[1:]:
    folded_sum = semiring.plus(folded_sum, row)
    folded_prod = semiring.times(folded_prod, row)
  npt.assert_allclose(semiring.sum(x, 0).numpy(), folded_sum.numpy(),
                      rtol=1e-4, atol=1e-4)
  npt.assert_allclose(semiring.prod(x, 0).numpy(), folded_prod.numpy(),
                      rtol=1e-4, atol=1e-4)
