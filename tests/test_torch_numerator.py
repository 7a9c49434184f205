"""The port's local normalizers and numerator against the JAX package.

The normalizers and ``LocallyNormalizedWeightFn.apply`` are held to JAX at
rtol 1e-5 / atol 1e-6 (float32, summation order only), and stay finite for
blank weights of +-1000. ``LocallyNormalizedWeightFn.label_weights``
through the port's numerator route (the kernels' plain versions on CPU
tensors) is held to JAX's XLA frame-major scan and to JAX's Pallas kernel
in interpret mode, values to rtol/atol 1e-5 and the gradients of every
parameter and frame (torch autograd against ``jax.vjp``, the same numpy
cotangents) to 1e-4 of the largest gradient (float32 both sides, other
summation order); in bfloat16 to the interpret-mode kernel, values to 1e-5
and gradients to 1e-3 of their largest. With two batch dimensions (outside
JAX's kernel gate, so JAX takes its frame-major XLA scan) the port flattens
them into its numerator route, held to JAX alike.
"""

import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch
from torch.utils import _pytree as pytree

from last_torch_tpu import weight_fns as jax_weight_fns
from last_torch_tpu.ops import numerator_scan as jax_numerator_scan
from last_torch_tpu_torch import convert, weight_fns
from last_torch_tpu_torch.ops import numerator_scan

torch.set_num_threads(1)
torch.set_float32_matmul_precision('highest')

NORMALIZERS = {
    'hat': (jax_weight_fns.hat_normalize, weight_fns.hat_normalize),
    'log_softmax': (jax_weight_fns.log_softmax_normalize,
                    weight_fns.log_softmax_normalize),
}
# The JAX kernel needs hidden % 128 == 0; V = 70 is ragged for every tile.
HIDDEN, EMBEDDING, VOCAB, NUM_STATES = 128, 16, 70, 9


@pytest.mark.parametrize('name', sorted(NORMALIZERS))
def test_normalizers_match_jax(name):
  jax_fn, torch_fn = NORMALIZERS[name]
  rng = np.random.default_rng(0)
  blank = rng.standard_normal((5,)).astype(np.float32) * 3
  lexical = rng.standard_normal((5, 8)).astype(np.float32) * 3
  # Large weights: the naive log(1 + exp(b)) overflows here.
  blank[:2] = [1000.0, -1000.0]
  lexical[0, 0], lexical[1, 1] = 1000.0, -1000.0
  want = jax_fn(jnp.asarray(blank), jnp.asarray(lexical))
  got = torch_fn(torch.from_numpy(blank), torch.from_numpy(lexical))
  for g, w in zip(got, want):
    assert torch.isfinite(g).all()
    npt.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)
  total = torch.exp(got[0][2:]) + torch.exp(got[1][2:]).sum(-1)
  npt.assert_allclose(total.numpy(), 1.0, rtol=1e-5)


def make_weight_fns(name, hidden=HIDDEN, vocab=VOCAB):
  jax_fn, torch_fn = NORMALIZERS[name]
  jax_wf = jax_weight_fns.LocallyNormalizedWeightFn(
      jax_weight_fns.JointWeightFn(vocab_size=vocab, hidden_size=hidden),
      normalize=jax_fn)
  torch_wf = weight_fns.LocallyNormalizedWeightFn(
      weight_fns.JointWeightFn(vocab_size=vocab, hidden_size=hidden),
      normalize=torch_fn)
  return jax_wf, torch_wf


def make_inputs(seed, batch_dims, max_t, u1, vocab=VOCAB):
  rng = np.random.default_rng(seed)
  cache = rng.standard_normal((NUM_STATES, EMBEDDING)).astype(np.float32)
  frames = rng.standard_normal(batch_dims + (max_t, 6)).astype(np.float32)
  states = rng.integers(0, NUM_STATES, batch_dims + (u1,)).astype(np.int32)
  # Label 0 (the dummy of the last position) occurs too.
  next_labels = rng.integers(0, vocab + 1,
                             batch_dims + (u1,)).astype(np.int32)
  return cache, frames, states, next_labels


def jax_params(jax_wf, cache, frames, seed):
  params = jax_wf.init(jax.random.PRNGKey(seed), jnp.asarray(cache),
                       jnp.zeros((frames.shape[-1],)))
  params['blank_b'] = jnp.asarray(0.4)
  params['vocab_b'] = jnp.linspace(-1.0, 1.0, params['vocab_b'].shape[0])
  return jax.tree.map(np.asarray, params)


@pytest.mark.parametrize('with_state', [False, True])
@pytest.mark.parametrize('name', sorted(NORMALIZERS))
def test_locally_normalized_apply_matches_jax(name, with_state):
  jax_wf, torch_wf = make_weight_fns(name, hidden=7, vocab=11)
  cache, frames, _, _ = make_inputs(1, (3,), 2, 1, vocab=11)
  params = jax_params(jax_wf, cache, frames, seed=1)
  frame = frames[:, 0]
  state = np.array([0, 4, 8]) if with_state else None
  want = jax_wf.apply(params, cache, frame,
                      None if state is None else jnp.asarray(state))
  got = torch_wf.apply(convert.from_jax_params(params, device='cpu'),
                       torch.from_numpy(cache), torch.from_numpy(frame),
                       None if state is None else torch.from_numpy(state))
  for g, w in zip(got, want):
    assert tuple(g.shape) == w.shape
    npt.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)


def jax_label_weights_vjp(jax_wf, params, cache, frames, states, next_labels,
                          cotangents):
  def fn(params, cache, frames):
    return jax_wf.label_weights(params, cache, frames, jnp.asarray(states),
                                jnp.asarray(next_labels))
  out, vjp = jax.vjp(fn, jax.tree.map(jnp.asarray, params),
                     jnp.asarray(cache), jnp.asarray(frames))
  grads = vjp(tuple(jnp.asarray(c) for c in cotangents))
  return ([np.asarray(x) for x in out],
          jax.tree.map(np.asarray, grads))


def torch_label_weights_grad(torch_wf, params, cache, frames, states,
                             next_labels, cotangents):
  params = convert.from_jax_params(params, device='cpu')
  for leaf in pytree.tree_leaves(params):
    leaf.requires_grad_(True)
  cache = torch.from_numpy(cache).requires_grad_(True)
  frames = torch.from_numpy(frames).requires_grad_(True)
  out = torch_wf.label_weights(params, cache, frames,
                               torch.from_numpy(states),
                               torch.from_numpy(next_labels))
  total = sum((o * torch.from_numpy(c)).sum() for o, c in zip(out,
                                                              cotangents))
  total.backward()
  grads = (pytree.tree_map(lambda x: x.grad.numpy(), params),
           cache.grad.numpy(), frames.grad.numpy())
  return [o.detach().numpy() for o in out], grads


def assert_same_gradients(got, want, rtol=1e-4):
  """Every leaf of (params, cache, frames) to rtol of the largest."""
  want_leaves = jax.tree.leaves(want)
  scale = max(float(np.abs(w).max()) for w in want_leaves)
  got_leaves = [got[0][k] for k in sorted(got[0])] + list(got[1:])
  assert len(got_leaves) == len(want_leaves)
  for g, w in zip(got_leaves, want_leaves):
    npt.assert_allclose(g, w, rtol=0, atol=rtol * scale)


@pytest.mark.parametrize('name', sorted(NORMALIZERS))
@pytest.mark.parametrize('jax_route', ['xla', 'interpret'])
def test_numerator_route_matches_jax(monkeypatch, jax_route, name):
  if jax_route == 'interpret':
    monkeypatch.setattr(jax_numerator_scan, 'FORCE_INTERPRET', True)
  batch, max_t, u1 = 2, 3, 5
  jax_wf, torch_wf = make_weight_fns(name)
  cache, frames, states, next_labels = make_inputs(2, (batch,), max_t, u1)
  params = jax_params(jax_wf, cache, frames, seed=2)
  assert jax_numerator_scan.supported(
      jax_wf.weight_fn, cache, jnp.zeros(frames.shape[:-1] + (HIDDEN,)),
      states, next_labels) == (jax_route == 'interpret')
  rng = np.random.default_rng(3)
  cotangents = [rng.standard_normal((batch, u1, max_t)).astype(np.float32)
                for _ in range(2)]
  cotangents[0][1] = 0.0  # batch row 1: g = 0 for blank ...
  cotangents[1][1] = 0.0  # ... and for the label weights
  want, want_grads = jax_label_weights_vjp(
      jax_wf, params, cache, frames, states, next_labels, cotangents)
  before = numerator_scan.forward_launches, numerator_scan.backward_launches
  got, got_grads = torch_label_weights_grad(
      torch_wf, params, cache, frames, states, next_labels, cotangents)
  assert (numerator_scan.forward_launches,
          numerator_scan.backward_launches) == before  # CPU: plain versions
  for g, w in zip(got, want):
    assert g.shape == (batch, u1, max_t)
    npt.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
  assert_same_gradients(got_grads, want_grads)
  # The zero-cotangent row contributes nothing: its frames' gradient is 0.
  assert np.all(got_grads[2][1] == 0)


@pytest.mark.parametrize('name', sorted(NORMALIZERS))
def test_bf16_numerator_route_matches_jax_kernel(monkeypatch, name):
  """bfloat16 compute: both round the projections' inputs, the joint and
  vocab_w (and ds) at the same points and sum in float32, so values agree
  to 1e-5 of their largest and gradients to 1e-3 of the largest gradient
  (a float32 tanh on either side of a rounding boundary would move one
  joint entry by a bfloat16 step)."""
  monkeypatch.setattr(jax_numerator_scan, 'FORCE_INTERPRET', True)
  batch, max_t, u1 = 2, 3, 4
  jax_fn, torch_fn = NORMALIZERS[name]
  jax_wf = jax_weight_fns.LocallyNormalizedWeightFn(
      jax_weight_fns.JointWeightFn(vocab_size=VOCAB, hidden_size=HIDDEN,
                                   compute_dtype=jnp.bfloat16),
      normalize=jax_fn)
  torch_wf = weight_fns.LocallyNormalizedWeightFn(
      weight_fns.JointWeightFn(vocab_size=VOCAB, hidden_size=HIDDEN,
                               compute_dtype=torch.bfloat16),
      normalize=torch_fn)
  cache, frames, states, next_labels = make_inputs(6, (batch,), max_t, u1)
  params = jax_params(jax_wf, cache, frames, seed=6)
  rng = np.random.default_rng(7)
  cotangents = [rng.standard_normal((batch, u1, max_t)).astype(np.float32)
                for _ in range(2)]
  want, want_grads = jax_label_weights_vjp(
      jax_wf, params, cache, frames, states, next_labels, cotangents)
  got, got_grads = torch_label_weights_grad(
      torch_wf, params, cache, frames, states, next_labels, cotangents)
  for g, w in zip(got, want):
    npt.assert_allclose(g, w, rtol=0, atol=1e-5 * np.abs(w).max())
  assert_same_gradients(got_grads, want_grads, rtol=1e-3)


def test_outside_the_gate_frame_major_route_matches_jax():
  """Two batch dimensions: JAX takes its frame-major scan, the port
  flattens them into one for its numerator route."""
  batch_dims, max_t, u1 = (2, 2), 3, 4
  jax_wf, torch_wf = make_weight_fns('hat', hidden=10, vocab=13)
  cache, frames, states, next_labels = make_inputs(4, batch_dims, max_t, u1,
                                                   vocab=13)
  params = jax_params(jax_wf, cache, frames, seed=4)
  rng = np.random.default_rng(5)
  cotangents = [rng.standard_normal(batch_dims + (u1, max_t)).astype(
      np.float32) for _ in range(2)]
  want, want_grads = jax_label_weights_vjp(
      jax_wf, params, cache, frames, states, next_labels, cotangents)
  got, got_grads = torch_label_weights_grad(
      torch_wf, params, cache, frames, states, next_labels, cotangents)
  for g, w in zip(got, want):
    assert g.shape == batch_dims + (u1, max_t)
    npt.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
  assert_same_gradients(got_grads, want_grads)


def test_numerator_route_with_no_frames():
  """T = 0: empty weights, and the backward gives zero gradients."""
  jax_wf, torch_wf = make_weight_fns('log_softmax', hidden=10, vocab=13)
  cache, frames, states, next_labels = make_inputs(8, (2,), 0, 3, vocab=13)
  params = jax_params(jax_wf, cache, frames, seed=8)
  cotangents = [np.zeros((2, 3, 0), np.float32)] * 2
  got, (param_grads, cache_grad, frames_grad) = torch_label_weights_grad(
      torch_wf, params, cache, frames, states, next_labels, cotangents)
  assert [g.shape for g in got] == [(2, 3, 0)] * 2
  assert frames_grad.shape == frames.shape
  for leaf in list(param_grads.values()) + [cache_grad]:
    assert np.all(leaf == 0)


def test_numerator_rejects_other_compute_types():
  """The kernels and their plain versions round to float32 or bfloat16."""
  torch_wf = weight_fns.LocallyNormalizedWeightFn(
      weight_fns.JointWeightFn(vocab_size=VOCAB, hidden_size=8,
                               compute_dtype=torch.float16))
  jax_wf, _ = make_weight_fns('hat', hidden=8)
  cache, frames, states, next_labels = make_inputs(9, (2,), 3, 4)
  params = convert.from_jax_params(jax_params(jax_wf, cache, frames, seed=9),
                                   device='cpu')
  with pytest.raises(ValueError, match='compute_dtype'):
    torch_wf.label_weights(params, torch.from_numpy(cache),
                           torch.from_numpy(frames), torch.from_numpy(states),
                           torch.from_numpy(next_labels))


def test_other_inner_weight_fns_or_normalizers_have_no_fast_path():
  class Joint(weight_fns.JointWeightFn):
    pass

  args = (None, None, None, None, None)
  assert weight_fns.LocallyNormalizedWeightFn(
      Joint(vocab_size=3, hidden_size=4)).label_weights(*args) is None
  assert weight_fns.LocallyNormalizedWeightFn(
      weight_fns.JointWeightFn(vocab_size=3, hidden_size=4),
      normalize=lambda b, l: (b, l)).label_weights(*args) is None
