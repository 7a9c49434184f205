"""The port's training slice against the JAX package: GNATModel.mean_loss,
the optimizer and the train step.

A small GNATConfig (encoder 2 x 16); JAX parameters from init(PRNGKey),
converted with ``convert.from_jax_params``, and the same numpy features and
labels through both packages. Loss values to rtol 1e-5 / atol 1e-6,
gradients per leaf to 1e-4 of the global gradient scale (float32 both
sides, sums in another order; FrameLabelDependent's ``blank_b`` gradient is
a structural zero made of rounding residue). The optimizer is held to the
optax chain by feeding both the same numpy gradients, so that Adam's
sign-like first step never amplifies rounding residue: updated parameters
to 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import optax
import pytest
import torch
from torch.utils import _pytree as pytree

from last_torch_tpu.models import gnat as jax_gnat
from last_torch_tpu_torch import convert
from last_torch_tpu_torch.models import gnat

torch.set_num_threads(1)
torch.set_float32_matmul_precision('highest')

SMALL = dict(feature_size=6, vocab_size=5, encoder_size=16, encoder_layers=2,
             encoder_heads=2, encoder_ffn_size=32, hidden_size=12,
             embedding_size=10)
NUM_FRAMES = np.array([7, 4, 0, 3], np.int32)  # full, padded, empty, short
# Row 3 is infeasible under FrameDependent (4 labels in 3 frames).
LABELS = np.array([[2, 5, 1, 3], [4, 4, 0, 0], [0, 0, 0, 0], [1, 2, 3, 4]],
                  np.int32)
NUM_LABELS = np.array([4, 2, 0, 4], np.int32)


def make_batch(seed):
  rng = np.random.default_rng(seed)
  frames = rng.standard_normal(
      (len(NUM_FRAMES), 7, SMALL['feature_size'])).astype(np.float32)
  return frames, NUM_FRAMES, LABELS, NUM_LABELS


def with_grad(params):
  for leaf in pytree.tree_leaves(params):
    leaf.requires_grad_(True)
  return params


def leaf_at(tree, path):
  """The leaf of a nested dict/list tree at a JAX key path."""
  for key in path:
    tree = tree[key.key if hasattr(key, 'key') else key.idx]
  return tree


def assert_grads_close(got, want, rtol=1e-4):
  """Per leaf, to rtol of the global gradient scale."""
  scale = max(float(np.abs(w).max()) for w in jax.tree.leaves(want))
  for path, w in jax.tree_util.tree_flatten_with_path(want)[0]:
    npt.assert_allclose(leaf_at(got, path), w, rtol=0, atol=rtol * scale,
                        err_msg=str(path))


@pytest.mark.parametrize('max_expansions', [0, 2])
def test_mean_loss_and_gradients_match_jax(max_expansions):
  config = dict(SMALL, max_expansions=max_expansions)
  jax_model = jax_gnat.GNATModel(jax_gnat.GNATConfig(**config))
  params = jax.tree.map(np.asarray, jax_model.init(jax.random.PRNGKey(3)))
  batch = make_batch(seed=max_expansions)
  value_j, grads_j = jax.value_and_grad(jax_model.mean_loss)(
      jax.tree.map(jnp.asarray, params), *batch)
  per_seq_j = np.asarray(jax_model.loss(params, *batch))

  model = gnat.GNATModel(gnat.GNATConfig(**config), device='cpu')
  torch_params = with_grad(convert.from_jax_params(params, device='cpu'))
  per_seq = model.loss(torch_params, *batch)
  npt.assert_allclose(per_seq.detach().numpy(), per_seq_j, rtol=1e-5,
                      atol=1e-6)
  assert per_seq[2].item() == 0.0  # no frames, no labels
  assert np.isinf(per_seq_j[3]) == (max_expansions == 0)
  value = model.mean_loss(torch_params, *batch)
  value.backward()
  assert model.lattice.last_path == 'plain'
  npt.assert_allclose(value.item(), float(value_j), rtol=1e-5, atol=1e-6)
  grads = pytree.tree_map(lambda x: x.grad.numpy(), torch_params)
  for leaf in pytree.tree_leaves(grads):
    assert np.isfinite(leaf).all()
  assert_grads_close(grads, jax.tree.map(np.asarray, grads_j))


def test_infeasible_and_empty_rows_get_zero_cotangent():
  model = gnat.GNATModel(gnat.GNATConfig(**SMALL, max_expansions=0),
                         device='cpu')
  params = with_grad(model.init(torch.Generator().manual_seed(0)))
  frames, num_frames, labels, num_labels = make_batch(seed=4)
  frames = torch.from_numpy(frames).requires_grad_(True)
  per_seq = model.loss(params, frames, num_frames, labels, num_labels)
  assert per_seq[3].item() == float('inf')
  assert per_seq[2].item() == 0.0
  model.mean_loss(params, frames, num_frames, labels, num_labels).backward()
  for leaf in pytree.tree_leaves(params):
    assert torch.isfinite(leaf.grad).all()
  # The infeasible row and the empty row contribute nothing; padding frames
  # get exactly zero gradient.
  assert torch.all(frames.grad[3] == 0) and torch.all(frames.grad[2] == 0)
  assert torch.all(frames.grad[1, 4:] == 0)
  assert torch.any(frames.grad[0] != 0)


def random_tree(rng, scale=1.0):
  normal = lambda *shape: (rng.standard_normal(shape) * scale).astype(
      np.float32)
  return {'a': {'w': normal(4, 3), 'b': normal(3)}, 'c': normal(5),
          'd': np.float32(normal(1)[0])}


SCHEDULES = {
    # name: (make_optimizer keywords, gradient scale)
    'constant': (dict(learning_rate=1e-2), 0.1),
    'clipped': (dict(learning_rate=1e-2, clip_norm=0.5), 3.0),
    'warmup_cosine': (dict(learning_rate=3e-2, warmup_steps=2,
                           total_steps=5), 1.0),
    'warmup_linear': (dict(learning_rate=3e-2, warmup_steps=3), 1.0),
}


@pytest.mark.parametrize('name', sorted(SCHEDULES))
def test_optimizer_matches_optax(name):
  kwargs, grad_scale = SCHEDULES[name]
  rng = np.random.default_rng(len(name))
  params = random_tree(rng)
  grads = [random_tree(rng, grad_scale) for _ in range(6)]

  tx = jax_gnat.make_optimizer(**kwargs)
  jax_params = jax.tree.map(jnp.asarray, params)
  opt_state = tx.init(jax_params)
  optimizer = gnat.make_optimizer(**kwargs)
  torch_params = convert.from_jax_params(params, device='cpu')
  state = optimizer.init(torch_params)
  for step, g in enumerate(grads):
    updates, opt_state = tx.update(jax.tree.map(jnp.asarray, g), opt_state,
                                   jax_params)
    jax_params = optax.apply_updates(jax_params, updates)
    for path, grad in jax.tree_util.tree_flatten_with_path(g)[0]:
      leaf_at(torch_params, path).grad = torch.tensor(grad)
    optimizer.apply_gradients(state)
    # torch's clip divides by norm + 1e-6 where optax divides by norm: a
    # relative 1e-6 / norm on a clipped step, far inside the tolerance.
    for path, want in jax.tree_util.tree_flatten_with_path(jax_params)[0]:
      npt.assert_allclose(leaf_at(torch_params, path).numpy(),
                          np.asarray(want), rtol=0, atol=1e-6,
                          err_msg=f'step {step} {path}')


def test_optimizer_rejects_unported_and_bad_options():
  with pytest.raises(ValueError, match='must exceed warmup_steps'):
    gnat.make_optimizer(warmup_steps=5, total_steps=5)


def test_train_steps_lower_the_loss():
  config = gnat.GNATConfig(**SMALL, max_expansions=2)
  model = gnat.GNATModel(config, device='cpu')
  optimizer = gnat.make_optimizer(learning_rate=1e-2)
  state = gnat.init_train_state(model, torch.Generator().manual_seed(1),
                                optimizer)
  batch = make_batch(seed=5)
  before = {k: v.detach().clone()
            for k, v in state.params['lattice']['weight_fn'].items()}
  first = model.mean_loss(state.params, *batch).item()
  losses = []
  for _ in range(3):
    state, loss = gnat.train_step(model, optimizer, state, *batch)
    losses.append(loss.item())
  assert state.step == 3
  assert losses[0] == pytest.approx(first, rel=1e-6)
  assert all(np.isfinite(losses)) and losses[2] < losses[1] < losses[0]
  for name, value in state.params['lattice']['weight_fn'].items():
    assert not torch.equal(value.detach(), before[name]), name
  # The same step in the JAX package from the same parameters gives the
  # same loss.
  fields = dataclasses.asdict(config)
  assert fields.pop('encoder_kind') == 'transformer'  # JAX's only encoder
  jax_model = jax_gnat.GNATModel(jax_gnat.GNATConfig(**fields))
  jax_params = jax.tree.map(
      lambda x: jnp.asarray(x.detach().numpy()), state.params)
  npt.assert_allclose(
      model.mean_loss(state.params, *batch).item(),
      float(jax_model.mean_loss(jax_params, *batch)), rtol=1e-5, atol=1e-6)
