"""The port's expected-risk (MWER / REINFORCE) loss and ``risk_train_step``
against the JAX package and enumeration oracles.

The port draws the paths (its own random stream); the JAX package is run on
the same paths: the JAX lattice instance's ``sample_paths`` is set to
return the port's alignment labels with their ``log_prob`` scored in JAX
(``weight_fn.apply`` at each slot's state minus ``shortest_distance``, as in
``test_torch_sample_paths.py``), so every gradient JAX takes goes through
its own scoring. Held: the loss to rtol 1e-5, the risks and hypotheses
exactly, every gradient to 1e-4 of the largest; for ``risk_train_step``
(a small GNAT, globally and locally normalized, with and without the NLL
term) also ``mean_risk`` and ``nll``, the gradients being the step's own,
read before its clip (whose norm is set out of reach). Then the estimators'
statistics on enumerable ``TableWeightFn`` lattices, as the JAX package's
``tests/test_risk.py`` checks them: REINFORCE's value is the Monte Carlo
mean and its batch-averaged gradient the exact ``grad E[r]``; MWER's value
the tilted risk and its gradient half the tilted objective's; and the
error paths.
"""

import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch
from torch.utils import _pytree as pytree

from last_torch_tpu import risk as jax_risk
from last_torch_tpu.models import gnat as jax_gnat
import last_torch_tpu_torch
from last_torch_tpu_torch import alignments, contexts, convert, risk
from last_torch_tpu_torch import weight_fns
from last_torch_tpu_torch.models import gnat

from test_risk import enumeration_oracle
from test_torch_sample_paths import jax_score, joint_lattices

torch.set_num_threads(1)
torch.set_float32_matmul_precision('highest')

FEATURES = 5


def spy_on_sampler(lattice, seen):
  """Records the alignment labels of every draw of the sampler (the
  losses call ``_sample_paths``)."""
  sample_paths = lattice._sample_paths

  def spy(*args, **kwargs):
    out = sample_paths(*args, **kwargs)
    seen.append(out[0].detach().numpy().copy())
    return out

  lattice._sample_paths = spy


def replay_in_jax(jax_lattice, seen):
  """JAX ``sample_paths`` returning the port's paths, scored in JAX."""

  def sample_paths(params, frames, num_frames, key, num_samples=1,
                   cache=None):
    del key, cache
    labels = seen.pop(0)
    assert labels.shape[-2] == num_samples
    log_prob = jax_score(jax_lattice, params, frames, jnp.asarray(num_frames),
                         labels)
    num = jnp.broadcast_to(
        (jax_lattice.alignment.num_states() *
         jnp.asarray(num_frames, jnp.int32))[:, None], labels.shape[:-1])
    return jnp.asarray(labels), num, log_prob

  jax_lattice.sample_paths = sample_paths


def named(tree):
  return {'/'.join(str(getattr(k, 'key', getattr(k, 'idx', k))) for k in p):
          np.asarray(leaf) for p, leaf in
          jax.tree_util.tree_flatten_with_path(tree)[0]}


def torch_named(tree, attr):
  return {'/'.join(str(getattr(k, 'key', getattr(k, 'idx', k))) for k in p):
          getattr(leaf, attr).detach().numpy() for p, leaf in
          pytree.tree_flatten_with_path(tree)[0]}


def assert_same_gradients(got, want):
  assert set(got) == set(want)
  scale = max(float(np.abs(w).max()) for w in want.values())
  assert scale > 0
  for name, w in want.items():
    npt.assert_allclose(got[name], w, rtol=0, atol=1e-4 * scale,
                        err_msg=name)


@pytest.mark.parametrize('estimator', ['mwer', 'reinforce'])
@pytest.mark.parametrize('max_expansions', [None, 1])
def test_sampled_risk_loss_matches_jax_on_the_same_paths(estimator,
                                                         max_expansions):
  jax_lattice, lattice = joint_lattices(5, max_expansions)
  params = jax.tree.map(np.asarray, jax_lattice.init(jax.random.PRNGKey(7),
                                                     feature_size=FEATURES))
  rng = np.random.default_rng(8)
  num_frames = np.asarray([6, 4, 1], np.int32)
  frames = rng.standard_normal((3, 6, FEATURES)).astype(np.float32)
  labels = np.asarray([[1, 2, 3], [4, 4, 0], [5, 1, 2]], np.int32)
  num_labels = np.asarray([3, 2, 3], np.int32)
  seen = []
  spy_on_sampler(lattice, seen)
  torch_params = convert.from_jax_params(params, device='cpu')
  for leaf in pytree.tree_leaves(torch_params):
    leaf.requires_grad_(True)
  loss, aux = risk.sampled_risk_loss(
      lattice, torch_params, torch.from_numpy(frames),
      torch.from_numpy(num_frames), torch.from_numpy(labels),
      torch.from_numpy(num_labels), torch.Generator().manual_seed(9),
      num_samples=4, estimator=estimator)
  loss.sum().backward()
  assert len(seen) == 1

  replay_in_jax(jax_lattice, seen)

  def total(p):
    out, jax_aux = jax_risk.sampled_risk_loss(
        jax_lattice, p, frames, num_frames, labels, num_labels,
        jax.random.PRNGKey(0), num_samples=4, estimator=estimator)
    return jnp.sum(out), (out, jax_aux)

  (_, (want, jax_aux)), d_params = jax.value_and_grad(total, has_aux=True)(
      jax.tree.map(jnp.asarray, params))
  npt.assert_allclose(loss.detach().numpy(), np.asarray(want), rtol=1e-5,
                      atol=1e-6)
  for key in ('risk', 'hyp_labels', 'num_hyp_labels'):
    npt.assert_array_equal(aux[key].numpy(), np.asarray(jax_aux[key]),
                           err_msg=key)
  npt.assert_allclose(aux['log_prob'].detach().numpy(),
                      np.asarray(jax_aux['log_prob']), rtol=1e-5, atol=1e-5)
  npt.assert_allclose(aux['mean_risk'].numpy(),
                      np.asarray(jax_aux['mean_risk']), rtol=1e-6)
  assert_same_gradients(torch_named(torch_params, 'grad'), named(d_params))


@pytest.mark.parametrize('estimator', ['mwer', 'reinforce'])
def test_loss_gradient_through_log_z_is_zero(estimator):
  """The loss takes log Z as a constant: on the same paths, its gradients
  equal those of the loss differentiated through the beta pass as well
  (the JAX package's route), though log Z's own gradient is not small."""
  _, lattice = joint_lattices(5, 2)
  params = lattice.init(torch.Generator().manual_seed(3),
                        feature_size=FEATURES, device='cpu')
  leaves = pytree.tree_leaves(params)
  for leaf in leaves:
    leaf.requires_grad_(True)
  rng = np.random.default_rng(4)
  frames = torch.from_numpy(rng.standard_normal((3, 6, FEATURES)).astype(
      np.float32))
  num_frames = torch.tensor([6, 4, 2])
  labels = torch.tensor([[1, 2, 3], [4, 4, 0], [5, 1, 2]])
  num_labels = torch.tensor([3, 2, 3])

  def gradients():
    loss, aux = risk.sampled_risk_loss(
        lattice, params, frames, num_frames, labels, num_labels,
        torch.Generator().manual_seed(9), num_samples=4,
        estimator=estimator)
    return torch.autograd.grad(loss.sum(), leaves, allow_unused=True), aux

  got, aux = gradients()
  sample_paths = lattice._sample_paths
  lattice._sample_paths = lambda *args, log_z_grad: sample_paths(*args)
  want, want_aux = gradients()
  npt.assert_array_equal(aux['hyp_labels'].numpy(),
                         want_aux['hyp_labels'].numpy())
  log_z = lattice._sample_betas(params, lattice.build_cache(params), frames,
                                num_frames)[0]
  d_log_z = torch.autograd.grad(log_z.sum(), leaves, allow_unused=True)
  largest = max(w.abs().max().item() for w in want if w is not None)
  assert max(d.abs().max().item() for d in d_log_z
             if d is not None) > largest
  for g, w in zip(got, want):
    if w is None:
      assert g is None
    else:
      assert (g - w).abs().max().item() <= 1e-5 * largest


SMALL = dict(feature_size=8, vocab_size=6, context_size=1, encoder_size=16,
             encoder_layers=1, encoder_heads=2, encoder_ffn_size=32,
             hidden_size=16, embedding_size=8, max_expansions=1)


@pytest.mark.parametrize('locally_normalized,estimator,nll_weight', [
    (False, 'mwer', 0.1),
    (False, 'reinforce', 0.0),
    (True, 'mwer', 0.3),
])
def test_risk_train_step_matches_jax_on_the_same_paths(
    locally_normalized, estimator, nll_weight):
  config = dict(SMALL, locally_normalized=locally_normalized)
  jax_model = jax_gnat.GNATModel(jax_gnat.GNATConfig(**config))
  params = jax.tree.map(np.asarray, jax_model.init(jax.random.PRNGKey(2)))
  rng = np.random.default_rng(3)
  num_frames = np.asarray([7, 5, 2, 7], np.int32)
  frames = rng.standard_normal((4, 7, 8)).astype(np.float32)
  labels = rng.integers(1, 7, size=(4, 3)).astype(np.int32)
  # Row 2 is infeasible under FLD(1) (3 labels in 2 frames): its NLL is
  # +inf and drops out of the mean; its risk stays.
  num_labels = np.asarray([3, 2, 3, 1], np.int32)

  model = gnat.GNATModel(gnat.GNATConfig(**config), device='cpu')
  seen = []
  spy_on_sampler(model.lattice, seen)
  optimizer = gnat.make_optimizer(learning_rate=1e-3, clip_norm=1e9)
  torch_params = convert.from_jax_params(params, device='cpu')
  for leaf in pytree.tree_leaves(torch_params):
    leaf.requires_grad_(True)
  state = gnat.GNATTrainState(torch_params, optimizer.init(torch_params), 0)
  before = {n: x.copy() for n, x in torch_named(state.params, 'data').items()}
  state, metrics = gnat.risk_train_step(
      model, optimizer, state, frames, num_frames, labels, num_labels,
      torch.Generator().manual_seed(4), num_samples=3, estimator=estimator,
      nll_weight=nll_weight)
  assert state.step == 1 and len(seen) == 1
  assert set(metrics) == ({'loss', 'mean_risk', 'nll'} if nll_weight else
                          {'loss', 'mean_risk'})
  after = torch_named(state.params, 'data')
  assert any(not np.array_equal(after[n], before[n]) for n in before)

  replay_in_jax(jax_model.lattice, seen)
  grads = {}

  def capture(g, s, p=None):
    grads['g'] = g
    return g, s

  import optax
  _, want = jax_gnat.risk_train_step(
      jax_model, optax.GradientTransformation(lambda p: (), capture),
      jax_gnat.GNATTrainState(params=jax.tree.map(jnp.asarray, params),
                              opt_state=(), step=jnp.zeros((), jnp.int32)),
      frames, num_frames, labels, num_labels, jax.random.PRNGKey(0),
      num_samples=3, estimator=estimator, nll_weight=nll_weight)
  for key in metrics:
    npt.assert_allclose(float(metrics[key]), float(want[key]), rtol=1e-5,
                        err_msg=key)
  assert_same_gradients(torch_named(state.params, 'grad'),
                        named(grads['g']))


def test_risk_train_step_per_example_keys_draws_each_row_alone():
  model = gnat.GNATModel(gnat.GNATConfig(**SMALL), device='cpu')
  params = model.init(torch.Generator().manual_seed(0))
  rng = np.random.default_rng(1)
  frames = torch.from_numpy(rng.standard_normal((4, 7, 8)).astype(np.float32))
  num_frames = torch.tensor([7, 5, 2, 7])
  labels = torch.from_numpy(rng.integers(1, 7, size=(4, 3)))
  num_labels = torch.tensor([3, 2, 1, 1])
  with torch.no_grad():
    encoded = model.encoder.apply(params['encoder'], frames, num_frames)
    rows = risk.per_example_keys(torch.Generator().manual_seed(2), 4)
    # Rows 1 and 3 alone, each from its own generator.
    want = model.lattice.sample_paths(params['lattice'], encoded[1::2],
                                      num_frames[1::2], rows[1::2],
                                      num_samples=4)[0]
  seen = []
  spy_on_sampler(model.lattice, seen)
  optimizer = gnat.make_optimizer()
  for leaf in pytree.tree_leaves(params):
    leaf.requires_grad_(True)
  state = gnat.GNATTrainState(params, optimizer.init(params), 0)
  gnat.risk_train_step(model, optimizer, state, frames, num_frames, labels,
                       num_labels, torch.Generator().manual_seed(2),
                       num_samples=4, per_example_keys=True)
  assert seen[0].shape == (4, 4, 14)
  npt.assert_array_equal(seen[0][1::2], want.numpy())


def test_error_paths():
  table = np.zeros((1, 3, 3, 3), np.float32)
  lattice = last_torch_tpu_torch.RecognitionLattice(
      context=contexts.FullNGram(vocab_size=2, context_size=1),
      alignment=alignments.FrameLabelDependent(1),
      weight_fn_cacher_factory=lambda ctx: weight_fns.NullCacher(),
      weight_fn_factory=lambda ctx: weight_fns.TableWeightFn(table))
  params = lattice.init(torch.Generator(), feature_size=1, device='cpu')
  args = (lattice, params, torch.zeros((1, 2, 1)), torch.tensor([2]),
          torch.tensor([[1]]), torch.tensor([1]), torch.Generator())
  with pytest.raises(ValueError, match='estimator'):
    risk.sampled_risk_loss(*args, estimator='nope')
  for estimator in ('reinforce', 'mwer'):
    with pytest.raises(ValueError, match='num_samples'):
      risk.sampled_risk_loss(*args, num_samples=1, estimator=estimator)
  with pytest.raises(ValueError, match='single leading batch dim'):
    risk.sampled_risk_loss_per_example(
        lattice, params, torch.zeros((1, 1, 2, 1)), torch.tensor([[2]]),
        torch.tensor([[[1]]]), torch.tensor([[1]]), [torch.Generator()])


def table_lattice(table, max_expansions):
  return last_torch_tpu_torch.RecognitionLattice(
      context=contexts.FullNGram(vocab_size=2, context_size=1),
      alignment=(alignments.FrameDependent() if max_expansions is None else
                 alignments.FrameLabelDependent(max_expansions)),
      weight_fn_cacher_factory=lambda ctx: weight_fns.NullCacher(),
      weight_fn_factory=lambda ctx: weight_fns.TableWeightFn(table))


def batch_of(frames_int, ref, rows):
  """``rows`` copies of one utterance: independent sample sets in one
  sampler pass, in place of the JAX package's vmap over keys."""
  frames = torch.tensor(frames_int, dtype=torch.float32)[None, :, None]
  return (frames.expand(rows, -1, -1), torch.full((rows,), len(frames_int)),
          torch.tensor([ref]).expand(rows, -1),
          torch.full((rows,), len(ref)))


@pytest.mark.parametrize('max_expansions', [None, 1])
def test_values_match_enumeration(max_expansions):
  ref = [1, 2]
  table, frames_int, exact_er, exact_tilted = enumeration_oracle(
      max_expansions, 3, ref, seed=0)
  lattice = table_lattice(torch.from_numpy(table), max_expansions)
  params = lattice.init(torch.Generator(), feature_size=1, device='cpu')
  batch = batch_of(frames_int, ref, 1)
  m = 4096
  loss_r, aux = risk.sampled_risk_loss(
      lattice, params, *batch, torch.Generator().manual_seed(3),
      num_samples=m, estimator='reinforce')
  npt.assert_allclose(loss_r.detach().numpy(), aux['mean_risk'].numpy(),
                      rtol=1e-6)
  er = float(exact_er(jnp.asarray(table)))
  var = float(((aux['risk'] - er)**2).mean())
  npt.assert_allclose(float(loss_r[0]), er, atol=5 * np.sqrt(var / m) + 1e-3)
  loss_m, _ = risk.sampled_risk_loss(
      lattice, params, *batch, torch.Generator().manual_seed(3),
      num_samples=m, estimator='mwer')
  tilted = float(exact_tilted(jnp.asarray(table)))
  npt.assert_allclose(float(loss_m[0]), tilted, atol=0.05)


@pytest.mark.parametrize('estimator', ['reinforce', 'mwer'])
def test_gradient_matches_enumeration(estimator):
  ref = [2, 1]
  table, frames_int, exact_er, exact_tilted = enumeration_oracle(
      1, 3, ref, seed=1)
  # As the JAX package's test: many small sets for the unbiased REINFORCE,
  # fewer large ones for MWER, whose fixed-sample gradient reaches its
  # asymptote only as M grows. Each set is a batch row.
  m, rows = (8, 1024) if estimator == 'reinforce' else (512, 64)
  base = torch.from_numpy(table[0]).requires_grad_(True)
  lattice = table_lattice(base.expand((rows,) + base.shape), 1)
  params = lattice.init(torch.Generator(), feature_size=1, device='cpu')
  loss, _ = risk.sampled_risk_loss(
      lattice, params, *batch_of(frames_int, ref, rows),
      torch.Generator().manual_seed(17), num_samples=m, estimator=estimator)
  loss.mean().backward()
  g_est = base.grad.numpy()[None]
  if estimator == 'reinforce':
    g_exact = np.asarray(jax.grad(exact_er)(jnp.asarray(table)))
  else:
    g_exact = 0.5 * np.asarray(jax.grad(exact_tilted)(jnp.asarray(table)))
  scale = np.abs(g_exact).max()
  assert scale > 1e-3
  npt.assert_allclose(g_est, g_exact, atol=0.15 * scale)
  cos = (g_est * g_exact).sum() / (np.linalg.norm(g_est) *
                                   np.linalg.norm(g_exact))
  assert cos > 0.98, f'gradient cosine {cos}'
