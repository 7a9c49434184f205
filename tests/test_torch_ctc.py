"""The CTC topology (``presets.ctc_like``: FullNGram(0), FrameDependent,
locally normalized) and path entropy on the port, against the JAX package.

A small ``ctc_like`` model (and the globally normalized S = 1 lattice of
``gnat_global_bigram(context_size=0)``) on the same numpy inputs, JAX
parameters carried over with ``convert.from_jax_params``, every S = 1 call
on the port's factorized route: ``mean_loss`` to rtol 1e-5 / atol 1e-6 and
its gradients to 1e-4 of the largest gradient, one ``train_step`` (the
updated parameters to 1e-6; the blank head of the FrameLabelDependent
lattice, whose gradient is rounding residue at S = 1, to twice the
learning rate), ``decode`` (labels exactly), ``align`` (emit frames
exactly), ``label_marginals`` (rtol 1e-4 / atol 1e-6), and
``sample_paths``' ``log_prob`` and gradients on the paths the port drew,
scored by JAX. Path entropy (``shortest_distance`` under
``LogLogExpectation`` with the entropy lift) at S = 1 and on bench config
4's topology (a locally normalized bigram, FrameDependent), small, to rtol
1e-5. ``examples/train_ctc_torch.py`` trains for 20 steps and the loss
drops.
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch
from torch.utils import _pytree as pytree

import last_torch_tpu
from last_torch_tpu import alignments as jax_alignments
from last_torch_tpu import contexts as jax_contexts
from last_torch_tpu import semirings as jax_semirings
from last_torch_tpu import weight_fns as jax_weight_fns
from last_torch_tpu.models import gnat as jax_gnat
import last_torch_tpu_torch
from last_torch_tpu_torch import (alignments, contexts, convert, semirings,
                                  weight_fns)
from last_torch_tpu_torch.models import gnat, presets

from test_torch_sample_paths import jax_score

torch.set_num_threads(1)
torch.set_float32_matmul_precision('highest')

SMALL = dict(vocab_size=6, feature_size=5, encoder_size=16, encoder_layers=2,
             encoder_heads=2, encoder_ffn_size=32, hidden_size=12,
             embedding_size=10)
MODEL_FRAMES = np.array([8, 5, 0, 3], np.int32)
MODEL_LABELS = np.array([[2, 6, 1], [4, 4, 0], [0, 0, 0], [1, 2, 3]],
                        np.int32)
MODEL_NUM_LABELS = np.array([3, 2, 0, 3], np.int32)
RTOL, ATOL = 1e-5, 1e-6
GRAD_RTOL = 1e-4


def models(config, seed):
  fields = dataclasses.asdict(config)
  assert fields.pop('encoder_kind') == 'transformer'  # JAX's only encoder
  jax_model = jax_gnat.GNATModel(jax_gnat.GNATConfig(**fields))
  params = jax.tree.map(np.asarray, jax_model.init(jax.random.PRNGKey(seed)))
  frames = np.random.default_rng(seed).standard_normal(
      (len(MODEL_FRAMES), 8, SMALL['feature_size'])).astype(np.float32)
  return jax_model, gnat.GNATModel(config, device='cpu'), params, frames


def leaf_at(tree, path):
  for key in path:
    tree = tree[key.key if hasattr(key, 'key') else key.idx]
  return tree


def assert_grads_close(torch_params, grads_j):
  """Each leaf's ``.grad`` against JAX's, to 1e-4 of the largest."""
  scale = max(float(np.abs(g).max()) for g in jax.tree.leaves(grads_j))
  for path, want in jax.tree_util.tree_flatten_with_path(grads_j)[0]:
    npt.assert_allclose(leaf_at(torch_params, path).grad.numpy(),
                        np.asarray(want), rtol=0, atol=GRAD_RTOL * scale,
                        err_msg=str(path))


def with_grad(params):
  params = convert.from_jax_params(params, device='cpu')
  for leaf in pytree.tree_leaves(params):
    leaf.requires_grad_(True)
  return params


@pytest.mark.parametrize('preset', ['ctc_like', 'global_s1'])
def test_mean_loss_gradients_and_train_step_match_jax(preset):
  config = (presets.ctc_like(**SMALL) if preset == 'ctc_like' else
            presets.gnat_global_bigram(context_size=0, **SMALL))
  jax_model, model, params, frames = models(config, seed=11)
  assert model.lattice.context.shape()[0] == 1
  batch = (frames, MODEL_FRAMES, MODEL_LABELS, MODEL_NUM_LABELS)

  value_j, grads_j = jax.value_and_grad(jax_model.mean_loss)(
      jax.tree.map(jnp.asarray, params), *batch)
  torch_params = with_grad(params)
  value = model.mean_loss(torch_params, *batch)
  value.backward()
  npt.assert_allclose(value.item(), float(value_j), rtol=RTOL, atol=ATOL)
  assert_grads_close(torch_params, jax.tree.map(np.asarray, grads_j))
  if preset == 'global_s1':
    assert model.lattice.last_path == 's1'

  tx = jax_gnat.make_optimizer(learning_rate=1e-3)
  jax_params = jax.tree.map(jnp.asarray, params)
  jax_state = jax_gnat.GNATTrainState(
      params=jax_params, opt_state=tx.init(jax_params), step=0)
  jax_state, loss_j = jax_gnat.train_step(jax_model, tx, jax_state, *batch)
  optimizer = gnat.make_optimizer(learning_rate=1e-3)
  torch_params = with_grad(params)
  state = gnat.GNATTrainState(params=torch_params,
                              opt_state=optimizer.init(torch_params), step=0)
  state, loss = gnat.train_step(model, optimizer, state, *batch)
  npt.assert_allclose(loss.item(), float(loss_j), rtol=RTOL, atol=ATOL)
  for path, want in jax.tree_util.tree_flatten_with_path(
      jax_state.params)[0]:
    # At S = 1 under FrameLabelDependent every path takes each frame's one
    # blank weight exactly once: the blank head's gradients are structural
    # zeros made of rounding residue, which Adam's sign-like first step
    # turns into a move of up to the learning rate in either package.
    residue = preset == 'global_s1' and path[-1].key in ('blank_w',
                                                         'blank_b')
    npt.assert_allclose(leaf_at(state.params, path).detach().numpy(),
                        np.asarray(want), rtol=0,
                        atol=2e-3 if residue else 1e-6, err_msg=str(path))


@pytest.mark.parametrize('preset', ['ctc_like', 'global_s1'])
def test_decode_matches_jax_and_the_generic_route(preset):
  config = (presets.ctc_like(**SMALL) if preset == 'ctc_like' else
            presets.gnat_global_bigram(context_size=0, **SMALL))
  jax_model, model, params, frames = models(config, seed=12)
  # A blank bias that lets labels win some frames of the random model.
  params['lattice']['weight_fn']['blank_b'] = np.float32(-3.0)
  labels_j, num_j, weights_j = jax_model.decode(params, frames, MODEL_FRAMES)
  torch_params = convert.from_jax_params(params, device='cpu')
  labels, num_labels, weights = model.decode(torch_params, frames,
                                             MODEL_FRAMES)
  assert model.lattice.last_path == 's1'
  npt.assert_array_equal(labels.numpy(), np.asarray(labels_j))
  npt.assert_array_equal(num_labels.numpy(), np.asarray(num_j))
  npt.assert_allclose(weights.numpy(), np.asarray(weights_j), rtol=RTOL,
                      atol=1e-5)
  model.lattice._factorize_s1 = False
  labels_g, _, weights_g = model.decode(torch_params, frames, MODEL_FRAMES)
  assert model.lattice.last_path == 'generic'
  npt.assert_array_equal(labels.numpy(), labels_g.numpy())
  npt.assert_allclose(weights.numpy(), weights_g.numpy(), rtol=RTOL,
                      atol=1e-5)
  assert np.any(labels.numpy() > 0)
  if preset == 'ctc_like':
    assert torch.all(weights <= 0)  # log-probabilities


def encoded_inputs(jax_model, model, params, frames):
  """The port's encoder output (numpy) as the lattice's frames for both
  packages, and the lattice parameters of each."""
  torch_params = convert.from_jax_params(params, device='cpu')
  with torch.no_grad():
    encoded = model.encoder.apply(torch_params['encoder'],
                                  torch.from_numpy(frames),
                                  torch.from_numpy(MODEL_FRAMES)).numpy()
  return encoded, params['lattice'], torch_params['lattice']


def test_align_and_label_marginals_match_jax():
  jax_model, model, params, frames = models(presets.ctc_like(**SMALL),
                                            seed=13)
  encoded, jax_p, torch_p = encoded_inputs(jax_model, model, params, frames)
  jax_lattice, lattice = jax_model.lattice, model.lattice
  args = (MODEL_FRAMES, MODEL_LABELS, MODEL_NUM_LABELS)
  emit_j, scores_j = jax_lattice.align(jax_p, jnp.asarray(encoded), *args)
  emit, scores = lattice.align(torch_p, torch.from_numpy(encoded),
                               *map(torch.from_numpy, args))
  npt.assert_array_equal(emit.numpy(), np.asarray(emit_j))
  npt.assert_allclose(scores.numpy(), np.asarray(scores_j), rtol=RTOL,
                      atol=1e-5)

  want = jax_lattice.label_marginals(jax_p, jnp.asarray(encoded),
                                     MODEL_FRAMES)
  got = lattice.label_marginals(torch_p, torch.from_numpy(encoded),
                                torch.from_numpy(MODEL_FRAMES))
  assert lattice.last_path == 's1'
  for g, w in zip(got, want):
    npt.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=ATOL)
  # Blank and label posteriors sum to 1 at every real frame (FD), 0 past.
  sums = got[0][..., 0] + got[1].sum(-1)
  real = np.arange(8)[None] < MODEL_FRAMES[:, None]
  npt.assert_allclose(sums.numpy(), real.astype(np.float32), atol=1e-5)


def test_sample_paths_score_matches_jax():
  """Paths the port draws at S = 1, scored by JAX: log_prob and its
  gradients."""
  jax_model, model, params, frames = models(presets.ctc_like(**SMALL),
                                            seed=14)
  encoded, jax_p, _ = encoded_inputs(jax_model, model, params, frames)
  torch_p = with_grad(jax_p)
  frames_t = torch.from_numpy(encoded).requires_grad_(True)
  m = 5
  labels, num_labels, log_prob = model.lattice.sample_paths(
      torch_p, frames_t, torch.from_numpy(MODEL_FRAMES),
      torch.Generator().manual_seed(3), num_samples=m)
  assert labels.shape == (len(MODEL_FRAMES), m, 8)
  npt.assert_array_equal(num_labels.numpy(),
                         np.repeat(MODEL_FRAMES[:, None], m, axis=1))
  assert bool((labels > 0).any())
  cotangent = np.random.default_rng(4).standard_normal(
      (len(MODEL_FRAMES), m)).astype(np.float32)
  (log_prob * torch.from_numpy(cotangent)).sum().backward()

  def total(p, f):
    lp = jax_score(jax_model.lattice, p, f, MODEL_FRAMES, np.asarray(labels))
    return jnp.sum(lp * cotangent), lp

  (_, want), (d_params, d_frames) = jax.value_and_grad(
      total, argnums=(0, 1), has_aux=True)(jax.tree.map(jnp.asarray, jax_p),
                                           jnp.asarray(encoded))
  npt.assert_allclose(log_prob.detach().numpy(), np.asarray(want),
                      rtol=RTOL, atol=1e-5)
  assert_grads_close(torch_p, jax.tree.map(np.asarray, d_params))
  scale = float(np.abs(np.asarray(d_frames)).max())
  npt.assert_allclose(frames_t.grad.numpy(), np.asarray(d_frames), rtol=0,
                      atol=GRAD_RTOL * scale)


ENTROPY_VOCAB, ENTROPY_HIDDEN = 7, 16


def entropy_lattices(context_size):
  """Bench config 4's topology, small: locally normalized, FrameDependent."""
  jax_lattice = last_torch_tpu.RecognitionLattice(
      context=jax_contexts.FullNGram(vocab_size=ENTROPY_VOCAB,
                                     context_size=context_size),
      alignment=jax_alignments.FrameDependent(),
      weight_fn_cacher_factory=lambda ctx: jax_weight_fns.SharedEmbCacher(
          num_context_states=ctx.shape()[0], embedding_size=ENTROPY_HIDDEN),
      weight_fn_factory=lambda ctx: jax_weight_fns.LocallyNormalizedWeightFn(
          jax_weight_fns.JointWeightFn(vocab_size=ENTROPY_VOCAB,
                                       hidden_size=ENTROPY_HIDDEN)),
      fused='never')
  lattice = last_torch_tpu_torch.RecognitionLattice(
      context=contexts.FullNGram(vocab_size=ENTROPY_VOCAB,
                                 context_size=context_size),
      alignment=alignments.FrameDependent(),
      weight_fn_cacher_factory=lambda ctx: weight_fns.SharedEmbCacher(
          num_context_states=ctx.shape()[0], embedding_size=ENTROPY_HIDDEN),
      weight_fn_factory=lambda ctx: weight_fns.LocallyNormalizedWeightFn(
          weight_fns.JointWeightFn(vocab_size=ENTROPY_VOCAB,
                                   hidden_size=ENTROPY_HIDDEN)))
  return jax_lattice, lattice


@pytest.mark.parametrize('context_size', [0, 1])
def test_path_entropy_matches_jax(context_size):
  jax_lattice, lattice = entropy_lattices(context_size)
  params = jax.tree.map(np.asarray, jax_lattice.init(
      jax.random.PRNGKey(15), feature_size=ENTROPY_HIDDEN))
  rng = np.random.default_rng(15)
  num_frames = np.array([9, 4, 0, 1], np.int32)
  frames = (rng.standard_normal((4, 9, ENTROPY_HIDDEN)) * 0.5).astype(
      np.float32)
  jax_sr = jax_semirings.LogLogExpectation
  want = jax_lattice.shortest_distance(
      params, jnp.asarray(frames), num_frames, semiring=jax_sr,
      weight_lift=lambda w: jax_sr.weighted(
          w, jnp.log(jnp.maximum(-w, 1e-30))))
  sr = semirings.LogLogExpectation
  lift = lambda w: sr.weighted(w, torch.log(torch.clamp(-w, min=1e-30)))
  torch_params = convert.from_jax_params(params, device='cpu')
  with torch.no_grad():
    log_z, log_cost = lattice.shortest_distance(
        torch_params, torch.from_numpy(frames), torch.from_numpy(num_frames),
        semiring=sr, weight_lift=lift)
  assert lattice.last_path == ('s1' if context_size == 0 else 'generic')
  npt.assert_allclose(log_z.numpy(), np.asarray(want[0]), rtol=RTOL,
                      atol=1e-5)
  npt.assert_allclose(log_cost.numpy(), np.asarray(want[1]), rtol=RTOL,
                      atol=1e-5)
  # Locally normalized: log Z is 0; the entropy is positive where a frame
  # is real, and the empty row's cost is the x-semiring zero.
  npt.assert_allclose(log_z.numpy(), 0.0, atol=1e-5)
  entropy = torch.exp(log_cost - log_z)
  assert bool((entropy[num_frames > 0] > 0).all()) and entropy[2] == 0
  if context_size == 0:
    lattice._factorize_s1 = False
    with torch.no_grad():
      generic = lattice.shortest_distance(
          torch_params, torch.from_numpy(frames),
          torch.from_numpy(num_frames), semiring=sr, weight_lift=lift)
    assert lattice.last_path == 'generic'
    for g, w in zip((log_z, log_cost), generic):
      npt.assert_allclose(g.numpy(), w.numpy(), rtol=RTOL, atol=1e-5)


def test_train_ctc_example_loss_drops():
  sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..',
                                  'examples'))
  try:
    import train_ctc_torch  # pylint: disable=g-import-not-at-top
  finally:
    sys.path.pop(0)
  losses = train_ctc_torch.main(steps=20, device='cpu')
  assert len(losses) == 20 and all(np.isfinite(losses))
  assert np.mean(losses[-5:]) < np.mean(losses[:5])
