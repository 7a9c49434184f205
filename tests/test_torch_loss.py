"""The port's lattice loss and shortest distance against the JAX package.

Same numpy inputs, JAX parameters converted with ``convert.from_jax_params``.
The port's loss (plain log-partition on CPU tensors) and its generic route
(a ``JointWeightFn`` subclass, outside the kernels' gate) are held to JAX's
loss through the Pallas kernels in interpret mode and through XLA: values
to rtol 1e-5 / atol 1e-6, gradients of parameters and frames to rtol 1e-4
(float32 both sides, other summation order). Gradients are compared per
leaf against the global gradient scale, since FrameLabelDependent's
``blank_b`` gradient is a structural zero made of rounding residue.
"""

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
import last_torch_tpu_torch
from last_torch_tpu_torch import (alignments, contexts, convert, semirings,
                                  weight_fns)

torch.set_num_threads(1)
torch.set_float32_matmul_precision('highest')

VOCAB, HIDDEN, EMBEDDING, FEATURES = 5, 8, 8, 6
NUM_FRAMES = np.array([7, 4, 0], np.int32)  # full, padded, empty
LABELS = np.array([[2, 5, 1, 3], [4, 4, 0, 0], [0, 0, 0, 0]], np.int32)
NUM_LABELS = np.array([4, 2, 0], np.int32)
ALIGNMENTS = {
    'fd': (jax_alignments.FrameDependent, alignments.FrameDependent),
    'fld1': (lambda: jax_alignments.FrameLabelDependent(1),
             lambda: alignments.FrameLabelDependent(1)),
    'fld2': (lambda: jax_alignments.FrameLabelDependent(2),
             lambda: alignments.FrameLabelDependent(2)),
}


class SubclassedJoint(weight_fns.JointWeightFn):
  """Outside the kernels' gate (the gate wants exactly JointWeightFn)."""


def jax_lattice(alignment, fused, context_size=1):
  return last_torch_tpu.RecognitionLattice(
      context=jax_contexts.FullNGram(vocab_size=VOCAB,
                                     context_size=context_size),
      alignment=ALIGNMENTS[alignment][0](),
      weight_fn_cacher_factory=lambda ctx: jax_weight_fns.SharedEmbCacher(
          num_context_states=ctx.shape()[0], embedding_size=EMBEDDING),
      weight_fn_factory=lambda ctx: jax_weight_fns.JointWeightFn(
          vocab_size=ctx.shape()[1], hidden_size=HIDDEN),
      fused=fused)


def torch_lattice(alignment, weight_fn=weight_fns.JointWeightFn,
                  context_size=1, vocab=VOCAB):
  return last_torch_tpu_torch.RecognitionLattice(
      context=contexts.FullNGram(vocab_size=vocab, context_size=context_size),
      alignment=ALIGNMENTS[alignment][1](),
      weight_fn_cacher_factory=lambda ctx: weight_fns.SharedEmbCacher(
          num_context_states=ctx.shape()[0], embedding_size=EMBEDDING),
      weight_fn_factory=lambda ctx: weight_fn(
          vocab_size=ctx.shape()[1], hidden_size=HIDDEN))


def make_inputs(seed):
  params = jax_lattice('fd', 'never').init(jax.random.PRNGKey(seed),
                                           feature_size=FEATURES)
  frames = np.random.default_rng(seed).standard_normal(
      (len(NUM_FRAMES), 7, FEATURES)).astype(np.float32)
  return jax.tree.map(np.asarray, params), frames


def jax_loss_and_grads(lattice, params, frames, labels=LABELS,
                       num_labels=NUM_LABELS):
  def total(p, f):
    return jnp.sum(lattice(p, f, NUM_FRAMES, labels, num_labels))
  value, (d_params, d_frames) = jax.value_and_grad(total, argnums=(0, 1))(
      jax.tree.map(jnp.asarray, params), jnp.asarray(frames))
  return (float(value), jax.tree.map(np.asarray, d_params),
          np.asarray(d_frames))


def torch_loss_and_grads(lattice, params, frames, labels=LABELS,
                         num_labels=NUM_LABELS):
  params = convert.from_jax_params(params, device='cpu')
  for leaf in pytree.tree_leaves(params):
    leaf.requires_grad_(True)
  frames = torch.from_numpy(frames).requires_grad_(True)
  loss = lattice.loss(params, frames, torch.from_numpy(NUM_FRAMES),
                      torch.from_numpy(labels), torch.from_numpy(num_labels))
  loss.sum().backward()
  return (loss.detach(), pytree.tree_map(lambda x: x.grad.numpy(), params),
          frames.grad.numpy())


def assert_grads_close(got, want, rtol=1e-4):
  """Per leaf, to rtol of the global gradient scale."""
  scale = max(float(np.abs(w).max()) for w in jax.tree.leaves(want))
  for path, w in jax.tree_util.tree_flatten_with_path(want)[0]:
    g = got
    for key in path:
      g = g[key.key]
    npt.assert_allclose(g, w, rtol=0, atol=rtol * scale, err_msg=str(path))


@pytest.mark.parametrize('fused', ['interpret', 'never'])
@pytest.mark.parametrize('alignment', ['fd', 'fld1', 'fld2'])
def test_loss_matches_jax(alignment, fused):
  params, frames = make_inputs(seed=1)
  value_j, d_params_j, d_frames_j = jax_loss_and_grads(
      jax_lattice(alignment, fused), params, frames)
  lattice = torch_lattice(alignment)
  loss, d_params, d_frames = torch_loss_and_grads(lattice, params, frames)
  assert lattice.last_path == 'plain'
  npt.assert_allclose(float(loss.sum()), value_j, rtol=1e-5, atol=1e-6)
  assert loss[2] == 0.0  # no frames, no labels: loss 0
  assert_grads_close(d_params, d_params_j)
  npt.assert_allclose(d_frames, d_frames_j, rtol=1e-4, atol=1e-6)
  # Frames past num_frames get exactly zero gradient.
  assert np.all(d_frames[1, 4:] == 0) and np.all(d_frames[2] == 0)


@pytest.mark.parametrize('alignment', ['fd', 'fld2'])
def test_generic_route_matches_plain_kernel_route(alignment):
  params, frames = make_inputs(seed=2)
  plain = torch_lattice(alignment)
  generic = torch_lattice(alignment, weight_fn=SubclassedJoint)
  loss_p, d_params_p, d_frames_p = torch_loss_and_grads(plain, params,
                                                        frames)
  loss_g, d_params_g, d_frames_g = torch_loss_and_grads(generic, params,
                                                        frames)
  assert (plain.last_path, generic.last_path) == ('plain', 'generic')
  npt.assert_allclose(loss_g.numpy(), loss_p.numpy(), rtol=1e-5, atol=1e-6)
  assert_grads_close(d_params_g, d_params_p)
  npt.assert_allclose(d_frames_g, d_frames_p, rtol=1e-4, atol=1e-6)
  assert np.all(d_frames_g[1, 4:] == 0) and np.all(d_frames_g[2] == 0)


@pytest.mark.parametrize('alignment', ['fd', 'fld2'])
def test_shortest_distance_matches_jax(alignment):
  params, frames = make_inputs(seed=3)
  reference = jax_lattice(alignment, 'never')
  torch_params = convert.from_jax_params(params, device='cpu')
  for semiring, jax_semiring in ((semirings.Log, jax_semirings.Log),
                                 (semirings.MaxTropical,
                                  jax_semirings.MaxTropical)):
    want = reference.shortest_distance(params, frames, NUM_FRAMES,
                                       semiring=jax_semiring)
    for weight_fn in (weight_fns.JointWeightFn, SubclassedJoint):
      got = torch_lattice(alignment, weight_fn).shortest_distance(
          torch_params, torch.from_numpy(frames),
          torch.from_numpy(NUM_FRAMES), semiring=semiring)
      npt.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                          atol=1e-6)


def test_max_tropical_shortest_distance_gradient_is_one_path():
  params, frames = make_inputs(seed=4)
  torch_params = convert.from_jax_params(params, device='cpu')
  lattice = torch_lattice('fd')
  mask = torch.zeros((len(NUM_FRAMES), 7, STATES := VOCAB + 1, VOCAB),
                     requires_grad=True)
  cache = lattice.build_cache(torch_params)
  weights, _ = lattice._forward(torch_params, cache,
                                torch.from_numpy(frames),
                                torch.from_numpy(NUM_FRAMES),
                                semirings.MaxTropical, lexical_mask=[mask])
  weights.sum().backward()
  # One path per utterance: each real frame takes at most one lexical arc.
  per_frame = mask.grad.sum(dim=(-1, -2))
  assert torch.all((per_frame == 0) | (per_frame == 1))
  assert torch.all(per_frame[1, 4:] == 0) and torch.all(per_frame[2] == 0)
  assert mask.grad.shape[-2] == STATES


def test_infeasible_labels_give_inf_loss_and_zero_cotangent_gradients():
  params, frames = make_inputs(seed=5)
  # FrameDependent emits at most one label per frame: 5 labels cannot fit
  # in 4 frames.
  labels = np.array([[1, 2, 0, 0, 0], [1, 2, 3, 4, 5], [0, 0, 0, 0, 0]],
                    np.int32)
  num_labels = np.array([2, 5, 0], np.int32)
  lattice = torch_lattice('fd')
  torch_params = convert.from_jax_params(params, device='cpu')
  for leaf in pytree.tree_leaves(torch_params):
    leaf.requires_grad_(True)
  frames_t = torch.from_numpy(frames).requires_grad_(True)
  per_seq = lattice.loss(torch_params, frames_t, torch.from_numpy(NUM_FRAMES),
                         torch.from_numpy(labels),
                         torch.from_numpy(num_labels))
  assert per_seq[1].item() == float('inf')
  assert torch.isfinite(per_seq[[0, 2]]).all()
  # mean_loss's masking: the infeasible row gets a zero cotangent.
  finite = torch.isfinite(per_seq)
  mean = torch.where(finite, per_seq, 0.0).sum() / finite.sum()
  mean.backward()
  for leaf in pytree.tree_leaves(torch_params):
    assert torch.isfinite(leaf.grad).all()
  assert torch.all(frames_t.grad[1] == 0) and torch.all(frames_t.grad[2] == 0)
  reference = jax_lattice('fd', 'never')(
      jax.tree.map(jnp.asarray, params), frames, NUM_FRAMES, labels,
      num_labels)
  npt.assert_allclose(per_seq.detach().numpy(), np.asarray(reference),
                      rtol=1e-5)


def test_shape_mismatches_name_the_pair():
  params, frames = make_inputs(seed=6)
  lattice = torch_lattice('fld2')
  torch_params = convert.from_jax_params(params, device='cpu')
  frames = torch.from_numpy(frames)
  num_frames = torch.from_numpy(NUM_FRAMES)
  labels = torch.from_numpy(LABELS)
  num_labels = torch.from_numpy(NUM_LABELS)
  with pytest.raises(ValueError, match='frames and num_frames'):
    lattice.loss(torch_params, frames[:2], num_frames, labels, num_labels)
  with pytest.raises(ValueError, match='labels and num_frames'):
    lattice.loss(torch_params, frames, num_frames, labels[:2], num_labels)
  with pytest.raises(ValueError, match='num_labels and num_frames'):
    lattice.loss(torch_params, frames, num_frames, labels, num_labels[:2])


def test_unported_routes_raise():
  """The routes this test once found unported, now held to JAX: the
  globally normalized S = 1 (context_size 0) loss through the factorized
  route, values and gradients, and ``shortest_distance`` with a
  ``weight_lift`` (the LogLogExpectation path entropy) on the bigram."""
  for alignment in ('fd', 'fld2'):
    params = jax.tree.map(np.asarray, jax_lattice(
        alignment, 'never', context_size=0).init(jax.random.PRNGKey(7),
                                                 feature_size=FEATURES))
    frames = np.random.default_rng(7).standard_normal(
        (len(NUM_FRAMES), 7, FEATURES)).astype(np.float32)
    value_j, d_params_j, d_frames_j = jax_loss_and_grads(
        jax_lattice(alignment, 'never', context_size=0), params, frames)
    ctc = torch_lattice(alignment, context_size=0)
    loss, d_params, d_frames = torch_loss_and_grads(ctc, params, frames)
    assert ctc.last_path == 's1'
    npt.assert_allclose(float(loss.sum()), value_j, rtol=1e-5, atol=1e-6)
    assert loss[2] == 0.0
    assert_grads_close(d_params, d_params_j)
    npt.assert_allclose(d_frames, d_frames_j, rtol=1e-4, atol=1e-6)

  params, frames = make_inputs(seed=7)
  jax_sr = jax_semirings.LogLogExpectation
  want = jax_lattice('fld2', 'never').shortest_distance(
      params, frames, NUM_FRAMES, semiring=jax_sr,
      weight_lift=lambda w: jax_sr.weighted(
          w, jnp.log(jnp.maximum(-w, 1e-30))))
  sr = semirings.LogLogExpectation
  lattice = torch_lattice('fld2')
  got = lattice.shortest_distance(
      convert.from_jax_params(params, device='cpu'), torch.from_numpy(frames),
      torch.from_numpy(NUM_FRAMES), semiring=sr,
      weight_lift=lambda w: sr.weighted(w, torch.log(torch.clamp(-w,
                                                                 min=1e-30))))
  assert lattice.last_path == 'generic'
  assert isinstance(got, tuple) and len(got) == 2
  for g, w in zip(got, want):
    npt.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=1e-5,
                        atol=1e-6)


@pytest.mark.parametrize('seed', range(6))
def test_fuzz_plain_kernel_route_matches_generic_route(seed):
  """Random small configurations: the kernels' plain versions (inside the
  gate) against the per-frame generic route, loss and gradients."""
  rng = np.random.default_rng(100 + seed)
  vocab = int(rng.integers(2, 7))
  k = int(rng.integers(0, 3))
  batch, max_t = int(rng.integers(1, 4)), int(rng.integers(1, 6))
  num_frames = rng.integers(0, max_t + 1, size=batch).astype(np.int32)
  max_u = int(rng.integers(1, 4))
  labels = rng.integers(1, vocab + 1, size=(batch, max_u)).astype(np.int32)
  num_labels = rng.integers(0, max_u + 1, size=batch).astype(np.int32)
  alignment = (alignments.FrameDependent() if k == 0 else
               alignments.FrameLabelDependent(k))

  def make(weight_fn):
    return last_torch_tpu_torch.RecognitionLattice(
        context=contexts.FullNGram(vocab_size=vocab, context_size=1),
        alignment=alignment,
        weight_fn_cacher_factory=lambda ctx: weight_fns.SharedEmbCacher(
            num_context_states=ctx.shape()[0], embedding_size=EMBEDDING),
        weight_fn_factory=lambda ctx: weight_fn(vocab_size=vocab,
                                                hidden_size=HIDDEN))

  plain, generic = make(weight_fns.JointWeightFn), make(SubclassedJoint)
  params = plain.init(torch.Generator().manual_seed(seed), FEATURES,
                      device='cpu')
  frames = rng.standard_normal((batch, max_t, FEATURES)).astype(np.float32)
  results = []
  for lattice in (plain, generic):
    p = pytree.tree_map(lambda x: x.clone().requires_grad_(True), params)
    f = torch.from_numpy(frames).requires_grad_(True)
    loss = lattice.loss(p, f, torch.from_numpy(num_frames),
                        torch.from_numpy(labels), torch.from_numpy(num_labels))
    finite = torch.isfinite(loss)
    torch.where(finite, loss, 0.0).sum().backward()
    results.append((loss.detach(), pytree.tree_map(lambda x: x.grad, p),
                    f.grad))
  assert (plain.last_path, generic.last_path) == ('plain', 'generic')
  (loss_p, grads_p, frames_p), (loss_g, grads_g, frames_g) = results
  npt.assert_allclose(loss_g.numpy(), loss_p.numpy(), rtol=1e-5, atol=1e-6)
  scale = max(float(g.abs().max()) for g in pytree.tree_leaves(grads_p))
  for got, want in zip(pytree.tree_leaves(grads_g),
                       pytree.tree_leaves(grads_p)):
    npt.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                        atol=1e-4 * max(scale, 1e-6))
  npt.assert_allclose(frames_g.numpy(), frames_p.numpy(), rtol=1e-4,
                      atol=1e-6)
