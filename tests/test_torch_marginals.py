"""The port's per-frame posteriors against the JAX package.

Same numpy inputs, JAX parameters converted with ``convert.from_jax_params``.
``label_marginals`` (the marginals kernel's plain version on CPU tensors) is
held to JAX ``label_marginals`` through its Pallas kernel in interpret mode
and through XLA, to rtol 1e-4 / atol 1e-6 (the tolerance
``test_fused_scan.py`` holds the two JAX routes to; float32 both sides,
sums in another order); ``arc_marginals`` (the generic backward algorithm,
as in JAX) to JAX ``arc_marginals`` at rtol 1e-5 / atol 1e-6. A HAT lattice
takes the generic route in both packages. The marginals kernel is held to
its plain version on the card in ``test_torch_kernels.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

import last_torch_tpu
from last_torch_tpu import alignments as jax_alignments
from last_torch_tpu import contexts as jax_contexts
from last_torch_tpu import weight_fns as jax_weight_fns
import last_torch_tpu_torch
from last_torch_tpu_torch import alignments, contexts, convert, weight_fns
from last_torch_tpu_torch.ops import fused_scan

torch.set_num_threads(1)
torch.set_float32_matmul_precision('highest')

HIDDEN, EMBEDDING, FEATURES = 8, 8, 6
NUM_FRAMES = np.array([5, 3, 0], np.int32)  # full, padded, empty
MAX_T = 5
ALIGNMENTS = {
    'fd': (jax_alignments.FrameDependent, alignments.FrameDependent),
    'fld2': (lambda: jax_alignments.FrameLabelDependent(2),
             lambda: alignments.FrameLabelDependent(2)),
}


def jax_joint(vocab):
  return jax_weight_fns.JointWeightFn(vocab_size=vocab, hidden_size=HIDDEN)


def jax_hat(vocab):
  return jax_weight_fns.LocallyNormalizedWeightFn(jax_joint(vocab))


def torch_joint(vocab):
  return weight_fns.JointWeightFn(vocab_size=vocab, hidden_size=HIDDEN)


def torch_hat(vocab):
  return weight_fns.LocallyNormalizedWeightFn(torch_joint(vocab))


def jax_lattice(alignment, fused, vocab=5, weight_fn=jax_joint,
                context_size=1):
  return last_torch_tpu.RecognitionLattice(
      context=jax_contexts.FullNGram(vocab_size=vocab,
                                     context_size=context_size),
      alignment=ALIGNMENTS[alignment][0](),
      weight_fn_cacher_factory=lambda ctx: jax_weight_fns.SharedEmbCacher(
          num_context_states=ctx.shape()[0], embedding_size=EMBEDDING),
      weight_fn_factory=lambda ctx: weight_fn(ctx.shape()[1]),
      fused=fused)


def torch_lattice(alignment, vocab=5, weight_fn=torch_joint, context_size=1):
  return last_torch_tpu_torch.RecognitionLattice(
      context=contexts.FullNGram(vocab_size=vocab, context_size=context_size),
      alignment=ALIGNMENTS[alignment][1](),
      weight_fn_cacher_factory=lambda ctx: weight_fns.SharedEmbCacher(
          num_context_states=ctx.shape()[0], embedding_size=EMBEDDING),
      weight_fn_factory=lambda ctx: weight_fn(ctx.shape()[1]))


def make_inputs(seed, vocab=5, weight_fn=jax_joint, context_size=1):
  params = jax_lattice('fd', 'never', vocab, weight_fn, context_size).init(
      jax.random.PRNGKey(seed), feature_size=FEATURES)
  frames = (np.random.default_rng(seed).standard_normal(
      (len(NUM_FRAMES), MAX_T, FEATURES)) * 1.5).astype(np.float32)
  return jax.tree.map(np.asarray, params), frames


def port_call(lattice, method, params, frames, **kwargs):
  return getattr(lattice, method)(
      convert.from_jax_params(params, device='cpu'), torch.from_numpy(frames),
      torch.from_numpy(NUM_FRAMES), **kwargs)


@pytest.mark.parametrize('fused', ['interpret', 'never'])
@pytest.mark.parametrize('alignment', sorted(ALIGNMENTS))
def test_label_marginals_match_jax(alignment, fused):
  params, frames = make_inputs(seed=30)
  bm_j, lm_j = jax_lattice(alignment, fused).label_marginals(
      params, frames, NUM_FRAMES)
  lattice = torch_lattice(alignment)
  before = fused_scan.forward_launches, fused_scan.marginals_launches
  bm, lm = port_call(lattice, 'label_marginals', params, frames)
  assert lattice.last_path == 'plain'
  # CPU tensors run the plain versions and launch nothing.
  assert (fused_scan.forward_launches,
          fused_scan.marginals_launches) == before
  assert bm.shape == (3, MAX_T, 6) and lm.shape == (3, MAX_T, 5)
  npt.assert_allclose(bm.numpy(), np.asarray(bm_j), rtol=1e-4, atol=1e-6)
  npt.assert_allclose(lm.numpy(), np.asarray(lm_j), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize('alignment', sorted(ALIGNMENTS))
def test_arc_marginals_match_jax_and_sum_to_label_marginals(alignment):
  params, frames = make_inputs(seed=31)
  bm_j, lm_j = jax_lattice(alignment, 'never').arc_marginals(
      params, frames, NUM_FRAMES)
  lattice = torch_lattice(alignment)
  bm, lm = port_call(lattice, 'arc_marginals', params, frames)
  assert lattice.last_path == 'generic'
  assert lm.shape == (3, MAX_T, 6, 5)
  npt.assert_allclose(bm.numpy(), np.asarray(bm_j), rtol=1e-5, atol=1e-6)
  npt.assert_allclose(lm.numpy(), np.asarray(lm_j), rtol=1e-5, atol=1e-6)
  # Summed over the source states: the label posteriors of the kernels'
  # plain route.
  bm_l, lm_l = port_call(lattice, 'label_marginals', params, frames)
  npt.assert_allclose(lm.sum(dim=-2).numpy(), lm_l.numpy(), rtol=1e-5,
                      atol=1e-6)
  npt.assert_allclose(bm.numpy(), bm_l.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize('alignment', sorted(ALIGNMENTS))
def test_posteriors_normalize_per_frame(alignment):
  params, frames = make_inputs(seed=32)
  bm, lm = port_call(torch_lattice(alignment), 'label_marginals', params,
                     frames)
  valid = (np.arange(MAX_T)[None, :] < NUM_FRAMES[:, None])
  blank = bm.numpy().sum(-1)
  label = lm.numpy().sum(-1)
  if alignment == 'fd':
    # One arc per frame: blank or lexical.
    npt.assert_allclose((blank + label)[valid], 1.0, rtol=1e-5)
  else:
    # Every path takes exactly one blank arc per frame, and up to 2 labels.
    npt.assert_allclose(blank[valid], 1.0, rtol=1e-5)
    assert np.all(label[valid] <= 2.0 + 1e-5)
  assert np.all(bm.numpy() >= 0) and np.all(lm.numpy() >= 0)
  assert np.all(bm.numpy()[~valid] == 0) and np.all(lm.numpy()[~valid] == 0)


def test_arc_marginals_guard_raises():
  params, frames = make_inputs(seed=33)
  # 4 * 3 * 5 * 6 * (5 + 1) = 2160 bytes.
  with pytest.raises(ValueError, match='label_marginals'):
    port_call(torch_lattice('fd'), 'arc_marginals', params, frames,
              max_output_bytes=2159)
  bm, _ = port_call(torch_lattice('fd'), 'arc_marginals', params, frames,
                    max_output_bytes=2160)
  assert bm.shape == (3, MAX_T, 6)


@pytest.mark.parametrize('alignment', sorted(ALIGNMENTS))
def test_ragged_vocabulary_matches_jax_kernel(alignment):
  # V=130: ragged against the port's 64-label tiles and JAX's 128 lanes.
  params, frames = make_inputs(seed=34, vocab=130)
  bm_j, lm_j = jax_lattice(alignment, 'interpret', vocab=130).label_marginals(
      params, frames, NUM_FRAMES)
  bm, lm = port_call(torch_lattice(alignment, vocab=130), 'label_marginals',
                     params, frames)
  npt.assert_allclose(bm.numpy(), np.asarray(bm_j), rtol=1e-4, atol=1e-6)
  npt.assert_allclose(lm.numpy(), np.asarray(lm_j), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize('method', ['label_marginals', 'arc_marginals'])
@pytest.mark.parametrize('alignment', sorted(ALIGNMENTS))
def test_hat_lattice_generic_route_matches_jax(alignment, method):
  params, frames = make_inputs(seed=35, weight_fn=jax_hat)
  want = getattr(jax_lattice(alignment, 'interpret', weight_fn=jax_hat),
                 method)(params, frames, NUM_FRAMES)
  lattice = torch_lattice(alignment, weight_fn=torch_hat)
  got = port_call(lattice, method, params, frames)
  assert lattice.last_path == 'generic'
  for g, w in zip(got, want):
    npt.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)


def test_no_frames_give_empty_posteriors():
  params, _ = make_inputs(seed=36)
  frames = np.zeros((3, 0, FEATURES), np.float32)
  num_frames = torch.zeros(3, dtype=torch.int32)
  torch_params = convert.from_jax_params(params, device='cpu')
  for weight_fn in (torch_joint, torch_hat):
    lattice = torch_lattice('fld2', weight_fn=weight_fn)
    if weight_fn is torch_hat:
      torch_params = lattice.init(torch.Generator().manual_seed(0), FEATURES,
                                  device='cpu')
    bm, lm = lattice.label_marginals(torch_params, torch.from_numpy(frames),
                                     num_frames)
    assert bm.shape == (3, 0, 6) and lm.shape == (3, 0, 5)
  bm, lm = lattice.arc_marginals(torch_params, torch.from_numpy(frames),
                                 num_frames)
  assert bm.shape == (3, 0, 6) and lm.shape == (3, 0, 6, 5)


def test_unported_routes_raise():
  """Routes once unported, now held to JAX's."""
  # S = 1 (context_size 0): the backward algorithm over the factorized
  # route's alpha history, against JAX's single-context-state route.
  for alignment in sorted(ALIGNMENTS):
    params, frames = make_inputs(seed=36, context_size=0)
    ctc = torch_lattice(alignment, context_size=0)
    got = port_call(ctc, 'label_marginals', params, frames)
    assert ctc.last_path == 's1'
    assert got[0].shape == (3, MAX_T, 1) and got[1].shape == (3, MAX_T, 5)
    want = jax_lattice(alignment, 'never',
                       context_size=0).label_marginals(params, frames,
                                                       NUM_FRAMES)
    for g, w in zip(got, want):
      npt.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-6)
  # The trigram now takes the generic route, as in the JAX package.
  params, frames = make_inputs(seed=37, vocab=2, context_size=2)
  trigram = torch_lattice('fd', vocab=2, context_size=2)
  got = port_call(trigram, 'label_marginals', params, frames)
  assert trigram.last_path == 'generic'
  want = jax_lattice('fd', 'interpret', vocab=2,
                     context_size=2).label_marginals(params, frames,
                                                     NUM_FRAMES)
  for g, w in zip(got, want):
    npt.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize('seed', range(4))
def test_fuzz_plain_kernel_route_matches_generic_route(seed):
  """Random small configurations: the marginals kernel's plain version
  (inside the gate) against the generic backward algorithm."""
  rng = np.random.default_rng(200 + seed)
  vocab, k = int(rng.integers(2, 7)), int(rng.integers(0, 3))
  batch, max_t = int(rng.integers(1, 4)), int(rng.integers(1, 6))
  num_frames = torch.from_numpy(
      rng.integers(0, max_t + 1, size=batch).astype(np.int32))
  frames = torch.from_numpy(
      rng.standard_normal((batch, max_t, FEATURES)).astype(np.float32))

  class SubclassedJoint(weight_fns.JointWeightFn):
    """Outside the kernels' gate (the gate wants exactly JointWeightFn)."""

  def make(weight_fn):
    return last_torch_tpu_torch.RecognitionLattice(
        context=contexts.FullNGram(vocab_size=vocab, context_size=1),
        alignment=(alignments.FrameDependent() if k == 0 else
                   alignments.FrameLabelDependent(k)),
        weight_fn_cacher_factory=lambda ctx: weight_fns.SharedEmbCacher(
            num_context_states=ctx.shape()[0], embedding_size=EMBEDDING),
        weight_fn_factory=lambda ctx: weight_fn(vocab_size=vocab,
                                                hidden_size=HIDDEN))

  plain, generic = make(weight_fns.JointWeightFn), make(SubclassedJoint)
  params = plain.init(torch.Generator().manual_seed(seed), FEATURES,
                      device='cpu')
  got = plain.label_marginals(params, frames, num_frames)
  want = generic.label_marginals(params, frames, num_frames)
  assert (plain.last_path, generic.last_path) == ('plain', 'generic')
  for g, w in zip(got, want):
    npt.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5, atol=1e-6)
