"""The port's factorized single-context-state (S = 1) route against the JAX
package and against the port's own generic frame loop.

Every case of ``test_s1_factorized.py``, parametrised the same way, on the
same numpy inputs (JAX parameters carried over with
``convert.from_jax_params``): the port with ``_factorize_s1`` on (its
log-depth cumulative product over time) is held to JAX's S = 1 route
(``lax.associative_scan``) and to the port with ``_factorize_s1`` off (the
per-frame loop). Values to rtol 1e-5 / atol 1e-6 (float32 both sides, the
time products associated in another order), gradients to 1e-4 of the
largest gradient (FrameLabelDependent's ``blank_b`` gradient is a
structural zero made of rounding residue), decoded labels exactly.
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

VOCAB, HIDDEN, EMB = 6, 64, 8
B, T, U = 3, 9, 4
RTOL, ATOL = 1e-5, 1e-6
GRAD_RTOL = 1e-4

ALIGNMENTS = {
    'fd': (jax_alignments.FrameDependent, alignments.FrameDependent),
    'fld1': (lambda: jax_alignments.FrameLabelDependent(1),
             lambda: alignments.FrameLabelDependent(1)),
    'fld2': (lambda: jax_alignments.FrameLabelDependent(2),
             lambda: alignments.FrameLabelDependent(2)),
}
SEMIRINGS = {
    'log': (jax_semirings.Log, semirings.Log),
    'real': (jax_semirings.Real, semirings.Real),
    'max_tropical': (jax_semirings.MaxTropical, semirings.MaxTropical),
}


def joint(package, normalize=None):
  fns = jax_weight_fns if package == 'jax' else weight_fns
  wf = fns.JointWeightFn(vocab_size=VOCAB, hidden_size=HIDDEN)
  if normalize is None:
    return wf
  return fns.LocallyNormalizedWeightFn(wf, normalize=getattr(fns, normalize))


def make_lattices(alignment='fld2', normalize=None):
  jax_lattice = last_torch_tpu.RecognitionLattice(
      context=jax_contexts.FullNGram(vocab_size=VOCAB, context_size=0),
      alignment=ALIGNMENTS[alignment][0](),
      weight_fn_cacher_factory=lambda ctx: jax_weight_fns.SharedEmbCacher(
          num_context_states=ctx.shape()[0], embedding_size=EMB),
      weight_fn_factory=lambda ctx: joint('jax', normalize),
      fused='never')
  torch_lattice = last_torch_tpu_torch.RecognitionLattice(
      context=contexts.FullNGram(vocab_size=VOCAB, context_size=0),
      alignment=ALIGNMENTS[alignment][1](),
      weight_fn_cacher_factory=lambda ctx: weight_fns.SharedEmbCacher(
          num_context_states=ctx.shape()[0], embedding_size=EMB),
      weight_fn_factory=lambda ctx: joint('torch', normalize))
  return jax_lattice, torch_lattice


def jax_params(lattice, seed):
  return jax.tree.map(np.asarray, lattice.init(jax.random.PRNGKey(seed),
                                               feature_size=HIDDEN))


@pytest.fixture
def batch():
  rng = np.random.default_rng(0)
  frames = rng.normal(size=(B, T, HIDDEN)).astype(np.float32)
  num_frames = np.asarray([T, T - 4, 0], np.int32)
  labels = rng.integers(1, VOCAB + 1, size=(B, U)).astype(np.int32)
  num_labels = np.asarray([U, U - 2, 0], np.int32)
  return frames, num_frames, labels, num_labels


def both_routes(lattice, fn, generic_path='generic'):
  """fn() with the factorized route, then with the generic frame loop;
  checks the path the second took (a locally normalized loss, which has no
  log-partition, leaves ``last_path`` as it was: None)."""
  lattice._factorize_s1 = True
  factorized = fn()
  path = lattice.last_path
  lattice._factorize_s1 = False
  generic = fn()
  assert lattice.last_path == generic_path
  lattice._factorize_s1 = True
  return factorized, generic, path


def leaves(tree):
  return [np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor)
                     else x) for x in pytree.tree_leaves(tree)]


def assert_values_close(got, want, rtol=RTOL, atol=ATOL):
  got, want = leaves(got), leaves(jax.tree.map(np.asarray, want))
  assert len(got) == len(want)
  for g, w in zip(got, want):
    npt.assert_allclose(g, w, rtol=rtol, atol=atol)


def assert_grads_close(got, want, rtol=GRAD_RTOL):
  """Leaf by leaf (same tree order), to rtol of the global scale."""
  got, want = leaves(got), leaves(want)
  assert len(got) == len(want)
  scale = max(float(np.abs(w).max()) for w in want)
  for g, w in zip(got, want):
    npt.assert_allclose(g, w, rtol=0, atol=rtol * scale)


def port_params(params, requires_grad=False):
  params = convert.from_jax_params(params, device='cpu')
  for leaf in pytree.tree_leaves(params):
    leaf.requires_grad_(requires_grad)
  return params


def t(x):
  return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize('semiring', sorted(SEMIRINGS))
@pytest.mark.parametrize('alignment', sorted(ALIGNMENTS))
def test_distance_and_history_match_scan(batch, semiring, alignment):
  frames, num_frames, _, _ = batch
  jax_sr, sr = SEMIRINGS[semiring]
  jax_lattice, lattice = make_lattices(alignment)
  params = jax_params(jax_lattice, 0)
  want = jax_lattice._forward(params, jax_lattice.build_cache(params),
                              jnp.asarray(frames), num_frames, jax_sr)
  assert jax_lattice.last_path == 'xla-s1'
  torch_params = port_params(params)
  cache = lattice.build_cache(torch_params)
  with torch.no_grad():
    got, generic, path = both_routes(lattice, lambda: lattice._forward(
        torch_params, cache, t(frames), t(num_frames), sr))
  assert path == 's1'
  assert got[1].shape == (B, T, 1)
  assert_values_close(got, want)
  assert_values_close(got, generic)


def test_gradients_match_scan(batch):
  frames, num_frames, _, _ = batch
  jax_lattice, lattice = make_lattices()
  params = jax_params(jax_lattice, 0)

  def jax_log_z(p, f):
    d, _ = jax_lattice._forward(p, jax_lattice.build_cache(p), f, num_frames,
                                jax_semirings.Log)
    return jnp.sum(d)

  want = jax.grad(jax_log_z, argnums=(0, 1))(params, jnp.asarray(frames))

  def grads():
    p = port_params(params, requires_grad=True)
    f = t(frames).requires_grad_()
    d, _ = lattice._forward(p, lattice.build_cache(p), f, t(num_frames),
                            semirings.Log)
    d.sum().backward()
    return [leaf.grad for leaf in pytree.tree_leaves(p)] + [f.grad]

  got, generic, path = both_routes(lattice, grads)
  assert path == 's1'
  want = jax.tree.leaves(want[0]) + [want[1]]
  assert_grads_close(got, want)
  assert_grads_close(got, generic)


def test_mask_gradients_match_scan(batch):
  """The mask-gradient trick (arc marginals, shortest path) holds on the
  factorized route."""
  frames, num_frames, _, _ = batch
  jax_lattice, lattice = make_lattices()
  params = jax_params(jax_lattice, 0)
  jax_cache = jax_lattice.build_cache(params)
  num_align = lattice.alignment.num_states()
  torch_params = port_params(params)
  cache = lattice.build_cache(torch_params)

  for jax_sr, sr in (SEMIRINGS['log'], SEMIRINGS['max_tropical']):
    def jax_distance(bm, lm):
      d, _ = jax_lattice._forward(params, jax_cache, jnp.asarray(frames),
                                  num_frames, jax_sr, blank_mask=bm,
                                  lexical_mask=lm)
      return jnp.sum(d)

    want = jax.grad(jax_distance, argnums=(0, 1))(
        [jnp.zeros((B, T, 1))] * num_align,
        [jnp.zeros((B, T, 1, VOCAB))] * num_align)

    def grads():
      bm = [torch.zeros((B, T, 1), requires_grad=True)
            for _ in range(num_align)]
      lm = [torch.zeros((B, T, 1, VOCAB), requires_grad=True)
            for _ in range(num_align)]
      d, _ = lattice._forward(torch_params, cache, t(frames), t(num_frames),
                              sr, blank_mask=bm, lexical_mask=lm)
      d.sum().backward()
      # FLD's last expansion state has no lexical arc: no gradient.
      return [torch.zeros_like(m) if m.grad is None else m.grad
              for m in bm + lm]

    got, generic, _ = both_routes(lattice, grads)
    want = jax.tree.leaves(want[0]) + jax.tree.leaves(want[1])
    for g, w, o in zip(leaves(got), leaves(want), leaves(generic)):
      npt.assert_allclose(g, w, rtol=GRAD_RTOL, atol=ATOL)
      npt.assert_allclose(g, o, rtol=GRAD_RTOL, atol=ATOL)


def test_expectation_weight_lift_matches_scan(batch):
  """A tuple semiring and a weight_lift (the entropy route) factorize too."""
  frames, num_frames, _, _ = batch
  jax_lattice, lattice = make_lattices()
  params = jax_params(jax_lattice, 0)
  jax_sr = jax_semirings.LogLogExpectation
  jax_lift = lambda w: jax_sr.weighted(w, jnp.log(jnp.maximum(-w, 1e-30)))
  want, _ = jax_lattice._forward(params, jax_lattice.build_cache(params),
                                 jnp.asarray(frames), num_frames, jax_sr,
                                 weight_lift=jax_lift)
  assert jax_lattice.last_path == 'xla-s1'
  sr = semirings.LogLogExpectation
  lift = lambda w: sr.weighted(w, torch.log(torch.clamp(-w, min=1e-30)))
  torch_params = port_params(params)
  cache = lattice.build_cache(torch_params)
  with torch.no_grad():
    got, generic, path = both_routes(lattice, lambda: lattice._forward(
        torch_params, cache, t(frames), t(num_frames), sr,
        weight_lift=lift)[0])
  assert path == 's1'
  assert isinstance(got, tuple) and len(got) == 2
  assert_values_close(got, want)
  assert_values_close(got, generic)


def test_table_weight_fn_matches_scan():
  """A TableWeightFn reads its batch dimensions first: the one application
  over every frame (time as a trailing batch dimension) keeps its exact
  gathers."""
  rng = np.random.default_rng(1)
  num_input_labels = 5
  table = rng.normal(size=(B, num_input_labels, 1, 1 + VOCAB)).astype(
      np.float32)
  jax_lattice = last_torch_tpu.RecognitionLattice(
      context=jax_contexts.FullNGram(vocab_size=VOCAB, context_size=0),
      alignment=jax_alignments.FrameDependent(),
      weight_fn_cacher_factory=lambda ctx: jax_weight_fns.NullCacher(),
      weight_fn_factory=lambda ctx: jax_weight_fns.TableWeightFn(
          jnp.asarray(table)),
      fused='never')
  lattice = last_torch_tpu_torch.RecognitionLattice(
      context=contexts.FullNGram(vocab_size=VOCAB, context_size=0),
      alignment=alignments.FrameDependent(),
      weight_fn_cacher_factory=lambda ctx: weight_fns.NullCacher(),
      weight_fn_factory=lambda ctx: weight_fns.TableWeightFn(t(table)))
  frames = rng.integers(0, num_input_labels, size=(B, T, 1)).astype(
      np.float32)
  num_frames = np.asarray([T, T - 2, 1], np.int32)
  jax_p = jax_lattice.init(jax.random.PRNGKey(0), feature_size=1)
  want = jax_lattice._forward(jax_p, jax_lattice.build_cache(jax_p),
                              jnp.asarray(frames), num_frames,
                              jax_semirings.Log)
  params = lattice.init(torch.Generator().manual_seed(0), feature_size=1,
                        device='cpu')
  got, generic, path = both_routes(lattice, lambda: lattice._forward(
      params, None, t(frames), t(num_frames), semirings.Log))
  assert path == 's1'
  assert_values_close(got, want)
  assert_values_close(got, generic)


def loss_and_grads(jax_lattice, lattice, params, batch,
                   generic_path='generic'):
  frames, num_frames, labels, num_labels = batch

  def jax_loss(p):
    return jnp.sum(jax_lattice(p, jnp.asarray(frames), num_frames, labels,
                               num_labels))

  value_j, grads_j = jax.value_and_grad(jax_loss)(params)

  def port():
    p = port_params(params, requires_grad=True)
    loss = lattice.loss(p, t(frames), t(num_frames), t(labels),
                        t(num_labels))
    loss.sum().backward()
    return [loss.detach()] + [leaf.grad for leaf in pytree.tree_leaves(p)]

  got, generic, path = both_routes(lattice, port, generic_path)
  return (float(value_j), jax.tree.leaves(grads_j)), got, generic, path


def test_loss_and_grads_match_scan(batch):
  jax_lattice, lattice = make_lattices()
  params = jax_params(jax_lattice, 0)
  (value_j, grads_j), got, generic, path = loss_and_grads(
      jax_lattice, lattice, params, batch)
  assert jax_lattice.last_path == 'xla-s1'
  assert path == 's1'
  npt.assert_allclose(float(got[0].sum()), value_j, rtol=RTOL, atol=ATOL)
  npt.assert_allclose(got[0].numpy(), generic[0].numpy(), rtol=RTOL,
                      atol=ATOL)
  assert got[0][2] == 0.0  # no frames, no labels
  assert_grads_close(got[1:], grads_j)
  assert_grads_close(got[1:], generic[1:])


def test_shortest_path_matches_scan(batch):
  frames, num_frames, _, _ = batch
  jax_lattice, lattice = make_lattices()
  params = jax_params(jax_lattice, 1)
  labels_j, num_j, weights_j = jax_lattice.shortest_path(
      params, jnp.asarray(frames), num_frames)
  torch_params = port_params(params)
  with torch.no_grad():
    got, generic, path = both_routes(lattice, lambda: lattice.shortest_path(
        torch_params, t(frames), t(num_frames)))
  assert path == 's1'
  for out in (got, generic):
    npt.assert_array_equal(out[0].numpy(), np.asarray(labels_j))
    npt.assert_array_equal(out[1].numpy(), np.asarray(num_j))
  npt.assert_allclose(got[2].numpy(), np.asarray(weights_j), rtol=RTOL,
                      atol=ATOL)
  npt.assert_allclose(got[2].numpy(), generic[2].numpy(), rtol=RTOL,
                      atol=ATOL)


def test_label_marginals_match_scan(batch):
  """The alpha history of the factorized forward feeds the backward
  algorithm."""
  frames, num_frames, _, _ = batch
  jax_lattice, lattice = make_lattices()
  params = jax_params(jax_lattice, 2)
  want = jax_lattice.label_marginals(params, jnp.asarray(frames), num_frames)
  torch_params = port_params(params)
  got, generic, path = both_routes(lattice, lambda: lattice.label_marginals(
      torch_params, t(frames), t(num_frames)))
  assert path == 's1'
  assert got[0].shape == (B, T, 1) and got[1].shape == (B, T, VOCAB)
  assert_values_close(got, want, rtol=1e-4)
  assert_values_close(got, generic, rtol=1e-4)


@pytest.mark.parametrize('normalize', ['hat', 'softmax'])
def test_locally_normalized_matches_scan(batch, normalize):
  """HAT / softmax at S = 1: the string weights gathered from the one
  application equal the per-position ``label_weights`` route, values and
  gradients."""
  name = 'hat_normalize' if normalize == 'hat' else 'log_softmax_normalize'
  jax_lattice, lattice = make_lattices(normalize=name)
  params = jax_params(jax_lattice, 0)
  (value_j, grads_j), got, generic, path = loss_and_grads(
      jax_lattice, lattice, params, batch, generic_path=None)
  assert path is None
  npt.assert_allclose(float(got[0].sum()), value_j, rtol=RTOL, atol=ATOL)
  npt.assert_allclose(got[0].numpy(), generic[0].numpy(), rtol=RTOL,
                      atol=ATOL)
  assert_grads_close(got[1:], grads_j)
  assert_grads_close(got[1:], generic[1:])


def test_global_loss_shares_one_weight_application(batch, monkeypatch):
  """The globally normalized S = 1 loss applies the weight function once
  for numerator and denominator together."""
  frames, num_frames, labels, num_labels = batch
  jax_lattice, lattice = make_lattices()
  params = jax_params(jax_lattice, 0)
  want = jax_lattice(params, jnp.asarray(frames), num_frames, labels,
                     num_labels)
  calls = []
  apply = weight_fns.JointWeightFn.apply
  monkeypatch.setattr(weight_fns.JointWeightFn, 'apply',
                      lambda *a, **k: (calls.append(1), apply(*a, **k))[1])
  got = lattice.loss(port_params(params), t(frames), t(num_frames),
                     t(labels), t(num_labels))
  assert len(calls) == 1, f'weight_fn.apply ran {len(calls)} times'
  assert lattice.last_path == 's1'
  npt.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=RTOL,
                      atol=ATOL)


def test_zero_and_full_lengths(batch):
  """num_frames of 0 and of T reduce exactly as the frame loop does."""
  frames, _, _, _ = batch
  jax_lattice, lattice = make_lattices()
  params = jax_params(jax_lattice, 0)
  num_frames = np.asarray([0, T, 1], np.int32)
  want, _ = jax_lattice._forward(params, jax_lattice.build_cache(params),
                                 jnp.asarray(frames), num_frames,
                                 jax_semirings.Log)
  torch_params = port_params(params)
  cache = lattice.build_cache(torch_params)
  with torch.no_grad():
    got, generic, _ = both_routes(lattice, lambda: lattice._forward(
        torch_params, cache, t(frames), t(num_frames), semirings.Log)[0])
  npt.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
  npt.assert_allclose(got.numpy(), generic.numpy(), rtol=RTOL, atol=ATOL)
  # An all-padding row has one path, the empty one, of weight one.
  assert got[0] == 0.0
  # No frames at all: the frame loop, as in the JAX package (the factorized
  # route needs T > 0).
  with torch.no_grad():
    empty, _ = lattice._forward(torch_params, cache, t(frames[:, :0]),
                                t(num_frames * 0), semirings.Log)
  assert lattice.last_path == 'generic'
  npt.assert_array_equal(empty.numpy(), np.zeros(B, np.float32))
