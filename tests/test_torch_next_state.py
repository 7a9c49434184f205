"""A NextStateTable lattice in the port against the JAX package, and the
lattice's ``fused`` switch.

A random context DFA (7 states, 4 labels; state 0, the start, has no
incoming arc) through both packages on the same numpy inputs, JAX
parameters converted with ``convert.from_jax_params``, JAX on its XLA route
(the only one it has for a NextStateTable): the loss to rtol 1e-5 with
parameter and frame gradients to 1e-4 of the global gradient scale;
``shortest_path`` labels exactly and weights to rtol 1e-5;
``label_marginals`` to 1e-4 of their largest, at FrameDependent and
FrameLabelDependent(2), float32 both sides. Then the port against itself: a
densified bigram ``NextStateTable`` lattice (generic routes) against its
``FullNGram`` lattice (the kernels' plain versions), ``fused='never'``
against ``'auto'``, and a densified trigram of 1057 states, whose
per-frame ``JointWeightFn.apply`` runs the joint+head plain versions,
counted per call.
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
from last_torch_tpu import weight_fns as jax_weight_fns
import last_torch_tpu_torch
from last_torch_tpu_torch import alignments, contexts, convert, weight_fns
from last_torch_tpu_torch.ops import fused_scan, joint_head, trigram_scan

torch.set_num_threads(1)
torch.set_float32_matmul_precision('highest')

HIDDEN, EMBEDDING, FEATURES = 8, 8, 6
NUM_FRAMES = np.array([6, 3, 0], np.int32)  # full, padded, empty
LABELS = np.array([[2, 4, 1], [3, 0, 0], [0, 0, 0]], np.int32)
NUM_LABELS = np.array([3, 1, 0], np.int32)
ALIGNMENTS = {
    'fd': (jax_alignments.FrameDependent, alignments.FrameDependent),
    'fld2': (lambda: jax_alignments.FrameLabelDependent(2),
             lambda: alignments.FrameLabelDependent(2)),
}


def random_table(num_states=7, vocab=4, seed=0):
  """Destinations in [1, num_states): the start state has in-degree 0."""
  return np.random.default_rng(seed).integers(
      1, num_states, size=(num_states, vocab)).astype(np.int32)


def jax_lattice(alignment, table):
  return last_torch_tpu.RecognitionLattice(
      context=jax_contexts.NextStateTable(jnp.asarray(table)),
      alignment=ALIGNMENTS[alignment][0](),
      weight_fn_cacher_factory=lambda ctx: jax_weight_fns.SharedEmbCacher(
          num_context_states=ctx.shape()[0], embedding_size=EMBEDDING),
      weight_fn_factory=lambda ctx: jax_weight_fns.JointWeightFn(
          vocab_size=ctx.shape()[1], hidden_size=HIDDEN))


def torch_lattice(alignment, context, fused='auto'):
  return last_torch_tpu_torch.RecognitionLattice(
      context=context,
      alignment=ALIGNMENTS[alignment][1](),
      weight_fn_cacher_factory=lambda ctx: weight_fns.SharedEmbCacher(
          num_context_states=ctx.shape()[0], embedding_size=EMBEDDING),
      weight_fn_factory=lambda ctx: weight_fns.JointWeightFn(
          vocab_size=ctx.shape()[1], hidden_size=HIDDEN),
      fused=fused)


def make_inputs(seed, table):
  params = jax_lattice('fd', table).init(jax.random.PRNGKey(seed),
                                         feature_size=FEATURES)
  frames = np.random.default_rng(seed).standard_normal(
      (len(NUM_FRAMES), 6, FEATURES)).astype(np.float32)
  return jax.tree.map(np.asarray, params), frames


def torch_loss_and_grads(lattice, params, frames):
  params = pytree.tree_map(lambda x: x.detach().clone().requires_grad_(True),
                           params)
  frames = torch.from_numpy(frames).requires_grad_(True)
  loss = lattice.loss(params, frames, torch.from_numpy(NUM_FRAMES),
                      torch.from_numpy(LABELS), torch.from_numpy(NUM_LABELS))
  loss.sum().backward()
  return (loss.detach().numpy(),
          pytree.tree_map(lambda x: x.grad.numpy(), params),
          frames.grad.numpy())


def assert_grads_close(got, want, rtol=1e-4):
  """Each leaf to rtol of the global gradient scale."""
  got, want = pytree.tree_leaves(got), pytree.tree_leaves(want)
  scale = max(float(np.abs(w).max()) for w in want)
  for g, w in zip(got, want):
    npt.assert_allclose(g, w, rtol=0, atol=rtol * scale)


def posteriors_close(got, want, rtol=1e-4):
  for g, w in zip(got, want):
    g, w = np.asarray(g), np.asarray(w)
    assert g.shape == w.shape
    assert np.abs(g - w).max() <= rtol * np.abs(w).max()


@pytest.mark.parametrize('alignment', ['fd', 'fld2'])
def test_next_state_table_lattice_matches_jax(alignment):
  table = random_table()
  params, frames = make_inputs(1, table)
  reference = jax_lattice(alignment, table)
  lattice = torch_lattice(alignment, contexts.NextStateTable(table))
  torch_params = convert.from_jax_params(params, device='cpu')

  def total(p, f):
    return jnp.sum(reference(p, f, NUM_FRAMES, LABELS, NUM_LABELS))

  value_j, (d_params_j, d_frames_j) = jax.value_and_grad(
      total, argnums=(0, 1))(jax.tree.map(jnp.asarray, params),
                             jnp.asarray(frames))
  loss, d_params, d_frames = torch_loss_and_grads(lattice, torch_params,
                                                  frames)
  assert lattice.last_path == 'generic'
  npt.assert_allclose(loss.sum(), float(value_j), rtol=1e-5, atol=1e-6)
  assert_grads_close(d_params, jax.tree.map(np.asarray, d_params_j))
  npt.assert_allclose(d_frames, np.asarray(d_frames_j), rtol=1e-4, atol=1e-6)
  assert np.all(d_frames[1, 3:] == 0) and np.all(d_frames[2] == 0)

  frames_t, num_frames_t = torch.from_numpy(frames), torch.from_numpy(
      NUM_FRAMES)
  labels, num_labels, weights = lattice.shortest_path(torch_params, frames_t,
                                                      num_frames_t)
  labels_j, num_labels_j, weights_j = reference.shortest_path(
      params, frames, NUM_FRAMES)
  npt.assert_array_equal(labels.numpy(), np.asarray(labels_j))
  npt.assert_array_equal(num_labels.numpy(), np.asarray(num_labels_j))
  npt.assert_allclose(weights.numpy(), np.asarray(weights_j), rtol=1e-5,
                      atol=1e-6)
  posteriors_close(
      lattice.label_marginals(torch_params, frames_t, num_frames_t),
      reference.label_marginals(params, frames, NUM_FRAMES))
  assert lattice.last_path == 'generic'


def test_next_state_table_never_enters_the_kernel_gates():
  for context_size in (1, 2):
    table = contexts.FullNGram(3, context_size).next_state_table()
    lattice = torch_lattice('fld2', contexts.NextStateTable(table))
    frames = torch.zeros((2, 4, FEATURES))
    assert not fused_scan.supported(lattice, frames)
    assert not trigram_scan.supported(lattice, frames)
    assert not lattice.would_fuse(frames)


@pytest.mark.parametrize('alignment', ['fd', 'fld2'])
def test_densified_bigram_matches_full_ngram_lattice(alignment):
  """The same function through the generic routes (NextStateTable) and the
  kernels' plain versions (FullNGram)."""
  vocab = 4
  ngram = contexts.FullNGram(vocab, 1)
  params, frames = make_inputs(2, np.asarray(ngram.next_state_table()))
  torch_params = convert.from_jax_params(params, device='cpu')
  dense = torch_lattice(alignment, contexts.NextStateTable(
      ngram.next_state_table()))
  kernel = torch_lattice(alignment, ngram)
  loss_d, grads_d, frames_d = torch_loss_and_grads(dense, torch_params,
                                                   frames)
  loss_k, grads_k, frames_k = torch_loss_and_grads(kernel, torch_params,
                                                   frames)
  assert (dense.last_path, kernel.last_path) == ('generic', 'plain')
  npt.assert_allclose(loss_d, loss_k, rtol=1e-5, atol=1e-6)
  assert_grads_close(grads_d, grads_k)
  npt.assert_allclose(frames_d, frames_k, rtol=1e-4, atol=1e-6)
  frames_t, num_frames_t = torch.from_numpy(frames), torch.from_numpy(
      NUM_FRAMES)
  decode_d = dense.shortest_path(torch_params, frames_t, num_frames_t)
  decode_k = kernel.shortest_path(torch_params, frames_t, num_frames_t)
  npt.assert_array_equal(decode_d[0].numpy(), decode_k[0].numpy())
  npt.assert_allclose(decode_d[2].numpy(), decode_k[2].numpy(), rtol=1e-5)
  posteriors_close(dense.label_marginals(torch_params, frames_t,
                                         num_frames_t),
                   kernel.label_marginals(torch_params, frames_t,
                                          num_frames_t))


@pytest.mark.parametrize('alignment', ['fd', 'fld2'])
def test_fused_never_matches_auto(alignment):
  ngram = contexts.FullNGram(5, 1)
  params, frames = make_inputs(3, np.asarray(ngram.next_state_table()))
  torch_params = convert.from_jax_params(params, device='cpu')
  auto = torch_lattice(alignment, ngram)
  never = torch_lattice(alignment, ngram, fused='never')
  frames_t = torch.zeros((3, 6, FEATURES))
  assert auto.would_fuse(frames_t) and not never.would_fuse(frames_t)
  assert not auto.would_fuse(frames_t,
                             semiring=last_torch_tpu_torch.semirings.
                             MaxTropical)
  loss_a, grads_a, frames_a = torch_loss_and_grads(auto, torch_params, frames)
  assert auto.last_path == 'plain'
  loss_n, grads_n, frames_n = torch_loss_and_grads(never, torch_params,
                                                   frames)
  assert never.last_path == 'generic'
  npt.assert_allclose(loss_n, loss_a, rtol=1e-5, atol=1e-6)
  assert_grads_close(grads_n, grads_a)
  npt.assert_allclose(frames_n, frames_a, rtol=1e-4, atol=1e-6)
  frames_t, num_frames_t = torch.from_numpy(frames), torch.from_numpy(
      NUM_FRAMES)
  decode_a = auto.shortest_path(torch_params, frames_t, num_frames_t)
  assert auto.last_path == 'plain'
  decode_n = never.shortest_path(torch_params, frames_t, num_frames_t)
  assert never.last_path == 'generic'
  npt.assert_array_equal(decode_n[0].numpy(), decode_a[0].numpy())
  npt.assert_allclose(decode_n[2].numpy(), decode_a[2].numpy(), rtol=1e-5)
  posteriors_close(never.label_marginals(torch_params, frames_t,
                                         num_frames_t),
                   auto.label_marginals(torch_params, frames_t,
                                        num_frames_t))
  assert never.last_path == 'generic'


def test_fused_takes_auto_or_never():
  ngram = contexts.FullNGram(3, 1)
  with pytest.raises(ValueError, match='interpret'):
    torch_lattice('fd', ngram, fused='interpret')
  with pytest.raises(ValueError, match="'auto' or 'never'"):
    torch_lattice('fd', ngram, fused='always')


class CountingPair:
  """The joint+head plain versions, counted per call."""

  def __init__(self):
    self.forward = self.backward = 0

  def run_forward(self, *args, **kwargs):
    self.forward += 1
    return joint_head.joint_head_forward_plain(*args, **kwargs)

  def run_backward(self, *args, **kwargs):
    self.backward += 1
    return joint_head.joint_head_backward_plain(*args, **kwargs)


def test_large_dfa_runs_the_joint_head_per_frame():
  """A densified trigram (S = 1057 >= 1024 states) through the generic
  routes runs every frame's apply through the joint+head path: T_max
  forwards in the log-partition's forward, T_max more and T_max backwards
  in its backward; 2 T_max forwards and no backward in a decode (the
  checkpoint's recompute) and in label_marginals. Its loss and gradients
  equal the trigram kernels' plain versions on the FullNGram lattice."""
  vocab, max_t = 32, 3
  ngram = contexts.FullNGram(vocab, 2)
  dense = torch_lattice('fld2', contexts.NextStateTable(
      ngram.next_state_table()))
  kernel = torch_lattice('fld2', ngram)
  params = kernel.init(torch.Generator().manual_seed(0), FEATURES,
                       device='cpu')
  rng = np.random.default_rng(4)
  frames = rng.standard_normal((2, max_t, FEATURES)).astype(np.float32)
  num_frames = torch.tensor([3, 2])
  labels = torch.tensor([[5, 17], [32, 0]])
  num_labels = torch.tensor([2, 1])
  pair = CountingPair()
  results = []
  for lattice in (dense, kernel):
    p = pytree.tree_map(lambda x: x.clone().requires_grad_(True), params)
    f = torch.from_numpy(frames).requires_grad_(True)
    with joint_head.using(pair.run_forward, pair.run_backward):
      loss = lattice.loss(p, f, num_frames, labels, num_labels)
      if lattice is dense:
        assert (pair.forward, pair.backward) == (max_t, 0)
      loss.sum().backward()
    results.append((loss.detach(), pytree.tree_leaves(
        pytree.tree_map(lambda x: x.grad, p)), f.grad))
    # The trigram kernels' route never calls apply.
    assert (pair.forward, pair.backward) == (2 * max_t, max_t)
  assert (dense.last_path, kernel.last_path) == ('generic', 'plain')
  (loss_d, grads_d, frames_d), (loss_k, grads_k, frames_k) = results
  npt.assert_allclose(loss_d.numpy(), loss_k.numpy(), rtol=1e-5)
  assert_grads_close([g.numpy() for g in grads_d],
                     [g.numpy() for g in grads_k])
  npt.assert_allclose(frames_d.numpy(), frames_k.numpy(), rtol=1e-4,
                      atol=1e-6)

  frames_t = torch.from_numpy(frames)
  for method in ('shortest_path', 'label_marginals'):
    pair = CountingPair()
    with joint_head.using(pair.run_forward, pair.run_backward):
      getattr(dense, method)(params, frames_t, num_frames)
    assert (pair.forward, pair.backward) == (2 * max_t, 0), method
  # Outside the gate (fewer states) the einsums run: nothing counted.
  small = torch_lattice('fld2', contexts.NextStateTable(
      contexts.FullNGram(4, 2).next_state_table()))
  small_params = small.init(torch.Generator().manual_seed(0), FEATURES,
                            device='cpu')
  pair = CountingPair()
  with joint_head.using(pair.run_forward, pair.run_backward):
    small.loss(small_params, frames_t, num_frames, labels.clamp(max=4),
               num_labels)
  assert (pair.forward, pair.backward) == (0, 0)
