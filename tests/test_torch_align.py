"""The port's forced alignment (``RecognitionLattice.align``) against the
JAX package.

Same numpy inputs, JAX parameters converted with ``convert.from_jax_params``,
float32 with matmul precision 'highest'. Globally normalized lattices
(``JointWeightFn.label_weights``) and HAT lattices (the numerator kernels'
plain versions in the port; JAX's XLA route and its numerator kernel in
interpret mode), FrameDependent, FrameLabelDependent(1) and (2): the emit
frames equal JAX's exactly on every feasible row and the scores to rtol
1e-5; an infeasible transcript scores -inf on both sides, an empty row
emits nothing. Then the alignment's own structure: aligning the decoded
transcript reproduces the decode, and no gradient reaches the parameters.
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
from last_torch_tpu.ops import numerator_scan as jax_numerator_scan
import last_torch_tpu_torch
from last_torch_tpu_torch import alignments, contexts, convert, weight_fns
from last_torch_tpu_torch.ops import numerator_scan

torch.set_num_threads(1)
torch.set_float32_matmul_precision('highest')

VOCAB, EMBEDDING, FEATURES = 6, 8, 5
# JAX's numerator kernel (interpret mode) needs hidden % 128 == 0.
HIDDEN = {'gn': 8, 'hat': 128}
MAX_T = 9
NUM_FRAMES = np.array([9, 6, 2, 0], np.int32)
LABELS = np.array([[2, 5, 1, 3, 6, 1], [4, 4, 1, 2, 0, 0],
                   [1, 2, 3, 4, 5, 6], [0, 0, 0, 0, 0, 0]], np.int32)
# Row 2 has 4 labels in 2 frames: infeasible under FrameDependent and
# FrameLabelDependent(1) (one label a frame), feasible under
# FrameLabelDependent(2) (two). Row 3 is
# empty.
NUM_LABELS = np.array([5, 4, 4, 0], np.int32)
ALIGNMENTS = {
    'fd': (jax_alignments.FrameDependent, alignments.FrameDependent, 1),
    'fld1': (lambda: jax_alignments.FrameLabelDependent(1),
             lambda: alignments.FrameLabelDependent(1), 1),
    'fld2': (lambda: jax_alignments.FrameLabelDependent(2),
             lambda: alignments.FrameLabelDependent(2), 2),
}


def lattices(model, alignment, fused='never'):
  hidden = HIDDEN[model]
  jax_alignment, torch_alignment, _ = ALIGNMENTS[alignment]

  def jax_wf(ctx):
    joint = jax_weight_fns.JointWeightFn(vocab_size=ctx.shape()[1],
                                         hidden_size=hidden)
    return (joint if model == 'gn' else
            jax_weight_fns.LocallyNormalizedWeightFn(joint))

  def torch_wf(ctx):
    joint = weight_fns.JointWeightFn(vocab_size=ctx.shape()[1],
                                     hidden_size=hidden)
    return (joint if model == 'gn' else
            weight_fns.LocallyNormalizedWeightFn(joint))

  jax_lattice = last_torch_tpu.RecognitionLattice(
      context=jax_contexts.FullNGram(vocab_size=VOCAB, context_size=1),
      alignment=jax_alignment(),
      weight_fn_cacher_factory=lambda ctx: jax_weight_fns.SharedEmbCacher(
          num_context_states=ctx.shape()[0], embedding_size=EMBEDDING),
      weight_fn_factory=jax_wf, fused=fused)
  torch_lattice = last_torch_tpu_torch.RecognitionLattice(
      context=contexts.FullNGram(vocab_size=VOCAB, context_size=1),
      alignment=torch_alignment(),
      weight_fn_cacher_factory=lambda ctx: weight_fns.SharedEmbCacher(
          num_context_states=ctx.shape()[0], embedding_size=EMBEDDING),
      weight_fn_factory=torch_wf)
  return jax_lattice, torch_lattice


def inputs(jax_lattice, seed):
  params = jax_lattice.init(jax.random.PRNGKey(seed), feature_size=FEATURES)
  params = jax.tree.map(np.asarray, params)
  frames = np.random.default_rng(seed).standard_normal(
      (len(NUM_FRAMES), MAX_T, FEATURES)).astype(np.float32)
  return params, frames


def feasible(alignment):
  per_frame = ALIGNMENTS[alignment][2]
  return NUM_LABELS <= per_frame * NUM_FRAMES


@pytest.mark.parametrize('model,alignment,jax_route', [
    ('gn', 'fd', 'xla'), ('gn', 'fld1', 'xla'), ('gn', 'fld2', 'xla'),
    ('hat', 'fd', 'xla'), ('hat', 'fld1', 'xla'), ('hat', 'fld2', 'xla'),
    ('hat', 'fld2', 'interpret'),
])
def test_align_matches_jax(monkeypatch, model, alignment, jax_route):
  if jax_route == 'interpret':
    monkeypatch.setattr(jax_numerator_scan, 'FORCE_INTERPRET', True)
  jax_lattice, torch_lattice = lattices(model, alignment)
  params, frames = inputs(jax_lattice, seed=3)
  emit_j, scores_j = jax_lattice.align(params, frames, NUM_FRAMES, LABELS,
                                       NUM_LABELS)
  emit_j, scores_j = np.asarray(emit_j), np.asarray(scores_j)
  before = numerator_scan.forward_launches
  emit, scores = torch_lattice.align(
      convert.from_jax_params(params, device='cpu'), torch.from_numpy(frames),
      torch.from_numpy(NUM_FRAMES), torch.from_numpy(LABELS),
      torch.from_numpy(NUM_LABELS))
  assert numerator_scan.forward_launches == before  # CPU: plain versions
  assert emit.dtype == torch.int32 and emit.shape == LABELS.shape
  ok = feasible(alignment)
  assert ok.all() == (alignment == 'fld2')
  npt.assert_array_equal(emit.numpy()[ok], emit_j[ok])
  assert np.all(np.isfinite(scores.numpy()[ok]))
  npt.assert_allclose(scores.numpy()[ok], scores_j[ok], rtol=1e-5, atol=1e-6)
  assert np.all(np.isneginf(scores.numpy()[~ok]))
  assert np.all(np.isneginf(scores_j[~ok]))
  for b in np.nonzero(ok)[0]:
    row = emit.numpy()[b]
    n = NUM_LABELS[b]
    assert np.all(row[n:] == -1)
    assert np.all((row[:n] >= 0) & (row[:n] < NUM_FRAMES[b]))
    assert np.all(np.diff(row[:n]) >= 0)
  assert scores.numpy()[3] == 0.0  # the empty row: one all-blank path
  if model == 'hat':
    assert np.all(scores.numpy()[ok] <= 0)


@pytest.mark.parametrize('alignment', sorted(ALIGNMENTS))
def test_aligning_the_decode_reproduces_it(alignment):
  jax_lattice, torch_lattice = lattices('gn', alignment)
  params, frames = inputs(jax_lattice, seed=4)
  params = convert.from_jax_params(params, device='cpu')
  frames = torch.from_numpy(frames)
  num_frames = torch.from_numpy(NUM_FRAMES)
  slots, _, path_weights = torch_lattice.shortest_path(params, frames,
                                                       num_frames)
  per_frame = slots.shape[1] // MAX_T
  labels = torch.zeros_like(slots)
  want = torch.full_like(slots, -1)
  num_labels = torch.zeros(len(NUM_FRAMES), dtype=torch.int64)
  for b in range(len(NUM_FRAMES)):
    pos = torch.nonzero(slots[b] > 0)[:, 0]
    labels[b, :len(pos)] = slots[b, pos]
    want[b, :len(pos)] = pos // per_frame
    num_labels[b] = len(pos)
  emit, scores = torch_lattice.align(params, frames, num_frames, labels,
                                     num_labels)
  npt.assert_allclose(scores.numpy(), path_weights.numpy(), rtol=1e-6)
  npt.assert_array_equal(emit.numpy(), want.numpy())


def test_align_differentiates_only_the_mask():
  jax_lattice, torch_lattice = lattices('hat', 'fld2')
  params, frames = inputs(jax_lattice, seed=5)
  params = convert.from_jax_params(params, device='cpu')
  for leaf in pytree.tree_leaves(params):
    leaf.requires_grad_(True)
  frames = torch.from_numpy(frames).requires_grad_(True)
  emit, scores = torch_lattice.align(
      params, frames, torch.from_numpy(NUM_FRAMES), torch.from_numpy(LABELS),
      torch.from_numpy(NUM_LABELS))
  assert not scores.requires_grad
  assert frames.grad is None
  assert all(leaf.grad is None for leaf in pytree.tree_leaves(params))
  # Two batch dimensions give the flat batch's answer.
  emit2, scores2 = torch_lattice.align(
      params, frames.detach().reshape(2, 2, MAX_T, FEATURES),
      torch.from_numpy(NUM_FRAMES).reshape(2, 2),
      torch.from_numpy(LABELS).reshape(2, 2, -1),
      torch.from_numpy(NUM_LABELS).reshape(2, 2))
  npt.assert_array_equal(emit2.reshape(4, -1).numpy(), emit.numpy())
  npt.assert_allclose(scores2.reshape(4).numpy(), scores.numpy(), rtol=1e-6)


@pytest.mark.parametrize('context_size,alignment', [(2, 'fd'), (1, 'fld2')])
def test_table_lattice_loss_and_align_match_jax(context_size, alignment):
  """A ``TableWeightFn`` lattice (the JAX package's bench config 3 kind):
  its string weights come from the table's exact lookups
  (``TableWeightFn.label_weights``), its log Z from the generic route with
  a None cache."""
  vocab = 3
  num_states = jax_contexts.FullNGram(vocab_size=vocab,
                                      context_size=context_size).shape()[0]
  rng = np.random.default_rng(context_size)
  table = rng.normal(size=(2, 4, num_states, 1 + vocab)).astype(np.float32)
  frames = rng.integers(0, 4, size=(2, 5, 1)).astype(np.float32)
  num_frames = np.asarray([5, 3], np.int32)
  labels = np.asarray([[1, 3, 2], [2, 0, 0]], np.int32)
  num_labels = np.asarray([3, 1], np.int32)
  jax_alignment, torch_alignment, _ = ALIGNMENTS[alignment]
  jax_lattice = last_torch_tpu.RecognitionLattice(
      context=jax_contexts.FullNGram(vocab_size=vocab,
                                     context_size=context_size),
      alignment=jax_alignment(),
      weight_fn_cacher_factory=lambda ctx: jax_weight_fns.NullCacher(),
      weight_fn_factory=lambda ctx: jax_weight_fns.TableWeightFn(
          jnp.asarray(table)))
  lattice = last_torch_tpu_torch.RecognitionLattice(
      context=contexts.FullNGram(vocab_size=vocab, context_size=context_size),
      alignment=torch_alignment(),
      weight_fn_cacher_factory=lambda ctx: weight_fns.NullCacher(),
      weight_fn_factory=lambda ctx: weight_fns.TableWeightFn(
          convert.from_jax_params(table, device='cpu')))
  params = lattice.init(torch.Generator(), feature_size=1, device='cpu')
  jax_params = {'cacher': {}, 'weight_fn': {}}
  args = (torch.from_numpy(frames), torch.from_numpy(num_frames),
          torch.from_numpy(labels), torch.from_numpy(num_labels))
  frames_t = args[0].clone().requires_grad_(True)
  loss = lattice.loss(params, frames_t, *args[1:])
  want = jax_lattice(jax_params, frames, num_frames, labels, num_labels)
  npt.assert_allclose(loss.detach().numpy(), np.asarray(want), rtol=1e-5,
                      atol=1e-6)
  # The frames only index the table: a zero gradient, as in JAX.
  loss.sum().backward()
  assert not bool(frames_t.grad.any())
  emit, scores = lattice.align(params, *args)
  emit_j, scores_j = jax_lattice.align(jax_params, frames, num_frames, labels,
                                       num_labels)
  npt.assert_array_equal(emit.numpy(), np.asarray(emit_j))
  npt.assert_allclose(scores.numpy(), np.asarray(scores_j), rtol=1e-6)
