"""The port's trigram lattice (FullNGram(context_size=2)) and model against
the JAX package.

Same numpy inputs, JAX parameters converted with ``convert.from_jax_params``,
float32 on both sides with matmul precision 'highest'. The trigram
log-partition's plain versions (CPU tensors) are held to JAX
``trigram_scan.log_partition`` with its Pallas kernels in interpret mode and
to JAX's XLA route (``_forward`` differentiated): values to rtol 1e-5,
gradients to rtol 1e-4 / atol 1e-5 (``tests/test_trigram_scan.py`` holds the
two JAX routes to the same). The lattice's loss, the generic MaxTropical
``shortest_path`` (labels and counts equal, path weights to rtol 1e-5),
``label_marginals`` (the generic route in both packages) and the small
trigram GNAT are held to JAX's. The kernels themselves are held to the plain
versions on the card in ``test_torch_kernels.py``.
"""

import dataclasses

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
from last_torch_tpu.ops import trigram_scan as jax_trigram_scan
import last_torch_tpu_torch
from last_torch_tpu_torch import (alignments, contexts, convert, semirings,
                                  weight_fns)
from last_torch_tpu_torch.models import gnat, presets
from last_torch_tpu_torch.ops import fused_scan, trigram_scan

torch.set_num_threads(1)
torch.set_float32_matmul_precision('highest')

HIDDEN, EMBEDDING, FEATURES = 8, 8, 6
NUM_FRAMES = np.array([6, 4, 0], np.int32)  # full, padded, empty
MAX_T = 6
ALIGNMENTS = {
    'fd': (jax_alignments.FrameDependent, alignments.FrameDependent),
    'fld1': (lambda: jax_alignments.FrameLabelDependent(1),
             lambda: alignments.FrameLabelDependent(1)),
    'fld2': (lambda: jax_alignments.FrameLabelDependent(2),
             lambda: alignments.FrameLabelDependent(2)),
}


class JaxSubclassedJoint(jax_weight_fns.JointWeightFn):
  """Outside the JAX kernels' gates (they want exactly JointWeightFn)."""


class SubclassedJoint(weight_fns.JointWeightFn):
  """Outside the port's kernels' gates, as above."""


def jax_lattice(alignment, vocab=4, context_size=2, fused='never',
                joint=jax_weight_fns.JointWeightFn):
  return last_torch_tpu.RecognitionLattice(
      context=jax_contexts.FullNGram(vocab_size=vocab,
                                     context_size=context_size),
      alignment=ALIGNMENTS[alignment][0](),
      weight_fn_cacher_factory=lambda ctx: jax_weight_fns.SharedEmbCacher(
          num_context_states=ctx.shape()[0], embedding_size=EMBEDDING),
      weight_fn_factory=lambda ctx: joint(vocab_size=ctx.shape()[1],
                                          hidden_size=HIDDEN),
      fused=fused)


def torch_lattice(alignment, vocab=4, context_size=2,
                  joint=weight_fns.JointWeightFn):
  return last_torch_tpu_torch.RecognitionLattice(
      context=contexts.FullNGram(vocab_size=vocab, context_size=context_size),
      alignment=ALIGNMENTS[alignment][1](),
      weight_fn_cacher_factory=lambda ctx: weight_fns.SharedEmbCacher(
          num_context_states=ctx.shape()[0], embedding_size=EMBEDDING),
      weight_fn_factory=lambda ctx: joint(vocab_size=ctx.shape()[1],
                                          hidden_size=HIDDEN))


def make_inputs(seed, vocab=4, context_size=2, batch_shape=(3,)):
  """JAX params (numpy) from init(PRNGKey), frames from numpy's rng."""
  params = jax_lattice('fd', vocab, context_size).init(
      jax.random.PRNGKey(seed), feature_size=FEATURES)
  frames = (np.random.default_rng(seed).standard_normal(
      batch_shape + (MAX_T, FEATURES)) * 1.5).astype(np.float32)
  return jax.tree.map(np.asarray, params), frames


def leaf_at(tree, path):
  for key in path:
    tree = tree[key.key if hasattr(key, 'key') else key.idx]
  return tree


def assert_grads_close(torch_params, grads_j, rel):
  """Each gradient leaf to ``rel`` of the largest JAX gradient leaf."""
  scale = max(float(np.abs(g).max()) for g in jax.tree.leaves(grads_j))
  for path, want in jax.tree_util.tree_flatten_with_path(grads_j)[0]:
    npt.assert_allclose(leaf_at(torch_params, path).grad.numpy(),
                        np.asarray(want), rtol=0, atol=rel * scale,
                        err_msg=str(path))


@pytest.mark.parametrize('alignment', sorted(ALIGNMENTS))
@pytest.mark.parametrize('vocab', [2, 4, 5])
@pytest.mark.parametrize('route', ['interpret', 'xla'])
def test_plain_log_partition_matches_jax(route, vocab, alignment):
  params, frames = make_inputs(seed=vocab, vocab=vocab)
  lattice_j = jax_lattice(alignment, vocab)
  k = lattice_j.alignment.num_states() - 1
  cache = np.asarray(lattice_j.build_cache(params))

  def jax_log_z(wf, cache, frames):
    if route == 'interpret':
      return jax_trigram_scan.log_partition(
          wf, cache, frames, NUM_FRAMES, max_expansions=k,
          frame_dependent=alignment == 'fd', vocab=vocab,
          compute_dtype=jnp.float32, interpret=True)
    log_z, _ = lattice_j._forward(params={'weight_fn': wf}, cache=cache,
                                  frames=frames, num_frames=NUM_FRAMES,
                                  semiring=jax_semirings.Log)
    return log_z

  wf_j = jax.tree.map(jnp.asarray, params['weight_fn'])
  log_z_j, vjp = jax.vjp(jax_log_z, wf_j, jnp.asarray(cache),
                         jnp.asarray(frames))
  grads_j = vjp(jnp.ones_like(log_z_j))

  wf = convert.from_jax_params(params['weight_fn'], device='cpu')
  cache_t = torch.from_numpy(cache.copy())
  frames_t = torch.from_numpy(frames)
  for x in [*wf.values(), cache_t, frames_t]:
    x.requires_grad_(True)
  before = trigram_scan.forward_launches, trigram_scan.backward_launches
  log_z = trigram_scan.log_partition(
      wf, cache_t, frames_t, torch.from_numpy(NUM_FRAMES), max_expansions=k,
      frame_dependent=alignment == 'fd', compute_dtype=torch.float32)
  log_z.sum().backward()
  # CPU tensors run the plain versions and launch nothing.
  assert (trigram_scan.forward_launches,
          trigram_scan.backward_launches) == before
  npt.assert_allclose(log_z.detach().numpy(), np.asarray(log_z_j),
                      rtol=1e-5, atol=1e-6)
  assert log_z[2].item() == 0.0  # no frames: the start state alone
  for name, want in grads_j[0].items():
    npt.assert_allclose(wf[name].grad.numpy(), np.asarray(want), rtol=1e-4,
                        atol=1e-5, err_msg=name)
  npt.assert_allclose(cache_t.grad.numpy(), np.asarray(grads_j[1]),
                      rtol=1e-4, atol=1e-5)
  npt.assert_allclose(frames_t.grad.numpy(), np.asarray(grads_j[2]),
                      rtol=1e-4, atol=1e-5)
  # Padding frames and the empty row get exactly zero gradient.
  assert torch.all(frames_t.grad[1, 4:] == 0)
  assert torch.all(frames_t.grad[2] == 0)


# Row 1 has 3 labels in 4 frames; the empty row none.
LABELS = np.array([[1, 3, 2, 4], [4, 4, 1, 0], [0, 0, 0, 0]], np.int32)
NUM_LABELS = np.array([4, 3, 0], np.int32)


@pytest.mark.parametrize('alignment', ['fd', 'fld2'])
def test_lattice_loss_matches_jax(alignment):
  """The trigram loss: JAX through its trigram kernels in interpret mode,
  the port through their plain versions; values and every gradient."""
  params, frames = make_inputs(seed=11)
  reference = jax_lattice(alignment, fused='interpret')

  def jax_total(p, f):
    per_seq = reference(p, f, NUM_FRAMES, LABELS, NUM_LABELS)
    return jnp.where(jnp.isfinite(per_seq), per_seq, 0.0).sum(), per_seq

  (_, per_seq_j), (d_params_j, d_frames_j) = jax.value_and_grad(
      jax_total, argnums=(0, 1), has_aux=True)(
          jax.tree.map(jnp.asarray, params), jnp.asarray(frames))
  assert reference.last_path == 'fused'

  lattice = torch_lattice(alignment)
  torch_params = convert.from_jax_params(params, device='cpu')
  for leaf in pytree.tree_leaves(torch_params):
    leaf.requires_grad_(True)
  frames_t = torch.from_numpy(frames).requires_grad_(True)
  per_seq = lattice.loss(torch_params, frames_t, torch.from_numpy(NUM_FRAMES),
                         torch.from_numpy(LABELS),
                         torch.from_numpy(NUM_LABELS))
  assert lattice.last_path == 'plain'
  torch.where(torch.isfinite(per_seq), per_seq, 0.0).sum().backward()
  npt.assert_allclose(per_seq.detach().numpy(), np.asarray(per_seq_j),
                      rtol=1e-5, atol=1e-6)
  assert per_seq[2].item() == 0.0
  assert_grads_close(torch_params, jax.tree.map(np.asarray, d_params_j),
                     1e-4)
  npt.assert_allclose(frames_t.grad.numpy(), np.asarray(d_frames_j),
                      rtol=1e-4, atol=1e-5)


SHORTEST_PATH_CASES = {
    # name: (alignment, vocab, context_size, batch_shape, JAX joint, joint)
    'trigram_fd': ('fd', 4, 2, (3,), jax_weight_fns.JointWeightFn,
                   weight_fns.JointWeightFn),
    'trigram_fld2': ('fld2', 4, 2, (3,), jax_weight_fns.JointWeightFn,
                     weight_fns.JointWeightFn),
    'bigram_two_batch_dims': ('fd', 5, 1, (2, 3),
                              jax_weight_fns.JointWeightFn,
                              weight_fns.JointWeightFn),
    'subclassed_joint': ('fld2', 5, 1, (3,), JaxSubclassedJoint,
                         SubclassedJoint),
}


@pytest.mark.parametrize('case', sorted(SHORTEST_PATH_CASES))
def test_generic_shortest_path_matches_jax(case):
  """Outside the Viterbi kernel's gate both packages differentiate the
  tropical shortest distance with respect to a zero lexical mask."""
  alignment, vocab, context_size, batch_shape, joint_j, joint = (
      SHORTEST_PATH_CASES[case])
  params, frames = make_inputs(seed=12, vocab=vocab,
                               context_size=context_size,
                               batch_shape=batch_shape)
  num_frames = np.resize(NUM_FRAMES, batch_shape)
  if len(batch_shape) == 2:
    num_frames[1] = [3, 6, 1]
  reference = jax_lattice(alignment, vocab, context_size, fused='interpret',
                          joint=joint_j)
  lattice = torch_lattice(alignment, vocab, context_size, joint=joint)
  torch_params = convert.from_jax_params(params, device='cpu')
  for reference_compat in (False, True):
    want = reference.shortest_path(params, frames, num_frames,
                                   reference_compat=reference_compat)
    assert reference.last_path == 'xla'
    with torch.no_grad():  # as GNATModel.decode calls it
      got = lattice.shortest_path(torch_params, torch.from_numpy(frames),
                                  torch.from_numpy(num_frames),
                                  reference_compat=reference_compat)
    assert lattice.last_path == 'generic'
    labels, num_labels, weights = got
    assert labels.dtype == torch.int32 and num_labels.dtype == torch.int32
    npt.assert_array_equal(labels.numpy(), np.asarray(want[0]))
    npt.assert_array_equal(num_labels.numpy(), np.asarray(want[1]))
    npt.assert_allclose(weights.numpy(), np.asarray(want[2]), rtol=1e-5,
                        atol=1e-6)
  assert np.any(labels.numpy() > 0)


@pytest.mark.parametrize('alignment', ['fd', 'fld2'])
def test_label_marginals_match_jax(alignment):
  """Trigram posteriors take the generic route in both packages."""
  params, frames = make_inputs(seed=13)
  want = jax_lattice(alignment, fused='interpret').label_marginals(
      params, frames, NUM_FRAMES)
  lattice = torch_lattice(alignment)
  got = lattice.label_marginals(convert.from_jax_params(params, device='cpu'),
                                torch.from_numpy(frames),
                                torch.from_numpy(NUM_FRAMES))
  assert lattice.last_path == 'generic'
  assert got[0].shape == (3, MAX_T, 21) and got[1].shape == (3, MAX_T, 4)
  for g, w in zip(got, want):
    npt.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)


SMALL = dict(vocab_size=6, feature_size=5, encoder_size=16, encoder_layers=2,
             encoder_heads=2, encoder_ffn_size=32, hidden_size=12,
             embedding_size=10)
MODEL_FRAMES = np.array([8, 5, 0, 3], np.int32)
MODEL_LABELS = np.array([[2, 6, 1], [4, 4, 0], [0, 0, 0], [1, 2, 3]],
                        np.int32)
MODEL_NUM_LABELS = np.array([3, 2, 0, 3], np.int32)


def test_gnat_trigram_model_matches_jax():
  config = presets.gnat_global_bigram(context_size=2, **SMALL)
  fields = dataclasses.asdict(config)
  assert fields.pop('encoder_kind') == 'transformer'  # JAX's only encoder
  jax_model = jax_gnat.GNATModel(jax_gnat.GNATConfig(**fields))
  params = jax.tree.map(np.asarray, jax_model.init(jax.random.PRNGKey(14)))
  rng = np.random.default_rng(14)
  frames = rng.standard_normal(
      (len(MODEL_FRAMES), 8, SMALL['feature_size'])).astype(np.float32)
  batch = (frames, MODEL_FRAMES, MODEL_LABELS, MODEL_NUM_LABELS)
  model = gnat.GNATModel(config, device='cpu')
  assert model.lattice.context.num_states() == 1 + 6 + 36
  torch_params = convert.from_jax_params(params, device='cpu')

  # Decode: the generic route.
  labels_j, num_j, weights_j = jax_model.decode(params, frames, MODEL_FRAMES)
  labels_t, num_t, weights_t = model.decode(torch_params, frames,
                                            MODEL_FRAMES)
  assert model.lattice.last_path == 'generic'
  npt.assert_array_equal(labels_t.numpy(), np.asarray(labels_j))
  npt.assert_array_equal(num_t.numpy(), np.asarray(num_j))
  npt.assert_allclose(weights_t.numpy(), np.asarray(weights_j), rtol=1e-5,
                      atol=1e-5)

  # Mean loss and its gradients: the trigram log-partition's plain versions.
  value_j, grads_j = jax.value_and_grad(jax_model.mean_loss)(
      jax.tree.map(jnp.asarray, params), *batch)
  for leaf in pytree.tree_leaves(torch_params):
    leaf.requires_grad_(True)
  value = model.mean_loss(torch_params, *batch)
  value.backward()
  assert model.lattice.last_path == 'plain'
  npt.assert_allclose(value.item(), float(value_j), rtol=1e-5, atol=1e-6)
  assert_grads_close(torch_params, jax.tree.map(np.asarray, grads_j), 1e-4)

  # Train steps: finite losses that fall.
  optimizer = gnat.make_optimizer(learning_rate=1e-2)
  torch_params = convert.from_jax_params(params, device='cpu')
  for leaf in pytree.tree_leaves(torch_params):
    leaf.requires_grad_(True)
  state = gnat.GNATTrainState(params=torch_params,
                              opt_state=optimizer.init(torch_params), step=0)
  losses = []
  for _ in range(3):
    state, loss = gnat.train_step(model, optimizer, state, *batch)
    losses.append(loss.item())
  npt.assert_allclose(losses[0], float(value_j), rtol=1e-5)
  assert np.all(np.isfinite(losses)) and losses[2] < losses[1] < losses[0]


def test_gate():
  frames = torch.zeros((2, 4, FEATURES))
  for alignment in ALIGNMENTS:
    assert trigram_scan.supported(torch_lattice(alignment), frames)
  # Not the trigram kernels: a locally normalized weight function, a
  # subclass, two batch dims, the bigram.
  hat = last_torch_tpu_torch.RecognitionLattice(
      context=contexts.FullNGram(vocab_size=4, context_size=2),
      alignment=alignments.FrameDependent(),
      weight_fn_cacher_factory=lambda ctx: weight_fns.SharedEmbCacher(
          num_context_states=ctx.shape()[0], embedding_size=EMBEDDING),
      weight_fn_factory=lambda ctx: weight_fns.LocallyNormalizedWeightFn(
          weight_fns.JointWeightFn(vocab_size=4, hidden_size=HIDDEN)))
  assert not trigram_scan.supported(hat, frames)
  assert not trigram_scan.supported(
      torch_lattice('fd', joint=SubclassedJoint), frames)
  assert not trigram_scan.supported(torch_lattice('fd'), frames[None])
  bigram = torch_lattice('fd', context_size=1)
  assert not trigram_scan.supported(bigram, frames)
  assert fused_scan.supported(bigram, frames)
  assert not fused_scan.supported(torch_lattice('fd'), frames)
  # The memory rule, from shapes alone (constructing a lattice allocates
  # nothing). At B=8 the card stages 6 bytes per [B, S, V] entry (float32
  # lex, bfloat16 d_lex) and V=563 is the largest vocabulary inside the
  # 8 GiB budget; CPU tensors compute in float32, 8 bytes, and stop at 511.
  budget = fused_scan.LEX_STAGE_BUDGET
  assert trigram_scan.staged_bytes(8, 64, torch.bfloat16) == (
      8 * 4161 * 64 * 6)
  assert trigram_scan.staged_bytes(8, 563, torch.bfloat16) <= budget
  assert trigram_scan.staged_bytes(8, 564, torch.bfloat16) > budget
  batch8 = torch.zeros((8, 1, FEATURES))
  assert trigram_scan.supported(torch_lattice('fd', vocab=511), batch8)
  assert not trigram_scan.supported(torch_lattice('fd', vocab=512), batch8)
  assert not trigram_scan.supported(torch_lattice('fd', vocab=1024), batch8)


# (batch, vocab, hidden) -> (group, strips, groups, blocks) of the segment
# kernels, or None where they take no such V.
SEGMENT_PLANS = {
    'probe': ((8, 64, 512), (4, 1, 2, 130)),
    'b3': ((3, 64, 512), (4, 1, 1, 65)),
    'b5_v5_h24': ((5, 5, 24), (4, 1, 2, 12)),
    'v80_two_strips': ((5, 80, 64), (2, 2, 3, 243)),
    'v128': ((8, 128, 512), (2, 2, 4, 516)),
    'v129': ((8, 129, 512), None),
}


@pytest.mark.parametrize('case', sorted(SEGMENT_PLANS))
def test_segment_plan(case):
  args, want = SEGMENT_PLANS[case]
  if want is None:
    with pytest.raises(ValueError, match='V <= 128'):
      trigram_scan.segment_plan(*args)
    return
  plan = trigram_scan.segment_plan(*args)
  assert (plan.group, plan.strips, plan.groups, plan.blocks) == want
  batch, vocab, hidden = args
  assert plan.vocab_pad == 64 * plan.strips >= vocab
  assert plan.hidden_pad % 64 == 0 and 0 <= plan.hidden_pad - hidden < 64
  assert plan.group * plan.groups >= batch > plan.group * (plan.groups - 1)


class _Library:
  """Stands in for the kernel library: answers ``trigram_segment_smem``
  with a fixed byte count and records its arguments."""

  def __init__(self, smem):
    self.smem, self.calls = smem, []

  def trigram_segment_smem(self, *args):
    self.calls.append(args)
    return self.smem


@pytest.mark.parametrize('case', ['float32', 'refused', 'taken'])
def test_segment_route_follows_the_library(case, monkeypatch):
  """The segment kernels run a bfloat16 call where the library's
  ``trigram_segment_smem`` gives it bytes, and no float32 call (the
  library is not asked); the card test holds the library's rule."""
  library = _Library(0 if case == 'refused' else 200000)
  monkeypatch.setattr(fused_scan, 'library', lambda: library)
  dtype = torch.float32 if case == 'float32' else torch.bfloat16
  plan = trigram_scan.segment_route(8, 64, 512, dtype, 2)
  if case == 'taken':
    assert plan == trigram_scan.segment_plan(8, 64, 512)
    assert library.calls == [(512, 64, 2)]
  else:
    assert plan is None
    assert library.calls == ([] if case == 'float32' else [(512, 64, 2)])


@pytest.mark.parametrize('passes', [1, 2, 3])
def test_segment_scratch_holds_no_joint_and_no_d_lex(passes):
  """No [B, S, h] buffer (the joint, d_pc's accumulator) and no [B, S, V]
  d_lex; what is staged per frame (float32 lex) is within the gate's
  ``staged_bytes``."""
  batch, vocab, hidden = 8, 64, 512
  states = 1 + vocab + vocab**2
  plan = trigram_scan.segment_plan(batch, vocab, hidden)
  forward = trigram_scan.segment_forward_scratch(plan, batch, vocab, passes,
                                                 with_slabs=True)
  backward = trigram_scan.segment_backward_scratch(plan, batch, vocab,
                                                   hidden, passes)
  for scratch in (forward, backward):
    for name, (shape, dtype) in scratch.items():
      assert tuple(shape[:2]) != (batch, states) or len(shape) == 2 or (
          name == 'lex' and shape[2] == vocab and dtype == torch.float32), name
      assert dtype != torch.bfloat16 or name == 'vocab_w', name
  staged = lambda scratch: sum(
      int(np.prod(shape)) * 4 for name, (shape, _) in scratch.items()
      if name == 'lex')
  limit = trigram_scan.staged_bytes(batch, vocab, torch.bfloat16)
  assert staged(backward) <= limit and staged(forward) <= limit
  assert ('lex' in forward) == (passes >= 2)
  # d_pc's accumulator is per group of rows, not per row.
  assert backward['dpc_acc'][0] == (plan.groups, states, hidden)
  # Without slabs the forward keeps two frames of expansions.
  assert trigram_scan.segment_forward_scratch(
      plan, batch, vocab, passes, with_slabs=False)['last'][0] == (
          2, passes, batch, states)


def test_past_the_budget_the_lattice_takes_the_generic_route(monkeypatch):
  """With the staging budget below this lattice's bytes, log Z and its
  gradients take the generic route and still match JAX; under MaxTropical
  the shortest distance is generic whatever the budget."""
  params, frames = make_inputs(seed=15)
  monkeypatch.setattr(fused_scan, 'LEX_STAGE_BUDGET',
                      trigram_scan.staged_bytes(3, 4, torch.float32) - 1)
  reference = jax_lattice('fld2')
  log_z_j, grads_j = jax.value_and_grad(
      lambda p, f: reference.shortest_distance(p, f, NUM_FRAMES).sum(),
      argnums=(0, 1))(jax.tree.map(jnp.asarray, params), jnp.asarray(frames))
  lattice = torch_lattice('fld2')
  torch_params = convert.from_jax_params(params, device='cpu')
  for leaf in pytree.tree_leaves(torch_params):
    leaf.requires_grad_(True)
  frames_t = torch.from_numpy(frames).requires_grad_(True)
  assert not trigram_scan.supported(lattice, frames_t)
  log_z = lattice.shortest_distance(torch_params, frames_t,
                                    torch.from_numpy(NUM_FRAMES))
  assert lattice.last_path == 'generic'
  log_z.sum().backward()
  npt.assert_allclose(log_z.sum().item(), float(log_z_j), rtol=1e-5)
  assert_grads_close(torch_params, jax.tree.map(np.asarray, grads_j[0]),
                     1e-4)
  npt.assert_allclose(frames_t.grad.numpy(), np.asarray(grads_j[1]),
                      rtol=1e-4, atol=1e-5)

  best_j = reference.shortest_distance(params, frames, NUM_FRAMES,
                                       semiring=jax_semirings.MaxTropical)
  with torch.no_grad():
    best = lattice.shortest_distance(
        convert.from_jax_params(params, device='cpu'),
        torch.from_numpy(frames), torch.from_numpy(NUM_FRAMES),
        semiring=semirings.MaxTropical)
  assert lattice.last_path == 'generic'
  npt.assert_allclose(best.numpy(), np.asarray(best_j), rtol=1e-5,
                      atol=1e-6)
