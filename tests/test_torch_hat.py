"""The port's locally normalized (HAT) lattice and model against the JAX
package.

Same numpy inputs, JAX parameters converted with ``convert.from_jax_params``.
Decoding: the port's plain Viterbi with in-kernel normalization (CPU
tensors) against JAX ``shortest_path`` through its Pallas kernel in
interpret mode and through XLA: labels equal, path weights to rtol 1e-5 /
atol 1e-5 (float32, other summation order). The loss (-numerator, through
the numerator kernels' plain versions) against JAX: values to rtol 1e-5,
gradients of parameters and frames to 1e-4 of the largest gradient. The
small ``hat_bigram`` model: decode, mean loss and gradients as above, and
one ``train_step`` (the loss it reports to rtol 1e-5; the updated
parameters to 1e-6, Adam's first step moving each by about the learning
rate).
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
from last_torch_tpu import weight_fns as jax_weight_fns
from last_torch_tpu.models import gnat as jax_gnat
import last_torch_tpu_torch
from last_torch_tpu_torch import alignments, contexts, convert, weight_fns
from last_torch_tpu_torch.models import gnat, presets
from last_torch_tpu_torch.ops import numerator_scan, viterbi

torch.set_num_threads(1)
torch.set_float32_matmul_precision('highest')

VOCAB, HIDDEN, EMBEDDING, FEATURES = 5, 8, 8, 6
NUM_FRAMES = np.array([7, 4, 0], np.int32)  # full, padded, empty
ALIGNMENTS = {
    'fd': (jax_alignments.FrameDependent, alignments.FrameDependent),
    'fld2': (lambda: jax_alignments.FrameLabelDependent(2),
             lambda: alignments.FrameLabelDependent(2)),
}
NORMALIZERS = {
    'hat': (jax_weight_fns.hat_normalize, weight_fns.hat_normalize),
    'log_softmax': (jax_weight_fns.log_softmax_normalize,
                    weight_fns.log_softmax_normalize),
}


def jax_lattice(alignment, normalize, fused='never',
                joint=jax_weight_fns.JointWeightFn):
  return last_torch_tpu.RecognitionLattice(
      context=jax_contexts.FullNGram(vocab_size=VOCAB, context_size=1),
      alignment=ALIGNMENTS[alignment][0](),
      weight_fn_cacher_factory=lambda ctx: jax_weight_fns.SharedEmbCacher(
          num_context_states=ctx.shape()[0], embedding_size=EMBEDDING),
      weight_fn_factory=lambda ctx: jax_weight_fns.LocallyNormalizedWeightFn(
          joint(vocab_size=ctx.shape()[1], hidden_size=HIDDEN),
          normalize=NORMALIZERS[normalize][0]),
      fused=fused)


def torch_lattice(alignment, normalize, joint=weight_fns.JointWeightFn):
  return last_torch_tpu_torch.RecognitionLattice(
      context=contexts.FullNGram(vocab_size=VOCAB, context_size=1),
      alignment=ALIGNMENTS[alignment][1](),
      weight_fn_cacher_factory=lambda ctx: weight_fns.SharedEmbCacher(
          num_context_states=ctx.shape()[0], embedding_size=EMBEDDING),
      weight_fn_factory=lambda ctx: weight_fns.LocallyNormalizedWeightFn(
          joint(vocab_size=ctx.shape()[1], hidden_size=HIDDEN),
          normalize=NORMALIZERS[normalize][1]))


def make_inputs(seed):
  params = jax_lattice('fd', 'hat').init(jax.random.PRNGKey(seed),
                                         feature_size=FEATURES)
  params['weight_fn']['blank_b'] = jnp.asarray(-0.5)
  frames = np.random.default_rng(seed).standard_normal(
      (len(NUM_FRAMES), 7, FEATURES)).astype(np.float32)
  return jax.tree.map(np.asarray, params), frames


@pytest.mark.parametrize('fused', ['interpret', 'never'])
@pytest.mark.parametrize('normalize', sorted(NORMALIZERS))
@pytest.mark.parametrize('alignment', sorted(ALIGNMENTS))
def test_normalized_shortest_path_matches_jax(alignment, normalize, fused):
  params, frames = make_inputs(seed=1)
  labels_j, num_j, weights_j = jax_lattice(
      alignment, normalize, fused).shortest_path(params, frames, NUM_FRAMES)
  lattice = torch_lattice(alignment, normalize)
  before = viterbi.launches
  labels_t, num_t, weights_t = lattice.shortest_path(
      convert.from_jax_params(params, device='cpu'), torch.from_numpy(frames),
      torch.from_numpy(NUM_FRAMES))
  assert lattice.last_path == 'plain' and viterbi.launches == before
  npt.assert_array_equal(labels_t.numpy(), np.asarray(labels_j))
  npt.assert_array_equal(num_t.numpy(), np.asarray(num_j))
  npt.assert_allclose(weights_t.numpy(), np.asarray(weights_j), rtol=1e-5,
                      atol=1e-5)
  assert np.any(labels_t.numpy() > 0)
  # Normalized weights are log-probabilities: every path weight is <= 0.
  assert torch.all(weights_t <= 0)


LABELS = np.array([[2, 5, 1, 3, 1], [4, 4, 1, 2, 3], [0, 0, 0, 0, 0]],
                  np.int32)
# Row 1 has 5 labels in 4 frames: infeasible under FrameDependent (one
# label per frame), feasible under FrameLabelDependent(2).
NUM_LABELS = np.array([4, 5, 0], np.int32)


@pytest.mark.parametrize('normalize', sorted(NORMALIZERS))
@pytest.mark.parametrize('alignment', sorted(ALIGNMENTS))
def test_locally_normalized_loss_matches_jax(alignment, normalize):
  params, frames = make_inputs(seed=2)
  labels, num_labels = LABELS, NUM_LABELS
  reference = jax_lattice(alignment, normalize)

  def jax_total(p, f):
    per_seq = reference(p, f, NUM_FRAMES, labels, num_labels)
    return jnp.where(jnp.isfinite(per_seq), per_seq, 0.0).sum(), per_seq

  (_, per_seq_j), (d_params_j, d_frames_j) = jax.value_and_grad(
      jax_total, argnums=(0, 1), has_aux=True)(
          jax.tree.map(jnp.asarray, params), jnp.asarray(frames))

  lattice = torch_lattice(alignment, normalize)
  torch_params = convert.from_jax_params(params, device='cpu')
  for leaf in pytree.tree_leaves(torch_params):
    leaf.requires_grad_(True)
  frames_t = torch.from_numpy(frames).requires_grad_(True)
  per_seq = lattice.loss(torch_params, frames_t, torch.from_numpy(NUM_FRAMES),
                         torch.from_numpy(labels),
                         torch.from_numpy(num_labels))
  torch.where(torch.isfinite(per_seq), per_seq, 0.0).sum().backward()

  infeasible = alignment == 'fd'
  assert (per_seq[1].item() == float('inf')) == infeasible
  assert per_seq[2].item() == 0.0  # no frames, no labels: -log 1
  npt.assert_allclose(per_seq.detach().numpy(), np.asarray(per_seq_j),
                      rtol=1e-5, atol=1e-6)
  assert per_seq[0].item() > 0
  d_params_j = jax.tree.map(np.asarray, d_params_j)
  scale = max(float(np.abs(w).max()) for w in jax.tree.leaves(d_params_j))
  for key, want in d_params_j['weight_fn'].items():
    npt.assert_allclose(torch_params['weight_fn'][key].grad.numpy(), want,
                        rtol=0, atol=1e-4 * scale, err_msg=key)
  npt.assert_allclose(torch_params['cacher']['embedding'].grad.numpy(),
                      d_params_j['cacher']['embedding'], rtol=0,
                      atol=1e-4 * scale)
  npt.assert_allclose(frames_t.grad.numpy(), np.asarray(d_frames_j),
                      rtol=1e-4, atol=1e-6)
  # Padding frames, and an infeasible row's zero cotangent, give exact 0.
  assert torch.all(frames_t.grad[2] == 0)
  assert torch.all(frames_t.grad[1, 4:] == 0)
  if infeasible:
    assert torch.all(frames_t.grad[1] == 0)


@pytest.mark.parametrize('normalize', sorted(NORMALIZERS))
def test_locally_normalized_shortest_distance_matches_jax(normalize):
  """log Z of a locally normalized lattice takes the generic route."""
  params, frames = make_inputs(seed=3)
  want = jax_lattice('fld2', normalize).shortest_distance(params, frames,
                                                          NUM_FRAMES)
  lattice = torch_lattice('fld2', normalize)
  got = lattice.shortest_distance(
      convert.from_jax_params(params, device='cpu'), torch.from_numpy(frames),
      torch.from_numpy(NUM_FRAMES))
  assert lattice.last_path == 'generic'
  npt.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_other_inner_weight_fns_raise_naming_the_roadmap():
  """Over a JointWeightFn subclass the HAT loss's string weights have no
  fast path: they take the generic per-position route (one weight
  application over all frames per label position), held to JAX's, values
  and gradients; its decode takes the generic route, as in the JAX
  package, and agrees with it."""
  class Joint(weight_fns.JointWeightFn):
    pass

  class JaxJoint(jax_weight_fns.JointWeightFn):
    pass

  params, frames = make_inputs(seed=4)
  lattice = torch_lattice('fld2', 'hat', joint=Joint)

  def jax_total(p, f):
    return jnp.sum(jax_lattice('fld2', 'hat', joint=JaxJoint)(
        p, f, NUM_FRAMES, LABELS, NUM_LABELS))

  value_j, (d_params_j, d_frames_j) = jax.value_and_grad(
      jax_total, argnums=(0, 1))(jax.tree.map(jnp.asarray, params),
                                 jnp.asarray(frames))
  torch_params = convert.from_jax_params(params, device='cpu')
  for leaf in pytree.tree_leaves(torch_params):
    leaf.requires_grad_(True)
  frames_t = torch.from_numpy(frames).requires_grad_(True)
  before = numerator_scan.forward_launches, numerator_scan.backward_launches
  loss = lattice.loss(torch_params, frames_t, torch.from_numpy(NUM_FRAMES),
                      torch.from_numpy(LABELS), torch.from_numpy(NUM_LABELS))
  loss.sum().backward()
  assert (numerator_scan.forward_launches,
          numerator_scan.backward_launches) == before
  npt.assert_allclose(float(loss.detach().sum()), float(value_j), rtol=1e-5,
                      atol=1e-6)
  scale = max(float(np.abs(g).max()) for g in jax.tree.leaves(d_params_j))
  for path, want in jax.tree_util.tree_flatten_with_path(d_params_j)[0]:
    npt.assert_allclose(leaf_at(torch_params, path).grad.numpy(),
                        np.asarray(want), rtol=0, atol=1e-4 * scale,
                        err_msg=str(path))
  npt.assert_allclose(frames_t.grad.numpy(), np.asarray(d_frames_j),
                      rtol=1e-4, atol=1e-6)
  labels, num_labels, weights = lattice.shortest_path(
      convert.from_jax_params(params, device='cpu'), torch.from_numpy(frames),
      torch.from_numpy(NUM_FRAMES))
  assert lattice.last_path == 'generic'
  labels_j, num_j, weights_j = jax_lattice(
      'fld2', 'hat', 'interpret', joint=JaxJoint).shortest_path(
          params, frames, NUM_FRAMES)
  npt.assert_array_equal(labels.numpy(), np.asarray(labels_j))
  npt.assert_array_equal(num_labels.numpy(), np.asarray(num_j))
  npt.assert_allclose(weights.numpy(), np.asarray(weights_j), rtol=1e-5,
                      atol=1e-5)
  assert torch.all(weights <= 0)


SMALL = dict(vocab_size=6, feature_size=5, encoder_size=16, encoder_layers=2,
             encoder_heads=2, encoder_ffn_size=32, hidden_size=12,
             embedding_size=10)
MODEL_FRAMES = np.array([8, 5, 0, 3], np.int32)
MODEL_LABELS = np.array([[2, 6, 1], [4, 4, 0], [0, 0, 0], [1, 2, 3]],
                        np.int32)
MODEL_NUM_LABELS = np.array([3, 2, 0, 3], np.int32)


def leaf_at(tree, path):
  for key in path:
    tree = tree[key.key if hasattr(key, 'key') else key.idx]
  return tree


def test_hat_model_decode_loss_and_train_step_match_jax():
  config = presets.hat_bigram(**SMALL)
  fields = dataclasses.asdict(config)
  assert fields.pop('encoder_kind') == 'transformer'  # JAX's only encoder
  jax_model = jax_gnat.GNATModel(jax_gnat.GNATConfig(**fields))
  params = jax.tree.map(np.asarray, jax_model.init(jax.random.PRNGKey(5)))
  rng = np.random.default_rng(5)
  frames = rng.standard_normal(
      (len(MODEL_FRAMES), 8, SMALL['feature_size'])).astype(np.float32)
  batch = (frames, MODEL_FRAMES, MODEL_LABELS, MODEL_NUM_LABELS)

  model = gnat.GNATModel(config, device='cpu')
  assert isinstance(model.lattice.weight_fn,
                    weight_fns.LocallyNormalizedWeightFn)
  torch_params = convert.from_jax_params(params, device='cpu')

  # Decode.
  labels_j, num_j, weights_j = jax_model.decode(params, frames, MODEL_FRAMES)
  labels_t, num_t, weights_t = model.decode(torch_params, frames,
                                            MODEL_FRAMES)
  assert model.lattice.last_path == 'plain'
  npt.assert_array_equal(labels_t.numpy(), np.asarray(labels_j))
  npt.assert_array_equal(num_t.numpy(), np.asarray(num_j))
  npt.assert_allclose(weights_t.numpy(), np.asarray(weights_j), rtol=1e-5,
                      atol=1e-5)

  # Mean loss and its gradients.
  value_j, grads_j = jax.value_and_grad(jax_model.mean_loss)(
      jax.tree.map(jnp.asarray, params), *batch)
  grads_j = jax.tree.map(np.asarray, grads_j)
  for leaf in pytree.tree_leaves(torch_params):
    leaf.requires_grad_(True)
  before = numerator_scan.forward_launches, numerator_scan.backward_launches
  value = model.mean_loss(torch_params, *batch)
  value.backward()
  assert (numerator_scan.forward_launches,
          numerator_scan.backward_launches) == before
  npt.assert_allclose(value.item(), float(value_j), rtol=1e-5, atol=1e-6)
  scale = max(float(np.abs(g).max()) for g in jax.tree.leaves(grads_j))
  for path, want in jax.tree_util.tree_flatten_with_path(grads_j)[0]:
    npt.assert_allclose(leaf_at(torch_params, path).grad.numpy(), want,
                        rtol=0, atol=1e-4 * scale, err_msg=str(path))

  # One train step from the same parameters.
  tx = jax_gnat.make_optimizer(learning_rate=1e-3)
  jax_state = jax_gnat.GNATTrainState(
      params=jax.tree.map(jnp.asarray, params),
      opt_state=tx.init(jax.tree.map(jnp.asarray, params)), step=0)
  jax_state, loss_j = jax_gnat.train_step(jax_model, tx, jax_state, *batch)
  optimizer = gnat.make_optimizer(learning_rate=1e-3)
  torch_params = convert.from_jax_params(params, device='cpu')
  for leaf in pytree.tree_leaves(torch_params):
    leaf.requires_grad_(True)
  state = gnat.GNATTrainState(params=torch_params,
                              opt_state=optimizer.init(torch_params), step=0)
  state, loss = gnat.train_step(model, optimizer, state, *batch)
  assert state.step == 1
  npt.assert_allclose(loss.item(), float(loss_j), rtol=1e-5, atol=1e-6)
  for path, want in jax.tree_util.tree_flatten_with_path(
      jax_state.params)[0]:
    npt.assert_allclose(leaf_at(state.params, path).detach().numpy(),
                        np.asarray(want), rtol=0, atol=1e-6,
                        err_msg=str(path))
