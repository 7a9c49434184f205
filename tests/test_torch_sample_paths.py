"""The port's posterior path sampler (``RecognitionLattice.sample_paths``)
against enumeration oracles and the JAX package.

On seeded ``TableWeightFn`` lattices small enough to enumerate (the cases of
the JAX package's ``tests/test_sample_paths.py``): the port's table lookups
equal JAX's ``TableWeightFn`` bit for bit and JAX's log Z equals the
enumeration's; every one of M=4096 samples is a lattice path whose
``log_prob`` is the enumerated ``w(path) - log Z`` (rtol/atol 1e-5), and the
empirical distribution is within 5 binomial sigma + 2/M of the posterior.
A peaked lattice collapses onto ``shortest_path``; padding slots are zero;
an unsupported alignment raises. Samples cannot equal JAX's bit for bit
(other random streams), so on paths the port drew from a small
``JointWeightFn`` lattice (and one at 1025 states, whose beta pass runs the
joint+head kernels' plain versions), ``log_prob`` and its gradient with
respect to every parameter and the frames are held to a JAX scoring of the
same paths (``weight_fn.apply`` at each slot's state, ``shortest_distance``
for log Z) to rtol 1e-5 and 1e-4 of the largest gradient. Per-row
generators make a row's samples independent of the rest of the batch.
"""

import itertools

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
from last_torch_tpu_torch import alignments, contexts, convert, risk
from last_torch_tpu_torch import weight_fns
from last_torch_tpu_torch.ops import joint_head

from test_lattice_fuzz import frame_arc_options, path_weight

torch.set_num_threads(1)
torch.set_float32_matmul_precision('highest')

VOCAB = 2
INPUT_VOCAB = 3


def torch_alignment(max_expansions):
  return (alignments.FrameDependent() if max_expansions is None else
          alignments.FrameLabelDependent(max_expansions))


def jax_alignment(max_expansions):
  return (jax_alignments.FrameDependent() if max_expansions is None else
          jax_alignments.FrameLabelDependent(max_expansions))


def table_lattices(context_size, max_expansions, table):
  jax_lattice = last_torch_tpu.RecognitionLattice(
      context=jax_contexts.FullNGram(vocab_size=VOCAB,
                                     context_size=context_size),
      alignment=jax_alignment(max_expansions),
      weight_fn_cacher_factory=lambda ctx: jax_weight_fns.NullCacher(),
      weight_fn_factory=lambda ctx: jax_weight_fns.TableWeightFn(
          jnp.asarray(table)))
  torch_lattice = last_torch_tpu_torch.RecognitionLattice(
      context=contexts.FullNGram(vocab_size=VOCAB, context_size=context_size),
      alignment=torch_alignment(max_expansions),
      weight_fn_cacher_factory=lambda ctx: weight_fns.NullCacher(),
      weight_fn_factory=lambda ctx: weight_fns.TableWeightFn(
          convert.from_jax_params(np.asarray(table), device='cpu')))
  params = torch_lattice.init(torch.Generator().manual_seed(0),
                              feature_size=1, device='cpu')
  return jax_lattice, torch_lattice, params


def slot_encoding(arcs_per_frame, num_frames, max_t, max_expansions):
  """The ``shortest_path``-format slot labels of one alignment path."""
  num_align = 1 if max_expansions is None else max_expansions + 1
  slots = []
  for t in range(max_t):
    arcs = arcs_per_frame[t] if t < num_frames else ()
    slots.extend(list(arcs) + [0] * (num_align - len(arcs)))
  return tuple(slots)


@pytest.mark.parametrize('context_size,max_expansions,num_frames', [
    (0, None, 3),
    (0, 1, 3),
    (1, None, 3),
    (1, 1, 3),
    (1, 2, 2),
    (2, None, 3),
    (2, 2, 2),
])
def test_log_prob_exact_and_distribution_matches_enumeration(
    context_size, max_expansions, num_frames):
  rng = np.random.default_rng(context_size * 10 + num_frames)
  max_t = 3
  num_states = jax_contexts.FullNGram(
      vocab_size=VOCAB, context_size=context_size).shape()[0]
  table = np.asarray(
      rng.normal(size=(1, INPUT_VOCAB, num_states, 1 + VOCAB)), np.float32)
  jax_lattice, lattice, params = table_lattices(context_size, max_expansions,
                                                table)
  frames_int = rng.integers(0, INPUT_VOCAB, size=max_t)
  frames = np.asarray(frames_int, np.float32)[None, :, None]
  nf = np.asarray([num_frames], np.int32)

  # The two TableWeightFns look up the same weights.
  for state in (None, np.asarray([num_states - 1], np.int32)):
    want = jax_lattice.weight_fn.apply({}, None, jnp.asarray(frames[:, 1]),
                                       state)
    got = lattice.weight_fn.apply(
        {}, None, torch.from_numpy(frames[:, 1]),
        None if state is None else torch.from_numpy(state))
    for g, w in zip(got, want):
      npt.assert_array_equal(g.numpy(), np.asarray(w))

  nxt = np.asarray(jax_lattice.context.next_state_table())
  exact, weights = {}, []
  for arcs in itertools.product(frame_arc_options(max_expansions),
                                repeat=num_frames):
    w, _ = path_weight(table[0], nxt, frames_int, arcs, max_expansions)
    weights.append(w)
    exact[slot_encoding(arcs, num_frames, max_t, max_expansions)] = w
  assert len(exact) == len(weights), 'slot encoding must be injective'
  log_z = np.logaddexp.reduce(np.asarray(weights))
  jax_log_z = jax_lattice.shortest_distance({'cacher': {}, 'weight_fn': {}},
                                            jnp.asarray(frames),
                                            jnp.asarray(nf))
  npt.assert_allclose(float(jax_log_z[0]), log_z, rtol=1e-5, atol=1e-5)

  m = 4096
  labels, num_labels, log_prob = lattice.sample_paths(
      params, torch.from_numpy(frames), torch.from_numpy(nf),
      torch.Generator().manual_seed(7), num_samples=m)
  num_align = lattice.alignment.num_states()
  assert labels.shape == (1, m, max_t * num_align)
  assert labels.dtype == torch.int32
  npt.assert_array_equal(num_labels.numpy(),
                         np.full((1, m), num_align * num_frames))
  counts = {}
  for path, lp in zip(labels[0].tolist(), log_prob[0].tolist()):
    path = tuple(path)
    assert path in exact, f'sampled an alignment not in the lattice: {path}'
    npt.assert_allclose(lp, exact[path] - log_z, rtol=1e-5, atol=1e-5)
    counts[path] = counts.get(path, 0) + 1
  for path, w in exact.items():
    p = np.exp(w - log_z)
    p_hat = counts.get(path, 0) / m
    tol = 5 * np.sqrt(p * (1 - p) / m) + 2 / m
    assert abs(p_hat - p) <= tol, (
        f'path {path}: empirical {p_hat:.4f} vs exact {p:.4f} (tol {tol:.4f})')


def test_peaked_lattice_collapses_to_shortest_path():
  rng = np.random.default_rng(3)
  max_t = 3
  table = np.asarray(8.0 * rng.normal(size=(1, INPUT_VOCAB, 1 + VOCAB,
                                            1 + VOCAB)), np.float32)
  _, lattice, params = table_lattices(1, 1, table)
  frames = torch.from_numpy(np.asarray(
      rng.integers(0, INPUT_VOCAB, size=max_t), np.float32)[None, :, None])
  nf = torch.tensor([max_t])
  best_labels, _, _ = lattice.shortest_path(params, frames, nf)
  labels, _, log_prob = lattice.sample_paths(
      params, frames, nf, torch.Generator().manual_seed(0), num_samples=64)
  assert np.exp(log_prob.max().item()) > 0.9
  picked = labels[0, int(torch.argmax(log_prob[0]))]
  npt.assert_array_equal(picked.numpy(), best_labels[0].numpy())
  mode_count = (labels[0] == best_labels[0]).all(dim=-1).sum().item()
  assert mode_count >= 58  # ~0.9+ posterior, 64 draws


def test_ragged_batch_and_padding_slots():
  rng = np.random.default_rng(5)
  max_t = 4
  table = np.asarray(rng.normal(size=(2, INPUT_VOCAB, 1 + VOCAB, 1 + VOCAB)),
                     np.float32)
  _, lattice, params = table_lattices(1, 2, table)
  frames = torch.from_numpy(np.asarray(
      rng.integers(0, INPUT_VOCAB, size=(2, max_t)), np.float32)[..., None])
  nf = torch.tensor([4, 2])
  labels, num_labels, log_prob = lattice.sample_paths(
      params, frames, nf, torch.Generator().manual_seed(1), num_samples=8)
  num_align = lattice.alignment.num_states()
  assert labels.shape == (2, 8, max_t * num_align)
  npt.assert_array_equal(num_labels[0].numpy(), 4 * num_align)
  npt.assert_array_equal(num_labels[1].numpy(), 2 * num_align)
  # Slots past num_frames * num_align are structural zeros.
  npt.assert_array_equal(labels[1, :, 2 * num_align:].numpy(), 0)
  # Within a frame, nothing follows the blank (the first zero slot).
  slots = labels.reshape(2, 8, max_t, num_align)
  after_blank = torch.cumprod((slots > 0).int(), dim=-1) == 0
  assert not bool((slots[..., 1:] > 0)[after_blank[..., :-1]].any())
  assert bool(torch.isfinite(log_prob).all())
  assert bool((log_prob <= 1e-5).all())


def test_unsupported_alignment_raises():

  class Weird:
    """A one-state alignment that is neither of the two the sampler
    covers."""

    def num_states(self):
      return 1

    def start(self):
      return 0

  table = np.zeros((1, INPUT_VOCAB, 1 + VOCAB, 1 + VOCAB), np.float32)
  lattice = last_torch_tpu_torch.RecognitionLattice(
      context=contexts.FullNGram(vocab_size=VOCAB, context_size=1),
      alignment=Weird(),
      weight_fn_cacher_factory=lambda ctx: weight_fns.NullCacher(),
      weight_fn_factory=lambda ctx: weight_fns.TableWeightFn(table))
  params = lattice.init(torch.Generator(), feature_size=1, device='cpu')
  with pytest.raises(NotImplementedError, match='FrameDependent and '
                     'FrameLabelDependent'):
    lattice.sample_paths(params, torch.zeros((1, 3, 1)), torch.tensor([3]),
                         torch.Generator())


# Paths the port draws, scored by JAX.
HIDDEN, EMBEDDING, FEATURES = 8, 8, 5
JOINT_CASES = {
    # name: (vocab, max_expansions, num_frames, samples)
    'fd_v5': (5, None, [6, 3, 0], 6),
    'fld1_v5': (5, 1, [6, 3, 0], 6),
    'fld2_v5': (5, 2, [6, 4, 1], 6),
    # 1025 states: the beta pass runs JointWeightFn.apply through the
    # joint+head kernels' gate (their plain versions on CPU tensors).
    'fld2_v1024': (1024, 2, [3, 2], 3),
}


def joint_lattices(vocab, max_expansions):
  jax_lattice = last_torch_tpu.RecognitionLattice(
      context=jax_contexts.FullNGram(vocab_size=vocab, context_size=1),
      alignment=jax_alignment(max_expansions),
      weight_fn_cacher_factory=lambda ctx: jax_weight_fns.SharedEmbCacher(
          num_context_states=ctx.shape()[0], embedding_size=EMBEDDING),
      weight_fn_factory=lambda ctx: jax_weight_fns.JointWeightFn(
          vocab_size=ctx.shape()[1], hidden_size=HIDDEN))
  torch_lattice = last_torch_tpu_torch.RecognitionLattice(
      context=contexts.FullNGram(vocab_size=vocab, context_size=1),
      alignment=torch_alignment(max_expansions),
      weight_fn_cacher_factory=lambda ctx: weight_fns.SharedEmbCacher(
          num_context_states=ctx.shape()[0], embedding_size=EMBEDDING),
      weight_fn_factory=lambda ctx: weight_fns.JointWeightFn(
          vocab_size=ctx.shape()[1], hidden_size=HIDDEN))
  return jax_lattice, torch_lattice


def jax_score(lattice, params, frames, num_frames, slots):
  """JAX's ``log_prob`` of given paths: the arc weights at each slot's state
  from ``weight_fn.apply``, minus ``shortest_distance``'s log Z."""
  batch, m, _ = slots.shape
  max_t, features = frames.shape[1:]
  num_align = lattice.alignment.num_states()
  slots = jnp.asarray(slots).reshape(batch, m, max_t, num_align)
  cache = lattice.build_cache(params)
  state = jnp.full((batch, m), lattice.context.start(), jnp.int32)
  logw = jnp.zeros((batch, m))
  for t in range(max_t):
    frame = jnp.broadcast_to(frames[:, t, None, :], (batch, m, features))
    done = jnp.broadcast_to((t >= num_frames)[:, None], (batch, m))
    for e in range(num_align):
      y = slots[..., t, e]
      blank, lexical = lattice.weight_fn.apply(params['weight_fn'], cache,
                                               frame, state)
      label_w = jnp.take_along_axis(lexical, jnp.maximum(y - 1, 0)[..., None],
                                    axis=-1)[..., 0]
      logw = logw + jnp.where(done, 0.0, jnp.where(y > 0, label_w, blank))
      done = done | (y == 0)
      state = lattice.context.next_state(state, y)
  log_z = lattice.shortest_distance(params, frames, num_frames)
  return logw - log_z[:, None]


@pytest.mark.parametrize('case', sorted(JOINT_CASES))
def test_log_prob_and_gradients_match_a_jax_scoring(case):
  vocab, max_expansions, num_frames, m = JOINT_CASES[case]
  jax_lattice, lattice = joint_lattices(vocab, max_expansions)
  params = jax.tree.map(np.asarray, jax_lattice.init(jax.random.PRNGKey(1),
                                                     feature_size=FEATURES))
  rng = np.random.default_rng(2)
  frames = rng.standard_normal((len(num_frames), max(num_frames),
                                FEATURES)).astype(np.float32)
  num_frames = np.asarray(num_frames, np.int32)
  cotangent = rng.standard_normal((len(num_frames), m)).astype(np.float32)

  torch_params = convert.from_jax_params(params, device='cpu')
  for leaf in pytree.tree_leaves(torch_params):
    leaf.requires_grad_(True)
  frames_t = torch.from_numpy(frames).requires_grad_(True)
  before = joint_head.forward_launches, joint_head.backward_launches
  labels, _, log_prob = lattice.sample_paths(
      torch_params, frames_t, torch.from_numpy(num_frames),
      torch.Generator().manual_seed(3), num_samples=m)
  (log_prob * torch.from_numpy(cotangent)).sum().backward()
  assert (joint_head.forward_launches,
          joint_head.backward_launches) == before  # CPU: plain versions
  assert bool((labels > 0).any())

  def total(p, f):
    lp = jax_score(jax_lattice, p, f, num_frames, np.asarray(labels))
    return jnp.sum(lp * cotangent), lp

  (_, want), (d_params, d_frames) = jax.value_and_grad(
      total, argnums=(0, 1), has_aux=True)(jax.tree.map(jnp.asarray, params),
                                           jnp.asarray(frames))
  npt.assert_allclose(log_prob.detach().numpy(), np.asarray(want),
                      rtol=1e-5, atol=1e-5)
  want_grads = {'/'.join(str(k.key) for k in path): np.asarray(g) for path, g
                in jax.tree_util.tree_flatten_with_path(d_params)[0]}
  want_grads['frames'] = np.asarray(d_frames)
  got_grads = {'/'.join(str(k.key) for k in path): leaf.grad.numpy()
               for path, leaf in pytree.tree_flatten_with_path(
                   torch_params)[0]}
  got_grads['frames'] = frames_t.grad.numpy()
  assert set(got_grads) == set(want_grads)
  scale = max(float(np.abs(g).max()) for g in want_grads.values())
  for name, w in want_grads.items():
    npt.assert_allclose(got_grads[name], w, rtol=0, atol=1e-4 * scale,
                        err_msg=name)


def test_row_generators_make_rows_independent():
  jax_lattice, lattice = joint_lattices(5, 2)
  params = convert.from_jax_params(jax.tree.map(
      np.asarray, jax_lattice.init(jax.random.PRNGKey(4),
                                   feature_size=FEATURES)), device='cpu')
  frames = torch.from_numpy(np.random.default_rng(5).standard_normal(
      (4, 70, FEATURES)).astype(np.float32))  # two noise chunks of frames
  num_frames = torch.tensor([70, 65, 3, 40])
  rows = lambda: risk.per_example_keys(torch.Generator().manual_seed(6), 4)
  with torch.no_grad():
    whole = lattice.sample_paths(params, frames, num_frames, rows(),
                                 num_samples=5)
    half = lattice.sample_paths(params, frames[2:], num_frames[2:],
                                rows()[2:], num_samples=5)
  npt.assert_array_equal(whole[0][2:].numpy(), half[0].numpy())
  npt.assert_allclose(whole[2][2:].numpy(), half[2].numpy(), rtol=1e-6)
  with pytest.raises(ValueError, match='one generator per row'):
    lattice.sample_paths(params, frames, num_frames, rows()[:3])
