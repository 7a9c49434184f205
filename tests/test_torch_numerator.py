"""The port's local normalizers and numerator against the JAX package.

The normalizers and ``LocallyNormalizedWeightFn.apply`` are held to JAX at
rtol 1e-5 / atol 1e-6 (float32, summation order only), and stay finite for
blank weights of +-1000. ``LocallyNormalizedWeightFn.label_weights``
through the port's numerator route (the kernels' plain versions on CPU
tensors) is held to JAX's XLA frame-major scan and to JAX's Pallas kernel
in interpret mode, values to rtol/atol 1e-5 and the gradients of every
parameter and frame (torch autograd against ``jax.vjp``, the same numpy
cotangents) to 1e-4 of the largest gradient (float32 both sides, other
summation order); in bfloat16 to the interpret-mode kernel, values to 1e-5
and gradients to 1e-3 of their largest. With two batch dimensions (outside
JAX's kernel gate, so JAX takes its frame-major XLA scan) the port flattens
them into its numerator route, held to JAX alike.
"""

import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch
from torch.utils import _pytree as pytree

from last_torch_tpu import weight_fns as jax_weight_fns
from last_torch_tpu.ops import numerator_scan as jax_numerator_scan
from last_torch_tpu_torch import convert, weight_fns
from last_torch_tpu_torch.ops import numerator_scan

torch.set_num_threads(1)
torch.set_float32_matmul_precision('highest')

NORMALIZERS = {
    'hat': (jax_weight_fns.hat_normalize, weight_fns.hat_normalize),
    'log_softmax': (jax_weight_fns.log_softmax_normalize,
                    weight_fns.log_softmax_normalize),
}
# The JAX kernel needs hidden % 128 == 0; V = 70 is ragged for every tile.
HIDDEN, EMBEDDING, VOCAB, NUM_STATES = 128, 16, 70, 9


@pytest.mark.parametrize('name', sorted(NORMALIZERS))
def test_normalizers_match_jax(name):
  jax_fn, torch_fn = NORMALIZERS[name]
  rng = np.random.default_rng(0)
  blank = rng.standard_normal((5,)).astype(np.float32) * 3
  lexical = rng.standard_normal((5, 8)).astype(np.float32) * 3
  # Large weights: the naive log(1 + exp(b)) overflows here.
  blank[:2] = [1000.0, -1000.0]
  lexical[0, 0], lexical[1, 1] = 1000.0, -1000.0
  want = jax_fn(jnp.asarray(blank), jnp.asarray(lexical))
  got = torch_fn(torch.from_numpy(blank), torch.from_numpy(lexical))
  for g, w in zip(got, want):
    assert torch.isfinite(g).all()
    npt.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)
  total = torch.exp(got[0][2:]) + torch.exp(got[1][2:]).sum(-1)
  npt.assert_allclose(total.numpy(), 1.0, rtol=1e-5)


def make_weight_fns(name, hidden=HIDDEN, vocab=VOCAB):
  jax_fn, torch_fn = NORMALIZERS[name]
  jax_wf = jax_weight_fns.LocallyNormalizedWeightFn(
      jax_weight_fns.JointWeightFn(vocab_size=vocab, hidden_size=hidden),
      normalize=jax_fn)
  torch_wf = weight_fns.LocallyNormalizedWeightFn(
      weight_fns.JointWeightFn(vocab_size=vocab, hidden_size=hidden),
      normalize=torch_fn)
  return jax_wf, torch_wf


def make_inputs(seed, batch_dims, max_t, u1, vocab=VOCAB):
  rng = np.random.default_rng(seed)
  cache = rng.standard_normal((NUM_STATES, EMBEDDING)).astype(np.float32)
  frames = rng.standard_normal(batch_dims + (max_t, 6)).astype(np.float32)
  states = rng.integers(0, NUM_STATES, batch_dims + (u1,)).astype(np.int32)
  # Label 0 (the dummy of the last position) occurs too.
  next_labels = rng.integers(0, vocab + 1,
                             batch_dims + (u1,)).astype(np.int32)
  return cache, frames, states, next_labels


def jax_params(jax_wf, cache, frames, seed):
  params = jax_wf.init(jax.random.PRNGKey(seed), jnp.asarray(cache),
                       jnp.zeros((frames.shape[-1],)))
  params['blank_b'] = jnp.asarray(0.4)
  params['vocab_b'] = jnp.linspace(-1.0, 1.0, params['vocab_b'].shape[0])
  return jax.tree.map(np.asarray, params)


@pytest.mark.parametrize('with_state', [False, True])
@pytest.mark.parametrize('name', sorted(NORMALIZERS))
def test_locally_normalized_apply_matches_jax(name, with_state):
  jax_wf, torch_wf = make_weight_fns(name, hidden=7, vocab=11)
  cache, frames, _, _ = make_inputs(1, (3,), 2, 1, vocab=11)
  params = jax_params(jax_wf, cache, frames, seed=1)
  frame = frames[:, 0]
  state = np.array([0, 4, 8]) if with_state else None
  want = jax_wf.apply(params, cache, frame,
                      None if state is None else jnp.asarray(state))
  got = torch_wf.apply(convert.from_jax_params(params, device='cpu'),
                       torch.from_numpy(cache), torch.from_numpy(frame),
                       None if state is None else torch.from_numpy(state))
  for g, w in zip(got, want):
    assert tuple(g.shape) == w.shape
    npt.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)


def jax_label_weights_vjp(jax_wf, params, cache, frames, states, next_labels,
                          cotangents):
  def fn(params, cache, frames):
    return jax_wf.label_weights(params, cache, frames, jnp.asarray(states),
                                jnp.asarray(next_labels))
  out, vjp = jax.vjp(fn, jax.tree.map(jnp.asarray, params),
                     jnp.asarray(cache), jnp.asarray(frames))
  grads = vjp(tuple(jnp.asarray(c) for c in cotangents))
  return ([np.asarray(x) for x in out],
          jax.tree.map(np.asarray, grads))


def torch_label_weights_grad(torch_wf, params, cache, frames, states,
                             next_labels, cotangents):
  params = convert.from_jax_params(params, device='cpu')
  for leaf in pytree.tree_leaves(params):
    leaf.requires_grad_(True)
  cache = torch.from_numpy(cache).requires_grad_(True)
  frames = torch.from_numpy(frames).requires_grad_(True)
  out = torch_wf.label_weights(params, cache, frames,
                               torch.from_numpy(states),
                               torch.from_numpy(next_labels))
  total = sum((o * torch.from_numpy(c)).sum() for o, c in zip(out,
                                                              cotangents))
  total.backward()
  grads = (pytree.tree_map(lambda x: x.grad.numpy(), params),
           cache.grad.numpy(), frames.grad.numpy())
  return [o.detach().numpy() for o in out], grads


def assert_same_gradients(got, want, rtol=1e-4):
  """Every leaf of (params, cache, frames) to rtol of the largest."""
  want_leaves = jax.tree.leaves(want)
  scale = max(float(np.abs(w).max()) for w in want_leaves)
  got_leaves = [got[0][k] for k in sorted(got[0])] + list(got[1:])
  assert len(got_leaves) == len(want_leaves)
  for g, w in zip(got_leaves, want_leaves):
    npt.assert_allclose(g, w, rtol=0, atol=rtol * scale)


@pytest.mark.parametrize('name', sorted(NORMALIZERS))
@pytest.mark.parametrize('jax_route', ['xla', 'interpret'])
def test_numerator_route_matches_jax(monkeypatch, jax_route, name):
  if jax_route == 'interpret':
    monkeypatch.setattr(jax_numerator_scan, 'FORCE_INTERPRET', True)
  batch, max_t, u1 = 2, 3, 5
  jax_wf, torch_wf = make_weight_fns(name)
  cache, frames, states, next_labels = make_inputs(2, (batch,), max_t, u1)
  params = jax_params(jax_wf, cache, frames, seed=2)
  assert jax_numerator_scan.supported(
      jax_wf.weight_fn, cache, jnp.zeros(frames.shape[:-1] + (HIDDEN,)),
      states, next_labels) == (jax_route == 'interpret')
  rng = np.random.default_rng(3)
  cotangents = [rng.standard_normal((batch, u1, max_t)).astype(np.float32)
                for _ in range(2)]
  cotangents[0][1] = 0.0  # batch row 1: g = 0 for blank ...
  cotangents[1][1] = 0.0  # ... and for the label weights
  want, want_grads = jax_label_weights_vjp(
      jax_wf, params, cache, frames, states, next_labels, cotangents)
  before = numerator_scan.forward_launches, numerator_scan.backward_launches
  got, got_grads = torch_label_weights_grad(
      torch_wf, params, cache, frames, states, next_labels, cotangents)
  assert (numerator_scan.forward_launches,
          numerator_scan.backward_launches) == before  # CPU: plain versions
  for g, w in zip(got, want):
    assert g.shape == (batch, u1, max_t)
    npt.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
  assert_same_gradients(got_grads, want_grads)
  # The zero-cotangent row contributes nothing: its frames' gradient is 0.
  assert np.all(got_grads[2][1] == 0)


@pytest.mark.parametrize('name', sorted(NORMALIZERS))
def test_bf16_numerator_route_matches_jax_kernel(monkeypatch, name):
  """bfloat16 compute: both round the projections' inputs, the joint and
  vocab_w (and ds) at the same points and sum in float32, so values agree
  to 1e-5 of their largest and gradients to 1e-3 of the largest gradient
  (a float32 tanh on either side of a rounding boundary would move one
  joint entry by a bfloat16 step)."""
  monkeypatch.setattr(jax_numerator_scan, 'FORCE_INTERPRET', True)
  batch, max_t, u1 = 2, 3, 4
  jax_fn, torch_fn = NORMALIZERS[name]
  jax_wf = jax_weight_fns.LocallyNormalizedWeightFn(
      jax_weight_fns.JointWeightFn(vocab_size=VOCAB, hidden_size=HIDDEN,
                                   compute_dtype=jnp.bfloat16),
      normalize=jax_fn)
  torch_wf = weight_fns.LocallyNormalizedWeightFn(
      weight_fns.JointWeightFn(vocab_size=VOCAB, hidden_size=HIDDEN,
                               compute_dtype=torch.bfloat16),
      normalize=torch_fn)
  cache, frames, states, next_labels = make_inputs(6, (batch,), max_t, u1)
  params = jax_params(jax_wf, cache, frames, seed=6)
  rng = np.random.default_rng(7)
  cotangents = [rng.standard_normal((batch, u1, max_t)).astype(np.float32)
                for _ in range(2)]
  want, want_grads = jax_label_weights_vjp(
      jax_wf, params, cache, frames, states, next_labels, cotangents)
  got, got_grads = torch_label_weights_grad(
      torch_wf, params, cache, frames, states, next_labels, cotangents)
  for g, w in zip(got, want):
    npt.assert_allclose(g, w, rtol=0, atol=1e-5 * np.abs(w).max())
  assert_same_gradients(got_grads, want_grads, rtol=1e-3)


def test_outside_the_gate_frame_major_route_matches_jax():
  """Two batch dimensions: JAX takes its frame-major scan, the port
  flattens them into one for its numerator route."""
  batch_dims, max_t, u1 = (2, 2), 3, 4
  jax_wf, torch_wf = make_weight_fns('hat', hidden=10, vocab=13)
  cache, frames, states, next_labels = make_inputs(4, batch_dims, max_t, u1,
                                                   vocab=13)
  params = jax_params(jax_wf, cache, frames, seed=4)
  rng = np.random.default_rng(5)
  cotangents = [rng.standard_normal(batch_dims + (u1, max_t)).astype(
      np.float32) for _ in range(2)]
  want, want_grads = jax_label_weights_vjp(
      jax_wf, params, cache, frames, states, next_labels, cotangents)
  got, got_grads = torch_label_weights_grad(
      torch_wf, params, cache, frames, states, next_labels, cotangents)
  for g, w in zip(got, want):
    assert g.shape == batch_dims + (u1, max_t)
    npt.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
  assert_same_gradients(got_grads, want_grads)


def test_numerator_route_with_no_frames():
  """T = 0: empty weights, and the backward gives zero gradients."""
  jax_wf, torch_wf = make_weight_fns('log_softmax', hidden=10, vocab=13)
  cache, frames, states, next_labels = make_inputs(8, (2,), 0, 3, vocab=13)
  params = jax_params(jax_wf, cache, frames, seed=8)
  cotangents = [np.zeros((2, 3, 0), np.float32)] * 2
  got, (param_grads, cache_grad, frames_grad) = torch_label_weights_grad(
      torch_wf, params, cache, frames, states, next_labels, cotangents)
  assert [g.shape for g in got] == [(2, 3, 0)] * 2
  assert frames_grad.shape == frames.shape
  for leaf in list(param_grads.values()) + [cache_grad]:
    assert np.all(leaf == 0)


def test_numerator_rejects_other_compute_types():
  """The kernels and their plain versions round to float32 or bfloat16."""
  torch_wf = weight_fns.LocallyNormalizedWeightFn(
      weight_fns.JointWeightFn(vocab_size=VOCAB, hidden_size=8,
                               compute_dtype=torch.float16))
  jax_wf, _ = make_weight_fns('hat', hidden=8)
  cache, frames, states, next_labels = make_inputs(9, (2,), 3, 4)
  params = convert.from_jax_params(jax_params(jax_wf, cache, frames, seed=9),
                                   device='cpu')
  with pytest.raises(ValueError, match='compute_dtype'):
    torch_wf.label_weights(params, torch.from_numpy(cache),
                           torch.from_numpy(frames), torch.from_numpy(states),
                           torch.from_numpy(next_labels))


def test_other_inner_weight_fns_or_normalizers_have_no_fast_path():
  class Joint(weight_fns.JointWeightFn):
    pass

  args = (None, None, None, None, None)
  assert weight_fns.LocallyNormalizedWeightFn(
      Joint(vocab_size=3, hidden_size=4)).label_weights(*args) is None
  assert weight_fns.LocallyNormalizedWeightFn(
      weight_fns.JointWeightFn(vocab_size=3, hidden_size=4),
      normalize=lambda b, l: (b, l)).label_weights(*args) is None


def live_list_by_loops(g_b, g_l, chunk):
  """The live list by explicit loops (``numerator_scan.live_tiles``'
  contract): [(t, tile)] in the order (chunk, tile, frame), and per (chunk,
  tile) the first position."""
  max_t, rows = g_b.shape
  r64 = -(-rows // 64)
  items, groups = [], []
  for t0 in range(0, max_t, chunk):
    for k in range(r64):
      groups.append(len(items))
      for t in range(t0, min(max_t, t0 + chunk)):
        rows_k = slice(k * 64, min(rows, k * 64 + 64))
        if bool((g_b[t, rows_k] != 0).any() or (g_l[t, rows_k] != 0).any()):
          items.append((t, k))
  groups.append(len(items))
  return items, groups


LIVE_CASES = {
    # name: (max_t, batch, u1, chunk, pattern)
    'all_dead': (5, 3, 37, 2, 'dead'),
    'all_live': (5, 3, 37, 2, 'live'),
    'straddling_u101': (9, 4, 101, 4, 'lengths'),  # rows 64-127 span rows 0, 1
    'u5_many_rows_a_tile': (6, 30, 5, 6, 'lengths'),
    'b1_ragged': (7, 1, 130, 3, 'lengths'),
    'one_frame_chunks': (4, 2, 70, 1, 'lengths'),
}


def live_cotangents(max_t, batch, u1, pattern, seed=0):
  """g_b, g_l [T, B * U1]: all zero, all nonzero, or nonzero only for t <
  T_b and u <= U_b (the string DP's mask) with a zero batch row."""
  rng = np.random.default_rng(seed)
  g = [rng.standard_normal((max_t, batch, u1)).astype(np.float32)
       for _ in range(2)]
  if pattern == 'dead':
    g = [x * 0 for x in g]
  elif pattern == 'lengths':
    frames = rng.integers(0, max_t + 1, size=batch)
    labels = rng.integers(0, u1, size=batch)
    t = np.arange(max_t)[:, None, None]
    u = np.arange(u1)[None, None, :]
    mask = (t < frames[None, :, None]) & (u <= labels[None, :, None])
    mask[:, batch // 2] = False
    g = [x * mask for x in g]
  return [torch.from_numpy(x.reshape(max_t, batch * u1)) for x in g]


@pytest.mark.parametrize('case', sorted(LIVE_CASES))
def test_live_tiles_plain_matches_loops(case):
  """The backward's live (frame, 64-row tile) list: every pair with a
  nonzero cotangent once, in (chunk, tile, frame) order, with the per
  (chunk, tile) offsets, per chunk counts and each pair's position."""
  max_t, batch, u1, chunk, pattern = LIVE_CASES[case]
  g_b, g_l = live_cotangents(max_t, batch, u1, pattern)
  items, groups, count, pos_of = numerator_scan.live_tiles(g_b, g_l, chunk)
  want_items, want_groups = live_list_by_loops(g_b, g_l, chunk)
  r64 = -(-batch * u1 // 64)
  n = len(want_items)
  assert [divmod(int(v), r64) for v in items[:n]] == want_items
  assert groups.tolist() == want_groups
  assert count.tolist() == [want_groups[(c + 1) * r64] -
                            want_groups[c * r64]
                            for c in range(-(-max_t // chunk))]
  want_pos = torch.full((max_t, r64), -1, dtype=torch.int32)
  for p, (t, k) in enumerate(want_items):
    want_pos[t, k] = p
  assert torch.equal(pos_of, want_pos)
  if pattern == 'dead':
    assert n == 0
  if pattern == 'live':
    assert n == max_t * r64


@pytest.mark.parametrize('u1', [1, 5, 37, 64, 65, 101, 130])
@pytest.mark.parametrize('batch', [1, 3, 8])
def test_rows_per_tile_is_the_most_batch_rows_of_a_tile(batch, u1):
  rows = batch * u1
  want = max(len({r // u1 for r in range(k, min(rows, k + 64))})
             for k in range(0, rows, 64))
  assert numerator_scan.rows_per_tile(batch, u1) == want


SMS = 132  # an H100's SMs


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
@pytest.mark.parametrize('max_t,batch,u1,hidden,vocab', [
    (1600, 8, 101, 512, 1024),  # the HAT training step (phase 6b)
    (1600, 32, 101, 512, 1024),  # bench config 7
    (9, 3, 5, 40, 70),  # ragged R, h and V
    (9, 1, 37, 2048, 1001),
])
def test_forward_plan_fits_its_chunk_and_covers_every_frame(
    max_t, batch, u1, hidden, vocab, dtype):
  """The forward's chunks stage at most _CHUNK_BYTES (or one frame) and,
  walked as the kernel walks them, hold every (frame, 64-row tile) item
  once; its product's grid is about one wave; its scratch lies in one
  buffer, 256-byte aligned and disjoint: the partials hold a (max, sum)
  pair per row and label strip, no logits."""
  plan = numerator_scan.forward_plan(max_t, batch, u1, hidden, vocab, dtype,
                                     SMS)
  scratch = numerator_scan.forward_scratch(batch, u1, hidden, vocab, dtype,
                                           plan.chunk)
  assert 1 <= plan.chunk <= max_t
  staged = sum(np.prod(shape) * torch.empty((), dtype=d).element_size()
               for name, (shape, d) in scratch.items() if name != 'wp')
  assert plan.chunk == 1 or staged <= numerator_scan._CHUNK_BYTES
  rows = batch * u1
  r64 = -(-rows // 64)
  hp, vp = -(-hidden // 64) * 64, -(-vocab // 64) * 64
  strip = 128 if dtype == torch.bfloat16 else 256
  assert scratch['wp'] == ((hp, vp), dtype)
  assert scratch['joint'] == ((plan.chunk * r64, 64, hp), dtype)
  assert scratch['part_m'] == scratch['part_l'] == (
      (-(-vp // strip), plan.chunk * rows), torch.float32)
  # The chunks, as run_forward walks them: every (frame, tile) once.
  walked = []
  for t0 in range(0, max_t, plan.chunk):
    frames = min(plan.chunk, max_t - t0)
    walked += [(t0 + slot // r64, slot % r64) for slot in range(frames * r64)]
  assert walked == [(t, k) for t in range(max_t) for k in range(r64)]
  strips = -(-vp // strip)
  assert plan.blocks >= 1 and plan.blocks * strips <= 2 * SMS
  assert plan.blocks * strips > 2 * SMS - strips
  spans = sorted((plan.offsets[name], plan.offsets[name] + np.prod(shape) *
                  torch.empty((), dtype=d).element_size())
                 for name, (shape, d) in scratch.items())
  assert all(start % 256 == 0 for start, _ in spans)
  assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
  assert spans[-1][1] <= plan.size


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
@pytest.mark.parametrize('max_t,batch,u1,hidden,vocab', [
    (1600, 8, 101, 512, 1024),  # the HAT training step (phase 6b)
    (1600, 32, 101, 512, 1024),  # bench config 7
    (9, 3, 5, 40, 70),  # ragged R, h and V
    (9, 1, 37, 2048, 1001),
])
def test_backward_plan_fits_its_chunk_and_the_card(max_t, batch, u1, hidden,
                                                   vocab, dtype):
  """The backward's chunks stage at most _CHUNK_BYTES (or one frame), its
  grids hold about a wave, and its scratch lies in one buffer, 256-byte
  aligned and disjoint, the staging padded to 64-deep stages."""
  plan = numerator_scan.backward_plan(max_t, batch, u1, hidden, vocab,
                                      dtype, SMS)
  scratch = numerator_scan.backward_scratch(
      max_t, batch, u1, hidden, vocab, dtype, plan.chunk, plan.blocks,
      plan.jgrid, plan.ksplits)
  assert 1 <= plan.chunk <= max_t
  staged = sum(np.prod(shape) * torch.empty((), dtype=d).element_size()
               for name, (shape, d) in scratch.items()
               if name in ('joint', 'joint32', 'ds', 'du', 'dpf_part'))
  assert plan.chunk == 1 or staged <= numerator_scan._CHUNK_BYTES
  r64 = -(-batch * u1 // 64)
  hp, vp = -(-hidden // 64) * 64, -(-vocab // 64) * 64
  assert scratch['joint'] == ((plan.chunk * r64, 64, hp), dtype)
  assert scratch['ds'] == ((plan.chunk * r64, 64, vp), dtype)
  assert ('joint32' in scratch) == (dtype == torch.bfloat16)
  assert plan.rows_per_tile == numerator_scan.rows_per_tile(batch, u1)
  if dtype == torch.float32:  # du staged, d_pc summed from it
    assert scratch['du'] == ((plan.chunk * r64, 64, hidden), torch.float32)
    assert 'joint32' not in scratch and scratch['dpc_part'][0][0] == 1
  else:  # the float32 joint staged, d_pc in the d_joint blocks' registers
    assert scratch['joint32'] == ((plan.chunk * r64, 64, hidden),
                                  torch.float32)
    assert 'du' not in scratch
    assert 1 <= plan.jgrid <= plan.chunk
    assert scratch['dpc_part'][0][0] == plan.jgrid
  assert plan.blocks >= 1 and plan.jgrid >= 1 and plan.ksplits >= 1
  spans = []
  for name, (shape, d) in scratch.items():
    assert plan.offsets[name] % 256 == 0, name
    itemsize = torch.empty((), dtype=d).element_size()
    spans.append((plan.offsets[name],
                  plan.offsets[name] + np.prod(shape) * itemsize))
  spans.sort()
  assert all(end <= start for (_, end), (start, _) in zip(spans, spans[1:]))
  assert spans[-1][1] <= plan.size
