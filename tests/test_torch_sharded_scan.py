"""The port's vocab-sharded lattice computations against the JAX package,
in one process (one vocab shard; ``tests/test_torch_parallel.py`` runs the
sharded ranks).

``frame_reduce`` (its plain versions, on CPU tensors) is held to JAX's
``sharded_scan.frame_reduce`` in interpret mode at JAX's own test shape,
and to JAX's plain oracle at a shape JAX's kernel refuses (S and Vl off the
128 lanes): values to rtol 1e-5, the seven gradients under random
cotangents to rtol 2e-4, as ``tests/test_sharding.py`` holds the TPU
kernel. ``sharded_shortest_distance`` and ``tp_lattice_loss`` are held to
JAX's ``RecognitionLattice.shortest_distance`` / ``loss``: values to rtol
1e-5 / atol 1e-6, gradients per leaf to 1e-4 of the global gradient scale
(float32 both sides, sums in another order; FrameLabelDependent's
``blank_b`` gradient is a structural zero made of rounding residue).
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
from last_torch_tpu.ops import sharded_scan as jax_sharded_scan
import last_torch_tpu_torch
from last_torch_tpu_torch import alignments, contexts, convert, weight_fns
from last_torch_tpu_torch.ops import fused_scan, joint_head, sharded_scan

torch.set_num_threads(1)
torch.set_float32_matmul_precision('highest')

FRAME_REDUCE_NAMES = ('d_vec', 'd_pf', 'd_pc', 'd_vw', 'd_vb', 'd_bw', 'd_bb')


def frame_reduce_inputs(seed, batch, states, hidden, vocab, dead_from):
  """numpy inputs of one frame's reduction (states from ``dead_from`` on
  at -inf, as JAX's padded states) and cotangents of both outputs."""
  rng = np.random.default_rng(seed)
  vec = rng.normal(size=(batch, states)).astype(np.float32)
  vec[:, dead_from:] = -np.inf
  args = [vec] + [rng.normal(size=shape).astype(np.float32) * scale
                  for shape, scale in (((batch, hidden), 1.0),
                                       ((states, hidden), 1.0),
                                       ((hidden, vocab), 0.3),
                                       ((vocab,), 1.0), ((hidden,), 1.0),
                                       ((), 1.0))]
  d_red = rng.normal(size=(batch, vocab)).astype(np.float32)
  d_blank = rng.normal(size=(batch, states)).astype(np.float32)
  return args, d_red, d_blank


def jax_frame_reduce_oracle(vec, pf, pc, vw, vb, bw, bb):
  """``tests/test_sharding.py``'s oracle of the TPU kernel."""
  joint = jnp.tanh(pc[None] + pf[:, None])
  lex = joint @ vw + vb
  blank = joint @ bw[:, None] + bb
  red = jax.scipy.special.logsumexp(vec[:, :, None] + lex, axis=1)
  return red, blank[..., 0]


def jax_values_and_grads(fn, args, d_red, d_blank):
  def total(*a):
    red, blank = fn(*a)
    return jnp.sum(red * d_red) + jnp.sum(blank * d_blank)
  args = [jnp.asarray(a) for a in args]
  values = fn(*args)
  grads = jax.grad(total, argnums=tuple(range(7)))(*args)
  return [np.asarray(v) for v in values], [np.asarray(g) for g in grads]


def torch_values_and_grads(args, d_red, d_blank):
  leaves = [torch.tensor(a, requires_grad=True) for a in args]
  red, blank = sharded_scan.frame_reduce(*leaves)
  grads = torch.autograd.grad(
      (red * torch.from_numpy(d_red)).sum() +
      (blank * torch.from_numpy(d_blank)).sum(), leaves)
  return ([red.detach().numpy(), blank.detach().numpy()],
          [g.numpy() for g in grads])


def test_frame_reduce_matches_jax_kernel_in_interpret_mode():
  args, d_red, d_blank = frame_reduce_inputs(0, batch=3, states=256,
                                             hidden=16, vocab=128,
                                             dead_from=200)
  want_values, want_grads = jax_values_and_grads(
      lambda *a: jax_sharded_scan.frame_reduce(*a, 8, True), args, d_red,
      d_blank)
  got_values, got_grads = torch_values_and_grads(args, d_red, d_blank)
  for got, want in zip(got_values, want_values):
    npt.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
  for name, got, want in zip(FRAME_REDUCE_NAMES, got_grads, want_grads):
    npt.assert_allclose(got, want, rtol=2e-4, atol=1e-5, err_msg=name)
  assert np.all(got_grads[0][:, 200:] == 0)  # d_vec at the dead states


def test_frame_reduce_takes_shapes_off_the_lanes():
  """S=200, Vl=96, B=5: JAX's kernel refuses them (128-lane rule); the
  port takes them, held to JAX's oracle."""
  args, d_red, d_blank = frame_reduce_inputs(1, batch=5, states=200,
                                             hidden=16, vocab=96,
                                             dead_from=150)
  with pytest.raises(ValueError, match='128-aligned'):
    jax_sharded_scan.frame_reduce(*[jnp.asarray(a) for a in args], 8, True)
  want_values, want_grads = jax_values_and_grads(jax_frame_reduce_oracle,
                                                 args, d_red, d_blank)
  got_values, got_grads = torch_values_and_grads(args, d_red, d_blank)
  for got, want in zip(got_values, want_values):
    npt.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
  for name, got, want in zip(FRAME_REDUCE_NAMES, got_grads, want_grads):
    npt.assert_allclose(got, want, rtol=2e-4, atol=1e-5, err_msg=name)


VOCAB, HIDDEN, EMBEDDING, FEATURES = 7, 8, 6, 5
NUM_FRAMES = np.array([6, 3, 0], np.int32)  # full, padded, empty
LABELS = np.array([[2, 5, 1, 3], [4, 7, 0, 0], [0, 0, 0, 0]], np.int32)
NUM_LABELS = np.array([4, 2, 0], np.int32)
ALIGNMENTS = {
    'fd': (jax_alignments.FrameDependent, alignments.FrameDependent),
    'fld1': (lambda: jax_alignments.FrameLabelDependent(1),
             lambda: alignments.FrameLabelDependent(1)),
    'fld2': (lambda: jax_alignments.FrameLabelDependent(2),
             lambda: alignments.FrameLabelDependent(2)),
}


def lattices(alignment, locally_normalized=False, vocab=VOCAB):
  """(JAX lattice, port lattice) of the same configuration."""
  def make(package, ctx_lib, align, wf_lib):
    def weight_fn(ctx):
      joint = wf_lib.JointWeightFn(vocab_size=ctx.shape()[1],
                                   hidden_size=HIDDEN)
      if locally_normalized:
        return wf_lib.LocallyNormalizedWeightFn(joint)
      return joint
    return package.RecognitionLattice(
        context=ctx_lib.FullNGram(vocab_size=vocab, context_size=1),
        alignment=align(),
        weight_fn_cacher_factory=lambda ctx: wf_lib.SharedEmbCacher(
            num_context_states=ctx.shape()[0], embedding_size=EMBEDDING),
        weight_fn_factory=weight_fn)
  jax_align, torch_align = ALIGNMENTS[alignment]
  return (make(last_torch_tpu, jax_contexts, jax_align, jax_weight_fns),
          make(last_torch_tpu_torch, contexts, torch_align, weight_fns))


def make_inputs(seed, jax_lattice):
  params = jax_lattice.init(jax.random.PRNGKey(seed), feature_size=FEATURES)
  frames = np.random.default_rng(seed).standard_normal(
      (len(NUM_FRAMES), 6, FEATURES)).astype(np.float32)
  return jax.tree.map(np.asarray, params), frames


def with_grad(params, frames):
  params = convert.from_jax_params(params, device='cpu')
  for leaf in pytree.tree_leaves(params):
    leaf.requires_grad_(True)
  return params, torch.from_numpy(frames).requires_grad_(True)


def assert_grads_close(got, want, rtol=1e-4):
  """Per leaf, to rtol of the global gradient scale."""
  scale = max(float(np.abs(w).max()) for w in jax.tree.leaves(want))
  for path, w in jax.tree_util.tree_flatten_with_path(want)[0]:
    g = got
    for key in path:
      g = g[key.key]
    npt.assert_allclose(g.numpy(), w, rtol=0, atol=rtol * scale,
                        err_msg=str(path))


@pytest.mark.parametrize('alignment', ['fd', 'fld1', 'fld2'])
def test_sharded_shortest_distance_matches_jax_log_z(alignment):
  jax_lattice, lattice = lattices(alignment)
  params, frames = make_inputs(3, jax_lattice)
  g = np.array([1.0, 0.7, 1.3], np.float32)

  def total(p, f):
    return jnp.sum(jax_lattice.shortest_distance(p, f, NUM_FRAMES) * g)
  want = np.asarray(jax_lattice.shortest_distance(params, frames, NUM_FRAMES))
  want_params, want_frames = jax.grad(total, argnums=(0, 1))(
      jax.tree.map(jnp.asarray, params), jnp.asarray(frames))

  torch_params, torch_frames = with_grad(params, frames)
  frame_dependent = alignment == 'fd'
  before = (sharded_scan.forward_launches, sharded_scan.backward_launches)
  log_z = sharded_scan.sharded_shortest_distance(
      torch_params['weight_fn'], lattice.build_cache(torch_params),
      torch_frames, torch.from_numpy(NUM_FRAMES),
      max_expansions=0 if frame_dependent else int(alignment[-1]),
      frame_dependent=frame_dependent,
      num_context_states=lattice.context.shape()[0])
  (log_z * torch.from_numpy(g)).sum().backward()
  # CPU tensors run the plain versions: no kernel launch counted.
  assert (sharded_scan.forward_launches,
          sharded_scan.backward_launches) == before
  npt.assert_allclose(log_z.detach().numpy(), want, rtol=1e-5, atol=1e-6)
  assert log_z[2].item() == 0.0  # no frames: the start state's weight
  assert_grads_close(pytree.tree_map(lambda x: x.grad, torch_params),
                     jax.tree.map(np.asarray, want_params))
  npt.assert_allclose(torch_frames.grad.numpy(), np.asarray(want_frames),
                      rtol=1e-4, atol=1e-6)
  assert np.all(torch_frames.grad.numpy()[1, 3:] == 0)


def test_sharded_shortest_distance_chains_blocks_of_frames():
  """alpha0 / t_offset / return_alpha: two halves of the frames chained
  give the whole."""
  jax_lattice, lattice = lattices('fld2')
  params, frames = make_inputs(4, jax_lattice)
  torch_params = convert.from_jax_params(params, device='cpu')
  kw = dict(max_expansions=2, frame_dependent=False,
            num_context_states=lattice.context.shape()[0])
  cache = lattice.build_cache(torch_params)
  frames = torch.from_numpy(frames)
  num_frames = torch.from_numpy(NUM_FRAMES)
  whole = sharded_scan.sharded_shortest_distance(
      torch_params['weight_fn'], cache, frames, num_frames, **kw)
  alpha = sharded_scan.sharded_shortest_distance(
      torch_params['weight_fn'], cache, frames[:, :2], num_frames,
      return_alpha=True, **kw)
  assert tuple(alpha.shape) == (len(NUM_FRAMES), VOCAB + 1)
  chained = sharded_scan.sharded_shortest_distance(
      torch_params['weight_fn'], cache, frames[:, 2:], num_frames,
      alpha0=alpha, t_offset=2, **kw)
  npt.assert_allclose(chained.numpy(), whole.numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize('alignment,locally_normalized',
                         [('fd', False), ('fld2', False), ('fld1', True)])
def test_tp_lattice_loss_matches_jax_loss(alignment, locally_normalized):
  jax_lattice, lattice = lattices(alignment, locally_normalized)
  params, frames = make_inputs(5, jax_lattice)

  def total(p, f):
    return jnp.sum(jax_lattice(p, f, NUM_FRAMES, LABELS, NUM_LABELS))
  want = np.asarray(jax_lattice(params, frames, NUM_FRAMES, LABELS,
                                NUM_LABELS))
  want_params, want_frames = jax.grad(total, argnums=(0, 1))(
      jax.tree.map(jnp.asarray, params), jnp.asarray(frames))

  torch_params, torch_frames = with_grad(params, frames)
  loss = sharded_scan.tp_lattice_loss(
      lattice, torch_params, torch_frames, torch.from_numpy(NUM_FRAMES),
      torch.from_numpy(LABELS), torch.from_numpy(NUM_LABELS))
  loss.sum().backward()
  npt.assert_allclose(loss.detach().numpy(), want, rtol=1e-5, atol=1e-6)
  assert_grads_close(pytree.tree_map(lambda x: x.grad, torch_params),
                     jax.tree.map(np.asarray, want_params))
  npt.assert_allclose(torch_frames.grad.numpy(), np.asarray(want_frames),
                      rtol=1e-4, atol=1e-6)


class SubclassedJoint(weight_fns.JointWeightFn):
  """Not exactly a JointWeightFn: outside the tensor-parallel gate (the
  JAX test takes a TableWeightFn, which the port does not have yet)."""


def test_tp_supported_gating():
  def make(context, weight_fn_factory, alignment=None):
    return last_torch_tpu_torch.RecognitionLattice(
        context=context,
        alignment=alignment or alignments.FrameDependent(),
        weight_fn_cacher_factory=lambda ctx: weight_fns.SharedEmbCacher(
            num_context_states=ctx.shape()[0], embedding_size=4),
        weight_fn_factory=weight_fn_factory)

  bigram = contexts.FullNGram(vocab_size=4, context_size=1)
  trigram = contexts.FullNGram(vocab_size=4, context_size=2)
  joint = lambda ctx: weight_fns.JointWeightFn(vocab_size=4, hidden_size=8)
  assert sharded_scan.tp_supported(make(bigram, joint))
  assert sharded_scan.tp_supported(
      make(bigram, joint, alignments.FrameLabelDependent(2)))
  assert not sharded_scan.tp_supported(make(trigram, joint))
  sub = lambda ctx: SubclassedJoint(vocab_size=4, hidden_size=8)
  assert not sharded_scan.tp_supported(make(bigram, sub))
  # Locally normalized: numerator-only, always coverable.
  local = lambda ctx: weight_fns.LocallyNormalizedWeightFn(joint(ctx))
  assert sharded_scan.tp_supported(make(bigram, local))
  assert sharded_scan.tp_supported(make(trigram, local))


def test_tp_plan_drops_the_lane_and_backend_rules():
  _, lattice = lattices('fld2', vocab=6)
  assert sharded_scan.tp_plan(lattice, 6, 2, device='cpu') == 'plain'
  # Shards of 3 labels: JAX wants 128-lane shards and a TPU backend.
  assert sharded_scan.tp_plan(lattice, 6, 2, device='cuda') == 'kernel'
  assert sharded_scan.tp_plan(lattice, 6, 4, device='cpu') is None
  assert sharded_scan.tp_plan(lattice, 6, 0, device='cpu') is None
  lattice.fused = 'never'
  assert sharded_scan.tp_plan(lattice, 6, 2, device='cpu') is None
  # The JAX package's plan for the same configuration off the TPU: none.
  jax_lattice, _ = lattices('fld2', vocab=6)
  assert jax_sharded_scan.tp_plan(jax_lattice, 6, 2, 'cpu') is None


SMS = 132  # an H100's SMs


@pytest.mark.parametrize('vocab', [1024, 256, 200])
def test_bfloat16_backward_fills_the_card_at_every_shard(vocab):
  """The headline frame (B=8, S=1025, h=512) with the whole head (Vl=1024),
  one of 4 shards (256) and a ragged shard: every product has a block per
  SM, and d_lex reaches device memory only in bfloat16."""
  batch, states, hidden = 8, 1025, 512
  grid = fused_scan.wgmma_grid(batch, states, hidden, vocab, SMS)
  for name, blocks in grid.blocks.items():
    assert blocks >= SMS, name
  scratch = sharded_scan.backward_scratch(batch, states, hidden, vocab, grid)
  assert scratch['d_lex'] == ((batch, states, grid.vocab_pad),
                              torch.bfloat16)
  for name, (shape, dtype) in scratch.items():
    if shape[:2] == (batch, states):  # only the float32 joint is float32
      assert dtype == torch.bfloat16 or shape[2] == hidden, name
  assert scratch['dpc_part'][0] == (grid.dsplits, states, hidden)


def test_bfloat16_backward_workspace_is_aligned_and_disjoint():
  args = (5, 77, 42, 37, SMS)  # h and Vl off the 64-deep stages
  (splits, dsplits), offsets, size = sharded_scan._workspace(*args)
  grid = fused_scan.wgmma_grid(*args)
  assert (splits, dsplits) == (grid.ksplits, grid.dsplits)
  assert (grid.hidden_pad, grid.vocab_pad) == (64, 64)
  spans = []
  for name, (shape, dtype) in sharded_scan.backward_scratch(
      *args[:4], grid).items():
    assert offsets[name] % 256 == 0, name
    itemsize = torch.empty((), dtype=dtype).element_size()
    spans.append((offsets[name], offsets[name] + np.prod(shape) * itemsize))
  spans.sort()
  assert all(end <= start for (_, end), (start, _) in zip(spans, spans[1:]))
  assert spans[-1][1] <= size


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
@pytest.mark.parametrize('batch,states,hidden,vocab', [
    (8, 1025, 512, 1024),  # the headline frame, the whole head
    (8, 1025, 512, 256),  # one of 4 shards
    (8, 1025, 80, 520),  # h and Vl off the 64-deep stages
    (5, 77, 512, 1024),  # a ragged 64-state unit
    (3, 77, 80, 520),
])
def test_forward_workspace_is_aligned_disjoint_and_sized(batch, states,
                                                         hidden, vocab,
                                                         dtype):
  """The forward's one workspace: the (max, sum) partials per 64-state
  unit and, in bfloat16, the padded joint and head of the column-reduce
  product, each 256-byte aligned and disjoint; the product's persistent
  grid is capped at two blocks an SM."""
  max_blocks, offsets, size = sharded_scan._forward_workspace(
      batch, states, hidden, vocab, dtype, SMS)
  plan = joint_head.reduce_plan(batch, states, hidden, vocab, SMS)
  scratch = sharded_scan.forward_scratch(
      batch, states, hidden, vocab, dtype,
      plan if dtype == torch.bfloat16 else None)
  part = ((-(-states // 64), batch, vocab), torch.float32)
  want = {'part_m': part, 'part_s': part}
  if dtype == torch.bfloat16:
    want['joint'] = ((batch, states, plan.hidden_pad), torch.bfloat16)
    want['vw16'] = ((plan.hidden_pad, plan.vocab_pad), torch.bfloat16)
    assert max_blocks == plan.max_blocks == 2 * SMS
  else:
    assert max_blocks == 0
  assert scratch == want
  spans = []
  for name, (shape, item) in scratch.items():
    assert offsets[name] % 256 == 0, name
    spans.append((offsets[name], offsets[name] +
                  np.prod(shape) * torch.empty((), dtype=item).element_size()))
  spans.sort()
  assert all(end <= start for (_, end), (start, _) in zip(spans, spans[1:]))
  assert spans[-1][1] <= size < spans[-1][1] + 256
