"""The port's joint+head plain versions against the JAX package's kernel.

``ops/joint_head.py``'s plain forward and backward (what CPU tensors run)
are held to the JAX package's ``joint_head`` Pallas kernels in interpret
mode (``FORCE_INTERPRET`` on and ``_MIN_STATES`` 1, as its own tests set
them), on the same numpy inputs at hidden 128, ragged state and vocabulary
counts, compute type float32 and bfloat16: values to rtol 1e-5 (float32) or
1e-4 (bfloat16), of max(|value|, 1), both rounding the same float32 joint;
the gradients d_pc, d_pf, d_w and d_b to 1e-4 of their largest entry (the
same roundings of the cotangents, float32 sums in another order). In
bfloat16 the two libraries' float32 tanh can fall on either side of a
rounding boundary, which moves a joint entry by one bfloat16 step: the
values' and the head gradient's tolerances add exactly what those steps
can move them by (the steps found between the two tanh, times |w| or the
rounded |cotangent|). Then
``blank_lexical`` with its autograd Function against JAX's with
``jax.grad``, and the gate's both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch
from torch.utils import _pytree as pytree

from last_torch_tpu import weight_fns as jax_weight_fns
from last_torch_tpu.ops import joint_head as jax_joint_head
from last_torch_tpu_torch import convert, weight_fns
from last_torch_tpu_torch.ops import fused_scan, joint_head

torch.set_num_threads(1)
torch.set_float32_matmul_precision('highest')

HIDDEN, EMBEDDING, BATCH = 128, 16, 3
DTYPES = {'f32': (None, None, torch.float32),
          'bf16': (jnp.bfloat16, torch.bfloat16, torch.bfloat16)}
VALUE_RTOL = {'f32': 1e-5, 'bf16': 1e-4}
GRAD_RTOL = 1e-4


@pytest.fixture
def interpret_kernel(monkeypatch):
  """Routes JAX's apply() through its kernel in interpret mode at tiny
  shapes."""
  monkeypatch.setattr(jax_joint_head, 'FORCE_INTERPRET', True)
  monkeypatch.setattr(jax_joint_head, '_MIN_STATES', 1)


def make_inputs(seed, num_states, vocab):
  rng = np.random.default_rng(seed)
  cache = rng.standard_normal((num_states, EMBEDDING)).astype(np.float32)
  frame = rng.standard_normal((BATCH, HIDDEN)).astype(np.float32)
  wf = jax_weight_fns.JointWeightFn(vocab_size=vocab, hidden_size=HIDDEN)
  params = wf.init(jax.random.PRNGKey(seed), jnp.asarray(cache),
                   jnp.asarray(frame))
  params['vocab_b'] = jnp.asarray(rng.standard_normal(vocab), jnp.float32)
  params['blank_b'] = jnp.asarray(0.3, jnp.float32)
  g_blank = rng.standard_normal((BATCH, num_states)).astype(np.float32)
  g_lexical = rng.standard_normal((BATCH, num_states, vocab)).astype(
      np.float32)
  return cache, frame, jax.tree.map(np.asarray, params), g_blank, g_lexical


def rel(a, b):
  a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
  return float((np.abs(a - b) / np.maximum(np.abs(b), 1.0)).max())


def flip_steps(pc, pf, compute_dtype):
  """[B, S, h]: the bfloat16 steps between the port's and JAX's rounded
  tanh(pc + pf) (zeros in float32, where nothing is rounded)."""
  pc, pf = np.array(pc), np.array(pf)
  if compute_dtype == torch.float32:
    return np.zeros((pf.shape[0],) + pc.shape)
  ours = torch.tanh(torch.from_numpy(pc)[None] + torch.from_numpy(pf)[:, None])
  theirs = torch.from_numpy(np.array(jnp.tanh(pc[None] + pf[:, None])))
  return (ours.to(torch.bfloat16).float() -
          theirs.to(torch.bfloat16).float()).abs().double().numpy()


def flip_allowance(steps, w):
  """[B, S, n]: what the steps can move a product with w [h, n] by."""
  return steps @ np.abs(np.asarray(w, np.float64))


def weight_flip_allowance(steps, g_blank, g_lexical, compute_dtype):
  """[h, V + 1]: what the steps can move the head gradient (the rounded
  joint times the rounded cotangents, summed over rows) by."""
  g = torch.from_numpy(np.concatenate([g_lexical, g_blank[..., None]], -1))
  g = g.to(compute_dtype).double().abs().numpy()
  return np.einsum('bsh,bsv->hv', steps, g)


def within(a, b, rtol, allowance):
  a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
  return bool(np.all(np.abs(a - b) <= rtol * np.maximum(np.abs(b), 1.0) +
                     allowance))


def of_largest(a, b):
  a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
  return float(np.abs(a - b).max() / np.abs(b).max())


CASES = {
    # name: (num_states, vocab)
    's8_v5': (8, 5),
    's130_v127': (130, 127),
    's384_v5': (384, 5),
    's37_v7': (37, 7),
}


@pytest.mark.parametrize('dtype', sorted(DTYPES))
@pytest.mark.parametrize('case', sorted(CASES))
def test_plain_versions_match_jax_kernel(interpret_kernel, case, dtype):
  num_states, vocab = CASES[case]
  cache, frame, params, g_blank, g_lexical = make_inputs(0, num_states,
                                                         vocab)
  jax_dtype, _, compute_dtype = DTYPES[dtype]
  jax_compute = jax_dtype or jnp.float32
  # The kernel's own inputs, as JAX's blank_lexical forms them.
  pc = jax_joint_head._mm(jnp.asarray(cache), params['context_proj'],
                          jax_compute)
  pf = jax_joint_head._mm(jnp.asarray(frame), params['frame_proj'],
                          jax_compute)
  v_pad = -(-(vocab + 1) // 128) * 128
  w = np.zeros((HIDDEN, v_pad), np.float32)
  w[:, :vocab], w[:, vocab] = params['vocab_w'], params['blank_w']
  b = np.zeros((v_pad,), np.float32)
  b[:vocab], b[vocab] = params['vocab_b'], params['blank_b']
  full, vjp = jax.vjp(
      lambda *x: jax_joint_head._joint_head(*x, jax_compute, True), pc, pf,
      jnp.asarray(w), jnp.asarray(b))
  g = np.zeros((BATCH, num_states, v_pad), np.float32)
  g[..., :vocab], g[..., vocab] = g_lexical, g_blank
  d_pc_j, d_pf_j, d_w_j, d_b_j = (np.asarray(x) for x in vjp(jnp.asarray(g)))

  t = lambda x: torch.from_numpy(np.array(x, np.float32))
  head = (t(params['vocab_w']), t(params['blank_w']))
  blank, lexical = joint_head.joint_head_forward(
      t(pc), t(pf), *head, t(params['vocab_b']), t(params['blank_b']),
      compute_dtype=compute_dtype)
  steps = flip_steps(pc, pf, compute_dtype)
  assert within(blank, full[..., vocab], VALUE_RTOL[dtype],
                flip_allowance(steps, params['blank_w'][:, None])[..., 0])
  assert within(lexical, full[..., :vocab], VALUE_RTOL[dtype],
                flip_allowance(steps, params['vocab_w']))
  d_pc, d_pf, d_vocab_w, d_blank_w = joint_head.joint_head_backward(
      t(pc), t(pf), *head, t(g_blank), t(g_lexical),
      compute_dtype=compute_dtype)
  d_w = np.concatenate([d_vocab_w, d_blank_w[:, None]], axis=1)
  d_w_j = d_w_j[:, :vocab + 1]
  for name, got, want in (
      ('d_pc', d_pc, d_pc_j), ('d_pf', d_pf, d_pf_j),
      ('d_b', np.concatenate([g_lexical.sum((0, 1)), [g_blank.sum()]]),
       d_b_j[:vocab + 1])):
    assert of_largest(got, want) <= GRAD_RTOL, name
  assert within(d_w, d_w_j, 0.0, GRAD_RTOL * np.abs(d_w_j).max() +
                weight_flip_allowance(steps, g_blank, g_lexical,
                                      compute_dtype))
  # The padding columns of JAX's combined head get nothing.
  assert not np.any(d_w_j[:, vocab + 1:])


@pytest.mark.parametrize('dtype', sorted(DTYPES))
@pytest.mark.parametrize('case', ['s130_v127', 's37_v7'])
def test_blank_lexical_matches_jax(interpret_kernel, case, dtype):
  """The drop-in with its autograd Function, gradients into the parameters,
  the cache and the frame, against JAX's through its custom VJP."""
  num_states, vocab = CASES[case]
  cache, frame, params, g_blank, g_lexical = make_inputs(1, num_states,
                                                         vocab)
  jax_dtype, torch_dtype, _ = DTYPES[dtype]
  jax_wf = jax_weight_fns.JointWeightFn(vocab_size=vocab, hidden_size=HIDDEN,
                                        compute_dtype=jax_dtype)
  wf = weight_fns.JointWeightFn(vocab_size=vocab, hidden_size=HIDDEN,
                                compute_dtype=torch_dtype)

  def jax_total(p, c, f):
    blank, lexical = jax_joint_head.blank_lexical(jax_wf, p, c, f)
    return jnp.sum(blank * g_blank) + jnp.sum(lexical * g_lexical), (
        blank, lexical)

  (_, (blank_j, lexical_j)), grads_j = jax.value_and_grad(
      jax_total, argnums=(0, 1, 2), has_aux=True)(
          jax.tree.map(jnp.asarray, params), jnp.asarray(cache),
          jnp.asarray(frame))

  leaves = convert.from_jax_params(params, device='cpu')
  for leaf in pytree.tree_leaves(leaves):
    leaf.requires_grad_(True)
  cache_t = torch.from_numpy(cache).requires_grad_(True)
  frame_t = torch.from_numpy(frame).requires_grad_(True)
  blank, lexical = joint_head.blank_lexical(wf, leaves, cache_t, frame_t)
  ((blank * torch.from_numpy(g_blank)).sum() +
   (lexical * torch.from_numpy(g_lexical)).sum()).backward()
  compute_dtype = torch_dtype or torch.float32
  pc = wf._mm(torch.from_numpy(cache), leaves['context_proj']).detach()
  pf = wf._mm(torch.from_numpy(frame), leaves['frame_proj']).detach()
  steps = flip_steps(pc, pf, compute_dtype)
  assert within(blank.detach(), blank_j, VALUE_RTOL[dtype],
                flip_allowance(steps, params['blank_w'][:, None])[..., 0])
  assert within(lexical.detach(), lexical_j, VALUE_RTOL[dtype],
                flip_allowance(steps, params['vocab_w']))
  head_flips = weight_flip_allowance(steps, g_blank, g_lexical, compute_dtype)
  flips = {'vocab_w': head_flips[:, :-1], 'blank_w': head_flips[:, -1]}
  d_params_j, d_cache_j, d_frame_j = grads_j
  got = {**{n: leaves[n].grad for n in d_params_j}, 'cache': cache_t.grad,
         'frame': frame_t.grad}
  want = {**d_params_j, 'cache': d_cache_j, 'frame': d_frame_j}
  for name in want:
    a = np.asarray(got[name], np.float64)
    b = np.asarray(want[name], np.float64)
    # In bfloat16 the gradients that leave through _mm's rounding of its
    # inputs are rounded to bfloat16 themselves (autograd's cast and XLA's
    # convert alike): one bfloat16 step of each entry (at most 2**-7 of
    # it) on top.
    step = 2.0**-7 * np.abs(b) if torch_dtype is not None and name in (
        'context_proj', 'frame_proj', 'cache', 'frame') else 0.0
    assert np.all(np.abs(a - b) <= GRAD_RTOL * np.abs(b).max() + step +
                  flips.get(name, 0.0)), name


SMS = 132  # an H100's SMs


@pytest.mark.parametrize('batch,states,hidden,vocab', [
    (8, 1025, 512, 1024),  # the densified headline's frame
    (8, 4161, 512, 64),  # the trigram probe: one strip, half of it padding
    (8, 1100, 512, 1001),  # V not a multiple of 4
    (3, 77, 40, 37),
    (5, 3, 128, 64),
    (1, 3, 40, 1024),
])
def test_forward_plan_covers_every_tile_once(batch, states, hidden, vocab):
  """The bfloat16 forward's persistent grid: block i computes the output
  tiles i, i + blocks, ...; every tile once, the blocks' loads within one
  tile of each other, at most two blocks an SM."""
  plan = joint_head.forward_plan(batch, states, hidden, vocab, SMS)
  assert plan.hidden_pad % 64 == 0 and 0 <= plan.hidden_pad - hidden < 64
  assert plan.vocab_pad % 64 == 0 and 0 <= plan.vocab_pad - vocab < 64
  assert plan.tiles == (-(-batch * states // 128) *
                        -(-plan.vocab_pad // 128))
  assert 1 <= plan.blocks <= min(plan.tiles, 2 * SMS)
  walked = [list(range(i, plan.tiles, plan.blocks))
            for i in range(plan.blocks)]
  assert sorted(t for tiles in walked for t in tiles) == list(
      range(plan.tiles))
  loads = [len(tiles) for tiles in walked]
  assert min(loads) >= 1 and max(loads) - min(loads) <= 1
  if plan.tiles >= 2 * SMS:  # a frame of the main paths fills the card
    assert plan.blocks == 2 * SMS


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
@pytest.mark.parametrize('batch,states,hidden,vocab', [
    (8, 1025, 512, 1024),  # the densified headline's frame
    (8, 4161, 512, 64),  # the trigram probe
    (3, 77, 40, 37),  # h and V off the 64-deep stages, V % 4 != 0
    (1, 3, 40, 1001),
    (5, 3, 24, 129),  # one row tile over five batch rows, V past 128
])
def test_backward_workspace_is_aligned_and_disjoint(batch, states, hidden,
                                                    vocab, dtype):
  """The backward's scratch in one buffer: each buffer 256-byte aligned,
  none overlapping; bfloat16 stages the cotangent in bfloat16 padded to the
  64-deep stages and splits its products as the other wgmma backwards;
  float32 pads the joint and the head to 64, keeps a d_pf partial for each
  batch row a 64-row tile touches, and splits the d_vocab_w contraction
  into parts that cover every 16-row slice of the B S rows once."""
  plan = joint_head.backward_plan(batch, states, hidden, vocab, dtype, SMS)
  scratch = joint_head.backward_scratch(batch, states, hidden, vocab, dtype,
                                        plan.splits, plan.dsplits)
  assert set(plan.offsets) == set(scratch)
  spans = []
  for name, (shape, item_dtype) in scratch.items():
    assert plan.offsets[name] % 256 == 0, name
    itemsize = torch.empty((), dtype=item_dtype).element_size()
    spans.append((plan.offsets[name],
                  plan.offsets[name] + np.prod(shape) * itemsize))
  spans.sort()
  assert all(end <= start for (_, end), (start, _) in zip(spans, spans[1:]))
  assert spans[-1][1] <= plan.size
  if dtype == torch.float32:
    assert plan.dsplits == 0 and 'd_lex' not in scratch
    assert plan.labels_major == (vocab <= 128)
    assert scratch['dw_part'][0] == ((plan.splits, vocab, hidden)
                                     if plan.labels_major else
                                     (plan.splits, hidden, vocab))
    rows = batch * states
    pad = lambda n: -(-n // 64) * 64
    assert scratch['joint32'][0] == (pad(rows), pad(hidden))
    assert scratch['head'][0] == (pad(vocab), pad(hidden))  # transposed
    assert scratch['du'][0] == (rows, pad(hidden))
    tiles = pad(rows) // 64
    assert scratch['dbw_part'][0] == (tiles, hidden)
    slots = scratch['dpf_part'][0][1]
    assert scratch['dpf_part'][0] == (tiles, slots, hidden)
    for t in range(tiles):  # every batch row a tile touches has a slot
      first, last = t * 64 // states, (min(t * 64 + 64, rows) - 1) // states
      assert last - first + 1 <= slots <= batch
    slices = -(-rows // 16)
    ranges = joint_head.f32_split_slices(batch, states, plan.splits)
    assert ranges[0][0] == 0 and ranges[-1][1] == slices
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert all(end - begin >= min(32, slices) for begin, end in ranges)
    out_tiles = (-(-vocab // 64) * -(-pad(hidden) // 256)
                 if plan.labels_major else
                 pad(hidden) // 64 * -(-pad(vocab) // 256))
    assert 1 <= plan.splits and plan.splits * out_tiles <= max(
        out_tiles, 2 * SMS)
  else:
    assert scratch['dw_part'][0] == (plan.splits, hidden, vocab)
    grid = fused_scan.wgmma_grid(batch, states, hidden, vocab, SMS)
    assert (plan.splits, plan.dsplits) == (grid.ksplits, grid.dsplits)
    assert 1 <= plan.dsplits <= batch
    vp = -(-vocab // 64) * 64
    assert scratch['d_lex'] == ((batch * states, vp), torch.bfloat16)
    assert scratch['joint32'] == ((batch * states, hidden), torch.float32)
    assert scratch['dpc_part'][0] == (plan.dsplits, states, hidden)


@pytest.mark.parametrize('batch,states,hidden,vocab,labels_major', [
    (8, 1025, 512, 1024, False),  # the MWER step's beta pass
    (8, 4161, 512, 64, True),  # the trigram probe: labels-major
    (3, 77, 40, 37, True),  # ragged: h, V and B S off the tiles
    (4, 1025, 200, 128, True),  # at the shape selection's threshold
    (4, 1025, 200, 129, False),  # just past it
    (8, 1100, 512, 1001, False),  # V not a multiple of 4
])
def test_f32_forward_plan_pads_and_tiles_every_output(batch, states, hidden,
                                                      vocab, labels_major):
  """The float32 forward: the joint scratch [B S, h] and the head [h, V]
  padded to 64 (zeros there: the products read no masks), 256-byte aligned
  and disjoint in one workspace; the product's grid covers every output
  entry once, rows-major (64 rows by 256 labels) or, where a 256-label
  tile would be at least half padding, labels-major (64 labels by 256
  rows)."""
  plan = joint_head.f32_forward_plan(batch, states, hidden, vocab)
  rows = batch * states
  assert plan.labels_major == labels_major
  assert joint_head.f32_labels_major(vocab) == labels_major
  for padded, n in ((plan.rows_pad, rows), (plan.hidden_pad, hidden),
                    (plan.vocab_pad, vocab)):
    assert padded % 64 == 0 and 0 <= padded - n < 64
  # Rows-major also keeps the joint transposed: its product contracts over
  # h and reads both operands along their rows.
  sizes = {'joint': plan.rows_pad * plan.hidden_pad,
           'head': plan.hidden_pad * plan.vocab_pad}
  if not labels_major:
    sizes['joint_t'] = plan.hidden_pad * plan.rows_pad
  assert set(plan.offsets) == set(sizes)
  spans = sorted((plan.offsets[n], plan.offsets[n] + 4 * size)
                 for n, size in sizes.items())
  assert all(start % 256 == 0 for start, _ in spans)
  assert all(end <= start for (_, end), (start, _) in zip(spans, spans[1:]))
  assert spans[-1][1] <= plan.size
  x, y = plan.grid
  if labels_major:  # x: 64-label tiles, y: 256-row strips
    assert x * 64 >= vocab > (x - 1) * 64 and y * 256 >= rows > (y - 1) * 256
  else:  # x: 64-row tiles, y: 256-label strips
    assert x * 64 >= rows > (x - 1) * 64
    assert y * 256 >= vocab > (y - 1) * 256
  # A 256-wide side covers its outputs at least half full.
  wide = rows if labels_major else vocab
  assert not labels_major or vocab <= 128
  assert labels_major or wide > 128


def gate_inputs(num_states, batch=4, hidden=HIDDEN, frame_dims=1,
                dtype=torch.float32):
  cache = torch.zeros((num_states, EMBEDDING), dtype=dtype)
  frame = torch.zeros((batch,) * frame_dims + (hidden,), dtype=dtype)
  return cache, frame


def test_gate_keeps_the_structural_conditions():
  wf = weight_fns.JointWeightFn(vocab_size=8, hidden_size=HIDDEN)
  cache, frame = gate_inputs(joint_head.MIN_STATES)
  assert joint_head.MIN_STATES == jax_joint_head._MIN_STATES == 1024
  assert joint_head.supported(wf, cache, frame, None)
  # Below the state count, the einsum route.
  assert not joint_head.supported(wf, cache[:-1], frame, None)
  # Per-state calls and more than one batch dimension.
  assert not joint_head.supported(wf, cache, frame, torch.zeros(4, dtype=int))
  assert not joint_head.supported(wf, *gate_inputs(2048, frame_dims=2), None)
  # Compute types other than None, float32, bfloat16; inputs not float32.
  for dtype in (torch.float32, torch.bfloat16):
    assert joint_head.supported(
        weight_fns.JointWeightFn(8, HIDDEN, compute_dtype=dtype), cache,
        frame, None)
  assert not joint_head.supported(
      weight_fns.JointWeightFn(8, HIDDEN, compute_dtype=torch.float16), cache,
      frame, None)
  assert not joint_head.supported(
      wf, *gate_inputs(2048, dtype=torch.float64), None)


def test_gate_agrees_with_jax_on_its_structural_half():
  """JAX's gate (with its kernel forced on) and the port's agree where the
  TPU's VMEM limits do not bite; past them the port keeps the kernels."""
  jax_wf = jax_weight_fns.JointWeightFn(vocab_size=8, hidden_size=HIDDEN)
  wf = weight_fns.JointWeightFn(vocab_size=8, hidden_size=HIDDEN)
  try:
    jax_joint_head.FORCE_INTERPRET = True
    for num_states in (1023, 1024, 1057):
      cache, frame = gate_inputs(num_states)
      assert joint_head.supported(wf, cache, frame, None) == (
          jax_joint_head.supported(jax_wf, jnp.asarray(cache.numpy()),
                                   jnp.asarray(frame.numpy()), None))
    # B > 64, hidden not a multiple of 128, hidden > 1024, V + 1 > 2048.
    for batch, hidden, vocab in ((65, 128, 8), (4, 96, 8), (4, 1152, 8),
                                 (4, 128, 2048)):
      jax_wide = jax_weight_fns.JointWeightFn(vocab_size=vocab,
                                              hidden_size=hidden)
      wide = weight_fns.JointWeightFn(vocab_size=vocab, hidden_size=hidden)
      cache, frame = gate_inputs(1024, batch=batch, hidden=hidden)
      assert not jax_joint_head.supported(
          jax_wide, jnp.asarray(cache.numpy()), jnp.asarray(frame.numpy()),
          None)
      assert joint_head.supported(wide, cache, frame, None)
  finally:
    jax_joint_head.FORCE_INTERPRET = False


def test_apply_routes_through_the_gate():
  """Inside the gate a CPU call runs the plain versions through
  blank_lexical (counted here through ``using``); outside it the einsums.
  Both give the same values."""
  calls = []

  def forward(*args, **kwargs):
    calls.append('forward')
    return joint_head.joint_head_forward_plain(*args, **kwargs)

  def backward(*args, **kwargs):
    calls.append('backward')
    return joint_head.joint_head_backward_plain(*args, **kwargs)

  wf = weight_fns.JointWeightFn(vocab_size=6, hidden_size=8)
  rng = np.random.default_rng(2)
  cache = torch.from_numpy(rng.standard_normal((1030, 5)).astype(np.float32))
  frame = torch.from_numpy(rng.standard_normal((2, 4)).astype(np.float32))
  params = wf.init(torch.Generator().manual_seed(0), cache, frame)
  for leaf in params.values():
    leaf.requires_grad_(True)
  with joint_head.using(forward, backward):
    blank, lexical = wf.apply(params, cache, frame)
    (blank.sum() + lexical.sum()).backward()
    grads = {n: x.grad.clone() for n, x in params.items()}
    assert calls == ['forward', 'backward']
    for x in params.values():
      x.grad = None
    blank_s, lexical_s = wf.apply(params, cache[:1023], frame)
    (blank_s.sum() + lexical_s.sum()).backward()
    assert calls == ['forward', 'backward']  # the einsum route
  npt.assert_allclose(blank_s.detach().numpy(), blank[:, :1023].detach(),
                      rtol=1e-5, atol=1e-6)
  npt.assert_allclose(lexical_s.detach().numpy(),
                      lexical[:, :1023].detach(), rtol=1e-5, atol=1e-6)
  assert joint_head.forward_launches == joint_head.backward_launches == 0
