"""The log-partition kernels' plain versions against the JAX kernel pair.

The port's ``fused_forward_plain`` / ``fused_backward_plain`` (what the CUDA
kernels compute, in plain PyTorch) are held to the JAX package's Pallas
kernels run in interpret mode in float32 (``fused_shortest_distance_fwd``
and ``run_fused_backward``), on the same numpy inputs: log Z, the alpha
history, the expansion slabs, dpf, dpc, the head gradients and beta_out.
To read dpf and dpc off the JAX wrapper, frames enter through an identity
``frame_proj`` and the context embedding is the identity, so d(frames) is
dpf and d(context_proj) is dpc. Tolerances as ``test_fused_scan.py``:
rtol 1e-5 / atol 1e-6 on values, rtol 1e-4 / atol 1e-6 on gradients
(float32 in both, sums in another order). The CUDA kernels are held to the
plain versions on the card in ``test_torch_kernels.py``.
"""

import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

from last_torch_tpu.ops import fused_scan as jax_fused_scan
from last_torch_tpu_torch.ops import fused_scan, joint_head

torch.set_num_threads(1)
torch.set_float32_matmul_precision('highest')

VOCAB, HIDDEN = 5, 8  # V = 5: ragged against every tile
STATES = VOCAB + 1
NUM_FRAMES = np.array([7, 4, 0], np.int32)  # full, padded, empty
MAX_T = 7
CASES = {'fd': (0, True), 'fld1': (1, False), 'fld2': (2, False)}


def make_inputs(seed):
  rng = np.random.default_rng(seed)
  normal = lambda *shape: rng.standard_normal(shape).astype(np.float32)
  wf_params = {
      'frame_proj': np.eye(HIDDEN, dtype=np.float32),
      'context_proj': normal(STATES, HIDDEN) * 0.7,
      'vocab_w': normal(HIDDEN, VOCAB) * 0.5,
      'vocab_b': normal(VOCAB) * 0.1,
      'blank_w': normal(HIDDEN) * 0.5,
      'blank_b': np.float32(0.2),
  }
  cache = np.eye(STATES, dtype=np.float32)
  frames = normal(len(NUM_FRAMES), MAX_T, HIDDEN)
  g = np.array([1.0, 0.7, 1.3], np.float32)
  return wf_params, cache, frames, g


def port_inputs(wf_params, frames):
  pf = torch.from_numpy(frames).transpose(0, 1).contiguous()  # [T, B, h]
  pc = torch.from_numpy(wf_params['context_proj'])  # cache is the identity
  head = {k: torch.tensor(wf_params[k])
          for k in ('vocab_w', 'vocab_b', 'blank_w', 'blank_b')}
  is_pad = torch.arange(MAX_T)[:, None] >= torch.from_numpy(NUM_FRAMES)[None]
  return pf, pc, head, is_pad


@pytest.mark.parametrize('case', sorted(CASES))
def test_plain_kernel_pair_matches_jax_interpret(case):
  k, fd = CASES[case]
  wf_params, cache, frames, g = make_inputs(seed=len(case))
  kw = dict(max_expansions=k, frame_dependent=fd)
  streamed = not fd and k >= 1
  jax_wf = {n: jnp.asarray(x) for n, x in wf_params.items()}
  outs = jax_fused_scan.fused_shortest_distance_fwd(
      jax_wf, jnp.asarray(cache), jnp.asarray(frames), NUM_FRAMES,
      num_context_states=STATES, compute_dtype=jnp.float32, interpret=True,
      return_final_alpha=True, with_expansions=streamed, **kw)
  log_z_j, hist_j, alpha_j = (np.asarray(x) for x in outs[:3])
  d_wf_j, _, d_frames_j, beta_j = jax_fused_scan.run_fused_backward(
      jax_wf, jnp.asarray(cache), jnp.asarray(frames), NUM_FRAMES,
      outs[0], jnp.asarray(g), outs[1], num_context_states=STATES,
      compute_dtype=jnp.float32, interpret=True,
      expansion_history=outs[3] if streamed else None, **kw)

  pf, pc, head, is_pad = port_inputs(wf_params, frames)
  before = fused_scan.forward_launches, fused_scan.backward_launches
  log_z, alpha, hist, slabs = fused_scan.fused_forward(
      pf, pc, head, is_pad, compute_dtype=torch.float32, with_residuals=True,
      **kw)
  dpf, dpc, dvw, dvb, dbw, dbb, beta = fused_scan.fused_backward(
      pf, pc, head, is_pad, log_z, torch.from_numpy(g), hist, slabs,
      compute_dtype=torch.float32, **kw)
  # CPU tensors run the plain versions and never launch a kernel.
  assert (fused_scan.forward_launches,
          fused_scan.backward_launches) == before

  values = dict(rtol=1e-5, atol=1e-6)
  npt.assert_allclose(log_z.numpy(), log_z_j, **values)
  npt.assert_allclose(alpha.numpy(), alpha_j, **values)
  npt.assert_allclose(hist.numpy(), hist_j.transpose(1, 0, 2), **values)
  if streamed:
    real = ~is_pad.numpy()  # the slabs are defined on real frames
    for j in range(k):
      want = np.asarray(outs[3][j])[:, :len(NUM_FRAMES), :STATES]
      npt.assert_allclose(slabs[j].numpy()[real], want[real], **values)
  else:
    assert slabs is None
  grads = dict(rtol=1e-4, atol=1e-6)
  npt.assert_allclose(dpf.numpy(), np.asarray(d_frames_j).transpose(1, 0, 2),
                      **grads)
  npt.assert_allclose(dpc.numpy(), np.asarray(d_wf_j['context_proj']),
                      **grads)
  for name, got in (('vocab_w', dvw), ('vocab_b', dvb), ('blank_w', dbw),
                    ('blank_b', dbb)):
    npt.assert_allclose(got.numpy(), np.asarray(d_wf_j[name]), **grads,
                        err_msg=name)
  npt.assert_allclose(beta.numpy(), np.asarray(beta_j), **values)


def test_primal_only_forward_writes_no_residuals():
  wf_params, _, frames, _ = make_inputs(seed=0)
  pf, pc, head, is_pad = port_inputs(wf_params, frames)
  kw = dict(max_expansions=2, frame_dependent=False,
            compute_dtype=torch.float32)
  log_z, alpha, hist, slabs = fused_scan.fused_forward(
      pf, pc, head, is_pad, with_residuals=False, **kw)
  assert hist is None and slabs is None
  with_res = fused_scan.fused_forward(pf, pc, head, is_pad,
                                      with_residuals=True, **kw)
  npt.assert_array_equal(log_z.numpy(), with_res[0].numpy())
  npt.assert_array_equal(alpha.numpy(), with_res[1].numpy())


def test_wrappers_reject_bad_inputs():
  wf_params, _, frames, g = make_inputs(seed=1)
  pf, pc, head, is_pad = port_inputs(wf_params, frames)
  kw = dict(max_expansions=2, frame_dependent=False,
            compute_dtype=torch.float32)
  with pytest.raises(ValueError, match='pf should be'):
    fused_scan.fused_forward(pf.double(), pc, head, is_pad,
                             with_residuals=False, **kw)
  with pytest.raises(ValueError, match='bigram'):
    fused_scan.fused_forward(pf, pc[:-1].contiguous(), head, is_pad,
                             with_residuals=False, **kw)
  log_z, _, hist, slabs = fused_scan.fused_forward(
      pf, pc, head, is_pad, with_residuals=True, **kw)
  with pytest.raises(ValueError, match='slabs should be'):
    fused_scan.fused_backward(pf, pc, head, is_pad, log_z,
                              torch.from_numpy(g), hist, None, **kw)
  with pytest.raises(ValueError, match='hist should be'):
    fused_scan.fused_marginals(pf, pc, head, is_pad, log_z, hist[1:], slabs,
                               **kw)
  with pytest.raises(ValueError, match='bigram'):
    fused_scan.fused_marginals(pf, pc[:-1].contiguous(), head, is_pad, log_z,
                               hist, slabs, **kw)
  meta = lambda x: x.to('meta')
  meta_head = {n: meta(x) for n, x in head.items()}
  with pytest.raises(ValueError, match='no log-partition kernel'):
    fused_scan.fused_forward(meta(pf), meta(pc), meta_head, meta(is_pad),
                             with_residuals=False, **kw)
  with pytest.raises(ValueError, match='no marginals kernel'):
    fused_scan.fused_marginals(meta(pf), meta(pc), meta_head, meta(is_pad),
                               meta(log_z), meta(hist), meta(slabs), **kw)


SMS = 132  # an H100's SMs


@pytest.mark.parametrize('batch,states,hidden,vocab', [
    (8, 1025, 512, 1024),  # the main path's frame
    (32, 1025, 512, 1024),  # bench.py's headline batch
    (8, 4097, 512, 4096),  # bench.py's config 9
    (3, 521, 40, 520),  # V and h off the 64-deep stages
    (1, 38, 24, 37),
])
def test_wgmma_grid_pads_and_splits_within_a_wave(batch, states, hidden,
                                                   vocab):
  grid = fused_scan.wgmma_grid(batch, states, hidden, vocab, SMS)
  assert grid.hidden_pad % 64 == 0 and 0 <= grid.hidden_pad - hidden < 64
  assert grid.vocab_pad % 64 == 0 and 0 <= grid.vocab_pad - vocab < 64
  assert grid.strips == -(-grid.vocab_pad // 128)
  assert 1 <= grid.dsplits <= batch
  assert 1 <= grid.ksplits <= batch * -(-states // 64)
  # Split products stay within one wave of two blocks an SM.
  for name, splits in (('head_grad', grid.ksplits),
                       ('joint_grad', grid.dsplits)):
    assert splits == 1 or grid.blocks[name] <= 2 * SMS, name
  if batch >= 8:  # a full frame of the main paths fills the card
    for name, blocks in grid.blocks.items():
      assert blocks >= SMS, name


@pytest.mark.parametrize('batch,states,hidden,vocab', [
    (8, 1025, 512, 1000),  # V off the 64-deep stages
    (32, 1025, 512, 1024),  # bench.py's headline batch
    (2, 9, 16, 8),
])
def test_backward_scratch_keeps_d_lex_in_bfloat16(batch, states, hidden,
                                                  vocab):
  grid = fused_scan.wgmma_grid(batch, states, hidden, vocab, SMS)
  scratch = fused_scan.backward_scratch(batch, states, hidden, vocab, grid)
  hp, vp = grid.hidden_pad, grid.vocab_pad
  assert scratch['d_lex'] == ((batch, states, vp), torch.bfloat16)
  assert scratch['joint'] == ((batch, states, hp), torch.bfloat16)
  assert scratch['vocab_w'] == ((hp, vp), torch.bfloat16)
  assert scratch['part_m'][0] == scratch['part_l'][0] == (
      grid.strips, batch, states)
  # d_pc carried over [splits, S, h], not [B, S, h].
  assert scratch['dpc_acc'][0] == (grid.dsplits, states, hidden)
  if batch >= 8:
    assert grid.dsplits < batch
  # lex is recomputed: no float32 [B, S, V] buffer.
  assert 'lex' not in scratch
  for name, (shape, dtype) in scratch.items():
    if shape[:2] == (batch, states):
      assert dtype == torch.bfloat16 or shape[2] == hidden, name


@pytest.mark.parametrize('batch,states,hidden,vocab', [
    (8, 4097, 512, 4096),  # bench.py's config 9
    (8, 16385, 512, 16384),  # 'auto' plans the online mode here
    (32, 8193, 512, 8192),  # and here
    (3, 1101, 40, 1100),  # a ragged last chunk, h off the stages
])
def test_online_wgmma_grid_runs_products_per_chunk(batch, states, hidden,
                                                   vocab):
  assert fused_scan.plan(batch, states, vocab, torch.bfloat16) == (
      'online' if states > 8000 else 'cache')
  grid = fused_scan.wgmma_grid(batch, states, hidden, vocab, SMS, 'online')
  cache = fused_scan.wgmma_grid(batch, states, hidden, vocab, SMS)
  chunk = fused_scan.ONLINE_CHUNK_STATES
  assert chunk % 64 == 0 and grid.chunk == chunk < states
  assert cache.chunk == states
  # The row reductions over all S states plan as in 'cache'; the gradient
  # products run per chunk, split to fill one wave.
  assert (grid.hidden_pad, grid.vocab_pad, grid.strips) == (
      cache.hidden_pad, cache.vocab_pad, cache.strips)
  assert grid.blocks['lexical'] == cache.blocks['lexical']
  assert 1 <= grid.dsplits <= batch
  assert 1 <= grid.ksplits <= batch * chunk // 64
  for name, splits in (('head_grad', grid.ksplits),
                       ('joint_grad', grid.dsplits)):
    assert splits == 1 or grid.blocks[name] <= 2 * SMS, name
    if batch >= 8:
      assert grid.blocks[name] >= SMS, name


@pytest.mark.parametrize('batch,states,hidden,vocab', [
    (8, 4097, 512, 4096),
    (8, 16385, 512, 16384),
    (32, 8193, 512, 8192),
    (3, 1101, 40, 1100),
])
def test_online_backward_scratch_holds_no_batch_state_vocab_buffer(
    batch, states, hidden, vocab):
  """The bfloat16 online backward allocates no buffer of B S V elements:
  d_lex holds one chunk of states, and the rest grows as B S h or S V."""
  grid = fused_scan.wgmma_grid(batch, states, hidden, vocab, SMS, 'online')
  scratch = fused_scan.backward_scratch(batch, states, hidden, vocab, grid)
  assert scratch['d_lex'] == ((batch, fused_scan.ONLINE_CHUNK_STATES,
                               grid.vocab_pad), torch.bfloat16)
  assert 'lex' not in scratch
  for name, (shape, _) in scratch.items():
    assert np.prod(shape) < batch * states * vocab, name
  # Doubling the vocabulary (S = V + 1) leaves d_lex's state count alone.
  wide = fused_scan.backward_scratch(
      batch, 2 * states - 1, hidden, 2 * vocab,
      fused_scan.wgmma_grid(batch, 2 * states - 1, hidden, 2 * vocab, SMS,
                            'online'))
  assert wide['d_lex'][0][:2] == scratch['d_lex'][0][:2]


@pytest.mark.parametrize('batch,states,hidden,vocab', [
    (8, 1025, 512, 1024),  # the main path's frame
    (32, 1025, 512, 1024),  # bench.py's headline batch
    (8, 4097, 512, 4096),  # bench.py's config 9
    (8, 1025, 80, 520),  # h and V off the 64-deep stages
    (3, 77, 512, 1021),  # a ragged unit, V not a multiple of 4
    (1, 77, 80, 256),
])
def test_reduce_plan_walks_every_unit_once(batch, states, hidden, vocab):
  """The column-reduce product's persistent grid (csrc/head_product.cuh):
  the tiles' unit pairs, walked as the kernel walks them, cover every
  (row, 64-state unit, 128-label strip) once; the first unit of a pair is
  always a real one; at most two blocks an SM."""
  plan = joint_head.reduce_plan(batch, states, hidden, vocab, SMS)
  assert plan.hidden_pad % 64 == 0 and 0 <= plan.hidden_pad - hidden < 64
  assert plan.vocab_pad % 64 == 0 and 0 <= plan.vocab_pad - vocab < 64
  t64 = -(-states // 64)
  assert plan.state_tiles == t64
  assert plan.units == batch * t64
  strips = -(-plan.vocab_pad // 128)
  assert plan.tiles == -(-plan.units // 2) * strips
  walked = []
  for t in range(plan.tiles):
    pair, strip = divmod(t, strips)
    for u in (2 * pair, 2 * pair + 1):
      row, unit = divmod(u, t64)
      real = u < plan.units
      assert real or u == 2 * pair + 1, t
      if real:
        walked.append((row, unit, strip))
  assert sorted(walked) == [(b, u, n) for b in range(batch)
                            for u in range(t64) for n in range(strips)]
  assert plan.max_blocks == 2 * SMS
  assert 1 <= plan.blocks <= min(plan.tiles, plan.max_blocks)
  if plan.tiles >= 2 * SMS:
    assert plan.blocks == 2 * SMS
  # Each row is padded to 64 states, not to a pair of units.
  assert plan.units * 64 - batch * states < batch * 64


@pytest.mark.parametrize('batch,states,hidden,vocab', [
    (8, 1025, 512, 1024),
    (32, 1025, 512, 1024),
    (8, 4097, 512, 4096),
    (3, 77, 80, 1021),
])
def test_forward_scratch_stages_lex_by_the_rule(batch, states, hidden,
                                                vocab):
  """The bfloat16 'cache' forward's scratch: the padded bfloat16 joint and
  head and a (max, sum) partial per 64-state unit; the float32 lex [B, S,
  V] exactly where a frame has two or more reductions; and plan() counts
  what that mode stages, lex and the backward's bfloat16 d_lex."""
  plan = joint_head.reduce_plan(batch, states, hidden, vocab, SMS)
  hp, vp = plan.hidden_pad, plan.vocab_pad
  for reductions in (0, 1, 2, 3):
    scratch = fused_scan.forward_scratch(batch, states, hidden, vocab, plan,
                                         reductions)
    assert scratch['joint'] == ((batch, states, hp), torch.bfloat16)
    assert scratch['vocab_w'] == ((hp, vp), torch.bfloat16)
    assert scratch['part_m'] == scratch['part_l'] == (
        (-(-states // 64), batch, vocab), torch.float32)
    big = [n for n, (shape, dtype) in scratch.items()
           if dtype == torch.float32 and np.prod(shape) >=
           batch * states * vocab]
    assert big == (['lex'] if reductions >= 2 else []), big
    if reductions >= 2:
      assert scratch['lex'] == ((batch, states, vocab), torch.float32)
  staged = batch * states * vocab * (4 + 2)
  assert fused_scan.plan(batch, states, vocab, torch.bfloat16) == (
      'cache' if staged <= fused_scan.LEX_STAGE_BUDGET else 'online')


@pytest.mark.parametrize('batch,states,hidden,vocab', [
    (8, 4097, 512, 4096),  # bench.py's config 9
    (8, 16385, 512, 16384),  # 'auto' plans the online mode here
    (8, 1025, 512, 1024),
    (3, 77, 80, 1021),
])
def test_online_forward_scratch_holds_no_batch_state_vocab_buffer(
    batch, states, hidden, vocab):
  """The bfloat16 'online' forward runs the column-reduce product for every
  reduction: the 'cache' forward's buffers without the staged lex, none of
  B S V elements, whatever the reductions a frame; and plan() still picks
  the mode by what 'cache' stages."""
  plan = joint_head.reduce_plan(batch, states, hidden, vocab, SMS)
  for reductions in (1, 2, 3):
    online = fused_scan.forward_scratch(batch, states, hidden, vocab, plan,
                                        reductions, 'online')
    cache = fused_scan.forward_scratch(batch, states, hidden, vocab, plan,
                                       reductions)
    assert 'lex' not in online
    assert online == {n: v for n, v in cache.items() if n != 'lex'}
    for name, (shape, _) in online.items():
      assert np.prod(shape) < batch * states * vocab, name
  with pytest.raises(ValueError, match='mode'):
    fused_scan.forward_scratch(batch, states, hidden, vocab, plan, 2, 'auto')
  staged = batch * states * vocab * (4 + 2)
  assert fused_scan.plan(batch, states, vocab, torch.bfloat16) == (
      'cache' if staged <= fused_scan.LEX_STAGE_BUDGET else 'online')


@pytest.mark.parametrize('reductions', [0, 1, 2, 3])
@pytest.mark.parametrize('batch,states,hidden,vocab', [
    (8, 1025, 512, 1024),  # the confidence main path's frame
    (32, 1025, 512, 1024),  # bench.py's config 8
    (8, 4097, 512, 4096),
    (3, 521, 40, 520),  # V and h off the 64-deep stages
])
def test_marginals_scratch_stages_lex_only_in_float32(batch, states, hidden,
                                                      vocab, reductions):
  """The bfloat16 marginals scan with a row reduction a frame runs the
  backward's wgmma reductions, lex recomputed by each: no float32 [B, S, V]
  buffer, the padded bfloat16 joint and head and a partial per 128-label
  strip, as the backward plans them. The float32 route (and FLD(0)) keeps
  its staged lex."""
  grid = fused_scan.wgmma_grid(batch, states, hidden, vocab, SMS)
  bsv = batch * states * vocab
  bf16 = fused_scan.marginals_scratch(batch, states, hidden, vocab,
                                      torch.bfloat16, reductions)
  f32 = fused_scan.marginals_scratch(batch, states, hidden, vocab,
                                     torch.float32, reductions, ysplits=5)
  assert f32['lex'] == ((batch, states, vocab), torch.float32)
  assert f32['part_m'] == f32['part_l'] == ((5, batch, states),
                                            torch.float32)
  assert f32['joint'] == ((batch, states, hidden), torch.float32)
  shared = ('blank', 'nb', 'beta', 'lp_part')
  assert {n: bf16[n] for n in shared} == {n: f32[n] for n in shared}
  assert bf16['lp_part'] == ((batch, -(-states // 64), vocab), torch.float32)
  assert bf16['nb'][0] == (max(reductions, 1), batch, states)
  if reductions == 0:  # FLD(0): no reduction, tile_product.cuh's route
    assert bf16['lex'] == ((batch, states, vocab), torch.float32)
    return
  assert 'lex' not in bf16
  backward = fused_scan.backward_scratch(batch, states, hidden, vocab, grid)
  for name in ('vocab_w', 'joint', 'part_m', 'part_l'):
    assert bf16[name] == backward[name], name
  for name, (shape, _) in bf16.items():
    assert np.prod(shape) < bsv, name


@pytest.mark.parametrize('lengths', [[5, 2, 0, 5], [0, 0], [3], [1, 4, 4]])
def test_live_rows_lists_each_frames_real_rows_first(lengths):
  """What the wgmma routes walk: per frame the count of real rows, on the
  host, and the batch indices, real rows first in batch order, then the
  padding rows."""
  max_t = 6
  is_pad = (torch.arange(max_t)[:, None] >=
            torch.tensor(lengths)[None, :])
  live, rows = fused_scan.live_rows(is_pad)
  assert live.device.type == 'cpu' and live.dtype == torch.int32
  assert rows.dtype == torch.int32 and rows.shape == (max_t, len(lengths))
  for t in range(max_t):
    real = [b for b, n in enumerate(lengths) if t < n]
    padding = [b for b, n in enumerate(lengths) if t >= n]
    assert int(live[t]) == len(real)
    assert rows[t].tolist() == real + padding
