"""The port's CUDA kernels and their plain versions, without JAX.

Viterbi: the plain version's tie-breaking is pinned on the CPU (lowest
state wins an argmax tie; FrameLabelDependent keeps the fewest expansions
on a tie). Log-partition: the plain versions' padding behaviour is pinned
on the CPU. Numerator: the plain backward is held to autograd through the
plain forward on the CPU. Trigram log-partition: the plain versions'
padding behaviour is pinned, and ``log_partition`` through them is held to
the lattice's generic forward-backward, on the CPU. Joint+head and frame
reduce: the plain backward is held to autograd through the plain forward
on the CPU. The posterior sampler's beta pass (the joint+head kernels) is
held on the card to its run through the plain versions on the paths it
drew. On the
card each kernel is held to its plain version: the tests marked ``cuda``
skip without a GPU. This file imports
no JAX, so it also runs on a machine that has only PyTorch:

    python -m pytest tests/test_torch_kernels.py -q -m cuda --noconftest

(``--noconftest`` skips ``tests/conftest.py``, which imports JAX.)
"""

import numpy as np
import numpy.testing as npt
import pytest
import torch

from last_torch_tpu_torch import (alignments, contexts, lattices, risk,
                                  weight_fns)
from last_torch_tpu_torch.ops import (fused_scan, joint_head, numerator_scan,
                                      sharded_scan, trigram_scan, viterbi)

torch.set_num_threads(1)
torch.set_float32_matmul_precision('highest')


def random_inputs(seed, vocab, hidden, max_t, lengths, device='cpu',
                  states=None):
  """Kernel inputs over ``states`` context states (the bigram's V + 1 by
  default)."""
  rng = np.random.default_rng(seed)
  tensor = lambda shape, scale=1.0: torch.from_numpy(
      (rng.standard_normal(shape) * scale).astype(np.float32)).to(device)
  params = {
      'vocab_w': tensor((hidden, vocab), hidden**-0.5),
      'vocab_b': tensor((vocab,), 0.1),
      'blank_w': tensor((hidden,), hidden**-0.5),
      'blank_b': torch.tensor(0.3, device=device),
  }
  pf = tensor((max_t, len(lengths), hidden))
  pc = tensor((vocab + 1 if states is None else states, hidden))
  is_pad = (torch.arange(max_t)[:, None] >=
            torch.tensor(lengths)[None, :]).to(device)
  return pf, pc, params, is_pad


def tied_inputs(vocab, hidden, max_t, batch, device='cpu'):
  """Every state scores alike: all lexical weights 0, blank -1."""
  params = {
      'vocab_w': torch.zeros((hidden, vocab), device=device),
      'vocab_b': torch.zeros((vocab,), device=device),
      'blank_w': torch.zeros((hidden,), device=device),
      'blank_b': torch.tensor(-1.0, device=device),
  }
  pf = torch.ones((max_t, batch, hidden), device=device)
  pc = torch.ones((vocab + 1, hidden), device=device)
  is_pad = torch.zeros((max_t, batch), dtype=torch.bool, device=device)
  return pf, pc, params, is_pad


def test_plain_argmax_ties_pick_the_lowest_state():
  pf, pc, params, is_pad = tied_inputs(vocab=6, hidden=4, max_t=3, batch=2)
  arg, jstar, alpha = viterbi.viterbi_forward_plain(
      pf, pc, params, is_pad, max_expansions=0, frame_dependent=True,
      compute_dtype=torch.float32)
  # Frame 0: only the start state is reachable.
  assert torch.all(arg[0] == 0)
  # From frame 1 on, states 1..V tie at the top: the lowest, 1, wins.
  assert torch.all(arg[1:] == 1)
  assert torch.all(jstar[0, :, 1:] == 1) and torch.all(jstar[0, :, 0] == 0)
  npt.assert_array_equal(alpha[:, 1:].numpy(), 0.0)


def test_plain_fld_ties_keep_the_fewest_expansions():
  pf, pc, params, is_pad = tied_inputs(vocab=5, hidden=4, max_t=2, batch=1)
  params['blank_b'] = torch.tensor(0.0)
  _, jstar, _ = viterbi.viterbi_forward_plain(
      pf, pc, params, is_pad, max_expansions=2, frame_dependent=False,
      compute_dtype=torch.float32)
  # One and two expansions reach states 1..V with the same score 0: the
  # strict '>' keeps j = 1.
  assert torch.all(jstar[0, 0, 1:] == 1)
  assert jstar[0, 0, 0] == 0


def test_padding_frames_hold_alpha_and_write_zero_tables():
  pf, pc, params, is_pad = random_inputs(0, vocab=7, hidden=5, max_t=6,
                                         lengths=[6, 2, 0])
  kwargs = dict(max_expansions=2, frame_dependent=False,
                compute_dtype=torch.float32)
  arg, jstar, alpha = viterbi.viterbi_forward_plain(pf, pc, params, is_pad,
                                                    **kwargs)
  _, _, alpha_2 = viterbi.viterbi_forward_plain(
      pf[:2].contiguous(), pc, params, is_pad[:2].contiguous(), **kwargs)
  assert torch.all(jstar[2:, 1] == 0) and torch.all(jstar[:, 2] == 0)
  assert torch.all(arg[2:, 1] == 0) and torch.all(arg[:, 2] == 0)
  npt.assert_array_equal(alpha[1].numpy(), alpha_2[1].numpy())
  assert alpha[2, 0] == 0.0 and torch.all(alpha[2, 1:] == float('-inf'))


CARD_CASES = {
    # name: (vocab, hidden, max_expansions, frame_dependent)
    'fd_ragged_v37': (37, 24, 0, True),
    'fld1_v130': (130, 40, 1, False),
    'fld2_ragged_v1000': (1000, 512, 2, False),
    'fld2_v1024': (1024, 512, 2, False),
    # hp 640: too deep for the products' strip walk, so the pair walk (its
    # FLD(2) products: test_deep_head_kernel_matches_plain_to_ties_on_card).
    'fd_ragged_v1000_h640': (1000, 640, 0, True),
    # S=70: a full 64-state unit and a ragged one, so a block's second
    # warpgroup takes the ragged unit or the next row's first.
    'fld2_ragged_v69': (69, 64, 2, False),
}


@pytest.fixture
def card():
  if not torch.cuda.is_available():
    pytest.skip('needs an NVIDIA GPU: the CUDA kernel has no CPU mode')
  torch.backends.cuda.matmul.allow_tf32 = False
  return torch.device('cuda')


@pytest.mark.cuda
@pytest.mark.parametrize('compute_dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
@pytest.mark.parametrize('case', sorted(CARD_CASES))
def test_kernel_matches_plain_on_card(card, case, compute_dtype):
  vocab, hidden, k, fd = CARD_CASES[case]
  pf, pc, params, is_pad = random_inputs(1, vocab, hidden, max_t=12,
                                         lengths=[12, 7, 0], device=card)
  kwargs = dict(max_expansions=k, frame_dependent=fd,
                compute_dtype=compute_dtype)
  before = viterbi.launches
  arg_k, jstar_k, alpha_k = viterbi.viterbi_forward(
      pf, pc, params, is_pad, **kwargs)
  torch.cuda.synchronize()
  assert viterbi.launches == before + 1
  arg_p, jstar_p, alpha_p = viterbi.viterbi_forward_plain(
      pf, pc, params, is_pad, **kwargs)
  # Same rounded inputs, float32 sums in another order: the decisions agree
  # at these sizes, and the scores to float32 summation error.
  npt.assert_array_equal(arg_k.cpu().numpy(), arg_p.cpu().numpy())
  npt.assert_array_equal(jstar_k.cpu().numpy(), jstar_p.cpu().numpy())
  npt.assert_allclose(alpha_k.cpu().numpy(), alpha_p.cpu().numpy(),
                      rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize('normalize', ['hat', 'log_softmax'])
@pytest.mark.parametrize('compute_dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
@pytest.mark.parametrize('case', ['fd_ragged_v37', 'fld2_ragged_v1000',
                                  'fld2_ragged_v69', 'fd_ragged_v1000_h640'])
def test_normalized_kernel_matches_plain_on_card(card, case, compute_dtype,
                                                 normalize):
  vocab, hidden, k, fd = CARD_CASES[case]
  pf, pc, params, is_pad = random_inputs(1, vocab, hidden, max_t=12,
                                         lengths=[12, 7, 0], device=card)
  kwargs = dict(max_expansions=k, frame_dependent=fd,
                compute_dtype=compute_dtype, normalize=normalize)
  before = viterbi.launches
  arg_k, jstar_k, alpha_k = viterbi.viterbi_forward(
      pf, pc, params, is_pad, **kwargs)
  torch.cuda.synchronize()
  assert viterbi.launches == before + 1
  arg_p, jstar_p, alpha_p = viterbi.viterbi_forward_plain(
      pf, pc, params, is_pad, **kwargs)
  # As the unnormalized kernel: the decisions agree at these sizes, the
  # scores to float32 summation error (the normalizers are logsumexps of
  # the same rounded products).
  npt.assert_array_equal(arg_k.cpu().numpy(), arg_p.cpu().numpy())
  npt.assert_array_equal(jstar_k.cpu().numpy(), jstar_p.cpu().numpy())
  npt.assert_allclose(alpha_k.cpu().numpy(), alpha_p.cpu().numpy(),
                      rtol=1e-5, atol=1e-5)
  assert bool((alpha_k[:, 1:] <= 0).all())  # log-probabilities


def fld_tie_gaps(inputs, kwargs, got, want):
  """The entries where two FLD forwards' tables differ (arg: t, b, pass j,
  label y; jstar: t, b, state s), each with the gap between the two
  choices' scores, rescored in float64 from the plain version's alpha
  before frame t, relative to max(1, |score|)."""
  pf, pc, params, is_pad = inputs
  (arg_k, jstar_k, _), (arg_p, jstar_p, _) = got, want
  rnd = lambda x: x.to(kwargs['compute_dtype']).double()
  vw, vb = rnd(params['vocab_w']), params['vocab_b'].double()
  bw, bb = rnd(params['blank_w']), params['blank_b'].double()
  diffs = ([('arg', *i) for i in (arg_k != arg_p).nonzero().tolist()] +
           [('jstar', *i) for i in (jstar_k != jstar_p).nonzero().tolist()])
  gaps = []
  for kind, t, b, *where in diffs:
    alpha = viterbi.viterbi_forward_plain(
        pf[:t].contiguous(), pc, params, is_pad[:t].contiguous(),
        **kwargs)[2][b].double()
    joint = rnd(torch.tanh(pc + pf[t, b]))  # [S, h]
    lex, blank = joint @ vw + vb, joint @ bw + bb
    c = torch.zeros_like(blank)
    if kwargs['normalize'] == 'hat':
      softplus = lambda x: torch.logaddexp(x, torch.zeros_like(x))
      c, blank = torch.logsumexp(lex, -1) + softplus(blank), -softplus(-blank)
    vecs = [alpha]  # each pass's input: alpha, then the expanded maxima
    for _ in range(arg_k.shape[2]):
      red = ((vecs[-1] - c)[:, None] + lex).max(dim=0).values
      vecs.append(torch.cat([red.new_full((1,), float('-inf')), red]))
    if kind == 'arg':
      j, y = where
      score = lambda s: vecs[j][s] - c[s] + lex[s, y]
      mine, theirs = int(arg_k[t, b, j, y]), int(arg_p[t, b, j, y])
    else:
      (s,) = where
      score = lambda j: vecs[j][s] + blank[s]
      mine, theirs = int(jstar_k[t, b, s]), int(jstar_p[t, b, s])
    a, z = score(mine).item(), score(theirs).item()
    gaps.append(abs(a - z) / max(abs(z), 1.0))
  return gaps


@pytest.mark.cuda
@pytest.mark.parametrize('normalize', ['none', 'hat'])
@pytest.mark.parametrize('compute_dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
def test_deep_head_kernel_matches_plain_to_ties_on_card(card, compute_dtype,
                                                        normalize):
  """h=640 (hp 640, past the strip walk's 576): the bfloat16 FLD(2)
  products run the pair walk (column_max_kernel storing lex for the second
  pass; row_reduce_kernel under hat). At test_kernel_matches_plain's inputs
  some labels' best source states tie to within 2e-8 of their score, which
  float32 sums in another order break either way, in the float32 kernel
  (no walk) as in the bfloat16 one. So the tables may differ from the plain
  version's in a few entries, each a tie in float64 (1e-6), and alpha
  agrees to float32 summation error."""
  vocab, hidden = 1000, 640
  inputs = random_inputs(1, vocab, hidden, max_t=12, lengths=[12, 7, 0],
                         device=card)
  kwargs = dict(max_expansions=2, frame_dependent=False,
                compute_dtype=compute_dtype, normalize=normalize)
  got = viterbi.viterbi_forward(*inputs, **kwargs)
  want = viterbi.viterbi_forward_plain(*inputs, **kwargs)
  gaps = fld_tie_gaps(inputs, kwargs, got, want)
  assert len(gaps) <= 3 and max(gaps, default=0.0) <= 1e-6, gaps
  npt.assert_allclose(got[2].cpu().numpy(), want[2].cpu().numpy(),
                      rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize('compute_dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
@pytest.mark.parametrize('frame_dependent', [True, False])
def test_kernel_breaks_ties_as_plain_on_card(card, frame_dependent,
                                             compute_dtype):
  # Every state ties: across the 64-state units (S=301: 5), the 128-label
  # strips (3) and the two warpgroups of a block.
  pf, pc, params, is_pad = tied_inputs(vocab=300, hidden=16, max_t=4,
                                       batch=3, device=card)
  kwargs = dict(max_expansions=2, frame_dependent=frame_dependent,
                compute_dtype=compute_dtype)
  got = viterbi.viterbi_forward(pf, pc, params, is_pad, **kwargs)
  want = viterbi.viterbi_forward_plain(pf, pc, params, is_pad, **kwargs)
  for g, w in zip(got, want):
    npt.assert_array_equal(g.cpu().numpy(), w.cpu().numpy())


# Labels whose lexical weight ties at the top: from the second frame on, the
# states 1 + y lead alpha together. They tie within a thread's two rows (2
# and 10), across lanes (12) and warps (30) of a unit, across the two
# warpgroups of a block (70), across blocks (200, 701) and label strips
# (labels 1 to 700 lie in 6 of the 8 strips of V=1000).
TIED_LABELS = (1, 9, 11, 29, 69, 199, 700)


@pytest.mark.cuda
@pytest.mark.parametrize('normalize', ['none', 'hat'])
@pytest.mark.parametrize('compute_dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
@pytest.mark.parametrize('frame_dependent', [True, False])
def test_kernel_breaks_placed_ties_as_plain_on_card(card, frame_dependent,
                                                    compute_dtype,
                                                    normalize):
  """The lowest of the tied states wins every argmax, in rows that end at
  different frames (one all padding). The lexical weights are vocab_b alone
  (exact in both versions); normalization subtracts one constant from every
  state, so the ties stay exact."""
  vocab, hidden, lengths = 1000, 64, [6, 5, 0, 2]
  rng = np.random.default_rng(11)
  vocab_b = rng.uniform(-2.0, -1.0, vocab).astype(np.float32)
  vocab_b[list(TIED_LABELS)] = 0.5  # above the start state's blank path
  params = {
      'vocab_w': torch.zeros((hidden, vocab), device=card),
      'vocab_b': torch.from_numpy(vocab_b).to(card),
      'blank_w': torch.zeros((hidden,), device=card),
      'blank_b': torch.tensor(-5.0, device=card),
  }
  pf, pc, _, is_pad = random_inputs(3, vocab, hidden, max_t=6,
                                    lengths=lengths, device=card)
  kwargs = dict(max_expansions=2, frame_dependent=frame_dependent,
                compute_dtype=compute_dtype, normalize=normalize)
  arg_k, jstar_k, alpha_k = viterbi.viterbi_forward(pf, pc, params, is_pad,
                                                    **kwargs)
  arg_p, jstar_p, alpha_p = viterbi.viterbi_forward_plain(
      pf, pc, params, is_pad, **kwargs)
  torch.cuda.synchronize()
  # From the second frame on, every live argmax is the lowest tied state,
  # or the start state where it leads alone (FLD's first pass under hat).
  live = ~is_pad
  live[0] = False
  chosen = set(arg_k[live].unique().tolist())
  assert 1 + min(TIED_LABELS) in chosen and chosen <= {0, 1 + min(TIED_LABELS)}
  npt.assert_array_equal(arg_k.cpu().numpy(), arg_p.cpu().numpy())
  npt.assert_array_equal(jstar_k.cpu().numpy(), jstar_p.cpu().numpy())
  # Unnormalized the scores are exact; the normalizers are logsumexps
  # taken in another order.
  npt.assert_allclose(alpha_k.cpu().numpy(), alpha_p.cpu().numpy(),
                      rtol=0 if normalize == 'none' else 1e-6, atol=0)


def test_walk_counts_follow_the_products_grid():
  # The cells' shape: S=1025 (17 units a row), V=1024 (8 strips), 132 SMs
  # (16 lanes a strip). 384 rows make 3264 unit pairs, 2 rows 17, 1 row 9,
  # and 0 rows none; a lane walks at most one pair of the last two.
  lanes = viterbi.strip_lanes(512, 1024, 132)
  assert lanes == 16
  tiles, loads = viterbi.walk_counts([384, 2, 1, 0], 1025, 1024, lanes)
  assert (tiles, loads) == ((3264 + 17 + 9) * 8, 8 * (16 + 16 + 9))
  # A one-row frame (B=1) gives each block one pair: a strip load a tile,
  # as on the pair walk, where every tile loads its strip.
  assert viterbi.walk_counts([1], 1025, 1024, lanes) == (72, 72)
  assert viterbi.walk_counts([384, 2], 1025, 1024, 0) == (26248, 26248)
  # A ragged vocabulary rounds to 64, then to strips: V=1000 (Vp 1024).
  assert viterbi.walk_counts([48], 1001, 1000, lanes) == (384 * 8, 128)


def test_walk_is_chosen_from_the_hidden_pad_alone():
  # The strip walk up to hp = 576 (h 513 to 576 pad to it), whatever the
  # vocabulary or the card, sms // strips lanes a strip and at least one;
  # past it the pair walk (0).
  for vocab, sms in ((64, 1), (1000, 132), (4096, 132), (32768, 78)):
    strips = -(-vocab // 128)
    for hidden in (24, 512, 513, 576, 577, 640, 1024):
      want = max(1, sms // strips) if hidden <= 576 else 0
      assert viterbi.strip_lanes(hidden, vocab, sms) == want, (vocab, hidden)


def product_launches(prof_json, walk):
  """The grids of the Viterbi's unit products in a profiler's Chrome trace,
  each checked to run in ``walk`` (StripWalk or PairWalk)."""
  import json
  with open(prof_json) as f:
    events = json.load(f)['traceEvents']
  grids = []
  for e in events:
    name = e.get('name', '')
    if e.get('cat') == 'kernel' and ('column_max_kernel' in name or
                                     'row_reduce_kernel' in name):
      assert walk in name, name
      grids.append(e['args']['grid'])
  return grids


@pytest.mark.cuda
@pytest.mark.parametrize('hidden', [512, 640], ids=['strip_walk', 'pair_walk'])
@pytest.mark.parametrize('normalize', ['none', 'hat'])
@pytest.mark.parametrize('frame_dependent', [True, False],
                         ids=['fd', 'fld2'])
def test_product_walks_give_each_row_its_own_bits_on_card(
    card, frame_dependent, normalize, hidden, tmp_path):
  """At B=48 a frame's product has up to 384 unit pairs by 8 strips, so
  each block walks many pairs (the strip walk's 16 lanes a strip on 132
  SMs; the pair walk's 2 blocks an SM over 3072 tiles). A tile's sums do
  not depend on the walk or on the other rows of the batch, so the batch's
  tables and alpha equal, bit for bit, each row's decoded alone (B=1).
  V=1000 (S=1001): a ragged last strip (104 labels) and unit (41 states);
  rows of no frames and rows that end mid-call. The profiler's trace shows
  the walk each product ran in and, on the strip walk, its blocks: one
  strip load each, as the call's ``strip_loads`` counts."""
  vocab, max_t = 1000, 6
  lengths = [6, 0, 3, 6, 1, 5, 2, 4] * 6
  pf, pc, params, is_pad = random_inputs(5, vocab, hidden, max_t, lengths,
                                         device=card)
  kwargs = dict(max_expansions=2, frame_dependent=frame_dependent,
                compute_dtype=torch.bfloat16, normalize=normalize)
  viterbi.viterbi_forward(pf, pc, params, is_pad, **kwargs)  # builds
  loads = viterbi.strip_loads
  with torch.profiler.profile(
      activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
    arg, jstar, alpha = viterbi.viterbi_forward(pf, pc, params, is_pad,
                                                **kwargs)
    torch.cuda.synchronize()
  prof.export_chrome_trace(str(tmp_path / 'trace.json'))
  grids = product_launches(tmp_path / 'trace.json',
                           'StripWalk' if hidden <= 576 else 'PairWalk')
  assert len(grids) == max_t  # one product a frame: every frame has rows
  if hidden <= 576:
    assert sum(g[0] for g in grids) == viterbi.strip_loads - loads
  bits = lambda x: x.view(torch.int32).cpu().numpy()
  for b in range(len(lengths)):
    arg_b, jstar_b, alpha_b = viterbi.viterbi_forward(
        pf[:, b:b + 1].contiguous(), pc, params,
        is_pad[:, b:b + 1].contiguous(), **kwargs)
    npt.assert_array_equal(arg[:, b:b + 1].cpu().numpy(), arg_b.cpu().numpy())
    npt.assert_array_equal(jstar[:, b:b + 1].cpu().numpy(),
                           jstar_b.cpu().numpy())
    npt.assert_array_equal(bits(alpha[b:b + 1]), bits(alpha_b))


def reread_launches(prof_json):
  """(grid, 16-byte loads) of each launch of the staged lex's later
  max-passes (max_pass_kernel) in a profiler's Chrome trace, in order."""
  import json
  with open(prof_json) as f:
    events = json.load(f)['traceEvents']
  found = sorted((e['ts'], e['args']['grid'], ', true>' in e['name'])
                 for e in events if e.get('cat') == 'kernel' and
                 'max_pass_kernel' in e.get('name', ''))
  return [(grid, vec) for _, grid, vec in found]


@pytest.mark.cuda
@pytest.mark.parametrize('vocab', [1000, 69], ids=['v1000', 'v69'])
@pytest.mark.parametrize('normalize', ['none', 'hat'])
def test_staged_reread_walks_the_live_rows_on_card(card, vocab, normalize,
                                                   tmp_path):
  """The bfloat16 forward's later max-passes, which read back the lex the
  frame's first product staged (FLD(2)'s second pass; under hat both,
  after the normalizing product), launch a block per live row's 64-state
  tile and 64-label strip, none for padding rows, with 16-byte loads where
  V % 4 == 0 (V=1000) and 4-byte ones where it is not (V=69). Each row's
  tables and alpha are the bits of that row decoded alone."""
  lengths, max_t = [6, 0, 3, 6, 1, 5, 2, 4], 6
  pf, pc, params, is_pad = random_inputs(7, vocab, 512, max_t, lengths,
                                         device=card)
  kwargs = dict(max_expansions=2, frame_dependent=False,
                compute_dtype=torch.bfloat16, normalize=normalize)
  viterbi.viterbi_forward(pf, pc, params, is_pad, **kwargs)  # builds
  with torch.profiler.profile(
      activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
    arg, jstar, alpha = viterbi.viterbi_forward(pf, pc, params, is_pad,
                                                **kwargs)
    torch.cuda.synchronize()
  prof.export_chrome_trace(str(tmp_path / 'trace.json'))
  launches = reread_launches(tmp_path / 'trace.json')
  live = [sum(n > t for n in lengths) for t in range(max_t)]
  passes = 1 if normalize == 'none' else 2  # those that read lex back
  assert [grid[2] for grid, _ in launches] == [
      n for n in live for _ in range(passes)]
  assert all(vec == (vocab % 4 == 0) for _, vec in launches)
  bits = lambda x: x.view(torch.int32).cpu().numpy()
  for b in range(len(lengths)):
    arg_b, jstar_b, alpha_b = viterbi.viterbi_forward(
        pf[:, b:b + 1].contiguous(), pc, params,
        is_pad[:, b:b + 1].contiguous(), **kwargs)
    npt.assert_array_equal(arg[:, b:b + 1].cpu().numpy(), arg_b.cpu().numpy())
    npt.assert_array_equal(jstar[:, b:b + 1].cpu().numpy(),
                           jstar_b.cpu().numpy())
    npt.assert_array_equal(bits(alpha[b:b + 1]), bits(alpha_b))


def fused_inputs(seed, vocab, hidden, max_t, lengths, device='cpu'):
  pf, pc, params, is_pad = random_inputs(seed, vocab, hidden, max_t, lengths,
                                         device)
  return pf * 0.5, pc * 0.5, params, is_pad


def test_plain_log_partition_padding():
  lengths = [6, 2, 0]
  pf, pc, params, is_pad = fused_inputs(0, vocab=7, hidden=5, max_t=6,
                                        lengths=lengths)
  kw = dict(max_expansions=2, frame_dependent=False,
            compute_dtype=torch.float32)
  log_z, alpha, hist, slabs = fused_scan.fused_forward_plain(
      pf, pc, params, is_pad, with_residuals=True, **kw)
  log_z_2, alpha_2, _, _ = fused_scan.fused_forward_plain(
      pf[:2].contiguous(), pc, params, is_pad[:2].contiguous(),
      with_residuals=False, **kw)
  # Padding frames hold alpha; the empty row keeps the start state.
  npt.assert_array_equal(alpha[1].numpy(), alpha_2[1].numpy())
  assert log_z[1] == log_z_2[1] and log_z[2] == 0.0
  for t in range(2, 6):
    npt.assert_array_equal(hist[t, 1].numpy(), alpha_2[1].numpy())
  assert torch.all(slabs[:, 2:, 1] == float('-inf'))
  assert torch.all(slabs[:, :, 2] == float('-inf'))

  g = torch.tensor([1.0, 0.5, 1.0])
  dpf, dpc, dvw, dvb, dbw, dbb, beta = fused_scan.fused_backward_plain(
      pf, pc, params, is_pad, log_z, g, hist, slabs, **kw)
  # Padding frames and the empty row get exactly zero gradient.
  assert torch.all(dpf[2:, 1] == 0) and torch.all(dpf[:, 2] == 0)
  assert torch.all(dpf[:2, 1] != 0)
  assert torch.all(beta[2] == 0)
  for x in (dpc, dvw, dvb, dbw, dbb):
    assert torch.isfinite(x).all()
  # g = 0 everywhere: every gradient is exactly zero.
  zero = fused_scan.fused_backward_plain(pf, pc, params, is_pad, log_z,
                                         torch.zeros(3), hist, slabs, **kw)
  for x in zero[:-1]:
    assert torch.all(x == 0)


FUSED_CARD_CASES = {
    # name: (vocab, hidden, max_expansions, frame_dependent, batch)
    'fd_ragged_v37': (37, 24, 0, True, 3),
    'fld1_v130': (130, 40, 1, False, 3),
    'fld2_ragged_v1000': (1000, 512, 2, False, 3),
    'fld2_v1024': (1024, 512, 2, False, 3),
    # The bfloat16 backward's wgmma tiles: 128-label strips past a ragged
    # V=520 (padded to 576), S=1025, one row and 32.
    'fd_v1024': (1024, 512, 0, True, 3),
    'fd_ragged_v520_b32': (520, 512, 0, True, 32),
    'fld1_ragged_v520_b1': (520, 512, 1, False, 1),
    'fld3_ragged_v520': (520, 512, 3, False, 3),
    'fld2_v1024_b32': (1024, 512, 2, False, 32),
    # The bfloat16 online backward's chunks of 1024 states: S=1101 runs a
    # full chunk and a ragged one, over FD, FLD(1) and FLD(3), with B=32.
    'fd_ragged_v1100_b32': (1100, 512, 0, True, 32),
    'fld1_ragged_v1100': (1100, 512, 1, False, 3),
    'fld3_ragged_v1100_b32': (1100, 512, 3, False, 32),
    # The bfloat16 forward's column reduction: V not a multiple of 4 (its
    # padded labels must be masked, not reduced), S=77 (a ragged 64-state
    # unit), h=80 (the joint zero past h in its 128-deep padding).
    'fld2_ragged_v1021_h80': (1021, 80, 2, False, 3),
    'fld2_ragged_v76_h80': (76, 80, 2, False, 5),
    # Rows that end at different frames (one empty) on the bfloat16 'online'
    # forward's column reduction, FLD(2): the same log Z as 'cache'.
    'fld2_ragged_v1000_b8': (1000, 512, 2, False, 8),
}
# T_max of the card cases: the last two frames are padding in every row.
CARD_MAX_T = 14


def card_rows(batch, device):
  """(lengths, g) of a card case: row 0 has 12 frames, row 1 7 and a zero
  cotangent, row 2 none; further rows 1 to 11 frames."""
  lengths = ([12, 7, 0] + [1 + 5 * i % 11 for i in range(batch)])[:batch]
  g = ([1.0, 0.0, 1.0] + [0.5 + 0.1 * (i % 7) for i in range(batch)])[:batch]
  return lengths, torch.tensor(g, device=device)


def assert_zero_rows(dpf, lengths, g):
  """d(pf) is exactly zero on padding frames, on empty rows and on rows
  with a zero cotangent."""
  for b, (n, gb) in enumerate(zip(lengths, g.tolist())):
    assert torch.all(dpf[n:, b] == 0), b
    if gb == 0.0:
      assert torch.all(dpf[:, b] == 0), b


def rel_err(a, b, per_output=False):
  """max |a - b| / max(|b|, 1) elementwise, or with per_output
  |a - b|max / |b|max; infinities must match exactly."""
  a, b = a.double().cpu(), b.double().cpu()
  finite = torch.isfinite(b)
  assert torch.equal(finite, torch.isfinite(a))
  assert torch.equal(a[~finite], b[~finite])
  if not bool(finite.any()):
    return 0.0
  a, b = a[finite], b[finite]
  if per_output:
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
  return float(((a - b).abs() / b.abs().clamp(min=1.0)).max())


@pytest.mark.cuda
@pytest.mark.parametrize('compute_dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
@pytest.mark.parametrize('case', sorted(FUSED_CARD_CASES))
def test_log_partition_kernels_match_plain_on_card(card, case,
                                                   compute_dtype):
  vocab, hidden, k, fd, batch = FUSED_CARD_CASES[case]
  lengths, g = card_rows(batch, card)
  pf, pc, params, is_pad = fused_inputs(2, vocab, hidden, CARD_MAX_T,
                                        lengths, device=card)
  kw = dict(max_expansions=k, frame_dependent=fd,
            compute_dtype=compute_dtype)
  before = fused_scan.forward_launches, fused_scan.backward_launches
  fwd_k = fused_scan.fused_forward(pf, pc, params, is_pad,
                                   with_residuals=True, **kw)
  fwd_p = fused_scan.fused_forward_plain(pf, pc, params, is_pad,
                                         with_residuals=True, **kw)
  bwd_k = fused_scan.fused_backward(pf, pc, params, is_pad, fwd_k[0], g,
                                    fwd_k[2], fwd_k[3], **kw)
  bwd_p = fused_scan.fused_backward_plain(pf, pc, params, is_pad, fwd_p[0],
                                          g, fwd_p[2], fwd_p[3], **kw)
  torch.cuda.synchronize()
  assert (fused_scan.forward_launches, fused_scan.backward_launches) == (
      before[0] + 1, before[1] + 1)
  # Same rounded inputs, float32 sums in another order. Log-space values
  # (alpha, log Z, beta) to 1e-5 of max(|value|, 1) in float32. Gradients
  # as |a - b|max / |b|max per output, 1e-4 in float32: a marginal is the
  # exp of a sum of log-space terms as large as |log Z|, so a float32 sum
  # taken in another order moves it by ~|log Z| * 6e-8 relative
  # (test_fused_scan.py holds the JAX kernel's gradients to the same
  # 1e-4). bfloat16 (rounding points shared, but a float32 tanh on either
  # side of a bfloat16 rounding boundary moves a joint entry by one
  # bfloat16 step): values to 1e-4, gradients to 1e-3.
  bf16 = compute_dtype == torch.bfloat16
  for name, got, want in zip(('log_z', 'alpha', 'hist', 'slabs'), fwd_k,
                             fwd_p):
    if want is not None:
      assert rel_err(got, want) <= (1e-4 if bf16 else 1e-5), name
  names = ('dpf', 'dpc', 'dvw', 'dvb', 'dbw', 'dbb', 'beta_out')
  for name, got, want in zip(names, bwd_k, bwd_p):
    if name == 'beta_out':
      assert rel_err(got, want) <= (1e-4 if bf16 else 1e-5), name
    else:
      err = rel_err(got, want, per_output=True)
      assert err <= (1e-3 if bf16 else 1e-4), name
  assert_zero_rows(bwd_k[0], lengths, g)


@pytest.mark.cuda
@pytest.mark.parametrize('compute_dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
@pytest.mark.parametrize('case', sorted(FUSED_CARD_CASES))
def test_online_kernels_match_plain_and_cache_on_card(card, case,
                                                      compute_dtype):
  vocab, hidden, k, fd, batch = FUSED_CARD_CASES[case]
  lengths, g = card_rows(batch, card)
  pf, pc, params, is_pad = fused_inputs(2, vocab, hidden, CARD_MAX_T,
                                        lengths, device=card)
  kw = dict(max_expansions=k, frame_dependent=fd,
            compute_dtype=compute_dtype)
  before = (fused_scan.online_forward_launches,
            fused_scan.online_backward_launches)
  fwd_o = fused_scan.fused_forward(pf, pc, params, is_pad,
                                   with_residuals=True, mode='online', **kw)
  bwd_o = fused_scan.fused_backward(pf, pc, params, is_pad, fwd_o[0], g,
                                    fwd_o[2], fwd_o[3], mode='online', **kw)
  torch.cuda.synchronize()
  assert (fused_scan.online_forward_launches,
          fused_scan.online_backward_launches) == (before[0] + 1,
                                                   before[1] + 1)
  fwd_c = fused_scan.fused_forward(pf, pc, params, is_pad,
                                   with_residuals=True, **kw)
  bwd_c = fused_scan.fused_backward(pf, pc, params, is_pad, fwd_c[0], g,
                                    fwd_c[2], fwd_c[3], **kw)
  fwd_p = fused_scan.fused_forward_plain(pf, pc, params, is_pad,
                                         with_residuals=True, **kw)
  bwd_p = fused_scan.fused_backward_plain(pf, pc, params, is_pad, fwd_p[0],
                                          g, fwd_p[2], fwd_p[3], **kw)
  # As the cache kernels against plain (test above); against the cache
  # kernels the same bounds hold: the products are the same, only the
  # order of the float32 sums differs (d_lex chunks, recomputed lex).
  bf16 = compute_dtype == torch.bfloat16
  for fwd, bwd in ((fwd_p, bwd_p), (fwd_c, bwd_c)):
    for name, got, want in zip(('log_z', 'alpha', 'hist', 'slabs'), fwd_o,
                               fwd):
      if want is not None:
        assert rel_err(got, want) <= (1e-4 if bf16 else 1e-5), name
    names = ('dpf', 'dpc', 'dvw', 'dvb', 'dbw', 'dbb', 'beta_out')
    for name, got, want in zip(names, bwd_o, bwd):
      if name == 'beta_out':
        assert rel_err(got, want) <= (1e-4 if bf16 else 1e-5), name
      else:
        assert rel_err(got, want, per_output=True) <= (
            1e-3 if bf16 else 1e-4), name
  assert_zero_rows(bwd_o[0], lengths, g)


@pytest.mark.cuda
@pytest.mark.parametrize('compute_dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
@pytest.mark.parametrize('case', sorted(FUSED_CARD_CASES))
def test_marginals_kernel_matches_plain_on_card(card, case, compute_dtype):
  vocab, hidden, k, fd, batch = FUSED_CARD_CASES[case]
  lengths, _ = card_rows(batch, card)
  pf, pc, params, is_pad = fused_inputs(5, vocab, hidden, CARD_MAX_T,
                                        lengths, device=card)
  kw = dict(max_expansions=k, frame_dependent=fd,
            compute_dtype=compute_dtype)
  log_z, _, hist, slabs = fused_scan.fused_forward_plain(
      pf, pc, params, is_pad, with_residuals=True, **kw)
  before = fused_scan.marginals_launches
  torch.cuda.synchronize()
  allocated = torch.cuda.memory_allocated(card)
  torch.cuda.reset_peak_memory_stats(card)
  bm, lp = fused_scan.fused_marginals(pf, pc, params, is_pad, log_z, hist,
                                      slabs, **kw)
  torch.cuda.synchronize()
  peak = torch.cuda.max_memory_allocated(card) - allocated
  assert fused_scan.marginals_launches == before + 1
  bm_p, lp_p = fused_scan.fused_marginals_plain(pf, pc, params, is_pad,
                                                log_z, hist, slabs, **kw)
  # Posteriors as the backward's gradients (the same exps with g = 1).
  bf16 = compute_dtype == torch.bfloat16
  if bf16 and vocab >= 1000:
    # The bfloat16 route recomputes lex for each reduction: the whole call
    # holds less than the float32 [B, S, V] lex the float32 route stages.
    assert peak < batch * (vocab + 1) * vocab * 4
  assert rel_err(bm, bm_p, per_output=True) <= (1e-3 if bf16 else 1e-4)
  assert rel_err(lp, lp_p, per_output=True) <= (1e-3 if bf16 else 1e-4)
  # Padding frames and empty rows: exact zeros.
  for b, n in enumerate(lengths):
    assert torch.all(bm[n:, b] == 0) and torch.all(lp[n:, b] == 0)
    if not fd:  # one blank arc per frame on every path
      blank = bm[:n, b].sum(-1)
      assert torch.allclose(blank, torch.ones_like(blank), rtol=1e-3)


@pytest.mark.cuda
def test_kernels_take_no_frames_on_card(card):
  pf, pc, params, is_pad = fused_inputs(6, 130, 40, max_t=0, lengths=[0, 0],
                                        device=card)
  kw = dict(max_expansions=2, frame_dependent=False,
            compute_dtype=torch.bfloat16)
  g = torch.ones(2, device=card)
  for mode in fused_scan.MODES:
    log_z, alpha, hist, slabs = fused_scan.fused_forward(
        pf, pc, params, is_pad, with_residuals=True, mode=mode, **kw)
    assert torch.all(log_z == 0) and hist.shape == (0, 2, 131)
    grads = fused_scan.fused_backward(pf, pc, params, is_pad, log_z, g, hist,
                                      slabs, mode=mode, **kw)
    assert grads[0].shape == (0, 2, 40)
    for x in grads[1:-1]:
      assert torch.all(x == 0)
  bm, lp = fused_scan.fused_marginals(pf, pc, params, is_pad, log_z, hist,
                                      slabs, **kw)
  assert bm.shape == (0, 2, 131) and lp.shape == (0, 2, 130)


@pytest.mark.cuda
def test_log_partition_kernels_give_exact_zeros_on_card(card):
  pf, pc, params, is_pad = fused_inputs(3, 130, 40, max_t=6,
                                        lengths=[6, 3, 0], device=card)
  kw = dict(max_expansions=2, frame_dependent=False,
            compute_dtype=torch.bfloat16)
  log_z, _, hist, slabs = fused_scan.fused_forward(
      pf, pc, params, is_pad, with_residuals=True, **kw)
  assert log_z[2].item() == 0.0
  grads = fused_scan.fused_backward(pf, pc, params, is_pad, log_z,
                                    torch.zeros(3, device=card), hist, slabs,
                                    **kw)
  for x in grads[:-1]:
    assert torch.all(x == 0)
  # beta does not depend on g; the empty row's stays the semiring one.
  assert torch.all(grads[-1][2] == 0)


@pytest.mark.cuda
def test_log_partition_primal_only_forward_on_card(card):
  pf, pc, params, is_pad = fused_inputs(4, 1000, 512, max_t=5,
                                        lengths=[5, 4], device=card)
  kw = dict(max_expansions=2, frame_dependent=False,
            compute_dtype=torch.bfloat16)
  with_res = fused_scan.fused_forward(pf, pc, params, is_pad,
                                      with_residuals=True, **kw)
  log_z, alpha, hist, slabs = fused_scan.fused_forward(
      pf, pc, params, is_pad, with_residuals=False, **kw)
  assert hist is None and slabs is None
  npt.assert_array_equal(log_z.cpu().numpy(), with_res[0].cpu().numpy())
  npt.assert_array_equal(alpha.cpu().numpy(), with_res[1].cpu().numpy())


def numerator_inputs(seed, vocab, hidden, max_t, batch, u1, device='cpu'):
  rng = np.random.default_rng(seed)
  tensor = lambda shape, scale=1.0: torch.from_numpy(
      (rng.standard_normal(shape) * scale).astype(np.float32)).to(device)
  head = {
      'vocab_w': tensor((hidden, vocab), hidden**-0.5),
      'vocab_b': tensor((vocab,), 0.1),
      'blank_w': tensor((hidden,), hidden**-0.5),
      'blank_b': torch.tensor(0.3, device=device),
  }
  rows = batch * u1
  pc, pf = tensor((rows, hidden), 0.5), tensor((max_t, batch, hidden), 0.5)
  wy, by = tensor((rows, hidden), hidden**-0.5), tensor((rows,), 0.1)
  # Cotangents: batch row 1 (where there is one) zero throughout, frame 0
  # zero for every row.
  g_b, g_l = tensor((max_t, rows)), tensor((max_t, rows))
  for g in (g_b, g_l):
    if batch > 1:
      g.view(max_t, batch, u1)[:, 1] = 0.0
    g[:1] = 0.0
  return pc, pf, head, wy, by, g_b, g_l


NUMERATOR_OUTPUTS = ('d_pc', 'd_pf', 'd_vocab_w', 'd_vocab_b', 'd_blank_w',
                     'd_blank_b', 'd_wy', 'd_by')


@pytest.mark.parametrize('hat', [True, False], ids=['hat', 'log_softmax'])
def test_plain_numerator_backward_is_the_vjp_of_its_forward(hat):
  pc, pf, head, wy, by, g_b, g_l = numerator_inputs(5, vocab=9, hidden=6,
                                                    max_t=4, batch=3, u1=2)
  kw = dict(hat=hat, compute_dtype=torch.float32)
  inputs = [pc, pf, head['vocab_w'], head['vocab_b'], head['blank_w'],
            head['blank_b'], wy, by]
  leaves = [x.clone().requires_grad_(True) for x in inputs]
  nb, nl, z, blank = numerator_scan.numerator_forward_plain(
      leaves[0], leaves[1], dict(zip(numerator_scan._HEAD, leaves[2:6])),
      leaves[6], leaves[7], **kw)
  want = torch.autograd.grad((nb * g_b).sum() + (nl * g_l).sum(), leaves)
  got = numerator_scan.numerator_backward_plain(
      pc, pf, head, wy, by, z.detach(), blank.detach(), g_b, g_l, **kw)
  # Both follow ``inputs``' order.
  for name, g, w in zip(NUMERATOR_OUTPUTS, got, want):
    npt.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5, atol=1e-6,
                        err_msg=name)
  # Zero cotangents: batch row 1's frames and frame 0 get exactly zero.
  d_pf = got[1]
  assert torch.all(d_pf[:, 1] == 0) and torch.all(d_pf[0] == 0)
  zero = numerator_scan.numerator_backward_plain(
      pc, pf, head, wy, by, z.detach(), blank.detach(), torch.zeros_like(g_b),
      torch.zeros_like(g_l), **kw)
  for x in zero:
    assert torch.all(x == 0)


NUMERATOR_CARD_CASES = {
    # name: (vocab, hidden, batch, u1)
    'ragged_v70_h40': (70, 40, 3, 5),  # 13 batch rows in a 64-row tile
    'v1024_u101': (1024, 512, 2, 101),  # rows 64-127 hold two batch rows
    'ragged_v1000_u37': (1000, 512, 3, 37),
    # B=1, one batch row over three tiles, h off the 64-deep stages and
    # V % 4 != 0.
    'b1_u130_v1001_h72': (1001, 72, 1, 130),
}


@pytest.fixture
def few_frames_a_chunk(monkeypatch):
  """Sets the numerator's staging budget to ``frames`` frames of the
  forward at the given shape (the backward's chunks, larger a frame, take
  one or a few frames then), clearing the cached plans around the test."""

  def budget(frames, batch, u1, hidden, vocab, compute_dtype):
    per_frame = sum(
        np.prod(shape) * torch.empty((), dtype=dtype).element_size()
        for name, (shape, dtype) in numerator_scan.forward_scratch(
            batch, u1, hidden, vocab, compute_dtype, 1).items()
        if name != 'wp')
    monkeypatch.setattr(numerator_scan, '_CHUNK_BYTES',
                        int(frames * per_frame))
    for plan in (numerator_scan.forward_plan, numerator_scan.backward_plan):
      plan.cache_clear()

  yield budget
  for plan in (numerator_scan.forward_plan, numerator_scan.backward_plan):
    plan.cache_clear()


@pytest.mark.cuda
@pytest.mark.parametrize('chunks', ['one', 'several'])
@pytest.mark.parametrize('hat', [True, False], ids=['hat', 'log_softmax'])
@pytest.mark.parametrize('compute_dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
@pytest.mark.parametrize('case', sorted(NUMERATOR_CARD_CASES))
def test_numerator_kernels_match_plain_on_card(card, case, compute_dtype,
                                               hat, chunks,
                                               few_frames_a_chunk):
  vocab, hidden, batch, u1 = NUMERATOR_CARD_CASES[case]
  pc, pf, head, wy, by, g_b, g_l = numerator_inputs(
      6, vocab, hidden, max_t=9, batch=batch, u1=u1, device=card)
  kw = dict(hat=hat, compute_dtype=compute_dtype)
  if chunks == 'several':  # the forward walks 9 frames 2 at a time
    few_frames_a_chunk(2, batch, u1, hidden, vocab, compute_dtype)
    assert numerator_scan.forward_plan(
        9, batch, u1, hidden, vocab, compute_dtype,
        joint_head.sm_count(card)).chunk == 2
  before = (numerator_scan.forward_launches,
            numerator_scan.backward_launches)
  fwd_k = numerator_scan.numerator_forward(pc, pf, head, wy, by, **kw)
  fwd_p = numerator_scan.numerator_forward_plain(pc, pf, head, wy, by, **kw)
  bwd_k = numerator_scan.numerator_backward(pc, pf, head, wy, by, fwd_k[2],
                                            fwd_k[3], g_b, g_l, **kw)
  bwd_p = numerator_scan.numerator_backward_plain(pc, pf, head, wy, by,
                                                  fwd_p[2], fwd_p[3], g_b,
                                                  g_l, **kw)
  torch.cuda.synchronize()
  assert (numerator_scan.forward_launches,
          numerator_scan.backward_launches) == (before[0] + 1, before[1] + 1)
  # Same rounded inputs, float32 sums in another order: values to 1e-5 of
  # max(|value|, 1), gradients to 1e-4 of each output's largest entry in
  # float32; bfloat16 (a float32 tanh on either side of a rounding
  # boundary moves a joint entry by one bfloat16 step, ds is rounded too):
  # 1e-4 and 2e-3.
  bf16 = compute_dtype == torch.bfloat16
  for name, got, want in zip(('nb', 'nl', 'z', 'blank'), fwd_k, fwd_p):
    assert rel_err(got, want) <= (1e-4 if bf16 else 1e-5), name
  for name, got, want in zip(NUMERATOR_OUTPUTS, bwd_k, bwd_p):
    assert rel_err(got, want, per_output=True) <= (2e-3 if bf16 else 1e-4), (
        name)
  d_pf = bwd_k[1]
  assert torch.all(d_pf[0] == 0)
  if batch > 1:  # batch row 1's rows have no cotangent: exact zeros
    assert torch.all(d_pf[:, 1] == 0)
    d_pc, d_wy, d_by = bwd_k[0], bwd_k[6], bwd_k[7]
    for x in (d_pc, d_wy, d_by):
      assert torch.all(x.view(batch, u1, -1)[1] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize('compute_dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
def test_numerator_kernels_match_plain_over_many_frames_on_card(
    card, compute_dtype):
  # chip_smoke.py phase 5b's widest shape (T=64, B=4, U+1=26, V=1000,
  # h=1024): each block of the d_joint product walks many items in turn,
  # as at the main paths' shapes.
  vocab, hidden, batch, u1 = 1000, 1024, 4, 26
  pc, pf, head, wy, by, g_b, g_l = numerator_inputs(
      13, vocab, hidden, max_t=64, batch=batch, u1=u1, device=card)
  kw = dict(hat=True, compute_dtype=compute_dtype)
  fwd = numerator_scan.numerator_forward_plain(pc, pf, head, wy, by, **kw)
  got = numerator_scan.numerator_backward(pc, pf, head, wy, by, fwd[2],
                                          fwd[3], g_b, g_l, **kw)
  want = numerator_scan.numerator_backward_plain(pc, pf, head, wy, by,
                                                 fwd[2], fwd[3], g_b, g_l,
                                                 **kw)
  torch.cuda.synchronize()
  bf16 = compute_dtype == torch.bfloat16
  for name, a, b in zip(NUMERATOR_OUTPUTS, got, want):
    assert rel_err(a, b, per_output=True) <= (2e-3 if bf16 else 1e-4), name


@pytest.mark.cuda
@pytest.mark.parametrize('compute_dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
def test_numerator_backward_in_several_chunks_on_card(card, compute_dtype,
                                                      monkeypatch):
  # A staging budget of a few frames: the backward walks its live list in
  # chunks (the main paths' shapes take 16 to 62), each with its own items,
  # slots and d_pf frames, and sums across them.
  vocab, hidden, batch, u1 = 1000, 72, 3, 37
  pc, pf, head, wy, by, g_b, g_l = numerator_inputs(
      11, vocab, hidden, max_t=23, batch=batch, u1=u1, device=card)
  kw = dict(hat=True, compute_dtype=compute_dtype)
  fwd = numerator_scan.numerator_forward_plain(pc, pf, head, wy, by, **kw)
  want = numerator_scan.numerator_backward_plain(pc, pf, head, wy, by,
                                                 fwd[2], fwd[3], g_b, g_l,
                                                 **kw)
  numerator_scan.backward_plan.cache_clear()
  item = torch.finfo(compute_dtype).bits // 8
  per_frame = 2 * 64 * (128 * item + 1024 * item + 4 * hidden)
  monkeypatch.setattr(numerator_scan, '_CHUNK_BYTES', 4 * per_frame)
  try:
    plan = numerator_scan.backward_plan(23, batch, u1, hidden, vocab,
                                        compute_dtype,
                                        joint_head.sm_count(card))
    assert 1 < plan.chunk < 23
    got = numerator_scan.numerator_backward(pc, pf, head, wy, by, fwd[2],
                                            fwd[3], g_b, g_l, **kw)
    torch.cuda.synchronize()
  finally:
    numerator_scan.backward_plan.cache_clear()
  bf16 = compute_dtype == torch.bfloat16
  for name, a, b in zip(NUMERATOR_OUTPUTS, got, want):
    assert rel_err(a, b, per_output=True) <= (2e-3 if bf16 else 1e-4), name


@pytest.mark.cuda
@pytest.mark.parametrize('case', ['dead', 'live', 'lengths'])
@pytest.mark.parametrize('batch,u1,chunk', [(4, 101, 5), (30, 5, 3),
                                            (1, 130, 17)])
def test_numerator_live_tiles_match_plain_on_card(card, batch, u1, chunk,
                                                  case):
  # The backward's live list from its own kernels (mark, prefix sum)
  # against the plain version: the same items in the same order.
  rng = np.random.default_rng(12)
  max_t = 40
  g = rng.standard_normal((2, max_t, batch, u1)).astype(np.float32)
  if case == 'dead':
    g *= 0
  elif case == 'lengths':
    frames = rng.integers(0, max_t + 1, size=batch)
    labels = rng.integers(0, u1, size=batch)
    g *= ((np.arange(max_t)[:, None, None] < frames[None, :, None]) &
          (np.arange(u1)[None, None, :] <= labels[None, :, None]))
  g_b, g_l = (torch.from_numpy(x.reshape(max_t, batch * u1)) for x in g)
  want = numerator_scan.live_tiles(g_b, g_l, chunk)
  got = numerator_scan.live_tiles(g_b.to(card), g_l.to(card), chunk)
  items, groups, count, pos_of = (x.cpu() for x in got)
  n = int(want[2].sum())
  assert torch.equal(items[:n], want[0][:n])
  assert torch.equal(groups, want[1]) and torch.equal(count, want[2])
  assert torch.equal(pos_of, want[3])


@pytest.mark.cuda
@pytest.mark.parametrize('hat', [True, False], ids=['hat', 'log_softmax'])
@pytest.mark.parametrize('hidden,compute_dtype',
                         [(1024, torch.float32), (2048, torch.bfloat16)],
                         ids=['h1024_f32', 'h2048_bf16'])
def test_numerator_kernels_match_plain_at_large_hidden_on_card(
    card, hidden, compute_dtype, hat):
  # Wide joints: both directions walk the depth in 64-deep stages (16 of
  # them at h=1024, 32 at h=2048); no hidden size is too wide.
  pc, pf, head, wy, by, g_b, g_l = numerator_inputs(
      7, 1000, hidden, max_t=9, batch=3, u1=37, device=card)
  kw = dict(hat=hat, compute_dtype=compute_dtype)
  fwd_k = numerator_scan.numerator_forward(pc, pf, head, wy, by, **kw)
  fwd_p = numerator_scan.numerator_forward_plain(pc, pf, head, wy, by, **kw)
  bwd_k = numerator_scan.numerator_backward(pc, pf, head, wy, by, fwd_k[2],
                                            fwd_k[3], g_b, g_l, **kw)
  bwd_p = numerator_scan.numerator_backward_plain(pc, pf, head, wy, by,
                                                  fwd_p[2], fwd_p[3], g_b,
                                                  g_l, **kw)
  torch.cuda.synchronize()
  # The tolerances of test_numerator_kernels_match_plain_on_card.
  bf16 = compute_dtype == torch.bfloat16
  for name, got, want in zip(('nb', 'nl', 'z', 'blank'), fwd_k, fwd_p):
    assert rel_err(got, want) <= (1e-4 if bf16 else 1e-5), name
  for name, got, want in zip(NUMERATOR_OUTPUTS, bwd_k, bwd_p):
    assert rel_err(got, want, per_output=True) <= (2e-3 if bf16 else 1e-4), (
        name)


@pytest.mark.cuda
@pytest.mark.parametrize('hat', [True, False], ids=['hat', 'log_softmax'])
def test_numerator_kernels_take_no_frames_on_card(card, hat):
  pc, pf, head, wy, by, g_b, g_l = numerator_inputs(8, 70, 40, max_t=0,
                                                    batch=3, u1=5,
                                                    device=card)
  kw = dict(hat=hat, compute_dtype=torch.float32)
  fwd_k = numerator_scan.numerator_forward(pc, pf, head, wy, by, **kw)
  fwd_p = numerator_scan.numerator_forward_plain(pc, pf, head, wy, by, **kw)
  for got, want in zip(fwd_k, fwd_p):
    assert got.shape == want.shape == (0, 15)
  bwd_k = numerator_scan.numerator_backward(pc, pf, head, wy, by, fwd_k[2],
                                            fwd_k[3], g_b, g_l, **kw)
  bwd_p = numerator_scan.numerator_backward_plain(pc, pf, head, wy, by,
                                                  fwd_p[2], fwd_p[3], g_b,
                                                  g_l, **kw)
  for name, got, want in zip(NUMERATOR_OUTPUTS, bwd_k, bwd_p):
    assert got.shape == want.shape and torch.all(got == 0), name
    assert torch.all(want == 0), name


@pytest.mark.cuda
def test_numerator_kernels_give_exact_zeros_on_card(card):
  pc, pf, head, wy, by, g_b, g_l = numerator_inputs(7, 130, 64, max_t=5,
                                                    batch=2, u1=3,
                                                    device=card)
  kw = dict(hat=False, compute_dtype=torch.bfloat16)
  _, _, z, blank = numerator_scan.numerator_forward(pc, pf, head, wy, by,
                                                    **kw)
  grads = numerator_scan.numerator_backward(
      pc, pf, head, wy, by, z, blank, torch.zeros_like(g_b),
      torch.zeros_like(g_l), **kw)
  for x in grads:
    assert torch.all(x == 0)


TRIGRAM_CARD_CASES = {
    # name: (vocab, hidden, max_expansions, frame_dependent, batch);
    # S = 1 + V + V^2. In bfloat16 the segment kernels run all but
    # TRIGRAM_TILE_CASES: a block owns a segment and 4 batch rows (V <= 64)
    # or 2 (V <= 128, two label strips), so B = 3 and 5 leave groups part
    # empty, V = 5 and 50 pad the labels, h = 24 and 40 the hidden chunk,
    # and V = 80 at B = 5 launches 81 x 3 = 243 blocks, past the card's 132
    # SMs.
    'fd_ragged_v5': (5, 24, 0, True, 3),
    'fld1_ragged_v50': (50, 64, 1, False, 3),
    'fld2_v64': (64, 512, 2, False, 3),
    'fld2_v5_h24_b5': (5, 24, 2, False, 5),
    'fld2_ragged_v50_h40_b5': (50, 40, 2, False, 5),
    'fd_v64_b5': (64, 128, 0, True, 5),
    'fld1_v80_b5': (80, 64, 1, False, 5),
    'fd_v80_h40': (80, 40, 0, True, 3),
    'fld2_v80_b5': (80, 64, 2, False, 5),
    # Three reductions a frame: grad_kernel's generic pair count.
    'fld3_v64_h128_b5': (64, 128, 3, False, 5),
    # Outside the segment route, on the first design's tile kernels in
    # bfloat16 too: FLD(0), V > 128, a hidden size past a block's shared
    # memory.
    'fld0_v64_b5': (64, 128, 0, False, 5),
    'fld2_v130_h24': (130, 24, 2, False, 3),
    'fld2_v64_h1088': (64, 1088, 2, False, 3),
}
TRIGRAM_TILE_CASES = ('fld0_v64_b5', 'fld2_v130_h24', 'fld2_v64_h1088')
# Rows of the card cases: full, zero cotangent, empty, then (B = 5) a
# padded row with a cotangent and a full one.
TRIGRAM_CARD_LENGTHS = [12, 7, 0, 3, 12]
TRIGRAM_CARD_G = [1.0, 0.0, 1.0, 0.5, 1.0]


def trigram_inputs(seed, vocab, hidden, max_t, lengths, device='cpu'):
  states = contexts.FullNGram(vocab_size=vocab, context_size=2).num_states()
  pf, pc, params, is_pad = random_inputs(seed, vocab, hidden, max_t, lengths,
                                         device, states)
  return pf * 0.5, pc * 0.5, params, is_pad


@pytest.mark.parametrize('frame_dependent', [True, False], ids=['fd', 'fld2'])
def test_plain_trigram_log_partition_padding(frame_dependent):
  lengths = [5, 2, 0]
  pf, pc, params, is_pad = trigram_inputs(7, vocab=3, hidden=5, max_t=5,
                                          lengths=lengths)
  kw = dict(max_expansions=2, frame_dependent=frame_dependent,
            compute_dtype=torch.float32)
  log_z, alpha, hist, slabs = trigram_scan.trigram_forward_plain(
      pf, pc, params, is_pad, with_residuals=True, **kw)
  _, alpha_2, _, _ = trigram_scan.trigram_forward_plain(
      pf[:2].contiguous(), pc, params, is_pad[:2].contiguous(),
      with_residuals=False, **kw)
  # Padding frames hold alpha; the empty row keeps the start state.
  npt.assert_array_equal(alpha[1].numpy(), alpha_2[1].numpy())
  assert log_z[2] == 0.0
  for t in range(2, 5):
    npt.assert_array_equal(hist[t, 1].numpy(), alpha_2[1].numpy())
  if not frame_dependent:
    assert torch.all(slabs[:, 2:, 1] == float('-inf'))
    # No lexical arc enters the start state.
    assert torch.all(slabs[:, :, :, 0] == float('-inf'))

  g = torch.tensor([1.0, 0.5, 1.0])
  grads = trigram_scan.trigram_backward_plain(pf, pc, params, is_pad, log_z,
                                              g, hist, slabs, **kw)
  dpf = grads[0]
  assert torch.all(dpf[2:, 1] == 0) and torch.all(dpf[:, 2] == 0)
  assert torch.all(grads[-1][2] == 0)  # the empty row's beta: semiring one


@pytest.mark.parametrize('frame_dependent', [True, False], ids=['fd', 'fld2'])
def test_plain_trigram_log_partition_matches_generic_route(frame_dependent):
  """The plain versions inside ``log_partition`` against the lattice's
  generic forward-backward (a JointWeightFn subclass keeps it outside the
  gate): log Z and the gradients of the parameters, cache and frames."""

  class SubclassedJoint(weight_fns.JointWeightFn):
    pass

  def make(joint):
    return lattices.RecognitionLattice(
        context=contexts.FullNGram(vocab_size=3, context_size=2),
        alignment=(alignments.FrameDependent() if frame_dependent else
                   alignments.FrameLabelDependent(2)),
        weight_fn_cacher_factory=lambda ctx: weight_fns.SharedEmbCacher(
            num_context_states=ctx.shape()[0], embedding_size=6),
        weight_fn_factory=lambda ctx: joint(vocab_size=3, hidden_size=5))

  plain, generic = make(weight_fns.JointWeightFn), make(SubclassedJoint)
  params = plain.init(torch.Generator().manual_seed(3), feature_size=4,
                      device='cpu')
  frames = torch.from_numpy(np.random.default_rng(3).standard_normal(
      (3, 5, 4)).astype(np.float32))
  num_frames = torch.tensor([5, 2, 0])
  results = []
  for lattice in (plain, generic):
    leaves = [params['weight_fn'][n] for n in sorted(params['weight_fn'])]
    leaves = [x.detach().requires_grad_(True) for x in leaves]
    wf = dict(zip(sorted(params['weight_fn']), leaves))
    cache = lattice.build_cache(params).detach().requires_grad_(True)
    frames_g = frames.clone().requires_grad_(True)
    log_z = lattice.shortest_distance({'cacher': params['cacher'],
                                       'weight_fn': wf}, frames_g,
                                      num_frames, cache=cache)
    (log_z * torch.tensor([1.0, 0.5, 1.0])).sum().backward()
    results.append([log_z] + [x.grad for x in leaves + [cache, frames_g]])
  assert (plain.last_path, generic.last_path) == ('plain', 'generic')
  for got, want in zip(*results):
    npt.assert_allclose(got.detach().numpy(), want.detach().numpy(),
                        rtol=1e-4, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize('compute_dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
@pytest.mark.parametrize('case', sorted(TRIGRAM_CARD_CASES))
def test_trigram_kernels_match_plain_on_card(card, case, compute_dtype):
  vocab, hidden, k, fd, batch = TRIGRAM_CARD_CASES[case]
  pf, pc, params, is_pad = trigram_inputs(
      8, vocab, hidden, max_t=12, lengths=TRIGRAM_CARD_LENGTHS[:batch],
      device=card)
  kw = dict(max_expansions=k, frame_dependent=fd,
            compute_dtype=compute_dtype)
  route = trigram_scan.segment_route(
      batch, vocab, hidden, compute_dtype,
      fused_scan.num_passes(k, fd))
  assert (route is not None) == (compute_dtype == torch.bfloat16 and
                                 case not in TRIGRAM_TILE_CASES)
  before = trigram_scan.forward_launches, trigram_scan.backward_launches
  fwd_k = trigram_scan.trigram_forward(pf, pc, params, is_pad,
                                       with_residuals=True, **kw)
  fwd_p = trigram_scan.trigram_forward_plain(pf, pc, params, is_pad,
                                             with_residuals=True, **kw)
  g = torch.tensor(TRIGRAM_CARD_G[:batch], device=card)  # row 1: zero
  bwd_k = trigram_scan.trigram_backward(pf, pc, params, is_pad, fwd_k[0], g,
                                        fwd_k[2], fwd_k[3], **kw)
  bwd_p = trigram_scan.trigram_backward_plain(pf, pc, params, is_pad,
                                              fwd_p[0], g, fwd_p[2],
                                              fwd_p[3], **kw)
  torch.cuda.synchronize()
  assert (trigram_scan.forward_launches, trigram_scan.backward_launches) == (
      before[0] + 1, before[1] + 1)
  # The bigram kernels' tolerances (test_log_partition_kernels_match_plain
  # _on_card): same rounded inputs, float32 sums in another order.
  bf16 = compute_dtype == torch.bfloat16
  for name, got, want in zip(('log_z', 'alpha', 'hist', 'slabs'), fwd_k,
                             fwd_p):
    if want is not None:
      assert rel_err(got, want) <= (1e-4 if bf16 else 1e-5), name
  names = ('dpf', 'dpc', 'dvw', 'dvb', 'dbw', 'dbb', 'beta_out')
  for name, got, want in zip(names, bwd_k, bwd_p):
    if name == 'beta_out':
      assert rel_err(got, want) <= (1e-4 if bf16 else 1e-5), name
    else:
      err = rel_err(got, want, per_output=True)
      assert err <= (1e-3 if bf16 else 1e-4), name
  assert fwd_k[0][2].item() == 0.0
  dpf = bwd_k[0]  # the zero-cotangent row and the empty row
  assert torch.all(dpf[:, 1] == 0) and torch.all(dpf[:, 2] == 0)
  if batch > 3:  # the padding frames of a row with a cotangent
    assert torch.all(dpf[3:, 3] == 0) and torch.any(dpf[:3, 3] != 0)


# (vocab, hidden, passes) -> whether the bfloat16 segment kernels run the
# call (the library's trigram_segment_smem): FD and FLD(1..8), V <= 128, and
# h up to 1024 with one label strip, 704 with two.
TRIGRAM_SEGMENT_ROUTES = {
    'probe': ((64, 512, 2), True),
    'fd_v5_h24': ((5, 24, 1), True),
    'eight_passes_v128': ((128, 512, 8), True),
    'nine_passes': ((64, 512, 9), False),
    'fld0': ((64, 512, 0), False),
    'v129': ((129, 512, 2), False),
    'h1024': ((64, 1024, 2), True),
    'h1088': ((64, 1088, 2), False),
    'v128_h704': ((128, 704, 2), True),
    'v128_h768': ((128, 768, 2), False),
}


@pytest.mark.cuda
@pytest.mark.parametrize('case', sorted(TRIGRAM_SEGMENT_ROUTES))
def test_trigram_segment_route_on_card(card, case):
  (vocab, hidden, passes), taken = TRIGRAM_SEGMENT_ROUTES[case]
  smem = fused_scan.library().trigram_segment_smem(hidden, vocab, passes)
  assert (smem > 0) == taken and smem <= 232448
  route = trigram_scan.segment_route(8, vocab, hidden, torch.bfloat16,
                                     passes)
  assert (route is not None) == taken


@pytest.mark.cuda
def test_trigram_kernels_give_exact_zeros_on_card(card):
  pf, pc, params, is_pad = trigram_inputs(9, 50, 40, max_t=6,
                                          lengths=[6, 3, 0], device=card)
  kw = dict(max_expansions=2, frame_dependent=False,
            compute_dtype=torch.bfloat16)
  log_z, _, hist, slabs = trigram_scan.trigram_forward(
      pf, pc, params, is_pad, with_residuals=True, **kw)
  grads = trigram_scan.trigram_backward(pf, pc, params, is_pad, log_z,
                                        torch.zeros(3, device=card), hist,
                                        slabs, **kw)
  for x in grads[:-1]:
    assert torch.all(x == 0)
  assert torch.all(grads[-1][2] == 0)
  # A primal-only forward gives the same log Z and alpha.
  primal = trigram_scan.trigram_forward(pf, pc, params, is_pad,
                                        with_residuals=False, **kw)
  assert primal[2] is None and primal[3] is None
  npt.assert_array_equal(primal[0].cpu().numpy(), log_z.cpu().numpy())


def joint_head_inputs(seed, batch, states, hidden, vocab, device='cpu'):
  """Kernel inputs of the joint+head kernels and cotangents of both
  outputs; batch row 1's cotangents are zero."""
  rng = np.random.default_rng(seed)
  tensor = lambda shape, scale=1.0: torch.from_numpy(
      (rng.standard_normal(shape) * scale).astype(np.float32)).to(device)
  inputs = {
      'pc': tensor((states, hidden), 0.5),
      'pf': tensor((batch, hidden), 0.5),
      'vocab_w': tensor((hidden, vocab), hidden**-0.5),
      'blank_w': tensor((hidden,), hidden**-0.5),
      'vocab_b': tensor((vocab,), 0.1),
      'blank_b': torch.tensor(0.3, device=device),
  }
  g_blank, g_lexical = tensor((batch, states)), tensor((batch, states, vocab))
  if batch > 1:
    g_blank[1], g_lexical[1] = 0.0, 0.0
  return inputs, g_blank, g_lexical


JOINT_HEAD_GRADS = ('d_pc', 'd_pf', 'd_vocab_w', 'd_blank_w')


def test_plain_joint_head_backward_is_the_vjp_of_its_forward():
  inputs, g_blank, g_lexical = joint_head_inputs(8, batch=3, states=11,
                                                 hidden=6, vocab=5)
  leaves = {n: x.clone().requires_grad_(True) for n, x in inputs.items()}
  blank, lexical = joint_head.joint_head_forward_plain(
      **leaves, compute_dtype=torch.float32)
  want = torch.autograd.grad(
      (blank * g_blank).sum() + (lexical * g_lexical).sum(),
      [leaves[n] for n in ('pc', 'pf', 'vocab_w', 'blank_w')])
  got = joint_head.joint_head_backward_plain(
      inputs['pc'], inputs['pf'], inputs['vocab_w'], inputs['blank_w'],
      g_blank, g_lexical, compute_dtype=torch.float32)
  for name, g, w in zip(JOINT_HEAD_GRADS, got, want):
    npt.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5, atol=1e-6,
                        err_msg=name)
  assert torch.all(got[1][1] == 0)  # d_pf of the zero-cotangent row


def test_joint_head_wrappers_check_their_inputs():
  inputs, g_blank, g_lexical = joint_head_inputs(8, batch=2, states=4,
                                                 hidden=6, vocab=5)
  with pytest.raises(ValueError, match='compute_dtype'):
    joint_head.joint_head_forward(**inputs, compute_dtype=torch.float16)
  with pytest.raises(ValueError, match='vocab_b'):
    joint_head.joint_head_forward(**dict(inputs, vocab_b=inputs['vocab_b'][1:]),
                                  compute_dtype=torch.float32)
  with pytest.raises(ValueError, match='g_lexical'):
    joint_head.joint_head_backward(
        inputs['pc'], inputs['pf'], inputs['vocab_w'], inputs['blank_w'],
        g_blank, g_lexical.double(), compute_dtype=torch.float32)


JOINT_HEAD_CARD_CASES = {
    # name: (batch, states, vocab, hidden)
    'b1_s1025_v1024': (1, 1025, 1024, 512),
    'b8_s1025_v1024': (8, 1025, 1024, 512),
    'b8_s4161_v64': (8, 4161, 64, 512),
    'b8_s1100_v1000': (8, 1100, 1000, 512),
    'ragged_b3_s77_v37_h40': (3, 77, 37, 40),
    # One row tile over five batch rows (the bfloat16 d_joint product runs
    # over the flattened B S rows).
    'b5_s3_v64_h128': (5, 3, 64, 128),
    # The bfloat16 forward's wgmma product: one 128-label strip half past
    # V=64 at S=4161, and h=40 padded to 64 with V=130 (two strips, scalar
    # stores).
    'b2_s4161_v64_h40': (2, 4161, 64, 40),
    'b3_s1025_v130_h40': (3, 1025, 130, 40),
    # The bfloat16 backward's staging pass without 16-byte loads (V % 4 !=
    # 0) and h off the 64-deep stages.
    'b4_s1025_v1001_h200': (4, 1025, 1001, 200),
    # The float32 FMA tiles: B S not a multiple of the 64-row tile, h off
    # the 16-deep slices and not a multiple of 4, V % 4 != 0 (no 16-byte
    # loads of the cotangent or stores of lex), rows-major.
    'b7_s131_v130_h37': (7, 131, 130, 37),
    # V at the float32 shape selection's threshold (labels-major at V <=
    # 128) and just past it (rows-major), and labels-major with V % 4 != 0
    # and two 64-label tiles.
    'b4_s1025_v128_h200': (4, 1025, 128, 200),
    'b4_s1025_v129_h200': (4, 1025, 129, 200),
    'b2_s300_v127_h70': (2, 300, 127, 70),
}


@pytest.mark.cuda
@pytest.mark.parametrize('compute_dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
@pytest.mark.parametrize('case', sorted(JOINT_HEAD_CARD_CASES))
def test_joint_head_kernels_match_plain_on_card(card, case, compute_dtype):
  batch, states, vocab, hidden = JOINT_HEAD_CARD_CASES[case]
  inputs, g_blank, g_lexical = joint_head_inputs(9, batch, states, hidden,
                                                 vocab, device=card)
  before = (joint_head.forward_launches, joint_head.backward_launches)
  fwd_k = joint_head.joint_head_forward(**inputs, compute_dtype=compute_dtype)
  fwd_p = joint_head.joint_head_forward_plain(**inputs,
                                              compute_dtype=compute_dtype)
  args = [inputs[n] for n in ('pc', 'pf', 'vocab_w', 'blank_w')]
  bwd_k = joint_head.joint_head_backward(*args, g_blank, g_lexical,
                                         compute_dtype=compute_dtype)
  bwd_p = joint_head.joint_head_backward_plain(*args, g_blank, g_lexical,
                                               compute_dtype=compute_dtype)
  torch.cuda.synchronize()
  assert (joint_head.forward_launches, joint_head.backward_launches) == (
      before[0] + 1, before[1] + 1)
  # Same rounded inputs, float32 sums in another order: values to 1e-5
  # (float32) or 1e-4 (bfloat16) of max(|value|, 1); gradients to 1e-4 or
  # 1e-3 of each output's largest entry.
  bf16 = compute_dtype == torch.bfloat16
  for name, got, want in zip(('blank', 'lexical'), fwd_k, fwd_p):
    assert got.is_contiguous() and got.shape == want.shape, name
    assert rel_err(got, want) <= (1e-4 if bf16 else 1e-5), name
  for name, got, want in zip(JOINT_HEAD_GRADS, bwd_k, bwd_p):
    assert rel_err(got, want, per_output=True) <= (1e-3 if bf16 else 1e-4), (
        name)
  if batch > 1:
    assert torch.all(bwd_k[1][1] == 0)  # d_pf of the zero-cotangent row


@pytest.mark.cuda
def test_joint_head_f32_kernels_against_float64_on_card(card):
  """At the MWER step's beta-pass shape (B=8, S=1025, V=1024, h=512), the
  float32 kernel pair's error against the plain versions run in float64 is
  at most twice the float32 plain versions' own error, output by output
  (max |error| over the float64 output's largest entry)."""
  inputs, g_blank, g_lexical = joint_head_inputs(12, 8, 1025, 512, 1024,
                                                 device=card)
  args = [inputs[n] for n in ('pc', 'pf', 'vocab_w', 'blank_w')]
  f32 = dict(compute_dtype=torch.float32)
  kernel = (joint_head.joint_head_forward(**inputs, **f32) +
            joint_head.joint_head_backward(*args, g_blank, g_lexical, **f32))
  plain = (joint_head.joint_head_forward_plain(**inputs, **f32) +
           joint_head.joint_head_backward_plain(*args, g_blank, g_lexical,
                                                **f32))
  wide = lambda xs: [x.double() for x in xs]
  exact = (joint_head.joint_head_forward_plain(
      **{n: x.double() for n, x in inputs.items()}, **f32) +
           joint_head.joint_head_backward_plain(
               *wide(args), *wide((g_blank, g_lexical)), **f32))
  torch.cuda.synchronize()
  for name, k, p, x in zip(('blank', 'lexical') + JOINT_HEAD_GRADS, kernel,
                           plain, exact):
    scale = x.abs().max()
    kernel_err = ((k.double() - x).abs().max() / scale).item()
    plain_err = ((p.double() - x).abs().max() / scale).item()
    assert kernel_err <= 2 * plain_err, (name, kernel_err, plain_err)


@pytest.mark.cuda
def test_joint_head_autograd_matches_plain_on_card(card):
  """blank_lexical's Function through the kernels against the same
  Function through the plain versions (``joint_head.using``)."""
  inputs, g_blank, g_lexical = joint_head_inputs(10, batch=4, states=1025,
                                                 hidden=64, vocab=100,
                                                 device=card)
  wf = weight_fns.JointWeightFn(vocab_size=100, hidden_size=64,
                                compute_dtype=torch.bfloat16)
  cache = inputs['pc']
  params = wf.init(torch.Generator().manual_seed(0), cache, inputs['pf'])
  assert joint_head.supported(wf, cache, inputs['pf'], None)

  def run():
    leaves = {n: x.detach().requires_grad_(True) for n, x in params.items()}
    blank, lexical = wf.apply(leaves, cache, inputs['pf'])
    ((blank * g_blank).sum() + (lexical * g_lexical).sum()).backward()
    return (blank, lexical), {n: x.grad for n, x in leaves.items()}

  before = (joint_head.forward_launches, joint_head.backward_launches)
  got_values, got = run()
  assert (joint_head.forward_launches, joint_head.backward_launches) == (
      before[0] + 1, before[1] + 1)
  with joint_head.using(joint_head.joint_head_forward_plain,
                        joint_head.joint_head_backward_plain):
    want_values, want = run()
  assert (joint_head.forward_launches, joint_head.backward_launches) == (
      before[0] + 1, before[1] + 1)
  for got_x, want_x in zip(got_values, want_values):
    assert rel_err(got_x, want_x) <= 1e-4
  for name in want:
    a, b = got[name].double(), want[name].double()
    # The projections' gradients leave through _mm's bfloat16 rounding of
    # their inputs, which rounds them too: one bfloat16 step of each entry
    # (at most 2**-7 of it) on top.
    step = 2.0**-7 * b.abs() if name.endswith('_proj') else 0.0
    assert bool(((a - b).abs() <= 1e-3 * b.abs().max() + step).all()), name


def frame_reduce_inputs(seed, batch, states, hidden, vocab, device='cpu'):
  """Kernel inputs of one frame's reduction and cotangents of both outputs:
  the last quarter of the states are dead (-inf in vec, as under
  FrameLabelDependent) and batch row 1 is dead at every state, so its
  reduction is -inf."""
  rng = np.random.default_rng(seed)
  tensor = lambda shape, scale=1.0: torch.from_numpy(
      (rng.standard_normal(shape) * scale).astype(np.float32)).to(device)
  vec = tensor((batch, states), 3.0)
  vec[:, states - states // 4:] = float('-inf')
  if batch > 1:
    vec[1] = float('-inf')
  inputs = {
      'vec': vec,
      'pf_t': tensor((batch, hidden), 0.5),
      'pc': tensor((states, hidden), 0.5),
      'vw': tensor((hidden, vocab), hidden**-0.5),
      'vb': tensor((vocab,), 0.1),
      'bw': tensor((hidden,), hidden**-0.5),
      'bb': torch.tensor(0.3, device=device),
  }
  return inputs, tensor((batch, vocab)), tensor((batch, states))


FRAME_REDUCE_GRADS = ('d_vec', 'd_pf', 'd_pc', 'd_vw', 'd_vb', 'd_bw', 'd_bb')


def test_plain_frame_reduce_backward_is_the_vjp_of_its_forward():
  inputs, d_red, d_blank = frame_reduce_inputs(11, batch=3, states=13,
                                               hidden=6, vocab=5)
  inputs['vec'][1, 0] = 0.0  # autograd's logsumexp is NaN on a dead row
  leaves = {n: x.double().requires_grad_(True) for n, x in inputs.items()}
  red, blank = sharded_scan.frame_reduce_plain(**leaves,
                                               compute_dtype=torch.float32)
  want = torch.autograd.grad(
      (red * d_red).sum() + (blank * d_blank).sum(), list(leaves.values()))
  args = [leaves[n].detach() for n in ('vec', 'pf_t', 'pc', 'vw', 'vb', 'bw')]
  got = sharded_scan.frame_reduce_backward_plain(
      *args, red.detach(), d_red.double(), d_blank.double(),
      compute_dtype=torch.float32)
  for name, g, w in zip(FRAME_REDUCE_GRADS, got, want):
    npt.assert_allclose(g.numpy(), w.numpy(), rtol=1e-10, atol=1e-12,
                        err_msg=name)
  assert torch.all(got[0][:, 10:] == 0)  # d_vec at the dead states


def test_frame_reduce_wrappers_check_their_inputs():
  inputs, d_red, d_blank = frame_reduce_inputs(12, batch=2, states=4,
                                               hidden=6, vocab=5)
  with pytest.raises(ValueError, match='compute_dtype'):
    sharded_scan.frame_reduce_forward(**inputs, compute_dtype=torch.float16)
  with pytest.raises(ValueError, match='vb'):
    sharded_scan.frame_reduce_forward(**dict(inputs, vb=inputs['vb'][1:]),
                                      compute_dtype=torch.float32)
  with pytest.raises(ValueError, match='contiguous'):
    sharded_scan.frame_reduce_forward(
        **dict(inputs, vw=inputs['vw'].t().contiguous().t()),
        compute_dtype=torch.float32)
  red, _ = sharded_scan.frame_reduce_forward(**inputs,
                                             compute_dtype=torch.float32)
  args = [inputs[n] for n in ('vec', 'pf_t', 'pc', 'vw', 'vb', 'bw')]
  with pytest.raises(ValueError, match='d_blank'):
    sharded_scan.frame_reduce_backward(*args, red, d_red, d_blank[:, 1:],
                                       compute_dtype=torch.float32)


FRAME_REDUCE_CARD_CASES = {
    # name: (batch, states, vocab, hidden)
    'b3_s1025_v96': (3, 1025, 96, 512),
    'b3_s1025_v1024': (3, 1025, 1024, 512),
    'b8_s1025_v1024': (8, 1025, 1024, 512),
    'b8_s1025_v256': (8, 1025, 256, 512),
    # The bfloat16 backward's wgmma tiles past a ragged Vl (padded to 256)
    # at h=384.
    'b4_s1025_v200_h384': (4, 1025, 200, 384),
    # h and V not multiples of 4: bfloat16 staged without 16-byte loads.
    'ragged_b5_s77_v37_h42': (5, 77, 37, 42),
    # The bfloat16 forward's column reduction at ragged shapes.
    'b3_s77_v520_h80': (3, 77, 520, 80),
    'b4_s1025_v1021_h80': (4, 1025, 1021, 80),
}


def frame_reduce_pair(inputs, d_red, d_blank, compute_dtype, forward,
                      backward):
  """(red, blank) and the seven gradients through the given pair."""
  red, blank = forward(**inputs, compute_dtype=compute_dtype)
  args = [inputs[n] for n in ('vec', 'pf_t', 'pc', 'vw', 'vb', 'bw')]
  grads = backward(*args, red, d_red, d_blank, compute_dtype=compute_dtype)
  return (red, blank), grads


@pytest.mark.cuda
@pytest.mark.parametrize('compute_dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
@pytest.mark.parametrize('case', sorted(FRAME_REDUCE_CARD_CASES))
def test_frame_reduce_kernels_match_plain_on_card(card, case, compute_dtype):
  batch, states, vocab, hidden = FRAME_REDUCE_CARD_CASES[case]
  inputs, d_red, d_blank = frame_reduce_inputs(13, batch, states, hidden,
                                               vocab, device=card)
  before = (sharded_scan.forward_launches, sharded_scan.backward_launches)
  values_k, grads_k = frame_reduce_pair(
      inputs, d_red, d_blank, compute_dtype,
      sharded_scan.frame_reduce_forward, sharded_scan.frame_reduce_backward)
  values_p, grads_p = frame_reduce_pair(
      inputs, d_red, d_blank, compute_dtype,
      sharded_scan.frame_reduce_plain,
      sharded_scan.frame_reduce_backward_plain)
  torch.cuda.synchronize()
  assert (sharded_scan.forward_launches, sharded_scan.backward_launches) == (
      before[0] + 1, before[1] + 1)
  # Same rounded inputs, float32 sums in another order: values to 1e-5
  # (float32) or 1e-4 (bfloat16) of max(|value|, 1); gradients to 1e-4 or
  # 1e-3 of each output's largest entry.
  bf16 = compute_dtype == torch.bfloat16
  for name, got, want in zip(('red', 'blank'), values_k, values_p):
    assert got.shape == want.shape, name
    assert rel_err(got, want) <= (1e-4 if bf16 else 1e-5), name
  assert bool(torch.isneginf(values_k[0][1]).all())  # the dead row
  for name, got, want in zip(FRAME_REDUCE_GRADS, grads_k, grads_p):
    assert got.shape == want.shape, name
    assert rel_err(got, want, per_output=True) <= (1e-3 if bf16 else 1e-4), (
        name)
  dead = torch.isneginf(inputs['vec'])
  assert bool((grads_k[0][dead] == 0).all())  # d_vec, never NaN


@pytest.mark.cuda
@pytest.mark.parametrize('compute_dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
def test_frame_reduce_shards_reproduce_the_whole_head_on_card(card,
                                                              compute_dtype):
  """Four vocab shards in one process: their reductions concatenated are
  the whole head's, and their gradients (the blank cotangent given to one
  shard, the shared gradients summed, the head's concatenated) the whole
  head's."""
  inputs, d_red, d_blank = frame_reduce_inputs(14, 8, 1025, 512, 1024,
                                               device=card)
  whole_values, whole_grads = frame_reduce_pair(
      inputs, d_red, d_blank, compute_dtype,
      sharded_scan.frame_reduce_forward, sharded_scan.frame_reduce_backward)
  reds, grads = [], []
  for r in range(4):
    cols = slice(r * 256, (r + 1) * 256)
    shard = dict(inputs, vw=inputs['vw'][:, cols].contiguous(),
                 vb=inputs['vb'][cols].contiguous())
    (red, _), g = frame_reduce_pair(
        shard, d_red[:, cols].contiguous(),
        d_blank if r == 0 else torch.zeros_like(d_blank), compute_dtype,
        sharded_scan.frame_reduce_forward, sharded_scan.frame_reduce_backward)
    reds.append(red)
    grads.append(g)
  torch.cuda.synchronize()
  bf16 = compute_dtype == torch.bfloat16
  assert rel_err(torch.cat(reds, 1), whole_values[0]) <= (
      1e-4 if bf16 else 1e-5)
  shared = [sum(g[i] for g in grads) for i in (0, 1, 2, 5, 6)]
  sharded = [torch.cat([g[3] for g in grads], 1),
             torch.cat([g[4] for g in grads], 0)]
  got = dict(zip(('d_vec', 'd_pf', 'd_pc', 'd_bw', 'd_bb', 'd_vw', 'd_vb'),
                 shared + sharded))
  for name, want in zip(FRAME_REDUCE_GRADS, whole_grads):
    assert rel_err(got[name], want, per_output=True) <= (
        1e-3 if bf16 else 1e-4), name


@pytest.mark.cuda
def test_wgmma_backwards_launch_on_every_card(card):
  """The wgmma kernels raise their shared-memory limit on each device (the
  attribute holds only for the device that is current when it is set):
  both bfloat16 backwards launch on two cards in one process, the second
  after the first, and agree with their plain versions on each."""
  if torch.cuda.device_count() < 2:
    pytest.skip('needs two NVIDIA GPUs')
  bf16 = torch.bfloat16
  for index in (0, 1, 0):
    device = torch.device('cuda', index)
    lengths, g = card_rows(3, device)
    pf, pc, params, is_pad = fused_inputs(2, 520, 512, CARD_MAX_T, lengths,
                                          device=device)
    kw = dict(max_expansions=2, frame_dependent=False, compute_dtype=bf16)
    log_z, _, hist, slabs = fused_scan.fused_forward_plain(
        pf, pc, params, is_pad, with_residuals=True, **kw)
    got = fused_scan.fused_backward(pf, pc, params, is_pad, log_z, g, hist,
                                    slabs, **kw)
    want = fused_scan.fused_backward_plain(pf, pc, params, is_pad, log_z, g,
                                           hist, slabs, **kw)
    for name, a, b in zip(('dpf', 'dpc', 'dvw', 'dvb', 'dbw', 'dbb'), got,
                          want):
      assert a.device == device, name
      assert rel_err(a, b, per_output=True) <= 1e-3, (index, name)
    inputs, d_red, d_blank = frame_reduce_inputs(13, 3, 1025, 512, 200,
                                                 device=device)
    _, grads_k = frame_reduce_pair(
        inputs, d_red, d_blank, bf16, sharded_scan.frame_reduce_forward,
        sharded_scan.frame_reduce_backward)
    _, grads_p = frame_reduce_pair(
        inputs, d_red, d_blank, bf16, sharded_scan.frame_reduce_plain,
        sharded_scan.frame_reduce_backward_plain)
    for name, a, b in zip(FRAME_REDUCE_GRADS, grads_k, grads_p):
      assert rel_err(a, b, per_output=True) <= 1e-3, (index, name)


@pytest.mark.cuda
@pytest.mark.parametrize('compute_dtype', [None, torch.bfloat16],
                         ids=['f32', 'bf16'])
def test_sampler_kernel_route_matches_plain_on_card(card, compute_dtype):
  """``sample_paths`` at 1025 states on the card: its beta pass runs the
  joint+head kernels (forward, its recompute and backward, counted); on
  the paths it drew, the beta pass and the scoring through the joint+head
  plain versions give the same log_prob and gradients."""
  lattice = lattices.RecognitionLattice(
      context=contexts.FullNGram(vocab_size=1024, context_size=1),
      alignment=alignments.FrameLabelDependent(2),
      weight_fn_cacher_factory=lambda ctx: weight_fns.SharedEmbCacher(
          num_context_states=ctx.shape()[0], embedding_size=64),
      weight_fn_factory=lambda ctx: weight_fns.JointWeightFn(
          vocab_size=ctx.shape()[1], hidden_size=128,
          compute_dtype=compute_dtype))
  params = lattice.init(torch.Generator().manual_seed(0), feature_size=32,
                        device=card)
  leaves = [params['cacher']['embedding']] + list(
      params['weight_fn'].values())
  for leaf in leaves:
    leaf.requires_grad_(True)
  frames = torch.randn((3, 12, 32), generator=torch.Generator().manual_seed(
      1)).to(card)
  num_frames = torch.tensor([12, 7, 0], device=card)
  before = joint_head.forward_launches, joint_head.backward_launches
  labels, _, log_prob = lattice.sample_paths(
      params, frames, num_frames,
      torch.Generator(device=card).manual_seed(2), num_samples=3)
  log_prob.sum().backward()
  assert joint_head.forward_launches - before[0] == 2 * 12
  assert joint_head.backward_launches - before[1] == 12
  assert int(labels.min()) >= 0 and int(labels.max()) <= 1024
  grads = [leaf.grad.clone() for leaf in leaves]
  for leaf in leaves:
    leaf.grad = None
  with joint_head.using(joint_head.joint_head_forward_plain,
                        joint_head.joint_head_backward_plain):
    cache = lattice.build_cache(params)
    log_z, _, _ = lattice._sample_betas(params, cache, frames, num_frames)
    plain = lattice._score_paths(params, cache, frames, num_frames,
                                 labels) - log_z[:, None]
    plain.sum().backward()
  assert joint_head.forward_launches - before[0] == 2 * 12
  bf16 = compute_dtype == torch.bfloat16
  assert rel_err(log_prob.detach(), plain.detach()) <= (1e-4 if bf16 else
                                                        1e-5)
  assert bool((log_prob <= 1e-3).all())
  # blank_b's gradient is a structural zero under FrameLabelDependent
  # (one blank arc a frame on every path): judge each gradient against the
  # largest one.
  largest = max(leaf.grad.abs().max().item() for leaf in leaves)
  for leaf, got in zip(leaves, grads):
    assert (got - leaf.grad).abs().max().item() <= largest * (
        1e-3 if bf16 else 1e-4)


@pytest.mark.cuda
def test_risk_loss_beta_pass_runs_forward_only_on_card(card):
  """``sampled_risk_loss`` at 1025 states on the card: its beta pass runs
  the joint+head forward once a frame and no backward (log Z's gradient is
  zero under both estimators); its gradients equal those of the same loss
  with the beta pass differentiated (forward, recompute and backward)."""
  lattice = lattices.RecognitionLattice(
      context=contexts.FullNGram(vocab_size=1024, context_size=1),
      alignment=alignments.FrameLabelDependent(2),
      weight_fn_cacher_factory=lambda ctx: weight_fns.SharedEmbCacher(
          num_context_states=ctx.shape()[0], embedding_size=64),
      weight_fn_factory=lambda ctx: weight_fns.JointWeightFn(
          vocab_size=ctx.shape()[1], hidden_size=128))
  params = lattice.init(torch.Generator().manual_seed(0), feature_size=32,
                        device=card)
  leaves = [params['cacher']['embedding']] + list(
      params['weight_fn'].values())
  for leaf in leaves:
    leaf.requires_grad_(True)
  frames = torch.randn((3, 12, 32), generator=torch.Generator().manual_seed(
      1)).to(card)
  num_frames = torch.tensor([12, 7, 0], device=card)
  labels = torch.tensor([[1, 2, 3], [4, 5, 0], [6, 0, 0]], device=card)
  num_labels = torch.tensor([3, 2, 1], device=card)

  # Random weights emit a label nearly every slot, so every sample's edit
  # distance is alike, and their log-probabilities lie far apart, which
  # saturates the 'mwer' softmax: 'reinforce' with a risk of the labels
  # themselves gives a gradient to compare.
  label_sum = lambda hyp, num_hyp, ref, num_ref: hyp.float().sum(-1) / 1024

  def gradients():
    before = joint_head.forward_launches, joint_head.backward_launches
    loss, _ = risk.sampled_risk_loss(
        lattice, params, frames, num_frames, labels, num_labels,
        torch.Generator(device=card).manual_seed(2), num_samples=3,
        estimator='reinforce', risk_fn=label_sum)
    grads = torch.autograd.grad(loss.sum(), leaves)
    return grads, (joint_head.forward_launches - before[0],
                   joint_head.backward_launches - before[1])

  got, launched = gradients()
  assert launched == (12, 0)
  sample_paths = lattice._sample_paths
  lattice._sample_paths = lambda *args, log_z_grad: sample_paths(*args)
  want, launched = gradients()
  assert launched == (24, 12)
  largest = max(w.abs().max().item() for w in want)
  assert largest > 1e-3
  for g, w in zip(got, want):
    assert (g - w).abs().max().item() <= 1e-5 * largest


def rel_attention_inputs(lengths, max_t, device, seed=0):
  """q, k, v as head views of one [B, T, 3d] projection (8 heads of 64,
  the Conformer (L) widths), positions [2T - 1, d], u and v, lengths."""
  g = torch.Generator(device).manual_seed(seed)
  heads, head_dim = 8, 64
  d = heads * head_dim
  qkv = torch.randn((len(lengths), max_t, 3 * d), device=device, generator=g)
  q, k, v = (z.reshape(len(lengths), max_t, heads, head_dim)
             for z in qkv.split(d, dim=-1))
  pos = torch.randn((2 * max_t - 1, d), device=device, generator=g)
  u = 0.1 * torch.randn((heads, head_dim), device=device, generator=g)
  vb = 0.1 * torch.randn((heads, head_dim), device=device, generator=g)
  return q, k, v, pos, u, vb, torch.tensor(lengths, device=device)


@pytest.mark.cuda
def test_rel_attention_kernel_matches_plain_on_card(card):
  """16 rows at the Conformer cell's T'=799 with ragged lengths, T'=1 and
  T'=799 among them; the kernel allocates its output alone (no [B, H, T,
  T] or [B, H, T, 2T - 1] buffer)."""
  from last_torch_tpu_torch.ops import rel_attention
  lengths = [1, 799, 2, 64, 65, 128, 500, 300, 799, 17, 63, 700, 256, 1,
             400, 798]
  args = rel_attention_inputs(lengths, 799, card)
  torch.cuda.synchronize()
  before, launched = torch.cuda.memory_allocated(), rel_attention.launches
  torch.cuda.reset_peak_memory_stats()
  got = rel_attention.rel_attention(*args)
  torch.cuda.synchronize()
  extra = torch.cuda.max_memory_allocated() - before
  assert rel_attention.launches == launched + 1
  assert extra <= 2 * got.numel() * got.element_size()
  want = rel_attention.rel_attention_plain(*args)
  # Float32 both ways, the 64-deep products and the softmax over up to 799
  # keys summed in other orders: ~3e-6 of outputs of size ~3 (2.6e-6 on an
  # H100 80GB HBM3).
  torch.testing.assert_close(got, want, atol=2e-5, rtol=1e-5)
  for row, n in enumerate(lengths):
    assert torch.all(got[row, n:] == 0)


@pytest.mark.cuda
def test_conformer_decode_launches_rel_attention_each_block_on_card(card):
  from last_torch_tpu_torch.models import gnat, presets
  from last_torch_tpu_torch.ops import rel_attention
  model = gnat.GNATModel(presets.conformer_l_gnat(), device=card)
  params = model.init(torch.Generator().manual_seed(0))
  frames = torch.randn((2, 800, 80), device=card)
  num_frames = torch.tensor([800, 401], device=card)
  launched, decoded = rel_attention.launches, viterbi.launches
  labels, num_labels, _ = model.decode(params, frames, num_frames)
  assert rel_attention.launches - launched >= 17
  assert viterbi.launches == decoded + 1
  assert model.lattice.last_path == 'kernel'
  assert num_labels.tolist() == [3 * 199, 3 * 99]
