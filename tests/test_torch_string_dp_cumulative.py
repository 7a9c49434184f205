"""The port's closed-form string DP (``lattices.STRING_DP_CUMULATIVE``)
against the JAX package's closed form and against the port's own scan.

Every case of ``test_string_dp_cumulative.py``, on the same numpy inputs:
values and gradients for FrameDependent and FrameLabelDependent(1, 2, 3),
an infeasible string exactly -inf, no NaN gradient on infeasible rows, zero
gradients on padding, the relay contract (``alpha0`` / ``t_offset`` /
``final_gather``), the full loss (S = 1 and the bigram), a single frame and
a single position, and the non-Log semirings keeping the scan. JAX's flag is
set with ``monkeypatch`` on its module, the port's likewise. Tolerances are
JAX's own test's: values rtol 1e-5 / atol 1e-5, gradients rtol 1e-4 / atol
1e-5 (the loss's gradients 1e-4 of the largest), float32 on both sides.

The drift test runs B=2, T=1600, U=100, FrameLabelDependent(2) in float32
on HAT-like weights (the scale of a randomly initialised ``hat_bigram``'s
normalized weights at V=1024) and holds the port's closed form to at most
twice the JAX closed form's distance from a float64 scan, and the port's
scan to twice JAX's scan's: the loss relative, the gradients as a share of
the largest. ``DRIFT_LIMITS`` (twice the JAX distances this test measures)
are the limits of ``chip_smoke.py``'s ``[string-dp]`` phase. The port's
closed form computes in float64 and rounds its result to float32, so its
distance is little more than that rounding's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

import last_torch_tpu
from last_torch_tpu import alignments as jax_alignments
from last_torch_tpu import contexts as jax_contexts
from last_torch_tpu import lattices as jax_lattices
from last_torch_tpu import semirings as jax_semirings
from last_torch_tpu import weight_fns as jax_weight_fns
import last_torch_tpu_torch
from last_torch_tpu_torch import (alignments, contexts, convert, lattices,
                                  semirings, weight_fns)

torch.set_num_threads(1)
torch.set_float32_matmul_precision('highest')

VOCAB, HIDDEN, EMB = 6, 32, 8
B, T, U = 3, 11, 4
NUM_FRAMES = np.array([T, T - 5, 0], np.int32)
NUM_LABELS = np.array([U, U - 2, 0], np.int32)
# name: (JAX alignment, the port's).
ALIGNMENTS = {
    'fd': (jax_alignments.FrameDependent, alignments.FrameDependent),
    'fld1': (lambda: jax_alignments.FrameLabelDependent(1),
             lambda: alignments.FrameLabelDependent(1)),
    'fld2': (lambda: jax_alignments.FrameLabelDependent(2),
             lambda: alignments.FrameLabelDependent(2)),
    'fld3': (lambda: jax_alignments.FrameLabelDependent(3),
             lambda: alignments.FrameLabelDependent(3)),
}
# The drift shape, and chip_smoke.py's limits for it, per route: twice the
# JAX package's distance from a float64 scan that test_drift_at_t1600
# measures on the same route (closed form: loss relative 9.150e-08,
# gradients 8.312e-05 of the largest; scan: 8.951e-07 and 1.286e-04). The
# float32 scan drifts more than the closed form, so each route is held to
# JAX's own.
DRIFT_B, DRIFT_T, DRIFT_U = 2, 1600, 100
DRIFT_LIMITS = {'closed_form': {'loss': 1.84e-07, 'grads': 1.67e-04},
                'scan': {'loss': 1.80e-06, 'grads': 2.58e-04}}


def named(tree, prefix=''):
  """{'cacher/embedding': leaf, ...} of a tree of dicts."""
  if isinstance(tree, dict):
    out = {}
    for key, value in tree.items():
      out.update(named(value, f'{prefix}{key}/'))
    return out
  return {prefix[:-1]: tree}


def make_lattices(alignment='fld2', context_size=1):
  jax_alignment, port_alignment = ALIGNMENTS[alignment]
  jax_lattice = last_torch_tpu.RecognitionLattice(
      context=jax_contexts.FullNGram(vocab_size=VOCAB,
                                     context_size=context_size),
      alignment=jax_alignment(),
      weight_fn_cacher_factory=lambda ctx: jax_weight_fns.SharedEmbCacher(
          num_context_states=ctx.shape()[0], embedding_size=EMB),
      weight_fn_factory=lambda ctx: jax_weight_fns.JointWeightFn(
          vocab_size=VOCAB, hidden_size=HIDDEN),
      fused='never')
  port_lattice = last_torch_tpu_torch.RecognitionLattice(
      context=contexts.FullNGram(vocab_size=VOCAB,
                                 context_size=context_size),
      alignment=port_alignment(),
      weight_fn_cacher_factory=lambda ctx: weight_fns.SharedEmbCacher(
          num_context_states=ctx.shape()[0], embedding_size=EMB),
      weight_fn_factory=lambda ctx: weight_fns.JointWeightFn(
          vocab_size=VOCAB, hidden_size=HIDDEN))
  return jax_lattice, port_lattice


@pytest.fixture
def weights():
  rng = np.random.default_rng(0)
  bw = rng.normal(size=(T, B, U + 1)).astype(np.float32)
  lw = rng.normal(size=(T, B, U + 1)).astype(np.float32)
  return bw, lw


def jax_dp(monkeypatch, lattice, cumulative, bw, lw, num_frames, num_labels,
           semiring=jax_semirings.Log, **kwargs):
  monkeypatch.setattr(jax_lattices, 'STRING_DP_CUMULATIVE', cumulative)
  try:
    return lattice._string_dp(bw, lw, jnp.asarray(num_frames),
                              jnp.asarray(num_labels), semiring, **kwargs)
  finally:
    monkeypatch.setattr(jax_lattices, 'STRING_DP_CUMULATIVE', False)


def port_dp(monkeypatch, lattice, cumulative, bw, lw, num_frames,
            num_labels, semiring=semirings.Log, **kwargs):
  monkeypatch.setattr(lattices, 'STRING_DP_CUMULATIVE', cumulative)
  try:
    return lattice._string_dp(bw, lw, torch.as_tensor(num_frames),
                              torch.as_tensor(num_labels), semiring,
                              **kwargs)
  finally:
    monkeypatch.setattr(lattices, 'STRING_DP_CUMULATIVE', False)


def jax_value_and_grads(monkeypatch, lattice, bw, lw, num_frames,
                        num_labels, finite_only=False, cumulative=True):
  def total(b, l):
    d = jax_dp(monkeypatch, lattice, cumulative, b, l, num_frames,
               num_labels)
    if finite_only:
      d = jnp.where(jnp.isfinite(d), d, 0.0)
    return jnp.sum(d)

  value, grads = jax.value_and_grad(total, argnums=(0, 1))(
      jnp.asarray(bw), jnp.asarray(lw))
  return float(value), [np.asarray(g) for g in grads]


def port_value_and_grads(monkeypatch, lattice, cumulative, bw, lw,
                         num_frames, num_labels, finite_only=False):
  b = torch.tensor(bw, requires_grad=True)
  l = torch.tensor(lw, requires_grad=True)
  d = port_dp(monkeypatch, lattice, cumulative, b, l, num_frames,
              num_labels)
  if finite_only:
    d = torch.where(torch.isfinite(d), d, 0.0)
  d.sum().backward()
  # A DP of one label position reads no lexical weight.
  return float(d.detach().sum()), [
      np.zeros_like(w) if x.grad is None else x.grad.numpy()
      for x, w in ((b, bw), (l, lw))]


@pytest.mark.parametrize('alignment', list(ALIGNMENTS))
def test_values_and_grads_match_jax_and_scan(monkeypatch, weights,
                                             alignment):
  bw, lw = weights
  jax_lattice, port_lattice = make_lattices(alignment)
  want, want_grads = jax_value_and_grads(monkeypatch, jax_lattice, bw, lw,
                                         NUM_FRAMES, NUM_LABELS)
  got, got_grads = port_value_and_grads(monkeypatch, port_lattice, True, bw,
                                        lw, NUM_FRAMES, NUM_LABELS)
  scan, scan_grads = port_value_and_grads(monkeypatch, port_lattice, False,
                                          bw, lw, NUM_FRAMES, NUM_LABELS)
  for reference, reference_grads in ((want, want_grads),
                                     (scan, scan_grads)):
    npt.assert_allclose(got, reference, rtol=1e-5, atol=1e-5)
    for g, r in zip(got_grads, reference_grads):
      npt.assert_allclose(g, r, rtol=1e-4, atol=1e-5)


def test_route_is_the_closed_form(monkeypatch, weights):
  """The flag sends the Log DP to ``_string_dp_alpha_cumulative`` and
  nothing else; off (the default) keeps the scan."""
  assert lattices.STRING_DP_CUMULATIVE is False
  bw, lw = map(torch.from_numpy, weights)
  _, port_lattice = make_lattices()
  calls = []
  original = port_lattice._string_dp_alpha_cumulative
  monkeypatch.setattr(port_lattice, '_string_dp_alpha_cumulative',
                      lambda *a: calls.append(1) or original(*a))
  port_dp(monkeypatch, port_lattice, False, bw, lw, NUM_FRAMES, NUM_LABELS)
  assert not calls
  port_dp(monkeypatch, port_lattice, True, bw, lw, NUM_FRAMES, NUM_LABELS)
  assert calls == [1]
  port_dp(monkeypatch, port_lattice, True, bw.double(), lw.double(),
          NUM_FRAMES, NUM_LABELS)
  port_dp(monkeypatch, port_lattice, True, bw, lw, NUM_FRAMES, NUM_LABELS,
          weight_lift=lambda w: w)
  port_dp(monkeypatch, port_lattice, True, bw[:0], lw[:0], NUM_FRAMES,
          NUM_LABELS)
  assert calls == [1]


def test_infeasible_is_exactly_minus_inf(monkeypatch, weights):
  """More labels than k * frames allow: both routes and JAX's closed form
  give exactly -inf."""
  bw, lw = weights
  jax_lattice, port_lattice = make_lattices()  # k=2
  num_frames = np.array([1, 1, 0], np.int32)
  num_labels = np.array([4, 3, 1], np.int32)  # all infeasible
  d = jax_dp(monkeypatch, jax_lattice, True, jnp.asarray(bw),
             jnp.asarray(lw), num_frames, num_labels)
  assert np.all(np.isneginf(np.asarray(d)))
  for cumulative in (False, True):
    d = port_dp(monkeypatch, port_lattice, cumulative,
                torch.from_numpy(bw), torch.from_numpy(lw), num_frames,
                num_labels)
    assert bool(torch.isneginf(d).all()), (cumulative, d)


def test_grads_have_no_nans_on_infeasible(monkeypatch, weights):
  bw, lw = weights
  jax_lattice, port_lattice = make_lattices()
  num_frames = np.array([1, 1, 0], np.int32)
  num_labels = np.array([4, 3, 1], np.int32)
  _, want = jax_value_and_grads(monkeypatch, jax_lattice, bw, lw,
                                num_frames, num_labels, finite_only=True)
  _, got = port_value_and_grads(monkeypatch, port_lattice, True, bw, lw,
                                num_frames, num_labels, finite_only=True)
  for g, w in zip(got, want):
    assert np.isfinite(g).all()
    npt.assert_array_equal(g, w)


def test_padding_gradients_are_zero(monkeypatch, weights):
  bw, lw = weights
  _, port_lattice = make_lattices()
  _, (gb, gl) = port_value_and_grads(monkeypatch, port_lattice, True, bw, lw,
                                     NUM_FRAMES, NUM_LABELS)
  # Row 1 has T-5 frames; weights at t >= T-5 are padding.
  assert np.abs(gb[T - 5:, 1]).max() == 0.0
  assert np.abs(gl[T - 5:, 1]).max() == 0.0
  # Row 2 has no frame.
  assert np.abs(gb[:, 2]).max() == 0.0
  assert np.abs(gl[:, 2]).max() == 0.0
  # And the cotangent of the carry reaches no padded entry either.
  assert np.abs(gb[:T - 5, 1]).max() > 0.0


def test_relay_contract_alpha0_t_offset(monkeypatch, weights):
  """Two chained half-blocks equal the whole DP, and JAX's chain, with the
  flag on (and the port's scan chain too)."""
  bw, lw = weights
  jax_lattice, port_lattice = make_lattices()
  cut = T // 2

  def chained(dp, lattice, cumulative, to):
    alpha_mid = dp(monkeypatch, lattice, cumulative, to(bw[:cut]),
                   to(lw[:cut]), NUM_FRAMES, NUM_LABELS, final_gather=False)
    assert tuple(alpha_mid.shape) == (B, U + 1)
    return np.asarray(dp(monkeypatch, lattice, cumulative, to(bw[cut:]),
                         to(lw[cut:]), NUM_FRAMES, NUM_LABELS,
                         alpha0=alpha_mid, t_offset=cut))

  whole = port_dp(monkeypatch, port_lattice, True, torch.from_numpy(bw),
                  torch.from_numpy(lw), NUM_FRAMES, NUM_LABELS).numpy()
  jax_chain = chained(jax_dp, jax_lattice, True, jnp.asarray)
  for got in (chained(port_dp, port_lattice, True, torch.from_numpy),
              chained(port_dp, port_lattice, False, torch.from_numpy)):
    npt.assert_allclose(got, whole, rtol=1e-5, atol=1e-5)
    npt.assert_allclose(got, jax_chain, rtol=1e-5, atol=1e-5)


def test_relay_block_gradients_match_jax(monkeypatch, weights):
  """The second block's gradients, alpha0's included (an -inf entry of the
  carry gets none), against JAX's closed form."""
  bw, lw = weights
  jax_lattice, port_lattice = make_lattices()
  cut = T // 2
  alpha_mid = np.asarray(jax_dp(
      monkeypatch, jax_lattice, True, jnp.asarray(bw[:cut]),
      jnp.asarray(lw[:cut]), NUM_FRAMES, NUM_LABELS, final_gather=False))
  assert np.isneginf(alpha_mid).any()

  def jax_block(b, l, a):
    return jnp.sum(jax_dp(monkeypatch, jax_lattice, True, b, l, NUM_FRAMES,
                          NUM_LABELS, alpha0=a, t_offset=cut))

  want = jax.grad(jax_block, argnums=(0, 1, 2))(
      jnp.asarray(bw[cut:]), jnp.asarray(lw[cut:]), jnp.asarray(alpha_mid))
  leaves = [torch.tensor(x, requires_grad=True)
            for x in (bw[cut:], lw[cut:], alpha_mid)]
  port_dp(monkeypatch, port_lattice, True, leaves[0], leaves[1], NUM_FRAMES,
          NUM_LABELS, alpha0=leaves[2], t_offset=cut).sum().backward()
  for leaf, w in zip(leaves, want):
    assert np.isfinite(leaf.grad.numpy()).all()
    npt.assert_allclose(leaf.grad.numpy(), np.asarray(w), rtol=1e-4,
                        atol=1e-5)


@pytest.mark.parametrize('context_size', [0, 1])
def test_full_loss_matches_jax_and_scan(monkeypatch, context_size):
  """End to end: the S = 1 loss (the CTC topology's factorized route) and
  the bigram loss, flag on, against JAX's (flag on) and the port's scan."""
  rng = np.random.default_rng(1)
  frames = rng.normal(size=(B, T, HIDDEN)).astype(np.float32)
  labels = rng.integers(1, VOCAB + 1, size=(B, U)).astype(np.int32)
  jax_lattice, port_lattice = make_lattices(context_size=context_size)
  params = jax.tree.map(np.asarray, jax_lattice.init(
      jax.random.PRNGKey(0), feature_size=HIDDEN))

  def jax_loss(p):
    return jnp.sum(jax_lattice(p, jnp.asarray(frames),
                               jnp.asarray(NUM_FRAMES), jnp.asarray(labels),
                               jnp.asarray(NUM_LABELS)))

  monkeypatch.setattr(jax_lattices, 'STRING_DP_CUMULATIVE', True)
  want, want_grads = jax.value_and_grad(jax_loss)(params)
  monkeypatch.setattr(jax_lattices, 'STRING_DP_CUMULATIVE', False)
  want_grads = {k: np.asarray(v) for k, v in
                named(want_grads).items()}

  def port_loss(cumulative):
    monkeypatch.setattr(lattices, 'STRING_DP_CUMULATIVE', cumulative)
    p = convert.from_jax_params(params, device='cpu')
    leaves = named(p)
    for leaf in leaves.values():
      leaf.requires_grad_(True)
    loss = port_lattice.loss(p, torch.from_numpy(frames),
                             torch.from_numpy(NUM_FRAMES),
                             torch.from_numpy(labels),
                             torch.from_numpy(NUM_LABELS)).sum()
    loss.backward()
    monkeypatch.setattr(lattices, 'STRING_DP_CUMULATIVE', False)
    return float(loss), {k: v.grad.numpy() for k, v in leaves.items()}

  got, got_grads = port_loss(True)
  scan, scan_grads = port_loss(False)
  scale = max(np.abs(w).max() for w in want_grads.values())
  for value, grads in ((want, want_grads), (scan, scan_grads)):
    npt.assert_allclose(got, float(value), rtol=1e-5)
    assert set(grads) == set(got_grads)
    for name, g in grads.items():
      assert np.abs(got_grads[name] - g).max() <= 1e-4 * scale, name


def test_single_frame_and_single_position(monkeypatch):
  """Degenerate shapes: T=1, and U+1 = 1, below the expansion order."""
  rng = np.random.default_rng(2)
  jax_lattice, port_lattice = make_lattices()  # k=2 > U
  bw = rng.normal(size=(1, B, 1)).astype(np.float32)
  lw = rng.normal(size=(1, B, 1)).astype(np.float32)
  nf = np.array([1, 1, 0], np.int32)
  nl = np.zeros((B,), np.int32)
  want = np.asarray(jax_dp(monkeypatch, jax_lattice, True, jnp.asarray(bw),
                           jnp.asarray(lw), nf, nl))
  scan = port_dp(monkeypatch, port_lattice, False, torch.from_numpy(bw),
                 torch.from_numpy(lw), nf, nl).numpy()
  got, grads = port_value_and_grads(monkeypatch, port_lattice, True, bw, lw,
                                    nf, nl)
  npt.assert_allclose(got, want.sum(), rtol=1e-6, atol=1e-6)
  npt.assert_allclose(got, scan.sum(), rtol=1e-6, atol=1e-6)
  # One frame of blank at position 0: d/d blank = 1 on live rows.
  npt.assert_array_equal(grads[0][0, :, 0], [1.0, 1.0, 0.0])


def test_more_expansions_than_positions(monkeypatch, weights):
  """FrameLabelDependent(3) over U+1 = 2 positions (the shift by e >= U+1
  is all sentinel), with a row of one frame and a row of no label."""
  bw, lw = (w[:, :, :2] for w in weights)
  jax_lattice, port_lattice = make_lattices('fld3')
  nf = np.array([T, 1, 4], np.int32)
  nl = np.array([1, 1, 0], np.int32)
  want, want_grads = jax_value_and_grads(monkeypatch, jax_lattice, bw, lw,
                                         nf, nl)
  got, got_grads = port_value_and_grads(monkeypatch, port_lattice, True, bw,
                                        lw, nf, nl)
  npt.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
  for g, w in zip(got_grads, want_grads):
    npt.assert_allclose(g, w, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize('semiring', ['max_tropical', 'real'])
def test_non_log_semirings_keep_the_scan(monkeypatch, weights, semiring):
  """MaxTropical (one-hot tie-broken gradients) and Real keep the scan:
  flag on and off give the same bits, and JAX's value."""
  bw, lw = weights
  jax_sr = {'max_tropical': jax_semirings.MaxTropical,
            'real': jax_semirings.Real}[semiring]
  port_sr = {'max_tropical': semirings.MaxTropical,
             'real': semirings.Real}[semiring]
  if semiring == 'real':
    bw, lw = np.exp(bw), np.exp(lw)
  jax_lattice, port_lattice = make_lattices()
  on, off = (port_dp(monkeypatch, port_lattice, cumulative,
                     torch.from_numpy(bw), torch.from_numpy(lw), NUM_FRAMES,
                     NUM_LABELS, semiring=port_sr) for cumulative in (True,
                                                                     False))
  npt.assert_array_equal(on.numpy(), off.numpy())
  want = jax_dp(monkeypatch, jax_lattice, True, jnp.asarray(bw),
                jnp.asarray(lw), NUM_FRAMES, NUM_LABELS, semiring=jax_sr)
  npt.assert_allclose(on.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def hat_like_weights(seed=3):
  """Time-major [T, B, U+1] float32 blank and next-label weights at the
  scale of a randomly initialised HAT model's (V=1024): blank
  log sigmoid(z), the label log sigmoid(-z) plus a logit less the
  log-sum-exp of 1024 standard normal logits."""
  rng = np.random.default_rng(seed)
  shape = (DRIFT_T, DRIFT_B, DRIFT_U + 1)
  z = rng.normal(size=shape)
  log_sigmoid = lambda x: -np.logaddexp(0.0, -x)
  label = rng.normal(size=shape) - (np.log(1024.0) + 0.5)
  return (log_sigmoid(z).astype(np.float32),
          (log_sigmoid(-z) + label).astype(np.float32))


def drift(value, grads, ref_value, ref_grads):
  """(loss relative, gradients as a share of the largest) from the
  float64 reference."""
  scale = max(np.abs(g).max() for g in ref_grads)
  return (abs(value - ref_value) / abs(ref_value),
          max(np.abs(g - r).max() for g, r in zip(grads, ref_grads)) / scale)


def test_drift_at_t1600(monkeypatch):
  """Each route's float32 drift from a float64 scan at the HAT training
  shape is at most twice the JAX package's on the same route, and
  ``DRIFT_LIMITS`` are those two bounds (rounded up by under 1%)."""
  bw, lw = hat_like_weights()
  num_frames = np.full((DRIFT_B,), DRIFT_T, np.int32)
  num_labels = np.full((DRIFT_B,), DRIFT_U, np.int32)
  jax_lattice, port_lattice = make_lattices('fld2')
  ref_value, ref_grads = port_value_and_grads(
      monkeypatch, port_lattice, False, bw.astype(np.float64),
      lw.astype(np.float64), num_frames, num_labels)
  for route, cumulative in (('closed_form', True), ('scan', False)):
    jax_drift = drift(*jax_value_and_grads(
        monkeypatch, jax_lattice, bw, lw, num_frames, num_labels,
        cumulative=cumulative), ref_value, ref_grads)
    port_drift = drift(*port_value_and_grads(
        monkeypatch, port_lattice, cumulative, bw, lw, num_frames,
        num_labels), ref_value, ref_grads)
    for i, metric in enumerate(('loss', 'grads')):
      limit = DRIFT_LIMITS[route][metric]
      assert port_drift[i] <= 2 * jax_drift[i], (route, port_drift,
                                                 jax_drift)
      assert 2 * jax_drift[i] <= limit <= 2.02 * jax_drift[i], (
          route, metric, jax_drift)
