"""The port's streaming decoders against the JAX package.

A small lattice (V=8, hidden 16, embedding 16, 6 features) over a
``FullNGram`` bigram or a random ``NextStateTable``, FrameDependent or
FrameLabelDependent(2); JAX parameters converted with
``convert.from_jax_params`` and the same numpy encoded frames through both
packages. JAX decodes each utterance in one chunk; the port in chunks of 1,
3 and the whole utterance, over the same frames. Labels, counts, context
states, label hashes and the order of every beam slot (ties at -inf among
them) equal; scores to rtol 1e-5 (float32, summation order).
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

import last_torch_tpu
from last_torch_tpu import alignments as jax_alignments
from last_torch_tpu import contexts as jax_contexts
from last_torch_tpu import streaming as jax_streaming
from last_torch_tpu import weight_fns as jax_weight_fns
import last_torch_tpu_torch
from last_torch_tpu_torch import (alignments, contexts, convert, streaming,
                                  weight_fns)

torch.set_num_threads(1)
torch.set_float32_matmul_precision('highest')

VOCAB, HIDDEN, EMBEDDING, FEATURES = 8, 16, 16, 6
MAX_T = 7
NUM_FRAMES = np.array([7, 4, 0], np.int32)  # full, ragged, empty
TABLE_STATES = 12
CHUNK_SIZES = (1, 3, MAX_T)
ALIGNMENTS = {
    'fd': (jax_alignments.FrameDependent, alignments.FrameDependent),
    'fld2': (lambda: jax_alignments.FrameLabelDependent(2),
             lambda: alignments.FrameLabelDependent(2)),
}


def table():
  """Destinations in [1, TABLE_STATES): the start state has in-degree 0."""
  return np.random.default_rng(7).integers(
      1, TABLE_STATES, size=(TABLE_STATES, VOCAB)).astype(np.int32)


def lattices(alignment, context):
  if context == 'ngram':
    jax_ctx = jax_contexts.FullNGram(vocab_size=VOCAB, context_size=1)
    ctx = contexts.FullNGram(vocab_size=VOCAB, context_size=1)
  else:
    jax_ctx = jax_contexts.NextStateTable(jnp.asarray(table()))
    ctx = contexts.NextStateTable(torch.from_numpy(table()))
  jax_lat = last_torch_tpu.RecognitionLattice(
      context=jax_ctx, alignment=ALIGNMENTS[alignment][0](),
      weight_fn_cacher_factory=lambda c: jax_weight_fns.SharedEmbCacher(
          num_context_states=c.shape()[0], embedding_size=EMBEDDING),
      weight_fn_factory=lambda c: jax_weight_fns.JointWeightFn(
          vocab_size=c.shape()[1], hidden_size=HIDDEN))
  lat = last_torch_tpu_torch.RecognitionLattice(
      context=ctx, alignment=ALIGNMENTS[alignment][1](),
      weight_fn_cacher_factory=lambda c: weight_fns.SharedEmbCacher(
          num_context_states=c.shape()[0], embedding_size=EMBEDDING),
      weight_fn_factory=lambda c: weight_fns.JointWeightFn(
          vocab_size=c.shape()[1], hidden_size=HIDDEN))
  # JAX arrays: the JAX decoders index the cache with traced states.
  params = jax_lat.init(jax.random.PRNGKey(0), feature_size=FEATURES)
  frames = (np.random.default_rng(1).standard_normal(
      (len(NUM_FRAMES), MAX_T, FEATURES)) * 2.0).astype(np.float32)
  return jax_lat, lat, params, frames


def chunks(frames, size):
  """(frames, num_frames) of each chunk of ``size`` frames."""
  for start in range(0, MAX_T, size):
    yield (torch.from_numpy(frames[:, start:start + size]),
           torch.from_numpy(np.clip(NUM_FRAMES - start, 0, size)))


def assert_states_equal(got, want, rtol=1e-5):
  """Every field equal, scores to rtol (their -inf slots exactly)."""
  assert set(got) == set(want)
  for field, value in want.items():
    value = np.asarray(value)
    mine = got[field].numpy()
    if field == 'score':
      npt.assert_array_equal(np.isfinite(mine), np.isfinite(value))
      npt.assert_array_equal(mine[~np.isfinite(mine)],
                             value[~np.isfinite(value)])
      npt.assert_allclose(mine[np.isfinite(mine)],
                          value[np.isfinite(value)], rtol=rtol)
    else:
      npt.assert_array_equal(mine, value.astype(np.int64), err_msg=field)


@pytest.mark.parametrize('context', ['ngram', 'table'])
@pytest.mark.parametrize('alignment', sorted(ALIGNMENTS))
def test_greedy_matches_jax(alignment, context):
  jax_lat, lat, params, frames = lattices(alignment, context)
  jax_dec = jax_streaming.StreamingGreedyDecoder(jax_lat)
  q_j, labels_j, num_j = jax_dec.step(
      params, jax_dec.init_state(len(NUM_FRAMES)), frames, NUM_FRAMES)
  decoder = streaming.StreamingGreedyDecoder(lat)
  assert decoder.slots_per_frame == jax_dec.slots_per_frame
  torch_params = convert.from_jax_params(jax.tree.map(np.asarray, params),
                                         device='cpu')
  for size in CHUNK_SIZES:
    q = decoder.init_state(len(NUM_FRAMES), device='cpu')
    labels, counts = [], 0
    for chunk, num in chunks(frames, size):
      q, chunk_labels, chunk_counts = decoder.step(torch_params, q, chunk,
                                                   num)
      labels.append(chunk_labels)
      counts = counts + chunk_counts
    labels = torch.cat(labels, dim=1).numpy()
    npt.assert_array_equal(labels, np.asarray(labels_j), err_msg=str(size))
    npt.assert_array_equal(counts.numpy(), np.asarray(num_j))
    npt.assert_array_equal(q.numpy(), np.asarray(q_j))
  # Lexical labels do occur, and the empty stream emits nothing.
  assert np.any(labels > 0) and not np.any(labels[2])


BEAM_CASES = {
    # name: (alignment, context, merge, max_labels)
    'fd_ngram_max': ('fd', 'ngram', 'max', 16),
    'fd_ngram_logsumexp': ('fd', 'ngram', 'logsumexp', 16),
    'fd_ngram_none': ('fd', 'ngram', 'none', 16),
    'fld2_ngram_max': ('fld2', 'ngram', 'max', 16),
    'fld2_ngram_logsumexp': ('fld2', 'ngram', 'logsumexp', 16),
    'fld2_ngram_none': ('fld2', 'ngram', 'none', 16),
    'fd_table_max': ('fd', 'table', 'max', 16),
    'fld2_table_logsumexp': ('fld2', 'table', 'logsumexp', 16),
    # Hypotheses saturate at 2 labels and extend through blank only.
    'fld2_ngram_max_saturated': ('fld2', 'ngram', 'max', 2),
}


@pytest.mark.parametrize('case', sorted(BEAM_CASES))
def test_beam_matches_jax(case):
  alignment, context, merge, max_labels = BEAM_CASES[case]
  jax_lat, lat, params, frames = lattices(alignment, context)
  jax_dec = jax_streaming.StreamingBeamDecoder(jax_lat, beam_size=4,
                                               max_labels=max_labels,
                                               merge=merge)
  want = jax_dec.step(params, jax_dec.init_state(len(NUM_FRAMES)), frames,
                      NUM_FRAMES)
  decoder = streaming.StreamingBeamDecoder(lat, beam_size=4,
                                           max_labels=max_labels,
                                           merge=merge)
  torch_params = convert.from_jax_params(jax.tree.map(np.asarray, params),
                                         device='cpu')
  for size in CHUNK_SIZES:
    state = decoder.init_state(len(NUM_FRAMES), device='cpu')
    for chunk, num in chunks(frames, size):
      state = decoder.step(torch_params, state, chunk, num)
    assert_states_equal(state, want)
  labels, num_labels, score = decoder.best(state)
  labels_j, num_labels_j, score_j = jax_dec.best(want)
  npt.assert_array_equal(labels.numpy(), np.asarray(labels_j))
  npt.assert_array_equal(num_labels.numpy(), np.asarray(num_labels_j))
  npt.assert_allclose(score.numpy(), np.asarray(score_j), rtol=1e-5)
  # The empty stream keeps its initial beams: one live hypothesis, the
  # others at -inf.
  assert score[2].item() == 0.0 and num_labels[2].item() == 0
  if max_labels == 2:
    assert int(state['num_labels'][0].max()) == 2
  else:
    assert int(num_labels[0]) > 2


def test_nbest_offline_matches_jax_and_the_whole_chunk_beam():
  jax_lat, lat, params, frames = lattices('fld2', 'ngram')
  want = jax_streaming.nbest_offline(jax_lat, params, frames, NUM_FRAMES,
                                     beam_size=4, n=3)
  torch_params = convert.from_jax_params(jax.tree.map(np.asarray, params),
                                         device='cpu')
  got = streaming.nbest_offline(lat, torch_params, torch.from_numpy(frames),
                                torch.from_numpy(NUM_FRAMES), beam_size=4,
                                n=3)
  for mine, theirs in zip(got[:2], want[:2]):
    npt.assert_array_equal(mine.numpy(), np.asarray(theirs))
  npt.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=1e-5)
  assert got[0].shape == (len(NUM_FRAMES), 3, 2 * MAX_T)
  scores = got[2].numpy()
  assert np.all(scores[:, :-1] >= scores[:, 1:])
  decoder = streaming.StreamingBeamDecoder(lat, beam_size=4,
                                           max_labels=2 * MAX_T)
  state = decoder.step(torch_params, decoder.init_state(3, device='cpu'),
                       torch.from_numpy(frames), torch.from_numpy(NUM_FRAMES))
  for a, b in zip(decoder.best(state), got):
    assert torch.equal(a, b[:, 0])


def test_nbest_offline_caps_default_labels_at_512_with_a_warning():
  _, lat, params, _ = lattices('fld2', 'ngram')
  torch_params = convert.from_jax_params(jax.tree.map(np.asarray, params),
                                         device='cpu')
  frames = torch.zeros((1, 257, FEATURES))  # 2 labels a frame imply 514
  with pytest.warns(UserWarning, match='capped at 512'):
    labels, _, _ = streaming.nbest_offline(lat, torch_params, frames,
                                           torch.tensor([3]), beam_size=2)
  assert labels.shape == (1, 2, 512)
  with warnings.catch_warnings():
    warnings.simplefilter('error')
    labels, _, _ = streaming.nbest_offline(lat, torch_params, frames[:, :256],
                                           torch.tensor([3]), beam_size=2)
  assert labels.shape == (1, 2, 512)


def test_rolling_hash_wraps_as_uint32():
  rng = np.random.default_rng(3)
  # Labels large enough that the hash passes 2**32 on the first append.
  labels = rng.integers(1, 2**20, size=(6, 5)).astype(np.int64)
  want = np.zeros((5,), np.uint32)
  got = torch.zeros((5,), dtype=torch.int64)
  want_jax = jnp.zeros((5,), jnp.uint32)
  for row in labels:
    with np.errstate(over='ignore'):
      want = want * np.uint32(1000003) + row.astype(np.uint32)
    want_jax = want_jax * jnp.uint32(1000003) + jnp.asarray(row, jnp.uint32)
    got = streaming._rolling_hash(got, torch.from_numpy(row))
    npt.assert_array_equal(got.numpy(), want.astype(np.int64))
    npt.assert_array_equal(got.numpy(), np.asarray(want_jax).astype(np.int64))
  assert int(got.max()) < 2**32


def test_top_k_keeps_the_lowest_index_first_among_ties():
  ninf = float('-inf')
  x = torch.tensor([[ninf, 1.0, ninf, 1.0, 0.5, ninf],
                    [ninf, ninf, ninf, ninf, ninf, ninf]])
  values, idx = streaming._top_k(x, 4)
  values_j, idx_j = jax.lax.top_k(jnp.asarray(x.numpy()), 4)
  npt.assert_array_equal(idx.numpy(), np.asarray(idx_j))
  npt.assert_array_equal(values.numpy(), np.asarray(values_j))
  npt.assert_array_equal(idx.numpy(), [[1, 3, 4, 0], [0, 1, 2, 3]])


def test_decoders_reject_bad_options():
  _, lat, _, _ = lattices('fd', 'ngram')
  with pytest.raises(ValueError, match='beam_size'):
    streaming.StreamingBeamDecoder(lat, beam_size=0, max_labels=4)
  with pytest.raises(ValueError, match='merge'):
    streaming.StreamingBeamDecoder(lat, beam_size=2, max_labels=4,
                                   merge='sum')
  decoder = streaming.StreamingBeamDecoder(lat, beam_size=2, max_labels=4)
  with pytest.raises(ValueError, match='n must be'):
    decoder.nbest(decoder.init_state(1, device='cpu'), 3)
