"""The port's Viterbi decode against the JAX package.

The port's plain path (the CUDA kernel's plain PyTorch version plus the
backtrace) runs on the CPU and is held to JAX ``shortest_path`` through the
Pallas kernel in interpret mode and through the XLA route: labels and
counts equal, path weights to rtol 1e-5 / atol 1e-6 (float32, different
summation order). The kernel itself is held to the plain version on the
card in ``test_torch_kernels.py``.
"""

import jax
import numpy as np
import numpy.testing as npt
import pytest
import torch

import last_torch_tpu
from last_torch_tpu import alignments as jax_alignments
from last_torch_tpu import contexts as jax_contexts
from last_torch_tpu import weight_fns as jax_weight_fns
import last_torch_tpu_torch
from last_torch_tpu_torch import alignments, contexts, convert, weight_fns
from last_torch_tpu_torch.models import gnat
from last_torch_tpu_torch.ops import viterbi

torch.set_num_threads(1)
torch.set_float32_matmul_precision('highest')

# V = 5 is a multiple of neither 32 nor 128: the ragged edges are exercised.
VOCAB, HIDDEN, EMBEDDING, FEATURES = 5, 8, 8, 6
NUM_FRAMES = np.array([7, 4, 0], np.int32)  # full, padded, empty
ALIGNMENTS = {
    'fd': (jax_alignments.FrameDependent, alignments.FrameDependent),
    'fld1': (lambda: jax_alignments.FrameLabelDependent(1),
             lambda: alignments.FrameLabelDependent(1)),
    'fld2': (lambda: jax_alignments.FrameLabelDependent(2),
             lambda: alignments.FrameLabelDependent(2)),
}


def jax_lattice(alignment, fused):
  return last_torch_tpu.RecognitionLattice(
      context=jax_contexts.FullNGram(vocab_size=VOCAB, context_size=1),
      alignment=ALIGNMENTS[alignment][0](),
      weight_fn_cacher_factory=lambda ctx: jax_weight_fns.SharedEmbCacher(
          num_context_states=ctx.shape()[0], embedding_size=EMBEDDING),
      weight_fn_factory=lambda ctx: jax_weight_fns.JointWeightFn(
          vocab_size=ctx.shape()[1], hidden_size=HIDDEN),
      fused=fused)


def torch_lattice(alignment, context_size=1, vocab=VOCAB):
  return last_torch_tpu_torch.RecognitionLattice(
      context=contexts.FullNGram(vocab_size=vocab, context_size=context_size),
      alignment=ALIGNMENTS[alignment][1](),
      weight_fn_cacher_factory=lambda ctx: weight_fns.SharedEmbCacher(
          num_context_states=ctx.shape()[0], embedding_size=EMBEDDING),
      weight_fn_factory=lambda ctx: weight_fns.JointWeightFn(
          vocab_size=ctx.shape()[1], hidden_size=HIDDEN))


def make_inputs(seed):
  """JAX params (numpy) from init(PRNGKey), frames from numpy's rng."""
  params = jax_lattice('fd', 'never').init(jax.random.PRNGKey(seed),
                                           feature_size=FEATURES)
  rng = np.random.default_rng(seed)
  frames = rng.standard_normal(
      (len(NUM_FRAMES), 7, FEATURES)).astype(np.float32)
  return jax.tree.map(np.asarray, params), frames


@pytest.mark.parametrize('reference_compat', [False, True])
@pytest.mark.parametrize('fused', ['interpret', 'never'])
@pytest.mark.parametrize('alignment', ['fd', 'fld1', 'fld2'])
def test_plain_shortest_path_matches_jax(alignment, fused, reference_compat):
  params, frames = make_inputs(seed=3)
  labels_j, num_j, weights_j = jax_lattice(alignment, fused).shortest_path(
      params, frames, NUM_FRAMES, reference_compat=reference_compat)

  lattice = torch_lattice(alignment)
  before = viterbi.launches
  labels_t, num_t, weights_t = lattice.shortest_path(
      convert.from_jax_params(params, device='cpu'), torch.from_numpy(frames),
      torch.from_numpy(NUM_FRAMES), reference_compat=reference_compat)

  assert lattice.last_path == 'plain'
  assert viterbi.launches == before  # CPU tensors never launch the kernel
  assert labels_t.dtype == torch.int32 and num_t.dtype == torch.int32
  npt.assert_array_equal(labels_t.numpy(), np.asarray(labels_j))
  npt.assert_array_equal(num_t.numpy(), np.asarray(num_j))
  npt.assert_allclose(weights_t.numpy(), np.asarray(weights_j), rtol=1e-5,
                      atol=1e-6)


def test_empty_utterance_decodes_to_blanks_with_weight_zero():
  params, frames = make_inputs(seed=4)
  labels, num, weights = torch_lattice('fld2').shortest_path(
      convert.from_jax_params(params, device='cpu'), torch.from_numpy(frames),
      torch.from_numpy(NUM_FRAMES))
  assert num[2] == 0 and weights[2] == 0.0
  assert torch.all(labels[2] == 0)
  # Padding frames of the shorter utterance are blank too.
  assert torch.all(labels[1, 4 * 3:] == 0)


def test_forward_wrapper_rejects_bad_inputs():
  params, frames = make_inputs(seed=5)
  wf = convert.from_jax_params(params, device='cpu')['weight_fn']
  pf = torch.zeros((4, 2, HIDDEN))
  pc = torch.zeros((VOCAB + 1, HIDDEN))
  is_pad = torch.zeros((4, 2), dtype=torch.bool)
  kwargs = dict(max_expansions=2, frame_dependent=False,
                compute_dtype=torch.float32)
  viterbi.viterbi_forward(pf, pc, wf, is_pad, **kwargs)  # well-formed
  with pytest.raises(ValueError, match='pf should be'):
    viterbi.viterbi_forward(pf.double(), pc, wf, is_pad, **kwargs)
  with pytest.raises(ValueError, match='contiguous'):
    viterbi.viterbi_forward(pf.transpose(0, 1).contiguous().transpose(0, 1),
                            pc, wf, is_pad, **kwargs)
  with pytest.raises(ValueError, match='is_pad should be'):
    viterbi.viterbi_forward(pf, pc, wf, is_pad.int(), **kwargs)
  with pytest.raises(ValueError, match='bigram'):
    viterbi.viterbi_forward(pf, pc[:-1], wf, is_pad, **kwargs)
  with pytest.raises(ValueError, match='compute_dtype'):
    viterbi.viterbi_forward(pf, pc, wf, is_pad, max_expansions=2,
                            frame_dependent=False, compute_dtype=torch.half)
  with pytest.raises(ValueError, match='no Viterbi kernel'):
    viterbi.viterbi_forward(
        pf.to('meta'), pc.to('meta'),
        {k: v.to('meta') for k, v in wf.items()}, is_pad.to('meta'),
        **kwargs)


def test_cuda_model_without_gpu_raises():
  if torch.cuda.is_available():
    pytest.skip('a GPU is present; the no-GPU error cannot be observed')
  with pytest.raises(RuntimeError, match='no CUDA device'):
    gnat.GNATModel(gnat.GNATConfig(), device='cuda')
  # The card is the default device: without one the model refuses too.
  with pytest.raises(RuntimeError, match='no CUDA device'):
    gnat.GNATModel(gnat.GNATConfig())


def test_configs_outside_the_gate_raise():
  params, frames = make_inputs(seed=6)
  frames = torch.from_numpy(frames)
  num_frames = torch.from_numpy(NUM_FRAMES)
  trigram = torch_lattice('fd', context_size=2, vocab=2)
  trigram_params = trigram.init(torch.Generator().manual_seed(0),
                                feature_size=FEATURES, device='cpu')
  with pytest.raises(NotImplementedError, match='ROADMAP'):
    trigram.shortest_path(trigram_params, frames, num_frames)
  labels = torch.ones((len(NUM_FRAMES), 2), dtype=torch.int32)
  with pytest.raises(NotImplementedError,
                     match='ROADMAP.md queue 2, item 6'):
    trigram.loss(trigram_params, frames, num_frames, labels,
                 torch.full((len(NUM_FRAMES),), 2))
  lattice = torch_lattice('fd')
  torch_params = convert.from_jax_params(params, device='cpu')
  with pytest.raises(NotImplementedError, match='ROADMAP'):
    lattice.shortest_path(torch_params, frames[None], num_frames[None])
  with pytest.raises(NotImplementedError, match='ROADMAP'):
    lattice.align(torch_params, frames, num_frames,
                  torch.ones((len(NUM_FRAMES), 2), dtype=torch.int32),
                  torch.full((len(NUM_FRAMES),), 2))

  class MyJoint(weight_fns.JointWeightFn):
    pass

  lattice.weight_fn = MyJoint(vocab_size=VOCAB, hidden_size=HIDDEN)
  with pytest.raises(NotImplementedError, match='ROADMAP'):
    lattice.shortest_path(torch_params, frames, num_frames)
  assert lattice.last_path is None


@pytest.mark.parametrize('context_size', [0, 1, 2])
def test_full_ngram_matches_jax(context_size):
  ported = contexts.FullNGram(vocab_size=3, context_size=context_size)
  reference = jax_contexts.FullNGram(vocab_size=3, context_size=context_size)
  assert ported.shape() == reference.shape()
  assert ported.start() == reference.start()
  npt.assert_array_equal(ported.next_state_table().numpy(),
                         np.asarray(reference.next_state_table()))
  num_states = ported.num_states()
  states = np.repeat(np.arange(num_states), 4)
  labels = np.tile(np.arange(4), num_states)  # label 0 stays in place
  npt.assert_array_equal(
      ported.next_state(torch.from_numpy(states),
                        torch.from_numpy(labels)).numpy(),
      np.asarray(reference.next_state(states, labels)))


@pytest.mark.parametrize('alignment', sorted(ALIGNMENTS))
def test_alignment_structure_matches_jax(alignment):
  ported, reference = (factory() for factory in ALIGNMENTS[alignment])
  assert ported.num_states() == reference.num_states()
  assert ported.start() == reference.start()
  assert ported.topological_visit() == reference.topological_visit()
  for state in range(ported.num_states()):
    assert ported.blank_next(state) == reference.blank_next(state)
    assert ported.lexical_next(state) == reference.lexical_next(state)
