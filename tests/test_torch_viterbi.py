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
from last_torch_tpu_torch.ops import joint_head, viterbi

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


def jax_lattice(alignment, fused, context_size=1, vocab=VOCAB,
                joint=jax_weight_fns.JointWeightFn):
  return last_torch_tpu.RecognitionLattice(
      context=jax_contexts.FullNGram(vocab_size=vocab,
                                     context_size=context_size),
      alignment=ALIGNMENTS[alignment][0](),
      weight_fn_cacher_factory=lambda ctx: jax_weight_fns.SharedEmbCacher(
          num_context_states=ctx.shape()[0], embedding_size=EMBEDDING),
      weight_fn_factory=lambda ctx: joint(vocab_size=ctx.shape()[1],
                                          hidden_size=HIDDEN),
      fused=fused)


def torch_lattice(alignment, context_size=1, vocab=VOCAB,
                  joint=weight_fns.JointWeightFn):
  return last_torch_tpu_torch.RecognitionLattice(
      context=contexts.FullNGram(vocab_size=vocab, context_size=context_size),
      alignment=ALIGNMENTS[alignment][1](),
      weight_fn_cacher_factory=lambda ctx: weight_fns.SharedEmbCacher(
          num_context_states=ctx.shape()[0], embedding_size=EMBEDDING),
      weight_fn_factory=lambda ctx: joint(vocab_size=ctx.shape()[1],
                                          hidden_size=HIDDEN))


def make_inputs(seed, context_size=1, vocab=VOCAB):
  """JAX params (numpy) from init(PRNGKey), frames from numpy's rng."""
  params = jax_lattice('fd', 'never', context_size, vocab).init(
      jax.random.PRNGKey(seed), feature_size=FEATURES)
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


SMS = 132  # an H100's SMs


@pytest.mark.parametrize('batch,hidden,vocab', [
    (8, 512, 1024),  # the serving main path (S=1025)
    (8, 512, 4096),  # the V=4096 decode
    (3, 64, 69),  # S=70: a ragged unit, h and V off the stages
    (1, 24, 37),  # V not a multiple of 4
])
@pytest.mark.parametrize('passes', [1, 2, 3])
@pytest.mark.parametrize('normalize', ['none', 'hat', 'log_softmax'])
def test_forward_scratch_plans_the_bf16_route(batch, hidden, vocab, passes,
                                              normalize):
  """The bfloat16 forward's buffers (csrc/head_product.cuh): the padded
  bfloat16 joint and head; a (max, argmax) pair per 64-state unit, [ceil(S
  / 64), B, V]; the float32 lex [B, S, V] only where a max-pass reads it
  back (two or more passes, or normalization); the row partials per
  128-label strip and the normalizers only with normalization."""
  states = vocab + 1
  plan = joint_head.reduce_plan(batch, states, hidden, vocab, SMS)
  hp, vp = plan.hidden_pad, plan.vocab_pad
  scratch = viterbi.forward_scratch(batch, states, hidden, vocab, plan,
                                    passes, normalize)
  units = (-(-states // 64), batch, vocab)
  assert scratch['joint'] == ((batch, states, hp), torch.bfloat16)
  assert scratch['vocab_w'] == ((hp, vp), torch.bfloat16)
  assert scratch['part_v'] == (units, torch.float32)
  assert scratch['part_s'] == (units, torch.int32)
  normalized = normalize != 'none'
  staged = passes >= 2 or normalized
  assert ('lex' in scratch) == staged
  if staged:
    assert scratch['lex'] == ((batch, states, vocab), torch.float32)
  if hp < vocab:  # else the joint [B, S, hp] outgrows B S V
    big = [n for n, (shape, _) in scratch.items()
           if np.prod(shape) >= batch * states * vocab]
    assert big == (['lex'] if staged else []), big
  if normalized:
    strips = (-(-vp // 128), batch, states)
    assert scratch['part_m'] == scratch['part_l'] == (strips, torch.float32)
    assert scratch['cnorm'] == ((batch, states), torch.float32)
  else:
    assert not {'part_m', 'part_l', 'cnorm'} & set(scratch)
  # The products' persistent grid: one block per output tile, up to two an
  # SM; the units cover every row's states once.
  assert plan.units == batch * units[0]
  assert 1 <= plan.blocks <= min(plan.tiles, 2 * SMS)


def test_cuda_model_without_gpu_raises():
  if torch.cuda.is_available():
    pytest.skip('a GPU is present; the no-GPU error cannot be observed')
  with pytest.raises(RuntimeError, match='no CUDA device'):
    gnat.GNATModel(gnat.GNATConfig(), device='cuda')
  # The card is the default device: without one the model refuses too.
  with pytest.raises(RuntimeError, match='no CUDA device'):
    gnat.GNATModel(gnat.GNATConfig())


def assert_decodes_equal(got, want):
  labels, num_labels, weights = got
  npt.assert_array_equal(labels.numpy(), np.asarray(want[0]))
  npt.assert_array_equal(num_labels.numpy(), np.asarray(want[1]))
  npt.assert_allclose(weights.numpy(), np.asarray(want[2]), rtol=1e-5,
                      atol=1e-6)


def test_configs_outside_the_gate_raise():
  """Outside the Viterbi kernel's gate the trigram decode and loss, a
  decode with two batch dims and one over a JointWeightFn subclass take the
  generic routes and agree with the JAX package (labels and counts equal,
  path weights and losses to rtol 1e-5), and so does ``align``."""
  num_frames = torch.from_numpy(NUM_FRAMES)
  # The trigram (V=2): the generic decode, the trigram kernels' plain loss.
  params, frames = make_inputs(seed=6, context_size=2, vocab=2)
  trigram = torch_lattice('fd', context_size=2, vocab=2)
  trigram_params = convert.from_jax_params(params, device='cpu')
  got = trigram.shortest_path(trigram_params, torch.from_numpy(frames),
                              num_frames)
  assert trigram.last_path == 'generic'
  reference = jax_lattice('fd', 'interpret', context_size=2, vocab=2)
  assert_decodes_equal(got, reference.shortest_path(params, frames,
                                                    NUM_FRAMES))
  labels = np.ones((len(NUM_FRAMES), 2), dtype=np.int32)
  num_labels = np.full((len(NUM_FRAMES),), 2, dtype=np.int32)
  loss = trigram.loss(trigram_params, torch.from_numpy(frames), num_frames,
                      torch.from_numpy(labels), torch.from_numpy(num_labels))
  assert trigram.last_path == 'plain'
  # The empty row cannot emit its 2 labels: +inf in both packages.
  npt.assert_allclose(loss.numpy(), np.asarray(reference(
      params, frames, NUM_FRAMES, labels, num_labels)), rtol=1e-5)
  assert loss[2].item() == float('inf')

  params, frames = make_inputs(seed=6)
  lattice = torch_lattice('fd')
  torch_params = convert.from_jax_params(params, device='cpu')
  got = lattice.shortest_path(torch_params, torch.from_numpy(frames)[None],
                              num_frames[None])
  assert lattice.last_path == 'generic'
  assert_decodes_equal(got, jax_lattice('fd', 'interpret').shortest_path(
      params, frames[None], NUM_FRAMES[None]))
  # align is ported: it agrees with the JAX package's (the empty row
  # cannot emit its 2 labels and scores -inf in both).
  align_labels = np.ones((len(NUM_FRAMES), 2), dtype=np.int32)
  align_num = np.full((len(NUM_FRAMES),), 2, dtype=np.int32)
  emit, scores = lattice.align(torch_params, torch.from_numpy(frames),
                               num_frames, torch.from_numpy(align_labels),
                               torch.from_numpy(align_num))
  emit_j, scores_j = jax_lattice('fd', 'interpret').align(
      params, frames, NUM_FRAMES, align_labels, align_num)
  npt.assert_array_equal(emit.numpy()[:2], np.asarray(emit_j)[:2])
  npt.assert_allclose(scores.numpy(), np.asarray(scores_j), rtol=1e-5)
  assert scores[2].item() == float('-inf')

  class MyJoint(weight_fns.JointWeightFn):
    pass

  class JaxMyJoint(jax_weight_fns.JointWeightFn):
    pass

  lattice = torch_lattice('fld2', joint=MyJoint)
  got = lattice.shortest_path(torch_params, torch.from_numpy(frames),
                              num_frames)
  assert lattice.last_path == 'generic'
  assert_decodes_equal(got, jax_lattice(
      'fld2', 'interpret', joint=JaxMyJoint).shortest_path(
          params, frames, NUM_FRAMES))


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
