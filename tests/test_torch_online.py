"""The log-partition's 'online' mode against the JAX package's online
kernels.

The port's ``log_partition(mode='online')`` and ``mode='cache'`` on CPU
tensors (both run the plain versions: the two modes compute one function)
are held to the JAX package's vocabulary-tiled kernels in interpret mode in
float32 (``fused_shortest_distance_fwd`` and ``log_partition`` with
``mode='online'``), on the same numpy inputs: log Z and the alpha history to
rtol 1e-5 / atol 1e-6, the gradients of every parameter and of the frames
to rtol 2e-4 / atol 1e-5 (the tolerance ``test_fused_scan.py`` holds the JAX
online kernels to), at one vocabulary tile and at V=520, where the JAX
kernels sweep several state and vocabulary tiles. The CUDA kernels are held
to the plain versions on the card in ``test_torch_kernels.py``.
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
from last_torch_tpu.ops import fused_scan as jax_fused_scan
import last_torch_tpu_torch
from last_torch_tpu_torch import alignments, contexts, convert, weight_fns
from last_torch_tpu_torch.ops import fused_scan

torch.set_num_threads(1)
torch.set_float32_matmul_precision('highest')

FEATURES, EMBEDDING = 6, 8
ALIGNMENTS = {
    'fd': (0, jax_alignments.FrameDependent, alignments.FrameDependent),
    'fld1': (1, lambda: jax_alignments.FrameLabelDependent(1),
             lambda: alignments.FrameLabelDependent(1)),
    'fld2': (2, lambda: jax_alignments.FrameLabelDependent(2),
             lambda: alignments.FrameLabelDependent(2)),
}


def lattices(alignment, vocab, hidden):
  _, jax_align, torch_align = ALIGNMENTS[alignment]
  reference = last_torch_tpu.RecognitionLattice(
      context=jax_contexts.FullNGram(vocab_size=vocab, context_size=1),
      alignment=jax_align(),
      weight_fn_cacher_factory=lambda ctx: jax_weight_fns.SharedEmbCacher(
          num_context_states=ctx.shape()[0], embedding_size=EMBEDDING),
      weight_fn_factory=lambda ctx: jax_weight_fns.JointWeightFn(
          vocab_size=vocab, hidden_size=hidden),
      fused='never')
  port = last_torch_tpu_torch.RecognitionLattice(
      context=contexts.FullNGram(vocab_size=vocab, context_size=1),
      alignment=torch_align(),
      weight_fn_cacher_factory=lambda ctx: weight_fns.SharedEmbCacher(
          num_context_states=ctx.shape()[0], embedding_size=EMBEDDING),
      weight_fn_factory=lambda ctx: weight_fns.JointWeightFn(
          vocab_size=vocab, hidden_size=hidden))
  return reference, port


def check_against_jax(alignment, vocab, hidden, num_frames, seed, scale):
  k, _, _ = ALIGNMENTS[alignment]
  fd = alignment == 'fd'
  reference, port = lattices(alignment, vocab, hidden)
  states = vocab + 1
  params = jax.tree.map(np.asarray, reference.init(jax.random.PRNGKey(seed),
                                                   feature_size=FEATURES))
  frames = (np.random.default_rng(seed).standard_normal(
      (len(num_frames), max(num_frames), FEATURES)) * scale).astype(np.float32)
  kw = dict(max_expansions=k, frame_dependent=fd)

  # The JAX online kernels: forward values and alpha history, then log Z
  # with its gradients through the online backward.
  jax_params = jax.tree.map(jnp.asarray, params)
  log_z_j, hist_j = jax_fused_scan.fused_shortest_distance_fwd(
      jax_params['weight_fn'], reference.build_cache(jax_params),
      jnp.asarray(frames), num_frames, num_context_states=states,
      compute_dtype=jnp.float32, mode='online', interpret=True, **kw)

  def total(p, f):
    return jnp.sum(jax_fused_scan.log_partition(
        p['weight_fn'], reference.build_cache(p), f, num_frames,
        num_context_states=states, compute_dtype=jnp.float32, mode='online',
        interpret=True, **kw))

  value_j, (d_params_j, d_frames_j) = jax.value_and_grad(
      total, argnums=(0, 1))(jax_params, jnp.asarray(frames))

  for mode in ('online', 'cache'):
    torch_params = convert.from_jax_params(params, device='cpu')
    for leaf in pytree.tree_leaves(torch_params):
      leaf.requires_grad_(True)
    frames_t = torch.from_numpy(frames).requires_grad_(True)
    before = (fused_scan.forward_launches, fused_scan.backward_launches,
              fused_scan.online_forward_launches,
              fused_scan.online_backward_launches)
    log_z = fused_scan.log_partition(
        torch_params['weight_fn'], port.build_cache(torch_params), frames_t,
        torch.from_numpy(num_frames), compute_dtype=torch.float32, mode=mode,
        **kw)
    log_z.sum().backward()
    # CPU tensors run the plain versions and launch nothing.
    assert (fused_scan.forward_launches, fused_scan.backward_launches,
            fused_scan.online_forward_launches,
            fused_scan.online_backward_launches) == before
    npt.assert_allclose(log_z.detach().numpy(), np.asarray(log_z_j),
                        rtol=1e-5, atol=1e-6, err_msg=mode)
    npt.assert_allclose(float(log_z.detach().sum()), float(value_j),
                        rtol=1e-5, atol=1e-6)
    grads = dict(rtol=2e-4, atol=1e-5)
    npt.assert_allclose(frames_t.grad.numpy(), np.asarray(d_frames_j),
                        **grads, err_msg=mode)
    for path, want in jax.tree_util.tree_flatten_with_path(d_params_j)[0]:
      got = torch_params
      for key in path:
        got = got[key.key]
      npt.assert_allclose(got.grad.numpy(), np.asarray(want), **grads,
                          err_msg=f'{mode} {path}')

  # The alpha history of the port's forward (frames through frame_proj).
  torch_params = convert.from_jax_params(params, device='cpu')
  wf = torch_params['weight_fn']
  pf = torch.einsum('btf,fh->tbh', torch.from_numpy(frames),
                    wf['frame_proj']).contiguous()
  pc = (port.build_cache(torch_params) @ wf['context_proj']).contiguous()
  is_pad = (torch.arange(frames.shape[1])[:, None] >=
            torch.from_numpy(num_frames)[None])
  head = {n: wf[n] for n in ('vocab_w', 'vocab_b', 'blank_w', 'blank_b')}
  _, _, hist, _ = fused_scan.fused_forward(
      pf, pc, head, is_pad, compute_dtype=torch.float32, with_residuals=True,
      mode='online', **kw)
  npt.assert_allclose(hist.numpy().transpose(1, 0, 2), np.asarray(hist_j),
                      rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize('alignment', sorted(ALIGNMENTS))
def test_online_log_partition_matches_jax_online_kernels(alignment):
  check_against_jax(alignment, vocab=4, hidden=8,
                    num_frames=np.array([5, 3, 0], np.int32), seed=20,
                    scale=2.0)


@pytest.mark.parametrize('alignment', ['fd', 'fld2'])
def test_online_log_partition_matches_jax_multi_tile(alignment):
  # V=520: the JAX kernels run 5 vocabulary and 6 state tiles; ragged
  # against the port's 64-wide tiles too.
  check_against_jax(alignment, vocab=520, hidden=16,
                    num_frames=np.array([3, 2], np.int32), seed=40, scale=1.0)


def test_bad_mode_raises():
  _, port = lattices('fld2', vocab=4, hidden=8)
  params = port.init(torch.Generator().manual_seed(0), FEATURES, device='cpu')
  frames = torch.zeros((2, 3, FEATURES))
  kw = dict(max_expansions=2, frame_dependent=False,
            compute_dtype=torch.float32)
  with pytest.raises(ValueError, match='mode must be one of'):
    fused_scan.log_partition(params['weight_fn'], port.build_cache(params),
                             frames, torch.tensor([3, 2]), mode='tiled', **kw)
  wf = params['weight_fn']
  head = {n: wf[n] for n in ('vocab_w', 'vocab_b', 'blank_w', 'blank_b')}
  pf = torch.zeros((3, 2, 8))
  pc = torch.zeros((5, 8))
  is_pad = torch.zeros((3, 2), dtype=torch.bool)
  # 'auto' is log_partition's to resolve; the kernels take a concrete mode.
  with pytest.raises(ValueError, match='mode must be one of'):
    fused_scan.fused_forward(pf, pc, head, is_pad, with_residuals=False,
                             mode='auto', **kw)


def test_plan_stages_lex_within_the_budget():
  budget = fused_scan.LEX_STAGE_BUDGET
  per_state = lambda v, dtype: (v + 1) * v * (4 + dtype.itemsize)
  # The headline configurations stage lex.
  assert fused_scan.plan(32, 1025, 1024, torch.bfloat16) == 'cache'
  assert fused_scan.plan(8, 1025, 1024, torch.float32) == 'cache'
  # The largest batch that fits the budget stages; one more row does not.
  for vocab, dtype in ((4096, torch.bfloat16), (8192, torch.float32)):
    fits = budget // per_state(vocab, dtype)
    assert fused_scan.plan(fits, vocab + 1, vocab, dtype) == 'cache'
    assert fused_scan.plan(fits + 1, vocab + 1, vocab, dtype) == 'online'
