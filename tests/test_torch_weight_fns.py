"""The port's JointWeightFn and SharedEmbCacher against the JAX package.

Same parameters (JAX init, converted) and the same numpy frames through
both packages, float32: rtol 1e-5 / atol 1e-6 (summation order only).
"""

import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

from last_torch_tpu import weight_fns as jax_weight_fns
from last_torch_tpu_torch import convert, initializers, weight_fns

torch.set_num_threads(1)
torch.set_float32_matmul_precision('highest')

NUM_STATES, EMBEDDING, FEATURES, HIDDEN, VOCAB = 6, 8, 5, 7, 11


def jax_params(seed):
  cacher = jax_weight_fns.SharedEmbCacher(NUM_STATES, EMBEDDING)
  joint = jax_weight_fns.JointWeightFn(vocab_size=VOCAB, hidden_size=HIDDEN)
  k_cacher, k_joint = jax.random.split(jax.random.PRNGKey(seed))
  cacher_params = cacher.init(k_cacher)
  joint_params = joint.init(k_joint, cacher.apply(cacher_params),
                            jnp.zeros((FEATURES,)))
  # A non-zero bias exercises the bias adds.
  joint_params['blank_b'] = jnp.asarray(0.25)
  joint_params['vocab_b'] = jnp.linspace(-1.0, 1.0, VOCAB)
  return jax.tree.map(np.asarray, (cacher_params, joint_params))


def test_shared_emb_cacher_matches_jax():
  cacher_params, _ = jax_params(0)
  cache_j = jax_weight_fns.SharedEmbCacher(NUM_STATES, EMBEDDING).apply(
      cacher_params)
  cache_t = weight_fns.SharedEmbCacher(NUM_STATES, EMBEDDING).apply(
      convert.from_jax_params(cacher_params, device='cpu'))
  npt.assert_array_equal(cache_t.numpy(), np.asarray(cache_j))


@pytest.mark.parametrize('with_state', [False, True])
@pytest.mark.parametrize('compute_dtype', [None, 'bfloat16'])
def test_joint_weight_fn_matches_jax(compute_dtype, with_state):
  cacher_params, joint_params = jax_params(1)
  rng = np.random.default_rng(1)
  frame = rng.standard_normal((3, 2, FEATURES)).astype(np.float32)
  state = rng.integers(0, NUM_STATES, (3, 2)) if with_state else None

  jax_fn = jax_weight_fns.JointWeightFn(
      vocab_size=VOCAB, hidden_size=HIDDEN,
      compute_dtype=compute_dtype and jnp.bfloat16)
  blank_j, lexical_j = jax_fn.apply(
      joint_params, cacher_params['embedding'], frame,
      None if state is None else jnp.asarray(state))

  torch_fn = weight_fns.JointWeightFn(
      vocab_size=VOCAB, hidden_size=HIDDEN,
      compute_dtype=compute_dtype and torch.bfloat16)
  blank_t, lexical_t = torch_fn.apply(
      convert.from_jax_params(joint_params, device='cpu'),
      convert.from_jax_params(cacher_params, device='cpu')['embedding'],
      torch.from_numpy(frame),
      None if state is None else torch.from_numpy(state))

  assert blank_t.shape == blank_j.shape
  assert lexical_t.shape == lexical_j.shape
  npt.assert_allclose(blank_t.numpy(), np.asarray(blank_j), rtol=1e-5,
                      atol=1e-6)
  npt.assert_allclose(lexical_t.numpy(), np.asarray(lexical_j), rtol=1e-5,
                      atol=1e-6)


def test_init_shapes_and_distributions_match_jax():
  cacher_params_j, joint_params_j = jax_params(2)
  generator = torch.Generator().manual_seed(2)
  cacher = weight_fns.SharedEmbCacher(NUM_STATES, EMBEDDING)
  cacher_params = cacher.init(generator, device='cpu')
  joint_params = weight_fns.JointWeightFn(
      vocab_size=VOCAB, hidden_size=HIDDEN).init(
          generator, cacher.apply(cacher_params), torch.zeros((FEATURES,)))
  for ported, reference in ((cacher_params, cacher_params_j),
                            (joint_params, joint_params_j)):
    assert ported.keys() == reference.keys()
    for key in ported:
      assert tuple(ported[key].shape) == reference[key].shape, key
      assert ported[key].dtype == torch.float32, key
  # lecun_normal: truncated at 2 standard deviations of the fan-in scale.
  bound = 2.0 * (1.0 / HIDDEN)**0.5 / initializers._TRUNCATED_STD
  assert joint_params['vocab_w'].abs().max() <= bound
  big = initializers.lecun_normal((400, 400), generator)
  npt.assert_allclose(big.std().item(), (1.0 / 400)**0.5, rtol=0.02)
