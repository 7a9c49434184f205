"""The port's TransformerEncoder against the JAX package.

2 layers, width 16, 2 heads, FFN 32; the same converted parameters and
numpy frames through both: rtol 1e-5 / atol 1e-5 (float32, summation
order and transcendental rounding only).
"""

import jax
import numpy as np
import numpy.testing as npt
import pytest
import torch

from last_torch_tpu.models import encoder as jax_encoder
from last_torch_tpu_torch import convert
from last_torch_tpu_torch.models import encoder

torch.set_num_threads(1)
torch.set_float32_matmul_precision('highest')

FEATURES, WIDTH, LAYERS, HEADS, FFN = 6, 16, 2, 2, 32
NUM_FRAMES = np.array([12, 7, 1], np.int32)

VARIANTS = {
    'non_causal': dict(),
    'causal_window': dict(causal=True, window=4, banded_attention=False),
    # JAX takes its banded route here (T > 2 * window); the port computes
    # the same masks densely.
    'conformer': dict(causal=True, window=4, conv_kernel=3),
}


@pytest.mark.parametrize('variant', sorted(VARIANTS))
def test_encoder_matches_jax(variant):
  kwargs = dict(feature_size=FEATURES, model_size=WIDTH, num_layers=LAYERS,
                num_heads=HEADS, ffn_size=FFN, **VARIANTS[variant])
  jax_enc = jax_encoder.TransformerEncoder(**kwargs)
  params = jax.tree.map(np.asarray, jax_enc.init(jax.random.PRNGKey(0)))
  rng = np.random.default_rng(0)
  frames = rng.standard_normal(
      (len(NUM_FRAMES), 12, FEATURES)).astype(np.float32)

  expected = np.asarray(jax_enc.apply(params, frames, NUM_FRAMES))
  if 'banded_attention' in kwargs:
    del kwargs['banded_attention']  # the port's auto setting is dense
  got = encoder.TransformerEncoder(**kwargs).apply(
      convert.from_jax_params(params, device='cpu'), torch.from_numpy(frames),
      torch.from_numpy(NUM_FRAMES))

  assert got.dtype == torch.float32
  npt.assert_allclose(got.numpy(), expected, rtol=1e-5, atol=1e-5)
  assert np.all(got.numpy()[1, 7:] == 0.0)  # padding frames zeroed


def test_positions_interleave_sin_and_cos():
  pe = encoder._sinusoidal_positions(5, 8, 'cpu').numpy()
  expected = np.asarray(jax_encoder._sinusoidal_positions(5, 8))
  npt.assert_allclose(pe, expected, rtol=1e-6, atol=1e-6)
  npt.assert_allclose(pe[3, 0], np.sin(3.0), rtol=1e-6)
  npt.assert_allclose(pe[3, 1], np.cos(3.0), rtol=1e-6)


def test_init_matches_jax_layout():
  kwargs = dict(feature_size=FEATURES, model_size=WIDTH, num_layers=LAYERS,
                num_heads=HEADS, ffn_size=FFN, conv_kernel=3)
  reference = jax.tree.map(
      np.asarray,
      jax_encoder.TransformerEncoder(**kwargs).init(jax.random.PRNGKey(1)))
  ported = encoder.TransformerEncoder(**kwargs).init(
      torch.Generator().manual_seed(1), device='cpu')
  flat_ref, _ = jax.tree_util.tree_flatten_with_path(reference)
  flat_port, _ = jax.tree_util.tree_flatten_with_path(
      jax.tree.map(lambda x: x.numpy(), ported))
  assert [p for p, _ in flat_port] == [p for p, _ in flat_ref]
  for (path, a), (_, b) in zip(flat_port, flat_ref):
    assert a.shape == b.shape, path


def test_banded_attention_is_not_ported():
  enc = encoder.TransformerEncoder(feature_size=FEATURES, model_size=WIDTH,
                                   num_heads=HEADS, causal=True, window=4,
                                   banded_attention=True)
  with pytest.raises(NotImplementedError, match='ROADMAP'):
    enc.attention_inputs(torch.ones((1, 12), dtype=torch.bool))
