"""The port's serving slice, GNATModel.decode, against the JAX package.

A small GNATConfig; JAX parameters from init(PRNGKey), converted, and the
same numpy features through both packages' decode (encoder + Viterbi):
labels and counts equal, path weights to rtol 1e-5 / atol 1e-6 (float32).
"""

import dataclasses

import jax
import numpy as np
import numpy.testing as npt
import pytest
import torch

from last_torch_tpu.models import gnat as jax_gnat
from last_torch_tpu.models import presets as jax_presets
from last_torch_tpu_torch import convert
from last_torch_tpu_torch.models import gnat, presets
from last_torch_tpu_torch.ops import viterbi

torch.set_num_threads(1)
torch.set_float32_matmul_precision('highest')

SMALL = dict(feature_size=6, vocab_size=7, encoder_size=16, encoder_layers=2,
             encoder_heads=2, encoder_ffn_size=32, hidden_size=12,
             embedding_size=10)
NUM_FRAMES = np.array([9, 5, 0, 1], np.int32)


@pytest.mark.parametrize('max_expansions', [0, 2])
def test_decode_matches_jax(max_expansions):
  fields = dict(SMALL, max_expansions=max_expansions)
  jax_model = jax_gnat.GNATModel(jax_gnat.GNATConfig(**fields))
  params = jax.tree.map(np.asarray, jax_model.init(jax.random.PRNGKey(0)))
  rng = np.random.default_rng(0)
  frames = rng.standard_normal(
      (len(NUM_FRAMES), 9, fields['feature_size'])).astype(np.float32)
  labels_j, num_j, weights_j = jax_model.decode(params, frames, NUM_FRAMES)

  model = gnat.GNATModel(gnat.GNATConfig(**fields), device='cpu')
  before = viterbi.launches
  labels_t, num_t, weights_t = model.decode(
      convert.from_jax_params(params, device='cpu'), frames, NUM_FRAMES)

  assert model.lattice.last_path == 'plain'
  assert viterbi.launches == before
  npt.assert_array_equal(labels_t.numpy(), np.asarray(labels_j))
  npt.assert_array_equal(num_t.numpy(), np.asarray(num_j))
  npt.assert_allclose(weights_t.numpy(), np.asarray(weights_j), rtol=1e-5,
                      atol=1e-6)
  # Lexical labels do occur: the comparison is not all-blank.
  assert np.any(labels_t.numpy() > 0)


@pytest.mark.parametrize('name', ['ctc_like', 'hat_bigram',
                                  'gnat_global_bigram',
                                  'streaming_conformer_gnat'])
def test_presets_match_jax(name):
  ported = getattr(presets, name)(vocab_size=33, encoder_layers=3)
  reference = getattr(jax_presets, name)(vocab_size=33, encoder_layers=3)
  assert dataclasses.asdict(ported) == dataclasses.asdict(reference)
  assert dataclasses.asdict(getattr(presets, name)()) == dataclasses.asdict(
      getattr(jax_presets, name)())


def test_init_from_generator_is_seeded_and_decodes():
  config = gnat.GNATConfig(**SMALL)
  model = gnat.GNATModel(config, device='cpu')
  params = model.init(torch.Generator().manual_seed(5))
  again = model.init(torch.Generator().manual_seed(5))
  torch.testing.assert_close(params, again, rtol=0, atol=0)
  reference = jax.tree.map(
      np.asarray, jax_gnat.GNATModel(jax_gnat.GNATConfig(**SMALL)).init(
          jax.random.PRNGKey(5)))
  assert (jax.tree.map(lambda x: tuple(x.shape), params) ==
          jax.tree.map(lambda x: x.shape, reference))
  frames = np.random.default_rng(5).standard_normal(
      (2, 6, SMALL['feature_size'])).astype(np.float32)
  labels, num, weights = model.decode(params, frames, np.array([6, 3]))
  assert labels.shape == (2, 6 * (config.max_expansions + 1))
  npt.assert_array_equal(num.numpy(), [18, 9])
  assert torch.isfinite(weights).all()
  assert labels.min() >= 0 and labels.max() <= SMALL['vocab_size']


def test_unported_configs_raise():
  # The RNN-cacher model, once unported, builds and decodes on the CPU.
  model = gnat.GNATModel(gnat.GNATConfig(**SMALL, use_rnn_cacher=True),
                         device='cpu')
  params = model.init(torch.Generator().manual_seed(2))
  assert set(params['lattice']['cacher']) == {'embedding', 'cell'}
  labels, num, weights = model.decode(params, np.zeros((1, 4, 6), np.float32),
                                      np.array([4]))
  assert model.lattice.last_path == 'plain'
  assert torch.isfinite(weights).all() and num.tolist() == [12]
