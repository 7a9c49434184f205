"""The port's banded attention and StreamingEncoder against the JAX package.

2 layers, width 32, 2 heads, FFN 64, window 4; the same converted
parameters and numpy frames through both packages. Banded against JAX's
banded route and against the port's dense route: rtol / atol 1e-5
(float32, summation order). ``StreamingEncoder.step`` against JAX's chunk
by chunk (outputs and carried caches, 1e-5); chunked against one offline
``apply`` (atol 1e-4, JAX's own limit); chunked positions bit-equal to the
offline ones.
"""

import jax
import numpy as np
import numpy.testing as npt
import pytest
import torch
from torch.utils import _pytree as pytree

from last_torch_tpu.models import encoder as jax_encoder
from last_torch_tpu_torch import convert
from last_torch_tpu_torch.models import encoder

torch.set_num_threads(1)
torch.set_float32_matmul_precision('highest')

FEATURES, WIDTH, LAYERS, HEADS, FFN, WINDOW = 6, 32, 2, 2, 64, 4
# T=13 is no multiple of the window; ragged lengths, one of a single frame.
MAX_T = 13
NUM_FRAMES = np.array([13, 9, 1], np.int32)
CHUNKS = [3, 5, 4, 1]  # sums to MAX_T
CONV = {'transformer': 0, 'conformer': 3}


def kwargs(conv_kernel, **extra):
  return dict(feature_size=FEATURES, model_size=WIDTH, num_layers=LAYERS,
              num_heads=HEADS, ffn_size=FFN, causal=True, window=WINDOW,
              conv_kernel=conv_kernel, **extra)


def setup(conv_kernel, seed=0):
  jax_enc = jax_encoder.TransformerEncoder(**kwargs(conv_kernel))
  params = jax.tree.map(np.asarray, jax_enc.init(jax.random.PRNGKey(seed)))
  frames = np.random.default_rng(seed).standard_normal(
      (len(NUM_FRAMES), MAX_T, FEATURES)).astype(np.float32)
  return params, frames


def port_apply(conv_kernel, params, frames, banded):
  enc = encoder.TransformerEncoder(**kwargs(conv_kernel,
                                            banded_attention=banded))
  return enc.apply(convert.from_jax_params(params, device='cpu'),
                   torch.from_numpy(frames), torch.from_numpy(NUM_FRAMES))


@pytest.mark.parametrize('name', sorted(CONV))
def test_banded_matches_jax_banded_and_port_dense(name):
  params, frames = setup(CONV[name])
  jax_enc = jax_encoder.TransformerEncoder(
      **kwargs(CONV[name], banded_attention=True))
  expected = np.asarray(jax_enc.apply(params, frames, NUM_FRAMES))
  banded = port_apply(CONV[name], params, frames, banded=True).numpy()
  dense = port_apply(CONV[name], params, frames, banded=False).numpy()
  npt.assert_allclose(banded, expected, rtol=1e-5, atol=1e-5)
  npt.assert_allclose(banded, dense, rtol=1e-5, atol=1e-5)
  assert np.all(banded[1, 9:] == 0.0) and np.all(banded[2, 1:] == 0.0)


def test_auto_rule_takes_banded_past_twice_the_window():
  enc = encoder.TransformerEncoder(**kwargs(0))
  short = torch.ones((1, 2 * WINDOW), dtype=torch.bool)
  long = torch.ones((1, 2 * WINDOW + 1), dtype=torch.bool)
  assert enc.attention_inputs(short)[0] is False
  assert enc.attention_inputs(long) == (True, None)
  forced = encoder.TransformerEncoder(**kwargs(0, banded_attention=True))
  assert forced.attention_inputs(short)[0] is True
  # No window, or not causal: always dense.
  assert encoder.TransformerEncoder(
      feature_size=FEATURES, causal=True,
      banded_attention=True).attention_inputs(long)[0] is False


def test_banded_gradients_match_dense():
  params, frames = setup(CONV['conformer'], seed=1)
  grads = {}
  for banded in (True, False):
    tree = convert.from_jax_params(params, device='cpu')
    for leaf in pytree.tree_leaves(tree):
      leaf.requires_grad_(True)
    enc = encoder.TransformerEncoder(**kwargs(CONV['conformer'],
                                              banded_attention=banded))
    out = enc.apply(tree, torch.from_numpy(frames),
                    torch.from_numpy(NUM_FRAMES))
    (out * torch.linspace(-1, 1, out.shape[-1])).sum().backward()
    grads[banded] = [leaf.grad for leaf in pytree.tree_leaves(tree)]
  scale = max(g.abs().max().item() for g in grads[False])
  for got, want in zip(grads[True], grads[False]):
    npt.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5 * scale)


def stream_port(conv_kernel, params, frames):
  stream = encoder.StreamingEncoder(encoder.TransformerEncoder(
      **kwargs(conv_kernel)))
  torch_params = convert.from_jax_params(params, device='cpu')
  state = stream.init_state(frames.shape[0], device='cpu')
  outs, states, start = [], [], 0
  for size in CHUNKS:
    state, out = stream.step(torch_params,
                             state, torch.from_numpy(frames[:, start:start +
                                                            size]))
    outs.append(out.numpy())
    states.append(state)
    start += size
  return outs, states


@pytest.mark.parametrize('name', sorted(CONV))
def test_streaming_encoder_matches_jax_chunk_by_chunk(name):
  params, frames = setup(CONV[name])
  jax_stream = jax_encoder.StreamingEncoder(
      jax_encoder.TransformerEncoder(**kwargs(CONV[name])))
  jax_state = jax_stream.init_state(frames.shape[0])
  outs, states = stream_port(CONV[name], params, frames)
  start = 0
  for size, out, state in zip(CHUNKS, outs, states):
    jax_state, expected = jax_stream.step(params, jax_state,
                                          frames[:, start:start + size])
    start += size
    npt.assert_allclose(out, np.asarray(expected), rtol=1e-5, atol=1e-5)
    assert state['pos'] == int(jax_state['pos']) == start
    for key in ('k', 'v') + (('conv',) if CONV[name] else ()):
      npt.assert_allclose(state[key].numpy(), np.asarray(jax_state[key]),
                          rtol=1e-5, atol=1e-5, err_msg=key)
  assert set(states[-1]) == set(jax_state)


@pytest.mark.parametrize('name', sorted(CONV))
def test_chunked_matches_offline(name):
  params, frames = setup(CONV[name], seed=2)
  outs, _ = stream_port(CONV[name], params, frames)
  chunked = np.concatenate(outs, axis=1)
  # Every stream full length: the offline mask then covers every frame.
  full = np.full_like(NUM_FRAMES, MAX_T)
  enc = encoder.TransformerEncoder(**kwargs(CONV[name]))
  offline = enc.apply(convert.from_jax_params(params, device='cpu'),
                      torch.from_numpy(frames), torch.from_numpy(full))
  npt.assert_allclose(chunked, offline.numpy(), rtol=0, atol=1e-4)
  # Valid frames of ragged streams agree too: causal attention never looks
  # ahead, so a stream's padding cannot reach its earlier frames.
  ragged = port_apply(CONV[name], params, frames, banded=None).numpy()
  for b, n in enumerate(NUM_FRAMES):
    npt.assert_allclose(chunked[b, :n], ragged[b, :n], rtol=0, atol=1e-4)


def test_streaming_requires_causal_window():
  with pytest.raises(ValueError, match='causal=True and window > 0'):
    encoder.StreamingEncoder(encoder.TransformerEncoder(
        feature_size=FEATURES, causal=True, window=0))
  with pytest.raises(ValueError, match='causal=True and window > 0'):
    encoder.StreamingEncoder(encoder.TransformerEncoder(
        feature_size=FEATURES, window=4))


def test_chunked_positions_equal_offline_bit_for_bit():
  offline = encoder._sinusoidal_positions(1000, WIDTH, 'cpu')
  start = 0
  for size in (7, 64, 1, 300, 628):
    chunk = encoder._sinusoidal_positions_at(
        start + torch.arange(size), WIDTH)
    assert torch.equal(chunk, offline[start:start + size])
    start += size
  npt.assert_allclose(
      offline.numpy(),
      np.asarray(jax_encoder._sinusoidal_positions_at(
          jax.numpy.arange(1000), WIDTH)), rtol=0, atol=1e-5)
