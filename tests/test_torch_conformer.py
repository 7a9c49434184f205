"""The port's Conformer encoder (``models/encoder.py::ConformerEncoder``) and
its relative-position attention against the plain reference
``tests/reference/conformer.py``, on the CPU at a small size (d=64, 4 heads,
2 blocks, kernel 32, up to 200 frames) on seeded weights, and the Conformer
GNAT's decode against that reference encoder plus the benchmark's lattice
reference (``portbench/reference/gnat.py``). Imports no JAX.
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from last_torch_tpu_torch.models import encoder as encoder_lib
from last_torch_tpu_torch.models import gnat, presets
from last_torch_tpu_torch.ops import rel_attention

torch.set_num_threads(1)
torch.set_float32_matmul_precision('highest')

ROOT = pathlib.Path(__file__).resolve().parent.parent
FEATURES, WIDTH, HEADS, LAYERS, FFN, KERNEL = 20, 64, 4, 2, 128, 32
# Float32 on both sides with the same products summed in other orders (the
# port gathers the position scores where the reference shifts them, folds
# BatchNorm into one scale and shift, and layer-normalises with rsqrt):
# ~1e-6 of encodings of size ~3 over two blocks; the removed parts below
# move them by 1e-2 or more.
ATOL, RTOL = 2e-5, 1e-5


def load(path, name):
  spec = importlib.util.spec_from_file_location(name, ROOT / path)
  module = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(module)
  return module


reference = load('tests/reference/conformer.py', 'conformer_reference')
lattice_reference = load('portbench/reference/gnat.py',
                         'conformer_lattice_reference')


def make_encoder():
  return encoder_lib.ConformerEncoder(
      feature_size=FEATURES, model_size=WIDTH, num_layers=LAYERS,
      num_heads=HEADS, ffn_size=FFN, conv_kernel=KERNEL)


def seeded_params(encoder, seed=1):
  """``init``'s parameters with BatchNorm's running statistics, the
  position biases and the layer norms drawn away from their starting
  values, so that leaving any of them out moves the output."""
  params = encoder.init(torch.Generator().manual_seed(seed), 'cpu')
  g = torch.Generator().manual_seed(seed + 100)
  d, hd = encoder.model_size, encoder.model_size // encoder.num_heads
  for layer in params['layers']:
    layer['bn_mean'] = torch.randn(d, generator=g) * 0.1
    layer['bn_var'] = torch.rand(d, generator=g) + 0.5
    layer['pos_bias_u'] = torch.randn(encoder.num_heads, hd, generator=g) * 0.1
    layer['pos_bias_v'] = torch.randn(encoder.num_heads, hd, generator=g) * 0.1
    for name in ('ffn1', 'attn', 'conv', 'ffn2', 'final'):
      layer[f'{name}_ln_scale'] = 1.0 + 0.1 * torch.randn(d, generator=g)
      layer[f'{name}_ln_bias'] = 0.1 * torch.randn(d, generator=g)
  return params


def batch(lengths, max_t=200, seed=3):
  rng = np.random.default_rng(seed)
  frames = torch.from_numpy(
      rng.standard_normal((len(lengths), max_t, FEATURES)).astype(np.float32))
  num_frames = torch.tensor(lengths)
  frames *= (torch.arange(max_t) < num_frames[:, None])[..., None]
  return frames, num_frames


def test_encoder_matches_the_reference():
  encoder = make_encoder()
  params = seeded_params(encoder)
  frames, num_frames = batch([200, 57, 7, 131])
  got = encoder.apply(params, frames, num_frames)
  want = reference.encode(params, frames, num_frames, HEADS)
  assert got.shape == want.shape == (4, 49, WIDTH)
  torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)
  lengths = encoder.output_frames(num_frames)
  for row, n in enumerate(lengths.tolist()):
    assert torch.all(got[row, n:] == 0)


def drop_batch_norm(params):
  for layer in params['layers']:
    layer['bn_mean'] = torch.zeros_like(layer['bn_mean'])
    layer['bn_var'] = torch.full_like(layer['bn_var'], 1.0 - 1e-5)


def drop_position_biases(params):
  for layer in params['layers']:
    layer['pos_bias_u'] = torch.zeros_like(layer['pos_bias_u'])
    layer['pos_bias_v'] = torch.zeros_like(layer['pos_bias_v'])


@pytest.mark.parametrize('removed', ['batch_norm', 'position_biases',
                                     'block_norm'])
def test_removing_a_part_breaks_the_encoder_test(monkeypatch, removed):
  """A reference without BatchNorm, without u and v, or without each
  block's closing LayerNorm differs from the port by more than the
  tolerance: the comparison sees each part."""
  encoder = make_encoder()
  params = seeded_params(encoder)
  frames, num_frames = batch([200, 57, 7, 131])
  got = encoder.apply(params, frames, num_frames)
  changed = seeded_params(encoder)
  if removed == 'batch_norm':
    drop_batch_norm(changed)
  elif removed == 'position_biases':
    drop_position_biases(changed)
  else:
    closing = {id(layer['final_ln_scale']) for layer in changed['layers']}
    norm = reference.layer_norm
    monkeypatch.setattr(
        reference, 'layer_norm',
        lambda x, scale, bias, eps=1e-6: (x if id(scale) in closing else
                                          norm(x, scale, bias, eps)))
  want = reference.encode(changed, frames, num_frames, HEADS)
  gap = (got - want).abs() - RTOL * want.abs()
  assert gap.max() > 100 * ATOL


@pytest.mark.parametrize('b,t,h,hd,lengths', [
    (2, 9, 3, 4, [9, 4]),
    (3, 17, 2, 8, [17, 1, 10]),
    (1, 1, 2, 4, [1]),
])
def test_plain_attention_matches_the_rel_shift_formulation(b, t, h, hd,
                                                           lengths):
  g = torch.Generator().manual_seed(b * 100 + t)
  q, k, v = (torch.randn((b, t, h, hd), generator=g) for _ in range(3))
  pos = torch.randn((2 * t - 1, h * hd), generator=g)
  u, vb = (torch.randn((h, hd), generator=g) for _ in range(2))
  lengths = torch.tensor(lengths)
  got = rel_attention.rel_attention(q, k, v, pos, u, vb, lengths)
  # The reference's composition: ESPnet's rel_shift of the scores at every
  # distance, an additive -1e9 key mask, outputs past a row's length 0.
  qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))
  p = pos.reshape(2 * t - 1, h, hd).transpose(0, 1)
  content = (qh + u[None, :, None]) @ kh.transpose(-1, -2)
  position = reference.rel_shift((qh + vb[None, :, None]) @
                                 p.transpose(-1, -2)[None])
  live = torch.arange(t)[None] < lengths[:, None]
  key_bias = torch.where(live, 0.0, reference.MASKED)[:, None, None, :]
  weights = torch.softmax((content + position) / hd**0.5 + key_bias, dim=-1)
  want = (weights @ vh).transpose(1, 2) * live[:, :, None, None]
  torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)


def test_output_frames_match_the_references_convolutions():
  encoder = make_encoder()
  params = seeded_params(encoder)['subsample']
  for n in range(7, 65):
    frames = torch.randn((1, n, FEATURES))
    out = reference.subsample(params, frames)
    assert encoder.output_frames(torch.tensor([n])).tolist() == [out.shape[1]]
    assert reference.output_frames(torch.tensor([n])).tolist() == [
        out.shape[1]]


def small_model():
  config = presets.conformer_l_gnat(
      vocab_size=12, feature_size=FEATURES, encoder_size=WIDTH,
      encoder_layers=LAYERS, encoder_heads=HEADS, encoder_ffn_size=FFN,
      hidden_size=32, embedding_size=32)
  model = gnat.GNATModel(config, device='cpu')
  params = model.init(torch.Generator().manual_seed(5))
  params['encoder'] = seeded_params(model.encoder, seed=6)
  return model, params


def test_the_preset_is_conformer_l():
  config = presets.conformer_l_gnat()
  assert (config.encoder_kind, config.encoder_size, config.encoder_layers,
          config.encoder_heads, config.encoder_ffn_size,
          config.encoder_conv_kernel) == ('conformer', 512, 17, 8, 2048, 32)
  assert (config.vocab_size, config.context_size, config.max_expansions,
          config.locally_normalized, config.hidden_size,
          config.embedding_size) == (1024, 1, 2, False, 512, 512)
  assert isinstance(gnat.GNATModel(config, device='cpu').encoder,
                    encoder_lib.ConformerEncoder)


def test_an_utterance_decodes_alone_as_in_a_padded_batch():
  model, params = small_model()
  frames, num_frames = batch([200, 57, 7, 131])
  labels, num_labels, weights = model.decode(params, frames, num_frames)
  for row, n in enumerate(num_frames.tolist()):
    one_labels, one_num, one_weight = model.decode(
        params, frames[row:row + 1, :n], num_frames[row:row + 1])
    m = int(one_num[0])
    assert int(num_labels[row]) == m == 3 * int(
        model.encoder.output_frames(num_frames[row]))
    assert torch.equal(labels[row, :m], one_labels[0, :m])
    assert torch.all(labels[row, m:] == 0)
    torch.testing.assert_close(weights[row], one_weight[0], atol=1e-4,
                               rtol=1e-5)


def test_gnat_decode_matches_the_reference_encoder_and_viterbi():
  model, params = small_model()
  frames, num_frames = batch([200, 57, 7, 131])
  labels, num_labels, weights = model.decode(params, frames, num_frames)
  encoded = reference.encode(params['encoder'], frames, num_frames, HEADS)
  lengths = reference.output_frames(num_frames)
  pc, pf = lattice_reference.projections(params['lattice'], encoded)
  wf = params['lattice']['weight_fn']
  best, _ = lattice_reference.viterbi(wf, pc, pf, lengths, 2, None, 'none',
                                      with_path=False)
  rescored = lattice_reference.rescore(wf, pc, pf, lengths, labels, 2, None,
                                       'none')
  assert torch.equal(num_labels.long(), 3 * lengths)
  # float32 lattices over the two encoders' outputs (equal to ~1e-6):
  # path weights of size ~10-100.
  torch.testing.assert_close(weights, best, atol=1e-4, rtol=1e-5)
  torch.testing.assert_close(weights.double(), rescored, atol=1e-4,
                             rtol=1e-5)
