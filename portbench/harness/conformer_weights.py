"""Seeded parameters of a Conformer GNAT on the device, laid out as the
port's ``ConformerEncoder`` and lattice.

As ``weights.py`` makes them: on the device, from a ``torch.Generator``
seeded with ``--seed``, in float32, LeCun-normal dense matrices and
convolution kernels (a normal truncated to two standard deviations, over
the fan-in) in one draw, a standard-normal embedding table in another,
unit layer-norm scales, zero biases. Beside those, so that leaving out a
part changes the result: BatchNorm running means N(0, 0.1^2) and variances
U(0.5, 1.5) (unit scale, zero shift), and the position biases u and v
N(0, 0.1^2), each in a draw of its own.
"""

from __future__ import annotations

import math

import torch

from portbench.harness import weights

LAYER_DENSE = ('ffn1_in', 'ffn1_out', 'ffn2_in', 'ffn2_out', 'qkv', 'pos_proj',
               'attn_out', 'conv_in', 'conv_depth', 'conv_out')


def subsampled_features(feature_size: int) -> int:
  """Feature bins left by the two stride-2 3 x 3 convolutions."""
  return ((feature_size - 1) // 2 - 1) // 2


def dense_shapes(config: dict) -> list[tuple[str, tuple[int, int]]]:
  """(path, [fan_in, fan_out]) of every LeCun-normal leaf, in draw order.
  A convolution kernel is drawn [in * 9, out] and laid out [out, in, 3, 3];
  the depthwise one is [K, d]."""
  f, d = config['feature_size'], config['encoder_size']
  ffn, k = config['encoder_ffn_size'], config['encoder_conv_kernel']
  shapes = [('encoder.subsample.conv1', (9, d)),
            ('encoder.subsample.conv2', (9 * d, d)),
            ('encoder.subsample.proj', (d * subsampled_features(f), d))]
  widths = {'ffn1_in': (d, ffn), 'ffn1_out': (ffn, d), 'ffn2_in': (d, ffn),
            'ffn2_out': (ffn, d), 'qkv': (d, 3 * d), 'pos_proj': (d, d),
            'attn_out': (d, d), 'conv_in': (d, 2 * d), 'conv_depth': (k, d),
            'conv_out': (d, d)}
  for i in range(config['encoder_layers']):
    shapes += [(f'encoder.layers.{i}.{name}', widths[name])
               for name in LAYER_DENSE]
  e, h = config['embedding_size'], config['hidden_size']
  shapes += [('lattice.weight_fn.context_proj', (e, h)),
             ('lattice.weight_fn.frame_proj', (d, h)),
             ('lattice.weight_fn.blank_w', (h, 1)),
             ('lattice.weight_fn.vocab_w', (h, config['vocab_size']))]
  return shapes


def make(config: dict, generator: torch.Generator, device) -> dict:
  """The model's parameters {'encoder': ..., 'lattice': ...}."""
  shapes = dense_shapes(config)
  sizes = [math.prod(shape) for _, shape in shapes]
  flat = torch.empty(sum(sizes), device=device)
  torch.nn.init.trunc_normal_(flat, 0.0, 1.0, -2.0, 2.0, generator=generator)
  dense = {}
  for (path, shape), part in zip(shapes, flat.split(sizes)):
    dense[path] = (part.view(shape) *
                   (math.sqrt(1.0 / shape[0]) / weights._TRUNCATED_STD))
  embedding = torch.empty((weights.num_states(config),
                           config['embedding_size']), device=device)
  embedding.normal_(generator=generator)
  d, layers = config['encoder_size'], config['encoder_layers']
  heads = config['encoder_heads']
  bn_mean = torch.empty((layers, d), device=device).normal_(
      0.0, 0.1, generator=generator)
  bn_var = torch.empty((layers, d), device=device).uniform_(
      0.5, 1.5, generator=generator)
  biases = torch.empty((layers, 2, heads, d // heads), device=device).normal_(
      0.0, 0.1, generator=generator)
  ones = lambda: torch.ones((d,), device=device)
  zeros = lambda *n: torch.zeros(n, device=device)

  def conv(path, channels_in):
    return dense[path].t().reshape(d, channels_in, 3, 3).contiguous()

  encoder = {
      'subsample': {'conv1': conv('encoder.subsample.conv1', 1),
                    'conv2': conv('encoder.subsample.conv2', d),
                    'proj': dense['encoder.subsample.proj']},
      'layers': [],
  }
  for i in range(layers):
    at = lambda name: dense[f'encoder.layers.{i}.{name}']
    layer = {}
    for ffn in ('ffn1', 'ffn2'):
      layer.update({f'{ffn}_ln_scale': ones(), f'{ffn}_ln_bias': zeros(d),
                    f'{ffn}_in': at(f'{ffn}_in'),
                    f'{ffn}_out': at(f'{ffn}_out')})
    layer.update({
        'attn_ln_scale': ones(), 'attn_ln_bias': zeros(d),
        'qkv': at('qkv'), 'pos_proj': at('pos_proj'),
        'pos_bias_u': biases[i, 0], 'pos_bias_v': biases[i, 1],
        'attn_out': at('attn_out'),
        'conv_ln_scale': ones(), 'conv_ln_bias': zeros(d),
        'conv_in': at('conv_in'), 'conv_depth': at('conv_depth'),
        'bn_mean': bn_mean[i], 'bn_var': bn_var[i],
        'bn_scale': ones(), 'bn_bias': zeros(d),
        'conv_out': at('conv_out'),
        'final_ln_scale': ones(), 'final_ln_bias': zeros(d),
    })
    encoder['layers'].append(layer)
  wf = lambda name: dense[f'lattice.weight_fn.{name}']
  return {
      'encoder': encoder,
      'lattice': {
          'cacher': {'embedding': embedding},
          'weight_fn': {'context_proj': wf('context_proj'),
                        'frame_proj': wf('frame_proj'),
                        'blank_w': wf('blank_w')[:, 0].contiguous(),
                        'blank_b': zeros(),
                        'vocab_w': wf('vocab_w'),
                        'vocab_b': zeros(config['vocab_size'])},
      },
  }
