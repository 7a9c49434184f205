"""Seeded parameters on the device, laid out as the port's.

The benchmark makes the weights itself, so that the program and the
reference are handed the same ones: on the device, from a
``torch.Generator`` seeded with ``--seed``, in three large draws (one for
every dense matrix, one for the embedding table, none for the constants),
in float32, the type the port keeps its parameters in. The distributions
are the port's initializers': LeCun-normal dense matrices (a normal
truncated to two standard deviations, scaled to 1 / sqrt(fan_in)), a
standard-normal embedding table, unit layer-norm scales, zero biases.
"""

from __future__ import annotations

import math

import torch

# Standard deviation of a standard normal truncated to [-2, 2].
_TRUNCATED_STD = 0.87962566103423978


def dense_shapes(config: dict) -> list[tuple[str, tuple[int, ...]]]:
  """(path, shape) of every LeCun-normal leaf, in draw order."""
  f, d = config['feature_size'], config['encoder_size']
  ffn, h = config['encoder_ffn_size'], config['hidden_size']
  shapes = [('encoder.input_proj', (f, d))]
  for i in range(config['encoder_layers']):
    shapes += [(f'encoder.layers.{i}.qkv', (d, 3 * d)),
               (f'encoder.layers.{i}.attn_out', (d, d)),
               (f'encoder.layers.{i}.ffn_in', (d, ffn)),
               (f'encoder.layers.{i}.ffn_out', (ffn, d))]
  e = config['embedding_size']
  shapes += [('lattice.weight_fn.context_proj', (e, h)),
             ('lattice.weight_fn.frame_proj', (d, h)),
             ('lattice.weight_fn.blank_w', (h, 1)),
             ('lattice.weight_fn.vocab_w', (h, config['vocab_size']))]
  return shapes


def num_states(config: dict) -> int:
  """Context states of a bigram FullNGram: the start and one a label."""
  if config['context_size'] != 1:
    raise ValueError('the benchmark lays out bigram contexts only')
  return config['vocab_size'] + 1


def make(config: dict, generator: torch.Generator, device) -> dict:
  """The model's parameters {'encoder': ..., 'lattice': ...}."""
  shapes = dense_shapes(config)
  sizes = [math.prod(shape) for _, shape in shapes]
  flat = torch.empty(sum(sizes), device=device)
  torch.nn.init.trunc_normal_(flat, 0.0, 1.0, -2.0, 2.0, generator=generator)
  dense = {}
  for (path, shape), part in zip(shapes, flat.split(sizes)):
    dense[path] = (part.view(shape) *
                   (math.sqrt(1.0 / shape[0]) / _TRUNCATED_STD))
  embedding = torch.empty((num_states(config), config['embedding_size']),
                          device=device)
  embedding.normal_(generator=generator)
  d = config['encoder_size']
  ones = lambda n: torch.ones((n,), device=device)
  zeros = lambda *n: torch.zeros(n, device=device)
  layers = []
  for i in range(config['encoder_layers']):
    at = lambda name: dense[f'encoder.layers.{i}.{name}']
    layers.append({
        'ln1_scale': ones(d), 'ln1_bias': zeros(d),
        'qkv': at('qkv'), 'attn_out': at('attn_out'),
        'ln2_scale': ones(d), 'ln2_bias': zeros(d),
        'ffn_in': at('ffn_in'), 'ffn_out': at('ffn_out'),
    })
  wf = lambda name: dense[f'lattice.weight_fn.{name}']
  return {
      'encoder': {'input_proj': dense['encoder.input_proj'],
                  'layers': layers,
                  'final_ln_scale': ones(d), 'final_ln_bias': zeros(d)},
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
