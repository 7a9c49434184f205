"""The counting functions and the trace arithmetic against counts worked
out by hand at small shapes."""

import numpy as np
import pytest
import torch

from portbench.harness import counting, judge, trace


def test_head_product_and_kernel_counts():
  # 2 * rows * S * h * V = 2 * 3 * 5 * 4 * 6
  assert counting.head_product_flops(3, 5, 4, 6) == 720


def test_encoder_count():
  config = dict(feature_size=2, encoder_size=4, encoder_ffn_size=8,
                encoder_layers=1)
  # T=3: input 2*3*2*4 = 48; qkv 2*3*4*12 = 288; logits and context
  # 2 * 2*3*3*4 = 144; output 2*3*4*4 = 96; feed-forward 2 * 2*3*4*8 = 384.
  assert counting.encoder_flops(config, [3]) == 48 + 288 + 144 + 96 + 384
  assert counting.encoder_flops(config, [3, 3]) == 2 * 960


def test_projection_count():
  config = dict(encoder_size=4, hidden_size=5)
  # 2 * (3 + 2) frames * 4 * 5
  assert counting.frame_projection_flops(config, [3, 2]) == 200


def test_decode_least_time_adds_its_parts():
  config = dict(feature_size=2, encoder_size=4, encoder_ffn_size=8,
                encoder_layers=1, hidden_size=5, vocab_size=6)
  lengths = [3, 2]
  f32, bf16 = counting.PEAK_OPS['float32'], counting.PEAK_OPS['bfloat16']
  decode = (counting.encoder_flops(config, lengths) +
            counting.frame_projection_flops(config, lengths)) / f32 + \
      counting.head_product_flops(5, 7, 5, 6) / bf16
  assert counting.decode_least_s(config, lengths) == pytest.approx(decode)


def test_bound_takes_the_larger_side():
  assert counting.bound(989e12 * 1e-3, 0, 'bfloat16') == (
      pytest.approx(1.0), 'operations')
  ms, by = counting.bound(0, 3.35e12 * 2e-3, 'float32')
  assert (ms, by) == (pytest.approx(2.0), 'bytes')
  x = torch.zeros((3, 4), dtype=torch.bfloat16)
  assert counting.nbytes(x, None, torch.zeros(5)) == 3 * 4 * 2 + 5 * 4


def test_busy_union_and_gaps():
  spans = [(10.0, 20.0, 'a'), (15.0, 30.0, 'b'), (50.0, 60.0, 'a')]
  assert trace.busy_intervals(spans) == [[10.0, 30.0], [50.0, 60.0]]
  host = trace.HostRanges()
  # Host ranges on the wall clock in ns; spans in us.
  host.ranges = [('step', (0, 0, 0), (40_000, 0, 40_000)),
                 ('sync', (40_000, 0, 40_000), (70_000, 0, 70_000))]
  reduced = trace.reduce(spans, host, wall_s=70e-6)
  assert reduced['busy_s'] == pytest.approx(30e-6)
  assert reduced['idle_share'] == pytest.approx(1 - 30 / 70)
  assert reduced['activities'] == 3
  ops = dict(reduced['breakdown']['device_ops'])
  assert ops == {'a': pytest.approx(20e-6), 'b': pytest.approx(15e-6)}
  gaps = reduced['breakdown']['idle_gaps']
  # Gaps 0-10 (step), 30-50 (the middle, 40, is where step ends and sync
  # begins: the narrower range wins), 60-70 (sync); longest first.
  assert [g[1] for g in gaps] == pytest.approx([20e-6, 10e-6, 10e-6])
  assert gaps[0][0].startswith('step') or gaps[0][0].startswith('sync')


def test_worst_is_nan_wherever_a_nan_is():
  assert judge.worst([1e-6, 3e-6, 2e-6]) == 3e-6
  assert np.isnan(judge.worst([float('nan'), 1e-6]))
  assert np.isnan(judge.worst([1e-6, float('nan'), 2e-6]))
  assert np.isnan(judge.worst([1e-6, float('nan')]))
  assert not judge.verdict([{'value': judge.worst([float('nan'), 0.0]),
                             'limit': 1.0}])
