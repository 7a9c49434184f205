"""The general traffic generator: deterministic in the seed, the same sizes
for every seed in another order."""

import torch

from portbench.harness import spec, traffic
from portbench.tests import tiny

BIG_SEED = 2**31 + 12345


def test_same_seed_same_pool_other_seed_same_sizes():
  m = spec.read_json(spec.BENCH_DIR / 'traffic' / 'decode_b384.json')
  config = dict(feature_size=3)
  small = dict(m, batch=m['batch'] // 32, max_frames=m['max_frames'] // 8,
               lengths=dict(m['lengths'], low=m['lengths']['low'] // 8,
                            high=m['lengths']['high'] // 8))
  a = traffic.make_pool(small, config, BIG_SEED, 'cpu')
  b = traffic.make_pool(small, config, BIG_SEED, 'cpu')
  c = traffic.make_pool(small, config, 7, 'cpu')
  assert len(a) == m['pool']
  for x, y in zip(a, b):
    assert torch.equal(x.frames, y.frames)
    assert x.lengths == y.lengths
  assert any(not torch.equal(x.frames, z.frames) for x, z in zip(a, c))
  # One set of sizes in every batch and for every seed, in another order.
  one = sorted(a[0].lengths)
  assert all(sorted(x.lengths) == one for x in a + c)
  assert len({tuple(x.lengths) for x in a + c}) > 1


def test_pool_contents():
  cell = tiny.cell('gn_decode_b384')
  pool = traffic.make_pool(cell.traffic, cell.config, BIG_SEED, 'cpu')
  low, high = cell.traffic['lengths']['low'], cell.traffic['lengths']['high']
  for batch in pool:
    steps = torch.arange(cell.traffic['max_frames'])
    padded = steps[None, :] >= batch.num_frames[:, None]
    assert bool((batch.frames[padded] == 0).all())
    assert batch.real_frames == int(batch.num_frames.sum())
    assert batch.lengths == batch.num_frames.tolist()
    assert low <= min(batch.lengths) and max(batch.lengths) <= high
