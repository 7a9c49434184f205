"""The plain reference against the port's own CPU path (its kernels' plain
versions in float32) at a tiny size, on the benchmark's seeded weights."""

import pytest
import torch
from torch.utils import _pytree as pytree

from portbench.harness import port, traffic, weights
from portbench.reference import gnat as reference
from portbench.tests import tiny

SEED = 2**31 + 77
CELLS = ['gn_decode_b384', 'hat_decode_b384']


def setup(name):
  cell = tiny.cell(name)
  params = weights.make(cell.config, torch.Generator('cpu').manual_seed(SEED),
                        'cpu')
  pool = traffic.make_pool(cell.traffic, cell.config, SEED, 'cpu')
  model = port.gnat().GNATModel(port.model_config(cell.config),
                                device='cpu')
  return cell, params, pool, model


@pytest.mark.parametrize('name', CELLS)
def test_weights_are_laid_out_as_the_port(name):
  cell, params, _, model = setup(name)
  theirs = model.init(torch.Generator().manual_seed(0))
  mine_leaves, mine_spec = pytree.tree_flatten(params)
  their_leaves, their_spec = pytree.tree_flatten(theirs)
  assert mine_spec == their_spec
  assert [x.shape for x in mine_leaves] == [x.shape for x in their_leaves]
  assert all(x.dtype == torch.float32 for x in mine_leaves)


@pytest.mark.parametrize('name', CELLS)
def test_viterbi_matches_the_port(name):
  cell, params, pool, model = setup(name)
  k = cell.config['max_expansions']
  normalize = 'hat' if cell.config['locally_normalized'] else 'none'
  for batch in pool[:2]:
    labels, num_labels, path_weights = model.decode(params, batch.frames,
                                                    batch.num_frames)
    with torch.no_grad():
      encoded = reference.encode(params['encoder'], batch.frames,
                                 batch.num_frames,
                                 cell.config['encoder_heads'])
      pc, pf = reference.projections(params['lattice'], encoded)
    wf = params['lattice']['weight_fn']
    best, path = reference.viterbi(wf, pc, pf, batch.num_frames, k,
                                   torch.float32, normalize, with_path=True)
    assert torch.allclose(path_weights, best, rtol=1e-5, atol=1e-5)
    mine = reference.rescore(wf, pc, pf, batch.num_frames, labels, k,
                             torch.float32, normalize)
    own = reference.rescore(wf, pc, pf, batch.num_frames, path, k,
                            torch.float32, normalize)
    assert torch.allclose(mine, best.double(), rtol=1e-5, atol=1e-5)
    assert torch.allclose(own, best.double(), rtol=1e-5, atol=1e-5)
    assert torch.equal(num_labels.long(), (k + 1) * batch.num_frames)


@pytest.mark.parametrize('name', CELLS)
def test_bfloat16_head_products_match_the_ports_plain_versions(name):
  """The reference's Viterbi at the card's rounding points against the
  port's plain version of its kernel in bfloat16, on the CPU."""
  from last_torch_tpu_torch.ops import viterbi
  cell, params, pool, _ = setup(name)
  k = cell.config['max_expansions']
  normalize = 'hat' if cell.config['locally_normalized'] else 'none'
  batch = pool[0]
  wf = params['lattice']['weight_fn']
  with torch.no_grad():
    encoded = reference.encode(params['encoder'], batch.frames,
                               batch.num_frames, cell.config['encoder_heads'])
    labels, _, got = viterbi.viterbi_decode(
        wf, params['lattice']['cacher']['embedding'], encoded,
        batch.num_frames, max_expansions=k, frame_dependent=False,
        compute_dtype=torch.bfloat16, normalize=normalize)
    pc, pf = reference.projections(params['lattice'], encoded)
  want, _ = reference.viterbi(wf, pc, pf, batch.num_frames, k,
                              torch.bfloat16, normalize, with_path=False)
  rescored = reference.rescore(wf, pc, pf, batch.num_frames, labels, k,
                               torch.bfloat16, normalize)
  assert torch.allclose(got, want, rtol=1e-5, atol=1e-5)
  assert torch.allclose(rescored, want.double(), rtol=1e-5, atol=1e-5)
