"""The Conformer cell's pieces on the CPU: the configuration through
``spec.load_cell``, the seeded weights against ``ConformerEncoder.init``'s
layout, the two copies of the reference encoder, the driver's control and
its refusal of a program without the Conformer, and the counts."""

import importlib.util

import pytest
import torch
from torch.utils import _pytree as pytree

from portbench.harness import (conformer_counting, conformer_weights, port,
                               spec)
from portbench.reference import conformer_gnat
from portbench.tests import tiny

CELL = 'conformer_decode_b256'
SEED = 2**31 + 31


def test_the_configuration_loads_as_the_cell_states():
  cell = spec.load_cell(CELL, tiny.ROOT)
  assert cell.chips == 1
  assert cell.config['encoder_kind'] == 'conformer'
  assert (cell.config['encoder_size'], cell.config['encoder_layers'],
          cell.config['encoder_heads'], cell.config['encoder_ffn_size'],
          cell.config['encoder_conv_kernel']) == (512, 17, 8, 2048, 32)
  assert cell.traffic['driver'] == 'conformer_decode'
  assert (cell.traffic['batch'], cell.traffic['max_frames']) == (256, 3200)
  names = {m['name'] for m in cell.per_layer}
  assert {'mfu.conformer_decode', 'rel_attention_roofline',
          'subsample_ms.conformer_decode', 'conv_module_ms.conformer_decode',
          'rel_attention_ms.conformer_decode', 'encoder_ms.decode',
          'idle_pct.decode', 'host_held_ms.decode',
          'backtrace_device_ms.decode'} == names
  assert [m['name'] for m in cell.end_to_end] == ['decode_frames_per_s',
                                                  'setup_s']
  model_config = port.model_config(cell.config)
  assert model_config.encoder_kind == 'conformer'


def test_weights_are_laid_out_as_the_ports_init():
  cell = tiny.cell(CELL)
  mine = conformer_weights.make(cell.config,
                                torch.Generator().manual_seed(SEED), 'cpu')
  model = port.gnat().GNATModel(port.model_config(cell.config), device='cpu')
  theirs = model.init(torch.Generator().manual_seed(0))
  mine_leaves, mine_spec = pytree.tree_flatten(mine)
  their_leaves, their_spec = pytree.tree_flatten(theirs)
  assert mine_spec == their_spec
  assert [x.shape for x in mine_leaves] == [x.shape for x in their_leaves]
  assert all(x.dtype == torch.float32 for x in mine_leaves)
  layer = mine['encoder']['layers'][0]
  assert layer['bn_mean'].abs().max() > 0 and layer['bn_var'].min() >= 0.5
  assert layer['pos_bias_u'].abs().max() > 0


def test_the_two_references_give_equal_encodings():
  spec_ = importlib.util.spec_from_file_location(
      'tests_conformer_reference',
      tiny.ROOT / 'tests' / 'reference' / 'conformer.py')
  tests_reference = importlib.util.module_from_spec(spec_)
  spec_.loader.exec_module(tests_reference)
  cell = tiny.cell(CELL)
  cell.config.update(feature_size=20, encoder_size=32, encoder_layers=2,
                     encoder_heads=4, encoder_ffn_size=64)
  params = conformer_weights.make(cell.config,
                                  torch.Generator().manual_seed(SEED), 'cpu')
  frames = torch.randn((3, 90, 20))
  num_frames = torch.tensor([90, 31, 7])
  a = conformer_gnat.encode(params['encoder'], frames, num_frames, 4)
  b = tests_reference.encode(params['encoder'], frames, num_frames, 4)
  assert torch.equal(a, b)


def test_the_control_fails_the_limits():
  cell = tiny.cell(CELL)
  driver = spec.driver(cell)
  control = cell.config['controls'][cell.traffic['driver']]
  numbers = driver.control_decode(cell, SEED, torch.device('cpu'), control,
                                  0.2)
  assert any(n['value'] > cell.limits[n['name']]['limit'] for n in numbers)


def test_a_program_without_the_conformer_stops_at_set_up(monkeypatch):
  """A program whose GNATConfig has no encoder_kind builds its Transformer
  for the configuration: set-up exits at once, naming the cause."""
  cell = tiny.cell(CELL)
  driver = spec.driver(cell)
  config = {k: v for k, v in cell.config.items() if k != 'encoder_kind'}
  monkeypatch.setattr(port, 'model_config',
                      lambda _: port.gnat().GNATConfig(**{
                          k: v for k, v in config.items()
                          if k in port.gnat().GNATConfig.__dataclass_fields__}))
  with pytest.raises(SystemExit, match='not a ConformerEncoder'):
    driver.setup(cell, SEED, torch.device('cpu'))


def test_counts():
  config = spec.load_cell(CELL, tiny.ROOT).config
  assert conformer_counting.output_frames(3200) == 799
  assert conformer_counting.output_frames(6) == 0
  assert conformer_counting.attention_flops(config, 799) == 6 * 799**2 * 512
  # The front end at n = 3200: conv1 [1599, 39] x 512 outputs of 9 terms,
  # conv2 [799, 19] x 512 of 4608, the linear map 9728 -> 512.
  assert conformer_counting.subsample_flops(config, 3200) == (
      2 * 1599 * 39 * 512 * 9 + 2 * 799 * 19 * 512 * 4608 +
      2 * 799 * 9728 * 512)
  lengths = [3200, 401]
  assert conformer_counting.encoder_flops(config, lengths) == sum(
      conformer_counting.subsample_flops(config, n) + 17 *
      conformer_counting.block_flops(config, conformer_counting.output_frames(n))
      for n in lengths)
  least = conformer_counting.attention_least_ms(config, lengths)
  flops = 6 * 512 * (799**2 + 99**2)
  assert least == pytest.approx(17 * flops / 67e12 * 1e3)
