"""The streaming serving path and the trainer's helpers on the card, without
JAX.

On CUDA tensors against the same calls on CPU tensors: the batches that
``data.prefetch_to_device`` stages from its side stream equal their host
arrays; ``StreamingEncoder`` (banded offline attention among its checks)
and the greedy and beam decoders agree with their CPU runs (encodings to
atol 1e-5 with TF32 off, labels equal, beam scores to rtol 1e-5); a
``CheckpointManager`` round trip of a train state on the card is bit-exact
and stays on the card. Every test needs a GPU and skips without one; run
them there with

    python -m pytest tests/test_torch_card_serving.py -q -m cuda --noconftest

(``--noconftest`` skips ``tests/conftest.py``, which imports JAX.)
"""

import numpy as np
import numpy.testing as npt
import pytest
import torch
from torch.utils import _pytree as pytree

from last_torch_tpu_torch import data, streaming
from last_torch_tpu_torch.models import encoder as encoder_lib
from last_torch_tpu_torch.models import gnat, presets
from last_torch_tpu_torch.models import train as train_lib
from last_torch_tpu_torch.utils import checkpoint

torch.set_num_threads(1)
torch.set_float32_matmul_precision('highest')

SMALL = dict(vocab_size=16, feature_size=8, encoder_size=32,
             encoder_layers=2, encoder_heads=2, encoder_ffn_size=64,
             hidden_size=32, embedding_size=32, encoder_window=8,
             encoder_conv_kernel=3)
NUM_FRAMES = [40, 33, 17, 1]


@pytest.fixture
def card():
  if not torch.cuda.is_available():
    pytest.skip('needs an NVIDIA GPU: the serving path runs on the card')
  torch.backends.cuda.matmul.allow_tf32 = False
  return torch.device('cuda')


@pytest.mark.cuda
def test_prefetch_batches_on_the_card_equal_their_host_arrays(card):
  config = train_lib.DataConfig(batch_size=8, max_num_frames=1600,
                                max_num_labels=100, feature_size=80,
                                vocab_size=1024)
  host = train_lib.synthetic_batches(config)
  staged = data.prefetch_to_device(train_lib.synthetic_batches(config),
                                   size=3, device=card)
  weight = torch.randn((80, 2048), device=card)
  for _ in range(6):
    batch = next(staged)
    # Work on the consumer's stream between batches: a missing wait on the
    # copy's event would let it read a batch before its copy landed.
    (batch['frames'] @ weight).sum().item()
    want = next(host)
    for key, value in want.items():
      assert batch[key].device.type == 'cuda'
      npt.assert_array_equal(batch[key].cpu().numpy(), value, err_msg=key)
  staged.close()


def models_on(device):
  model = gnat.GNATModel(presets.streaming_conformer_gnat(**SMALL),
                         device=device)
  params = model.init(torch.Generator().manual_seed(0))
  return model, params


@pytest.mark.cuda
def test_streaming_encoder_and_decoders_match_the_cpu(card):
  rng = np.random.default_rng(0)
  frames = torch.from_numpy(rng.standard_normal(
      (len(NUM_FRAMES), max(NUM_FRAMES), SMALL['feature_size'])).astype(
          np.float32))
  num_frames = torch.tensor(NUM_FRAMES)
  results = {}
  for device in ('cpu', card):
    model, params = models_on(device)
    stream = encoder_lib.StreamingEncoder(model.encoder)
    state = stream.init_state(len(NUM_FRAMES), device=device)
    chunks = []
    for start in range(0, frames.shape[1], 8):
      state, out = stream.step(params['encoder'], state,
                               frames[:, start:start + 8].to(device))
      chunks.append(out)
    offline = model.encoder.apply(params['encoder'], frames.to(device),
                                  num_frames.to(device))
    lattice_params = params['lattice']
    greedy = streaming.StreamingGreedyDecoder(model.lattice)
    q, labels, _ = greedy.step(lattice_params,
                               greedy.init_state(len(NUM_FRAMES), device),
                               offline, num_frames.to(device))
    beam = streaming.StreamingBeamDecoder(model.lattice, beam_size=4,
                                          max_labels=64)
    beams = beam.step(lattice_params,
                      beam.init_state(len(NUM_FRAMES), device), offline,
                      num_frames.to(device))
    results[str(device)] = [torch.cat(chunks, dim=1), offline, q, labels,
                            *beam.best(beams)]
  cpu, gpu = results['cpu'], results[str(card)]
  gpu = [x.cpu() for x in gpu]
  npt.assert_allclose(gpu[0].numpy(), cpu[0].numpy(), rtol=0, atol=1e-5)
  npt.assert_allclose(gpu[1].numpy(), cpu[1].numpy(), rtol=0, atol=1e-5)
  for got, want in zip(gpu[2:5], cpu[2:5]):
    assert torch.equal(got, want)
  assert torch.equal(gpu[5], cpu[5])
  npt.assert_allclose(gpu[6].numpy(), cpu[6].numpy(), rtol=1e-5)


@pytest.mark.cuda
def test_checkpoint_round_trip_of_a_state_on_the_card(card, tmp_path):
  model, _ = models_on(card)
  optimizer = gnat.make_optimizer(accumulate_steps=2)
  batches = train_lib.synthetic_batches(train_lib.DataConfig(
      batch_size=4, max_num_frames=24, max_num_labels=4,
      feature_size=SMALL['feature_size'], vocab_size=SMALL['vocab_size']))

  def fresh():
    return gnat.init_train_state(model, torch.Generator().manual_seed(0),
                                 optimizer)

  state = fresh()
  for _ in range(3):
    b = next(batches)
    state, _ = gnat.train_step(model, optimizer, state, b['frames'],
                               b['num_frames'], b['labels'], b['num_labels'])
  manager = checkpoint.CheckpointManager(str(tmp_path))
  manager.save(state.step, state)
  restored = manager.restore(template=fresh())
  assert restored.step == state.step == 3
  assert restored.opt_state.mini_step == state.opt_state.mini_step == 1
  for a, b in zip(pytree.tree_leaves(restored.params),
                  pytree.tree_leaves(state.params)):
    assert a.device.type == 'cuda' and torch.equal(a, b)
    for field in ('exp_avg', 'exp_avg_sq', 'step'):
      assert torch.equal(restored.opt_state.adamw.state[a][field],
                         state.opt_state.adamw.state[b][field])
  for a, b in zip(restored.opt_state.acc, state.opt_state.acc):
    assert a.device.type == 'cuda' and torch.equal(a, b)
