"""The port's LSTMCell and SharedRNNCacher against the JAX package, and a
GNAT model with the RNN cacher.

JAX parameters converted with ``convert.from_jax_params`` (the fused 4-gate
layout carries across as it is) and the same numpy inputs through both
packages: cell outputs and states to rtol 1e-5 / atol 1e-6, the cacher's
table (a trigram over V=4: 21 rows) to rtol 1e-5 / atol 1e-6; the
RNN-cacher GNAT's loss to rtol 1e-5 and its gradients to 1e-5 of the global
gradient scale, its decode exactly, float32 both sides. The lattice kernels'
gates take the RNN cacher's table (their plain versions run on the CPU).
"""

import jax
import numpy as np
import numpy.testing as npt
import torch
from torch.utils import _pytree as pytree

from last_torch_tpu import weight_fns as jax_weight_fns
from last_torch_tpu.models import gnat as jax_gnat
from last_torch_tpu.utils import rnn as jax_rnn
from last_torch_tpu_torch import convert, weight_fns
from last_torch_tpu_torch.models import gnat
from last_torch_tpu_torch.ops import fused_scan
from last_torch_tpu_torch.utils import rnn

torch.set_num_threads(1)
torch.set_float32_matmul_precision('highest')

SMALL = dict(feature_size=6, vocab_size=5, encoder_size=16, encoder_layers=2,
             encoder_heads=2, encoder_ffn_size=32, hidden_size=12,
             embedding_size=10, use_rnn_cacher=True)
NUM_FRAMES = np.array([7, 4, 0], np.int32)
LABELS = np.array([[2, 5, 1], [4, 4, 0], [0, 0, 0]], np.int32)
NUM_LABELS = np.array([3, 2, 0], np.int32)


def to_torch(tree):
  return convert.from_jax_params(jax.tree.map(np.asarray, tree),
                                 device='cpu')


def test_lstm_cell_matches_jax():
  cell_j = jax_rnn.LSTMCell(input_size=5, hidden_size=7)
  params = cell_j.init(jax.random.PRNGKey(0))
  rng = np.random.default_rng(0)
  inputs = rng.standard_normal((3, 5)).astype(np.float32)
  h0 = rng.standard_normal((3, 7)).astype(np.float32)
  c0 = rng.standard_normal((3, 7)).astype(np.float32)
  out_j, (h_j, c_j) = cell_j.apply(params, inputs, (h0, c0))
  cell = rnn.LSTMCell(input_size=5, hidden_size=7)
  out, (h, c) = cell.apply(to_torch(params), torch.from_numpy(inputs),
                           (torch.from_numpy(h0), torch.from_numpy(c0)))
  for got, want in ((out, out_j), (h, h_j), (c, c_j)):
    npt.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
  # Layout and initial carry as the JAX cell's.
  ported = cell.init(torch.Generator().manual_seed(0), device='cpu')
  assert {k: tuple(v.shape) for k, v in ported.items()} == {
      k: v.shape for k, v in params.items()}
  assert float(ported['w_i'].abs().max()) <= 5**-0.5
  zeros = cell.initial_state(2, device='cpu')
  assert all(z.shape == (2, 7) and not z.any() for z in zeros)


def test_shared_rnn_cacher_matches_jax():
  kw = dict(vocab_size=4, context_size=2, rnn_size=8, rnn_embedding_size=6)
  cacher_j = jax_weight_fns.SharedRNNCacher(**kw)
  params = cacher_j.init(jax.random.PRNGKey(1))
  table_j = np.asarray(cacher_j.apply(params))
  cacher = weight_fns.SharedRNNCacher(**kw)
  table = cacher.apply(to_torch(params))
  assert table.shape == table_j.shape == (1 + 4 + 16, 8)
  npt.assert_allclose(table.numpy(), table_j, rtol=1e-5, atol=1e-6)
  ported = cacher.init(torch.Generator().manual_seed(1), device='cpu')
  assert (jax.tree.map(lambda x: tuple(x.shape), ported) ==
          jax.tree.map(lambda x: x.shape, params))


def test_rnn_cacher_gnat_loss_gradients_and_decode_match_jax():
  jax_model = jax_gnat.GNATModel(jax_gnat.GNATConfig(**SMALL))
  params = jax_model.init(jax.random.PRNGKey(3))
  frames = np.random.default_rng(3).standard_normal(
      (len(NUM_FRAMES), 7, SMALL['feature_size'])).astype(np.float32)
  batch = (frames, NUM_FRAMES, LABELS, NUM_LABELS)
  value_j, grads_j = jax.value_and_grad(jax_model.mean_loss)(params, *batch)

  model = gnat.GNATModel(gnat.GNATConfig(**SMALL), device='cpu')
  assert isinstance(model.lattice.weight_fn_cacher, weight_fns.SharedRNNCacher)
  # The bigram kernels' gate takes this cacher: its plain versions run here.
  assert fused_scan.supported(model.lattice, torch.from_numpy(frames))
  torch_params = to_torch(params)
  for leaf in pytree.tree_leaves(torch_params):
    leaf.requires_grad_(True)
  value = model.mean_loss(torch_params, *batch)
  value.backward()
  assert model.lattice.last_path == 'plain'
  npt.assert_allclose(value.item(), float(value_j), rtol=1e-5)
  grads_j = jax.tree.map(np.asarray, grads_j)
  scale = max(float(np.abs(g).max()) for g in jax.tree.leaves(grads_j))
  flat_j = jax.tree_util.tree_flatten_with_path(grads_j)[0]
  flat = pytree.tree_flatten_with_path(torch_params)[0]
  assert len(flat) == len(flat_j)
  for (path, leaf), (_, want) in zip(flat, flat_j):
    npt.assert_allclose(leaf.grad.numpy(), want, rtol=0, atol=1e-5 * scale,
                        err_msg=pytree.keystr(path))
  # The cell's gradients are not zero: the loss reaches the LSTM.
  assert torch_params['lattice']['cacher']['cell']['w_h'].grad.abs().max() > 0

  labels_j, num_j, weights_j = jax_model.decode(params, frames, NUM_FRAMES)
  labels, num, weights = model.decode(torch_params, frames, NUM_FRAMES)
  assert model.lattice.last_path == 'plain'
  npt.assert_array_equal(labels.numpy(), np.asarray(labels_j))
  npt.assert_array_equal(num.numpy(), np.asarray(num_j))
  npt.assert_allclose(weights.numpy(), np.asarray(weights_j), rtol=1e-5)


def test_rnn_cacher_gnat_trains_on_the_cpu():
  model = gnat.GNATModel(gnat.GNATConfig(**SMALL), device='cpu')
  optimizer = gnat.make_optimizer(learning_rate=1e-2)
  state = gnat.init_train_state(model, torch.Generator().manual_seed(0),
                                optimizer)
  frames = np.random.default_rng(4).standard_normal(
      (len(NUM_FRAMES), 7, SMALL['feature_size'])).astype(np.float32)
  cell_before = state.params['lattice']['cacher']['cell']['w_i'].clone()
  losses = []
  for _ in range(3):
    state, loss = gnat.train_step(model, optimizer, state, frames,
                                  NUM_FRAMES, LABELS, NUM_LABELS)
    losses.append(loss.item())
  assert losses[2] < losses[1] < losses[0]
  assert not torch.equal(state.params['lattice']['cacher']['cell']['w_i'],
                         cell_before)
