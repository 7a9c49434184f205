"""The port's trainer and its helpers against the JAX package.

``synthetic_batches``, ``process_local_slice`` and ``bucket_batches`` equal
JAX's exactly; ``make_optimizer(accumulate_steps=2)`` against
``optax.MultiSteps`` fed the same gradients over 4 micro-steps (updated
parameters to rtol 1e-5 / atol 1e-7); ``label_accuracy`` and
``label_error_rate`` equal JAX's on the same converted parameters. Then the
port alone on the CPU: ``prefetch_to_device`` (order, error propagation,
early close), ``CheckpointManager`` (a bit-exact round trip of parameters,
AdamW moments, schedule and accumulated gradients; retention), ``train``
resumed after 2 steps against 4 straight steps (bit-exact), and the
timer's keys; the three examples
(``examples/*_torch.py``: serving, the full pipeline, MWER) for a few steps
on the CPU. The tensor-parallel ``train`` runs on two gloo ranks in
``tests/test_torch_parallel.py``.
"""

import importlib
import json
import os
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import optax
import pytest
import torch
from torch.utils import _pytree as pytree

from last_torch_tpu import data as jax_data
from last_torch_tpu.models import gnat as jax_gnat
from last_torch_tpu.models import train as jax_train
from last_torch_tpu_torch import convert, data
from last_torch_tpu_torch.models import gnat, train
from last_torch_tpu_torch.utils import checkpoint, profiling

torch.set_num_threads(1)
torch.set_float32_matmul_precision('highest')

SMALL = dict(feature_size=8, vocab_size=6, encoder_size=16, encoder_layers=1,
             encoder_heads=2, encoder_ffn_size=32, hidden_size=12,
             embedding_size=10)
DATA = dict(batch_size=4, max_num_frames=16, max_num_labels=4,
            feature_size=8, vocab_size=6)


def test_synthetic_batches_equal_jax_bit_for_bit():
  config = dict(DATA, seed=3)
  ours = train.synthetic_batches(train.DataConfig(**config))
  theirs = jax_train.synthetic_batches(jax_train.DataConfig(**config))
  for _ in range(3):
    a, b = next(ours), next(theirs)
    assert set(a) == set(b)
    for key in b:
      want = np.asarray(b[key])
      assert a[key].dtype == want.dtype, key
      npt.assert_array_equal(a[key], want, err_msg=key)


def test_process_local_slice_equals_jax():
  for args in ((8, 1, 0), (8, 2, 1), (12, 4, 3)):
    assert (train.process_local_slice(*args) ==
            jax_train.process_local_slice(*args))
  with pytest.raises(ValueError, match='divisible'):
    train.process_local_slice(6, 4, 0)


def examples(seed, n=11):
  rng = np.random.default_rng(seed)
  out = []
  for _ in range(n):
    t, u = int(rng.integers(1, 30)), int(rng.integers(0, 9))
    out.append((rng.standard_normal((t, 3)).astype(np.float32),
                rng.integers(1, 5, size=(u,)).astype(np.int32)))
  return out


@pytest.mark.parametrize('pad_final', [False, True])
def test_bucket_batches_equal_jax(pad_final):
  kw = dict(batch_size=2, frame_buckets=(10, 20), label_buckets=(4, 8),
            pad_final=pad_final)
  ours = list(data.bucket_batches(examples(0), **kw))
  theirs = list(jax_data.bucket_batches(examples(0), **kw))
  assert len(ours) == len(theirs) > 0
  for a, b in zip(ours, theirs):
    assert set(a) == set(b)
    for key in b:
      npt.assert_array_equal(a[key], b[key], err_msg=key)
  with pytest.raises(ValueError, match='exceeds the largest bucket'):
    list(data.bucket_batches(examples(0), drop_overlong=False, **kw))


def counting_source(n, fail_at=None, closed=None):
  try:
    for i in range(n):
      if i == fail_at:
        raise RuntimeError(f'source failed at {i}')
      yield {'x': np.full((2,), i, np.int32), 'tag': f'b{i}'}
  finally:
    if closed is not None:
      closed.set()


def test_prefetch_keeps_order_and_places_tensors():
  got = list(data.prefetch_to_device(counting_source(6), size=2,
                                     device='cpu'))
  assert [b['tag'] for b in got] == [f'b{i}' for i in range(6)]
  for i, b in enumerate(got):
    assert isinstance(b['x'], torch.Tensor) and b['x'].device.type == 'cpu'
    npt.assert_array_equal(b['x'].numpy(), [i, i])
  placed = list(data.prefetch_to_device(
      counting_source(3), device='cpu',
      place=lambda b: {'x': torch.as_tensor(b['x']) * 10}))
  assert [int(b['x'][0]) for b in placed] == [0, 10, 20]


def test_prefetch_raises_the_source_error_after_the_staged_batches():
  stream = data.prefetch_to_device(counting_source(6, fail_at=2), size=4,
                                   device='cpu')
  assert [b['tag'] for b in (next(stream), next(stream))] == ['b0', 'b1']
  with pytest.raises(RuntimeError, match='source failed at 2'):
    next(stream)


def test_prefetch_early_close_releases_the_thread():
  before = threading.active_count()
  closed = threading.Event()
  stream = data.prefetch_to_device(counting_source(1000, closed=closed),
                                   size=2, device='cpu')
  assert next(stream)['tag'] == 'b0'
  time.sleep(0.2)  # the producer fills the queue and blocks on it
  stream.close()
  assert closed.wait(timeout=10), 'the source was not closed'
  deadline = time.monotonic() + 10
  while threading.active_count() > before and time.monotonic() < deadline:
    time.sleep(0.05)
  assert threading.active_count() == before


def random_tree(rng, scale=1.0):
  normal = lambda *shape: (rng.standard_normal(shape) * scale).astype(
      np.float32)
  return {'a': {'w': normal(4, 3), 'b': normal(3)}, 'c': normal(5)}


def leaf_at(tree, path):
  for key in path:
    tree = tree[key.key]
  return tree


@pytest.mark.parametrize('clip_norm', [5.0, 0.5])
def test_accumulate_steps_matches_optax_multisteps(clip_norm):
  kwargs = dict(learning_rate=3e-2, warmup_steps=2, total_steps=6,
                clip_norm=clip_norm, accumulate_steps=2)
  rng = np.random.default_rng(11)
  params = random_tree(rng)
  grads = [random_tree(rng, 2.0) for _ in range(4)]
  tx = jax_gnat.make_optimizer(**kwargs)
  jax_params = jax.tree.map(jnp.asarray, params)
  opt_state = tx.init(jax_params)
  optimizer = gnat.make_optimizer(**kwargs)
  torch_params = convert.from_jax_params(params, device='cpu')
  state = optimizer.init(torch_params)
  for step, g in enumerate(grads):
    before = {'c': torch_params['c'].clone(),
              'w': torch_params['a']['w'].clone()}
    updates, opt_state = tx.update(jax.tree.map(jnp.asarray, g), opt_state,
                                   jax_params)
    jax_params = optax.apply_updates(jax_params, updates)
    for path, grad in jax.tree_util.tree_flatten_with_path(g)[0]:
      leaf_at(torch_params, path).grad = torch.tensor(grad)
    updated = optimizer.apply_gradients(state)
    assert updated == (step % 2 == 1)
    if not updated:  # the parameters do not move between updates
      assert torch.equal(torch_params['c'], before['c'])
      assert torch.equal(torch_params['a']['w'], before['w'])
    assert state.schedule.last_epoch == (step + 1) // 2
    for path, want in jax.tree_util.tree_flatten_with_path(jax_params)[0]:
      npt.assert_allclose(leaf_at(torch_params, path).numpy(),
                          np.asarray(want), rtol=1e-5, atol=1e-7,
                          err_msg=f'step {step} {path}')
  # AdamW counted two updates, not four micro-steps.
  assert int(opt_state.gradient_step) == 2
  assert all(int(s['step']) == 2 for s in state.adamw.state.values())


def small_model():
  return gnat.GNATModel(gnat.GNATConfig(**SMALL), device='cpu')


def test_label_metrics_equal_jax():
  jax_model = jax_gnat.GNATModel(jax_gnat.GNATConfig(**SMALL))
  params = jax_model.init(jax.random.PRNGKey(2))
  batch = next(train.synthetic_batches(train.DataConfig(**DATA)))
  model = small_model()
  torch_params = convert.from_jax_params(jax.tree.map(np.asarray, params),
                                         device='cpu')
  decode_j = jax.jit(jax_model.decode)
  jax_batch = jax.tree.map(jnp.asarray, batch)
  accuracy = train.label_accuracy(model, model.decode, torch_params, batch)
  assert accuracy == jax_train.label_accuracy(jax_model, decode_j, params,
                                              jax_batch)
  error_rate = train.label_error_rate(model, model.decode, torch_params,
                                      batch)
  assert error_rate == pytest.approx(jax_train.label_error_rate(
      jax_model, decode_j, params, jax_batch), rel=1e-7)
  assert 0.0 <= accuracy <= 1.0 and error_rate >= 0.0


def trained_state(steps, accumulate_steps=1):
  model = small_model()
  optimizer = gnat.make_optimizer(learning_rate=1e-2, warmup_steps=2,
                                  total_steps=10,
                                  accumulate_steps=accumulate_steps)
  state = gnat.init_train_state(model, torch.Generator().manual_seed(0),
                                optimizer)
  batches = train.synthetic_batches(train.DataConfig(**DATA))
  for _ in range(steps):
    b = next(batches)
    state, _ = gnat.train_step(model, optimizer, state, b['frames'],
                               b['num_frames'], b['labels'], b['num_labels'])
  return model, optimizer, state


def assert_states_equal(got, want):
  assert got.step == want.step
  for a, b in zip(pytree.tree_leaves(got.params),
                  pytree.tree_leaves(want.params)):
    assert torch.equal(a, b)
  got_opt, want_opt = got.opt_state, want.opt_state
  for a, b in zip(pytree.tree_leaves(got.params),
                  pytree.tree_leaves(want.params)):
    for field in ('exp_avg', 'exp_avg_sq', 'step'):
      assert torch.equal(got_opt.adamw.state[a][field],
                         want_opt.adamw.state[b][field]), field
  assert got_opt.schedule.last_epoch == want_opt.schedule.last_epoch
  assert ([g['lr'] for g in got_opt.adamw.param_groups] ==
          [g['lr'] for g in want_opt.adamw.param_groups])
  assert got_opt.mini_step == want_opt.mini_step
  if want_opt.acc is not None:
    for a, b in zip(got_opt.acc, want_opt.acc):
      assert torch.equal(a, b)


@pytest.mark.parametrize('accumulate_steps', [1, 2])
def test_checkpoint_round_trip_is_exact(tmp_path, accumulate_steps):
  # 3 micro-steps: with accumulation one update and one gradient pending.
  _, _, saved = trained_state(3, accumulate_steps)
  manager = checkpoint.CheckpointManager(str(tmp_path / 'run'))
  assert manager.latest_step() is None
  manager.save(3, saved)
  _, _, template = trained_state(0, accumulate_steps)
  restored = manager.restore(template=template)
  assert_states_equal(restored, saved)
  assert not any(name.endswith('.tmp') for name in
                 (p.name for p in (tmp_path / 'run').iterdir()))
  # The restored state trains on as the saved one does.
  model, optimizer, _ = trained_state(0, accumulate_steps)
  b = next(train.synthetic_batches(train.DataConfig(**DATA, seed=9)))
  batch = (b['frames'], b['num_frames'], b['labels'], b['num_labels'])
  saved, loss_a = gnat.train_step(model, optimizer, saved, *batch)
  restored, loss_b = gnat.train_step(model, optimizer, restored, *batch)
  assert torch.equal(loss_a, loss_b)
  assert_states_equal(restored, saved)


def test_checkpoint_retention_and_pytrees(tmp_path):
  manager = checkpoint.CheckpointManager(str(tmp_path), max_to_keep=2)
  tree = {'a': torch.arange(4.0), 'b': [torch.ones(2, 3), torch.tensor(7)]}
  for step in (1, 2, 3):
    manager.save(step, pytree.tree_map(lambda x: x * step, tree))
  assert manager.all_steps() == [2, 3] and manager.latest_step() == 3
  restored = manager.restore(template=tree, step=2)
  torch.testing.assert_close(restored, pytree.tree_map(lambda x: x * 2, tree),
                             rtol=0, atol=0)
  manager.close()
  checkpoint.save_pytree(str(tmp_path / 'one'), tree)
  again = checkpoint.restore_pytree(str(tmp_path / 'one'),
                                    pytree.tree_map(torch.zeros_like, tree))
  torch.testing.assert_close(again, tree, rtol=0, atol=0)
  with pytest.raises(ValueError, match='No checkpoints'):
    checkpoint.CheckpointManager(str(tmp_path / 'empty')).restore(tree)


def run_train(workdir, steps, records, **kw):
  return train.train(gnat.GNATConfig(**SMALL), train.DataConfig(**DATA),
                     num_steps=steps, workdir=workdir, checkpoint_every=2,
                     log_every=1, prefetch=2, device='cpu',
                     log_fn=records.append, **kw)


def losses(records):
  return [r['loss'] for r in map(json.loads, records)
          if r['event'] == 'train']


def test_train_resume_equals_straight_steps(tmp_path):
  straight_records = []
  straight = run_train(None, 4, straight_records, eval_every=4)
  first, resumed_records = [], []
  run_train(str(tmp_path), 2, first)
  resumed = run_train(str(tmp_path), 4, resumed_records, eval_every=4)
  assert resumed_records[0] == '{"event": "restored", "step": 2}'
  assert losses(first) + losses(resumed_records) == losses(straight_records)
  assert resumed.step == straight.step == 4
  for a, b in zip(pytree.tree_leaves(resumed.params),
                  pytree.tree_leaves(straight.params)):
    assert torch.equal(a, b)
  last = json.loads(straight_records[-1])
  assert {'eval_label_accuracy', 'eval_label_error_rate', 'p50_ms',
          'p90_ms', 'mean_ms'} <= set(last)
  assert checkpoint.CheckpointManager(str(tmp_path)).all_steps() == [2, 4]


def test_trace_writes_a_chrome_trace(tmp_path):
  with profiling.trace(str(tmp_path)):
    with profiling.span('scope'):
      torch.ones(8).sum()
  traces = list(tmp_path.glob('*.json'))
  assert len(traces) == 1 and 'scope' in traces[0].read_text()


def test_step_timer_and_benchmark_keys():
  timer = profiling.StepTimer(skip_first=1)
  for _ in range(3):
    with timer:
      time.sleep(0.001)
  summary = timer.summary()
  assert set(summary) == {'steps', 'p50_ms', 'p90_ms', 'mean_ms'}
  assert summary['steps'] == 2 and summary['p50_ms'] >= 1.0
  assert summary['p90_ms'] >= summary['p50_ms']
  assert np.isnan(profiling.StepTimer().summary()['p50_ms'])
  calls = []
  result = profiling.benchmark(lambda x: calls.append(x), 1, iters=4,
                               warmup=2)
  assert len(calls) == 6 and result['steps'] == 4
  assert set(result) == set(summary)


def import_example(name):
  sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
      os.path.abspath(__file__))), 'examples'))
  try:
    return importlib.import_module(name)
  finally:
    sys.path.pop(0)


def test_examples_run_on_the_cpu():
  serve = import_example('serve_streaming_torch')
  accuracy = serve.main(steps=20, device='cpu')
  assert 0.0 <= accuracy <= 1.0
  pipeline = import_example('train_full_pipeline_torch')
  assert 0.0 <= pipeline.main(micro_steps=8, device='cpu') <= 2.0
  mwer = import_example('train_mwer_torch')
  first_risk, last_risk, ler_nll, ler_mwer = mwer.main(
      nll_steps=4, mwer_steps=2, device='cpu')
  assert all(np.isfinite([first_risk, last_risk, ler_nll, ler_mwer]))
