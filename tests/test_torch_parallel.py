"""The port's data- and tensor-parallel train steps against the JAX
package's single-device step, on gloo ranks spawned on the CPU.

Each run spawns the ranks once (``torch.multiprocessing.spawn``, a
``file://`` store under the test's temporary directory, CPU tensors): 2
ranks take the tensor-parallel step at model 2 and the data-parallel step
at data 2, 4 ranks the tensor-parallel step at data 2 x model 2, each on
the three configurations of the JAX package's
``test_tp_train_step_matches_single_device`` (V=256, so a shard holds 128
labels). The batch has an infeasible row, so the two data ranks count
different feasible sequences. The rank functions sit at module level in
this file, whose top level imports no JAX; the JAX references are computed
in the test process and the ranks read the parameters from and write their
results to files.

The 2 ranks also take the data-parallel expected-risk step
(``make_shard_map_risk_train_step``) on a globally and a locally normalized
case; it must draw the single-device ``risk_train_step(...,
per_example_keys=True)``'s samples exactly and match its metrics and
gradients to 1e-5.

The 2 ranks also run the trainer, ``models.train.train``, tensor parallel
(``model_parallel=2``) and data parallel: 2 steps with a checkpoint (of the
vocab-sharded state under tensor parallelism), then a resumed run to 4
steps, whose losses must match 4 single-device ``train`` steps to rtol
1e-5.

Held, as ``tests/test_torch_train.py`` holds the single-device step: the
loss to rtol 1e-5, every gradient (each vocab shard's among them, which
catches a D-fold scaling) to 1e-4 of the global gradient scale, the
clipped gradients to the JAX gradients times the clip factor of their
global norm (which must take every shard), and the updated parameters to
the optax chain fed the same gradients, to 1e-6.
"""

import datetime
import json
import pathlib
import pickle
import time

import numpy as np
import numpy.testing as npt
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.utils import _pytree as pytree

from last_torch_tpu_torch import convert
from last_torch_tpu_torch.models import gnat
from last_torch_tpu_torch.parallel import sharding

CONFIG = dict(feature_size=8, vocab_size=256, context_size=1, encoder_size=16,
              encoder_layers=1, encoder_heads=2, encoder_ffn_size=32,
              hidden_size=16, embedding_size=16)
# name: (max_expansions, locally_normalized)
CASES = {'fd': (0, False), 'fld1': (1, False), 'fld1_hat': (1, True)}
NUM_FRAMES = np.array([6, 4, 1, 6], np.int32)
# Row 2 is infeasible (3 labels in 1 frame) under FD and FLD(1).
NUM_LABELS = np.array([3, 2, 3, 1], np.int32)
# A hung collective fails the rank after this long; a rank that has not
# finished after SPAWN_SECONDS fails the test.
COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=120)
SPAWN_SECONDS = 300
LEARNING_RATE = 1e-2
CLIP_NORM = 0.5  # below every case's gradient norm: the clip engages
# The runs of each spawn: (name, step, model_parallel, case).
# The data-parallel expected-risk step: case -> (estimator, nll_weight).
RISK_CASES = {'fld1': ('mwer', 0.1), 'fld1_hat': ('reinforce', 0.1)}
RISK_SAMPLES = 3
RISK_SEED = 11
SPAWNS = {
    2: [(f'tp2_{c}', 'tp', 2, c) for c in CASES] +
       [(f'dp2_{c}', 'dp', 1, c) for c in CASES] +
       [(f'risk2_{c}', 'risk', 1, c) for c in RISK_CASES] +
       [('train_tp2_fld1', 'train', 2, 'fld1'),
        ('train_dp2_fld1', 'train', 1, 'fld1')],
    4: [(f'tp2x2_{c}', 'tp', 2, c) for c in CASES],
}
ALL_RUNS = [run[0] for runs in SPAWNS.values() for run in runs]
RUNS = [run for run in ALL_RUNS if run.startswith(('tp', 'dp'))]
RISK_RUNS = [run for run in ALL_RUNS if run.startswith('risk')]
TRAIN_RUNS = [run for run in ALL_RUNS if run.startswith('train')]
# The trainer's runs: synthetic batches of CONFIG's shapes.
TRAIN_DATA = dict(batch_size=4, max_num_frames=8, max_num_labels=3,
                  feature_size=CONFIG['feature_size'],
                  vocab_size=CONFIG['vocab_size'])


def batch():
  rng = np.random.default_rng(1)
  frames = rng.normal(size=(4, 6, CONFIG['feature_size'])).astype(np.float32)
  labels = rng.integers(1, CONFIG['vocab_size'] + 1, size=(4, 3)).astype(
      np.int32)
  return frames, NUM_FRAMES, labels, NUM_LABELS


def _named(params):
  return {sharding._path_str(path): leaf for path, leaf in
          pytree.tree_flatten_with_path(params)[0]}


def _numpy(tensors):
  return {name: x.detach().numpy().copy() for name, x in tensors.items()}


def _spy_on_sampler(lattice, seen):
  """Records the alignment labels of every draw of the sampler (the
  losses call ``_sample_paths``)."""
  sample_paths = lattice._sample_paths

  def spy(*args, **kwargs):
    out = sample_paths(*args, **kwargs)
    seen.append(out[0].detach().numpy().copy())
    return out

  lattice._sample_paths = spy


def _risk_model(case, params):
  """The ``case`` model, its state from numpy ``params`` (gradients
  recorded) and an optimizer whose clip never engages, for the risk runs."""
  max_expansions, locally_normalized = CASES[case]
  model = gnat.GNATModel(gnat.GNATConfig(
      **CONFIG, max_expansions=max_expansions,
      locally_normalized=locally_normalized), device='cpu')
  optimizer = gnat.make_optimizer(LEARNING_RATE, clip_norm=1e9)
  params = convert.from_jax_params(params, device='cpu')
  for leaf in pytree.tree_leaves(params):
    leaf.requires_grad_(True)
  return model, optimizer, gnat.GNATTrainState(params,
                                               optimizer.init(params), 0)


def _risk_run(mesh, case, params):
  """One rank's data-parallel risk step: its samples, metrics and summed
  gradients."""
  model, optimizer, state = _risk_model(case, params)
  estimator, nll_weight = RISK_CASES[case]
  step = sharding.make_shard_map_risk_train_step(
      model, optimizer, mesh, num_samples=RISK_SAMPLES, estimator=estimator,
      nll_weight=nll_weight)
  seen = []
  _spy_on_sampler(model.lattice, seen)
  metrics = step.loss_and_grads(state, *sharding.shard_batch(batch(), mesh),
                                torch.Generator().manual_seed(RISK_SEED))
  return {
      'data': mesh.get_local_rank('data'),
      'model': mesh.get_local_rank('model'),
      'samples': seen[0],
      'metrics': {k: float(v) for k, v in metrics.items()},
      'grads': _numpy({n: x.grad for n, x in _named(state.params).items()}),
  }


def _train(case, **kwargs):
  """``models.train.train`` of the ``case`` model on TRAIN_DATA; returns
  its log records."""
  from last_torch_tpu_torch.models import train as train_lib
  max_expansions, locally_normalized = CASES[case]
  records = []
  train_lib.train(
      gnat.GNATConfig(**CONFIG, max_expansions=max_expansions,
                      locally_normalized=locally_normalized),
      train_lib.DataConfig(**TRAIN_DATA), log_every=1, eval_every=4,
      device='cpu', log_fn=records.append, **kwargs)
  return records


def _train_run(case, rank, workdir, model_parallel):
  """One rank's training (tensor parallel with model_parallel=2, data
  parallel with 1): 2 steps with a checkpoint, then a resumed run to 4
  steps from it."""
  records = []
  for steps in (2, 4):
    records += _train(case, num_steps=steps, workdir=str(workdir),
                      checkpoint_every=2, model_parallel=model_parallel)
  return {'data': rank // 2, 'model': rank % 2, 'case': case,
          'records': records}


def _rank_main(rank, world, workdir):
  """One rank: every run of its spawn, results to ``<run>.<rank>.pkl``."""
  torch.set_num_threads(1)
  torch.set_float32_matmul_precision('highest')
  workdir = pathlib.Path(workdir)
  dist.init_process_group('gloo', init_method=f'file://{workdir}/store',
                          rank=rank, world_size=world,
                          timeout=COLLECTIVE_TIMEOUT)
  try:
    for name, kind, model_parallel, case in SPAWNS[world]:
      mesh = sharding.make_mesh(model_parallel=model_parallel,
                                device_type='cpu')
      max_expansions, locally_normalized = CASES[case]
      model = gnat.GNATModel(gnat.GNATConfig(
          **CONFIG, max_expansions=max_expansions,
          locally_normalized=locally_normalized), device='cpu')
      optimizer = gnat.make_optimizer(LEARNING_RATE, clip_norm=CLIP_NORM)
      if kind == 'train':
        (workdir / f'{name}.{rank}.pkl').write_bytes(pickle.dumps(
            _train_run(case, rank, workdir / name, model_parallel)))
        continue
      params = pickle.loads((workdir / f'{case}.params.pkl').read_bytes())
      if kind == 'risk':
        (workdir / f'{name}.{rank}.pkl').write_bytes(pickle.dumps(
            _risk_run(mesh, case, params)))
        continue
      params = convert.from_jax_params(params, device='cpu')
      for leaf in pytree.tree_leaves(params):
        leaf.requires_grad_(True)
      state = gnat.GNATTrainState(params, optimizer.init(params), 0)
      if kind == 'tp':
        step, shard_state = sharding.make_tp_train_step(model, optimizer,
                                                        mesh)
        state = shard_state(state)
      else:
        step = sharding.make_shard_map_train_step(model, optimizer, mesh)
      shards = _numpy(_named(state.params))
      local = sharding.shard_batch(batch(), mesh)
      loss = step.loss_and_grads(state, *local).item()
      grads = _numpy({n: x.grad for n, x in _named(state.params).items()})
      state, step_loss = step(state, *local)
      result = {
          'data': mesh.get_local_rank('data'),
          'model': mesh.get_local_rank('model'),
          'rows': len(local[0]),
          'shards': shards,
          'loss': loss,
          'step_loss': step_loss.item(),
          'step': state.step,
          'grads': grads,
          'clipped': _numpy({n: x.grad for n, x in
                             _named(state.params).items()}),
          'params': _numpy(_named(state.params)),
      }
      (workdir / f'{name}.{rank}.pkl').write_bytes(pickle.dumps(result))
  finally:
    dist.destroy_process_group()


@pytest.fixture(scope='module')
def reference(tmp_path_factory):
  """{case: (numpy parameters, JAX mean loss, JAX gradients)}, and the
  ranks' results {run: [result of each rank]}."""
  import jax
  from last_torch_tpu.models import gnat as jax_gnat

  workdir = tmp_path_factory.mktemp('parallel')
  refs = {}
  for case, (max_expansions, locally_normalized) in CASES.items():
    jax_model = jax_gnat.GNATModel(jax_gnat.GNATConfig(
        **CONFIG, max_expansions=max_expansions,
        locally_normalized=locally_normalized))
    params = jax.tree.map(np.asarray, jax_model.init(jax.random.PRNGKey(0)))
    loss, grads = jax.value_and_grad(jax_model.mean_loss)(params, *batch())
    refs[case] = (params, float(loss), jax.tree.map(np.asarray, grads))
    (workdir / f'{case}.params.pkl').write_bytes(pickle.dumps(params))
  for world in SPAWNS:
    ranks = mp.spawn(_rank_main, args=(world, str(workdir)), nprocs=world,
                     join=False)
    deadline = time.monotonic() + SPAWN_SECONDS
    while not ranks.join(timeout=1):
      if time.monotonic() > deadline:
        for process in ranks.processes:
          process.kill()
        pytest.fail(f'{world} ranks did not finish in {SPAWN_SECONDS} s')
    (workdir / 'store').unlink(missing_ok=True)
  results = {run: sorted((pickle.loads(p.read_bytes())
                          for p in workdir.glob(f'{run}.*.pkl')),
                         key=lambda r: (r['data'], r['model']))
             for run in ALL_RUNS}
  return refs, results


def _flat(tree):
  return {sharding._path_str(path): leaf for path, leaf in
          pytree.tree_flatten_with_path(tree)[0]}


def assemble(results, key, case_params):
  """The whole tree of ``key`` from the ranks: sharded leaves concatenated
  over the model ranks (equal on every data rank), the others equal on
  every rank."""
  shardings = sharding.param_shardings(case_params)
  whole = {}
  for name, dim in shardings.items():
    if dim is None:
      values = [r[key][name] for r in results]
    else:
      values = [np.concatenate(
          [r[key][name] for r in results if r['data'] == d], axis=dim)
                for d in sorted({r['data'] for r in results})]
    for other in values[1:]:
      npt.assert_array_equal(other, values[0], err_msg=f'{key} {name}')
    whole[name] = values[0]
  return whole


def case_of(run):
  return run.split('_', 1)[1]


@pytest.mark.parametrize('run', RUNS)
def test_train_step_matches_jax_single_device(reference, run):
  import jax
  import optax
  from last_torch_tpu.models import gnat as jax_gnat

  refs, results = reference
  params, want_loss, want_grads = refs[case_of(run)]
  ranks = results[run]
  assert len(ranks) == (4 if run.startswith('tp2x2') else 2)
  for r in ranks:
    npt.assert_allclose(r['loss'], want_loss, rtol=1e-5, atol=1e-6)
    assert r['step_loss'] == r['loss'] and r['step'] == 1
  want = _flat(want_grads)
  scale = max(float(np.abs(w).max()) for w in want.values())
  grads = assemble(ranks, 'grads', params)
  for name, w in want.items():
    npt.assert_allclose(grads[name], w, rtol=0, atol=1e-4 * scale,
                        err_msg=name)
  # The clip's global norm takes every shard once.
  norm = np.sqrt(sum(float(np.square(w).sum()) for w in want.values()))
  assert norm > CLIP_NORM
  factor = CLIP_NORM / (norm + 1e-6)
  clipped = assemble(ranks, 'clipped', params)
  for name, w in want.items():
    npt.assert_allclose(clipped[name], w * factor, rtol=0,
                        atol=1e-4 * scale * factor, err_msg=name)
  # AdamW: the optax chain fed the step's own gradients.
  tx = jax_gnat.make_optimizer(learning_rate=LEARNING_RATE,
                               clip_norm=CLIP_NORM)
  jax_params = jax.tree.map(jax.numpy.asarray, params)
  jax_grads = jax.tree_util.tree_unflatten(
      jax.tree_util.tree_structure(jax_params),
      [grads[sharding._path_str(p)] for p, _ in
       jax.tree_util.tree_flatten_with_path(jax_params)[0]])
  updates, _ = tx.update(jax_grads, tx.init(jax_params), jax_params)
  updated = _flat(jax.tree.map(np.asarray,
                               optax.apply_updates(jax_params, updates)))
  got = assemble(ranks, 'params', params)
  for name, w in updated.items():
    npt.assert_allclose(got[name], w, rtol=0, atol=1e-6, err_msg=name)


@pytest.mark.parametrize('run', RISK_RUNS)
def test_risk_step_matches_the_single_device_step(reference, run):
  """The data-parallel risk step on 2 ranks against the port's
  single-device ``risk_train_step(..., per_example_keys=True)``: the same
  samples exactly, the metrics to rtol 1e-5 and the gradients to 1e-5 of
  the largest."""
  refs, results = reference
  case = case_of(run)
  model, optimizer, state = _risk_model(case, refs[case][0])
  estimator, nll_weight = RISK_CASES[case]
  seen = []
  _spy_on_sampler(model.lattice, seen)
  _, want = gnat.risk_train_step(
      model, optimizer, state, *batch(),
      torch.Generator().manual_seed(RISK_SEED), num_samples=RISK_SAMPLES,
      estimator=estimator, nll_weight=nll_weight, per_example_keys=True)
  ranks = results[run]
  assert len(ranks) == 2
  npt.assert_array_equal(
      np.concatenate([r['samples'] for r in ranks]), seen[0])
  want_grads = _numpy({n: x.grad for n, x in _named(state.params).items()})
  scale = max(float(np.abs(w).max()) for w in want_grads.values())
  for r in ranks:
    assert set(r['metrics']) == set(want) == {'loss', 'mean_risk', 'nll'}
    for key, value in want.items():
      npt.assert_allclose(r['metrics'][key], float(value), rtol=1e-5,
                          err_msg=key)
    for name, w in want_grads.items():
      npt.assert_allclose(r['grads'][name], w, rtol=0, atol=1e-5 * scale,
                          err_msg=name)


@pytest.mark.parametrize('run', TRAIN_RUNS)
def test_parallel_train_matches_single_device_train(reference, run):
  """``train(model_parallel=2)`` (tensor parallel) or ``train()`` in the
  2-rank group (data parallel) on 2 ranks, resumed from its checkpoint
  (vocab-sharded under tensor parallelism) after 2 steps, against 4
  single-device ``train`` steps: the losses to rtol 1e-5, the evaluation
  (on the gathered parameters) equal."""
  _, results = reference
  ranks = results[run]
  want = [json.loads(r) for r in _train(ranks[0]['case'], num_steps=4)]
  assert len(ranks) == 2
  for r in ranks:
    got = [json.loads(x) for x in r['records']]
    assert got[2] == {'event': 'restored', 'step': 2}
    got = got[:2] + got[3:]
    assert [g['step'] for g in got] == [w['step'] for w in want] == [1, 2, 3,
                                                                      4]
    npt.assert_allclose([g['loss'] for g in got], [w['loss'] for w in want],
                        rtol=1e-5)
    for key in ('eval_label_accuracy', 'eval_label_error_rate'):
      assert got[-1][key] == want[-1][key], key


def test_shard_params_slices_the_vocab_head(reference):
  refs, results = reference
  for run in ('tp2_fld1', 'tp2x2_fld1', 'dp2_fld1'):
    full = _flat(refs['fld1'][0])
    for r in results[run]:
      assert r['rows'] == (4 if run.startswith('tp2_') else 2)
      shards = 1 if run.startswith('dp') else 2
      for name, value in full.items():
        got = r['shards'][name]
        dim = sharding.param_shardings(refs['fld1'][0])[name]
        if dim is None or shards == 1:
          npt.assert_array_equal(got, value, err_msg=name)
        else:
          size = value.shape[dim] // shards
          npt.assert_array_equal(
              got, np.take(value, range(r['model'] * size,
                                        (r['model'] + 1) * size), axis=dim),
              err_msg=name)


def test_param_shardings_of_the_gnat_tree():
  model = gnat.GNATModel(gnat.GNATConfig(**CONFIG), device='cpu')
  params = model.init(torch.Generator().manual_seed(0))
  shardings = sharding.param_shardings(params)
  assert {n: d for n, d in shardings.items() if d is not None} == {
      'lattice/weight_fn/vocab_w': 1, 'lattice/weight_fn/vocab_b': 0}
  assert set(shardings) == set(_named(params))
  # The encoder stays replicated (the JAX package's Megatron rules are not
  # ported: the tensor-parallel step keeps the encoder whole).
  assert shardings['encoder/layers/0/qkv'] is None


def test_mesh_and_steps_refuse_what_they_do_not_cover():
  with pytest.raises(RuntimeError, match='init_process_group'):
    sharding.make_mesh(model_parallel=2, device_type='cpu')
  model = gnat.GNATModel(gnat.GNATConfig(**dict(CONFIG, context_size=2,
                                                vocab_size=8)), device='cpu')
  with pytest.raises(ValueError, match='tensor-parallel'):
    sharding.make_tp_train_step(model, gnat.make_optimizer(), mesh=None)
