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

Held, as ``tests/test_torch_train.py`` holds the single-device step: the
loss to rtol 1e-5, every gradient (each vocab shard's among them, which
catches a D-fold scaling) to 1e-4 of the global gradient scale, the
clipped gradients to the JAX gradients times the clip factor of their
global norm (which must take every shard), and the updated parameters to
the optax chain fed the same gradients, to 1e-6.
"""

import datetime
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
SPAWNS = {
    2: [(f'tp2_{c}', 'tp', 2, c) for c in CASES] +
       [(f'dp2_{c}', 'dp', 1, c) for c in CASES],
    4: [(f'tp2x2_{c}', 'tp', 2, c) for c in CASES],
}
RUNS = [run[0] for runs in SPAWNS.values() for run in runs]


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
      params = pickle.loads((workdir / f'{case}.params.pkl').read_bytes())
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
             for run in RUNS}
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
