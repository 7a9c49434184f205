"""The port's pipeline parallelism (``parallel/pipeline.py``) against the
JAX package's single-device functions, on gloo ranks spawned on the CPU.

The cases mirror the JAX package's ``TestPipelineParallel``
(``tests/test_sharding.py``), on 2 and 4 ranks where JAX's run on 8
virtual devices: ('pipe',) meshes of 2 and 4, ('data', 'pipe') 2 x 2 and
('pipe', 'seq') 2 x 2 (``torch.multiprocessing.spawn``, a ``file://``
store under the test's temporary directory, once per world size). Each run
is held to the JAX package's single-device function on the same seeded
numpy inputs and parameters (converted with ``convert.from_jax_params``):
the pipelined mean loss for M in {1, 2}, globally and locally normalized,
the Conformer blocks, the gradients, one train step, the encoding and its
gradients, pp x seq on both of the relay's routes, and the refusals. Each
rank's gradients follow the module's rule and are summed over the pipe and
data axes before the comparison; the pp x seq step sums them itself (the
lattice's over the time axis alone), so a P-fold gradient fails. The rank
functions sit at module level in this file, whose top level imports no
JAX; the JAX references are computed in the test process while the ranks
run.

Tolerances, the JAX package's own: losses rtol 1e-5; gradients rtol 1e-4
and atol 1e-6 of max(the largest gradient, 1); the train step's parameters
rtol 1e-4 / atol 1e-5; the encoding rtol 1e-5 / atol 1e-6, its gradients
rtol 1e-4 / atol 1e-6 against the port's own single-device encoder, and
against JAX's with the gradients' atol (the two libraries' float32
encoders differ by 5.7e-06 in an ``input_proj`` gradient of scale 8.5).
pp x seq adds ``tests/test_torch_sequence.py``'s relay allowance: at least
1e-5 of the largest gradient for FrameLabelDependent's ``blank_b``, a
structural zero made of rounding residue (-2.4e-07 against JAX's -3.8e-06
here); and as AdamW's first update divides each gradient by its own
magnitude, which turns such residue into a whole step, its updated
parameters are held to the optax chain fed the step's own gradients
(``tests/test_torch_parallel.py``'s rule), to 1e-6.
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
from last_torch_tpu_torch.parallel import pipeline, sharding

COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=120)
SPAWN_SECONDS = 300
LEARNING_RATE = 1e-2

# The JAX package's tiny_config (tests/test_models.py), locally normalized
# unless a run says otherwise.
TINY = dict(feature_size=8, vocab_size=4, context_size=1, encoder_size=16,
            encoder_layers=1, encoder_heads=2, encoder_ffn_size=32,
            hidden_size=16, embedding_size=16, max_expansions=1,
            locally_normalized=True)
CONFORMER = dict(encoder_causal=True, encoder_window=3,
                 encoder_conv_kernel=2)
# name -> (config overrides, batch, max_t)
MODELS = {
    'ln2': (dict(encoder_layers=2), 4, 6),
    'ln4': (dict(encoder_layers=4), 4, 6),
    'gn4': (dict(encoder_layers=4, locally_normalized=False), 4, 6),
    'conformer': (dict(encoder_layers=4, **CONFORMER), 2, 6),
    'ln4_t8': (dict(encoder_layers=4), 4, 8),
    'gn4_t8': (dict(encoder_layers=4, locally_normalized=False), 4, 8),
}
DATA_PIPE = (('data', 'pipe'), (2, 2))
# The runs of each spawn: name -> (mesh dims, mesh shape, kind, options).
SPAWNS = {
    2: {
        'pipe2': ((('pipe',), (2,)), 'loss', dict(model='ln2', m=2)),
    },
    4: {
        **{f'loss_m{m}_{norm}': (DATA_PIPE, 'loss',
                                  dict(model=f'{norm}4', m=m,
                                       data_axis='data'))
           for m in (1, 2) for norm in ('ln', 'gn')},
        'pipe4': ((('pipe',), (4,)), 'loss', dict(model='ln4', m=2)),
        'conformer': (DATA_PIPE, 'loss',
                      dict(model='conformer', m=1, data_axis='data')),
        'train': (DATA_PIPE, 'train', dict(model='ln4', m=2,
                                           data_axis='data')),
        'encode': (DATA_PIPE, 'encode', dict(model='ln4', m=2,
                                             data_axis='data')),
        'ppseq_ln': ((('pipe', 'seq'), (2, 2)), 'ppseq',
                     dict(model='ln4_t8', m=2, fused='never')),
        'ppseq_gn_never': ((('pipe', 'seq'), (2, 2)), 'ppseq',
                           dict(model='gn4_t8', m=2, fused='never')),
        'ppseq_gn_auto': ((('pipe', 'seq'), (2, 2)), 'ppseq',
                          dict(model='gn4_t8', m=2, fused='auto')),
        'errors': (DATA_PIPE, 'errors', {}),
    },
}
ALL_RUNS = {name: run for runs in SPAWNS.values() for name, run in
            runs.items()}
LOSS_RUNS = [f'loss_m{m}_{norm}' for m in (1, 2) for norm in ('ln', 'gn')]


def config(name):
  return gnat.GNATConfig(**dict(TINY, **MODELS[name][0]))


def make_batch(name):
  """The model's seeded numpy batch: frames, num_frames, labels,
  num_labels (lengths drawn as the JAX package's pipeline tests draw
  them)."""
  _, batch, max_t = MODELS[name]
  rng = np.random.default_rng(7)
  frames = rng.normal(size=(batch, max_t, TINY['feature_size'])).astype(
      np.float32)
  labels = rng.integers(1, TINY['vocab_size'] + 1,
                        size=(batch, 3)).astype(np.int32)
  num_frames = rng.integers(4, max_t + 1, size=(batch,)).astype(np.int32)
  num_labels = rng.integers(1, 4, size=(batch,)).astype(np.int32)
  return frames, num_frames, labels, num_labels


def _named(tree):
  return {sharding._path_str(path): leaf for path, leaf in
          pytree.tree_flatten_with_path(tree)[0]}


def _numpy(tensors):
  return {name: x.detach().numpy().copy() for name, x in tensors.items()}


# The ranks.


def _recording(params):
  """Port parameters from numpy, as leaves that record gradients."""
  params = convert.from_jax_params(params, device='cpu')
  for leaf in pytree.tree_leaves(params):
    leaf.requires_grad_(True)
  return params


def _summed_grads(mesh, params, axes):
  """Every gradient summed over ``axes`` (the module's rule)."""
  grads = [leaf.grad if leaf.grad is not None else torch.zeros_like(leaf)
           for leaf in pytree.tree_leaves(params)]
  for axis in axes:
    pipeline._Axis.of(mesh, axis).all_reduce(grads)
  names = list(_named(params))
  return dict(zip(names, [g.numpy().copy() for g in grads]))


def _errors(mesh, stored):
  """The refusals' messages."""
  messages = {}
  layers3 = gnat.GNATModel(gnat.GNATConfig(**dict(TINY, encoder_layers=3)),
                           device='cpu')
  for key, fn in (
      ('layers', lambda: pipeline.make_pp_loss_fn(layers3, mesh, 2,
                                                  data_axis='data')),
      ('batch', lambda: pipeline.make_pp_loss_fn(
          gnat.GNATModel(config('ln4'), device='cpu'), mesh, 2,
          data_axis='data')(_recording(stored['ln4']),
                            *(x[:2] for x in make_batch('ln4')))),
      ('mesh', lambda: pipeline.make_pp_mesh(pipeline_parallel=3,
                                             device_type='cpu'))):
    try:
      fn()
      messages[key] = None
    except ValueError as e:
      messages[key] = str(e)
  return messages


def _run(mesh, kind, opts, stored):
  name = opts.get('model')
  if kind == 'errors':
    return _errors(mesh, stored)
  model = gnat.GNATModel(config(name), device='cpu')
  params = _recording(stored[name])
  batch = make_batch(name)
  data_axis = opts.get('data_axis')
  axes = ['pipe'] + ([data_axis] if data_axis else [])
  if kind == 'loss':
    loss_fn = pipeline.make_pp_loss_fn(model, mesh, opts['m'],
                                       data_axis=data_axis)
    loss = loss_fn(params, *batch)
    loss.backward()
    return {'loss': loss.item(), 'grads': _summed_grads(mesh, params, axes)}
  if kind == 'encode':
    encode = pipeline.make_pp_encode_fn(model, mesh, opts['m'],
                                        data_axis=data_axis)
    encoded = encode(params['encoder'], batch[0], batch[1])
    torch.tanh(encoded).sum().backward()
    return {'data': mesh.get_local_rank('data'),
            'encoded': encoded.detach().numpy(),
            'grads': _summed_grads(mesh, params['encoder'], axes)}
  optimizer = gnat.make_optimizer(LEARNING_RATE)
  state = gnat.GNATTrainState(params, optimizer.init(params), 0)
  if kind == 'train':
    step = pipeline.make_pp_train_step(model, optimizer, mesh, opts['m'],
                                       data_axis=data_axis)
    state, loss = step(state, *batch)
    return {'loss': loss.item(), 'step': state.step,
            'params': _numpy(_named(state.params))}
  step = pipeline.make_pp_seq_train_step(model, optimizer, mesh, opts['m'],
                                         fused=opts['fused'])
  loss = step.loss_and_grads(state, *batch).item()
  grads = _numpy({n: x.grad for n, x in _named(params).items()})
  state, step_loss = step(state, *batch)
  return {'loss': loss, 'step_loss': step_loss.item(), 'grads': grads,
          'step': state.step, 'params': _numpy(_named(state.params)),
          'path': model.lattice.last_path}


def _rank_main(rank, world, workdir):
  """One rank: every run of its spawn, results to ``<run>.<rank>.pkl``."""
  from torch.distributed.device_mesh import init_device_mesh
  torch.set_num_threads(1)
  torch.set_float32_matmul_precision('highest')
  workdir = pathlib.Path(workdir)
  dist.init_process_group('gloo', init_method=f'file://{workdir}/store',
                          rank=rank, world_size=world,
                          timeout=COLLECTIVE_TIMEOUT)
  stored = pickle.loads((workdir / 'params.pkl').read_bytes())
  meshes = {}
  try:
    for name, ((dims, shape), kind, opts) in SPAWNS[world].items():
      if dims not in meshes:
        meshes[dims] = init_device_mesh('cpu', shape, mesh_dim_names=dims)
      out = _run(meshes[dims], kind, opts, stored)
      (workdir / f'{name}.{rank}.pkl').write_bytes(pickle.dumps(out))
  finally:
    dist.destroy_process_group()


# The JAX references, in the test process.


@pytest.fixture(scope='module')
def reference(tmp_path_factory):
  """(JAX references by model, the ranks' results by run)."""
  import jax
  import jax.numpy as jnp
  from last_torch_tpu.models import gnat as jax_gnat

  workdir = tmp_path_factory.mktemp('pipeline')
  jax_models, stored = {}, {}
  for name, (overrides, _, _) in MODELS.items():
    jax_models[name] = jax_gnat.GNATModel(
        jax_gnat.GNATConfig(**dict(TINY, **overrides)))
    stored[name] = jax.tree.map(
        np.asarray, jax_models[name].init(jax.random.PRNGKey(0)))

  spawns = []
  for world in SPAWNS:
    sub = workdir / f'world{world}'
    sub.mkdir()
    (sub / 'params.pkl').write_bytes(pickle.dumps(stored))
    spawns.append((world, sub, mp.spawn(_rank_main, args=(world, str(sub)),
                                        nprocs=world, join=False)))

  refs = {}
  for name, model in jax_models.items():
    batch = tuple(map(jnp.asarray, make_batch(name)))
    loss, grads = jax.jit(jax.value_and_grad(model.mean_loss))(
        stored[name], *batch)
    refs[name] = {'loss': float(loss),
                  'grads': _named(jax.tree.map(np.asarray, grads))}
    if name == 'ln4':
      optimizer = jax_gnat.make_optimizer(learning_rate=LEARNING_RATE)
      params = jax.tree.map(jnp.asarray, stored[name])
      state0 = jax_gnat.GNATTrainState(params, optimizer.init(params),
                                       jnp.zeros((), jnp.int32))
      state, loss = jax.jit(
          lambda s, *b, model=model, optimizer=optimizer:
          jax_gnat.train_step(model, optimizer, s, *b))(state0, *batch)
      refs[name]['step_loss'] = float(loss)
      refs[name]['params'] = _named(jax.tree.map(np.asarray, state.params))
  model = jax_models['ln4']
  refs['params'] = stored
  frames, num_frames, _, _ = map(jnp.asarray, make_batch('ln4'))
  refs['encoded'] = np.asarray(model.encoder.apply(
      stored['ln4']['encoder'], frames, num_frames))
  refs['encode_grads'] = _named(jax.tree.map(np.asarray, jax.jit(jax.grad(
      lambda p: jnp.sum(jnp.tanh(model.encoder.apply(p, frames,
                                                     num_frames)))))(
                                                         stored['ln4'][
                                                             'encoder'])))

  results = {}
  for world, sub, ranks in spawns:
    deadline = time.monotonic() + SPAWN_SECONDS
    while not ranks.join(timeout=1):
      if time.monotonic() > deadline:
        for process in ranks.processes:
          process.kill()
        pytest.fail(f'{world} ranks did not finish in {SPAWN_SECONDS} s')
    for name in SPAWNS[world]:
      results[name] = [pickle.loads((sub / f'{name}.{r}.pkl').read_bytes())
                       for r in range(world)]
  return refs, results


def _assert_grads(got, want, structural_zero=0.0):
  """The JAX package's tolerance for the pipeline's gradients; at least
  ``structural_zero`` of the largest gradient."""
  assert set(got) == set(want)
  scale = max(float(np.abs(w).max()) for w in want.values())
  for name, w in want.items():
    npt.assert_allclose(got[name], w, rtol=1e-4,
                        atol=max(1e-6 * max(scale, 1.0),
                                 structural_zero * scale), err_msg=name)


def _check_losses(results, run, refs):
  ref = refs[ALL_RUNS[run][2]['model']]
  for r in results[run]:
    npt.assert_allclose(r['loss'], ref['loss'], rtol=1e-5)


def test_stack_unstack_roundtrip():
  model = gnat.GNATModel(config('ln4'), device='cpu')
  params = model.init(torch.Generator().manual_seed(0))
  stacked = pipeline.stack_layers(params['encoder']['layers'])
  assert stacked['qkv'].shape == (4, 16, 48)
  back = pipeline.unstack_layers(stacked, 4)
  for orig, got in zip(params['encoder']['layers'], back):
    assert set(orig) == set(got)
    for key in orig:
      assert torch.equal(orig[key], got[key]), key


@pytest.mark.parametrize('run', LOSS_RUNS)
def test_pp_loss_matches_single_device(reference, run):
  """('data', 'pipe') 2 x 2, M in {1, 2}, locally and globally
  normalized, against JAX's ``mean_loss``."""
  refs, results = reference
  _check_losses(results, run, refs)


@pytest.mark.parametrize('run', ['pipe2', 'pipe4'])
def test_pp_pipe_only_mesh(reference, run):
  refs, results = reference
  _check_losses(results, run, refs)


def test_pp_conformer_blocks(reference):
  """Causal Conformer blocks (window 3, conv kernel 2), M = 1."""
  refs, results = reference
  _check_losses(results, 'conformer', refs)


@pytest.mark.parametrize('run', LOSS_RUNS + ['pipe2', 'pipe4', 'conformer'])
def test_pp_grads_match_single_device(reference, run):
  """Each rank's gradients summed over the pipe and data axes against
  ``jax.grad(mean_loss)``: a stage that added another's gradient, or a
  rank that used its own cotangent off the last stage, would fail."""
  refs, results = reference
  ref = refs[ALL_RUNS[run][2]['model']]
  for r in results[run]:
    _assert_grads(r['grads'], ref['grads'])


def test_pp_train_step_matches_single_device(reference):
  refs, results = reference
  ref = refs['ln4']
  for r in results['train']:
    assert r['step'] == 1
    npt.assert_allclose(r['loss'], ref['step_loss'], rtol=1e-5)
    assert set(r['params']) == set(ref['params'])
    for name, want in ref['params'].items():
      npt.assert_allclose(r['params'][name], want, rtol=1e-4, atol=1e-5,
                          err_msg=name)


def test_pp_encode_matches_plain_encoder(reference):
  """The pipelined encode (each data rank's rows, the same on both pipe
  ranks) against ``encoder.apply``: values and gradients."""
  refs, results = reference
  ranks = results['encode']
  for data in (0, 1):
    rows = [r['encoded'] for r in ranks if r['data'] == data]
    assert len(rows) == 2
    npt.assert_array_equal(rows[0], rows[1])
  got = np.concatenate([next(r['encoded'] for r in ranks if r['data'] == d)
                        for d in (0, 1)])
  npt.assert_allclose(got, refs['encoded'], rtol=1e-5, atol=1e-6)
  model = gnat.GNATModel(config('ln4'), device='cpu')
  params = convert.from_jax_params(refs['params']['ln4'], device='cpu')
  for leaf in pytree.tree_leaves(params['encoder']):
    leaf.requires_grad_(True)
  frames, num_frames, _, _ = map(torch.as_tensor, make_batch('ln4'))
  torch.tanh(model.encoder.apply(params['encoder'], frames,
                                 num_frames)).sum().backward()
  plain = _numpy({n: x.grad for n, x in _named(params['encoder']).items()})
  for r in ranks:
    assert set(r['grads']) == set(plain)
    for name, want in plain.items():
      npt.assert_allclose(r['grads'][name], want, rtol=1e-4, atol=1e-6,
                          err_msg=name)
    _assert_grads(r['grads'], refs['encode_grads'])


@pytest.mark.parametrize('run', ['ppseq_ln', 'ppseq_gn_never',
                                 'ppseq_gn_auto'])
def test_pp_seq_train_step_matches_single_device(reference, run):
  """pp x seq on ('pipe', 'seq') 2 x 2: the pipelined encoder and the
  time-sharded loss (the generic relay, or the kernel relay's plain
  versions with ``fused='auto'``) against JAX's single-device step: the
  loss, the step's summed gradients (a lattice gradient summed over the
  pipe axis would be 2-fold) and the updated parameters (the optax chain
  fed the step's gradients)."""
  import jax
  import optax
  from last_torch_tpu.models import gnat as jax_gnat

  refs, results = reference
  name = ALL_RUNS[run][2]['model']
  ref = refs[name]
  tx = jax_gnat.make_optimizer(learning_rate=LEARNING_RATE)
  params = jax.tree.map(jax.numpy.asarray, refs['params'][name])
  paths = [sharding._path_str(p) for p, _ in
           jax.tree_util.tree_flatten_with_path(params)[0]]
  for r in results[run]:
    npt.assert_allclose(r['loss'], ref['loss'], rtol=1e-5)
    assert r['step_loss'] == r['loss'] and r['step'] == 1
    _assert_grads(r['grads'], ref['grads'], structural_zero=1e-5)
    grads = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(params), [r['grads'][p] for p in paths])
    updates, _ = tx.update(grads, tx.init(params), params)
    updated = _named(jax.tree.map(np.asarray,
                                  optax.apply_updates(params, updates)))
    for leaf, want in updated.items():
      npt.assert_allclose(r['params'][leaf], want, rtol=0, atol=1e-6,
                          err_msg=leaf)
    if run == 'ppseq_gn_auto':
      assert r['path'] == 'plain'


def test_pp_error_paths(reference):
  _, results = reference
  for r in results['errors']:
    assert 'must divide across' in r['layers']
    assert 'must divide into' in r['batch']
    assert 'must divide' in r['mesh']


def test_pp_mesh_needs_a_process_group():
  with pytest.raises(RuntimeError, match='init_process_group'):
    pipeline.make_pp_mesh(pipeline_parallel=2, device_type='cpu')
