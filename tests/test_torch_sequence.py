"""The port's time-sharded relay (``parallel/sequence.py``) and the relay
seeds of the log-partition kernels against the JAX package.

In process: the bigram and trigram scans' plain versions (what the wrappers
run on CPU tensors) chained over 2 and 4 blocks of frames by their
``alpha0`` / ``beta0`` seeds equal one whole call, with a block in which
every row is padding; with the same non-one-hot seeds they equal JAX's
kernels in interpret mode (float32, rtol 1e-5).

On gloo ranks spawned on the CPU (``torch.multiprocessing.spawn``, a
``file://`` store under the test's temporary directory), once per world
size: ('seq',) meshes of 2 and 4, ('data', 'seq') 2 x 2 and ('seq',
'model') 2 x 2. Each run is held to the JAX package's single-device
functions on the same seeded numpy inputs and parameters (converted with
``convert.from_jax_params``): the log partition on both routes (the generic
relay and the kernel relay, ``fused='auto'``), MaxTropical gradients, the
Expectation relay, the string forward and the loss, the train steps, data x
seq, a fuzz over D, FLD order and ragged or zero lengths, the S = 1
lattice, decode and align, seq x tp, and the refusals. Each rank's
gradients are partial (the module's rule) and are summed over the time
axis (and the data axis) before the comparison, so a D-fold gradient
fails. The rank functions sit at module level in this file, whose top level
imports no JAX; the JAX references are computed in the test process.

Tolerances, the JAX package's own relay tests': values rtol 1e-5 (decode
path weights 1e-6), gradients rtol 1e-4 / atol 5e-6 (the fuzz atol 1e-5,
seq x tp atol 1e-6 of the largest gradient), and at least 1e-5 of the
largest gradient for FrameLabelDependent's ``blank_b``, a structural zero
made of rounding residue; decoded labels and emission frames exact. The
seeds against JAX's kernels: rtol 1e-5, gradients also 1e-5 of each leaf's
largest entry.
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

from last_torch_tpu_torch import (alignments, contexts, convert, lattices,
                                  semirings, weight_fns)
from last_torch_tpu_torch.models import gnat
from last_torch_tpu_torch.ops import fused_scan, trigram_scan
from last_torch_tpu_torch.parallel import sequence, sharding

torch.set_num_threads(1)
torch.set_float32_matmul_precision('highest')

COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=120)
SPAWN_SECONDS = 300
VALUE_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 5e-6
STRUCTURAL_ZERO = 1e-5  # of the largest gradient (``_assert_grads``)
# The seeds' gradients against JAX's interpret-mode kernels: rtol 1e-5 and
# 1e-5 of each leaf's largest entry (float32 sums over T * B terms).
SEED_RTOL = 1e-5
LEARNING_RATE, CLIP_NORM = 1e-2, 0.5

# The JAX package's relay lattice: bigram FullNGram(3), hidden 8, frames
# [2, 8, 4] with lengths [8, 5].
LABELS = np.array([[1, 2, 1], [3, 1, 0]], np.int32)
NUM_LABELS = np.array([3, 2], np.int32)
NUM_FRAMES = np.array([8, 5], np.int32)
# The infeasible transcript: row 1 has 3 labels in 2 frames (FD).
INFEASIBLE = (np.array([[1, 2, 1], [3, 1, 3]], np.int32),
              np.array([8, 2], np.int32), np.array([3, 3], np.int32))
# name: (vocab, context_size, max_expansions)
LATTICES = {'fd': (3, 1, 0), 'fld2': (3, 1, 2), 's1': (3, 0, 0)}
# The fuzz of the JAX package's test_relay_fuzz, at D <= 4:
# name: (D, max_expansions, seed).
FUZZ = {'fuzz0': (2, 0, 0), 'fuzz1': (4, 2, 1), 'fuzz2': (4, 1, 2)}
# The GNAT models of the train steps: name -> config overrides.
MODELS = {
    'gn': dict(feature_size=8, vocab_size=4, context_size=1, encoder_size=16,
               encoder_layers=1, encoder_heads=2, encoder_ffn_size=32,
               hidden_size=16, embedding_size=16, max_expansions=1,
               locally_normalized=False),
    # The JAX package's TestSeqTensorParallel model: a shard holds 128
    # labels at model 2.
    'tp': dict(feature_size=8, vocab_size=256, context_size=1,
               encoder_size=16, encoder_layers=1, encoder_heads=2,
               encoder_ffn_size=32, hidden_size=16, embedding_size=16,
               max_expansions=0, locally_normalized=False),
}
# The runs of each spawn: name -> (mesh dims, mesh shape, kind, options).
SPAWNS = {
    2: {
        'sd_never_d2': (('seq',), (2,), 'sd', dict(fused='never')),
        'sd_auto_d2': (('seq',), (2,), 'sd', dict(fused='auto')),
        'fuzz0_d2': (('seq',), (2,), 'fuzz', dict(case='fuzz0')),
        'train_auto_d2': (('seq',), (2,), 'train', dict(fused='auto')),
    },
    4: {
        'sd_never_d4': (('seq',), (4,), 'sd', dict(fused='never')),
        'sd_auto_d4': (('seq',), (4,), 'sd', dict(fused='auto')),
        'sd_fld2_auto_d4': (('seq',), (4,), 'sd',
                            dict(fused='auto', lattice='fld2')),
        'tropical_d4': (('seq',), (4,), 'tropical', {}),
        'expectation_d4': (('seq',), (4,), 'expectation', {}),
        'string_d4': (('seq',), (4,), 'string', {}),
        'loss_never_d4': (('seq',), (4,), 'loss', dict(fused='never')),
        'loss_auto_d4': (('seq',), (4,), 'loss', dict(fused='auto')),
        'fuzz1_d4': (('seq',), (4,), 'fuzz', dict(case='fuzz1')),
        'fuzz2_d4': (('seq',), (4,), 'fuzz', dict(case='fuzz2')),
        's1_d4': (('seq',), (4,), 's1', {}),
        'counts_d4': (('seq',), (4,), 'counts', {}),
        'path_fd_d4': (('seq',), (4,), 'path', dict(lattice='fd')),
        'path_fld2_d4': (('seq',), (4,), 'path', dict(lattice='fld2')),
        'align_fd_d4': (('seq',), (4,), 'align', dict(lattice='fd')),
        'align_fld2_d4': (('seq',), (4,), 'align', dict(lattice='fld2')),
        'align_infeasible_d4': (('seq',), (4,), 'align',
                                dict(lattice='fd', infeasible=True)),
        'refuse_d4': (('seq',), (4,), 'refuse', {}),
        'train_never_d4': (('seq',), (4,), 'train', dict(fused='never')),
        'dxs_never': (('data', 'seq'), (2, 2), 'loss',
                      dict(fused='never', batch_axis='data')),
        'dxs_auto': (('data', 'seq'), (2, 2), 'loss',
                     dict(fused='auto', batch_axis='data')),
        'dxs_path': (('data', 'seq'), (2, 2), 'path',
                     dict(lattice='fd', batch_axis='data',
                          reference_compat=True)),
        'dxs_train': (('data', 'seq'), (2, 2), 'train',
                      dict(fused='auto', batch_axis='data')),
        'sxm_fd': (('seq', 'model'), (2, 2), 'tp_loss',
                   dict(max_expansions=0)),
        'sxm_fld1': (('seq', 'model'), (2, 2), 'tp_loss',
                     dict(max_expansions=1)),
        'sxm_train': (('seq', 'model'), (2, 2), 'tp_train', {}),
    },
}
ALL_RUNS = {name: run for runs in SPAWNS.values() for name, run in
            runs.items()}


# Inputs and lattices, shared by the ranks and the references.


def relay_frames(max_t=8, batch=2, seed=1, feature=4):
  rng = np.random.default_rng(seed)
  return rng.normal(size=(batch, max_t, feature)).astype(np.float32)


def fuzz_inputs(case):
  """The fuzz case's vocabulary, frames and lengths (zero and ragged
  lengths drawn, as the JAX package's fuzz)."""
  num_devices, max_expansions, seed = FUZZ[case]
  rng = np.random.default_rng(seed)
  vocab = int(rng.integers(2, 6))
  batch = int(rng.integers(1, 4))
  max_t = num_devices * int(rng.integers(1, 4))
  frames = rng.normal(size=(batch, max_t, 4)).astype(np.float32)
  num_frames = rng.integers(0, max_t + 1, size=(batch,)).astype(np.int32)
  labels = rng.integers(1, vocab + 1, size=(batch, 2)).astype(np.int32)
  num_labels = np.minimum(rng.integers(0, 3, size=(batch,)),
                          num_frames * max(max_expansions, 1)).astype(
                              np.int32)
  return vocab, frames, num_frames, labels, num_labels


def model_batch(name, batch=2, max_t=8):
  rng = np.random.default_rng(3)
  vocab = MODELS[name]['vocab_size']
  frames = rng.normal(size=(batch, max_t, 8)).astype(np.float32)
  num_frames = np.array([8, 5], np.int32)[:batch]
  labels = rng.integers(1, vocab + 1, size=(batch, 3)).astype(np.int32)
  num_labels = np.array([3, 2], np.int32)[:batch]
  return frames, num_frames, labels, num_labels


def port_lattice(vocab, context_size, max_expansions, hidden=8):
  alignment = (alignments.FrameLabelDependent(max_expansions)
               if max_expansions else alignments.FrameDependent())
  return lattices.RecognitionLattice(
      context=contexts.FullNGram(vocab_size=vocab,
                                 context_size=context_size),
      alignment=alignment,
      weight_fn_cacher_factory=lambda ctx: weight_fns.SharedEmbCacher(
          num_context_states=ctx.shape()[0], embedding_size=8),
      weight_fn_factory=lambda ctx: weight_fns.JointWeightFn(
          vocab_size=ctx.shape()[1], hidden_size=hidden))


def jax_lattice(vocab, context_size, max_expansions, hidden=8, fused='never'):
  import last_torch_tpu
  from last_torch_tpu import alignments as jal, contexts as jc
  from last_torch_tpu import weight_fns as jw
  alignment = (jal.FrameLabelDependent(max_expansions)
               if max_expansions else jal.FrameDependent())
  return last_torch_tpu.RecognitionLattice(
      context=jc.FullNGram(vocab_size=vocab, context_size=context_size),
      alignment=alignment,
      weight_fn_cacher_factory=lambda ctx: jw.SharedEmbCacher(
          num_context_states=ctx.shape()[0], embedding_size=8),
      weight_fn_factory=lambda ctx: jw.JointWeightFn(
          vocab_size=ctx.shape()[1], hidden_size=hidden),
      fused=fused)


def _named(tree):
  return {sharding._path_str(path): np.asarray(leaf) for path, leaf in
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


def _reduced_grads(mesh, params, frames, batch_axis=None):
  """Every gradient summed over the time axis (and the data axis): the
  module's rule."""
  grads = [leaf.grad if leaf.grad is not None else torch.zeros_like(leaf)
           for leaf in pytree.tree_leaves(params)]
  frame_grad = (frames.grad if frames.grad is not None else
                torch.zeros_like(frames))
  seq = sequence._Axis.of(mesh, 'seq')
  seq.all_reduce(grads + [frame_grad])
  if batch_axis is not None:
    sequence._Axis.of(mesh, batch_axis).all_reduce(grads)
  names = list(_named(pytree.tree_map(lambda x: x.detach(), params)))
  return dict(zip(names, [g.numpy().copy() for g in grads])), (
      frame_grad.numpy().copy())


def _rows(mesh, batch_axis, *arrays):
  """This rank's rows of each array (all of them without ``batch_axis``)."""
  if batch_axis is None:
    return arrays
  parts = mesh.shape[mesh.mesh_dim_names.index(batch_axis)]
  index = mesh.get_local_rank(batch_axis)
  size = arrays[0].shape[0] // parts
  return tuple(a[index * size:(index + 1) * size] for a in arrays)


def _lattice_run(mesh, kind, opts, stored):
  name = opts.get('lattice', 'fd')
  lattice = port_lattice(*LATTICES[name])
  params = _recording(stored[name])
  batch_axis = opts.get('batch_axis')
  frames_np, nf, labels, nl = _rows(mesh, batch_axis, relay_frames(),
                                    NUM_FRAMES, LABELS, NUM_LABELS)
  frames = torch.tensor(frames_np, requires_grad=True)
  nf, labels, nl = map(torch.tensor, (nf, labels, nl))
  out = {'data': (mesh.get_local_rank(batch_axis) if batch_axis else 0)}
  if kind in ('sd', 'tropical', 'string', 'loss', 's1'):
    if kind == 'sd':
      value = sequence.shortest_distance_time_sharded(
          lattice, params, frames, nf, mesh, 'seq', fused=opts['fused'])
      out['path'] = lattice.last_path
    elif kind == 'tropical':
      value = sequence.shortest_distance_time_sharded(
          lattice, params, frames, nf, mesh, 'seq',
          semiring=semirings.MaxTropical)
    elif kind == 'string':
      value = sequence.string_forward_time_sharded(
          lattice, params, frames, nf, labels, nl, mesh, 'seq')
    else:
      if kind == 's1':
        lattice = port_lattice(*LATTICES['s1'])
        params = _recording(stored['s1'])
      value = sequence.loss_time_sharded(
          lattice, params, frames, nf, labels, nl, mesh, 'seq',
          fused=opts.get('fused', 'never'), batch_axis=batch_axis)
    value.sum().backward()
    out['value'] = value.detach().numpy()
    out['grads'], out['frame_grad'] = _reduced_grads(mesh, params, frames,
                                                     batch_axis)
    if kind == 's1':
      out['decode'] = [x.numpy() for x in sequence.shortest_path_time_sharded(
          lattice, params, frames, nf, mesh, 'seq')]
  elif kind == 'expectation':
    sr = semirings.LogLogExpectation
    lift = lambda w: sr.weighted(w, torch.log(torch.clamp(-w, min=1e-30)))
    with torch.no_grad():
      value = sequence.shortest_distance_time_sharded(
          lattice, params, frames, nf, mesh, 'seq', semiring=sr,
          weight_lift=lift)
    out['value'] = [v.numpy() for v in value]
  elif kind == 'path':
    out['decode'] = [x.numpy() for x in sequence.shortest_path_time_sharded(
        lattice, params, frames, nf, mesh, 'seq', batch_axis=batch_axis,
        reference_compat=opts.get('reference_compat', False))]
  elif kind == 'align':
    if opts.get('infeasible'):
      labels, nf, nl = map(torch.tensor, INFEASIBLE)
    emit, weights = sequence.align_time_sharded(
        lattice, params, frames, nf, labels, nl, mesh, 'seq')
    out['align'] = (emit.numpy(), weights.numpy())
  return out


def _fuzz_run(mesh, case, stored):
  vocab, frames_np, nf, labels, nl = fuzz_inputs(case)
  lattice = port_lattice(vocab, 1, FUZZ[case][1])
  params = _recording(stored[case])
  frames = torch.tensor(frames_np, requires_grad=True)
  losses = sequence.loss_time_sharded(
      lattice, params, frames, torch.tensor(nf), torch.tensor(labels),
      torch.tensor(nl), mesh, 'seq')
  total = torch.where(torch.isfinite(losses), losses, 0.0).sum()
  total.backward()
  grads, _ = _reduced_grads(mesh, params, frames)
  return {'value': float(total.detach()), 'grads': grads}


def _counts_run(mesh, stored):
  """Each block runs once forward and once backward: the generic relay
  (a counting ``local_fn``, the JAX package's test) and the kernel relay
  (calls of the plain versions, which the wrappers run on CPU tensors)."""
  calls = []

  def local_fn(carry, block, my_idx, diff_args):
    calls.append(my_idx)
    (w,) = diff_args
    return carry * w + block[..., 0].sum(dim=-1, keepdim=True)

  frames = torch.arange(2 * 8 * 3, dtype=torch.float32).reshape(2, 8, 3)
  w = torch.ones((), requires_grad=True)
  run = sequence._relay(mesh, 'seq', local_fn)
  axis = sequence._Axis.of(mesh, 'seq')
  out = run(torch.zeros((2, 1)), sequence._local_block(frames, axis, 2),
            (w,))
  forward_calls = len(calls)
  out.sum().backward()
  result = {'relay_out': out.detach().numpy(),
            'relay_calls': (forward_calls, len(calls) - forward_calls)}
  counts = {'forward': 0, 'backward': 0}
  originals = (fused_scan.fused_forward_plain, fused_scan.fused_backward_plain)

  def counting(kind, fn):
    def wrapped(*args, **kwargs):
      counts[kind] += 1
      return fn(*args, **kwargs)
    return wrapped

  fused_scan.fused_forward_plain = counting('forward', originals[0])
  fused_scan.fused_backward_plain = counting('backward', originals[1])
  try:
    lattice = port_lattice(*LATTICES['fd'])
    params = _recording(stored['fd'])
    log_z = sequence.shortest_distance_time_sharded(
        lattice, params, torch.tensor(relay_frames()),
        torch.tensor(NUM_FRAMES), mesh, 'seq', fused='auto')
    result['kernel_forward_calls'] = counts['forward']
    log_z.sum().backward()
  finally:
    fused_scan.fused_forward_plain, fused_scan.fused_backward_plain = (
        originals)
  result['kernel_calls'] = (counts['forward'], counts['backward'])
  return result


def _refuse_run(mesh, stored):
  lattice = port_lattice(*LATTICES['fd'])
  params = _recording(stored['fd'])
  frames = torch.tensor(relay_frames())[:, :6]
  try:
    sequence.shortest_distance_time_sharded(
        lattice, params, frames, torch.tensor(NUM_FRAMES), mesh, 'seq')
  except ValueError as e:
    return {'refused': str(e)}
  return {'refused': None}


def _train_run(mesh, kind, opts, stored):
  """Loss and summed gradients of one step (``loss_and_grads``), then the
  step itself: its loss, the clipped gradients and the updated
  parameters."""
  model_name = 'tp' if kind == 'tp_train' else 'gn'
  model = gnat.GNATModel(gnat.GNATConfig(**MODELS[model_name]), device='cpu')
  optimizer = gnat.make_optimizer(LEARNING_RATE, clip_norm=CLIP_NORM)
  params = _recording(stored[model_name])
  state = gnat.GNATTrainState(params, optimizer.init(params), 0)
  batch_axis = opts.get('batch_axis')
  if kind == 'tp_train':
    step = sequence.make_tp_seq_train_step(model, optimizer, mesh)
  else:
    step = sequence.make_time_sharded_train_step(
        model, optimizer, mesh, fused=opts['fused'], batch_axis=batch_axis)
  local = _rows(mesh, batch_axis, *model_batch(model_name))
  loss = step.loss_and_grads(state, *local).item()
  grads = _numpy({n: x.grad for n, x in _named_tensors(params).items()})
  state, step_loss = step(state, *local)
  return {'loss': loss, 'step_loss': step_loss.item(), 'step': state.step,
          'grads': grads,
          'params': _numpy(_named_tensors(state.params))}


def _named_tensors(params):
  return {sharding._path_str(path): leaf for path, leaf in
          pytree.tree_flatten_with_path(params)[0]}


def _tp_loss_run(mesh, opts, stored):
  config = dict(MODELS['tp'], max_expansions=opts['max_expansions'])
  model = gnat.GNATModel(gnat.GNATConfig(**config), device='cpu')
  params = _recording(stored[f"tp_lattice{opts['max_expansions']}"])
  frames = torch.tensor(np.random.default_rng(5).normal(
      size=(2, 8, 16)).astype(np.float32), requires_grad=True)
  _, nf, labels, nl = model_batch('tp')
  loss = sequence.tp_loss_time_sharded(
      model.lattice, params, frames, torch.tensor(nf), torch.tensor(labels),
      torch.tensor(nl), mesh, 'seq', 'model')
  loss.sum().backward()
  grads, frame_grad = _reduced_grads(mesh, params, frames)
  return {'value': loss.detach().numpy(), 'grads': grads,
          'frame_grad': frame_grad}


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
    for name, (dims, shape, kind, opts) in SPAWNS[world].items():
      if dims not in meshes:
        meshes[dims] = init_device_mesh('cpu', shape, mesh_dim_names=dims)
      mesh = meshes[dims]
      if kind == 'fuzz':
        out = _fuzz_run(mesh, opts['case'], stored)
      elif kind == 'counts':
        out = _counts_run(mesh, stored)
      elif kind == 'refuse':
        out = _refuse_run(mesh, stored)
      elif kind in ('train', 'tp_train'):
        out = _train_run(mesh, kind, opts, stored)
      elif kind == 'tp_loss':
        out = _tp_loss_run(mesh, opts, stored)
      else:
        out = _lattice_run(mesh, kind, opts, stored)
      (workdir / f'{name}.{rank}.pkl').write_bytes(pickle.dumps(out))
  finally:
    dist.destroy_process_group()


# The JAX references, in the test process.


def _jax_params(lattice, seed=0, feature_size=4):
  import jax
  params = lattice.init(jax.random.PRNGKey(seed), feature_size=feature_size)
  return jax.tree.map(np.asarray, params)


def _jax_grad(fn, params, *rest):
  import jax
  value, grads = jax.value_and_grad(fn)(params, *rest)
  return np.asarray(value), jax.tree.map(np.asarray, grads)


@pytest.fixture(scope='module')
def reference(tmp_path_factory):
  """(parameters, JAX references by run, the ranks' results by run)."""
  import jax
  import jax.numpy as jnp
  from last_torch_tpu import semirings as jsr
  from last_torch_tpu.models import gnat as jax_gnat

  workdir = tmp_path_factory.mktemp('sequence')
  stored, jl = {}, {}
  for name, spec in LATTICES.items():
    jl[name] = jax_lattice(*spec)
    stored[name] = _jax_params(jl[name])
  for case, (_, max_expansions, seed) in FUZZ.items():
    vocab = fuzz_inputs(case)[0]
    jl[case] = jax_lattice(vocab, 1, max_expansions)
    stored[case] = _jax_params(jl[case], seed=seed)
  jax_models = {}
  for name, config in MODELS.items():
    jax_models[name] = jax_gnat.GNATModel(jax_gnat.GNATConfig(**config))
    stored[name] = jax.tree.map(
        np.asarray, jax_models[name].init(jax.random.PRNGKey(0)))
  for k in (0, 1):
    model = jax_gnat.GNATModel(jax_gnat.GNATConfig(
        **dict(MODELS['tp'], max_expansions=k)))
    jl[f'tp_lattice{k}'] = model.lattice
    stored[f'tp_lattice{k}'] = jax.tree.map(
        np.asarray, model.init(jax.random.PRNGKey(0))['lattice'])
  (workdir / 'params.pkl').write_bytes(pickle.dumps(stored))

  # Start the ranks; the references are computed while they run.
  spawns = []
  for world in SPAWNS:
    sub = workdir / f'world{world}'
    sub.mkdir()
    (sub / 'params.pkl').write_bytes(pickle.dumps(stored))
    spawns.append((world, sub, mp.spawn(_rank_main, args=(world, str(sub)),
                                        nprocs=world, join=False)))

  frames = jnp.asarray(relay_frames())
  nf, labels, nl = map(jnp.asarray, (NUM_FRAMES, LABELS, NUM_LABELS))
  refs = {}

  def distance(lattice, semiring):
    def fn(params, frames):
      sd, _ = lattice._forward(params, lattice.build_cache(params), frames,
                               nf, semiring)
      return jnp.sum(sd)
    return fn

  def grads_of(fn, params):
    value, (gp, gf) = jax.value_and_grad(fn, argnums=(0, 1))(params, frames)
    return {'sum': float(value), 'grads': _named(jax.tree.map(np.asarray,
                                                              gp)),
            'frame_grad': np.asarray(gf)}

  for name in ('fd', 'fld2'):
    refs[f'sd_{name}'] = grads_of(distance(jl[name], jsr.Log),
                                  stored[name])
  refs['tropical'] = grads_of(distance(jl['fd'], jsr.MaxTropical),
                              stored['fd'])
  sr = jsr.LogLogExpectation
  lift = lambda w: sr.weighted(w, jnp.log(jnp.maximum(-w, 1e-30)))
  refs['expectation'] = [np.asarray(v) for v in jl['fd'].shortest_distance(
      stored['fd'], frames, nf, semiring=sr, weight_lift=lift)]
  refs['string'] = grads_of(
      lambda p, f: jnp.sum(jl['fd']._string_forward(
          p, jl['fd'].build_cache(p), f, nf, labels, nl, jsr.Log)),
      stored['fd'])
  for name in ('fd', 's1'):
    refs[f'loss_{name}'] = grads_of(
        lambda p, f, lat=jl[name]: jnp.sum(lat(
            p, frames=f, num_frames=nf, labels=labels, num_labels=nl)),
        stored[name])
  refs['loss_rows'] = np.asarray(jl['fd'](stored['fd'], frames=frames,
                                          num_frames=nf, labels=labels,
                                          num_labels=nl))
  for case in FUZZ:
    _, f, n, lab, nlab = fuzz_inputs(case)

    def fuzz_total(p, lat=jl[case], f=f, n=n, lab=lab, nlab=nlab):
      losses = lat(p, frames=jnp.asarray(f), num_frames=jnp.asarray(n),
                   labels=jnp.asarray(lab), num_labels=jnp.asarray(nlab))
      return jnp.sum(jnp.where(jnp.isfinite(losses), losses, 0.0))

    value, grads = _jax_grad(fuzz_total, stored[case])
    refs[case] = {'sum': float(value), 'grads': _named(grads)}
  for name in ('fd', 'fld2', 's1'):
    refs[f'path_{name}'] = [np.asarray(x) for x in jl[name].shortest_path(
        stored[name], frames, nf)]
  refs['path_compat'] = [np.asarray(x) for x in jl['fd'].shortest_path(
      stored['fd'], frames, nf, reference_compat=True)]
  for name in ('fd', 'fld2'):
    refs[f'align_{name}'] = [np.asarray(x) for x in jl[name].align(
        stored[name], frames, nf, labels, nl)]
  refs['align_infeasible'] = [np.asarray(x) for x in jl['fd'].align(
      stored['fd'], frames, *map(jnp.asarray, (INFEASIBLE[1], INFEASIBLE[0],
                                               INFEASIBLE[2])))]
  for name, model in jax_models.items():
    value, grads = _jax_grad(model.mean_loss, stored[name],
                             *model_batch(name))
    refs[f'train_{name}'] = {'loss': float(value), 'grads': _named(grads)}
  tp_frames = jnp.asarray(np.random.default_rng(5).normal(
      size=(2, 8, 16)).astype(np.float32))
  _, tnf, tlab, tnl = map(jnp.asarray, model_batch('tp'))
  for k in (0, 1):
    lat = jl[f'tp_lattice{k}']

    def tp_total(p, f, lat=lat):
      return jnp.sum(lat(p, frames=f, num_frames=tnf, labels=tlab,
                         num_labels=tnl))

    value, (gp, gf) = jax.value_and_grad(tp_total, argnums=(0, 1))(
        stored[f'tp_lattice{k}'], tp_frames)
    refs[f'tp{k}'] = {'sum': float(value),
                      'grads': _named(jax.tree.map(np.asarray, gp)),
                      'frame_grad': np.asarray(gf)}

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
  return stored, refs, results


def _assert_grads(got, want, rtol=GRAD_RTOL, atol=GRAD_ATOL):
  """Per leaf to ``rtol`` / ``atol``, and at least 1e-5 of the largest
  gradient: FrameLabelDependent's ``blank_b`` gradient is a structural zero
  made of rounding residue, which the order of the sums moves."""
  assert set(got) == set(want)
  scale = max(float(np.abs(w).max()) for w in want.values())
  for name, w in want.items():
    npt.assert_allclose(got[name], w, rtol=rtol,
                        atol=max(atol, STRUCTURAL_ZERO * scale),
                        err_msg=name)


def _check_value_and_grads(ranks, ref, **tol):
  for r in ranks:
    npt.assert_allclose(float(np.sum(r['value'])), ref['sum'],
                        rtol=VALUE_RTOL)
    _assert_grads(r['grads'], ref['grads'], **tol)
    if 'frame_grad' in ref:
      npt.assert_allclose(r['frame_grad'], ref['frame_grad'], rtol=GRAD_RTOL,
                          atol=tol.get('atol', GRAD_ATOL))


@pytest.mark.parametrize('run', ['sd_never_d2', 'sd_auto_d2', 'sd_never_d4',
                                 'sd_auto_d4', 'sd_fld2_auto_d4'])
def test_log_partition_and_grads_match_jax(reference, run):
  """The generic relay and the kernel relay (``fused='auto'``: the plain
  versions chained by their seeds) against JAX's single-device forward."""
  _, refs, results = reference
  lattice = ALL_RUNS[run][3].get('lattice', 'fd')
  _check_value_and_grads(results[run], refs[f'sd_{lattice}'])
  fused = ALL_RUNS[run][3]['fused']
  for r in results[run]:
    assert r['path'] == ('plain' if fused == 'auto' else None)


def test_tropical_grads_match_jax(reference):
  _, refs, results = reference
  _check_value_and_grads(results['tropical_d4'], refs['tropical'])


def test_expectation_relay_matches_jax(reference):
  _, refs, results = reference
  for r in results['expectation_d4']:
    for got, want in zip(r['value'], refs['expectation']):
      npt.assert_allclose(got, want, rtol=VALUE_RTOL, atol=1e-6)


@pytest.mark.parametrize('run,ref', [('string_d4', 'string'),
                                     ('loss_never_d4', 'loss_fd'),
                                     ('loss_auto_d4', 'loss_fd'),
                                     ('s1_d4', 'loss_s1')])
def test_string_forward_and_loss_grads_match_jax(reference, run, ref):
  _, refs, results = reference
  _check_value_and_grads(results[run], refs[ref])


@pytest.mark.parametrize('run', ['dxs_never', 'dxs_auto'])
def test_data_x_seq_loss_matches_jax(reference, run):
  """dp x seq: each data rank's rows, gradients summed over both axes."""
  _, refs, results = reference
  ranks = results[run]
  rows = {}
  for r in ranks:
    rows.setdefault(r['data'], r['value'])
    npt.assert_allclose(r['value'], rows[r['data']], rtol=0, atol=0)
  got = np.concatenate([rows[d] for d in sorted(rows)])
  npt.assert_allclose(got, refs['loss_rows'], rtol=VALUE_RTOL)
  for r in ranks:
    _assert_grads(r['grads'], refs['loss_fd']['grads'])


@pytest.mark.parametrize('run', ['fuzz0_d2', 'fuzz1_d4', 'fuzz2_d4'])
def test_relay_fuzz_matches_jax(reference, run):
  _, refs, results = reference
  ref = refs[ALL_RUNS[run][3]['case']]
  for r in results[run]:
    npt.assert_allclose(r['value'], ref['sum'], rtol=VALUE_RTOL, atol=1e-6)
    _assert_grads(r['grads'], ref['grads'], atol=1e-5)


def test_relay_runs_each_block_once(reference):
  _, _, results = reference
  frames = np.arange(2 * 8 * 3, dtype=np.float32).reshape(2, 8, 3)
  for r in results['counts_d4']:
    npt.assert_allclose(r['relay_out'], frames[..., 0].sum(-1,
                                                           keepdims=True))
    # One forward and one recomputed block a rank (4 of each, not 16).
    assert r['relay_calls'] == (1, 1)
    # The kernel relay: one primal forward, and in the backward one
    # forward (the recomputed history) and one backward a rank.
    assert r['kernel_forward_calls'] == 1
    assert r['kernel_calls'] == (2, 1)


@pytest.mark.parametrize('run,ref', [('path_fd_d4', 'path_fd'),
                                     ('path_fld2_d4', 'path_fld2'),
                                     ('s1_d4', 'path_s1'),
                                     ('dxs_path', 'path_compat')])
def test_shortest_path_matches_jax(reference, run, ref):
  _, refs, results = reference
  ranks = results[run]
  rows = {}
  for r in ranks:
    rows.setdefault(r['data'], r['decode'])
    for got, want in zip(r['decode'], rows[r['data']]):
      npt.assert_array_equal(got, want)
  decode = [np.concatenate([rows[d][i] for d in sorted(rows)])
            for i in range(3)]
  want = refs[ref]
  npt.assert_array_equal(decode[0], want[0])
  npt.assert_array_equal(decode[1], want[1])
  npt.assert_allclose(decode[2], want[2], rtol=1e-6)


@pytest.mark.parametrize('run,ref', [('align_fd_d4', 'align_fd'),
                                     ('align_fld2_d4', 'align_fld2')])
def test_align_matches_jax(reference, run, ref):
  _, refs, results = reference
  for r in results[run]:
    emit, weights = r['align']
    npt.assert_array_equal(emit, refs[ref][0])
    npt.assert_allclose(weights, refs[ref][1], rtol=1e-6)


def test_align_infeasible_transcript(reference):
  """An infeasible row keeps the -inf score; the feasible row aligns as
  JAX's."""
  _, refs, results = reference
  want_emit, want_weights = refs['align_infeasible']
  assert np.isneginf(want_weights[1])
  for r in results['align_infeasible_d4']:
    emit, weights = r['align']
    assert np.isneginf(weights[1])
    npt.assert_allclose(weights[0], want_weights[0], rtol=1e-6)
    npt.assert_array_equal(emit[0], want_emit[0])


def test_refuses_indivisible_frames(reference):
  _, _, results = reference
  for r in results['refuse_d4']:
    assert r['refused'] is not None and 'divisible' in r['refused']


@pytest.mark.parametrize('run', ['train_auto_d2', 'train_never_d4',
                                 'dxs_train', 'sxm_train'])
def test_train_step_matches_jax(reference, run):
  """One time-sharded (or seq x tp) step: the loss, the summed gradients
  (equal on every rank, not D times JAX's), and AdamW fed them."""
  import jax
  import optax
  from last_torch_tpu.models import gnat as jax_gnat

  stored, refs, results = reference
  model_name = 'tp' if run == 'sxm_train' else 'gn'
  ref = refs[f'train_{model_name}']
  scale = max(float(np.abs(w).max()) for w in ref['grads'].values())
  for r in results[run]:
    npt.assert_allclose(r['loss'], ref['loss'], rtol=VALUE_RTOL)
    assert r['step_loss'] == r['loss'] and r['step'] == 1
    _assert_grads(r['grads'], ref['grads'], atol=max(GRAD_ATOL,
                                                     1e-6 * scale))
  grads = results[run][0]['grads']
  for r in results[run][1:]:
    for name, g in grads.items():
      npt.assert_array_equal(r['grads'][name], g, err_msg=name)
  # AdamW with the clip: the optax chain fed the step's own gradients.
  tx = jax_gnat.make_optimizer(learning_rate=LEARNING_RATE,
                               clip_norm=CLIP_NORM)
  params = jax.tree.map(jax.numpy.asarray, stored[model_name])
  leaves, tree = jax.tree_util.tree_flatten_with_path(params)
  jax_grads = jax.tree_util.tree_unflatten(
      tree, [grads[sharding._path_str(p)] for p, _ in leaves])
  updates, _ = tx.update(jax_grads, tx.init(params), params)
  updated = _named(jax.tree.map(np.asarray,
                                optax.apply_updates(params, updates)))
  for r in results[run]:
    for name, w in updated.items():
      npt.assert_allclose(r['params'][name], w, rtol=0, atol=1e-6,
                          err_msg=name)


@pytest.mark.parametrize('run,k', [('sxm_fd', 0), ('sxm_fld1', 1)])
def test_seq_x_tp_loss_and_grads_match_jax(reference, run, k):
  _, refs, results = reference
  ref = refs[f'tp{k}']
  scale = max(float(np.abs(w).max()) for w in ref['grads'].values())
  _check_value_and_grads(results[run], ref, atol=1e-6 * max(scale, 1.0))


def test_seq_x_tp_refuses_an_unsupported_lattice():
  lattice = port_lattice(4, 2, 1)
  with pytest.raises(ValueError, match='tensor-parallel'):
    sequence.tp_loss_time_sharded(lattice, {}, None, None, None, None, None)
  model = gnat.GNATModel(gnat.GNATConfig(**dict(
      MODELS['gn'], context_size=2)), device='cpu')
  with pytest.raises(ValueError, match='tensor-parallel'):
    sequence.make_tp_seq_train_step(model, gnat.make_optimizer(), None)


# The relay seeds, in process.


def _seeded_block_inputs(vocab, context_size, max_expansions, batch=3,
                         max_t=8, seed=7):
  """Port and JAX lattices and parameters, frames and the staged pf, pc,
  head of the scans."""
  jl = jax_lattice(vocab, context_size, max_expansions)
  params = _jax_params(jl, seed=seed)
  wf = convert.from_jax_params(params['weight_fn'], device='cpu')
  lattice = port_lattice(vocab, context_size, max_expansions)
  cache = lattice.build_cache(convert.from_jax_params(params, device='cpu'))
  frames = torch.tensor(relay_frames(max_t, batch, seed + 1))
  return jl, params, wf, cache, frames


def _stage(wf, cache, frames, num_frames, t0, t1):
  pf, pc, is_pad = fused_scan._stage(
      cache, frames[:, t0:t1], num_frames - t0, wf['frame_proj'],
      wf['context_proj'])
  head = {n: wf[n] for n in ('vocab_w', 'vocab_b', 'blank_w', 'blank_b')}
  return pf, pc, head, is_pad


def _chain(ops_forward, ops_backward, wf, cache, frames, num_frames, blocks,
           kw):
  """log Z, final alpha, and the backward's outputs of the scans chained
  over ``blocks`` equal blocks of frames: forward by alpha0, backward in
  reverse by beta0 with the whole sequence's log Z."""
  max_t = frames.shape[1]
  size = max_t // blocks
  alpha, saved = None, []
  for b in range(blocks):
    pf, pc, head, is_pad = _stage(wf, cache, frames, num_frames, b * size,
                                  (b + 1) * size)
    _, alpha, hist, slabs = ops_forward(pf, pc, head, is_pad,
                                        with_residuals=True, alpha0=alpha,
                                        **kw)
    saved.append((pf, pc, head, is_pad, hist, slabs))
  log_z = torch.logsumexp(alpha, dim=-1)
  g = torch.linspace(0.5, 1.5, frames.shape[0])
  beta, dpfs, sums = None, [], None
  for b in reversed(range(blocks)):
    pf, pc, head, is_pad, hist, slabs = saved[b]
    *grads, beta = ops_backward(pf, pc, head, is_pad, log_z, g, hist, slabs,
                                beta0=beta, **kw)
    dpfs.insert(0, grads[0])
    sums = grads[1:] if sums is None else [a + x for a, x in
                                          zip(sums, grads[1:])]
  return log_z, alpha, [torch.cat(dpfs)] + sums + [beta]


@pytest.mark.parametrize('scan', ['bigram', 'trigram'])
@pytest.mark.parametrize('max_expansions', [0, 2])
@pytest.mark.parametrize('blocks', [2, 4])
def test_chained_plain_scans_equal_one_whole_call(scan, max_expansions,
                                                  blocks):
  """The wrappers' plain versions chained by alpha0 / beta0 == one call;
  the last block holds padding only (and row 2 no frame at all)."""
  forward = (fused_scan.fused_forward if scan == 'bigram' else
             trigram_scan.trigram_forward)
  backward = (fused_scan.fused_backward if scan == 'bigram' else
              trigram_scan.trigram_backward)
  vocab = 3
  _, _, wf, cache, frames = _seeded_block_inputs(
      vocab, 1 if scan == 'bigram' else 2, max_expansions)
  max_t = frames.shape[1]
  num_frames = torch.tensor([max_t - max_t // blocks, 3, 0])
  kw = dict(max_expansions=max_expansions,
            frame_dependent=max_expansions == 0,
            compute_dtype=torch.float32)
  whole = _chain(forward, backward, wf, cache, frames, num_frames, 1, kw)
  chained = _chain(forward, backward, wf, cache, frames, num_frames, blocks,
                   kw)
  npt.assert_allclose(chained[0], whole[0], rtol=1e-5)
  npt.assert_allclose(chained[1], whole[1], rtol=1e-5, atol=1e-6)
  for got, want in zip(chained[2], whole[2]):
    npt.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
  # The padding-only block and the empty row have exactly zero gradient.
  dpf = chained[2][0]
  assert not dpf[max_t - max_t // blocks:].any()
  assert not dpf[:, 2].any()


def _port_weight_grads(wf, cache, frames, dpf, dpc, dvw, dvb, dbw, dbb):
  """The backward's outputs as gradients of the weight-function parameters,
  the cache and the frames (``fused_scan._LogPartition``'s products)."""
  return ({'frame_proj': torch.einsum('btf,tbh->fh', frames, dpf),
           'context_proj': cache.t() @ dpc, 'vocab_w': dvw, 'vocab_b': dvb,
           'blank_w': dbw, 'blank_b': dbb},
          dpc @ wf['context_proj'].t(),
          torch.einsum('tbh,fh->btf', dpf, wf['frame_proj']))


def _assert_seed_grads(got, want):
  for i, (g, w) in enumerate(zip(got, want)):
    w = np.asarray(w)
    npt.assert_allclose(g, w, rtol=SEED_RTOL,
                        atol=SEED_RTOL * float(np.abs(w).max()),
                        err_msg=str(i))


@pytest.mark.parametrize('max_expansions', [0, 2])
def test_bigram_seeds_match_jax_interpret(max_expansions):
  """Random, non-one-hot alpha0 and beta0 into the port's plain versions
  and JAX's kernels in interpret mode (float32)."""
  import jax.numpy as jnp
  from last_torch_tpu.ops import fused_scan as jax_fused_scan

  vocab = 3
  jl, params, wf, cache, frames = _seeded_block_inputs(vocab, 1,
                                                       max_expansions)
  num_frames = torch.tensor([8, 5, 0])
  rng = np.random.default_rng(11)
  alpha0 = rng.normal(size=(3, vocab + 1)).astype(np.float32)
  beta0 = rng.normal(size=(3, vocab + 1)).astype(np.float32)
  g = np.array([1.0, 0.5, 2.0], np.float32)
  kw = dict(max_expansions=max_expansions,
            frame_dependent=max_expansions == 0)
  jkw = dict(kw, num_context_states=vocab + 1, compute_dtype=jnp.float32,
             interpret=True)
  jwf = params['weight_fn']
  jcache = jl.build_cache(params)
  j_log_z, j_hist, j_final = jax_fused_scan.fused_shortest_distance_fwd(
      jwf, jcache, jnp.asarray(frames.numpy()), jnp.asarray(num_frames),
      alpha0=jnp.asarray(alpha0), return_final_alpha=True, **jkw)
  pf, pc, head, is_pad = _stage(wf, cache, frames, num_frames, 0, 8)
  log_z, final, hist, slabs = fused_scan.fused_forward(
      pf, pc, head, is_pad, with_residuals=True,
      alpha0=torch.tensor(alpha0), compute_dtype=torch.float32, **kw)
  npt.assert_allclose(log_z, j_log_z, rtol=1e-5)
  npt.assert_allclose(final, j_final, rtol=1e-5, atol=1e-6)
  npt.assert_allclose(hist.transpose(0, 1), j_hist, rtol=1e-5, atol=1e-6)
  # Any log Z: here the forward's plus a constant, as a block's global one.
  shift = np.float32(0.25)
  j_dw, j_dc, j_df, j_beta = jax_fused_scan.run_fused_backward(
      jwf, jcache, jnp.asarray(frames.numpy()), jnp.asarray(num_frames),
      j_log_z + shift, jnp.asarray(g), j_hist, beta0=jnp.asarray(beta0),
      **jkw)
  *grads, beta = fused_scan.fused_backward(
      pf, pc, head, is_pad, log_z + shift, torch.tensor(g), hist, slabs,
      beta0=torch.tensor(beta0), compute_dtype=torch.float32, **kw)
  d_wf, d_cache, d_frames = _port_weight_grads(wf, cache, frames, *grads)
  npt.assert_allclose(beta, j_beta, rtol=1e-5, atol=1e-6)
  _assert_seed_grads([d_cache, d_frames] + [d_wf[n] for n in j_dw],
                     [j_dc, j_df] + list(j_dw.values()))


def test_trigram_alpha0_chaining_matches_jax():
  """The JAX package's test_alpha0_chaining_matches_whole_sequence, on the
  port's trigram forward against JAX's kernel in interpret mode."""
  import jax.numpy as jnp
  from last_torch_tpu.ops import trigram_scan as jax_trigram

  vocab = 4
  jl, params, wf, cache, frames = _seeded_block_inputs(vocab, 2, 1, batch=2,
                                                       seed=2)
  num_frames = torch.tensor([8, 5])
  jkw = dict(max_expansions=1, frame_dependent=False, vocab=vocab,
             compute_dtype=jnp.float32, interpret=True)
  jwf, jcache = params['weight_fn'], jl.build_cache(params)
  jf = jnp.asarray(frames.numpy())
  nf0, nf1 = jnp.clip(jnp.asarray(num_frames), 0, 4), jnp.clip(
      jnp.asarray(num_frames) - 4, 0, 4)
  _, _, a_mid = jax_trigram.fused_shortest_distance_fwd(
      jwf, jcache, jf[:, :4], nf0, return_final_alpha=True,
      with_history=False, **jkw)
  j_log_z, _, j_final = jax_trigram.fused_shortest_distance_fwd(
      jwf, jcache, jf[:, 4:], nf1, alpha0=a_mid, return_final_alpha=True,
      with_history=False, **jkw)
  kw = dict(max_expansions=1, frame_dependent=False,
            compute_dtype=torch.float32)
  log_z, final, _ = _chain(trigram_scan.trigram_forward,
                           trigram_scan.trigram_backward, wf, cache, frames,
                           num_frames, 2, kw)
  npt.assert_allclose(log_z, j_log_z, rtol=1e-5)
  npt.assert_allclose(final, j_final, rtol=1e-5, atol=1e-6)


def test_trigram_beta_chaining_matches_jax():
  """The JAX package's test_backward_beta_chaining: two chained backward
  blocks (beta0) on the port against the same chain of JAX's kernels in
  interpret mode, and against one whole call."""
  import jax.numpy as jnp
  from last_torch_tpu.ops import trigram_scan as jax_trigram

  vocab = 4
  jl, params, wf, cache, frames = _seeded_block_inputs(vocab, 2, 1, batch=2,
                                                       max_t=6, seed=4)
  num_frames = torch.tensor([6, 4])
  jkw = dict(max_expansions=1, frame_dependent=False, vocab=vocab,
             compute_dtype=jnp.float32, interpret=True)
  jwf, jcache = params['weight_fn'], jl.build_cache(params)
  jf = jnp.asarray(frames.numpy())
  jn = jnp.asarray(num_frames)
  nf0, nf1 = jnp.clip(jn, 0, 3), jnp.clip(jn - 3, 0, 3)
  _, h0, a_mid = jax_trigram.fused_shortest_distance_fwd(
      jwf, jcache, jf[:, :3], nf0, return_final_alpha=True,
      history_layout='layout', **jkw)
  j_log_z, h1, _ = jax_trigram.fused_shortest_distance_fwd(
      jwf, jcache, jf[:, 3:], nf1, alpha0=a_mid, return_final_alpha=True,
      history_layout='layout', **jkw)
  g = torch.linspace(0.5, 1.5, 2)
  jg = jnp.asarray(g.numpy())
  d1w, d1c, d1f, beta_mid = jax_trigram.run_fused_backward(
      jwf, jcache, jf[:, 3:], nf1, j_log_z, jg, h1, **jkw)
  d0w, d0c, d0f, _ = jax_trigram.run_fused_backward(
      jwf, jcache, jf[:, :3], nf0, j_log_z, jg, h0, beta0=beta_mid, **jkw)
  kw = dict(max_expansions=1, frame_dependent=False,
            compute_dtype=torch.float32)
  _, _, outs = _chain(trigram_scan.trigram_forward,
                      trigram_scan.trigram_backward, wf, cache, frames,
                      num_frames, 2, kw)
  _, _, whole = _chain(trigram_scan.trigram_forward,
                       trigram_scan.trigram_backward, wf, cache, frames,
                       num_frames, 1, kw)
  for got, want in zip(outs, whole):
    npt.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
  d_wf, d_cache, d_frames = _port_weight_grads(wf, cache, frames, *outs[:-1])
  _assert_seed_grads(
      [d_cache, d_frames] + [d_wf[n] for n in d0w],
      [d0c + d1c, jnp.concatenate([d0f, d1f], axis=1)] +
      [d0w[n] + d1w[n] for n in d0w])


def test_time_sharded_example_trains_on_cpu_ranks():
  """``examples/train_time_sharded_torch.py --cpu``: 4 gloo ranks, the loss
  falls over its steps (the example raises otherwise)."""
  import subprocess
  import sys
  root = pathlib.Path(__file__).resolve().parent.parent
  out = subprocess.run(
      [sys.executable, str(root / 'examples' / 'train_time_sharded_torch.py'),
       '--cpu'], capture_output=True, text=True, timeout=SPAWN_SECONDS,
      cwd=root)
  assert out.returncode == 0, out.stderr[-2000:]
  assert 'converges on 4 ranks' in out.stdout
