"""The port's public interfaces, ``weight_fns.WeightFn``,
``weight_fns.WeightFnCacher`` and ``alignments.TimeSyncAlignmentLattice``,
against the JAX package's.

Each base refuses instantiation while an abstract method is left out
(``TypeError``), and every weight function, cacher and alignment of the
port is an instance of its base. A user weight function that defines only
``init`` / ``apply`` (delegating to ``JointWeightFn``, defined alike in both
packages) inherits ``label_weights`` returning None, so the numerator takes
the generic per-position route as in JAX: its ``loss`` and gradients,
``align`` and, on two gloo ranks spawned on the CPU, ``loss_time_sharded``
equal JAX's, over FullNGram(3, 1) with FrameDependent and over a bigram
with FrameLabelDependent(2). A user alignment that delegates to
FrameLabelDependent(2) gives JAX's ``loss`` and ``shortest_path``.

Same numpy inputs, JAX parameters converted with
``convert.from_jax_params``, float32 with matmul precision 'highest'.
Tolerances: values rtol 1e-5, gradients 1e-5 of the largest gradient,
decoded labels and emission frames exact. The top level of this file
imports no JAX, so the gloo ranks start without it; the JAX references are
computed in the test process.
"""

import datetime
import functools
import pathlib
import pickle
import time

import numpy as np
import numpy.testing as npt
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import last_torch_tpu_torch
from last_torch_tpu_torch import alignments, contexts, convert, weight_fns
from last_torch_tpu_torch.parallel import sequence

torch.set_num_threads(1)
torch.set_float32_matmul_precision('highest')

EMBEDDING, HIDDEN, FEATURES = 8, 16, 5
VALUE_RTOL, GRAD_SHARE = 1e-5, 1e-5
MAX_T = 8
NUM_FRAMES = np.array([8, 5, 2], np.int32)
LABELS = np.array([[1, 2, 1, 3], [3, 1, 0, 0], [2, 2, 2, 0]], np.int32)
# Row 2: three labels in two frames, infeasible under FrameDependent (+inf
# loss), feasible under FrameLabelDependent(2).
NUM_LABELS = np.array([4, 2, 3], np.int32)
# name: (vocab, max_expansions; None for FrameDependent).
CASES = {'fd_ngram3': (3, None), 'fld2_bigram5': (5, 2)}
COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=120)
SPAWN_SECONDS = 300


class UserWeightFn(weight_fns.WeightFn):
  """A user's weight function: ``init`` and ``apply`` only, over a
  ``JointWeightFn``."""

  def __init__(self, vocab_size, hidden_size):
    self.inner = weight_fns.JointWeightFn(vocab_size=vocab_size,
                                          hidden_size=hidden_size)

  def init(self, generator, cache, frame):
    return self.inner.init(generator, cache, frame)

  def apply(self, params, cache, frame, state=None):
    return self.inner.apply(params, cache, frame, state)


class UserAlignment(alignments.TimeSyncAlignmentLattice):
  """A user's alignment: every method delegates to FrameLabelDependent(2)."""

  def __init__(self):
    self.inner = alignments.FrameLabelDependent(2)

  def num_states(self):
    return self.inner.num_states()

  def start(self):
    return self.inner.start()

  def blank_next(self, state):
    return self.inner.blank_next(state)

  def lexical_next(self, state):
    return self.inner.lexical_next(state)

  def topological_visit(self):
    return self.inner.topological_visit()

  def forward(self, alpha, blank, lexical, context, semiring):
    return self.inner.forward(alpha, blank, lexical, context, semiring)

  def backward(self, alpha, blank, lexical, beta, log_z, context):
    return self.inner.backward(alpha, blank, lexical, beta, log_z, context)

  def string_forward(self, alpha, blank, lexical, semiring):
    return self.inner.string_forward(alpha, blank, lexical, semiring)


def port_alignment(max_expansions):
  if max_expansions is None:
    return alignments.FrameDependent()
  return alignments.FrameLabelDependent(max_expansions)


def port_lattice(case, weight_fn=UserWeightFn, alignment=None):
  vocab, max_expansions = CASES[case]
  return last_torch_tpu_torch.RecognitionLattice(
      context=contexts.FullNGram(vocab_size=vocab, context_size=1),
      alignment=alignment or port_alignment(max_expansions),
      weight_fn_cacher_factory=lambda ctx: weight_fns.SharedEmbCacher(
          num_context_states=ctx.shape()[0], embedding_size=EMBEDDING),
      weight_fn_factory=lambda ctx: weight_fn(ctx.shape()[1], HIDDEN))


@functools.cache
def jax_classes():
  """The JAX package's counterparts of the user classes above."""
  from last_torch_tpu import alignments as jax_alignments
  from last_torch_tpu import weight_fns as jax_weight_fns

  class JaxUserWeightFn(jax_weight_fns.WeightFn):

    def __init__(self, vocab_size, hidden_size):
      self.inner = jax_weight_fns.JointWeightFn(vocab_size=vocab_size,
                                                hidden_size=hidden_size)

    def init(self, key, cache, frame):
      return self.inner.init(key, cache, frame)

    def apply(self, params, cache, frame, state=None):
      return self.inner.apply(params, cache, frame, state)

  class JaxUserAlignment(jax_alignments.TimeSyncAlignmentLattice):

    def __init__(self):
      self.inner = jax_alignments.FrameLabelDependent(2)

    def num_states(self):
      return self.inner.num_states()

    def start(self):
      return self.inner.start()

    def blank_next(self, state):
      return self.inner.blank_next(state)

    def lexical_next(self, state):
      return self.inner.lexical_next(state)

    def topological_visit(self):
      return self.inner.topological_visit()

    def forward(self, alpha, blank, lexical, context, semiring):
      return self.inner.forward(alpha, blank, lexical, context, semiring)

    def backward(self, alpha, blank, lexical, beta, log_z, context):
      return self.inner.backward(alpha, blank, lexical, beta, log_z,
                                 context)

    def string_forward(self, alpha, blank, lexical, semiring):
      return self.inner.string_forward(alpha, blank, lexical, semiring)

  return JaxUserWeightFn, JaxUserAlignment


def jax_lattice(case, user_alignment=False):
  import last_torch_tpu
  from last_torch_tpu import alignments as jax_alignments
  from last_torch_tpu import contexts as jax_contexts
  from last_torch_tpu import weight_fns as jax_weight_fns
  user_weight_fn, user_align = jax_classes()
  vocab, max_expansions = CASES[case]
  if user_alignment:
    alignment = user_align()
  elif max_expansions is None:
    alignment = jax_alignments.FrameDependent()
  else:
    alignment = jax_alignments.FrameLabelDependent(max_expansions)
  return last_torch_tpu.RecognitionLattice(
      context=jax_contexts.FullNGram(vocab_size=vocab, context_size=1),
      alignment=alignment,
      weight_fn_cacher_factory=lambda ctx: jax_weight_fns.SharedEmbCacher(
          num_context_states=ctx.shape()[0], embedding_size=EMBEDDING),
      weight_fn_factory=lambda ctx: user_weight_fn(ctx.shape()[1], HIDDEN))


def frames_np(seed=1):
  return np.random.default_rng(seed).standard_normal(
      (len(NUM_FRAMES), MAX_T, FEATURES)).astype(np.float32)


def jax_params(lattice, seed=0):
  import jax
  params = lattice.init(jax.random.PRNGKey(seed), feature_size=FEATURES)
  return jax.tree.map(np.asarray, params)


def named(tree, prefix=''):
  """{'cacher/embedding': leaf, ...} of a tree of dicts."""
  if isinstance(tree, dict):
    out = {}
    for key, value in tree.items():
      out.update(named(value, f'{prefix}{key}/'))
    return out
  return {prefix[:-1]: tree}


def finite_total(losses):
  """The sum of the finite losses (an infeasible row's loss is +inf)."""
  return torch.where(torch.isfinite(losses), losses, 0.0).sum()


def jax_loss_and_grads(lattice, params, frames):
  import jax
  import jax.numpy as jnp

  def total(p):
    losses = lattice(p, jnp.asarray(frames), jnp.asarray(NUM_FRAMES),
                     jnp.asarray(LABELS), jnp.asarray(NUM_LABELS))
    return jnp.sum(jnp.where(jnp.isfinite(losses), losses, 0.0)), losses

  (_, losses), grads = jax.value_and_grad(total, has_aux=True)(params)
  return np.asarray(losses), {k: np.asarray(v)
                              for k, v in named(grads).items()}


def port_loss_and_grads(lattice, params, frames):
  params = convert.from_jax_params(params, device='cpu')
  leaves = named(params)
  for leaf in leaves.values():
    leaf.requires_grad_(True)
  losses = lattice.loss(params, torch.from_numpy(frames),
                        torch.from_numpy(NUM_FRAMES),
                        torch.from_numpy(LABELS),
                        torch.from_numpy(NUM_LABELS))
  finite_total(losses).backward()
  return losses.detach().numpy(), {k: v.grad.numpy()
                                   for k, v in leaves.items()}


def assert_grads(got, want):
  assert set(got) == set(want)
  scale = max(np.abs(w).max() for w in want.values())
  for name, w in want.items():
    assert np.abs(got[name] - w).max() <= GRAD_SHARE * scale, name


def assert_losses(got, want):
  npt.assert_array_equal(np.isfinite(got), np.isfinite(want))
  finite = np.isfinite(want)
  npt.assert_allclose(got[finite], want[finite], rtol=VALUE_RTOL)


# The interfaces themselves.


def _without(base, missing):
  """A subclass of ``base`` that defines every abstract method but
  ``missing``."""
  body = {name: (lambda self, *a, **k: None)
          for name in base.__abstractmethods__ if name != missing}
  return type(f'Without_{missing}', (base,), body)


ABSTRACT = [(base, name) for base in (weight_fns.WeightFn,
                                      weight_fns.WeightFnCacher,
                                      alignments.TimeSyncAlignmentLattice)
            for name in sorted(base.__abstractmethods__)]


def test_abstract_methods_are_jax_s():
  assert weight_fns.WeightFn.__abstractmethods__ == {'init', 'apply'}
  assert weight_fns.WeightFnCacher.__abstractmethods__ == {'init', 'apply'}
  assert alignments.TimeSyncAlignmentLattice.__abstractmethods__ == {
      'num_states', 'start', 'blank_next', 'lexical_next',
      'topological_visit', 'forward', 'backward', 'string_forward'}


@pytest.mark.parametrize('base,missing', ABSTRACT,
                         ids=[f'{b.__name__}-{m}' for b, m in ABSTRACT])
def test_base_refuses_a_missing_abstract_method(base, missing):
  with pytest.raises(TypeError):
    _without(base, missing)()
  _without(base, None)()  # every method defined: instantiates
  with pytest.raises(TypeError):
    base()


@pytest.mark.parametrize('instance,base', [
    (weight_fns.JointWeightFn(4, 8), weight_fns.WeightFn),
    (weight_fns.LocallyNormalizedWeightFn(weight_fns.JointWeightFn(4, 8)),
     weight_fns.WeightFn),
    (weight_fns.TableWeightFn(np.zeros((2, 3, 5), np.float32)),
     weight_fns.WeightFn),
    (weight_fns.SharedEmbCacher(3, 4), weight_fns.WeightFnCacher),
    (weight_fns.SharedRNNCacher(2, 1, 4, 3), weight_fns.WeightFnCacher),
    (weight_fns.NullCacher(), weight_fns.WeightFnCacher),
    (alignments.FrameDependent(), alignments.TimeSyncAlignmentLattice),
    (alignments.FrameLabelDependent(2), alignments.TimeSyncAlignmentLattice),
], ids=lambda x: type(x).__name__)
def test_port_classes_subclass_their_base(instance, base):
  assert isinstance(instance, base)


def test_call_forwards_to_apply_and_label_weights_defaults_to_none():
  gen = torch.Generator().manual_seed(0)
  cacher = weight_fns.SharedEmbCacher(4, EMBEDDING)
  cacher_params = cacher.init(gen, device='cpu')
  cache = cacher(cacher_params)
  assert torch.equal(cache, cacher.apply(cacher_params))
  wf = UserWeightFn(3, HIDDEN)
  frame = torch.randn(2, FEATURES, generator=gen)
  params = wf.init(gen, cache, frame)
  for got, want in zip(wf(params, cache, frame),
                       wf.apply(params, cache, frame)):
    assert torch.equal(got, want)
  state = torch.tensor([1, 3])
  for got, want in zip(wf(params, cache, frame, state),
                       wf.inner.apply(params, cache, frame, state)):
    assert torch.equal(got, want)
  assert wf.label_weights(params, cache, frame[:, None], state[:, None],
                          state[:, None]) is None


# A user weight function through the lattice.


@pytest.mark.parametrize('case', list(CASES))
def test_user_weight_fn_loss_and_grads_match_jax(case):
  """Fails with AttributeError where the port has no ``WeightFn`` base."""
  jl, pl = jax_lattice(case), port_lattice(case)
  params, frames = jax_params(jl), frames_np()
  want, want_grads = jax_loss_and_grads(jl, params, frames)
  got, got_grads = port_loss_and_grads(pl, params, frames)
  assert_losses(got, want)
  assert_grads(got_grads, want_grads)
  # The JointWeightFn lattice (its label_weights) on the same parameters.
  fast, fast_grads = port_loss_and_grads(
      port_lattice(case, weight_fn=weight_fns.JointWeightFn), params, frames)
  assert_losses(got, fast)
  assert_grads(got_grads, fast_grads)


@pytest.mark.parametrize('case', list(CASES))
def test_user_weight_fn_align_matches_jax(case):
  import jax
  import jax.numpy as jnp
  jl, pl = jax_lattice(case), port_lattice(case)
  params, frames = jax_params(jl), frames_np()
  # JAX's align indexes the cache with traced states: jnp parameters.
  emit_j, scores_j = (np.asarray(x) for x in jl.align(
      jax.tree.map(jnp.asarray, params), jnp.asarray(frames), jnp.asarray(NUM_FRAMES),
      jnp.asarray(LABELS), jnp.asarray(NUM_LABELS)))
  emit, scores = pl.align(convert.from_jax_params(params, device='cpu'),
                          torch.from_numpy(frames),
                          torch.from_numpy(NUM_FRAMES),
                          torch.from_numpy(LABELS),
                          torch.from_numpy(NUM_LABELS))
  scores = scores.numpy()
  assert_losses(scores, scores_j)
  feasible = np.isfinite(scores_j)
  npt.assert_array_equal(emit.numpy()[feasible], emit_j[feasible])


def test_user_alignment_loss_and_shortest_path_match_jax():
  """A user alignment takes the generic routes (outside the kernels'
  FrameDependent / FrameLabelDependent gates) in both packages."""
  import jax.numpy as jnp
  case = 'fld2_bigram5'
  jl = jax_lattice(case, user_alignment=True)
  pl = port_lattice(case, alignment=UserAlignment())
  params, frames = jax_params(jl), frames_np()
  want, want_grads = jax_loss_and_grads(jl, params, frames)
  got, got_grads = port_loss_and_grads(pl, params, frames)
  assert_losses(got, want)
  assert_grads(got_grads, want_grads)
  labels_j, num_j, weights_j = (np.asarray(x) for x in jl.shortest_path(
      params, jnp.asarray(frames), jnp.asarray(NUM_FRAMES)))
  labels, num, weights = pl.shortest_path(
      convert.from_jax_params(params, device='cpu'),
      torch.from_numpy(frames), torch.from_numpy(NUM_FRAMES))
  assert pl.last_path == 'generic'
  npt.assert_array_equal(labels.numpy(), labels_j)
  npt.assert_array_equal(num.numpy(), num_j)
  npt.assert_allclose(weights.numpy(), weights_j, rtol=VALUE_RTOL)


# loss_time_sharded on gloo ranks: rank function at module level, no JAX.


def _rank_main(rank, world, workdir):
  """One rank of the ('seq',) mesh: each case's time-sharded loss and its
  partial gradients to ``<case>.<rank>.pkl``."""
  from torch.distributed.device_mesh import init_device_mesh
  torch.set_num_threads(1)
  torch.set_float32_matmul_precision('highest')
  workdir = pathlib.Path(workdir)
  dist.init_process_group('gloo', init_method=f'file://{workdir}/store',
                          rank=rank, world_size=world,
                          timeout=COLLECTIVE_TIMEOUT)
  try:
    mesh = init_device_mesh('cpu', (world,), mesh_dim_names=('seq',))
    stored = pickle.loads((workdir / 'params.pkl').read_bytes())
    for case in CASES:
      params = convert.from_jax_params(stored[case], device='cpu')
      leaves = named(params)
      for leaf in leaves.values():
        leaf.requires_grad_(True)
      losses = sequence.loss_time_sharded(
          port_lattice(case), params, torch.from_numpy(frames_np()),
          torch.from_numpy(NUM_FRAMES), torch.from_numpy(LABELS),
          torch.from_numpy(NUM_LABELS), mesh, 'seq')
      finite_total(losses).backward()
      out = {'losses': losses.detach().numpy(),
             'grads': {k: v.grad.numpy() for k, v in leaves.items()}}
      (workdir / f'{case}.{rank}.pkl').write_bytes(pickle.dumps(out))
  finally:
    dist.destroy_process_group()


def test_user_weight_fn_time_sharded_loss_matches_jax(tmp_path):
  world = 2
  lattices_j = {case: jax_lattice(case) for case in CASES}
  stored = {case: jax_params(lat) for case, lat in lattices_j.items()}
  (tmp_path / 'params.pkl').write_bytes(pickle.dumps(stored))
  ranks = mp.spawn(_rank_main, args=(world, str(tmp_path)), nprocs=world,
                   join=False)
  frames = frames_np()
  refs = {case: jax_loss_and_grads(lat, stored[case], frames)
          for case, lat in lattices_j.items()}
  deadline = time.monotonic() + SPAWN_SECONDS
  while not ranks.join(timeout=1):
    if time.monotonic() > deadline:
      for process in ranks.processes:
        process.kill()
      pytest.fail(f'{world} ranks did not finish in {SPAWN_SECONDS} s')
  for case, (want, want_grads) in refs.items():
    outs = [pickle.loads((tmp_path / f'{case}.{r}.pkl').read_bytes())
            for r in range(world)]
    # Each rank's gradients are its block's part: the sum is the whole.
    grads = {k: sum(o['grads'][k] for o in outs) for k in want_grads}
    for out in outs:
      assert_losses(out['losses'], want)
    assert_grads(grads, want_grads)
