# Copyright 2026.
#
# Licensed under the Apache License, Version 2.0 (the "License");
# you may not use this file except in compliance with the License.
# You may obtain a copy of the License at
#
#     http://www.apache.org/licenses/LICENSE-2.0
#
# Unless required by applicable law or agreed to in writing, software
# distributed under the License is distributed on an "AS IS" BASIS,
# WITHOUT WARRANTIES OR CONDITIONS OF ANY KIND, either express or implied.
# See the License for the specific language governing permissions and
# limitations under the License.

"""GNAT speech transducer: encoder + recognition lattice, PyTorch port.

Counterpart of ``last_torch_tpu/models/gnat.py``: ``GNATConfig``,
``GNATModel`` (``init``, ``loss``, ``mean_loss``, ``decode``), the optimizer
(``make_optimizer``: AdamW with global-norm clipping and the
warmup/cosine schedule), the training step (``GNATTrainState``,
``init_train_state``, ``train_step``) and the expected-risk (MWER)
fine-tuning step (``risk_train_step``). ``make_optimizer(accumulate_steps=k)``
averages gradients over k micro-steps before one update, as
``optax.MultiSteps`` does in the JAX package.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch
from torch.utils import _pytree as pytree

from last_torch_tpu_torch import alignments
from last_torch_tpu_torch import contexts
from last_torch_tpu_torch import lattices
from last_torch_tpu_torch import weight_fns
from last_torch_tpu_torch.models import encoder as encoder_lib
from last_torch_tpu_torch.utils import profiling

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class GNATConfig:
  """Configuration for a GNAT speech transducer (same fields and defaults as
  ``last_torch_tpu.models.gnat.GNATConfig``).

  Attributes:
    feature_size: Input acoustic feature dimension.
    vocab_size: Lexical output vocabulary size (excluding blank).
    context_size: FullNGram context order (1 = bigram label history, 2 =
      trigram).
    encoder_size: Transformer encoder width.
    encoder_layers: Number of encoder blocks.
    encoder_heads: Attention heads.
    encoder_ffn_size: Encoder feed-forward width.
    hidden_size: Joint network hidden size.
    embedding_size: Context embedding size.
    max_expansions: If > 0, FrameLabelDependent with this k; otherwise
      FrameDependent.
    locally_normalized: Locally normalized vs globally normalized.
    use_rnn_cacher: SharedRNNCacher instead of SharedEmbCacher.
    encoder_causal: Causal encoder attention.
    encoder_window: With encoder_causal, the left-context window (frames).
    encoder_conv_kernel: If > 0, Conformer blocks with this conv width.
    encoder_kind: 'transformer' (``TransformerEncoder``, the JAX package's
      encoder) or 'conformer' (``ConformerEncoder``: Conformer (L)'s
      stride-4 front end and relative-position blocks, non-causal; the
      port's own, not in the JAX package).
  """

  feature_size: int = 80
  vocab_size: int = 1024
  context_size: int = 1
  encoder_size: int = 256
  encoder_layers: int = 4
  encoder_heads: int = 4
  encoder_ffn_size: int = 1024
  hidden_size: int = 512
  embedding_size: int = 512
  max_expansions: int = 2
  locally_normalized: bool = False
  use_rnn_cacher: bool = False
  encoder_causal: bool = False
  encoder_window: int = 0
  encoder_conv_kernel: int = 0
  encoder_kind: str = 'transformer'


def _make_encoder(config: GNATConfig):
  """The encoder ``config.encoder_kind`` names, at the config's widths."""
  if config.encoder_kind == 'conformer':
    if config.encoder_causal or config.encoder_window:
      raise ValueError('the Conformer encoder is non-causal: '
                       'encoder_causal and encoder_window must be unset')
    return encoder_lib.ConformerEncoder(
        feature_size=config.feature_size,
        model_size=config.encoder_size,
        num_layers=config.encoder_layers,
        num_heads=config.encoder_heads,
        ffn_size=config.encoder_ffn_size,
        conv_kernel=config.encoder_conv_kernel)
  if config.encoder_kind != 'transformer':
    raise ValueError(f'encoder_kind {config.encoder_kind!r}: expected '
                     "'transformer' or 'conformer'")
  return encoder_lib.TransformerEncoder(
      feature_size=config.feature_size,
      model_size=config.encoder_size,
      num_layers=config.encoder_layers,
      num_heads=config.encoder_heads,
      ffn_size=config.encoder_ffn_size,
      causal=config.encoder_causal,
      window=config.encoder_window,
      conv_kernel=config.encoder_conv_kernel)


class GNATModel:
  """A complete GNAT speech transducer on one device.

  Attributes:
    config: GNATConfig.
    device: Where ``init`` puts the parameters and ``decode`` / ``loss``
      run: the card ('cuda', the default) unless the caller asks for 'cpu'.
    encoder: TransformerEncoder or ConformerEncoder (``encoder_kind``).
    lattice: RecognitionLattice over the encoder outputs.
  """

  def __init__(self, config: GNATConfig, device='cuda'):
    self.device = torch.device(device)
    if self.device.type == 'cuda' and not torch.cuda.is_available():
      raise RuntimeError(f'GNATModel on {device}: no CUDA device is '
                         'available (pass device=\'cpu\' to run on the CPU)')
    self.config = config
    self.encoder = _make_encoder(config)

    context = contexts.FullNGram(
        vocab_size=config.vocab_size, context_size=config.context_size)
    if config.max_expansions > 0:
      alignment = alignments.FrameLabelDependent(
          max_expansions=config.max_expansions)
    else:
      alignment = alignments.FrameDependent()

    def cacher_factory(ctx):
      if config.use_rnn_cacher:
        return weight_fns.SharedRNNCacher(
            vocab_size=ctx.vocab_size, context_size=ctx.context_size,
            rnn_size=config.embedding_size,
            rnn_embedding_size=config.embedding_size)
      return weight_fns.SharedEmbCacher(num_context_states=ctx.shape()[0],
                                        embedding_size=config.embedding_size)

    def weight_fn_factory(ctx):
      joint = weight_fns.JointWeightFn(vocab_size=ctx.shape()[1],
                                       hidden_size=config.hidden_size)
      if config.locally_normalized:
        return weight_fns.LocallyNormalizedWeightFn(joint)
      return joint

    self.lattice = lattices.RecognitionLattice(
        context=context,
        alignment=alignment,
        weight_fn_cacher_factory=cacher_factory,
        weight_fn_factory=weight_fn_factory)

  def init(self, generator: torch.Generator) -> Params:
    """Random parameters on ``self.device``, drawn from ``generator``."""
    return {
        'encoder': self.encoder.init(generator, self.device),
        'lattice': self.lattice.init(
            generator, feature_size=self.config.encoder_size,
            device=self.device),
    }

  def loss(self, params: Params, frames, num_frames, labels,
           num_labels) -> torch.Tensor:
    """Per-sequence negative log-probability loss.

    Args:
      params: Parameters from ``init`` (or ``convert.from_jax_params``).
      frames: [batch, max_num_frames, feature_size] acoustic features.
      num_frames: [batch] frame counts.
      labels: [batch, max_num_labels] label sequences (1..vocab_size).
      num_labels: [batch] label counts.

    Returns:
      [batch] loss values (+inf for infeasible label sequences).
    """
    frames = torch.as_tensor(frames, dtype=torch.float32, device=self.device)
    num_frames = torch.as_tensor(num_frames, device=self.device)
    encoded = self.encoder.apply(params['encoder'], frames, num_frames)
    return self.lattice(
        params['lattice'], frames=encoded,
        num_frames=self.encoder.output_frames(num_frames),
        labels=torch.as_tensor(labels, device=self.device),
        num_labels=torch.as_tensor(num_labels, device=self.device))

  def mean_loss(self, params: Params, frames, num_frames, labels,
                num_labels) -> torch.Tensor:
    """Scalar mean loss over the feasible sequences of a batch.

    Infeasible sequences (+inf loss) count as 0 and get a zero cotangent.
    """
    per_seq = self.loss(params, frames, num_frames, labels, num_labels)
    finite = torch.isfinite(per_seq)
    per_seq = torch.where(finite, per_seq, 0.0)
    return per_seq.sum() / finite.sum().clamp(min=1)

  @torch.no_grad()
  def decode(self, params: Params, frames, num_frames):
    """Viterbi-decodes the highest scoring alignment: through the Viterbi
    kernel for a bigram context, through the lattice's generic route
    (``RecognitionLattice.shortest_path``) for a trigram one, as in the JAX
    package.

    Args:
      params: Parameters from ``init`` (or ``convert.from_jax_params``).
      frames: [batch, max_num_frames, feature_size] acoustic features.
      num_frames: [batch] frame counts.

    Returns:
      (alignment_labels, num_alignment_labels, path_weights); see
      ``RecognitionLattice.shortest_path``.
    """
    with profiling.span('gnat.decode'):
      frames = torch.as_tensor(frames, dtype=torch.float32,
                               device=self.device)
      num_frames = torch.as_tensor(num_frames, device=self.device)
      encoded = self.encoder.apply(params['encoder'], frames, num_frames)
      return self.lattice.shortest_path(
          params['lattice'], frames=encoded,
          num_frames=self.encoder.output_frames(num_frames))


@dataclasses.dataclass
class OptState:
  """The optimizer's state: torch's AdamW over the parameter leaves, the
  learning-rate schedule that steps with it (its ``last_epoch`` counts the
  updates), and, when gradients accumulate, their running mean over the
  micro-steps since the last update (``acc``, one tensor a leaf) and the
  count of those micro-steps."""
  adamw: torch.optim.AdamW
  schedule: torch.optim.lr_scheduler.LambdaLR
  acc: Optional[list[torch.Tensor]] = None
  mini_step: int = 0


@dataclasses.dataclass(frozen=True)
class Optimizer:
  """AdamW with global-norm clipping (built by ``make_optimizer``).

  The counterpart of the JAX package's optax chain
  ``clip_by_global_norm(clip_norm)`` + ``adamw(schedule, weight_decay)``:
  betas (0.9, 0.999), eps 1e-8, decoupled weight decay on every leaf.
  torch's ``clip_grad_norm_`` divides by ``norm + 1e-6`` where optax
  divides by ``norm``, so clipped updates differ by that relative 1e-6 /
  norm. With ``accumulate_steps`` k > 1 it is ``optax.MultiSteps`` over that
  chain: each micro-step's gradients join a running mean (optax's
  ``acc + (g - acc) / (n + 1)``), and every k-th micro-step the chain runs
  once on the mean; the parameters stay put in between, and the schedule
  and AdamW's step count advance per update.
  """
  learning_rate: float
  weight_decay: float
  clip_norm: float
  warmup_steps: int
  total_steps: int
  accumulate_steps: int = 1

  def rate_factor(self, count: int) -> float:
    """The learning rate before update ``count`` (0-based), relative to
    ``learning_rate``: optax's linear warmup then cosine decay."""
    if self.warmup_steps <= 0:
      return 1.0
    if count < self.warmup_steps or not self.total_steps:
      return min(count, self.warmup_steps) / self.warmup_steps
    decay_steps = self.total_steps - self.warmup_steps
    done = min(count - self.warmup_steps, decay_steps)
    return 0.5 * (1.0 + math.cos(math.pi * done / decay_steps))

  def init(self, params: Params) -> OptState:
    """The state for ``params``, whose leaves it updates in place."""
    leaves = pytree.tree_leaves(params)
    adamw = torch.optim.AdamW(
        leaves, lr=self.learning_rate, betas=(0.9, 0.999), eps=1e-8,
        weight_decay=self.weight_decay)
    schedule = torch.optim.lr_scheduler.LambdaLR(adamw, self.rate_factor)
    acc = None
    if self.accumulate_steps > 1:
      acc = [torch.zeros_like(leaf, requires_grad=False) for leaf in leaves]
    return OptState(adamw, schedule, acc)

  def apply_gradients(self, opt_state: OptState,
                      total_norm=None) -> bool:
    """Clips the leaves' ``.grad`` to ``clip_norm`` in global norm and takes
    one AdamW step on them; the schedule advances by one update. With
    accumulation, the gradients join the running mean first, and the update
    runs on the mean at every ``accumulate_steps``-th call only.

    ``total_norm``: when the leaves hold only part of the gradients (a
    vocab shard of a tensor-parallel step), a function of no arguments that
    computes the global norm from the leaves' ``.grad`` (the mean, once
    accumulated); the leaves' own norm by default. The clip is
    ``clip_grad_norm_``'s either way.

    Returns:
      Whether the parameters were updated.
    """
    leaves = [p for group in opt_state.adamw.param_groups
              for p in group['params']]
    if opt_state.acc is not None:
      n = opt_state.mini_step
      with torch.no_grad():
        for acc, leaf in zip(opt_state.acc, leaves):
          if leaf.grad is not None:
            acc.add_((leaf.grad - acc) / (n + 1))
          else:
            acc.sub_(acc / (n + 1))
      opt_state.mini_step = n + 1
      if opt_state.mini_step < self.accumulate_steps:
        return False
      for acc, leaf in zip(opt_state.acc, leaves):
        leaf.grad = acc.clone()
        acc.zero_()
      opt_state.mini_step = 0
    if total_norm is None:
      torch.nn.utils.clip_grad_norm_(leaves, self.clip_norm)
    else:
      coef = torch.clamp(self.clip_norm / (total_norm() + 1e-6), max=1.0)
      for leaf in leaves:
        leaf.grad.mul_(coef)
    opt_state.adamw.step()
    opt_state.schedule.step()
    return True


def make_optimizer(learning_rate: float = 1e-3,
                   weight_decay: float = 1e-4,
                   clip_norm: float = 5.0,
                   accumulate_steps: int = 1,
                   warmup_steps: int = 0,
                   total_steps: int = 0) -> Optimizer:
  """AdamW with global-norm clipping; the standard transducer recipe.

  ``warmup_steps > 0`` switches the constant learning rate to the standard
  transducer schedule: linear warmup from 0 to ``learning_rate`` over
  ``warmup_steps``, then cosine decay to zero at ``total_steps`` (constant
  after warmup when ``total_steps`` is 0).

  ``accumulate_steps > 1`` averages the gradients of that many micro-batches
  before one parameter update (``optax.MultiSteps`` semantics): the way to
  train at effective batch sizes whose lattice activations do not fit one
  card. The schedule advances per update, not per micro-batch.
  """
  if warmup_steps > 0 and 0 < total_steps <= warmup_steps:
    raise ValueError(
        f'total_steps={total_steps} must exceed warmup_steps='
        f'{warmup_steps} (or be 0 for constant-after-warmup)')
  return Optimizer(learning_rate, weight_decay, clip_norm, warmup_steps,
                   total_steps, max(accumulate_steps, 1))


@dataclasses.dataclass
class GNATTrainState:
  """Training state: parameters + optimizer state + step counter.

  Unlike the JAX package's immutable state, ``train_step`` updates the
  parameter tensors in place (the optimizer holds them). ``shard`` is
  (index, count) of this rank's shard on the model axis in a sharded state
  (``parallel.sharding.make_tp_train_step`` / ``make_sharded_train_step``),
  None for a whole one.
  """
  params: Params
  opt_state: OptState
  step: int
  shard: Optional[tuple[int, int]] = None


def init_train_state(model: GNATModel, generator: torch.Generator,
                     optimizer: Optimizer) -> GNATTrainState:
  """Random parameters from ``generator``, as leaves that record gradients,
  with a fresh optimizer state."""
  params = model.init(generator)
  for leaf in pytree.tree_leaves(params):
    leaf.requires_grad_(True)
  return GNATTrainState(params=params, opt_state=optimizer.init(params),
                        step=0)


def train_step(model: GNATModel, optimizer: Optimizer,
               state: GNATTrainState, frames, num_frames, labels,
               num_labels) -> tuple[GNATTrainState, torch.Tensor]:
  """One training step; returns (new_state, mean loss before the update)."""
  state.opt_state.adamw.zero_grad(set_to_none=True)
  loss = model.mean_loss(state.params, frames, num_frames, labels,
                         num_labels)
  loss.backward()
  optimizer.apply_gradients(state.opt_state)
  return dataclasses.replace(state, step=state.step + 1), loss.detach()


def risk_train_step(model: GNATModel, optimizer: Optimizer,
                    state: GNATTrainState, frames, num_frames, labels,
                    num_labels, generator,
                    num_samples: int = 4,
                    estimator: str = 'mwer',
                    nll_weight: float = 0.0,
                    per_example_keys: bool = False
                    ) -> tuple[GNATTrainState, dict]:
  """One expected-risk (MWER) fine-tuning step.

  Minimizes the expected edit distance over exact posterior path samples
  (``risk.sampled_risk_loss``), optionally plus ``nll_weight`` times the
  mean likelihood loss over the feasible sequences (the usual MWER recipe
  keeps a small NLL term). The encoder runs once, and the weight function
  cache is built once and shared by both terms. Then the AdamW update.

  Args:
    model: The GNAT model.
    optimizer: ``make_optimizer``'s AdamW.
    state: Current train state (its parameters update in place).
    frames, num_frames, labels, num_labels: The batch.
    generator: The sampler's randomness, in place of the JAX package's key:
      a ``torch.Generator`` on the model's device (draw from a fresh one,
      or one that has moved on, each step).
    num_samples: Posterior samples per utterance.
    estimator: ``'mwer'`` or ``'reinforce'`` (see ``risk``).
    nll_weight: Weight of the added mean likelihood loss (0 disables it).
    per_example_keys: One generator per batch row
      (``risk.per_example_keys``), so that the samples do not depend on how
      the batch is split: the single-device reference of
      ``parallel.sharding.make_shard_map_risk_train_step``.

  Returns:
    (new_state, metrics): ``loss`` (the optimized scalar), ``mean_risk``
    (the Monte Carlo expected edit distance) and, when ``nll_weight`` is
    set, ``nll``, each a detached scalar tensor from before the update.
  """
  # Imported here: ``risk`` imports ``models.metrics``, so a top-level
  # import would run during this package's own initialization.
  from last_torch_tpu_torch import risk as risk_lib

  device = model.device
  frames = torch.as_tensor(frames, dtype=torch.float32, device=device)
  num_frames = torch.as_tensor(num_frames, device=device)
  labels = torch.as_tensor(labels, device=device)
  num_labels = torch.as_tensor(num_labels, device=device)
  params = state.params
  state.opt_state.adamw.zero_grad(set_to_none=True)
  encoded = model.encoder.apply(params['encoder'], frames, num_frames)
  num_frames = model.encoder.output_frames(num_frames)
  cache = model.lattice.build_cache(params['lattice'])
  kw = dict(num_samples=num_samples, estimator=estimator, cache=cache)
  if per_example_keys:
    row_keys = risk_lib.per_example_keys(generator, num_frames.shape[0])
    er, aux = risk_lib.sampled_risk_loss_per_example(
        model.lattice, params['lattice'], encoded, num_frames, labels,
        num_labels, row_keys, **kw)
  else:
    er, aux = risk_lib.sampled_risk_loss(
        model.lattice, params['lattice'], encoded, num_frames, labels,
        num_labels, generator, **kw)
  metrics = {'mean_risk': aux['mean_risk'].mean().detach()}
  total = er.mean()
  if nll_weight:
    per_seq = model.lattice(params['lattice'], frames=encoded,
                            num_frames=num_frames, labels=labels,
                            num_labels=num_labels, cache=cache)
    finite = torch.isfinite(per_seq)
    nll = (torch.where(finite, per_seq, 0.0).sum() /
           finite.sum().clamp(min=1))
    metrics['nll'] = nll.detach()
    total = total + nll_weight * nll
  total.backward()
  optimizer.apply_gradients(state.opt_state)
  return (dataclasses.replace(state, step=state.step + 1),
          dict(metrics, loss=total.detach()))
