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

"""Expected-risk (MWER-style) training over sampled alignment paths,
PyTorch port.

Counterpart of ``last_torch_tpu/risk.py``. Sequence-level discriminative
fine-tuning minimizes the expected task risk
``E_{path ~ p(.|x)}[risk(labels(path), reference)]``, for speech the label
edit distance:

* ``RecognitionLattice.sample_paths`` draws exact i.i.d. posterior
  alignment paths with exact log-probabilities (FFBS), so the estimators
  need no n-best search;
* ``models.metrics.edit_distance`` scores each sampled label sequence
  against the reference.

Two gradient estimators over the sampled log-posteriors
``log p_i = w(path_i) - log Z`` (differentiable through the arc weights of
the paths; both estimators are blind to log Z, a shift shared by a row's
samples, so the loss takes it as a constant where the JAX package
differentiates through it to an exact zero):

* ``'mwer'``: ``w_hat = softmax_i(log p_i)`` over the sample set and the
  loss ``sum_i w_hat_i (risk_i - rbar) + rbar`` with the baseline
  ``rbar = sum_i w_hat_i.detach() risk_i``, the n-best MWER objective with
  the beam replaced by exact samples. Its value converges to the
  posterior-tilted risk ``E[p r] / E[p]`` and its fixed-sample gradient to
  half that objective's gradient (the JAX package's module docstring).
* ``'reinforce'``: the unbiased score-function estimator
  ``mean_i (risk_i - b_i) grad log p_i`` with a leave-one-out mean baseline.

Randomness: the JAX package's keys become ``torch.Generator`` objects.
``per_example_keys`` gives each batch row a generator of its own, seeded
from ``(seed, global row)`` alone, so a data-parallel split of the batch
draws the rows' samples exactly as one device does.
"""

from __future__ import annotations

from collections.abc import Callable, Sequence
from typing import Any, Optional

import torch

from last_torch_tpu_torch.models import metrics

# risk_fn(hyp, num_hyp, ref, num_ref) -> [batch..., num_samples] risks.
RiskFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor],
                  torch.Tensor]

_MASK64 = (1 << 64) - 1


def labels_from_alignment(alignment_labels, max_labels: Optional[int] = None
                          ) -> tuple[torch.Tensor, torch.Tensor]:
  """Extracts emitted label sequences from packed alignment paths.

  Args:
    alignment_labels: [..., num_slots] packed alignment labels in the
      ``shortest_path`` / ``sample_paths`` slot format (0 = blank/unused,
      1..V = lexical).
    max_labels: Optional output length cap, ``num_slots`` by default. A
      path that emits more is truncated (its count clamped too).

  Returns:
    (labels [..., max_labels] int32, left-justified emitted labels,
    0-padded; num_labels [...] int32).
  """
  alignment_labels = torch.as_tensor(alignment_labels)
  emitted = alignment_labels > 0
  # A stable sort of "is padding" left-justifies the emitted labels in
  # order.
  order = torch.sort((~emitted).to(torch.int8), dim=-1, stable=True).indices
  labels = torch.gather(alignment_labels, -1, order)
  num = emitted.sum(dim=-1).to(torch.int32)
  if max_labels is not None and max_labels < labels.shape[-1]:
    labels = labels[..., :max_labels]
    num = num.clamp(max=max_labels)
  return labels.to(torch.int32), num


def edit_distance_risk(hyp, num_hyp, ref, num_ref) -> torch.Tensor:
  """Default risk: raw label edit distance (MWER's "number of errors")."""
  return metrics.edit_distance(hyp, num_hyp, ref, num_ref).float()


def sampled_risk_loss(lattice, params: Any, frames: torch.Tensor,
                      num_frames, labels, num_labels, generator,
                      num_samples: int = 4, estimator: str = 'mwer',
                      risk_fn: RiskFn = edit_distance_risk,
                      max_hyp_labels: Optional[int] = None,
                      cache: Any = None) -> tuple[torch.Tensor, dict]:
  """Expected-risk loss over exact posterior path samples.

  Args:
    lattice: A ``RecognitionLattice``.
    params: Parameters from ``lattice.init``.
    frames: [batch_dims..., max_num_frames, feature_size] padded frames.
    num_frames: [batch_dims...] frame counts.
    labels: [batch_dims..., max_num_labels] reference transcripts.
    num_labels: [batch_dims...] reference label counts.
    generator: Source of the sampler's randomness: a ``torch.Generator``
      on the frames' device, or one per batch row (``per_example_keys``).
    num_samples: Samples per utterance (at least 2).
    estimator: ``'mwer'`` or ``'reinforce'`` (module docstring).
    risk_fn: Maps (hyp, num_hyp, ref, num_ref) to [batch..., num_samples]
      risks; raw label edit distance by default. Not differentiated.
    max_hyp_labels: Optional cap on the extracted hypothesis length.
    cache: Optional weight function cache.

  Returns:
    (loss [batch_dims...], the differentiable per-utterance expected risk;
    aux: ``risk`` [batch..., num_samples], ``log_prob``, ``mean_risk`` (the
    plain Monte Carlo mean risk), ``hyp_labels``, ``num_hyp_labels``).
  """
  if estimator not in ('mwer', 'reinforce'):
    raise ValueError(f"estimator must be 'mwer' or 'reinforce', "
                     f'got {estimator!r}')
  if num_samples < 2:
    # Both estimators are gradient-free at one sample: REINFORCE has no
    # leave-one-out baseline, and MWER's single softmax weight is the
    # constant 1 with a zero advantage.
    raise ValueError(
        f'num_samples must be >= 2 for a usable gradient (got '
        f'{num_samples}); with one sample the {estimator!r} estimator '
        'has zero gradient')
  # Both estimators see a row's log-probabilities only up to a shift: the
  # softmax ignores one, and the leave-one-out advantages sum to 0. log Z,
  # one value a row, then has an exactly zero gradient, so the sampler's
  # beta pass runs without autograd.
  align_labels, _, log_prob = lattice._sample_paths(
      params, frames, num_frames, generator, num_samples, cache,
      log_z_grad=False)
  hyp, num_hyp = labels_from_alignment(align_labels, max_hyp_labels)
  device = hyp.device
  ref = torch.as_tensor(labels, device=device).to(torch.int32)[..., None, :]
  num_ref = torch.as_tensor(num_labels, device=device).to(torch.int32)[
      ..., None]
  risk = risk_fn(hyp, num_hyp, ref.expand(hyp.shape[:-1] + ref.shape[-1:]),
                 num_ref.expand(hyp.shape[:-1]))
  risk = torch.as_tensor(risk, device=device).float().detach()
  m = num_samples
  if estimator == 'mwer':
    w_hat = torch.softmax(log_prob, dim=-1)
    rbar = (w_hat.detach() * risk).sum(dim=-1)
    # sum_i w_hat_i = 1: adding back the detached baseline keeps the value
    # the softmax-weighted risk, the gradient that of (risk - rbar).
    loss = (w_hat * (risk - rbar[..., None])).sum(dim=-1) + rbar
  else:
    # Leave-one-out baseline: b_i = mean of the other samples' risks.
    baseline = (risk.sum(dim=-1, keepdim=True) - risk) / (m - 1)
    score = log_prob - log_prob.detach()
    # The value is the plain Monte Carlo mean risk; the second term is 0 in
    # value and carries the score-function gradient.
    loss = risk.mean(dim=-1) + ((risk - baseline) * score).mean(dim=-1)
  aux = {
      'risk': risk,
      'log_prob': log_prob,
      'mean_risk': risk.mean(dim=-1),
      'hyp_labels': hyp,
      'num_hyp_labels': num_hyp,
  }
  return loss, aux


def row_seed(seed: int, row: int) -> int:
  """The seed of batch row ``row``'s generator: a SplitMix64 finalizer of
  ``seed + (row + 1) * 0x9E3779B97F4A7C15`` (mod 2**64). Equal inputs give
  equal seeds on every machine and rank."""
  z = (seed + (row + 1) * 0x9E3779B97F4A7C15) & _MASK64
  z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
  z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
  return z ^ (z >> 31)


def per_example_keys(generator: torch.Generator, batch_size: int,
                     offset: int = 0) -> list[torch.Generator]:
  """One generator per batch row, on ``generator``'s device.

  Draws one 63-bit seed from ``generator`` (so successive calls with one
  generator give fresh rows), and seeds row i's generator with
  ``row_seed(seed, offset + i)``. The rows' samples then depend only on the
  seed and each row's global index: under data parallelism pass ``offset =
  data rank * local batch`` on every rank, each rank's ``generator`` in the
  same state (``parallel.sharding.make_shard_map_risk_train_step``).
  """
  device = generator.device
  seed = int(torch.randint(0, 2**63 - 1, (1,), generator=generator,
                           device=device).item())
  rows = []
  for i in range(batch_size):
    g = torch.Generator(device=device)
    g.manual_seed(row_seed(seed, int(offset) + i))
    rows.append(g)
  return rows


def sampled_risk_loss_per_example(lattice, params: Any,
                                  frames: torch.Tensor, num_frames, labels,
                                  num_labels,
                                  row_keys: Sequence[torch.Generator],
                                  num_samples: int = 4,
                                  estimator: str = 'mwer',
                                  risk_fn: RiskFn = edit_distance_risk,
                                  max_hyp_labels: Optional[int] = None,
                                  cache: Any = None
                                  ) -> tuple[torch.Tensor, dict]:
  """``sampled_risk_loss`` with one generator per batch row.

  One sampler pass for the whole batch, each row's Gumbel noise drawn from
  its own generator (``per_example_keys``), so the samples depend only on
  (seed, global row index): a data-parallel step reproduces the
  single-device samples. Arguments and results match ``sampled_risk_loss``
  except ``generator`` becomes ``row_keys``, and only one leading batch
  dimension is supported.
  """
  num_frames = torch.as_tensor(num_frames, device=frames.device)
  if num_frames.ndim != 1:
    raise ValueError('sampled_risk_loss_per_example supports a single '
                     f'leading batch dim, got batch_dims '
                     f'{tuple(num_frames.shape)}')
  row_keys = list(row_keys)
  if len(row_keys) != num_frames.shape[0]:
    raise ValueError(f'{len(row_keys)} row generators for a batch of '
                     f'{num_frames.shape[0]} rows')
  return sampled_risk_loss(
      lattice, params, frames, num_frames, labels, num_labels, row_keys,
      num_samples=num_samples, estimator=estimator, risk_fn=risk_fn,
      max_hyp_labels=max_hyp_labels, cache=cache)
