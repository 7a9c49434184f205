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

"""Recognition lattice, PyTorch port: decoding, the training loss and the
per-frame posteriors.

Counterpart of ``last_torch_tpu/lattices.py``. Ported: ``init``,
``build_cache``, ``shortest_path`` (through the Viterbi kernel,
``ops/viterbi.py``, which also normalizes a locally normalized
``JointWeightFn``, inside its gate; outside it the generic route, the
gradient of the tropical shortest distance with respect to a zero lexical
mask, as in the JAX package), ``loss`` / ``shortest_distance``,
``label_marginals`` (the marginals kernel of ``ops/fused_scan.py`` inside
its gate, the generic backward algorithm outside it) and ``arc_marginals``
(always the generic route, as in the JAX package), ``align`` (the string DP
under MaxTropical over the numerator's string weights, read off a mask's
gradient) and ``sample_paths`` (exact FFBS: a beta pass whose per-frame
``JointWeightFn.apply`` runs the joint+head kernels at 1024 context states
or more, a Gumbel-max draw at the sampled rows, and a differentiable
scoring of the drawn paths). The loss is the
globally normalized denominator minus the numerator, or minus the numerator
alone for a ``LocallyNormalizedWeightFn``: the numerator is the string DP
over the weight function's ``label_weights`` (the numerator kernels of
``ops/numerator_scan.py`` for a locally normalized one); the denominator
takes the log-partition kernels (``ops/fused_scan.py`` for the bigram,
``ops/trigram_scan.py`` for the trigram) inside their gates and the generic
forward-backward (a per-frame loop with a backward-algorithm gradient)
outside them, where the JAX package runs XLA. A ``NextStateTable``
context (any label-history DFA) never enters the bigram or trigram gates,
which need a ``FullNGram``: its loss, decode and posteriors run the generic
routes, whose per-frame ``JointWeightFn.apply`` runs the joint+head kernels
of ``ops/joint_head.py`` at 1024 context states or more. ``fused='never'``
sends every operation to the generic route.

A single-context-state lattice (S = 1: ``FullNGram(context_size=0)``, the
CTC topology) takes the factorized route of the JAX package
(``_forward_s1``): one weight-function application over every frame, the
per-frame factors of the alignment's algebra, and a log-depth cumulative
product over time (``semirings.cumulative_times``) in place of the frame
loop; the string weights are column gathers of the same application, and a
globally normalized loss shares it between numerator and denominator
(``_loss_s1``). ``shortest_distance`` takes any semiring with a
``weight_lift`` (the Expectation semiring's path entropy).
"""

from __future__ import annotations

import math
from collections.abc import Callable, Sequence
from typing import Any, Optional

import torch
import torch.utils.checkpoint
from torch.utils import _pytree as pytree

from last_torch_tpu_torch import alignments
from last_torch_tpu_torch import semirings
from last_torch_tpu_torch import weight_fns
from last_torch_tpu_torch.ops import fused_scan
from last_torch_tpu_torch.ops import trigram_scan
from last_torch_tpu_torch.ops import viterbi
from last_torch_tpu_torch.utils import profiling

Params = dict[str, Any]
# Lifts plain arc weight tensors into semiring values (tuple-valued ones, e.g.
# the Expectation semiring's, for path entropy). None means the identity.
WeightLift = Optional[Callable[[torch.Tensor], Any]]

# Route the Log-semiring string DP through its closed form
# (``RecognitionLattice._string_dp_alpha_cumulative``): one affine time
# recurrence per label position, solved with a cumsum and a cumulative
# logsumexp over time, a loop over the U+1 label positions in place of the
# loop over T frames. Off by default, as in the JAX package, which turned it
# off on a TPU measurement (its ``lattices.py``): that verdict is the JAX
# package's TPU figure, not one of this port. Its drift from a float64 scan
# at T=1600 is held to the JAX package's own closed form
# (``tests/test_torch_string_dp_cumulative.py``). It needs finite blank
# weights: the closed form subtracts their cumulative sum.
STRING_DP_CUMULATIVE = False

# The closed form's structural-zero sentinel: far below any reachable path
# weight but finite, so the cumulative sums and the logaddexp gradients stay
# free of NaN; values at or below the cutoff come back as -inf.
_DP_NEG = -1e30
_DP_CUTOFF = -1e20

# The sampler draws its Gumbel noise for this many frames at a time, and its
# scoring evaluates at most about this many arc weights at once.
_NOISE_FRAMES = 64
_SCORE_ENTRIES = 1 << 24


class RecognitionLattice:
  """Recognition lattice in GNAT-style formulation.

  Three components define it, as in the JAX package: a context dependency
  (``contexts``), an alignment lattice (``alignments``) and a weight
  function with its cacher (``weight_fns``). Parameters are dictionaries of
  tensors created by ``init`` and passed to every method.

  Attributes:
    context: Context dependency.
    alignment: Alignment lattice.
    weight_fn_cacher: WeightFnCacher built by ``weight_fn_cacher_factory``.
    weight_fn: WeightFn built by ``weight_fn_factory``.
    fused: 'auto' (default) takes the lattice kernels inside their gates,
      'never' the generic route for every operation. (The joint+head
      kernels of ``JointWeightFn.apply`` keep their own gate.)
  """

  def __init__(self, context, alignment,
               weight_fn_cacher_factory: Callable[[Any], Any],
               weight_fn_factory: Callable[[Any], Any],
               fused: str = 'auto'):
    if fused == 'interpret':
      raise ValueError(
          "fused='interpret' runs the JAX package's Pallas kernels in "
          'interpret mode and has no counterpart in the PyTorch port: the '
          "plain versions run on CPU tensors under 'auto'")
    if fused not in ('auto', 'never'):
      raise ValueError(f"fused should be 'auto' or 'never', but got "
                       f'{fused!r}')
    self.context = context
    self.alignment = alignment
    self.weight_fn_cacher = weight_fn_cacher_factory(context)
    self.weight_fn = weight_fn_factory(context)
    # 'auto': the lattice kernels inside their gates (their plain versions
    # on CPU tensors); 'never': every operation on the generic route, e.g.
    # to A/B the kernels against it on one lattice.
    self.fused = fused
    self._last_path = None
    # Single-context-state (S == 1) lattices take the factorized route
    # (``_forward_s1``); tests turn it off to hold it to the generic loop.
    self._factorize_s1 = True

  @property
  def last_path(self) -> Optional[str]:
    """Which path the last ``shortest_path``, log-partition or
    ``label_marginals`` took.

    'kernel' when it launched the lattice's CUDA kernels (CUDA tensors
    inside the kernels' gate), 'plain' when it ran their plain PyTorch
    versions (CPU tensors inside the gate), 'generic' for the per-frame loop
    outside the gates or under ``fused='never'`` (whose weight function may
    still launch the joint+head kernels, counted in
    ``ops.joint_head.forward_launches`` / ``backward_launches``), 's1' for
    the factorized single-context-state route (also a globally normalized
    S = 1 loss), None before any call.
    """
    return self._last_path

  def would_fuse(self, frames: torch.Tensor, semiring=semirings.Log) -> bool:
    """Whether the loss / log-partition on ``frames`` takes the lattice
    kernels (their plain versions on CPU tensors), from the configuration
    and shapes alone.

    Args:
      frames: The [batch, T, feature] frames the call would take.
      semiring: The semiring of the shortest distance; only Log has kernels.
    """
    if semiring is not semirings.Log:
      return False
    return any(self._kernels_take(ops, frames)
               for ops in (fused_scan, trigram_scan))

  def _kernels_take(self, ops, frames: torch.Tensor, **kw) -> bool:
    """Whether the lattice kernels of ``ops`` (``fused_scan`` or
    ``trigram_scan``) take an operation on ``frames``: ``fused`` allows them
    and their gate covers the configuration."""
    return self.fused != 'never' and ops.supported(self, frames, **kw)

  def init(self, generator: torch.Generator, feature_size: int,
           device='cuda') -> Params:
    """Creates the parameters, ``{'cacher': ..., 'weight_fn': ...}``, on
    ``device``: the card unless the caller asks for 'cpu'."""
    cacher_params = self.weight_fn_cacher.init(generator, device)
    cache = self.weight_fn_cacher.apply(cacher_params)
    dummy_frame = torch.zeros((feature_size,), device=device)
    wf_params = self.weight_fn.init(generator, cache, dummy_frame)
    return {'cacher': cacher_params, 'weight_fn': wf_params}

  def build_cache(self, params: Params) -> torch.Tensor:
    """The frame-independent weight function cache."""
    with profiling.span('lattice.cache'):
      return self.weight_fn_cacher.apply(params['cacher'])

  def __call__(self, params, frames, num_frames, labels, num_labels,
               cache=None):
    return self.loss(params, frames, num_frames, labels, num_labels, cache)

  def loss(self, params: Params, frames: torch.Tensor, num_frames, labels,
           num_labels, cache=None) -> torch.Tensor:
    """The negative sequence log-probability loss, -log P(labels | frames).

    Globally normalized: log Z (all paths) minus the weight of the paths
    that produce ``labels``. Locally normalized (a
    ``LocallyNormalizedWeightFn``): minus that weight alone, log Z being 0.
    Infeasible label sequences give +inf.

    Args:
      params: Parameters from ``init``.
      frames: [batch_dims..., max_num_frames, feature_size] padded frames.
      num_frames: [batch_dims...] number of frames.
      labels: [batch_dims..., max_num_labels] padded label sequences.
      num_labels: [batch_dims...] number of labels.
      cache: Optional weight function cache.

    Returns:
      [batch_dims...] loss.
    """
    num_frames, num_labels, labels = self._check_string_args(
        frames, num_frames, labels, num_labels)
    if cache is None:
      cache = self.build_cache(params)
    locally_normalized = isinstance(self.weight_fn,
                                    weight_fns.LocallyNormalizedWeightFn)
    if not locally_normalized and self._s1_route(frames):
      # Numerator and denominator share one weight application (the lattice
      # kernels need context_size >= 1 and never take S = 1).
      return self._loss_s1(params, cache, frames, num_frames, labels,
                           num_labels)
    numerator = self._string_forward(params, cache, frames, num_frames,
                                     labels, num_labels, semirings.Log)
    if locally_normalized:
      return -numerator
    denominator = self._forward_backward(params, cache, frames, num_frames)
    return denominator - numerator

  def shortest_path(self, params, frames: torch.Tensor,
                    num_frames: torch.Tensor, cache=None,
                    reference_compat: bool = False):
    """The highest scoring alignment path (Viterbi decode).

    Inside the Viterbi kernel's gate (bigram ``FullNGram``,
    ``JointWeightFn``, one batch dimension), on CUDA tensors the forward
    runs the Hopper kernel with bfloat16 joint and head inputs, as the TPU
    kernel did; on CPU tensors its plain version in float32, which is what
    the JAX package computes off the TPU. A ``LocallyNormalizedWeightFn``
    over a ``JointWeightFn`` with ``hat_normalize`` or
    ``log_softmax_normalize`` is normalized inside the kernel. Outside the
    gate (the trigram among others) it takes the JAX package's generic
    route (``_generic_shortest_path``).

    Args:
      params: Parameters from ``init``.
      frames: [batch_dims..., max_num_frames, feature_size] padded frames.
      num_frames: [batch_dims...] number of frames.
      cache: Optional weight function cache.
      reference_compat: Emit the reference's raw ``argmax`` label values
        (lexical label y becomes y - 1); see the JAX package's PARITY.md.

    Returns:
      (alignment_labels [batch_dims..., max_num_frames *
      num_alignment_states] int32, blank 0 or lexical 1..vocab_size;
      num_alignment_labels [batch_dims...] int32; path_weights
      [batch_dims...] in the frames' type).
    """
    num_frames = torch.as_tensor(num_frames, device=frames.device)
    if frames.shape[:-2] != num_frames.shape:
      raise ValueError('frames and num_frames have different batch_dims: '
                       f'{tuple(frames.shape[:-2])} vs '
                       f'{tuple(num_frames.shape)}')
    inner_wf, normalize = self.weight_fn, 'none'
    if isinstance(inner_wf, weight_fns.LocallyNormalizedWeightFn):
      if inner_wf.normalize is weight_fns.hat_normalize:
        inner_wf, normalize = inner_wf.weight_fn, 'hat'
      elif inner_wf.normalize is weight_fns.log_softmax_normalize:
        inner_wf, normalize = inner_wf.weight_fn, 'log_softmax'
    if cache is None:
      cache = self.build_cache(params)
    if self._kernels_take(fused_scan, frames, weight_fn=inner_wf):
      frame_dependent = isinstance(self.alignment,
                                   alignments.FrameDependent)
      on_card = frames.device.type == 'cuda'
      self._last_path = 'kernel' if on_card else 'plain'
      labels, num_labels, weights = viterbi.viterbi_decode(
          params['weight_fn'], cache, frames, num_frames,
          max_expansions=(0 if frame_dependent else
                          self.alignment.max_expansions),
          frame_dependent=frame_dependent,
          compute_dtype=fused_scan.compute_dtype_for(frames.device),
          normalize=normalize)
    else:
      labels, num_labels, weights = self._generic_shortest_path(
          params, cache, frames, num_frames)
    if reference_compat:
      labels = torch.where(labels == 0, 0, labels - 1)
    return labels, num_labels, weights

  def shortest_distance(self, params: Params, frames: torch.Tensor,
                        num_frames, semiring=None, cache=None,
                        weight_lift: WeightLift = None):
    """Shortest distance over all paths (the forward algorithm).

    Under the Log semiring with no lift (the default) this is log Z through
    the differentiable forward-backward route, the kernels inside their
    gate; any other semiring or a ``weight_lift`` takes the forward loop
    (the factorized route at S = 1). With the Expectation semiring and a
    lift, one pass gives e.g. the entropy of the path distribution of a
    locally normalized lattice::

      sr = semirings.LogLogExpectation
      lift = lambda w: sr.weighted(w, torch.log(torch.clamp(-w, min=1e-30)))
      log_z, log_cost = lattice.shortest_distance(
          params, frames, num_frames, semiring=sr, weight_lift=lift)
      entropy = torch.exp(log_cost - log_z)

    Args:
      params: Parameters from ``init``.
      frames: [batch_dims..., max_num_frames, feature_size] padded frames.
      num_frames: [batch_dims...] number of frames.
      semiring: Semiring (default ``semirings.Log``).
      cache: Optional weight function cache.
      weight_lift: Optional lifting of plain arc weight tensors into
        semiring values (required for the tuple-valued semirings).

    Returns:
      [batch_dims...] shortest distance (a semiring value).
    """
    semiring = semiring if semiring is not None else semirings.Log
    if cache is None:
      cache = self.build_cache(params)
    num_frames = torch.as_tensor(num_frames, device=frames.device)
    if semiring is semirings.Log and weight_lift is None:
      return self._forward_backward(params, cache, frames, num_frames)
    distance, _ = self._forward(params, cache, frames, num_frames, semiring,
                                weight_lift=weight_lift)
    return distance

  def arc_marginals(self, params: Params, frames: torch.Tensor, num_frames,
                    cache=None, max_output_bytes: int = 4 * 1024**3):
    """Arc posteriors by the backward algorithm (the dense output).

    The generic route, as in the JAX package, where this never takes a
    kernel: the forward loop saving the alpha history, then the reverse
    loop with an identity callback.

    Args:
      params: Parameters from ``init``.
      frames: [batch_dims..., max_num_frames, feature_size] padded frames.
      num_frames: [batch_dims...] number of frames.
      cache: Optional weight function cache.
      max_output_bytes: Largest dense output allowed (default 4 GiB); a
        larger one raises ValueError instead of allocating.

    Returns:
      (blank_marginals [batch_dims..., max_num_frames, num_context_states],
      lexical_marginals [batch_dims..., max_num_frames, num_context_states,
      vocab_size]): the posterior of each blank and lexical arc at each
      frame. Padding frames give zeros.
    """
    num_states, vocab_size = self.context.shape()
    batch = math.prod(frames.shape[:-2])
    out_bytes = 4 * batch * frames.shape[-2] * num_states * (vocab_size + 1)
    if out_bytes > max_output_bytes:
      raise ValueError(
          'arc_marginals would materialize a dense '
          f'[batch={batch}, T={frames.shape[-2]}, S={num_states}, '
          f'1+V={vocab_size + 1}] output of ~{out_bytes / 1024**3:.1f} GiB '
          f'(> max_output_bytes={max_output_bytes / 1024**3:.1f} GiB). Use '
          'label_marginals (O(T * (S + V)) outputs, through the marginals '
          'kernel on the card) for per-frame posteriors at production '
          'shapes, or raise max_output_bytes explicitly.')
    return self._generic_marginals(params, frames, num_frames, cache,
                                   lambda lexical: lexical)

  def label_marginals(self, params: Params, frames: torch.Tensor,
                      num_frames, cache=None):
    """Per-frame blank and label posteriors (the confidence API).

    The state-summed projection of ``arc_marginals``, with outputs of
    O(T * (S + V)). Inside the kernels' gate it runs
    ``fused_scan.label_marginals``: on CUDA tensors the forward and
    marginals kernels with bfloat16 joint and head inputs, as the TPU
    kernels; on CPU tensors their plain versions in float32, as the JAX
    package computes off the TPU. Outside the gate (a locally normalized
    weight function, the trigram or S = 1 among others), the generic
    backward algorithm, as in the JAX package: at S = 1 over the alpha
    history of the factorized forward.

    Args:
      params: Parameters from ``init``.
      frames: [batch_dims..., max_num_frames, feature_size] padded frames.
      num_frames: [batch_dims...] number of frames.
      cache: Optional weight function cache.

    Returns:
      (blank_marginals [batch_dims..., max_num_frames, num_context_states],
      label_marginals [batch_dims..., max_num_frames, vocab_size]): the
      posterior of the blank arc leaving each state, summed over the
      alignment's expansions, and of emitting label y + 1, summed over
      source states and expansions. Padding frames give zeros; at a valid
      frame they sum to the expected number of arcs taken there (1 for
      FrameDependent).
    """
    num_frames = torch.as_tensor(num_frames, device=frames.device)
    if tuple(frames.shape[:-2]) != tuple(num_frames.shape):
      raise ValueError('frames and num_frames have different batch_dims: '
                       f'{tuple(frames.shape[:-2])} vs '
                       f'{tuple(num_frames.shape)}')
    if self._kernels_take(fused_scan, frames):
      if cache is None:
        cache = self.build_cache(params)
      frame_dependent = isinstance(self.alignment, alignments.FrameDependent)
      on_card = frames.device.type == 'cuda'
      self._last_path = 'kernel' if on_card else 'plain'
      return fused_scan.label_marginals(
          params['weight_fn'], cache, frames, num_frames,
          max_expansions=(0 if frame_dependent else
                          self.alignment.max_expansions),
          frame_dependent=frame_dependent,
          compute_dtype=fused_scan.compute_dtype_for(frames.device))
    return self._generic_marginals(
        params, frames, num_frames, cache,
        lambda lexical: lexical.sum(dim=-2))

  def align(self, params: Params, frames: torch.Tensor, num_frames, labels,
            num_labels, cache=None):
    """Forced alignment: the frame at which each reference label is emitted.

    Runs the string DP under MaxTropical over the string weights plus a
    zero lexical mask, and reads the winning path off the mask's one-hot
    gradient, as ``shortest_path``'s generic route does, restricted to the
    paths that emit exactly the reference transcript. The string weights
    are computed without autograd (only the mask is differentiated): a
    ``JointWeightFn``'s ``label_weights``, or a locally normalized one's,
    which is the numerator forward kernel on CUDA tensors.

    Args:
      params: Parameters from ``init``.
      frames: [batch_dims..., max_num_frames, feature_size] padded frames.
      num_frames: [batch_dims...] number of frames.
      labels: [batch_dims..., max_num_labels] reference labels (1-based,
        0-padded).
      num_labels: [batch_dims...] number of reference labels.
      cache: Optional weight function cache.

    Returns:
      (emit_frames, path_weights):
      - emit_frames: [batch_dims..., max_num_labels] int32; entry u is the
        frame at which reference label u is emitted on the highest-scoring
        alignment, -1 beyond ``num_labels``.
      - path_weights: [batch_dims...] tropical score of that alignment,
        -inf when the transcript is infeasible (the emit_frames row is
        meaningless then).
    """
    if cache is None:
      cache = self.build_cache(params)
    num_frames, num_labels, labels = self._check_string_args(
        frames, num_frames, labels, num_labels)
    with torch.no_grad():
      blank_weight, lexical_weight = self._string_weights(
          params, cache, frames, labels)
    lexical_mask = torch.zeros_like(lexical_weight, requires_grad=True)
    with torch.enable_grad():
      scores = self._string_dp(blank_weight, lexical_weight + lexical_mask,
                               num_frames, num_labels, semirings.MaxTropical)
      if scores.requires_grad:
        (marks,) = torch.autograd.grad(scores.sum(), lexical_mask)
      else:  # no frames
        marks = torch.zeros_like(lexical_mask)
    # [T, batch..., U+1] -> [batch..., U+1, T]; exactly one winning frame
    # per position u < num_labels (each position advances once per path).
    marks = marks.movedim(0, -1)[..., :labels.shape[-1], :]
    if marks.shape[-1] == 0:
      emit = torch.full(marks.shape[:-1], -1, dtype=torch.int32,
                        device=marks.device)
    else:
      emit = torch.argmax(marks, dim=-1).to(torch.int32)
      emit = torch.where(marks.amax(dim=-1) > 0, emit, -1)
    return emit, scores.detach()

  def sample_paths(self, params: Params, frames: torch.Tensor, num_frames,
                   generator, num_samples: int = 1, cache=None):
    """Exact posterior samples of alignment paths (FFBS).

    Draws i.i.d. alignment paths from the lattice's posterior
    ``p(path) = exp(w(path)) / Z`` by backward filtering / forward
    sampling, as the JAX package:

    1. The beta pass (``_sample_betas``): a reverse loop over frames gives
       beta at every frame and, for FrameLabelDependent, the continuation
       values of each expansion; its start-state entry at frame 0 is
       log Z. ``weight_fn.apply`` over every context state runs once a
       frame (the joint+head kernels at 1024 states or more); each frame
       is checkpointed, so the backward recomputes it and saves only the
       [batch..., S] carries.
    2. The draw (``_draw_paths``, no autograd): a forward loop that
       evaluates the weight function only at the sampled context rows
       (one ``apply`` per expansion slot, the state [batch..., M] against
       the frame expanded to [batch..., M, F]) and draws each expansion
       slot from its exact conditional by Gumbel-max.
    3. The scoring (``_score_paths``): the weight of the drawn paths,
       differentiable, through the weight function at each slot's state.

    ``log_prob`` carries gradients through the scoring and through the beta
    pass (``log_z``), as in the JAX package; the draw has none.
    ``risk.sampled_risk_loss`` takes log Z without autograd
    (``_sample_paths``): its estimators' gradient through it is zero.

    Args:
      params: Parameters from ``init``.
      frames: [batch_dims..., max_num_frames, feature_size] padded frames.
      num_frames: [batch_dims...] number of frames.
      generator: The source of randomness, in place of the JAX package's
        key: a ``torch.Generator`` on the frames' device, or a sequence of
        one generator per batch row (one batch dimension), each row's
        Gumbel noise drawn from its own (see ``risk.per_example_keys``).
        The global RNG is never used.
      num_samples: Number of independent path samples per utterance.
      cache: Optional weight function cache.

    Returns:
      (alignment_labels, num_alignment_labels, log_prob):
      - alignment_labels: [batch_dims..., num_samples,
        max_num_frames * num_alignment_states] int32 in the packed slot
        format of ``shortest_path``: blank / unused 0, lexical 1..V.
      - num_alignment_labels: [batch_dims..., num_samples] int32,
        ``num_alignment_states * num_frames``.
      - log_prob: [batch_dims..., num_samples] exact posterior
        log-probability ``w(path) - log Z`` of each sampled path.
    """
    return self._sample_paths(params, frames, num_frames, generator,
                              num_samples, cache)

  def _sample_paths(self, params, frames, num_frames, generator,
                    num_samples, cache, log_z_grad=True):
    """``sample_paths``; with ``log_z_grad`` False the beta pass records no
    autograd (no checkpoints, no backward through it), and ``log_prob``
    carries gradients through the scoring alone, log Z a constant."""
    if not isinstance(self.alignment, (alignments.FrameDependent,
                                       alignments.FrameLabelDependent)):
      raise NotImplementedError(
          'sample_paths supports FrameDependent and FrameLabelDependent '
          f'alignment lattices, got {type(self.alignment).__name__}')
    num_frames = torch.as_tensor(num_frames, device=frames.device)
    batch_dims = tuple(num_frames.shape)
    if tuple(frames.shape[:-2]) != batch_dims:
      raise ValueError('frames and num_frames have different batch_dims: '
                       f'{tuple(frames.shape[:-2])} vs {batch_dims}')
    noise = _gumbel_source(generator, batch_dims, frames.device)
    if cache is None:
      cache = self.build_cache(params)
    with torch.set_grad_enabled(torch.is_grad_enabled() and log_z_grad):
      log_z, beta_next, conts = self._sample_betas(params, cache, frames,
                                                   num_frames)
    labels = self._draw_paths(params, cache, frames, num_frames, beta_next,
                              conts, num_samples, noise)
    logw = self._score_paths(params, cache, frames, num_frames, labels)
    num_labels = (self.alignment.num_states() * num_frames.to(torch.int32))
    num_labels = num_labels[..., None].expand(batch_dims + (num_samples,))
    return labels, num_labels, logw - log_z[..., None]

  # Private dynamic programs.

  def _sample_betas(self, params, cache, frames, num_frames):
    """The sampler's beta pass (phase 1): a reverse loop over frames.

    Returns:
      (log_z [batch_dims...], beta_next, conts): ``beta_next[t]`` is beta
      after frame t (the backward weight of frame t + 1, [batch_dims...,
      S]); ``conts[e][t]`` is the continuation value the draw conditions
      expansion e of frame t on: v[e + 1] for FrameLabelDependent (the
      weight of completing the utterance having taken e + 1 lexical arcs in
      frame t), beta_next[t] for FrameDependent, whose lexical arc ends the
      frame. Only log_z records autograd; the histories are detached.
    """
    fld = isinstance(self.alignment, alignments.FrameLabelDependent)
    k = self.alignment.max_expansions if fld else 0
    wf_params = params['weight_fn']

    def cont_values(blank, lexical, beta_next):
      # v[e]: the weight of completing the utterance from each state having
      # taken e lexical arcs in this frame; v[0] is beta. Only the
      # logsumexp's operand is ever [batch..., S, V].
      blank_term = blank + beta_next
      v = [None] * (k + 1) if fld else [None, beta_next]
      v[-1] = blank_term if fld else beta_next
      for e in range(len(v) - 2, -1, -1):
        s_e = semirings.Log.sum(
            lexical + self.context.backward_broadcast(v[e + 1]), axis=-1)
        v[e] = semirings.Log.plus(blank_term, s_e)
      return tuple(v) if fld else (v[0],)

    def step(beta, t):
      blank, lexical = self.weight_fn.apply(wf_params, cache,
                                            frames[..., t, :])
      return cont_values(blank, lexical, beta)

    if torch.is_grad_enabled():
      step_fn = lambda beta, t: torch.utils.checkpoint.checkpoint(
          step, beta, t, use_reentrant=False)
    else:
      step_fn = step
    batch_dims = tuple(num_frames.shape)
    max_t = frames.shape[-2]
    beta = semirings.Log.ones(batch_dims + (self.context.shape()[0],),
                              frames.dtype, frames.device)
    beta_next = [None] * max_t
    conts = [[None] * max_t for _ in range(k)]
    for t in range(max_t - 1, -1, -1):
      v = step_fn(beta, t)
      beta_next[t] = beta.detach()
      for e in range(k):
        conts[e][t] = v[e + 1].detach()
      beta = torch.where((t >= num_frames)[..., None], beta, v[0])
    return beta[..., self.context.start()], beta_next, conts or [beta_next]

  def _conts_at_next_states(self, cont, c):
    """cont [batch..., S], c [batch..., M] -> ``cont[next_state(c_m, y)]``
    for every lexical y, [batch..., M, V], without the [batch..., S, V]
    broadcast."""
    vocab_size = self.context.shape()[1]
    y_all = torch.arange(1, vocab_size + 1, device=c.device)
    ns = self.context.next_state(c[..., None], y_all).long()
    out = torch.gather(cont, -1, ns.reshape(ns.shape[:-2] + (-1,)))
    return out.reshape(tuple(c.shape) + (vocab_size,))

  @torch.no_grad()
  def _draw_paths(self, params, cache, frames, num_frames, beta_next, conts,
                  num_samples, noise):
    """The sampler's draw (phase 2): a forward loop drawing each expansion
    slot by Gumbel-max from its exact conditional, with arc weights
    evaluated only at the M sampled rows. ``noise(frames, draws, m, n)``
    returns uniform noise [frames, draws, batch..., m, n].

    Returns:
      [batch_dims..., M, max_num_frames * num_alignment_states] int32
      labels in ``shortest_path``'s slot format.
    """
    batch_dims = tuple(num_frames.shape)
    max_t, feature_size = frames.shape[-2:]
    num_align = self.alignment.num_states()
    vocab_size = self.context.shape()[1]
    draws = len(conts)
    wf_params = params['weight_fn']
    m = num_samples
    c = torch.full(batch_dims + (m,), self.context.start(), dtype=torch.long,
                   device=frames.device)
    tiny = torch.finfo(torch.float32).tiny
    slots = []
    for t in range(max_t):
      if t % _NOISE_FRAMES == 0:
        uniform = noise(min(_NOISE_FRAMES, max_t - t), draws, m,
                        1 + vocab_size)
        gumbel = -torch.log(-torch.log(uniform.clamp_(min=tiny)))
      is_padding = (t >= num_frames)[..., None]
      frame = frames[..., t, None, :].expand(batch_dims + (m, feature_size))
      done = torch.zeros_like(is_padding.expand(c.shape))
      for e in range(num_align):
        if e < draws:
          blank_w, lex_rows = self.weight_fn.apply(wf_params, cache, frame,
                                                   c)
          logits = torch.cat([
              (blank_w + torch.gather(beta_next[t], -1, c))[..., None],
              lex_rows + self._conts_at_next_states(conts[e][t], c)], dim=-1)
          choice = torch.argmax(logits + gumbel[t % _NOISE_FRAMES, e],
                                dim=-1)
          choice = torch.where(done | is_padding, 0, choice)
        else:
          # The last FLD expansion state has no lexical arc.
          choice = torch.zeros_like(c)
        done = done | ((choice == 0) & ~is_padding)
        c = self.context.next_state(c, choice)
        slots.append(choice)
    if not slots:
      return torch.zeros(batch_dims + (m, 0), dtype=torch.int32,
                         device=frames.device)
    return torch.stack(slots, dim=-1).to(torch.int32)

  @torch.no_grad()
  def _slot_states(self, slots):
    """The context state before each slot of [batch..., T * A] labels."""
    return self.context.walk_states(slots)[..., :-1].long()

  def _score_paths(self, params, cache, frames, num_frames, labels):
    """The weight of given alignment paths (the sampler's phase 3).

    Args:
      labels: [batch_dims..., M, max_num_frames * num_alignment_states]
        paths in ``shortest_path``'s slot format.

    Returns:
      [batch_dims..., M] path weights, recording autograd through the
      weight function at each slot's state (checkpointed by chunks of
      frames).
    """
    batch_dims = tuple(num_frames.shape)
    max_t, feature_size = frames.shape[-2:]
    num_align = self.alignment.num_states()
    m = labels.shape[-2]
    states = self._slot_states(labels).reshape(batch_dims +
                                               (m, max_t, num_align))
    slots = labels.long().reshape(batch_dims + (m, max_t, num_align))
    # A slot takes an arc until the frame's blank: after an unused (0) slot
    # of FrameLabelDependent nothing more is taken; padding frames take
    # none.
    emitted = slots > 0
    active = torch.cat([torch.ones_like(emitted[..., :1]),
                        emitted[..., :-1].cumprod(dim=-1).bool()], dim=-1)
    valid = torch.arange(max_t, device=frames.device) < num_frames[
        ..., None]
    active = active & valid[..., None, :, None]
    wf_params = params['weight_fn']

    def chunk_weight(frame, state, slot, on):
      blank, lexical = self.weight_fn.apply(wf_params, cache, frame, state)
      label_w = torch.gather(lexical, -1, (slot - 1).clamp(min=0)[..., None])
      w = torch.where(slot > 0, label_w[..., 0], blank)
      return torch.where(on, w, 0.0).sum(dim=(-2, -1))

    if torch.is_grad_enabled():
      weigh = lambda *a: torch.utils.checkpoint.checkpoint(
          chunk_weight, *a, use_reentrant=False)
    else:
      weigh = chunk_weight
    rows = math.prod(batch_dims) * m * num_align * (
        self.context.shape()[1] + 1)
    step = max(1, _SCORE_ENTRIES // max(rows, 1))
    logw = frames.new_zeros(batch_dims + (m,))
    for t0 in range(0, max_t, step):
      t1 = min(max_t, t0 + step)
      frame = frames[..., None, t0:t1, None, :].expand(
          batch_dims + (m, t1 - t0, num_align, feature_size))
      logw = logw + weigh(frame, states[..., t0:t1, :], slots[..., t0:t1, :],
                          active[..., t0:t1, :])
    return logw

  def _check_string_args(self, frames, num_frames, labels, num_labels):
    """Shape validation shared by the loss and the string DP."""
    device = frames.device
    num_frames = torch.as_tensor(num_frames, device=device)
    num_labels = torch.as_tensor(num_labels, device=device)
    labels = torch.as_tensor(labels, device=device).long()
    batch_dims = tuple(num_frames.shape)
    for name, shape in (('frames', frames.shape[:-2]),
                        ('labels', labels.shape[:-1]),
                        ('num_labels', num_labels.shape)):
      if tuple(shape) != batch_dims:
        raise ValueError(f'{name} and num_frames have different batch_dims: '
                         f'{tuple(shape)} vs {batch_dims}')
    return num_frames, num_labels, labels

  def _string_forward(self, params, cache, frames, num_frames, labels,
                      num_labels, semiring, weight_lift: WeightLift = None):
    """Shortest distance on the intersection with an output string.

    The numerator: per-(frame, label-position) weights (``_string_weights``)
    then the string DP.

    Returns:
      [batch_dims...] shortest distance.
    """
    num_frames, num_labels, labels = self._check_string_args(
        frames, num_frames, labels, num_labels)
    blank_weight, lexical_weight = self._string_weights(
        params, cache, frames, labels)
    return self._string_dp(blank_weight, lexical_weight, num_frames,
                           num_labels, semiring, weight_lift)

  def _string_weights(self, params, cache, frames, labels):
    """Per-(frame, label-position) blank and next-label weights.

    Returns (blank_weight, lexical_weight), both time-major
    [T, batch_dims..., U+1]: position u's weights come from the context
    state after ``labels[..., :u]``; ``lexical_weight`` holds the weight of
    the next needed label (position U uses a dummy label, never final).

    At S = 1 every position shares the one context state, so one weight
    application over all frames gives every weight (column gathers of it).
    Otherwise the weight function's ``label_weights`` fast path, or, where
    it has none (None), one checkpointed step per label position that
    applies the weight function over all frames at that position's state
    and gathers the next label's column.
    """
    wf_params = params['weight_fn']
    next_labels = torch.cat([labels, torch.ones_like(labels[..., :1])],
                            dim=-1)
    if self._factorize_s1 and self.context.shape()[0] == 1:
      blank, lexical = self._s1_weights(wf_params, cache, frames,
                                        tuple(labels.shape[:-1]))
      return self._s1_string_weights_from(blank, lexical, next_labels)
    context_states = self.context.walk_states(labels)
    weights = self.weight_fn.label_weights(wf_params, cache, frames,
                                           context_states, next_labels)
    if weights is None:
      weights = self._position_weights(wf_params, cache, frames,
                                       context_states, next_labels)
    blank, lexical = weights
    # [batch_dims..., U+1, T] -> [T, batch_dims..., U+1].
    return blank.movedim(-1, 0), lexical.movedim(-1, 0)

  def _position_weights(self, wf_params, cache, frames, context_states,
                        next_labels):
    """The generic per-position string weights: ``label_weights``'s
    contract for any weight function, one ``apply`` over all frames per
    label position (checkpointed when autograd records, as the JAX package
    rematerializes it).

    Returns:
      (blank, lexical), each [batch_dims..., U+1, max_num_frames].
    """
    max_t = frames.shape[-2]

    def position(state, next_label):
      state = state.long()[..., None].expand(state.shape + (max_t,))
      blank, lexical = self.weight_fn.apply(wf_params, cache, frames, state)
      # Label 0 (padding) is clamped to 1: never selected as final.
      y = (next_label.long().clamp(min=1) - 1)[..., None, None]
      lexical_y = torch.gather(lexical, -1, y.expand(state.shape + (1,)))
      return blank, lexical_y[..., 0]

    if torch.is_grad_enabled():
      step = lambda *a: torch.utils.checkpoint.checkpoint(
          position, *a, use_reentrant=False)
    else:
      step = position
    outputs = [step(context_states[..., u], next_labels[..., u])
               for u in range(next_labels.shape[-1])]
    return (torch.stack([b for b, _ in outputs], dim=-2),
            torch.stack([l for _, l in outputs], dim=-2))

  def _string_dp(self, blank_weight, lexical_weight, num_frames, num_labels,
                 semiring, weight_lift: WeightLift = None, alpha0=None,
                 t_offset: int = 0, final_gather: bool = True):
    """The (frame x label-position) recursion over precomputed weights.

    The scan route, one step a frame; ``weight_lift`` lifts each frame's
    weights into the semiring. With ``STRING_DP_CUMULATIVE`` set, a
    float32 Log-semiring DP over a ``FrameDependent`` or
    ``FrameLabelDependent`` alignment takes the closed form instead
    (``_string_dp_alpha_cumulative``, one step a label position), as in
    the JAX package.

    ``alpha0`` / ``t_offset`` / ``final_gather`` run the recursion over one
    block of frames of a longer sequence (the time-sharded relay,
    ``parallel/sequence.py``): the label-position carry starts from
    ``alpha0`` (the one-hot position 0 by default), frame t of the block is
    frame ``t_offset + t`` of the sequence for the padding test, and with
    ``final_gather`` False the raw final carry [batch_dims..., U+1] comes
    back instead of its ``num_labels`` entry.
    """
    batch_dims = tuple(num_frames.shape)
    num_align_states = self.alignment.num_states()
    num_positions = blank_weight.shape[-1]
    lift = weight_lift if weight_lift is not None else _identity
    alpha = alpha0
    if alpha is None:
      alpha = _init_context_state_weights(
          batch_dims, num_positions, 0, semiring,
          _lifted_dtype(lift, blank_weight), blank_weight.device)
    if (STRING_DP_CUMULATIVE and weight_lift is None
        and semiring is semirings.Log
        and blank_weight.shape[0] > 0
        and blank_weight.dtype == torch.float32
        and isinstance(self.alignment, (alignments.FrameDependent,
                                        alignments.FrameLabelDependent))):
      alpha = self._string_dp_alpha_cumulative(
          blank_weight, lexical_weight, num_frames, alpha, t_offset)
    else:
      for t in range(blank_weight.shape[0]):
        next_alpha = self.alignment.string_forward(
            alpha=alpha, blank=[lift(blank_weight[t])] * num_align_states,
            lexical=[lift(lexical_weight[t])] * num_align_states,
            semiring=semiring)
        alpha = semirings.where((t_offset + t >= num_frames)[..., None],
                                alpha, next_alpha)
    if not final_gather:
      return alpha
    is_final = num_labels[..., None] == torch.arange(
        num_positions, device=blank_weight.device)
    zero = semirings.zeros_like(semiring, alpha, ())
    return semiring.sum(semirings.where(is_final, alpha, zero), axis=-1)

  def _string_dp_alpha_cumulative(self, blank_weight, lexical_weight,
                                  num_frames, init_alpha, t_offset):
    """The Log-semiring string DP in closed form, one label position at a
    time.

    For a fixed label position u the string DP's time recursion is a
    first-order affine recurrence in the Log semiring::

      x_u[t] = A[t] (x) x_u[t-1]  (+)  C[t, u]

    with ``A[t] = blank[t, u]`` and ``C`` collecting the label arcs out of
    positions u-1 .. u-k at frame t (FrameDependent: k = 1 and no trailing
    blank; FrameLabelDependent(k): each expansion's chain of lexical
    weights times the terminating blank, ``alignment.string_forward``
    unrolled per position). Its closed form in log space is::

      x_u = cumA + logaddexp(alpha0_u, logcumsumexp(C - cumA))

    so the DP is a loop over the U+1 label positions, each a handful of
    [batch..., T] cumulative ops, instead of a loop over the T frames.
    Structural zeros ride the finite sentinel ``_DP_NEG`` (the closed form
    subtracts cumA, so blank weights must be finite) and are restored to
    -inf past ``_DP_CUTOFF``, which keeps an infeasible string's weight
    exactly -inf. Padded frames multiply by one (blank 0, lexical zero),
    as the scan's ``where(is_padding, alpha, ...)`` does.

    It computes in float64 and returns the weights' dtype. The closed form
    subtracts and re-adds cumA, |cumA| reaching ~1e3 nats at T=1600, so
    its cumulative ops need more than float32: PyTorch's CPU scans
    accumulate float32 in float64, but its CUDA scans accumulate in
    float32, and there, on an H100, the float32 closed form's gradients
    drifted 1e-3 of the largest from a float64 scan at the HAT training
    shape (``chip_smoke.py`` phase 18).

    Args:
      blank_weight, lexical_weight: time-major [T, batch_dims..., U+1], as
        ``_string_dp``.
      num_frames: [batch_dims...] lengths.
      init_alpha: [batch_dims..., U+1] carry before the first frame.
      t_offset: global index of frame 0 (the time-sharded relay's blocks).

    Returns:
      [batch_dims..., U+1] final carry, the scan's up to rounding.
    """
    neg = _DP_NEG
    dtype = blank_weight.dtype
    blank_weight, lexical_weight, init_alpha = (
        x.double() for x in (blank_weight, lexical_weight, init_alpha))
    max_t = blank_weight.shape[0]
    frame = t_offset + torch.arange(max_t, device=blank_weight.device)
    is_pad = frame >= num_frames[..., None]  # [batch..., T]
    fld = isinstance(self.alignment, alignments.FrameLabelDependent)
    k = self.alignment.max_expansions if fld else 1
    # Label-position-major with time innermost, [U+1, batch..., T]: the
    # cumulative ops then scan contiguous rows, which the card runs in
    # parallel (along an outer axis each column is one thread's loop).
    columns = lambda x: x.movedim(0, -1).movedim(-2, 0)
    blank = torch.where(is_pad, 0.0, columns(blank_weight)).contiguous()
    lexical = torch.where(is_pad, neg, columns(lexical_weight)).clamp(
        min=neg).contiguous()
    alpha0 = init_alpha.clamp(min=neg).movedim(-1, 0)[..., None]
    # The last k positions' rows over time, nearest first.
    previous, finals = [], []
    for u in range(blank.shape[0]):
      cum_a = torch.cumsum(blank[u], dim=-1)
      chain, arcs = 0.0, None
      # Positions before 0 carry only the sentinel and add nothing.
      for e in range(1, min(k, u) + 1):
        chain = chain + lexical[u - e]
        # x_{u-e} one frame back, alpha0 before the first frame.
        shifted = torch.cat([alpha0[u - e], previous[e - 1][..., :-1]],
                            dim=-1)
        term = shifted + chain
        arcs = term if arcs is None else torch.logaddexp(arcs, term)
      if arcs is None:
        c = torch.full_like(cum_a, neg)
      else:
        c = (blank[u] + arcs if fld else arcs).clamp(min=neg)
      m = torch.logcumsumexp(c - cum_a, dim=-1)
      x_u = (cum_a + torch.logaddexp(alpha0[u], m)).clamp(min=neg)
      previous = [x_u] + previous[:k - 1]
      finals.append(x_u[..., -1])
    alpha = torch.stack(finals, dim=-1)
    return torch.where(alpha <= _DP_CUTOFF, -math.inf, alpha).to(dtype)

  def _s1_route(self, frames) -> bool:
    """Whether the factorized single-context-state route applies: S == 1,
    at least one frame, and an alignment whose per-frame factor
    ``_forward_s1_from_weights`` spells out."""
    return (self._factorize_s1 and self.context.shape()[0] == 1 and
            frames.shape[-2] > 0 and
            isinstance(self.alignment, (alignments.FrameDependent,
                                        alignments.FrameLabelDependent)))

  def _generic_shortest_path(self, params, cache, frames, num_frames):
    """The JAX package's generic decode: the tropical shortest distance is
    differentiated with respect to a zero lexical mask, whose one-hot,
    tie-broken MaxTropical gradient marks the lexical arcs of one best path.

    Runs with autograd on whatever the caller's mode (``GNATModel.decode``
    runs under ``torch.no_grad``) and only the mask differentiated. Each
    frame is checkpointed, so the backward recomputes every frame's weights
    once more.

    Returns:
      (alignment_labels, num_alignment_labels, path_weights) as
      ``shortest_path``.
    """
    batch_dims = tuple(num_frames.shape)
    max_num_frames = frames.shape[-2]
    num_alignment_states = self.alignment.num_states()
    params = pytree.tree_map(torch.Tensor.detach, params)
    cache = None if cache is None else cache.detach()
    frames = frames.detach()
    mask = torch.zeros(batch_dims + (max_num_frames, num_alignment_states,
                                     self.context.shape()[1]),
                       dtype=frames.dtype, device=frames.device,
                       requires_grad=True)
    with torch.enable_grad():
      path_weights, _ = self._forward(
          params, cache, frames, num_frames, semirings.MaxTropical,
          lexical_mask=[mask[..., i, None, :]
                        for i in range(num_alignment_states)])
      if path_weights.requires_grad:
        (viterbi_mask,) = torch.autograd.grad(path_weights.sum(), mask)
      else:  # no frames: no arc, all-blank labels
        viterbi_mask = torch.zeros_like(mask)
    is_blank = torch.all(viterbi_mask == 0, dim=-1)
    labels = torch.where(is_blank, 0, 1 + torch.argmax(viterbi_mask, dim=-1))
    labels = labels.reshape(batch_dims + (-1,)).to(torch.int32)
    num_labels = (num_alignment_states * num_frames).to(torch.int32)
    return labels, num_labels, path_weights.detach()

  def _forward(self, params, cache, frames, num_frames, semiring,
               blank_mask: Optional[Sequence[torch.Tensor]] = None,
               lexical_mask: Optional[Sequence[torch.Tensor]] = None,
               weight_lift: WeightLift = None):
    """Shortest distance by the forward algorithm, in any semiring.

    A per-frame loop over ``weight_fn.apply`` and ``alignment.forward``.
    When autograd records, each frame runs under ``torch.utils.checkpoint``
    so that only the O(B * S) alpha carries are saved, never the
    O(B * S * V) arc weights (the JAX package's remat policy). At S = 1 the
    factorized route (``_forward_s1``) instead.

    Args:
      params, cache, frames, num_frames: As ``shortest_distance``.
      semiring: Semiring of the shortest distance.
      blank_mask: Optional length num_alignment_states sequence of
        [batch_dims..., max_num_frames, 1-or-num_context_states] tensors
        added to the blank weights.
      lexical_mask: Optional length num_alignment_states sequence of
        [batch_dims..., max_num_frames, 1-or-num_context_states,
        1-or-vocab_size] tensors added to the lexical weights.
      weight_lift: Optional lifting of the (masked) weights into semiring
        values, for tuple-valued semirings.

    Returns:
      (shortest_distance [batch_dims...], alpha history [batch_dims...,
      max_num_frames, num_context_states]: alpha before each frame), both
      semiring values.
    """
    num_frames = torch.as_tensor(num_frames, device=frames.device)
    batch_dims = tuple(num_frames.shape)
    if tuple(frames.shape[:-2]) != batch_dims:
      raise ValueError('frames and num_frames have different batch_dims: '
                       f'{tuple(frames.shape[:-2])} vs {batch_dims}')
    num_align_states = self.alignment.num_states()
    for name, mask in (('blank_mask', blank_mask),
                       ('lexical_mask', lexical_mask)):
      if mask is not None and len(mask) != num_align_states:
        raise ValueError(
            f'The length of {name} should be equal to {num_align_states} '
            f'(the number of alignment states), but is {len(mask)}')
    wf_params = params['weight_fn']
    lift = weight_lift if weight_lift is not None else _identity
    if self._s1_route(frames):
      self._last_path = 's1'
      return self._forward_s1(wf_params, cache, frames, num_frames, semiring,
                              blank_mask, lexical_mask, lift)
    self._last_path = 'generic'
    step_fn = self._frame_step(wf_params, cache, frames, num_frames,
                               semiring, blank_mask, lexical_mask,
                               weight_lift)
    num_states = self.context.shape()[0]
    alpha = _init_context_state_weights(
        batch_dims, num_states, self.context.start(), semiring,
        _lifted_dtype(lift, frames), frames.device)
    history = []
    for t in range(frames.shape[-2]):
      history.append(alpha)
      alpha = step_fn(alpha, t)
    if history:
      history = semirings.stack(history, axis=-2)
    else:
      history = pytree.tree_map(
          lambda a: a.new_empty(batch_dims + (0, num_states)), alpha)
    return semiring.sum(alpha, axis=-1), history

  def _forward_block(self, params, cache, frames, num_frames, semiring,
                     alpha, t_offset: int = 0, lexical_mask=None,
                     weight_lift: WeightLift = None):
    """Advances the forward algorithm's alpha over one block of frames.

    The time-sharded relay's body (``parallel/sequence.py``): the frame
    loop of ``_forward`` from ``alpha``, keeping no history, for any
    semiring and lift. At S = 1 it is the same loop: the factorized route
    needs the whole sequence.

    Args:
      params, cache, semiring, weight_lift: As ``_forward``.
      frames: [batch, Tl, feature] frames of the block.
      num_frames: [batch] frame counts of the whole sequence.
      alpha: [batch, S] alpha before the block (a semiring value).
      t_offset: The sequence frame of the block's first frame, for the
        padding test (frames at or past ``num_frames`` hold alpha).
      lexical_mask: Optional additive [batch, Tl, num_alignment_states,
        vocab_size] mask on the block's lexical weights (the decode's
        differentiation hook).

    Returns:
      The [batch, S] alpha after the block.
    """
    masks = None
    if lexical_mask is not None:
      masks = [lexical_mask[..., i, None, :]
               for i in range(self.alignment.num_states())]
    step_fn = self._frame_step(params['weight_fn'], cache, frames,
                               num_frames, semiring, None, masks,
                               weight_lift, t_offset)
    for t in range(frames.shape[-2]):
      alpha = step_fn(alpha, t)
    return alpha

  def _frame_step(self, wf_params, cache, frames, num_frames, semiring,
                  blank_mask, lexical_mask, weight_lift: WeightLift,
                  t_offset: int = 0):
    """``step(alpha, t)``: frame t of the forward algorithm's loop (masks
    as ``_forward`` takes them), holding alpha where frame ``t_offset + t``
    is padding; checkpointed when autograd records, so that only the
    O(B * S) alpha carries are saved, never the O(B * S * V) arc
    weights."""
    num_align_states = self.alignment.num_states()
    lift = weight_lift if weight_lift is not None else _identity

    def step(alpha, t):
      blank, lexical = self.weight_fn.apply(wf_params, cache,
                                            frames[..., t, :])
      next_alpha = self.alignment.forward(
          alpha=alpha,
          blank=_lift_masked(lift, blank, blank_mask, num_align_states,
                             lambda m: m[..., t, :]),
          lexical=_lift_masked(lift, lexical, lexical_mask,
                               num_align_states, lambda m: m[..., t, :, :]),
          context=self.context, semiring=semiring)
      return semirings.where((t_offset + t >= num_frames)[..., None], alpha,
                             next_alpha)

    if torch.is_grad_enabled():
      return lambda alpha, t: torch.utils.checkpoint.checkpoint(
          step, alpha, t, use_reentrant=False)
    return step

  def _forward_s1(self, wf_params, cache, frames, num_frames, semiring,
                  blank_mask, lexical_mask, lift):
    """Shortest distance of a single-context-state lattice, no frame loop.

    With one context state the alpha carry is one semiring scalar per batch
    element and the alignment's forward step is linear in it, so the
    recursion factorizes:

      alpha_{t+1} = alpha_t (x) f_t,   f_t = forward(one, blank_t, lex_t)

    The forward is then one weight-function application over every frame
    (``_s1_weights``), elementwise semiring algebra for the factors f_t,
    and an inclusive cumulative (x)-product over time for the alpha
    history (``semirings.cumulative_times``, log depth). Under MaxTropical
    the per-frame tie-breaking is the frame loop's: alpha is a common
    factor of every term a frame's ``plus`` compares. Values match the
    frame loop up to float reassociation.

    Args and returns: as ``_forward``, whose S == 1 specialization this is
    (masks and ``lift`` fully supported).
    """
    blank, lexical = self._s1_weights(wf_params, cache, frames,
                                      tuple(num_frames.shape))
    return self._forward_s1_from_weights(blank, lexical, num_frames,
                                         semiring, blank_mask, lexical_mask,
                                         lift)

  def _s1_weights(self, wf_params, cache, frames, batch_dims):
    """One weight-function application over every frame, at state 0.

    The time axis rides as one more batch dimension after ``batch_dims``
    (a ``TableWeightFn`` reads its table's batch dimensions first and
    takes any after them), the state pinned to 0, so the outputs come back
    without a state axis.

    Returns:
      (blank [batch_dims..., T], lexical [batch_dims..., T, vocab_size]).
    """
    state0 = torch.zeros(tuple(batch_dims) + (frames.shape[-2],),
                         dtype=torch.long, device=frames.device)
    return self.weight_fn.apply(wf_params, cache, frames, state0)

  @staticmethod
  def _s1_string_weights_from(blank, lexical, next_labels):
    """String-DP weights as column gathers of the shared S == 1 weights.

    Args:
      blank: [batch_dims..., T] blank weights from ``_s1_weights``.
      lexical: [batch_dims..., T, vocab_size] lexical weights.
      next_labels: [batch_dims..., U+1] next-label ids.

    Returns:
      (blank_weight, lexical_weight), both time-major
      [T, batch_dims..., U+1] (the ``_string_dp`` contract).
    """
    # Label 0 (padding) is clamped to 1: those positions are never final.
    y = next_labels.long().clamp(min=1) - 1  # [batch_dims..., U+1]
    index = y[..., None, :].expand(lexical.shape[:-1] + y.shape[-1:])
    lexical_y = torch.gather(lexical, -1, index)  # [batch..., T, U+1]
    blank_w = blank[..., None].expand(lexical_y.shape)
    return blank_w.movedim(-2, 0), lexical_y.movedim(-2, 0)

  def _forward_s1_from_weights(self, blank, lexical, num_frames, semiring,
                               blank_mask, lexical_mask, lift):
    """The factor algebra and cumulative product of ``_forward_s1`` on
    precomputed per-frame weights (shared with ``_loss_s1``)."""
    num_align_states = self.alignment.num_states()
    batch_dims = tuple(num_frames.shape)
    max_num_frames = blank.shape[-1]
    # Masks are [batch..., T, 1-or-S] and [batch..., T, 1-or-S, 1-or-V]
    # with S == 1: the state axis is dropped.
    blanks = _lift_masked(lift, blank, blank_mask, num_align_states,
                          lambda m: m[..., 0])
    lexicals = _lift_masked(lift, lexical, lexical_mask, num_align_states,
                            lambda m: m[..., 0, :])
    # The total lexical weight out of the one state (FullNGram's
    # forward_reduce at S == 1), once per distinct lifted weight.
    sums = {id(l): semiring.sum(l, axis=-1) for l in lexicals}
    lexical_sums = [sums[id(l)] for l in lexicals]

    # Per-frame total arc weight from a unit alpha: the alignment's forward
    # step at S == 1 on [batch..., T] values.
    if isinstance(self.alignment, alignments.FrameDependent):
      factor = semiring.plus(blanks[0], lexical_sums[0])
    else:  # FrameLabelDependent (``_s1_route`` checks the type).
      terminated = [blanks[0]]
      last = None
      for i in range(self.alignment.max_expansions):
        last = (lexical_sums[i] if last is None else
                semiring.times(last, lexical_sums[i]))
        terminated.append(semiring.times(last, blanks[i + 1]))
      factor = semiring.sum(semirings.stack(terminated), axis=0)

    # Padded frames multiply by the one (the frame loop carries alpha
    # through them unchanged).
    device = blank.device
    dtypes = semirings.value_dtype(factor)
    one = semiring.ones(batch_dims + (max_num_frames,), dtypes, device)
    is_padding = (torch.arange(max_num_frames, device=device) >=
                  num_frames[..., None])
    factor = semirings.where(is_padding, one, factor)

    # Its last entry is alpha_T; shifted right by one frame it is the alpha
    # history ([batch..., T, 1]: the state axis reappears only here).
    cum = semirings.cumulative_times(semiring, factor, len(batch_dims))
    distance = pytree.tree_map(lambda x: x[..., -1], cum)
    init = semiring.ones(batch_dims + (1,), dtypes, device)
    history = pytree.tree_map(
        lambda o, c: torch.cat([o, c[..., :-1]], dim=-1)[..., None], init,
        cum)
    return distance, history

  def _loss_s1(self, params, cache, frames, num_frames, labels, num_labels):
    """The globally normalized S == 1 loss on one weight application.

    The numerator's string weights and the denominator's per-frame factors
    are both functions of the same [batch..., T] blank and [batch..., T, V]
    lexical weights: the weight function runs once, the denominator takes
    the factor algebra of ``_forward_s1`` and the numerator gathers its
    label columns from the same tensors. Autograd differentiates both.
    """
    self._last_path = 's1'
    next_labels = torch.cat([labels, torch.ones_like(labels[..., :1])],
                            dim=-1)
    blank, lexical = self._s1_weights(params['weight_fn'], cache, frames,
                                      tuple(num_frames.shape))
    denominator, _ = self._forward_s1_from_weights(
        blank, lexical, num_frames, semirings.Log, None, None, _identity)
    blank_w, lexical_w = self._s1_string_weights_from(blank, lexical,
                                                      next_labels)
    numerator = self._string_dp(blank_w, lexical_w, num_frames, num_labels,
                                semirings.Log)
    return denominator - numerator

  def _forward_backward(self, params, cache, frames, num_frames):
    """Log Z with backward-algorithm gradients: the loss denominator.

    A locally normalized lattice takes the generic route, as its log Z runs
    in XLA in the JAX package.

    Inside the kernels' gates, ``fused_scan.log_partition`` (bigram) or
    ``trigram_scan.log_partition`` (trigram): the CUDA kernels on CUDA
    tensors with bfloat16 head inputs, as the TPU kernels; their plain
    versions in float32 on CPU tensors, as the JAX package off the TPU.
    Outside them, the generic route: the forward loop saving the
    alpha history, and a backward that runs the backward algorithm in
    reverse, recomputing each frame's weights and feeding the
    cotangent-scaled arc marginals through the weight function's VJP.
    """
    num_frames = torch.as_tensor(num_frames, device=frames.device)
    for ops in (fused_scan, trigram_scan):
      if self._kernels_take(ops, frames):
        frame_dependent = isinstance(self.alignment,
                                     alignments.FrameDependent)
        on_card = frames.device.type == 'cuda'
        self._last_path = 'kernel' if on_card else 'plain'
        return ops.log_partition(
            params['weight_fn'], cache, frames, num_frames,
            max_expansions=(0 if frame_dependent else
                            self.alignment.max_expansions),
            frame_dependent=frame_dependent,
            compute_dtype=fused_scan.compute_dtype_for(frames.device))
    if self._s1_route(frames):
      # The factorized forward has no frame loop: plain autograd through
      # its elementwise algebra is what the backward algorithm would do.
      log_z, _ = self._forward(params, cache, frames, num_frames,
                               semirings.Log)
      return log_z
    leaves, spec = pytree.tree_flatten(params['weight_fn'])
    return _GenericLogPartition.apply(self, num_frames, spec, cache, frames,
                                      *leaves)

  @torch.no_grad()
  def _generic_marginals(self, params, frames, num_frames, cache, project):
    """(blank, project(lexical)) arc posteriors of the generic route: the
    forward loop, then the reverse loop with an identity callback; each
    frame's lexical posteriors [batch_dims..., S, V] pass through
    ``project``. With no frames, empty outputs."""
    num_frames = torch.as_tensor(num_frames, device=frames.device)
    if cache is None:
      cache = self.build_cache(params)
    log_z, alpha_history = self._forward(params, cache, frames, num_frames,
                                         semirings.Log)
    _, marginals = self._backward(
        params, cache, frames, num_frames, log_z, alpha_history, None,
        lambda weight_vjp_fn, carry, blank_marginal, lexical_marginals: (
            carry, (blank_marginal, project(lexical_marginals))))
    if marginals is None:
      num_states, vocab = self.context.shape()
      empty = frames.new_zeros(tuple(num_frames.shape) + (0, num_states,
                                                          vocab))
      return empty[..., 0], project(empty)
    return marginals

  def _backward(self, params, cache, frames, num_frames, log_z,
                alpha_history, init_callback_carry, callback):
    """Arc marginals under the Log semiring by the backward algorithm.

    A reverse loop over frames. Each frame recomputes its weights with
    autograd recording, forms the arc marginals with
    ``alignment.backward``, and calls ``callback(weight_vjp_fn, carry,
    blank_marginal, lexical_marginals)``, where ``weight_vjp_fn(d_blank,
    d_lexical)`` returns the gradients of (params, cache, frame). Padding
    frames carry beta through and get zero marginals.

    Returns:
      (final callback carry, callback outputs stacked along a batch-major
      time axis, or None when there are no frames).
    """
    batch_dims = tuple(num_frames.shape)
    for name, shape in (('frames', frames.shape[:-2]),
                        ('log_z', log_z.shape),
                        ('alpha_0_to_T_minus_1', alpha_history.shape[:-2])):
      if tuple(shape) != batch_dims:
        raise ValueError(f'{name} and num_frames have different batch_dims: '
                         f'{tuple(shape)} vs {batch_dims}')
    num_align_states = self.alignment.num_states()
    leaves, spec = pytree.tree_flatten(params['weight_fn'])
    beta = semirings.Log.ones(batch_dims + (self.context.shape()[0],),
                              log_z.dtype, log_z.device)
    carry, outputs = init_callback_carry, []
    for t in range(frames.shape[-2] - 1, -1, -1):
      with torch.enable_grad():
        # A None cache (``NullCacher``) has no gradient.
        inputs = [x if x is None else x.detach().requires_grad_() for x in
                  leaves + [cache, frames[..., t, :]]]
        blank, lexical = self.weight_fn.apply(
            pytree.tree_unflatten(inputs[:-2], spec), *inputs[-2:])

      def weight_vjp_fn(d_blank, d_lexical, blank=blank, lexical=lexical,
                        inputs=inputs):
        wrt = [x for x in inputs if x is not None]
        if blank.requires_grad or lexical.requires_grad:
          grads = iter(torch.autograd.grad(
              (blank, lexical), wrt, (d_blank, d_lexical),
              allow_unused=True))
        else:  # a weight function with no differentiable input
          grads = iter([None] * len(wrt))
        grads = [None if x is None else next(grads) for x in inputs]
        grads = [d if x is None or d is not None else torch.zeros_like(x)
                 for d, x in zip(grads, inputs)]
        return pytree.tree_unflatten(grads[:-2], spec), grads[-2], grads[-1]

      blank, lexical = blank.detach(), lexical.detach()
      next_beta, blank_marginals, lexical_marginals = self.alignment.backward(
          alpha=alpha_history[..., t, :], blank=[blank] * num_align_states,
          lexical=[lexical] * num_align_states, beta=beta, log_z=log_z,
          context=self.context)
      # Weight functions are alignment-state-invariant: the total marginal
      # per (state, label) sums over alignment states.
      is_padding = (t >= num_frames)[..., None]
      blank_marginal = torch.where(is_padding, 0.0, sum(blank_marginals))
      lexical_marginal = torch.where(is_padding[..., None], 0.0,
                                     sum(lexical_marginals))
      beta = torch.where(is_padding, beta, next_beta)
      carry, out = callback(weight_vjp_fn=weight_vjp_fn, carry=carry,
                            blank_marginal=blank_marginal,
                            lexical_marginals=lexical_marginal)
      outputs.append(out)
    if not outputs:
      return carry, None
    outputs.reverse()
    stacked = pytree.tree_map(
        lambda *xs: torch.stack(xs, dim=len(batch_dims)), *outputs)
    return carry, stacked


class _GenericLogPartition(torch.autograd.Function):
  """The generic route's log Z with its backward-algorithm gradient."""

  @staticmethod
  def forward(ctx, lattice, num_frames, spec, cache, frames, *leaves):
    params = {'weight_fn': pytree.tree_unflatten(list(leaves), spec)}
    log_z, alpha_history = lattice._forward(params, cache, frames,
                                            num_frames, semirings.Log)
    ctx.lattice, ctx.spec = lattice, spec
    ctx.save_for_backward(num_frames, cache, frames, log_z, alpha_history,
                          *leaves)
    return log_z

  @staticmethod
  def backward(ctx, g):
    num_frames, cache, frames, log_z, alpha_history, *leaves = (
        ctx.saved_tensors)
    wf_params = pytree.tree_unflatten(leaves, ctx.spec)

    def accumulate(weight_vjp_fn, carry, blank_marginal, lexical_marginals):
      d_params, d_cache, d_frame = weight_vjp_fn(
          g[..., None] * blank_marginal,
          g[..., None, None] * lexical_marginals)
      add = lambda a, b: None if a is None else a + b
      return pytree.tree_map(add, carry, (d_params, d_cache)), d_frame

    init = pytree.tree_map(
        lambda x: None if x is None else torch.zeros_like(x),
        (wf_params, cache))
    (d_params, d_cache), d_frames = ctx.lattice._backward(
        {'weight_fn': wf_params}, cache, frames, num_frames, log_z,
        alpha_history, init, accumulate)
    if d_frames is None:
      d_frames = torch.zeros_like(frames)
    return (None, None, None, d_cache, d_frames,
            *pytree.tree_leaves(d_params))


def _identity(w):
  return w


def _lift_masked(lift, weights, masks, num_align_states, frame_of):
  """Each alignment state's lifted weights: ``lift(weights +
  frame_of(mask))`` per mask, or with no masks one ``lift(weights)``
  shared by every state (weight functions are alignment-state-invariant)."""
  if masks is None:
    return [lift(weights)] * num_align_states
  return [lift(weights + frame_of(m)) for m in masks]


def _lifted_dtype(lift, weights: torch.Tensor):
  """The dtypes of semiring values that ``lift`` makes of weights like
  ``weights`` (a pytree for a tuple-valued semiring)."""
  return semirings.value_dtype(
      lift(torch.zeros((), dtype=weights.dtype, device=weights.device)))


def _init_context_state_weights(batch_dims, num_states: int, start: int,
                                semiring, dtype, device):
  """One-hot start-state alpha_0 in any semiring (``dtype`` a pytree of
  dtypes for a tuple-valued one)."""
  is_start = torch.arange(num_states, device=device) == start
  weights = semirings.where(is_start, semiring.ones((), dtype, device),
                            semiring.zeros((), dtype, device))
  return pytree.tree_map(
      lambda w: w.expand(tuple(batch_dims) + (num_states,)), weights)


def _gumbel_source(generator, batch_dims, device):
  """The sampler's uniform noise from an explicit generator, or from one
  generator per batch row.

  Returns ``noise(frames, draws, m, n)`` -> [frames, draws, batch_dims...,
  m, n] uniform noise in [0, 1). With one generator per row, row i's noise
  is drawn from generator i alone, chunk by chunk in frame order, so it
  depends on that generator and the shapes only (not on the other rows).
  """
  device = torch.device(device)
  if isinstance(generator, torch.Generator):
    generators = None
    if generator.device.type != device.type:
      raise ValueError(f'the generator is on {generator.device}, the frames '
                       f'on {device}')
  else:
    generators = list(generator)
    if len(batch_dims) != 1 or len(generators) != batch_dims[0]:
      raise ValueError(
          f'{len(generators)} per-row generators for batch_dims '
          f'{batch_dims}: one generator per row needs one batch dimension')
    for g in generators:
      if g.device.type != device.type:
        raise ValueError(f'a row generator is on {g.device}, the frames on '
                         f'{device}')

  def noise(frames, draws, m, n):
    if generators is None:
      return torch.rand((frames, draws) + tuple(batch_dims) + (m, n),
                        generator=generator, device=device)
    if not generators:
      return torch.rand((frames, draws, 0, m, n), device=device)
    return torch.stack([torch.rand((frames, draws, m, n), generator=g,
                                   device=device) for g in generators], dim=2)

  return noise
