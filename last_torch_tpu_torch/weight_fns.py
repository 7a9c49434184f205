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

"""Weight functions (neural arc weights), PyTorch port.

Counterpart of ``last_torch_tpu/weight_fns.py``: the interfaces
``WeightFn`` and ``WeightFnCacher`` that every weight function and cacher
subclasses (a user's own too: one that defines only ``init`` / ``apply``
inherits ``label_weights``, which returns None, and gets its string weights
from the lattice's generic per-position route); ``JointWeightFn`` and
``SharedEmbCacher``, with parameters as plain dictionaries of tensors laid
out exactly as the JAX pytrees (so ``convert.from_jax_params`` maps one onto
the other), and ``JointWeightFn.label_weights``, the numerator's
column-gather fast path; the local normalizers ``hat_normalize`` and
``log_softmax_normalize`` and ``LocallyNormalizedWeightFn``, whose
``label_weights`` runs the numerator kernels of ``ops/numerator_scan.py``.
``JointWeightFn.apply`` over every context state runs the joint+head
kernels of ``ops/joint_head.py`` inside their gate. ``NullCacher`` and
``TableWeightFn`` are the fixed-table fakes of the JAX package's tests (the
enumeration oracles of the sampler and the risk). A weight function whose
``label_weights`` returns None (a ``LocallyNormalizedWeightFn`` over a
``JointWeightFn`` subclass or with another normalizer) gets its string
weights from the lattice's generic per-position route. ``SharedRNNCacher``
builds the context embedding table by running the n-gram label histories
through an LSTM (``utils.rnn``); the lattice kernels take its table as they
take ``SharedEmbCacher``'s.
"""

from __future__ import annotations

import abc
import dataclasses
from collections.abc import Callable
from typing import Any, Generic, Optional, TypeVar

import torch
import torch.utils.checkpoint
from torch.nn.functional import logsigmoid
from torch.utils import _pytree as pytree

from last_torch_tpu_torch import initializers
from last_torch_tpu_torch.ops import joint_head, numerator_scan
from last_torch_tpu_torch.utils import rnn

T = TypeVar('T')
Params = dict[str, Any]


class WeightFn(abc.ABC, Generic[T]):
  """Interface for weight functions, the neural arc-weight producers.

  Given one input frame (and optionally one context state), a WeightFn
  emits the blank and lexical arc weights that the lattice DPs consume.
  Each WeightFn is paired with a WeightFnCacher that supplies its
  frame-independent data (e.g. ``JointWeightFn`` with ``SharedEmbCacher``
  or ``SharedRNNCacher``).
  """

  @abc.abstractmethod
  def init(self, generator: torch.Generator, cache: T,
           frame: torch.Tensor) -> Params:
    """Creates the parameters, drawn from ``generator``, given example
    cache and frame inputs (on their device)."""

  @abc.abstractmethod
  def apply(self, params: Params, cache: T, frame: torch.Tensor,
            state: Optional[torch.Tensor] = None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Computes arc weights for a given frame.

    Args:
      params: Parameters from ``init``.
      cache: Cached data from the corresponding WeightFnCacher.
      frame: [batch_dims..., feature_size] input frame.
      state: None or an int tensor broadcastable to [batch_dims...]. If
        None, compute arc weights for all context states. Otherwise,
        compute arc weights for the specified context state.

    Returns:
      (blank, lexical) tuple.

      If state is None:
      - blank: [batch_dims..., num_context_states] blank arc weights.
      - lexical: [batch_dims..., num_context_states, vocab_size] lexical
        arc weights; lexical[..., p, y] is the weight of label y+1 from
        state p.

      If state is not None:
      - blank: [batch_dims...] blank arc weights from ``state``.
      - lexical: [batch_dims..., vocab_size] lexical arc weights.
    """

  def __call__(self, params, cache, frame, state=None):
    return self.apply(params, cache, frame, state)

  def label_weights(self, params, cache, frames, states, next_labels):
    """Optional fast path for string-intersection weights.

    Computes, for every (label position u, frame t), the blank weight and
    the lexical weight of ONE specific label, the quantities that the
    numerator's string DP needs (``RecognitionLattice._string_forward``).
    An implementation can avoid forming the full [*, T, vocab_size]
    lexical tensor per position (e.g. by gathering the needed vocab-head
    column before the joint contraction).

    Args:
      params: Parameters.
      cache: Cache data.
      frames: [batch_dims..., max_num_frames, feature_size] frames.
      states: [batch_dims..., num_positions] int context states.
      next_labels: [batch_dims..., num_positions] int labels in
        [0, vocab_size]; position weights for label 0 may be arbitrary
        (they are masked out downstream).

    Returns:
      None (no fast path; the caller takes the generic route), or (blank,
      lexical), each [batch_dims..., num_positions, max_num_frames].
    """
    del params, cache, frames, states, next_labels
    return None


class WeightFnCacher(abc.ABC, Generic[T]):
  """Interface for weight function cachers."""

  @abc.abstractmethod
  def init(self, generator: torch.Generator, device='cuda') -> Params:
    """Creates the parameters on ``device``: the card unless the caller
    asks for 'cpu'."""

  @abc.abstractmethod
  def apply(self, params: Params) -> T:
    """Builds the cached data (tensors, or None; never a module)."""

  def __call__(self, params):
    return self.apply(params)


@dataclasses.dataclass(frozen=True)
class JointWeightFn(WeightFn[torch.Tensor]):
  r"""Joint network over context embeddings and frames.

  ``blank, lexical = heads(tanh(cache @ context_proj + frame @ frame_proj))``

  Parameters:
  - context_proj: [embedding_size, hidden_size] (no bias)
  - frame_proj: [feature_size, hidden_size] (no bias)
  - blank_w: [hidden_size], blank_b: [] — blank head
  - vocab_w: [hidden_size, vocab_size], vocab_b: [vocab_size] — vocab head

  Attributes:
    vocab_size: Size of the lexical output vocabulary (excluding blank).
    hidden_size: Hidden layer size of the joint network.
    compute_dtype: Optional dtype the matmul inputs are rounded to (e.g.
      torch.bfloat16); products are summed in float32 either way. None keeps
      float32.
  """

  vocab_size: int
  hidden_size: int
  compute_dtype: Optional[torch.dtype] = None

  def _mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[..., i] @ [i, o] -> [..., o], float32 accumulation.

    Rounding the inputs to ``compute_dtype`` and multiplying in float32 is
    JAX's ``preferred_element_type=float32`` product: bf16 x bf16 products
    are exact in float32.
    """
    if self.compute_dtype is not None:
      a = a.to(self.compute_dtype).float()
      b = b.to(self.compute_dtype).float()
    return a @ b

  def init(self, generator: torch.Generator, cache: torch.Tensor,
           frame: torch.Tensor) -> Params:
    """Creates parameters on ``cache``'s device, sized from the inputs."""
    h = self.hidden_size
    device = cache.device

    def dense(shape):
      return initializers.lecun_normal(shape, generator, device)

    return {
        'context_proj': dense((cache.shape[-1], h)),
        'frame_proj': dense((frame.shape[-1], h)),
        'blank_w': dense((h, 1))[:, 0],
        'blank_b': torch.zeros((), device=device),
        'vocab_w': dense((h, self.vocab_size)),
        'vocab_b': torch.zeros((self.vocab_size,), device=device),
    }

  def apply(self, params: Params, cache: torch.Tensor, frame: torch.Tensor,
            state: Optional[torch.Tensor] = None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Arc weights for one frame.

    Args:
      params: Parameters from ``init``.
      cache: [num_context_states, embedding_size] context embeddings.
      frame: [batch_dims..., feature_size] input frame.
      state: None for all context states, or an int tensor broadcastable to
        [batch_dims...] selecting one state per batch element.

    Returns:
      (blank, lexical): [batch_dims..., num_context_states] and
      [batch_dims..., num_context_states, vocab_size] when state is None;
      [batch_dims...] and [batch_dims..., vocab_size] otherwise.

    Inside the gate of ``ops/joint_head.py`` (``state=None``, one batch
    dimension, at least 1024 context states, float32 inputs), the joint and
    both heads run in its kernels on CUDA tensors (the [batch, states,
    hidden] joint is never stored) and in their plain versions on CPU
    tensors; elsewhere the einsums below, as the JAX package takes XLA.
    """
    if joint_head.supported(self, cache, frame, state):
      return joint_head.blank_lexical(self, params, cache, frame)
    if state is None:
      projected_frame = self._mm(frame, params['frame_proj'])[..., None, :]
      projected_context = self._mm(cache, params['context_proj'])
    else:
      state = torch.broadcast_to(state, frame.shape[:-1])
      projected_frame = self._mm(frame, params['frame_proj'])
      projected_context = self._mm(cache[state], params['context_proj'])
    joint = torch.tanh(projected_context + projected_frame)
    blank = self._mm(joint, params['blank_w'][:, None])[..., 0] + params[
        'blank_b']
    lexical = self._mm(joint, params['vocab_w']) + params['vocab_b']
    return blank, lexical

  def label_weights(self, params: Params, cache: torch.Tensor,
                    frames: torch.Tensor, states: torch.Tensor,
                    next_labels: torch.Tensor):
    """Blank and one-label lexical weights per (label position, frame).

    The numerator's fast path: the lexical weight of one known label is
    joint . vocab_w[:, y], so the vocab-head column is gathered first and
    contracted, O(h) per (position, frame) instead of the O(h * V) head.
    Each position's step is recomputed in the backward pass
    (``torch.utils.checkpoint``), as the JAX package rematerializes it:
    saving the [batch, T, h] joint of every position would cost
    U+1 times its size.

    Args:
      params: Parameters from ``init``.
      cache: [num_context_states, embedding_size] context embeddings.
      frames: [batch_dims..., max_num_frames, feature_size] frames.
      states: [batch_dims..., num_positions] int context states.
      next_labels: [batch_dims..., num_positions] int labels in
        [0, vocab_size] (weights for label 0 are arbitrary).

    Returns:
      (blank, lexical), each [batch_dims..., num_positions, max_num_frames].
    """
    y = next_labels.long().clamp(min=1) - 1
    projected_frames = self._mm(frames, params['frame_proj'])
    projected_context = self._mm(cache, params['context_proj'])[states.long()]
    vocab_cols = params['vocab_w'].t()[y]  # [batch..., U1, h]
    vocab_bias = params['vocab_b'][y]  # [batch..., U1]
    blank_w, blank_b = params['blank_w'], params['blank_b']

    def per_position(pc_u, w_u, b_u):
      joint = torch.tanh(pc_u[..., None, :] + projected_frames)
      blank = self._mm(joint, blank_w[:, None])[..., 0] + blank_b
      lexical = torch.einsum('...th,...h->...t', joint, w_u) + b_u[..., None]
      return blank, lexical

    if torch.is_grad_enabled():
      step = lambda *a: torch.utils.checkpoint.checkpoint(
          per_position, *a, use_reentrant=False)
    else:
      step = per_position
    outputs = [step(projected_context[..., u, :], vocab_cols[..., u, :],
                    vocab_bias[..., u])
               for u in range(y.shape[-1])]
    blank = torch.stack([b for b, _ in outputs], dim=-2)
    lexical = torch.stack([l for _, l in outputs], dim=-2)
    return blank, lexical


def hat_normalize(blank: torch.Tensor, lexical: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
  """Local normalization of the Hybrid Autoregressive Transducer.

  The sigmoid of the blank weight is the probability of blank; lexical
  probabilities share the remaining mass through a log-softmax. Log-sigmoid
  keeps it finite for large blank weights.

  Args:
    blank: [batch_dims...] blank weight.
    lexical: [batch_dims..., vocab_size] lexical weights.

  Returns:
    Normalized (blank, lexical), with exp(blank) + sum(exp(lexical)) == 1.
  """
  normalized_blank = logsigmoid(blank)
  normalized_lexical = (torch.log_softmax(lexical, dim=-1) +
                        logsigmoid(-blank)[..., None])
  return normalized_blank, normalized_lexical


def log_softmax_normalize(blank: torch.Tensor, lexical: torch.Tensor
                          ) -> tuple[torch.Tensor, torch.Tensor]:
  """Joint log-softmax: one distribution over the 1 + vocab_size arcs.

  Args:
    blank: [batch_dims...] blank weight.
    lexical: [batch_dims..., vocab_size] lexical weights.

  Returns:
    Normalized (blank, lexical) log-probabilities.
  """
  all_weights = torch.log_softmax(
      torch.cat([blank[..., None], lexical], dim=-1), dim=-1)
  return all_weights[..., 0], all_weights[..., 1:]


class LocallyNormalizedWeightFn(WeightFn[T]):
  """Wraps a weight function into a locally normalized one.

  The type is load-bearing: ``RecognitionLattice.loss`` skips the
  denominator for it (the loss is -numerator), and ``shortest_path``
  unwraps a ``JointWeightFn`` under ``hat_normalize`` or
  ``log_softmax_normalize`` into the Viterbi kernel's in-kernel
  normalization.

  Attributes:
    weight_fn: The underlying weight function.
    normalize: Maps (blank, lexical) weights to normalized
      log-probabilities, e.g. ``hat_normalize`` or ``log_softmax_normalize``.
  """

  def __init__(self, weight_fn, normalize: Callable[
      [torch.Tensor, torch.Tensor], tuple[torch.Tensor, torch.Tensor]]
               = hat_normalize):
    self.weight_fn = weight_fn
    self.normalize = normalize

  def init(self, generator: torch.Generator, cache: torch.Tensor,
           frame: torch.Tensor) -> Params:
    return self.weight_fn.init(generator, cache, frame)

  def apply(self, params: Params, cache: torch.Tensor, frame: torch.Tensor,
            state: Optional[torch.Tensor] = None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    blank, lexical = self.weight_fn.apply(params, cache, frame, state)
    return self.normalize(blank, lexical)

  def label_weights(self, params: Params, cache: torch.Tensor,
                    frames: torch.Tensor, states: torch.Tensor,
                    next_labels: torch.Tensor):
    """Normalized blank and one-label weights per (label position, frame).

    The locally normalized numerator: the full vocabulary head runs for
    every (position, frame) to give the local normalizer, and only the
    normalized weights of blank and the next label are kept. It runs the
    numerator kernels of ``ops/numerator_scan.py`` (their plain frame-major
    versions on CPU tensors), which save no frame's [batch..., U+1, V]
    logits for the backward pass; the compute type must be None, float32
    or bfloat16.

    Returns:
      None when the inner weight function is not exactly ``JointWeightFn``
      or the normalizer is neither of the two above; otherwise (blank,
      lexical), each [batch_dims..., num_positions, max_num_frames].
    """
    wf = self.weight_fn
    if type(wf) is not JointWeightFn:
      return None
    if self.normalize not in (hat_normalize, log_softmax_normalize):
      return None
    return numerator_scan.label_weights(
        wf, params, cache, frames, states, next_labels,
        hat=self.normalize is hat_normalize)


@dataclasses.dataclass(frozen=True)
class SharedEmbCacher(WeightFnCacher[torch.Tensor]):
  """A learned, independent per-state context embedding table.

  Attributes:
    num_context_states: Number of context states.
    embedding_size: Embedding dimension.
  """

  num_context_states: int
  embedding_size: int

  def init(self, generator: torch.Generator, device='cuda') -> Params:
    """The embedding table on ``device``: the card unless the caller asks
    for 'cpu'."""
    return {
        'embedding':
            initializers.normal(
                (self.num_context_states, self.embedding_size), generator,
                device)
    }

  def apply(self, params: Params) -> torch.Tensor:
    return params['embedding']


class SharedRNNCacher(WeightFnCacher[torch.Tensor]):
  """Builds a context embedding table by running n-gram labels through an RNN.

  For a ``FullNGram`` context, whose ``num_context_states = sum(vocab_size**i
  for i in range(context_size + 1))``. Rows follow FullNGram's
  lexicographic state ids: the start token's output first, then each n-gram
  level, from the previous level's RNN state repeated vocab_size times and
  fed the label embeddings. The rows are the cell *outputs*, level by level,
  as in the JAX package.

  Attributes:
    vocab_size: Lexical vocabulary size.
    context_size: Maximum n-gram order.
    rnn_size: RNN hidden size (the embedding table width).
    rnn_embedding_size: Label embedding size fed to the RNN.
    rnn_cell: Optional custom RNN cell; defaults to ``utils.rnn.LSTMCell``.
  """

  def __init__(self, vocab_size: int, context_size: int, rnn_size: int,
               rnn_embedding_size: int,
               rnn_cell: Optional[rnn.RNNCellBase] = None):
    self.vocab_size = vocab_size
    self.context_size = context_size
    self.rnn_size = rnn_size
    self.rnn_embedding_size = rnn_embedding_size
    self.rnn_cell = rnn_cell or rnn.LSTMCell(
        input_size=rnn_embedding_size, hidden_size=rnn_size)

  def init(self, generator: torch.Generator, device='cuda') -> Params:
    """Label embeddings and the cell's parameters on ``device``: the card
    unless the caller asks for 'cpu'."""
    return {
        'embedding': initializers.normal(
            (self.vocab_size + 1, self.rnn_embedding_size), generator,
            device),
        'cell': self.rnn_cell.init(generator, device),
    }

  def apply(self, params: Params) -> torch.Tensor:
    embedding, cell_params = params['embedding'], params['cell']
    cell, v = self.rnn_cell, self.vocab_size
    device = embedding.device
    # Start (empty n-gram) state: the start token 0 from the zero state.
    state = cell.initial_state(1, embedding.dtype, device)
    out, state = cell.apply(cell_params, embedding[:1], state)
    parts = [out]
    labels = torch.arange(1, v + 1, device=device)
    for i in range(self.context_size):
      # Level i+1 lists the (i+1)-grams in lexicographic order: parent
      # state k // v with label k % v + 1.
      inputs = embedding[labels.repeat(v**i)]
      tiled = pytree.tree_map(lambda s: s.repeat_interleave(v, dim=0), state)
      out, state = cell.apply(cell_params, inputs, tiled)
      parts.append(out)
    return torch.cat(parts, dim=0)


class NullCacher(WeightFnCacher[type(None)]):
  """A cacher that returns None: the cache of ``TableWeightFn``."""

  def init(self, generator: torch.Generator, device='cuda') -> Params:
    del generator, device
    return {}

  def apply(self, params: Params) -> None:
    del params
    return None


class TableWeightFn(WeightFn[type(None)]):
  """Weight function that looks up a fixed table; for tests.

  Attributes:
    table: [batch_dims..., input_vocab_size, num_context_states,
      1 + vocab_size] arc weight table. For each input frame, element 0 of
      the feature vector is cast to an integer "input label" that picks the
      weights: blank arc weights at ``table[..., 0]``, lexical arcs at
      ``table[..., 1:]``. A table that requires grad passes its gradient
      through the lookups.
  """

  def __init__(self, table):
    self.table = torch.as_tensor(table)

  def init(self, generator: torch.Generator, cache, frame) -> Params:
    del generator, cache, frame
    return {}

  def apply(self, params: Params, cache, frame: torch.Tensor,
            state: Optional[torch.Tensor] = None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Arc weights for one frame, by exact gathers.

    ``frame`` is [batch_dims..., extra..., feature_size]: its leading dims
    are the table's batch_dims, and any dims after them (the sampler's
    sample axis, its frames and expansions) index the same table row.
    ``state`` is None for every context state, or an int tensor
    broadcastable to ``frame.shape[:-1]``.
    """
    del params, cache
    *batch_dims, _, num_context_states, _ = self.table.shape
    batch_dims = tuple(batch_dims)
    nb = len(batch_dims)
    if tuple(frame.shape[:nb]) != batch_dims or frame.ndim < nb + 1:
      raise ValueError(f'frame should have batch_dims={batch_dims} but '
                       f'got ({tuple(frame.shape[:-1])})')
    extra = tuple(frame.shape[nb:-1])
    table = self.table.to(frame.device)
    # [batch..., 1..., input_vocab, S, 1+V] against [batch..., extra...].
    table = table.reshape(batch_dims + (1,) * len(extra) + table.shape[nb:])
    input_label = frame[..., 0].long()
    index = input_label[..., None, None, None].expand(
        frame.shape[:-1] + (1,) + table.shape[-2:])
    weights = torch.gather(table.expand(frame.shape[:-1] + table.shape[-3:]),
                           -3, index)[..., 0, :, :]  # [batch..., S, 1+V]
    if state is not None:
      state = torch.broadcast_to(torch.as_tensor(state, device=frame.device),
                                 frame.shape[:-1]).long()
      weights = torch.gather(
          weights, -2, state[..., None, None].expand(
              state.shape + (1, weights.shape[-1])))[..., 0, :]
    return weights[..., 0], weights[..., 1:]

  def label_weights(self, params: Params, cache, frames: torch.Tensor,
                    states: torch.Tensor, next_labels: torch.Tensor):
    """Blank and one-label lexical weights per (label position, frame): the
    lookups of the JAX package's generic per-position route, exact.

    Args:
      frames: [batch_dims..., max_num_frames, feature_size] frames.
      states: [batch_dims..., num_positions] int context states.
      next_labels: [batch_dims..., num_positions] int labels in
        [0, vocab_size] (weights for label 0 are arbitrary).

    Returns:
      (blank, lexical), each [batch_dims..., num_positions, max_num_frames].
    """
    u1, max_t = states.shape[-1], frames.shape[-2]
    frame = frames[..., None, :, :].expand(
        frames.shape[:-2] + (u1,) + frames.shape[-2:])
    state = states[..., None].expand(states.shape + (max_t,))
    blank, lexical = self.apply(params, cache, frame, state)
    y = (next_labels.long().clamp(min=1) - 1)[..., None, None].expand(
        state.shape + (1,))
    return blank, torch.gather(lexical, -1, y)[..., 0]
