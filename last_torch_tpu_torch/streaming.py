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

"""Frame-synchronous streaming decoding, PyTorch port.

Counterpart of ``last_torch_tpu/streaming.py``: ``StreamingGreedyDecoder``,
``StreamingBeamDecoder`` (with hypothesis recombination) and
``nbest_offline`` over a ``RecognitionLattice``'s alignment, context and
weight function. Each frame queries ``weight_fn.apply(..., state=ctx)`` at
the carried context states: O(batch * hidden) work a query, no
[batch, states, vocab] tensor. A query with ``state`` lies outside the
joint+head kernels' gate, as it lies outside the Pallas kernels in the JAX
package: its [rows, h] x [h, V] head product is a plain matmul.

The carried state is exact, so any chunking of the same encoded frames
gives the same output. The JAX package's ``lax.scan`` is a Python loop over
the chunk's frames here, with no value read back to the host. Where torch
differs from JAX, the port keeps JAX's results:

* the beam's rolling label hash is uint32 in JAX; it is carried in int64
  here and wrapped to 32 bits after each ``* 1000003 + label``
  (``_rolling_hash``);
* ``jax.lax.top_k`` puts the lowest index first among equal values, where
  ``torch.topk`` promises no order; ``_top_k`` takes a stable descending
  sort, and the argsorts of the recombination are stable, as
  ``jnp.argsort`` is.
"""

from __future__ import annotations

import warnings
from typing import Any, Optional

import torch

from last_torch_tpu_torch import alignments as alignments_lib

_HASH_MULTIPLIER = 1000003
_HASH_MASK = 0xFFFFFFFF
# nbest_offline's default label capacity is the frames' bound capped here.
_DEFAULT_MAX_LABELS = 512


def _rolling_hash(old: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
  """uint32 ``old * 1000003 + label`` in int64: the product of a 32-bit
  hash and the multiplier stays below 2**52."""
  return (old * _HASH_MULTIPLIER + label.long()) & _HASH_MASK


def _top_k(x: torch.Tensor, k: int):
  """(values, indices) of the k largest along the last axis, the lowest
  index first among equal values (``jax.lax.top_k``'s order)."""
  values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
  return values[..., :k], indices[..., :k]


def _take(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
  """``take_along_axis(x, index, axis=1)`` with ``index`` [B, N] broadcast
  over x's trailing axes."""
  index = index.reshape(index.shape + (1,) * (x.ndim - 2)).expand(
      index.shape + x.shape[2:])
  return torch.gather(x, 1, index)


def _max_expansions(alignment, what: str) -> Optional[int]:
  """None for FrameDependent, k for FrameLabelDependent(k)."""
  if isinstance(alignment, alignments_lib.FrameDependent):
    return None
  if isinstance(alignment, alignments_lib.FrameLabelDependent):
    return alignment.max_expansions
  raise NotImplementedError(
      f'{what} not supported for {type(alignment).__name__}')


class StreamingGreedyDecoder:
  """Greedy frame-synchronous decoder over a RecognitionLattice.

  Per frame it emits the best lexical label while that beats blank (up to
  the alignment's expansion budget). The output layout is
  ``RecognitionLattice.shortest_path``'s: each frame contributes
  ``alignment.num_states()`` label slots (lexical labels in emission order,
  0 for unused slots).
  """

  def __init__(self, lattice):
    self.lattice = lattice
    expansions = _max_expansions(lattice.alignment, 'streaming decode')
    self._max_emissions = 1 if expansions is None else expansions
    self._force_trailing_blank = expansions is not None
    self._slots_per_frame = lattice.alignment.num_states()

  @property
  def slots_per_frame(self) -> int:
    return self._slots_per_frame

  def init_state(self, batch_size: int, device='cuda') -> torch.Tensor:
    """The context-DFA start state per stream, on ``device`` (the card
    unless the caller asks for 'cpu')."""
    return torch.full((batch_size,), self.lattice.context.start(),
                      dtype=torch.int32, device=device)

  @torch.no_grad()
  def step(self, params, state: torch.Tensor, frames: torch.Tensor,
           num_frames, cache: Any = None):
    """Decodes one chunk of encoded frames.

    Args:
      params: Lattice parameters.
      state: [batch] context states from ``init_state`` or the previous
        chunk.
      frames: [batch, chunk_len, feature] encoded frames.
      num_frames: [batch] number of valid frames in this chunk; frames past
        it leave the state alone and emit 0.
      cache: Optional prebuilt weight-function cache (pass
        ``lattice.build_cache(params)`` once per stream).

    Returns:
      (new_state, labels [batch, chunk_len * slots_per_frame] int32,
      num_labels = slots_per_frame * num_frames).
    """
    lattice = self.lattice
    if cache is None:
      cache = lattice.build_cache(params)
    device = frames.device
    num_frames = torch.as_tensor(num_frames, device=device).to(torch.int32)
    batch, chunk_len = frames.shape[:2]
    wf_params = params['weight_fn']
    valid = (torch.arange(chunk_len, device=device)[None, :] <
             num_frames[:, None])  # [B, C]
    q = state
    frame_slots = []
    for t in range(chunk_len):
      frame = frames[:, t]
      open_ = valid[:, t]  # may still emit a lexical label this frame
      slots = []
      for _ in range(self._max_emissions):
        blank, lexical = lattice.weight_fn.apply(wf_params, cache, frame,
                                                 state=q)
        best = torch.argmax(lexical, dim=-1)
        best_w = torch.gather(lexical, -1, best[:, None])[:, 0]
        emit = open_ & (best_w > blank)
        label = torch.where(emit, best + 1, 0).to(torch.int32)
        q = torch.where(emit, lattice.context.next_state(q, label),
                        q).to(state.dtype)
        slots.append(label)
        open_ = open_ & emit
      if self._force_trailing_blank:
        slots.append(torch.zeros((batch,), dtype=torch.int32, device=device))
      frame_slots.append(torch.stack(slots, dim=-1))  # [B, slots]
    labels = torch.stack(frame_slots, dim=1).reshape(batch, -1)
    return q, labels, self._slots_per_frame * num_frames


class StreamingBeamDecoder:
  """Time-synchronous beam search over a RecognitionLattice.

  Per frame each of ``beam_size`` hypotheses takes the blank arc or extends
  by a lexical label; FrameLabelDependent frames prune back to
  ``beam_size`` after every within-frame expansion. State is
  O(batch * beam * max_labels), and chunk boundaries change nothing.
  Hypotheses carry plain label sequences; ``best`` gives the top one.

  After each frame, hypotheses with the same label sequence (hence the same
  context state) are merged: ``merge='max'`` (default) keeps the best path
  score (Viterbi semantics, comparable to ``shortest_path``),
  ``'logsumexp'`` sums their probability, ``'none'`` does not merge.
  """

  def __init__(self, lattice, beam_size: int, max_labels: int,
               merge: str = 'max'):
    if beam_size < 1:
      raise ValueError(f'beam_size must be >= 1, got {beam_size}')
    if merge not in ('max', 'logsumexp', 'none'):
      raise ValueError(f"merge should be 'max', 'logsumexp' or 'none', "
                       f'but got {merge!r}')
    self.lattice = lattice
    self.beam_size = beam_size
    self.max_labels = max_labels
    self.merge = merge
    self._max_expansions = _max_expansions(lattice.alignment, 'beam decode')

  def init_state(self, batch_size: int, device='cuda') -> dict:
    """One live hypothesis (score 0, no labels) and beam_size - 1 at -inf
    per stream, on ``device`` (the card unless the caller asks for 'cpu').
    ``hash`` is the rolling hash of the label sequence, updated O(1) per
    append; recombination sorts on it so equal sequences are adjacent."""
    k, u = self.beam_size, self.max_labels
    score = torch.full((batch_size, k), float('-inf'), device=device)
    score[:, 0] = 0.0
    int_zeros = lambda *shape: torch.zeros(shape, dtype=torch.int32,
                                           device=device)
    return {
        'context': torch.full((batch_size, k), self.lattice.context.start(),
                              dtype=torch.int32, device=device),
        'score': score,
        'labels': int_zeros(batch_size, k, u),
        'num_labels': int_zeros(batch_size, k),
        'hash': torch.zeros((batch_size, k), dtype=torch.int64,
                            device=device),
    }

  def best(self, state: dict):
    """Top hypothesis per stream: (labels, num_labels, score)."""
    labels, num_labels, score = self.nbest(state, 1)
    return labels[:, 0], num_labels[:, 0], score[:, 0]

  def nbest(self, state: dict, n: int):
    """Top-n hypotheses per stream, score-sorted: each [batch, n, ...]."""
    if not 1 <= n <= self.beam_size:
      raise ValueError(f'n must be in [1, beam_size={self.beam_size}], '
                       f'got {n}')
    score, idx = _top_k(state['score'], n)
    return _take(state['labels'], idx), _take(state['num_labels'], idx), score

  def _append(self, hyp: dict, parent: torch.Tensor,
              label: torch.Tensor) -> dict:
    """Gathers the parents' fields and appends one label (clamped at
    max_labels)."""
    u = self.max_labels
    ctx = _take(hyp['context'], parent)
    labels, nlab = _take(hyp['labels'], parent), _take(hyp['num_labels'],
                                                       parent)
    old_hash = _take(hyp['hash'], parent)
    pos = torch.clamp(nlab, max=u - 1)
    grows = nlab < u
    write = ((torch.arange(u, device=label.device)[None, None, :] ==
              pos[:, :, None]) & grows[:, :, None])
    return {
        'context': self.lattice.context.next_state(ctx, label).to(
            ctx.dtype),
        'labels': torch.where(write, label[:, :, None], labels),
        'num_labels': torch.clamp(nlab + 1, max=u),
        'hash': torch.where(grows, _rolling_hash(old_hash, label), old_hash),
    }

  def _recombine(self, pool: dict) -> dict:
    """Merges hypotheses with identical label sequences.

    Duplicates (same labels, count and context state) collapse onto one
    survivor, its score max'ed or logsumexp'ed per ``merge``, and the other
    copies drop to -inf, so top-k never spends two beam slots on one
    sequence. Sort-based, O(M log M + M * U) a frame: the pool sorts by
    (hash, num_labels, context), so identical sequences are adjacent, and
    one comparison of neighbours delimits the groups. A 32-bit hash
    collision between unequal neighbours can only split a group (a missed
    merge), never merge unequal sequences: the full comparison gates every
    merge.
    """
    if self.merge == 'none':
      return pool
    batch, m = pool['score'].shape
    num_states, _ = self.lattice.context.shape()
    # Two stable argsorts compose into the lexicographic order.
    secondary = (pool['num_labels'].long() * num_states +
                 pool['context'].long())
    order1 = torch.argsort(secondary, dim=1, stable=True)
    order2 = torch.argsort(torch.gather(pool['hash'], 1, order1), dim=1,
                           stable=True)
    order = torch.gather(order1, 1, order2)
    pool = {f: _take(v, order) for f, v in pool.items()}
    score = pool['score']
    same_prev = (
        (pool['hash'][:, 1:] == pool['hash'][:, :-1]) &
        (pool['num_labels'][:, 1:] == pool['num_labels'][:, :-1]) &
        (pool['context'][:, 1:] == pool['context'][:, :-1]) &
        torch.all(pool['labels'][:, 1:] == pool['labels'][:, :-1], dim=-1))
    is_new = torch.cat([torch.ones((batch, 1), dtype=torch.bool,
                                   device=score.device), ~same_prev], dim=1)
    gid = torch.cumsum(is_new.long(), dim=1) - 1  # [B, M]
    gmax = torch.full((batch, m), float('-inf'), device=score.device)
    gmax = gmax.scatter_reduce(1, gid, score, 'amax')
    if self.merge == 'logsumexp':
      shift = torch.gather(gmax, 1, gid)
      safe = torch.where(torch.isfinite(shift), shift, 0.0)
      gsum = torch.zeros((batch, m), device=score.device).scatter_add(
          1, gid, torch.exp(score - safe))
      gmerged = torch.where(
          gsum > 0,
          torch.where(torch.isfinite(gmax), gmax, 0.0) + torch.log(gsum),
          float('-inf'))
    else:
      gmerged = gmax
    new_score = torch.where(is_new, torch.gather(gmerged, 1, gid),
                            float('-inf'))
    return {**pool, 'score': new_score}

  def _top_k_merge(self, pools: list[dict]) -> dict:
    """Top beam_size over the concatenated candidate pools."""
    merged = {f: torch.cat([p[f] for p in pools], dim=1) for f in pools[0]}
    merged = self._recombine(merged)
    best_score, idx = _top_k(merged.pop('score'), self.beam_size)
    return {'score': best_score,
            **{f: _take(v, idx) for f, v in merged.items()}}

  def _expand_lexical(self, hyp: dict, lex: torch.Tensor) -> dict:
    """Top beam_size lexical extensions of a frontier. lex: [B, K, V].

    Hypotheses that already hold ``max_labels`` labels cannot extend: their
    lexical candidates score -inf, so scores always belong to the returned
    (complete) label sequences; they survive through the blank arc only.
    """
    batch, vocab = lex.shape[0], lex.shape[-1]
    full = (hyp['num_labels'] >= self.max_labels)[:, :, None]
    cand = torch.where(full, float('-inf'),
                       hyp['score'][:, :, None] + lex).reshape(batch, -1)
    score, idx = _top_k(cand, self.beam_size)
    parent = idx // vocab
    label = (idx % vocab + 1).to(torch.int32)
    return {'score': score, **self._append(hyp, parent, label)}

  @torch.no_grad()
  def step(self, params, state: dict, frames: torch.Tensor, num_frames,
           cache: Any = None) -> dict:
    """Advances the beams over one chunk of encoded frames ([batch,
    chunk_len, feature]); frames past ``num_frames`` leave a stream's beams
    alone."""
    lattice = self.lattice
    if cache is None:
      cache = lattice.build_cache(params)
    device = frames.device
    num_frames = torch.as_tensor(num_frames, device=device)
    batch, chunk_len = frames.shape[:2]
    wf_params = params['weight_fn']
    valid = (torch.arange(chunk_len, device=device)[None, :] <
             num_frames[:, None])

    def query(ctx, frame):
      frame_k = frame[:, None, :].expand(batch, ctx.shape[1], frame.shape[-1])
      return lattice.weight_fn.apply(wf_params, cache, frame_k, state=ctx)

    steps = 1 if self._max_expansions is None else self._max_expansions
    for t in range(chunk_len):
      frame, carry = frames[:, t], state
      frontier, terminated = carry, []
      for j in range(steps + 1):
        blank, lex = query(frontier['context'], frame)
        terminated.append({**frontier, 'score': frontier['score'] + blank})
        if self._max_expansions is None:
          # FrameDependent: one lexical label ends the frame (no trailing
          # blank), so lexical extensions are terminal too.
          terminated.append(self._expand_lexical(frontier, lex))
          break
        if j < steps:
          frontier = self._expand_lexical(frontier, lex)
      new = self._top_k_merge(terminated)
      keep = valid[:, t]
      state = {f: torch.where(keep.reshape((batch,) + (1,) *
                                           (new[f].ndim - 1)),
                              new[f], carry[f]) for f in carry}
    return state


def nbest_offline(lattice, params, frames: torch.Tensor, num_frames, *,
                  beam_size: int, n: Optional[int] = None,
                  max_labels: Optional[int] = None, cache=None):
  """Offline n-best label sequences through one whole-utterance beam pass.

  Runs ``StreamingBeamDecoder`` (with recombination) over the whole encoded
  utterance in one chunk. ``shortest_path`` returns only the best
  alignment; this returns alternatives with their (recombined) scores.

  Args:
    lattice: ``RecognitionLattice``.
    params: Lattice parameters.
    frames: [batch, max_num_frames, feature_size] encoded frames.
    num_frames: [batch] frame counts.
    beam_size: Beam width.
    n: Number of hypotheses to return (default: ``beam_size``).
    max_labels: Label capacity per hypothesis. Default: the frames' bound
      (max_num_frames times the alignment's labels a frame) capped at 512,
      with a warning when the cap bites: recombination carries
      O(pool * max_labels) label state a frame. Pass a budget for longer
      transcripts.
    cache: Optional prebuilt weight function cache.

  Returns:
    (labels [batch, n, max_labels], num_labels [batch, n], scores
    [batch, n]), best first.
  """
  max_t = frames.shape[-2]
  if max_labels is None:
    per_frame = (1 if isinstance(lattice.alignment,
                                 alignments_lib.FrameDependent)
                 else lattice.alignment.max_expansions)
    if max_t * per_frame > _DEFAULT_MAX_LABELS:
      warnings.warn(
          'nbest_offline: default max_labels capped at 512 (frames imply '
          f'up to {max_t * per_frame}); hypotheses longer than 512 labels '
          'will be truncated. Pass max_labels explicitly for long '
          'transcripts.', stacklevel=2)
    max_labels = min(max_t * per_frame, _DEFAULT_MAX_LABELS)
  decoder = StreamingBeamDecoder(lattice, beam_size=beam_size,
                                 max_labels=max_labels)
  state = decoder.init_state(frames.shape[0], device=frames.device)
  state = decoder.step(params, state, frames, num_frames, cache)
  return decoder.nbest(state, n if n is not None else beam_size)
