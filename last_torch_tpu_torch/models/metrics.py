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

"""Recognition-quality metrics: batched edit distance and error rates,
PyTorch port.

Counterpart of ``last_torch_tpu/models/metrics.py``:

* ``edit_distance``: padded batched Levenshtein distance. The DP loops over
  reference positions; each row update is vectorized by rewriting the
  insertion chain ``new[i] = min(base[i], new[i-1] + 1)`` as the min-plus
  prefix scan ``new[i] = i + cummin_{k<=i}(base[k] - k)`` (``torch.cummin``).
* ``ErrorRateState`` / ``update_error_rate``: a summable (total_edits,
  total_ref_labels) accumulator. Sum it across batches or ranks
  (``torch.distributed.all_reduce`` of each field), then divide once: the
  corpus rate is not a mean of per-utterance rates. Totals are int64.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


def edit_distance(hyp, num_hyp, ref, num_ref) -> torch.Tensor:
  """Batched Levenshtein distance between padded label sequences.

  Args:
    hyp: [batch..., max_hyp] int labels; entries beyond ``num_hyp`` are
      ignored (any padding value is fine).
    num_hyp: [batch...] number of valid hypothesis labels.
    ref: [batch..., max_ref] int labels; entries beyond ``num_ref`` are
      ignored.
    num_ref: [batch...] number of valid reference labels.

  Returns:
    [batch...] int32 edit distances (substitutions + insertions +
    deletions) between ``hyp[..., :num_hyp]`` and ``ref[..., :num_ref]``.
  """
  hyp = torch.as_tensor(hyp).long()
  device = hyp.device
  ref = torch.as_tensor(ref, device=device).long()
  num_hyp = torch.as_tensor(num_hyp, device=device).long()
  num_ref = torch.as_tensor(num_ref, device=device).long()
  batch_shape = hyp.shape[:-1]
  u, v = hyp.shape[-1], ref.shape[-1]
  b = batch_shape.numel()
  hyp2 = hyp.reshape(b, u)
  ref2 = ref.reshape(b, v)
  nh = num_hyp.reshape(b, 1)
  nr = num_ref.reshape(1, b)

  # d[j, i] = distance(hyp[:i], ref[:j]). Row j depends only on row j-1,
  # so loop over reference positions; DP entries at (i <= nh, j <= nr)
  # never read padded symbols, so the (nh, nr) entry of the full padded DP
  # is exactly the prefix distance.
  idx = torch.arange(u + 1, device=device)[None, :]  # [1, U+1]
  row = idx.expand(b, u + 1)
  col = [nh[:, 0]]  # col[j][b] = d[j, nh[b]]
  for j in range(1, v + 1):
    cost = (hyp2 != ref2[:, j - 1, None]).long()  # [B, U]
    # base[i] = min(delete ref_j: d[j-1, i] + 1,
    #               substitute:   d[j-1, i-1] + cost_i), base[0] = j.
    base = torch.minimum(row[:, 1:] + 1, row[:, :-1] + cost)
    base = torch.cat([torch.full((b, 1), j, device=device), base], dim=1)
    # The insertion chain as a prefix min-plus scan.
    row = idx + torch.cummin(base - idx, dim=1).values
    col.append(torch.gather(row, 1, nh)[:, 0])
  col = torch.stack(col, dim=0)  # [V+1, B]
  out = torch.gather(col, 0, nr)[0]
  return out.reshape(batch_shape).to(torch.int32)


class ErrorRateState(NamedTuple):
  """Summable corpus error-rate accumulator.

  Add states together (or all-reduce each field across ranks), then call
  ``error_rate`` once: the corpus rate is total_edits / total_ref_labels,
  not a mean of per-utterance rates.
  """
  total_edits: torch.Tensor       # [] int64
  total_ref_labels: torch.Tensor  # [] int64
  num_sequences: torch.Tensor     # [] int64

  def __add__(self, other: 'ErrorRateState') -> 'ErrorRateState':
    return ErrorRateState(
        self.total_edits + other.total_edits,
        self.total_ref_labels + other.total_ref_labels,
        self.num_sequences + other.num_sequences)


def empty_error_rate_state(device='cuda') -> ErrorRateState:
  """Zero totals (int64) on ``device``: the card unless the caller asks
  for 'cpu'."""
  zero = torch.zeros((), dtype=torch.int64, device=device)
  return ErrorRateState(zero, zero, zero)


def update_error_rate(state: ErrorRateState, hyp, num_hyp, ref, num_ref,
                      valid: Optional[torch.Tensor] = None
                      ) -> ErrorRateState:
  """Folds one padded batch into the accumulator.

  Args:
    state: Accumulator so far.
    hyp / num_hyp / ref / num_ref: As in ``edit_distance``.
    valid: Optional [batch...] bool mask of real (non-padding) sequences;
      use it when the last evaluation batch is padded up to a fixed size.

  Returns:
    The updated accumulator, on ``state``'s device.
  """
  device = state.total_edits.device
  edits = edit_distance(hyp, num_hyp, ref, num_ref).to(device).long()
  num_ref = torch.as_tensor(num_ref, device=device).long()
  if valid is None:
    valid = torch.ones(edits.shape, dtype=torch.bool, device=device)
  valid = torch.as_tensor(valid, device=device).bool()
  return ErrorRateState(
      state.total_edits + torch.where(valid, edits, 0).sum(),
      state.total_ref_labels + torch.where(valid, num_ref, 0).sum(),
      state.num_sequences + valid.long().sum())


def error_rate(state: ErrorRateState) -> torch.Tensor:
  """Corpus label error rate: total edits over total reference labels."""
  return state.total_edits / state.total_ref_labels.clamp(min=1)
