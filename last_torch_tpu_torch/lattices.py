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

"""Recognition lattice, PyTorch port: the decode slice.

Counterpart of ``last_torch_tpu/lattices.py``. What is ported is what
``GNATModel.decode`` runs: ``init``, ``build_cache`` and ``shortest_path``
through the Viterbi kernel (``ops/viterbi.py``). The other operations, and
decodes outside the kernel's gate, raise ``NotImplementedError`` naming the
ROADMAP item that ports them; none of them falls back to another route.
"""

from __future__ import annotations

from collections.abc import Callable
from typing import Any, Optional

import torch

from last_torch_tpu_torch import alignments
from last_torch_tpu_torch.ops import viterbi

Params = dict[str, Any]


def _not_ported(operation: str, roadmap_item: str):
  raise NotImplementedError(
      f'{operation} is not ported to PyTorch yet: ROADMAP.md queue 1, '
      f'"{roadmap_item}"')


class RecognitionLattice:
  """Recognition lattice in GNAT-style formulation (decode slice).

  Three components define it, as in the JAX package: a context dependency
  (``contexts``), an alignment lattice (``alignments``) and a weight
  function with its cacher (``weight_fns``). Parameters are dictionaries of
  tensors created by ``init`` and passed to every method.

  Attributes:
    context: Context dependency.
    alignment: Alignment lattice.
    weight_fn_cacher: WeightFnCacher built by ``weight_fn_cacher_factory``.
    weight_fn: WeightFn built by ``weight_fn_factory``.
  """

  def __init__(self, context, alignment,
               weight_fn_cacher_factory: Callable[[Any], Any],
               weight_fn_factory: Callable[[Any], Any]):
    self.context = context
    self.alignment = alignment
    self.weight_fn_cacher = weight_fn_cacher_factory(context)
    self.weight_fn = weight_fn_factory(context)
    self._last_path = None

  @property
  def last_path(self) -> Optional[str]:
    """Which path the last ``shortest_path`` took.

    'kernel' when it launched the CUDA Viterbi kernel (CUDA tensors),
    'plain' when it ran the kernel's plain PyTorch version (CPU tensors),
    None before any call.
    """
    return self._last_path

  def init(self, generator: torch.Generator, feature_size: int,
           device='cpu') -> Params:
    """Creates the parameters: ``{'cacher': ..., 'weight_fn': ...}``."""
    cacher_params = self.weight_fn_cacher.init(generator, device)
    cache = self.weight_fn_cacher.apply(cacher_params)
    dummy_frame = torch.zeros((feature_size,), device=device)
    wf_params = self.weight_fn.init(generator, cache, dummy_frame)
    return {'cacher': cacher_params, 'weight_fn': wf_params}

  def build_cache(self, params: Params) -> torch.Tensor:
    """The frame-independent weight function cache."""
    return self.weight_fn_cacher.apply(params['cacher'])

  def shortest_path(self, params: Params, frames: torch.Tensor,
                    num_frames: torch.Tensor, cache=None,
                    reference_compat: bool = False):
    """The highest scoring alignment path (Viterbi decode).

    On CUDA tensors the forward runs the Hopper kernel with bfloat16 joint
    and head inputs, as the TPU kernel did; on CPU tensors its plain
    version in float32, which is what the JAX package computes off the TPU.

    Args:
      params: Parameters from ``init``.
      frames: [batch, max_num_frames, feature_size] padded frames.
      num_frames: [batch] number of frames.
      cache: Optional weight function cache.
      reference_compat: Emit the reference's raw ``argmax`` label values
        (lexical label y becomes y - 1); see the JAX package's PARITY.md.

    Returns:
      (alignment_labels [batch, max_num_frames * num_alignment_states]
      int32, blank 0 or lexical 1..vocab_size; num_alignment_labels [batch]
      int32; path_weights [batch] float32).
    """
    num_frames = torch.as_tensor(num_frames, device=frames.device)
    if frames.shape[:-2] != num_frames.shape:
      raise ValueError('frames and num_frames have different batch_dims: '
                       f'{tuple(frames.shape[:-2])} vs '
                       f'{tuple(num_frames.shape)}')
    if not viterbi.supported(self, frames):
      _not_ported('shortest_path outside the Viterbi kernel\'s gate '
                  '(bigram FullNGram, JointWeightFn, FD/FLD, one batch dim)',
                  'lattices.py, the rest')
    if cache is None:
      cache = self.build_cache(params)
    frame_dependent = isinstance(self.alignment, alignments.FrameDependent)
    on_card = frames.device.type == 'cuda'
    self._last_path = 'kernel' if on_card else 'plain'
    labels, num_labels, weights = viterbi.viterbi_decode(
        params['weight_fn'], cache, frames, num_frames,
        max_expansions=(0 if frame_dependent else
                        self.alignment.max_expansions),
        frame_dependent=frame_dependent,
        compute_dtype=torch.bfloat16 if on_card else torch.float32)
    if reference_compat:
      labels = torch.where(labels == 0, 0, labels - 1)
    return labels, num_labels, weights

  def loss(self, *args, **kwargs):
    _not_ported('loss', 'GN loss forward and backward')

  __call__ = loss

  def shortest_distance(self, *args, **kwargs):
    _not_ported('shortest_distance', 'GN loss forward and backward')

  def arc_marginals(self, *args, **kwargs):
    _not_ported('arc_marginals', 'label_marginals and arc_marginals')

  def label_marginals(self, *args, **kwargs):
    _not_ported('label_marginals', 'label_marginals and arc_marginals')

  def align(self, *args, **kwargs):
    _not_ported('align', 'lattices.py, the rest')

  def sample_paths(self, *args, **kwargs):
    _not_ported('sample_paths', 'lattices.py, the rest')
