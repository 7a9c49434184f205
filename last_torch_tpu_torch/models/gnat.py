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

Counterpart of ``last_torch_tpu/models/gnat.py``: ``GNATConfig`` and the
serving side of ``GNATModel`` (``init`` and ``decode``). The loss, the
optimizer and the train steps come with the training slice (ROADMAP
queue 1).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from last_torch_tpu_torch import alignments
from last_torch_tpu_torch import contexts
from last_torch_tpu_torch import lattices
from last_torch_tpu_torch import weight_fns
from last_torch_tpu_torch.models import encoder as encoder_lib

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class GNATConfig:
  """Configuration for a GNAT speech transducer (same fields and defaults as
  ``last_torch_tpu.models.gnat.GNATConfig``).

  Attributes:
    feature_size: Input acoustic feature dimension.
    vocab_size: Lexical output vocabulary size (excluding blank).
    context_size: FullNGram context order (1 = bigram label history).
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


class GNATModel:
  """A complete GNAT speech transducer on one device.

  Attributes:
    config: GNATConfig.
    device: Where ``init`` puts the parameters and ``decode`` runs.
    encoder: TransformerEncoder.
    lattice: RecognitionLattice over the encoder outputs.
  """

  def __init__(self, config: GNATConfig, device='cpu'):
    self.device = torch.device(device)
    if self.device.type == 'cuda' and not torch.cuda.is_available():
      raise RuntimeError(f'GNATModel on {device}: no CUDA device is '
                         'available')
    if config.locally_normalized:
      raise NotImplementedError(
          'locally normalized GNAT (LocallyNormalizedWeightFn) is not ported '
          'to PyTorch yet: ROADMAP.md queue 1, "hat/log-softmax decode"')
    if config.use_rnn_cacher:
      raise NotImplementedError(
          'SharedRNNCacher is not ported to PyTorch yet: ROADMAP.md queue 1, '
          '"weight_fns.py, the rest"')
    self.config = config
    self.encoder = encoder_lib.TransformerEncoder(
        feature_size=config.feature_size,
        model_size=config.encoder_size,
        num_layers=config.encoder_layers,
        num_heads=config.encoder_heads,
        ffn_size=config.encoder_ffn_size,
        causal=config.encoder_causal,
        window=config.encoder_window,
        conv_kernel=config.encoder_conv_kernel)

    context = contexts.FullNGram(
        vocab_size=config.vocab_size, context_size=config.context_size)
    if config.max_expansions > 0:
      alignment = alignments.FrameLabelDependent(
          max_expansions=config.max_expansions)
    else:
      alignment = alignments.FrameDependent()
    self.lattice = lattices.RecognitionLattice(
        context=context,
        alignment=alignment,
        weight_fn_cacher_factory=lambda ctx: weight_fns.SharedEmbCacher(
            num_context_states=ctx.shape()[0],
            embedding_size=config.embedding_size),
        weight_fn_factory=lambda ctx: weight_fns.JointWeightFn(
            vocab_size=ctx.shape()[1], hidden_size=config.hidden_size))

  def init(self, generator: torch.Generator) -> Params:
    """Random parameters on ``self.device``, drawn from ``generator``."""
    return {
        'encoder': self.encoder.init(generator, self.device),
        'lattice': self.lattice.init(
            generator, feature_size=self.config.encoder_size,
            device=self.device),
    }

  @torch.no_grad()
  def decode(self, params: Params, frames, num_frames):
    """Viterbi-decodes the highest scoring alignment.

    Args:
      params: Parameters from ``init`` (or ``convert.from_jax_params``).
      frames: [batch, max_num_frames, feature_size] acoustic features.
      num_frames: [batch] frame counts.

    Returns:
      (alignment_labels, num_alignment_labels, path_weights); see
      ``RecognitionLattice.shortest_path``.
    """
    frames = torch.as_tensor(frames, dtype=torch.float32, device=self.device)
    num_frames = torch.as_tensor(num_frames, device=self.device)
    encoded = self.encoder.apply(params['encoder'], frames, num_frames)
    return self.lattice.shortest_path(
        params['lattice'], frames=encoded, num_frames=num_frames)
