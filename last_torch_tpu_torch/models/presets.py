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

"""Named GNAT model-family presets, PyTorch port.

The same plain config factories as ``last_torch_tpu/models/presets.py``,
returning the port's ``GNATConfig``.

The GNAT formulation subsumes the classic lattice-based transducer family
(GNAT paper Sections 3-4); these presets name the common corners:

* ``ctc_like``: context-free (FullNGram order 0) + FrameDependent +
  locally normalized — the CTC topology with a learned joint network.
* ``hat_bigram``: bigram label history + HAT local normalization —
  a Hybrid Autoregressive Transducer-style model.
* ``gnat_global_bigram``: the flagship globally-normalized GNAT (bigram
  context, FrameLabelDependent) — the headline benchmark configuration at
  full size.
* ``conformer_l_gnat``: the same lattice behind Conformer (L)'s encoder at
  its published widths (the port's own; not in the JAX package).
"""

from __future__ import annotations

from last_torch_tpu_torch.models import gnat


def ctc_like(vocab_size: int = 128, feature_size: int = 80,
             **overrides) -> gnat.GNATConfig:
  """Context-free, frame-dependent, locally normalized (CTC topology)."""
  defaults = dict(
      feature_size=feature_size,
      vocab_size=vocab_size,
      context_size=0,
      max_expansions=0,
      locally_normalized=True)
  defaults.update(overrides)
  return gnat.GNATConfig(**defaults)


def hat_bigram(vocab_size: int = 128, feature_size: int = 80,
               **overrides) -> gnat.GNATConfig:
  """Bigram label history with HAT-style local normalization."""
  defaults = dict(
      feature_size=feature_size,
      vocab_size=vocab_size,
      context_size=1,
      max_expansions=2,
      locally_normalized=True)
  defaults.update(overrides)
  return gnat.GNATConfig(**defaults)


def gnat_global_bigram(vocab_size: int = 1024, feature_size: int = 80,
                       **overrides) -> gnat.GNATConfig:
  """Globally-normalized GNAT, bigram context (the headline config)."""
  defaults = dict(
      feature_size=feature_size,
      vocab_size=vocab_size,
      context_size=1,
      max_expansions=2,
      locally_normalized=False)
  defaults.update(overrides)
  return gnat.GNATConfig(**defaults)


def streaming_conformer_gnat(vocab_size: int = 1024,
                             feature_size: int = 80,
                             **overrides) -> gnat.GNATConfig:
  """Streamable Conformer-encoder GNAT for online serving.

  Causal left-windowed attention + Conformer blocks (causal conv), so
  offline training and chunked serving through
  ``models.encoder.StreamingEncoder`` + ``streaming``
  produce identical encodings.
  """
  defaults = dict(
      feature_size=feature_size,
      vocab_size=vocab_size,
      context_size=1,
      max_expansions=2,
      locally_normalized=False,
      encoder_causal=True,
      encoder_window=64,
      encoder_conv_kernel=8)
  defaults.update(overrides)
  return gnat.GNATConfig(**defaults)


def conformer_l_gnat(vocab_size: int = 1024, feature_size: int = 80,
                     **overrides) -> gnat.GNATConfig:
  """Conformer (L) (arXiv:2005.08100, Table 1: 17 blocks of width 512, 8
  heads, convolution kernel 32, feed-forward 2048) in front of the
  globally normalized bigram FLD(2) lattice, joint hidden and context
  embedding 512. The encoder (``models.encoder.ConformerEncoder``) cuts
  the frame rate by 4: the lattice decodes its output frames."""
  defaults = dict(
      feature_size=feature_size,
      vocab_size=vocab_size,
      context_size=1,
      max_expansions=2,
      locally_normalized=False,
      encoder_kind='conformer',
      encoder_size=512,
      encoder_layers=17,
      encoder_heads=8,
      encoder_ffn_size=2048,
      encoder_conv_kernel=32,
      hidden_size=512,
      embedding_size=512)
  defaults.update(overrides)
  return gnat.GNATConfig(**defaults)
