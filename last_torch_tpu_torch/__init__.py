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

"""last_torch_tpu_torch: the GNAT lattice framework on PyTorch and CUDA.

A port of the JAX package ``last_torch_tpu`` to PyTorch, with the Pallas
TPU kernels rewritten by hand for NVIDIA Hopper. The JAX package stays the
reference each part is held against. Ported so far: the serving path,
``models.gnat.GNATModel.decode``, whose Viterbi forward runs in
``csrc/viterbi.cu`` on the card, and the training path,
``GNATModel.mean_loss`` and ``models.gnat.train_step``, whose loss
denominator runs in ``csrc/fused_scan.cu``, and both paths of the locally
normalized (HAT) model, whose decode normalizes inside the Viterbi kernel
and whose numerator runs in ``csrc/numerator_scan.cu``; the posteriors, the
trigram GNAT and arbitrary context DFAs (``NextStateTable``), whose generic
routes run the joint network and heads in ``csrc/joint_head.cu``; and
data- and tensor-parallel training (``parallel.sharding``), whose
vocab-sharded loss reduces each frame over a rank's shard of the head in
``csrc/sharded_scan.cu``; forced alignment, exact posterior path samples
and expected-risk (MWER) fine-tuning (``risk``, ``models.metrics``,
``models.gnat.risk_train_step``), whose sampler's beta pass runs the
joint+head kernels; the CTC topology (a single context state,
``models.presets.ctc_like``), on the factorized S = 1 route of
``lattices``, and the tuple semirings (``semirings.LogLogExpectation``,
``Cartesian``) with ``shortest_distance``'s ``weight_lift``, e.g. path
entropy; online serving of a causal windowed encoder chunk by chunk
(``models.encoder.StreamingEncoder``, banded offline attention) with the
greedy and beam decoders of ``streaming``, and the trainer that feeds it
(``models.train``, ``data``, ``utils``: checkpoints, prefetch, timers;
gradient accumulation, the RNN context cacher); training, decoding and
alignment with the frames sharded over a time axis
(``parallel.sequence``: the alpha relay between ranks, the log-partition
kernels chained by their seeds); pipeline-parallel (GPipe) training
(``parallel.pipeline``) and the Megatron-sharded encoder
(``parallel.sharding.make_sharded_train_step``); and the public interfaces
that users subclass, ``weight_fns.WeightFn``, ``weight_fns.WeightFnCacher``
and ``alignments.TimeSyncAlignmentLattice``, with the closed-form string DP
(``lattices.STRING_DP_CUMULATIVE``, off by default). See ROADMAP.md for
what follows.
"""

from last_torch_tpu_torch import alignments
from last_torch_tpu_torch import contexts
from last_torch_tpu_torch import risk
from last_torch_tpu_torch import semirings
from last_torch_tpu_torch import streaming
from last_torch_tpu_torch import weight_fns
from last_torch_tpu_torch.contexts import ContextDependency
from last_torch_tpu_torch.contexts import FullNGram
from last_torch_tpu_torch.contexts import NextStateTable
from last_torch_tpu_torch.lattices import RecognitionLattice

__version__ = '0.1.0'
