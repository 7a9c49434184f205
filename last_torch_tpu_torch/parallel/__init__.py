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

"""Data-, tensor-, sequence- and pipeline-parallel GNAT training over
``torch.distributed``.

Counterpart of ``last_torch_tpu/parallel/``: ``sharding.py``'s mesh,
parameter rules (the vocab head and the Megatron encoder), the
data-parallel, tensor-parallel (vocab-sharded) and sharded train steps and
the data-parallel expected-risk (MWER) step; ``sequence.py``: training,
decoding and alignment with the frames sharded over a time axis (the
alpha / beta relay), alone, with data parallelism or with the vocabulary
sharded too (seq x tp); ``pipeline.py``: the encoder's blocks staged over
a pipe axis (GPipe), alone, with data parallelism or with the time-sharded
loss (pp x seq).
"""

from last_torch_tpu_torch.parallel import pipeline
from last_torch_tpu_torch.parallel import sequence
from last_torch_tpu_torch.parallel import sharding
