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

"""Hand-written Hopper kernels (``csrc/``) with their plain PyTorch versions.

Kernels are built and loaded at first use on a CUDA tensor, never at
import.
"""

from last_torch_tpu_torch.ops import fused_scan
from last_torch_tpu_torch.ops import joint_head
from last_torch_tpu_torch.ops import numerator_scan
from last_torch_tpu_torch.ops import rel_attention
from last_torch_tpu_torch.ops import sharded_scan
from last_torch_tpu_torch.ops import trigram_scan
from last_torch_tpu_torch.ops import viterbi
