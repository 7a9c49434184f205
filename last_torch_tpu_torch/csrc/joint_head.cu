// Copyright 2026.
//
// Licensed under the Apache License, Version 2.0 (the "License");
// you may not use this file except in compliance with the License.
// You may obtain a copy of the License at
//
//     http://www.apache.org/licenses/LICENSE-2.0
//
// Unless required by applicable law or agreed to in writing, software
// distributed under the License is distributed on an "AS IS" BASIS,
// WITHOUT WARRANTIES OR CONDITIONS OF ANY KIND, either express or implied.
// See the License for the specific language governing permissions and
// limitations under the License.

// The joint network and its heads for every context state, on Hopper:
// JointWeightFn.apply's state=None branch, forward and backward.
//
// Replaces the Pallas TPU kernels of last_torch_tpu/ops/joint_head.py:
// _fwd_kernel (pallas_call at joint_head.py:165) and _bwd_kernel (pallas_call
// at :214). Rows m = b * S + s run over the (batch row, context state) pairs.
// With T the compute type (float32 or bfloat16) and float32 sums:
//
//   joint32[m] = tanh(pc[s] + pf[b])                             [h], f32
//   lex[m, y]  = T(joint32[m]) . T(vocab_w[:, y]) + vocab_b[y]   [V]
//   blank[m]   = T(joint32[m]) . T(blank_w) + blank_b
//
// and, from the cotangents g_lex [B, S, V] and g_blank [B, S], rounded to T
// as the TPU kernel rounds them:
//
//   du[m]     = (T(g_lex[m]) . T(vocab_w)^T + T(g_blank[m]) T(blank_w))
//               * (1 - joint32[m]^2)
//   d_pc[s]   = sum_b du[b * S + s],   d_pf[b] = sum_s du[b * S + s]
//   d_vocab_w = sum_m T(joint32[m])^T T(g_lex[m]),
//   d_blank_w = sum_m T(joint32[m]) T(g_blank[m]).
//
// (The bias gradients are plain sums of the cotangents, left to the caller
// as the TPU kernel leaves them to XLA.)
//
// What bounds it here. The forward is one [B S, h] x [h, V] product per
// call (2 B S h V = 8.6 GFLOP at B=8, S=1025, V=1024, h=512), the backward
// two more (d_joint and d_vocab_w); the [B, S, V] float32 outputs and
// cotangents (34 MB there) are the only large device-memory traffic, so the
// products bound it: bfloat16 runs on the tensor cores (989 TFLOP/s peak),
// float32, kept for exact comparison with the plain versions, on the CUDA
// cores (67 TFLOP/s).
//
// What the design does about it:
// * The [B, S, h] joint never reaches device memory. The products take
//   their joint operand from a producer that forms tanh(pc + pf) slice by
//   slice as it stages the operand in shared memory (one depth slice of the
//   tile's rows), so the shared memory a block needs does not grow with h.
// * bfloat16: a 128 x 128 output tile per block, 8 warps of 32 x 64 through
//   WMMA (mma.sync, float32 accumulation), 16-deep stages, two blocks per
//   SM. Each thread loads its share of the next stage into registers
//   before the current stage's products and converts and stores it after
//   them, so the loads run under the products; where h and V are multiples
//   of 4 it loads 16 bytes at a time, which also keeps the loads'
//   addresses few enough for the registers. The joint's tanh is taken at
//   the store. Results leave through a per-warp shared-memory scratch, 32
//   consecutive columns per store. The blank head is summed from the
//   staged joint slices by the blocks of the first label strip.
// * float32: one 64 x 64 tile per block through FMAs (a 4 x 4 register
//   tile per thread), as tile_product.cuh's products but with producers in
//   place of loads; the blank head a warp-per-row dot.
// * The forward writes blank [B, S] and lexical [B, S, V] as two contiguous
//   outputs.
// * The backward's d_joint product: float32 runs per (state tile, hidden
//   tile), loops over the batch rows and sums d_pc in registers; bfloat16
//   runs per (row tile, hidden tile) over the B S rows, one wave of blocks
//   at the headline shape, and writes du [B, S, h], whose batch-row sums
//   (d_pc) and state sums (d_pf, by 32-state chunks) are reductions. d_pf /
//   d_blank_w go to per-tile partials; d_vocab_w splits its long
//   contraction (over B S rows) across blocks into per-split partials, as
//   many splits as fill one wave. Every partial belongs to one block and is
//   reduced by a second launch: no atomics, deterministic sums.
// The backward and the tile machinery live in joint_tiles.cuh, shared with
// sharded_scan.cu's frame reduction.
// wgmma, TMA, and reusing a joint slice across label strips are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "joint_tiles.cuh"

namespace {

using namespace joint_tiles;

// ---------------------------------------------------------------------------
// float32: 64 x 64 tiles through FMAs.

// blank [B, S] and lexical [B, S, V] for a (64-row, 64-label) tile.
// Grid (ceil(B S / 64), max(1, ceil(V / 64))).
__global__ void __launch_bounds__(kThreads)
    forward_f32_kernel(const float* __restrict__ pc,   // [S, h]
                       const float* __restrict__ pf,   // [B, h]
                       const float* __restrict__ vw,   // [h, V]
                       const float* __restrict__ bw,   // [h]
                       const float* __restrict__ vb,   // [V]
                       const float* __restrict__ bb,   // [1]
                       float* __restrict__ blank,      // [B, S]
                       float* __restrict__ lex,        // [B, S, V]
                       int B, int S, int h, int V) {
  __shared__ size_t pc_off[kBM], pf_off[kBM];
  const int M = B * S;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int tid = threadIdx.x;
  const int tx = tid % (kBN / kTN), ty = tid / (kBN / kTN);
  if (tid < kBM) {
    const int m = m0 + tid < M ? m0 + tid : 0;
    pc_off[tid] = static_cast<size_t>(m % S) * h;
    pf_off[tid] = static_cast<size_t>(m / S) * h;
  }
  __syncthreads();
  if (n0 < V) {
    auto joint = [&](int r, int k) {
      return m0 + r < M ? tanhf(pc[pc_off[r] + k] + pf[pf_off[r] + k]) : 0.f;
    };
    auto head = [&](int k, int c) {
      return n0 + c < V ? vw[static_cast<size_t>(k) * V + n0 + c] : 0.f;
    };
    float acc[kTM][kTN];
    zero(acc);
    accumulate<false, false>(acc, joint, head, 0, h);
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const int m = m0 + ty * kTM + i;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const int y = n0 + tx * kTN + j;
        if (y < V) lex[static_cast<size_t>(m) * V + y] = acc[i][j] + vb[y];
      }
    }
  }
  if (blockIdx.y == 0) {
    const int warp = tid / 32, lane = tid % 32;
    for (int row = warp; row < kBM; row += kThreads / 32) {
      if (m0 + row >= M) break;
      float dot = 0.f;
      for (int k = lane; k < h; k += 32) {
        dot = fmaf(tanhf(pc[pc_off[row] + k] + pf[pf_off[row] + k]), bw[k],
                   dot);
      }
      for (int o = 16; o > 0; o >>= 1) {
        dot += __shfl_xor_sync(0xffffffffu, dot, o);
      }
      if (lane == 0) blank[m0 + row] = dot + bb[0];
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16: 128 x 128 tiles through WMMA.

// blank [B, S] and lexical [B, S, V] for a (128-row, 128-label) tile. Grid
// (ceil(B S / 128), max(1, ceil(V / 128))).
template <bool Vec>
__global__ void __launch_bounds__(kThreads, 2)
    forward_bf16_kernel(const float* __restrict__ pc, const float* __restrict__ pf,
                        const float* __restrict__ vw, const float* __restrict__ bw,
                        const float* __restrict__ vb, const float* __restrict__ bb,
                        float* __restrict__ blank, float* __restrict__ lex,
                        int B, int S, int h, int V) {
  __shared__ __align__(128) __nv_bfloat16 smem[kSmemBytes / 2];
  __shared__ size_t pc_off[kHM], pf_off[kHM];
  const int M = B * S;
  const int m0 = blockIdx.x * kHM, n0 = blockIdx.y * kHN;
  const int tid = threadIdx.x;
  if (tid < kHM) {
    const int m = m0 + tid < M ? m0 + tid : 0;
    pc_off[tid] = static_cast<size_t>(m % S) * h;
    pf_off[tid] = static_cast<size_t>(m / S) * h;
  }
  __syncthreads();
  // The blank head, from the staged joint: thread pair (row, half) sums
  // half of each 32-deep slice of its row.
  const bool blank_strip = blockIdx.y == 0;
  const int row = tid / 2, part = tid % 2;
  float dot = 0.f;
  auto blank_hook = [&](int k0, const __nv_bfloat16* a_tile) {
    if (!blank_strip) return;
#pragma unroll
    for (int j = 0; j < kHK / 2; ++j) {
      const int d = part * (kHK / 2) + j;
      if (k0 + d < h) {
        dot = fmaf(__bfloat162float(a_tile[row * kLdDeep + d]),
                   bf16_round(bw[k0 + d]), dot);
      }
    }
  };
  Tile128 acc;
  zero(acc);
  mainloop<false, false, Vec>(
      acc, JointRows{{}, pc, pf, pc_off, pf_off, min(kHM, M - m0)},
      HeadCols{{}, vw, V, n0}, 0, h, smem, blank_hook);
  dot += __shfl_xor_sync(0xffffffffu, dot, 1);
  if (blank_strip && part == 0 && m0 + row < M) blank[m0 + row] = dot + bb[0];
  if (n0 >= V) return;
  drain(acc, smem, [&](int r, int c, float v, int) {
    const int m = m0 + r, y = n0 + c;
    if (m < M && y < V) lex[static_cast<size_t>(m) * V + y] = v + vb[y];
  });
}

}  // namespace

extern "C" {

// The forward on `stream`; returns the first error (0 on success). dtype 0 =
// float32, 1 = bfloat16 (the compute type); every pointer is float32: pc
// [S, h], pf [B, h], vw [h, V], bw [h], vb [V], bb [1], outputs blank
// [B, S] and lex [B, S, V].
int joint_head_forward(int dtype, const float* pc, const float* pf,
                       const float* vw, const float* bw, const float* vb,
                       const float* bb, float* blank, float* lex, int B,
                       int S, int h, int V, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = B * S;
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return 0;
  if (dtype == 0) {
    const dim3 grid(tiles(M, kBM), V > 0 ? tiles(V, kBN) : 1);
    forward_f32_kernel<<<grid, kThreads, 0, s>>>(pc, pf, vw, bw, vb, bb,
                                                 blank, lex, B, S, h, V);
  } else {
    const dim3 grid(tiles(M, kHM), V > 0 ? tiles(V, kHN) : 1);
    const auto kernel = vector_path(h, V, {pc, pf, vw})
                            ? forward_bf16_kernel<true>
                            : forward_bf16_kernel<false>;
    kernel<<<grid, kThreads, 0, s>>>(pc, pf, vw, bw, vb, bb, blank, lex, B,
                                     S, h, V);
  }
  RETURN_IF_LAUNCH_FAILED();
  return 0;
}

// The backward on `stream`; returns the first error. Outputs d_pc [S, h],
// d_pf [B, h], d_vw [h, V], d_bw [h]; the scratch is joint_backward's
// (joint_tiles.cuh). The blank cotangent, blank_w and the joint of d_bw are
// rounded to the compute type, as the TPU kernel rounds them.
int joint_head_backward(int dtype, const float* pc, const float* pf,
                        const float* vw, const float* bw,
                        const float* g_blank, const float* g_lex,
                        float* dpf_part, float* dbw_part, float* dpc_part,
                        float* dw_part, float* d_pc, float* d_pf,
                        float* d_vw, float* d_bw, int B, int S, int h, int V,
                        int splits, void* stream) {
  return joint_backward(dtype, /*round_blank=*/true, pc, pf, vw, bw, g_blank,
                        g_lex, dpf_part, dbw_part, dpc_part, dw_part, d_pc,
                        d_pf, d_vw, d_bw, B, S, h, V, splits,
                        static_cast<cudaStream_t>(stream));
}

const char* joint_head_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
