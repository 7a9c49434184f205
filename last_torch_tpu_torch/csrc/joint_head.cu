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
// call (2 B S h V = 8.6 GFLOP at B=8, S=1025, V=1024, h=512: 8.7 us at the
// bfloat16 peak) and writes the [B, S, V] float32 lexical output (33.6 MB
// there: 10.0 us at 3.35 TB/s), so in bfloat16 the output's bytes bound it;
// the backward runs two more products (d_joint and d_vocab_w), and reads
// the [B, S, V] cotangent. float32, kept for exact comparison with the
// plain versions, runs on the CUDA cores (67 TFLOP/s).
//
// What the design does about it:
// * bfloat16 forward (namespace hopper), two launches of head_product.cuh,
//   the machinery this forward shares with the lattice forwards of
//   fused_scan.cu and sharded_scan.cu. joint_pass_kernel forms every joint
//   entry once per call, tanh(pc + pf) rounded to bfloat16 into a [B S,
//   hp] scratch (hp: h rounded up to 64, zero past h; 8.4 MB at the
//   headline, resident in the 50 MB L2), with the blank head as a warp's
//   dot over the rounded row; its last hp rows round vocab_w into a padded
//   [hp, Vp] bfloat16 copy (zero past h and V). The TPU kernel kept the
//   whole head resident in VMEM and formed each joint tile once; here the
//   joint is formed once and both operands of the product reach shared
//   memory by TMA. head_product_kernel runs on wgmma with two consumer
//   warpgroups, which share each stage's head boxes: a (128-row,
//   128-label) tile reads 256 KB of operands from the L2 cache at h=512,
//   where a 64-row tile reads 192 KB for half the work, and those reads
//   bound the product. It runs as a persistent grid: each of at most two
//   blocks an SM walks over output tiles, the ring loading the next tile's
//   stages while the warpgroups add vb and store the last one. The stores
//   go from registers, 16 bytes a thread (a pair of lanes swaps halves so
//   that each holds four consecutive labels) where V is a multiple of 4;
//   else each warp passes its rows through a shared-memory scratch and
//   stores 32 consecutive labels of a row at a time. Both carry the
//   streaming (evict-first) hint: the output must not push the joint and
//   the head out of the L2 cache. With two blocks an SM one block's stores
//   run under the other's products.
// * bfloat16 backward: 128 x 128 output tiles per block, 8 warps of 32 x 64
//   through WMMA (mma.sync, float32 accumulation), 16-deep stages, two
//   blocks per SM; the joint formed slice by slice as the operand is staged
//   in shared memory (joint_tiles.cuh's mainloop). Each thread loads its
//   share of the next stage into registers before the current stage's
//   products and converts and stores it after them; where h and V are
//   multiples of 4 it loads 16 bytes at a time. The d_joint product runs
//   per (row tile, hidden tile) over the B S rows, one wave of blocks at
//   the headline shape, and writes du [B, S, h], whose batch-row sums
//   (d_pc) and state sums (d_pf, by 32-state chunks) are reductions. d_pf /
//   d_blank_w go to per-tile partials; d_vocab_w splits its long
//   contraction (over B S rows) across blocks into per-split partials, as
//   many splits as fill one wave. Every partial belongs to one block and is
//   reduced by a second launch: no atomics, deterministic sums.
// * float32: one 64 x 64 tile per block through FMAs (a 4 x 4 register
//   tile per thread), as tile_product.cuh's products but with producers in
//   place of loads, the joint formed as it is staged; the blank head a
//   warp-per-row dot.
// * The forward writes blank [B, S] and lexical [B, S, V] as two contiguous
//   outputs.
// The backward and its tile machinery live in joint_tiles.cuh, shared with
// sharded_scan.cu's frame reduction.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "head_product.cuh"
#include "joint_tiles.cuh"

namespace {

// ---------------------------------------------------------------------------
// bfloat16 forward on wgmma (head_product.cuh).
namespace hopper {

using wgmma_tiles::bf16;

// The joint pass, then (V > 0) the stored product on `blocks` persistent
// blocks (1 to the number of output tiles).
cudaError_t forward(const float* pc, const float* pf, const float* vw,
                    const float* bw, const float* vb, const float* bb,
                    float* blank, float* lex, bf16* joint, bf16* vw16, int B,
                    int S, int h, int V, int blocks, cudaStream_t stream) {
  const cudaError_t err = head_product::joint_pass(
      pc, pf, vw, bw, bb, nullptr, joint, vw16, blank, B, S, h, V,
      /*head=*/true, stream);
  if (err != cudaSuccess || V == 0) return err;
  return head_product::store_product(joint, vw16, vb, lex, B, S, h, V, blocks,
                                     stream);
}

}  // namespace hopper

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

}  // namespace

extern "C" {

// The forward on `stream`; returns the first error (0 on success). dtype 0 =
// float32, 1 = bfloat16 (the compute type); the inputs are float32: pc
// [S, h], pf [B, h], vw [h, V], bw [h], vb [V], bb [1], outputs blank
// [B, S] and lex [B, S, V]. bfloat16 also takes the scratch joint16 [B S,
// hp] and vw16 [hp, Vp] (bfloat16; hp, Vp: h and V rounded up to 64) and
// the product's persistent grid, `blocks` (1 to its output tiles,
// ceil(B S / 128) ceil(Vp / 128)); float32 ignores them.
int joint_head_forward(int dtype, const float* pc, const float* pf,
                       const float* vw, const float* bw, const float* vb,
                       const float* bb, float* blank, float* lex, int B,
                       int S, int h, int V, void* joint16, void* vw16,
                       int blocks, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = B * S;
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return 0;
  if (dtype == 1) {
    return static_cast<int>(hopper::forward(
        pc, pf, vw, bw, vb, bb, blank, lex,
        static_cast<hopper::bf16*>(joint16), static_cast<hopper::bf16*>(vw16),
        B, S, h, V, blocks, s));
  }
  const dim3 grid(tiles(M, kBM), V > 0 ? tiles(V, kBN) : 1);
  forward_f32_kernel<<<grid, kThreads, 0, s>>>(pc, pf, vw, bw, vb, bb, blank,
                                               lex, B, S, h, V);
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
