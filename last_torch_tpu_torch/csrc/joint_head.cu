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
// * bfloat16 backward (namespace hopper), the frame reduction's backward
//   (sharded_scan.cu) minus its lex recompute, in four launches on one
//   workspace: stage_kernel forms the bfloat16 joint [B S, hp] and the
//   float32 joint32 [B S, h] (the tanh derivative), the padded bfloat16
//   head vw16 [hp, Vp], and rounds the cotangent g_lex to bfloat16 into a
//   padded [B S, Vp] d_lex, as the TPU kernel rounds it (joint_head.py:255):
//   the padding is what TMA needs (16-byte row strides, zeros past V). At
//   the headline the pass reads the 33.6 MB float32 cotangent once, about
//   10 us at 3.35 TB/s, and writes 42 MB that the products then read from
//   the L2 cache and device memory. head_grads.cuh's two wgmma products
//   follow (TMA into a 4-stage mbarrier ring, one consumer warpgroup, two
//   blocks an SM): the d_joint product with the tanh derivative and the
//   rounded blank terms in its epilogue (RoundBlank), d_pc kept in
//   registers across the batch rows of its split and the state sums of du
//   (d_pf) and of joint d_blank (d_blank_w) written per 64-state tile; and
//   the d_vocab_w product split over the (batch row, 64-state) depth. One
//   launch sums every partial: each belongs to one block, no atomics.
// * float32: one 64 x 64 tile per block through FMAs (a 4 x 4 register
//   tile per thread), as tile_product.cuh's products but with producers in
//   place of loads, the joint formed as it is staged; the blank head a
//   warp-per-row dot.
// * The forward writes blank [B, S] and lexical [B, S, V] as two contiguous
//   outputs.
// The float32 backward lives in joint_tiles.cuh, shared with
// sharded_scan.cu's frame reduction.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "head_grads.cuh"
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

// The backward's operands in one pass, a warp per row: rows [0, M) of the
// grid (M = B S) form joint16[m, :hp] = bf16(tanh(pc[s] + pf[b])) (zero
// past h) and joint32[m, :h]; rows [M, 2M) round g_lex[m - M, :V] into
// d_lex[m - M, :Vp] (zero past V); the next hp rows round vw into vw16 [hp,
// Vp]. A lane takes 4 consecutive entries, with 16-byte loads and stores
// where Vec (h and V multiples of 4, 16-byte aligned inputs). Grid
// ceil((2 M + hp) / 8).
template <bool Vec>
__global__ void __launch_bounds__(head_product::kPassThreads)
    stage_kernel(const float* __restrict__ pc,     // [S, h]
                 const float* __restrict__ pf,     // [B, h]
                 const float* __restrict__ vw,     // [h, V]
                 const float* __restrict__ g_lex,  // [B, S, V]
                 bf16* __restrict__ joint16,       // [B S, hp]
                 float* __restrict__ joint32,      // [B S, h]
                 bf16* __restrict__ d_lex,         // [B S, Vp]
                 bf16* __restrict__ vw16,          // [hp, Vp]
                 int B, int S, int h, int hp, int V, int Vp) {
  constexpr int kWarps = head_product::kPassThreads / 32;
  const long long M = static_cast<long long>(B) * S;
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  // Entries k..k+3 of a row of n valid ones (zero past n).
  const auto load4 = [](const float* src, int k, int n, float (&x)[4]) {
    if (Vec && k < n) {
      const float4 v = *reinterpret_cast<const float4*>(src + k);
      x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) x[e] = k + e < n ? src[k + e] : 0.f;
    }
  };
  const auto store4 = [](bf16* dst, const float (&x)[4]) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(x[0], x[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(x[2], x[3]);
    *reinterpret_cast<uint2*>(dst) =
        make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                   *reinterpret_cast<const uint32_t*>(&hi));
  };
  if (row < M) {
    const float* pc_s = pc + static_cast<size_t>(row % S) * h;
    const float* pf_b = pf + static_cast<size_t>(row / S) * h;
    bf16* out16 = joint16 + static_cast<size_t>(row) * hp;
    float* out32 = joint32 + static_cast<size_t>(row) * h;
    for (int k = lane * 4; k < hp; k += 128) {
      float c[4], f[4], j[4];
      load4(pc_s, k, h, c);
      load4(pf_b, k, h, f);
#pragma unroll
      for (int e = 0; e < 4; ++e) j[e] = k + e < h ? tanhf(c[e] + f[e]) : 0.f;
      store4(out16 + k, j);
      if (Vec && k < h) {
        *reinterpret_cast<float4*>(out32 + k) = make_float4(j[0], j[1], j[2],
                                                            j[3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (k + e < h) out32[k + e] = j[e];
        }
      }
    }
  } else if (row < 2 * M) {
    const size_t m = static_cast<size_t>(row - M);
    const float* src = g_lex + m * V;
    bf16* out = d_lex + m * Vp;
    for (int y = lane * 4; y < Vp; y += 128) {
      float x[4];
      load4(src, y, V, x);
      store4(out + y, x);
    }
  } else if (row < 2 * M + hp) {
    const int k = static_cast<int>(row - 2 * M);
    const float* src = vw + static_cast<size_t>(k) * V;
    bf16* out = vw16 + static_cast<size_t>(k) * Vp;
    for (int y = lane * 4; y < Vp; y += 128) {
      float x[4];
      load4(src, y, k < h ? V : 0, x);
      store4(out + y, x);
    }
  }
}

// The bfloat16 backward: the staging pass, the two gradient products of
// head_grads.cuh (every batch row live, partials written, not added) and
// one launch of the sums. Sizes as joint_head_backward's; V >= 1.
cudaError_t backward(const float* pc, const float* pf, const float* vw,
                     const float* bw, const float* g_blank,
                     const float* g_lex, bf16* joint16, float* joint32,
                     bf16* d_lex, bf16* vw16, float* dpf_part,
                     float* dbw_part, float* dpc_part, float* dw_part,
                     float* d_pc, float* d_pf, float* d_vw, float* d_bw,
                     int B, int S, int h, int V, int splits, int dsplits,
                     cudaStream_t stream) {
  using namespace head_grads;
  if (V < 1 || h < 1 || splits < 1 || dsplits < 1 || dsplits > B) {
    return cudaErrorInvalidValue;
  }
  const int hp = round_up(h, kBK), Vp = round_up(V, kBK), t64 = cdiv(S, 64);
  const long long rows = 2LL * B * S + hp;
  constexpr int kWarps = head_product::kPassThreads / 32;
  const auto stage =
      head_product::vector_loads(h, V, {pc, pf, vw, g_lex, joint32})
          ? stage_kernel<true>
          : stage_kernel<false>;
  stage<<<static_cast<unsigned>((rows + kWarps - 1) / kWarps),
          head_product::kPassThreads, 0, stream>>>(
      pc, pf, vw, g_lex, joint16, joint32, d_lex, vw16, B, S, h, hp, V, Vp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  Maps maps;
  err = make_maps(&maps, joint16, d_lex, vw16, B, S, S, hp, Vp);
  if (err != cudaSuccess) return err;
  err = launch_joint_grad</*RoundBlank=*/true>(
      maps,
      JointGrad{bw, g_blank, joint32, nullptr, dpf_part, dbw_part, dpc_part,
                B, B, S, h, Vp, 0, 0, S},
      hp, dsplits, stream);
  if (err != cudaSuccess) return err;
  err = launch_head_grad(maps, HeadGrad{nullptr, dw_part, B, S, h, V, 0}, hp,
                         Vp, splits, stream);
  if (err != cudaSuccess) return err;
  Sums sums{};
  const auto add = [&](const float* in, int rows, int n, float* out) {
    sums.job[sums.count++] = {in, rows, n, out};
  };
  add(dpf_part, t64, B * h, d_pf);
  add(dbw_part, B * t64, h, d_bw);
  add(dpc_part, dsplits, S * h, d_pc);
  add(dw_part, splits, h * V, d_vw);
  return launch_sums(sums, stream);
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
// d_pf [B, h], d_vw [h, V], d_bw [h]. The blank cotangent, blank_w and the
// joint of d_bw are rounded to the compute type, as the TPU kernel rounds
// them. Scratch (hp, Vp: h and V rounded up to 64; t64 = ceil(S / 64)):
//   float32 (dtype 0): joint_backward's (joint_tiles.cuh) dpf_part,
//     dbw_part, dpc_part, dw_part with `splits`; the rest unused.
//   bfloat16 (dtype 1): joint16 bfloat16 [B S, hp], joint32 float32 [B S,
//     h], d_lex16 bfloat16 [B S, Vp], vw16 bfloat16 [hp, Vp], dpf_part [t64,
//     B, h], dbw_part [B t64, h], dpc_part [dsplits, S, h] (1 <= dsplits <=
//     B), dw_part [splits, h, V]; V >= 1.
int joint_head_backward(int dtype, const float* pc, const float* pf,
                        const float* vw, const float* bw,
                        const float* g_blank, const float* g_lex,
                        float* dpf_part, float* dbw_part, float* dpc_part,
                        float* dw_part, float* d_pc, float* d_pf,
                        float* d_vw, float* d_bw, int B, int S, int h, int V,
                        int splits, void* joint16, float* joint32,
                        void* d_lex16, void* vw16, int dsplits,
                        void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) {
    return joint_backward(pc, pf, vw, bw, g_blank, g_lex, dpf_part, dbw_part,
                          dw_part, d_pc, d_pf, d_vw, d_bw, B, S, h, V, splits,
                          s);
  }
  if (B == 0 || S == 0) {  // no rows: every gradient is zero
    const struct {
      float* out;
      size_t n;
    } outs[] = {{d_pf, static_cast<size_t>(B) * h},
                {d_pc, static_cast<size_t>(S) * h},
                {d_vw, static_cast<size_t>(h) * V},
                {d_bw, static_cast<size_t>(h)}};
    for (const auto& out : outs) {
      const cudaError_t err =
          cudaMemsetAsync(out.out, 0, out.n * sizeof(float), s);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    return 0;
  }
  using hopper::bf16;
  return static_cast<int>(hopper::backward(
      pc, pf, vw, bw, g_blank, g_lex, static_cast<bf16*>(joint16), joint32,
      static_cast<bf16*>(d_lex16), static_cast<bf16*>(vw16), dpf_part,
      dbw_part, dpc_part, dw_part, d_pc, d_pf, d_vw, d_bw, B, S, h, V, splits,
      dsplits, s));
}

const char* joint_head_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
