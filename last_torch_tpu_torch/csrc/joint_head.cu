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
// plain versions, runs on the CUDA cores (67 TFLOP/s): there the products'
// FMAs bound it (0.128 ms forward, 0.257 ms backward at that shape), and
// every tanhf (about 40 instructions on the same pipe) costs product time.
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
// * float32 (namespace fp32), on simt_tiles.cuh's register-blocked FMA
//   tiles (64 x 256 a block, 8 x 8 entries a thread from 16-byte shared
//   broadcasts, 16-deep slices double-buffered through registers; the
//   numerator's float32 route runs the same tiles). stage_kernel forms every
//   joint entry once a call, tanh(pc + pf) into a float32 [Mp, hp] scratch
//   (rows padded to 64, zeros past B S and h; 16.8 MB at the MWER shape,
//   resident in the 50 MB L2), with the forward's blank head as a warp's
//   dot over the row it has just formed and a padded copy of vw, so that
//   the products read padded operands. The tiles run fastest where an
//   operand is read along its rows, not along its contiguous contraction
//   axis (NVIDIA H100 80GB HBM3, 700 W: 62% of the FMA bound where neither
//   operand is contiguous along the depth, 56% with one, 50% with both;
//   PERF.md, tools/ab_kernels.py), so
//   transpose_kernel turns the operand the contraction would read along its
//   contiguous axis through a shared tile first.
//   Forward: one stored product, lex = joint . wp + vb (the bias in the
//   epilogue; 16-byte streaming stores where V % 4 == 0), rows-major
//   (lex_rows_kernel: 64 rows by 256 labels, from the joint transposed) or,
//   where a 256-label tile would be mostly padding (V <= 128, the trigram
//   probe's V=64), labels-major (lex_labels_kernel: 64 labels by 256 rows,
//   wp^T joint^T, from the row-major joint).
//   Backward, five launches on one workspace: the joint, the head
//   transposed (wt [Vp, hp]), the d_joint product over the flattened B S
//   rows (joint_grad_kernel: 64-row, 256-hidden tiles, g_lex . wt, 258
//   blocks at the MWER shape) with du = (dj + g_blank bw) (1 - joint^2) in
//   its epilogue, stored into a [B S, hp] buffer, and the tile's sums of du
//   over each batch row it touches (d_pf partials) and of joint g_blank
//   (d_blank_w partials); the d_vocab_w product joint^T g_lex split over
//   the rows so that one wave of blocks is busy (rows-major, or
//   labels-major as the forward); then one launch of the sums (d_pc =
//   sum_b du from the buffer). Every partial belongs to one block: no
//   atomics. Nothing is rounded.
// * The forward writes blank [B, S] and lexical [B, S, V] as two contiguous
//   outputs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "head_grads.cuh"
#include "head_product.cuh"
#include "simt_tiles.cuh"

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

// ---------------------------------------------------------------------------
// float32 on register-blocked FMA tiles (simt_tiles.cuh).
namespace fp32 {

using simt_tiles::col;
using simt_tiles::ColsA;
using simt_tiles::ColsAEdge;
using simt_tiles::ColsB;
using simt_tiles::kK;
using simt_tiles::kM;
using simt_tiles::kN;
using simt_tiles::kThreads;
using simt_tiles::ld4;
using simt_tiles::product;
using simt_tiles::reduce_columns;
using simt_tiles::RowsAEdge;
using simt_tiles::RowsB;
using simt_tiles::RowsBEdge;
using simt_tiles::Smem;
using wgmma_tiles::cdiv;
using wgmma_tiles::round_up;

// The sizes every float32 launch shares: M = B S rows, padded to Mp (64)
// in the joint scratch [Mp, hp] (zero past M and h); the head's padded copy
// wp [hp, Vp] (zero past h and V); hp and Vp: h and V rounded up to 64.
struct Shape {
  int B, S, h, V, M, Mp, hp, Vp;
  Shape(int B_, int S_, int h_, int V_)
      : B(B_), S(S_), h(h_), V(V_), M(B_ * S_), Mp(round_up(B_ * S_, kM)),
        hp(round_up(h_, kM)), Vp(round_up(V_, kM)) {}
  // Batch rows a 64-row tile of the flattened rows can touch.
  int batch_slots() const { return std::min(B, (kM - 1) / S + 2); }
};

// The operands in one pass, a warp per row: rows [0, Mp) of the grid form
// joint[m, :hp] = tanh(pc[s] + pf[b]) for m = b S + s < M (zero past h, and
// the rows m >= M zero) and, where blank is set, blank[m] = joint[m] . bw +
// bb, the warp's dot over the row it has just formed; the next hp rows copy
// vw into wp [hp, Vp] (zero past h and V). A lane takes 4 consecutive
// entries, with 16-byte loads where Vec (h and V multiples of 4, 16-byte
// aligned inputs); the scratch's stores are 16 bytes. Grid ceil((Mp + hp) /
// 8); the backward launches the joint's rows alone (Mp / 8 blocks).
template <bool Vec>
__global__ void __launch_bounds__(head_product::kPassThreads)
    stage_kernel(const float* __restrict__ pc,  // [S, h]
                 const float* __restrict__ pf,  // [B, h]
                 const float* __restrict__ vw,  // [h, V]
                 const float* __restrict__ bw,  // [h]
                 const float* __restrict__ bb,  // [1]
                 float* __restrict__ joint,     // [Mp, hp]
                 float* __restrict__ wp,        // [hp, Vp]
                 float* __restrict__ blank,     // [B, S] or null
                 int S, int h, int hp, int V, int Vp, int M, int Mp) {
  constexpr int kWarps = head_product::kPassThreads / 32;
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  // Entries k..k+3 of a row of n valid ones (zero past n).
  const auto load4 = [](const float* src, int k, int n, float (&x)[4]) {
    if (Vec && k < n) {
      const float4 v = ld4(src + k);
      x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) x[e] = k + e < n ? src[k + e] : 0.f;
    }
  };
  const auto store4 = [](float* dst, const float (&x)[4]) {
    *reinterpret_cast<float4*>(dst) = make_float4(x[0], x[1], x[2], x[3]);
  };
  if (row < Mp) {
    float* out = joint + static_cast<size_t>(row) * hp;
    const bool live = row < M;
    const float* pc_s = pc + static_cast<size_t>(live ? row % S : 0) * h;
    const float* pf_b = pf + static_cast<size_t>(live ? row / S : 0) * h;
    float dot = 0.f;
    for (int k = lane * 4; k < hp; k += 128) {
      float c[4], f[4], j[4];
      load4(pc_s, k, live ? h : 0, c);
      load4(pf_b, k, live ? h : 0, f);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        j[e] = live && k + e < h ? tanhf(c[e] + f[e]) : 0.f;
      }
      if (blank != nullptr) {
        float w[4];
        load4(bw, k, h, w);
#pragma unroll
        for (int e = 0; e < 4; ++e) dot = fmaf(j[e], w[e], dot);
      }
      store4(out + k, j);
    }
    if (blank != nullptr && live) {
      for (int o = 16; o > 0; o >>= 1) {
        dot += __shfl_xor_sync(0xffffffffu, dot, o);
      }
      if (lane == 0) blank[row] = dot + bb[0];
    }
  } else if (row < Mp + hp) {
    const int k = static_cast<int>(row - Mp);
    const float* src = vw + static_cast<size_t>(k) * V;
    float* out = wp + static_cast<size_t>(k) * Vp;
    for (int y = lane * 4; y < Vp; y += 128) {
      float x[4];
      load4(src, y, k < h ? V : 0, x);
      store4(out + y, x);
    }
  }
}

// Four consecutive outputs v at dst[0..3], those at e >= n dropped; one
// 16-byte store where Vec and all four are valid. Streaming (evict-first):
// the outputs must not push the joint and the head out of the L2 cache.
template <bool Vec>
__device__ __forceinline__ void store_out(float* dst, const float (&v)[4],
                                          int n) {
  if (Vec && n >= 4) {
    __stcs(reinterpret_cast<float4*>(dst), make_float4(v[0], v[1], v[2], v[3]));
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (e < n) __stcs(dst + e, v[e]);
    }
  }
}

// lex = joint . wp + vb, rows-major: a (64-row, 256-label) tile a block,
// from the joint transposed (the product contracts over h, and reads both
// operands along their rows). Grid (Mp / 64, ceil(Vp / 256)). Vec: V % 4 ==
// 0 and lex 16-byte aligned.
template <bool Vec>
__global__ void __launch_bounds__(kThreads, 2)
    lex_rows_kernel(const float* __restrict__ joint_t,  // [hp, Mp]
                    const float* __restrict__ wp,       // [hp, Vp]
                    const float* __restrict__ vb_in,    // [V]
                    float* __restrict__ lex,            // [M, V]
                    int M, int Mp, int hp, int V, int Vp) {
  __shared__ Smem sm;
  __shared__ float vb[kN];
  const int m0 = blockIdx.x * kM, n0 = blockIdx.y * kN, ty = threadIdx.x / 32;
  vb[threadIdx.x] = n0 + threadIdx.x < V ? vb_in[n0 + threadIdx.x] : 0.f;
  __syncthreads();
  float acc[8][8];
  product(acc, sm, hp / kK, ColsA{joint_t, Mp, m0}, RowsB{wp, Vp, n0, Vp});
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + ty * 8 + i;
    if (m >= M) continue;
    float* out = lex + static_cast<size_t>(m) * V;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int c = col(q * 4);
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = acc[i][q * 4 + e] + vb[c + e];
      store_out<Vec>(out + n0 + c, v, V - n0 - c);
    }
  }
}

// lex = joint . wp + vb, labels-major (where a 256-label tile would be
// mostly padding): a (64-label, 256-row) tile a block, the product wp^T
// joint^T. Grid (Vp / 64, ceil(M / 256)). Each thread stores 8
// consecutive labels of each of its 8 rows.
template <bool Vec>
__global__ void __launch_bounds__(kThreads, 2)
    lex_labels_kernel(const float* __restrict__ joint,  // [Mp, hp]
                      const float* __restrict__ wp,     // [hp, Vp]
                      const float* __restrict__ vb_in,  // [V]
                      float* __restrict__ lex,          // [M, V]
                      int M, int hp, int V, int Vp) {
  __shared__ Smem sm;
  __shared__ float vb[kM];
  const int l0 = blockIdx.x * kM, r0 = blockIdx.y * kN, ty = threadIdx.x / 32;
  if (threadIdx.x < kM) {
    vb[threadIdx.x] = l0 + threadIdx.x < V ? vb_in[l0 + threadIdx.x] : 0.f;
  }
  __syncthreads();
  float acc[8][8];
  product(acc, sm, hp / kK, ColsA{wp, Vp, l0}, ColsB{joint, hp, r0, M});
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int m = r0 + col(j);
    if (m >= M) continue;
    float* out = lex + static_cast<size_t>(m) * V + l0 + ty * 8;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[e] = acc[q * 4 + e][j] + vb[ty * 8 + q * 4 + e];
      }
      store_out<Vec>(out + q * 4, v, V - l0 - ty * 8 - q * 4);
    }
  }
}

// dst [cols_p, rows_p] = src [rows, cols] transposed (src row r at src + r
// ld_src; zero past rows and cols), through a 32 x 32 shared tile, both
// sides' accesses contiguous: the forward's joint for the rows-major
// product and the backward's head for the d_joint product, which contract
// over the source's contiguous axis. Grid (rows_p / 32, cols_p / 32), 32 x
// 8 threads.
__global__ void __launch_bounds__(256)
    transpose_kernel(const float* __restrict__ src, int ld_src, int rows,
                     int cols, float* __restrict__ dst, int rows_p) {
  __shared__ float tile[32][33];
  const int r0 = blockIdx.x * 32, c0 = blockIdx.y * 32;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  for (int i = ty; i < 32; i += 8) {
    const int r = r0 + i, c = c0 + tx;
    tile[i][tx] =
        r < rows && c < cols ? src[static_cast<size_t>(r) * ld_src + c] : 0.f;
  }
  __syncthreads();
  for (int i = ty; i < 32; i += 8) {
    dst[static_cast<size_t>(c0 + i) * rows_p + r0 + tx] = tile[tx][i];
  }
}

// The backward's operands and outputs (sizes as Shape).
struct Grad {
  const float* g_lex;    // [M, V]
  const float* g_blank;  // [M]
  const float* bw;       // [h]
  const float* joint;    // [Mp, hp]
  const float* wt;       // [Vp, hp], the head transposed
  float* du;             // [M, hp]
  float* dpf_part;       // [Mp / 64, J, h]
  float* dbw_part;       // [Mp / 64, h]
  float* dw_part;        // [splits, h, V]; labels-major [splits, V, h]
  int B, S, h, V, M, hp, Vp, J;
};

// The d_joint product over the flattened rows: a (64-row, 256-hidden) tile
// a block, dj = g_lex . wt, and in its epilogue du = (dj + g_blank bw) (1
// - joint^2), stored into du [M, hp] (zero past h); the tile's sums of
// joint g_blank (dbw_part[tile]) and of du over the rows of each batch row
// it touches (dpf_part[tile, b - b_first]). Grid (Mp / 64, ceil(hp / 256)).
// Vec: 16-byte loads of g_lex (V % 4 == 0, aligned).
template <bool Vec>
__global__ void __launch_bounds__(kThreads, 2)
    joint_grad_kernel(const Grad p) {
  __shared__ Smem sm;
  __shared__ float gb_s[kM];
  const int m0 = blockIdx.x * kM, n0 = blockIdx.y * kN, ty = threadIdx.x / 32;
  if (threadIdx.x < kM) {
    gb_s[threadIdx.x] = m0 + threadIdx.x < p.M ? p.g_blank[m0 + threadIdx.x]
                                               : 0.f;
  }
  __syncthreads();
  float acc[8][8];
  product(acc, sm, cdiv(p.V, kK),
          RowsAEdge<Vec>{p.g_lex + static_cast<size_t>(m0) * p.V, p.V,
                         p.M - m0, p.V},
          RowsB{p.wt, p.hp, n0, p.hp});
  float bw_part[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) bw_part[j] = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = ty * 8 + i, m = m0 + row;
    const float gb = gb_s[row];  // 0 past M
    const float* jrow = p.joint + static_cast<size_t>(m) * p.hp;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int k = n0 + col(q * 4);
      if (k >= p.hp) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][q * 4 + e] = 0.f;
        continue;
      }
      const float4 j4 = ld4(jrow + k);  // zero past h and M
      const float jt[4] = {j4.x, j4.y, j4.z, j4.w};
      float du[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float w = k + e < p.h ? p.bw[k + e] : 0.f;
        du[e] = m < p.M ? fmaf(gb, w, acc[i][q * 4 + e]) *
                              (1.f - jt[e] * jt[e])
                        : 0.f;
        acc[i][q * 4 + e] = du[e];
        bw_part[q * 4 + e] = fmaf(jt[e], gb, bw_part[q * 4 + e]);
      }
      if (m < p.M) {
        *reinterpret_cast<float4*>(p.du + static_cast<size_t>(m) * p.hp + k) =
            make_float4(du[0], du[1], du[2], du[3]);
      }
    }
  }
  const int tile = blockIdx.x;
  reduce_columns(bw_part, sm, [&](int c, float total) {
    if (n0 + c < p.h) {
      p.dbw_part[static_cast<size_t>(tile) * p.h + n0 + c] = total;
    }
  });
  const int b_first = m0 / p.S;
  const int b_last = (min(m0 + kM, p.M) - 1) / p.S;
  for (int b = b_first; b <= b_last; ++b) {
    float part[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float total = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int m = m0 + ty * 8 + i;
        total += m / p.S == b ? acc[i][j] : 0.f;  // du is 0 past M
      }
      part[j] = total;
    }
    reduce_columns(part, sm, [&](int c, float total) {
      if (n0 + c < p.h) {
        p.dpf_part[(static_cast<size_t>(tile) * p.J + b - b_first) * p.h + n0 +
                   c] = total;
      }
    });
  }
}

// The depth slices [begin, end) of split z of the d_vocab_w contraction
// over the flattened rows (16 rows a slice).
__device__ __forceinline__ void split_range(int M, int& begin, int& end) {
  const int steps = cdiv(M, kK);
  begin = static_cast<int>(static_cast<long long>(steps) * blockIdx.z /
                           gridDim.z);
  end = static_cast<int>(static_cast<long long>(steps) * (blockIdx.z + 1) /
                         gridDim.z);
}

// d_vocab_w partial, rows-major: a (64-hidden, 256-label) tile of joint^T
// g_lex over split z's rows, into dw_part[z] [h, V]. Grid (hp / 64,
// ceil(Vp / 256), splits).
template <bool Vec>
__global__ void __launch_bounds__(kThreads, 2)
    head_grad_rows_kernel(const Grad p) {
  __shared__ Smem sm;
  const int k0 = blockIdx.x * kM, n0 = blockIdx.y * kN, ty = threadIdx.x / 32;
  int begin, end;
  split_range(p.M, begin, end);
  const int d0 = begin * kK;
  float acc[8][8];
  product(acc, sm, end - begin,
          ColsA{p.joint + static_cast<size_t>(d0) * p.hp, p.hp, k0},
          RowsBEdge<Vec>{p.g_lex + static_cast<size_t>(d0) * p.V, p.V, n0,
                         p.V, p.M - d0});
  float* out = p.dw_part + static_cast<size_t>(blockIdx.z) * p.h * p.V;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int k = k0 + ty * 8 + i;
    if (k >= p.h) continue;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int y = n0 + col(q * 4);
      float* dst = out + static_cast<size_t>(k) * p.V + y;
      if (Vec && y + 4 <= p.V) {
        *reinterpret_cast<float4*>(dst) =
            make_float4(acc[i][q * 4], acc[i][q * 4 + 1], acc[i][q * 4 + 2],
                        acc[i][q * 4 + 3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (y + e < p.V) dst[e] = acc[i][q * 4 + e];
        }
      }
    }
  }
}

// d_vocab_w partial, labels-major: a (64-label, 256-hidden) tile of g_lex^T
// joint over split z's rows, into dw_part[z] [V, h] (transposed, so that a
// warp's stores stay contiguous). Grid (Vp / 64, ceil(hp / 256), splits).
template <bool Vec>
__global__ void __launch_bounds__(kThreads, 2)
    head_grad_labels_kernel(const Grad p) {
  __shared__ Smem sm;
  const int l0 = blockIdx.x * kM, n0 = blockIdx.y * kN, ty = threadIdx.x / 32;
  int begin, end;
  split_range(p.M, begin, end);
  const int d0 = begin * kK;
  float acc[8][8];
  product(acc, sm, end - begin,
          ColsAEdge<Vec>{p.g_lex + static_cast<size_t>(d0) * p.V, p.V, l0,
                         p.V, p.M - d0},
          RowsB{p.joint + static_cast<size_t>(d0) * p.hp, p.hp, n0, p.hp});
  float* out = p.dw_part + static_cast<size_t>(blockIdx.z) * p.V * p.h;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int y = l0 + ty * 8 + i;
    if (y >= p.V) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int k = n0 + col(j);
      if (k < p.h) out[static_cast<size_t>(y) * p.h + k] = acc[i][j];
    }
  }
}

// Every partial summed in one launch, in a fixed order (no atomics): job
// (blockIdx.y) 0 d_pc[s] = sum_b du[b S + s] and 3 d_vw = sum_z dw_part[z]
// (labels-major: transposed back), a thread an output; 1 d_pf[b] = sum
// over the tiles t touching batch row b of dpf_part[t, b - b_first(t)] and
// 2 d_bw = sum_t dbw_part[t], a warp an output (up to Mp / 64 terms each:
// one thread's chain of loads would wait on each), its lanes taking every
// 32nd term, then a shuffle tree.
struct Sums {
  const float* du;
  const float* dpf_part;
  const float* dbw_part;
  const float* dw_part;
  float* d_pc;
  float* d_pf;
  float* d_bw;
  float* d_vw;
  int B, S, h, hp, V, J, tiles, splits, labels_major;
};

constexpr int kSumThreads = 256;

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__global__ void __launch_bounds__(kSumThreads) sums_kernel(const Sums p) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kSumThreads + threadIdx.x;
  const long long warp = i / 32;
  const int lane = threadIdx.x % 32;
  const size_t n_vw = static_cast<size_t>(p.h) * p.V;
  switch (blockIdx.y) {
    case 0: {
      if (i >= static_cast<long long>(p.S) * p.h) return;
      const int s = static_cast<int>(i / p.h), k = static_cast<int>(i % p.h);
      float total = 0.f;
#pragma unroll 8
      for (int b = 0; b < p.B; ++b) {
        total += p.du[(static_cast<size_t>(b) * p.S + s) * p.hp + k];
      }
      p.d_pc[i] = total;
      return;
    }
    case 1: {
      if (warp >= static_cast<long long>(p.B) * p.h) return;
      const int b = static_cast<int>(warp / p.h);
      const int k = static_cast<int>(warp % p.h);
      const long long first = static_cast<long long>(b) * p.S;
      const int t0 = static_cast<int>(first / kM);
      const int t1 = static_cast<int>((first + p.S - 1) / kM);
      float total = 0.f;
      for (int t = t0 + lane; t <= t1; t += 32) {
        const int slot = b - static_cast<int>(static_cast<long long>(t) * kM /
                                              p.S);
        total += p.dpf_part[(static_cast<size_t>(t) * p.J + slot) * p.h + k];
      }
      total = warp_sum(total);
      if (lane == 0) p.d_pf[warp] = total;
      return;
    }
    case 2: {
      if (warp >= p.h) return;
      float total = 0.f;
      for (int t = lane; t < p.tiles; t += 32) {
        total += p.dbw_part[static_cast<size_t>(t) * p.h + warp];
      }
      total = warp_sum(total);
      if (lane == 0) p.d_bw[warp] = total;
      return;
    }
    default: {
      if (i >= static_cast<long long>(n_vw)) return;
      float total = 0.f;
#pragma unroll 8
      for (int z = 0; z < p.splits; ++z) total += p.dw_part[z * n_vw + i];
      // labels-major partials are [V, h]: i = y h + k.
      const size_t out = p.labels_major
                             ? static_cast<size_t>(i % p.h) * p.V + i / p.h
                             : static_cast<size_t>(i);
      p.d_vw[out] = total;
      return;
    }
  }
}

// The joint pass and the stored product. `route`: 0 rows-major (the joint
// transposed into joint_t [hp, Mp] first), 1 labels-major.
cudaError_t forward(const float* pc, const float* pf, const float* vw,
                    const float* bw, const float* vb, const float* bb,
                    float* blank, float* lex, float* joint, float* wp,
                    float* joint_t, const Shape& d, int route,
                    cudaStream_t stream) {
  if (route != 0 && route != 1) return cudaErrorInvalidValue;
  constexpr int kWarps = head_product::kPassThreads / 32;
  const auto stage = head_product::vector_loads(d.h, d.V, {pc, pf, vw, bw})
                         ? stage_kernel<true>
                         : stage_kernel<false>;
  stage<<<cdiv(d.Mp + d.hp, kWarps), head_product::kPassThreads, 0, stream>>>(
      pc, pf, vw, bw, bb, joint, wp, blank, d.S, d.h, d.hp, d.V, d.Vp, d.M,
      d.Mp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || d.V == 0) return err;
  const bool vec = d.V % 4 == 0 && reinterpret_cast<uintptr_t>(lex) % 16 == 0;
  if (route == 0) {
    transpose_kernel<<<dim3(d.Mp / 32, d.hp / 32), 256, 0, stream>>>(
        joint, d.hp, d.Mp, d.hp, joint_t, d.Mp);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const auto lex_kernel =
        vec ? lex_rows_kernel<true> : lex_rows_kernel<false>;
    lex_kernel<<<dim3(d.Mp / kM, cdiv(d.Vp, kN)), kThreads, 0, stream>>>(
        joint_t, wp, vb, lex, d.M, d.Mp, d.hp, d.V, d.Vp);
  } else {
    const auto lex_kernel =
        vec ? lex_labels_kernel<true> : lex_labels_kernel<false>;
    lex_kernel<<<dim3(d.Vp / kM, cdiv(d.M, kN)), kThreads, 0, stream>>>(
        joint, wp, vb, lex, d.M, d.hp, d.V, d.Vp);
  }
  return cudaGetLastError();
}

// The staging pass, the d_joint product, the d_vocab_w product split
// `splits` ways over the flattened rows, and one launch of the sums.
// Sizes as joint_head_backward's; B S >= 1, h >= 1, V >= 1.
cudaError_t backward(const float* pc, const float* pf, const float* vw,
                     const float* bw, const float* g_blank,
                     const float* g_lex, float* joint, float* wt, float* du,
                     float* dpf_part, float* dbw_part, float* dw_part,
                     float* d_pc, float* d_pf, float* d_vw, float* d_bw,
                     const Shape& d, int splits, int route,
                     cudaStream_t stream) {
  if (d.h < 1 || d.V < 1 || splits < 1 || (route != 0 && route != 1)) {
    return cudaErrorInvalidValue;
  }
  constexpr int kWarps = head_product::kPassThreads / 32;
  const auto stage = head_product::vector_loads(d.h, d.V, {pc, pf, vw})
                         ? stage_kernel<true>
                         : stage_kernel<false>;
  // The joint's rows only (the grid stops at Mp); the head goes transposed.
  stage<<<cdiv(d.Mp, kWarps), head_product::kPassThreads, 0, stream>>>(
      pc, pf, vw, bw, nullptr, joint, nullptr, nullptr, d.S, d.h, d.hp, d.V,
      d.Vp, d.M, d.Mp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  transpose_kernel<<<dim3(d.hp / 32, d.Vp / 32), 256, 0, stream>>>(
      vw, d.V, d.h, d.V, wt, d.hp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const Grad g{g_lex, g_blank, bw, joint, wt, du, dpf_part, dbw_part,
               dw_part, d.B, d.S, d.h, d.V, d.M, d.hp, d.Vp,
               d.batch_slots()};
  const bool vec =
      d.V % 4 == 0 && reinterpret_cast<uintptr_t>(g_lex) % 16 == 0;
  const int tiles = d.Mp / kM;
  const auto dj_kernel =
      vec ? joint_grad_kernel<true> : joint_grad_kernel<false>;
  dj_kernel<<<dim3(tiles, cdiv(d.hp, kN)), kThreads, 0, stream>>>(g);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (route == 0) {
    const auto dw_kernel =
        vec ? head_grad_rows_kernel<true> : head_grad_rows_kernel<false>;
    dw_kernel<<<dim3(d.hp / kM, cdiv(d.Vp, kN), splits), kThreads, 0,
                stream>>>(g);
  } else {
    const auto dw_kernel =
        vec ? head_grad_labels_kernel<true> : head_grad_labels_kernel<false>;
    dw_kernel<<<dim3(d.Vp / kM, cdiv(d.hp, kN), splits), kThreads, 0,
                stream>>>(g);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const Sums sums{du,   dpf_part, dbw_part, dw_part, d_pc,  d_pf,
                  d_bw, d_vw,     d.B,      d.S,     d.h,   d.hp,
                  d.V,  g.J,      tiles,    splits,  route};
  const long long most = std::max(
      {static_cast<long long>(d.S) * d.h, 32LL * d.B * d.h,
       static_cast<long long>(d.h) * d.V});
  sums_kernel<<<dim3(static_cast<unsigned>((most + kSumThreads - 1) /
                                           kSumThreads),
                     4),
                kSumThreads, 0, stream>>>(sums);
  return cudaGetLastError();
}

}  // namespace fp32

}  // namespace

extern "C" {

// The forward on `stream`; returns the first error (0 on success). dtype 0 =
// float32, 1 = bfloat16 (the compute type); the inputs are float32: pc
// [S, h], pf [B, h], vw [h, V], bw [h], vb [V], bb [1], outputs blank
// [B, S] and lex [B, S, V]. Scratch (hp, Vp: h and V rounded up to 64;
// Mp: B S rounded up to 64):
//   float32: joint float32 [Mp, hp] and head float32 [hp, Vp]; `route` 0
//     runs the product rows-major, on joint_t [hp, Mp] (the joint
//     transposed), 1 labels-major; `blocks` unused.
//   bfloat16: joint bfloat16 [B S, hp] and head bfloat16 [hp, Vp], and the
//     product's persistent grid, `blocks` (1 to its output tiles,
//     ceil(B S / 128) ceil(Vp / 128)); `route` unused.
int joint_head_forward(int dtype, const float* pc, const float* pf,
                       const float* vw, const float* bw, const float* vb,
                       const float* bb, float* blank, float* lex, int B,
                       int S, int h, int V, void* joint, void* head,
                       float* joint_t, int blocks, int route, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (B * S == 0) return 0;
  if (dtype == 1) {
    return static_cast<int>(hopper::forward(
        pc, pf, vw, bw, vb, bb, blank, lex, static_cast<hopper::bf16*>(joint),
        static_cast<hopper::bf16*>(head), B, S, h, V, blocks, s));
  }
  return static_cast<int>(fp32::forward(
      pc, pf, vw, bw, vb, bb, blank, lex, static_cast<float*>(joint),
      static_cast<float*>(head), joint_t, fp32::Shape(B, S, h, V), route, s));
}

// The backward on `stream`; returns the first error. Outputs d_pc [S, h],
// d_pf [B, h], d_vw [h, V], d_bw [h]. The blank cotangent, blank_w and the
// joint of d_bw are rounded to the compute type, as the TPU kernel rounds
// them. h >= 1 and V >= 1. Scratch (hp, Vp: h and V rounded up to 64; t64
// = ceil(S / 64); Mp = B S rounded up to 64, Mp / 64 row tiles; J =
// min(B, 63 / S + 2)):
//   float32 (dtype 0): joint32 [Mp, hp] and head [hp, Vp] (float32), du
//     (in dpc_part's place) [B S, hp], dpf_part [Mp / 64, J, h], dbw_part
//     [Mp / 64, h], dw_part [splits, h, V] (route 0, rows-major) or
//     [splits, V, h] (route 1, labels-major); joint16, d_lex16 and
//     dsplits unused.
//   bfloat16 (dtype 1): joint16 bfloat16 [B S, hp], joint32 float32 [B S,
//     h], d_lex16 bfloat16 [B S, Vp], head bfloat16 [hp, Vp], dpf_part
//     [t64, B, h], dbw_part [B t64, h], dpc_part [dsplits, S, h] (1 <=
//     dsplits <= B), dw_part [splits, h, V]; route unused.
int joint_head_backward(int dtype, const float* pc, const float* pf,
                        const float* vw, const float* bw,
                        const float* g_blank, const float* g_lex,
                        float* dpf_part, float* dbw_part, float* dpc_part,
                        float* dw_part, float* d_pc, float* d_pf,
                        float* d_vw, float* d_bw, int B, int S, int h, int V,
                        int splits, void* joint16, float* joint32,
                        void* d_lex16, void* head, int dsplits, int route,
                        void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
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
  if (dtype == 0) {
    return static_cast<int>(fp32::backward(
        pc, pf, vw, bw, g_blank, g_lex, joint32, static_cast<float*>(head),
        dpc_part, dpf_part, dbw_part, dw_part, d_pc, d_pf, d_vw, d_bw,
        fp32::Shape(B, S, h, V), splits, route, s));
  }
  using hopper::bf16;
  return static_cast<int>(hopper::backward(
      pc, pf, vw, bw, g_blank, g_lex, static_cast<bf16*>(joint16), joint32,
      static_cast<bf16*>(d_lex16), static_cast<bf16*>(head), dpf_part,
      dbw_part, dpc_part, dw_part, d_pc, d_pf, d_vw, d_bw, B, S, h, V, splits,
      dsplits, s));
}

const char* joint_head_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
