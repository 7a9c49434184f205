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

// One frame's vocab-shard reduction and blank head, and its VJP, on Hopper:
// the per-frame kernel pair of the tensor-parallel (vocab-sharded) lattice
// loss.
//
// Replaces the Pallas TPU kernels of last_torch_tpu/ops/sharded_scan.py:
// _frame_reduce_fwd_kernel (pallas_call at sharded_scan.py:354) and
// _frame_reduce_bwd_kernel (pallas_call at :427). For batch row b, context
// state s and label y of the local vocab shard, with T the compute type
// (float32 or bfloat16) and float32 sums:
//
//   joint32[b, s] = tanh(pc[s] + pf[b])                                 [h]
//   lex[b, s, y]  = T(joint32[b, s]) . T(vw[:, y]) + vb[y]
//   blank[b, s]   = T(joint32[b, s]) . T(bw) + bb
//   red[b, y]     = logsumexp_s(vec[b, s] + lex[b, s, y])  (-inf if every
//                   term is)
//
// and, from the cotangents d_red [B, Vl] and d_blank [B, S], as the TPU
// kernel forms them:
//
//   p             = exp(min(vec[b, s] + lex[b, s, y] - safe_red[b, y], 60))
//   d_lex         = T(d_red[b, y] p)    (0 where vec is -inf: never NaN)
//   d_vec[b, s]   = sum_y d_lex,   d_vb = sum_{b, s} d_lex,
//   d_bb          = sum_{b, s} d_blank,
//   d_vw          = sum_{b, s} T(joint32)^T d_lex,
//   du[b, s]      = (d_lex . T(vw)^T + d_blank bw) (1 - joint32^2),
//   d_pc = sum_b du,   d_pf = sum_s du,   d_bw = sum_{b, s} joint32 d_blank,
//
// with safe_red = red where finite, else 0 (the blank terms stay float32).
//
// What bounds it here. The forward is one [B S, h] x [h, Vl + 1] product
// (2 B S h (Vl + 1) = 8.6 GFLOP at B=8, S=1025, h=512, Vl=1024), the
// backward three (lex again, d_joint, d_vw); the inputs and outputs are
// O(B S + S h + h Vl), about 3 MB there, so the products bound both:
// bfloat16 on the tensor cores (989 TFLOP/s peak), float32, kept for exact
// comparison with the plain versions, on the CUDA cores (67 TFLOP/s). A
// tensor-parallel step launches each 3200 times, so a call's few launches
// and its host work count too.
//
// What the design does about it:
// * The bfloat16 forward (namespace hopper) runs on head_product.cuh, the
//   machinery it shares with the joint+head forward and the bigram
//   log-partition forward, in three launches: the joint pass forms each
//   joint entry's tanh once per call into a bfloat16 [B, S, hp] scratch
//   (8.4 MB at the headline shape, resident in the L2 cache), with the
//   blank head from the rounded row and the padded bfloat16 head [hp, Vp]
//   from the float32 shard; the column-reduce product runs on wgmma with
//   TMA operands (two consumer warpgroups sharing each head strip, a
//   persistent grid of at most two blocks an SM) and folds lex into one
//   online (max, sum) pair per (64-state unit, b, y) in its epilogue, so
//   that the [B, S, Vl] lex never reaches device memory; merge_kernel
//   combines the units' pairs, with no atomics.
// * The float32 forward forms the joint as joint_tiles.cuh's FMA products
//   stage it, over (batch row, 64-state tile, 64-label strip) blocks, each
//   folding its tile into a (max, sum) partial per (b, y) at once, merged
//   by the same second launch; the blocks of the first strip also write
//   the blank head.
// * The bfloat16 backward (namespace hopper) runs its three products on
//   wgmma (wgmma_tiles.cuh: TMA into a 4-stage mbarrier ring, two blocks an
//   SM). stage_kernel writes the bfloat16 joint and head once (padded to
//   multiples of 64) and the float32 joint; lex_grad_kernel recomputes lex
//   per (row, 64-state tile, 128-label strip) and in its epilogue writes
//   d_lex once, in bfloat16 (its values are rounded to bfloat16 anyway),
//   with its row sums (d_vec) and column sums (d_vb) as one partial per
//   block, and the d_blank sums (d_bb); head_grads.cuh's two products then
//   read d_lex once each (d_joint with the tanh derivative and the unrounded
//   float32 blank terms in its epilogue, d_pc kept in registers across the
//   rows of a block; d_vw split over the (row, state) depth), and one launch
//   sums every partial. Five launches, one workspace allocation. At Vl=256
//   (one of 4 shards) the grid is 8 x 17 x 2 blocks of 64 x 128: still more
//   than a block per SM. d_joint does not share the d_lex block: holding a
//   state tile's [64, h] d_joint beside its lex strip needs more registers
//   than two blocks an SM leave.
// * The float32 backward recomputes each lex tile on the CUDA cores into a
//   float32 d_lex, reduced by small launches and joint_tiles.cuh's
//   joint_backward.
// * The TPU kernel's tile-major [NV, h, Vt] / [NS, Bt, s_tile] layouts, its
//   fori_loop spill workarounds, the 128-lane alignment of S and Vl and its
//   VMEM limit are not needed: the kernels take any B, S, h and Vl.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "head_grads.cuh"
#include "head_product.cuh"
#include "joint_tiles.cuh"

namespace {

using namespace joint_tiles;

// Rows of d_lex summed per partial of d_vb.
constexpr int kColumnChunk = 64;

// Folds x into the online (max m, sum s of exp(. - m)); -inf adds nothing.
__device__ __forceinline__ void online_add(float& m, float& s, float x) {
  if (x > m) {
    s = s * expf(m - x) + 1.f;
    m = x;
  } else if (x > -INFINITY) {
    s += expf(x - m);
  }
}

// Merges the partial (m2, s2) into (m, s); an empty partial has s2 = 0.
__device__ __forceinline__ void online_merge(float& m, float& s, float m2,
                                             float s2) {
  if (s2 == 0.f) return;
  if (m2 > m) {
    s = s * expf(m - m2) + s2;
    m = m2;
  } else {
    s += s2 * expf(m2 - m);
  }
}

// d_lex of one (b, s, y), rounded to the compute type.
template <bool Bf16>
__device__ __forceinline__ float lex_cotangent(float vec, float lex,
                                               float red, float d_red) {
  const float safe = isfinite(red) ? red : 0.f;
  const float d = d_red * expf(fminf(vec + lex - safe, 60.f));
  return Bf16 ? bf16_round(d) : d;
}

// ---------------------------------------------------------------------------
// float32: 64 x 64 tiles through FMAs.

// The lex tile of (batch row b, states s0.., labels n0..) into acc (vb not
// added). Grid (B * ceil(S / 64), ceil(V / 64)): blockIdx.x = b * state
// tiles + state tile.
struct TileF32 {
  int b, st, s0, n0, rows;
  __device__ TileF32(int S) {
    const int s_tiles = tiles(S, kBM);
    b = blockIdx.x / s_tiles;
    st = blockIdx.x % s_tiles;
    s0 = st * kBM;
    n0 = blockIdx.y * kBN;
    rows = min(kBM, S - s0);
  }
};

__device__ __forceinline__ void lex_tile_f32(
    float (&acc)[kTM][kTN], const TileF32& t, const float* __restrict__ pc,
    const float* __restrict__ pf, const float* __restrict__ vw, int h,
    int V) {
  const float* pf_b = pf + static_cast<size_t>(t.b) * h;
  const float* pc_s = pc + static_cast<size_t>(t.s0) * h;
  auto joint = [&](int r, int k) {
    return r < t.rows ? tanhf(pc_s[static_cast<size_t>(r) * h + k] + pf_b[k])
                      : 0.f;
  };
  auto head = [&](int k, int c) {
    return t.n0 + c < V ? vw[static_cast<size_t>(k) * V + t.n0 + c] : 0.f;
  };
  zero(acc);
  accumulate<false, false>(acc, joint, head, 0, h);
}

// The (max, sum) partials [state tiles, B, V] and, in the first strip, the
// blank head.
__global__ void __launch_bounds__(kThreads)
    reduce_f32_kernel(const float* __restrict__ vec,  // [B, S]
                      const float* __restrict__ pc,   // [S, h]
                      const float* __restrict__ pf,   // [B, h]
                      const float* __restrict__ vw,   // [h, V]
                      const float* __restrict__ vb,   // [V]
                      const float* __restrict__ bw,   // [h]
                      const float* __restrict__ bb,   // [1]
                      float* __restrict__ part_m, float* __restrict__ part_s,
                      float* __restrict__ blank,      // [B, S]
                      int B, int S, int h, int V) {
  __shared__ float cand_m[kBM / kTM][kBN];
  __shared__ float cand_s[kBM / kTM][kBN];
  const TileF32 t(S);
  const int tid = threadIdx.x;
  const int tx = tid % (kBN / kTN), ty = tid / (kBN / kTN);
  float acc[kTM][kTN];
  lex_tile_f32(acc, t, pc, pf, vw, h, V);
  const float* vec_b = vec + static_cast<size_t>(t.b) * S + t.s0;
#pragma unroll
  for (int j = 0; j < kTN; ++j) {
    const int y = t.n0 + tx * kTN + j;
    float m = -INFINITY, s = 0.f;
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const int r = ty * kTM + i;
      if (r < t.rows && y < V) online_add(m, s, vec_b[r] + (acc[i][j] + vb[y]));
    }
    cand_m[ty][tx * kTN + j] = m;
    cand_s[ty][tx * kTN + j] = s;
  }
  __syncthreads();
  if (tid < kBN && t.n0 + tid < V) {
    float m = -INFINITY, s = 0.f;
    for (int g = 0; g < kBM / kTM; ++g) online_merge(m, s, cand_m[g][tid], cand_s[g][tid]);
    const size_t at = (static_cast<size_t>(t.st) * B + t.b) * V + t.n0 + tid;
    part_m[at] = m;
    part_s[at] = s;
  }
  if (blockIdx.y == 0) {
    const int warp = tid / 32, lane = tid % 32;
    const float* pf_b = pf + static_cast<size_t>(t.b) * h;
    for (int row = warp; row < t.rows; row += kThreads / 32) {
      const float* pc_s = pc + static_cast<size_t>(t.s0 + row) * h;
      float dot = 0.f;
      for (int k = lane; k < h; k += 32) {
        dot = fmaf(tanhf(pc_s[k] + pf_b[k]), bw[k], dot);
      }
      for (int o = 16; o > 0; o >>= 1) {
        dot += __shfl_xor_sync(0xffffffffu, dot, o);
      }
      if (lane == 0) blank[static_cast<size_t>(t.b) * S + t.s0 + row] = dot + bb[0];
    }
  }
}

// d_lex [B, S, V] for the tile.
__global__ void __launch_bounds__(kThreads)
    lex_grad_f32_kernel(const float* __restrict__ vec, const float* __restrict__ pc,
                        const float* __restrict__ pf, const float* __restrict__ vw,
                        const float* __restrict__ vb, const float* __restrict__ red,
                        const float* __restrict__ d_red,
                        float* __restrict__ d_lex, int B, int S, int h, int V) {
  const TileF32 t(S);
  const int tx = threadIdx.x % (kBN / kTN), ty = threadIdx.x / (kBN / kTN);
  float acc[kTM][kTN];
  lex_tile_f32(acc, t, pc, pf, vw, h, V);
  const size_t row0 = static_cast<size_t>(t.b) * S + t.s0;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int r = ty * kTM + i;
    if (r >= t.rows) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int y = t.n0 + tx * kTN + j;
      if (y >= V) continue;
      const size_t by = static_cast<size_t>(t.b) * V + y;
      d_lex[(row0 + r) * V + y] = lex_cotangent<false>(
          vec[row0 + r], acc[i][j] + vb[y], red[by], d_red[by]);
    }
  }
}

// ---------------------------------------------------------------------------
// Merges and reductions.

// red [B, V] from the partials [state tiles, B, V].
__global__ void __launch_bounds__(kPointThreads)
    merge_kernel(const float* __restrict__ part_m,
                 const float* __restrict__ part_s, int s_tiles, size_t n,
                 float* __restrict__ red) {
  const size_t i = static_cast<size_t>(blockIdx.x) * kPointThreads +
                   threadIdx.x;
  if (i >= n) return;
  // Latency-bound: 8 tiles' loads in flight before their merges.
  float m = -INFINITY, s = 0.f;
  for (int q0 = 0; q0 < s_tiles; q0 += 8) {
    float pm[8], ps[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      pm[k] = q0 + k < s_tiles ? part_m[(q0 + k) * n + i] : -INFINITY;
      ps[k] = q0 + k < s_tiles ? part_s[(q0 + k) * n + i] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) online_merge(m, s, pm[k], ps[k]);
  }
  red[i] = s == 0.f ? -INFINITY : m + logf(s);
}

// out[r] = sum_c in[r * n + c], one warp per row.
__global__ void __launch_bounds__(kPointThreads)
    row_sum_kernel(const float* __restrict__ in, int rows, int n,
                   float* __restrict__ out) {
  const int r = blockIdx.x * (kPointThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (r >= rows) return;
  const float* p = in + static_cast<size_t>(r) * n;
  float total = 0.f;
  for (int c = lane; c < n; c += 32) total += p[c];
  for (int o = 16; o > 0; o >>= 1) {
    total += __shfl_xor_sync(0xffffffffu, total, o);
  }
  if (lane == 0) out[r] = total;
}

// out[q, c] = sum of in[r, c] over the kColumnChunk rows r of chunk q.
// Grid (ceil(n / 256), ceil(rows / kColumnChunk)).
__global__ void __launch_bounds__(kPointThreads)
    column_chunk_kernel(const float* __restrict__ in, int rows, int n,
                        float* __restrict__ out) {
  const int c = blockIdx.x * kPointThreads + threadIdx.x;
  if (c >= n) return;
  const int r0 = blockIdx.y * kColumnChunk, r1 = min(rows, r0 + kColumnChunk);
  float total = 0.f;
  for (int r = r0; r < r1; ++r) total += in[static_cast<size_t>(r) * n + c];
  out[static_cast<size_t>(blockIdx.y) * n + c] = total;
}

inline int row_blocks(int rows) {
  return (rows + kPointThreads / 32 - 1) / (kPointThreads / 32);
}

// ---------------------------------------------------------------------------
// bfloat16 backward: wgmma products (wgmma_tiles.cuh, head_grads.cuh).

namespace hopper {

using namespace head_grads;
using wgmma_tiles::kBK;
using wgmma_tiles::kBN;

// The products' operands in bfloat16, padded with zeros: joint [B, S, hp] =
// tanh(pc[s] + pf[b]) and vw16 [hp, Vp]; and joint32 [B, S, h], the float32
// tanh. Grid (ceil(max(hp, Vp) / 512), B S + hp): blockIdx.y is a joint
// row (b S + s) or, past them, a row of the head; a thread writes one
// bfloat16 pair.
__global__ void __launch_bounds__(kSumThreads)
    stage_kernel(const float* __restrict__ pc, const float* __restrict__ pf,
                 const float* __restrict__ vw, bf16* __restrict__ joint,
                 float* __restrict__ joint32, bf16* __restrict__ vw16, int B,
                 int S, int h, int hp, int V, int Vp) {
  const int row = blockIdx.y;
  const int k = (blockIdx.x * kSumThreads + threadIdx.x) * 2;
  float x[2];
  if (row < B * S) {
    if (k >= hp) return;
    const float* pc_s = pc + static_cast<size_t>(row % S) * h;
    const float* pf_b = pf + static_cast<size_t>(row / S) * h;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      x[e] = k + e < h ? tanhf(pc_s[k + e] + pf_b[k + e]) : 0.f;
    }
    *reinterpret_cast<__nv_bfloat162*>(joint + static_cast<size_t>(row) * hp +
                                       k) = __floats2bfloat162_rn(x[0], x[1]);
    float* out32 = joint32 + static_cast<size_t>(row) * h + k;
    if (k + 1 < h && h % 2 == 0) {
      *reinterpret_cast<float2*>(out32) = make_float2(x[0], x[1]);
    } else {
      for (int e = 0; e < 2 && k + e < h; ++e) out32[e] = x[e];
    }
  } else {
    const int hh = row - B * S;
    if (k >= Vp) return;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      x[e] = hh < h && k + e < V ? vw[static_cast<size_t>(hh) * V + k + e]
                                 : 0.f;
    }
    *reinterpret_cast<__nv_bfloat162*>(vw16 + static_cast<size_t>(hh) * Vp +
                                       k) = __floats2bfloat162_rn(x[0], x[1]);
  }
}

// The lexical cotangent of a (batch row, 64-state tile, 128-label strip):
// lex on wgmma (A = joint, K-major; B = vw16, MN-major) plus vb, then d_lex
// = T(d_red exp(min(vec + lex - safe red, 60))) into d_lex [B, S, Vp] (zero
// past V), its sums over the strip into dvec_part [strips, B, S] and over
// the tile into dvb_part [B ceil(S / 64), V]; the first strip's blocks
// also sum d_blank over their tile into dbb_part [B ceil(S / 64)].
struct LexGrad {
  const float* vb;       // [V]
  const float* vec;      // [B, S]
  const float* red;      // [B, V]
  const float* d_red;    // [B, V]
  const float* d_blank;  // [B, S]
  bf16* d_lex;
  float* dvec_part;
  float* dvb_part;
  float* dbb_part;
  int B, S, hp, V, Vp;
};

// Epilogue scratch: the strip's vb, red and d_red, and per consumer warp a
// row of kBN column sums.
constexpr int kLexGradExtra = 7 * kBN * 4;

// Grid (B * ceil(S / 64), ceil(Vp / 128)).
__global__ void __launch_bounds__(wgmma_tiles::kThreads, 2)
    lex_grad_kernel(const __grid_constant__ Maps maps, const LexGrad p) {
  extern __shared__ uint8_t raw[];
  const Ring<4> ring(raw);
  const int row_tiles = cdiv(p.S, 64);
  const int b = blockIdx.x / row_tiles, tile = blockIdx.x % row_tiles;
  const int s0 = tile * 64, n0 = blockIdx.y * kBN;
  const size_t row0 = static_cast<size_t>(b) * p.S;
  if (ring.producer()) {
    produce(ring, p.hp / kBK, [&](int q, uint8_t* a, uint8_t* bt,
                                  uint64_t* bar) {
      tma_load(a, maps.joint, q * kBK, s0, b, bar);
      tma_load(bt, maps.vw, n0, q * kBK, bar);
      tma_load(bt + wgmma_tiles::kBox, maps.vw, n0 + 64, q * kBK, bar);
    });
    return;
  }
  // The strip's per-label operands, staged under the first products.
  float* vb = reinterpret_cast<float*>(ring.extra);  // [kBN]
  float* rd = vb + kBN;                              // [kBN]
  float* drd = rd + kBN;                             // [kBN]
  float* red = drd + kBN;                            // [warps][kBN]
  {
    const int t = threadIdx.x, y = n0 + t;
    const bool in = y < p.V;
    const size_t by = static_cast<size_t>(b) * p.V + y;
    vb[t] = in ? p.vb[y] : 0.f;
    rd[t] = in ? p.red[by] : 0.f;
    drd[t] = in ? p.d_red[by] : 0.f;
  }
  named_barrier(1, wgmma_tiles::kConsumers);
  float d[64];
  consume<false, true>(ring, 1, p.hp / kBK, d, [](int, float(&)[64]) {});
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int srow[2];
  float vec[2], rs[2] = {0.f, 0.f};
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    srow[half] = s0 + acc_row(half * 2);
    vec[half] = srow[half] < p.S ? p.vec[row0 + srow[half]] : -INFINITY;
  }
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    const int y0 = n0 + j * 8 + (lane % 4) * 2;
    float dv[2][2], cs[2] = {0.f, 0.f};
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int y = y0 + e;
      const bool in = y < p.V;
      const float bias = vb[y - n0], r = rd[y - n0], dr = drd[y - n0];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float v =
            in && srow[half] < p.S
                ? lex_cotangent<true>(vec[half], d[j * 4 + half * 2 + e] + bias,
                                      r, dr)
                : 0.f;
        dv[half][e] = v;
        cs[e] += v;
        rs[half] += v;
      }
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      if (srow[half] < p.S && y0 < p.Vp) {
        *reinterpret_cast<__nv_bfloat162*>(p.d_lex + (row0 + srow[half]) *
                                                         p.Vp + y0) =
            __floats2bfloat162_rn(dv[half][0], dv[half][1]);
      }
    }
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        cs[e] += __shfl_xor_sync(0xffffffffu, cs[e], o);
      }
    }
    if (lane < 4) {
      red[warp * kBN + j * 8 + lane * 2] = cs[0];
      red[warp * kBN + j * 8 + lane * 2 + 1] = cs[1];
    }
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    for (int o = 1; o < 4; o <<= 1) {
      rs[half] += __shfl_xor_sync(0xffffffffu, rs[half], o);
    }
    if (lane % 4 == 0 && srow[half] < p.S) {
      p.dvec_part[(static_cast<size_t>(blockIdx.y) * p.B + b) * p.S +
                  srow[half]] = rs[half];
    }
  }
  named_barrier(1, wgmma_tiles::kConsumers);
  const int t = threadIdx.x, y = n0 + t;
  if (y < p.V) {
    float total = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) total += red[w * kBN + t];
    p.dvb_part[(static_cast<size_t>(b) * row_tiles + tile) * p.V + y] = total;
  }
  if (blockIdx.y == 0 && t < 32) {
    const int s = s0 + t;
    float total = (s < p.S ? p.d_blank[row0 + s] : 0.f) +
                  (s + 32 < p.S ? p.d_blank[row0 + s + 32] : 0.f);
    for (int o = 16; o > 0; o >>= 1) {
      total += __shfl_xor_sync(0xffffffffu, total, o);
    }
    if (t == 0) p.dbb_part[static_cast<size_t>(b) * row_tiles + tile] = total;
  }
}

// The bfloat16 backward: the operands staged, the cotangent product, the
// two gradient products of head_grads.cuh (rows 0..B-1 all live, partials
// written, not added) and one launch of the sums. Sizes as
// frame_reduce_backward's.
int backward(const float* vec, const float* pf, const float* pc,
             const float* vw, const float* vb, const float* bw,
             const float* red, const float* d_red, const float* d_blank,
             bf16* d_lex, float* dvb_part, float* dpf_part, float* dbw_part,
             float* dpc_part, float* dw_part, float* d_vec, float* d_pf,
             float* d_pc, float* d_vw, float* d_vb, float* d_bw, float* d_bb,
             bf16* joint, float* joint32, bf16* vw16, float* dvec_part,
             float* dbb_part, int B, int S, int h, int V, int splits,
             int dsplits, cudaStream_t s) {
  if (splits < 1 || dsplits < 1 || dsplits > std::max(B, 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0 || S == 0) {  // no rows: every gradient is zero
    const struct {
      float* out;
      int n;
    } outs[] = {{d_pf, B * h}, {d_pc, S * h}, {d_vw, h * V},
                {d_vb, V},     {d_bw, h},     {d_bb, 1}};
    for (const auto& out : outs) {
      RETURN_IF_FAILED(cudaMemsetAsync(out.out, 0, out.n * sizeof(float), s));
    }
    return 0;
  }
  const int hp = round_up(h, kBK), Vp = round_up(V, kBK);
  const int strips = cdiv(Vp, kBN), t64 = cdiv(S, 64);
  stage_kernel<<<dim3(cdiv(std::max(hp, Vp), 2 * kSumThreads), B * S + hp),
                 kSumThreads, 0, s>>>(pc, pf, vw, joint, joint32, vw16, B, S,
                                      h, hp, V, Vp);
  RETURN_IF_LAUNCH_FAILED();
  Maps maps;
  RETURN_IF_FAILED(make_maps(&maps, joint, d_lex, vw16, B, S, S, hp, Vp));
  constexpr int kSmem = smem_bytes(4, kLexGradExtra);
  RETURN_IF_FAILED(allow_smem<lex_grad_kernel>(kSmem));
  lex_grad_kernel<<<dim3(B * t64, strips), wgmma_tiles::kThreads, kSmem, s>>>(
      maps, LexGrad{vb, vec, red, d_red, d_blank, d_lex, dvec_part, dvb_part,
                    dbb_part, B, S, hp, V, Vp});
  RETURN_IF_LAUNCH_FAILED();
  RETURN_IF_FAILED(launch_joint_grad(
      maps,
      JointGrad{bw, d_blank, joint32, nullptr, dpf_part, dbw_part, dpc_part,
                B, B, S, h, Vp, 0, 0, S},
      hp, dsplits, s));
  RETURN_IF_FAILED(launch_head_grad(
      maps, HeadGrad{nullptr, dw_part, B, S, h, V, 0}, hp, Vp, splits, s));
  Sums sums{};
  const auto add = [&](const float* in, int rows, int n, float* out) {
    sums.job[sums.count++] = {in, rows, n, out};
  };
  add(dvec_part, strips, B * S, d_vec);
  add(dvb_part, B * t64, V, d_vb);
  add(dbb_part, B * t64, 1, d_bb);
  add(dpf_part, t64, B * h, d_pf);
  add(dbw_part, B * t64, h, d_bw);
  add(dpc_part, dsplits, S * h, d_pc);
  add(dw_part, splits, h * V, d_vw);
  RETURN_IF_FAILED(launch_sums(sums, s));
  return 0;
}

// The bfloat16 forward: the joint pass (joint [B, S, hp], blank and vw16
// [hp, Vp]), the column-reduce product over vec on at most max_blocks
// persistent blocks (head_product.cuh; partials [ceil(S / 64), B, V]), and
// the merge. Sizes as frame_reduce_forward's.
int forward(const float* vec, const float* pf, const float* pc,
            const float* vw, const float* vb, const float* bw,
            const float* bb, float* part_m, float* part_s, float* red,
            float* blank, bf16* joint, bf16* vw16, int B, int S, int h,
            int V, int max_blocks, cudaStream_t s) {
  const int hp = round_up(h, kBK), Vp = round_up(V, kBK);
  RETURN_IF_FAILED(head_product::joint_pass(pc, pf, vw, bw, bb, nullptr,
                                            joint, vw16, blank, B, S, h, V,
                                            /*head=*/true, s));
  const head_product::ColumnReduce p{vb, vec, nullptr, part_m, part_s,
                                     nullptr, B, S, V, hp, Vp, B};
  RETURN_IF_FAILED(head_product::reduce_product(joint, vw16, p, max_blocks, s));
  const size_t n = static_cast<size_t>(B) * V;
  merge_kernel<<<blocks_for(n), kPointThreads, 0, s>>>(part_m, part_s,
                                                       cdiv(S, 64), n, red);
  RETURN_IF_LAUNCH_FAILED();
  return 0;
}

}  // namespace hopper

}  // namespace

extern "C" {

// The forward on `stream`; returns the first error (0 on success). dtype 0
// = float32, 1 = bfloat16 (the compute type); every pointer is float32:
// vec [B, S], pf [B, h], pc [S, h], vw [h, V], vb [V], bw [h], bb [1];
// outputs red [B, V] and blank [B, S]; scratch part_m, part_s [ceil(S /
// 64), B, V]. bfloat16 also takes the scratch joint16 [B, S, hp] and vw16
// [hp, Vp] (bfloat16; hp, Vp: h and V rounded up to 64) and the product's
// largest persistent grid, max_blocks (>= 1); float32 ignores them. V >= 1.
int frame_reduce_forward(int dtype, const float* vec, const float* pf,
                         const float* pc, const float* vw, const float* vb,
                         const float* bw, const float* bb, float* part_m,
                         float* part_s, float* red, float* blank, int B,
                         int S, int h, int V, void* joint16, void* vw16,
                         int max_blocks, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((dtype != 0 && dtype != 1) || V < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0) return 0;
  if (dtype == 1) {
    using hopper::bf16;
    return hopper::forward(vec, pf, pc, vw, vb, bw, bb, part_m, part_s, red,
                           blank, static_cast<bf16*>(joint16),
                           static_cast<bf16*>(vw16), B, S, h, V, max_blocks,
                           s);
  }
  const int s_tiles = tiles(S, kBM);
  reduce_f32_kernel<<<dim3(B * s_tiles, tiles(V, kBN)), kThreads, 0, s>>>(
      vec, pc, pf, vw, vb, bw, bb, part_m, part_s, blank, B, S, h, V);
  RETURN_IF_LAUNCH_FAILED();
  const size_t n = static_cast<size_t>(B) * V;
  merge_kernel<<<blocks_for(n), kPointThreads, 0, s>>>(part_m, part_s,
                                                       s_tiles, n, red);
  RETURN_IF_LAUNCH_FAILED();
  return 0;
}

// The backward on `stream`; returns the first error. Inputs as the forward's
// and red [B, V] (its output), d_red [B, V], d_blank [B, S]; outputs d_vec
// [B, S], d_pf [B, h], d_pc [S, h], d_vw [h, V], d_vb [V], d_bw [h], d_bb
// [1]. V >= 1. Scratch (hp, Vp: h and V rounded up to 64, t64 = ceil(S /
// 64)):
//   float32 (dtype 0): d_lex float32 [B, S, V], dvb_part [ceil(B S / 64),
//     V], and joint_backward's (joint_tiles.cuh) dpf_part, dbw_part,
//     dw_part with `splits`; the rest unused.
//   bfloat16 (dtype 1): d_lex bfloat16 [B, S, Vp], joint bfloat16 [B, S,
//     hp], joint32 float32 [B, S, h], vw16 bfloat16 [hp, Vp], dvec_part
//     [ceil(Vp / 128), B, S], dvb_part [B t64, V], dbb_part [B t64],
//     dpf_part [t64, B, h], dbw_part [B t64, h], dpc_part [dsplits, S, h]
//     (1 <= dsplits <= B), dw_part [splits, h, V].
int frame_reduce_backward(int dtype, const float* vec, const float* pf,
                          const float* pc, const float* vw, const float* vb,
                          const float* bw, const float* red,
                          const float* d_red, const float* d_blank,
                          void* d_lex, float* dvb_part, float* dpf_part,
                          float* dbw_part, float* dpc_part, float* dw_part,
                          float* d_vec, float* d_pf, float* d_pc, float* d_vw,
                          float* d_vb, float* d_bw, float* d_bb, void* joint,
                          float* joint32, void* vw16, float* dvec_part,
                          float* dbb_part, int B, int S, int h, int V,
                          int splits, int dsplits, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((dtype != 0 && dtype != 1) || V < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == 1) {
    using hopper::bf16;
    return hopper::backward(
        vec, pf, pc, vw, vb, bw, red, d_red, d_blank,
        static_cast<bf16*>(d_lex), dvb_part, dpf_part, dbw_part, dpc_part,
        dw_part, d_vec, d_pf, d_pc, d_vw, d_vb, d_bw, d_bb,
        static_cast<bf16*>(joint), joint32, static_cast<bf16*>(vw16),
        dvec_part, dbb_part, B, S, h, V, splits, dsplits, s);
  }
  float* d_lex32 = static_cast<float*>(d_lex);
  const int M = B * S;
  if (M > 0) {
    lex_grad_f32_kernel<<<dim3(B * tiles(S, kBM), tiles(V, kBN)), kThreads,
                          0, s>>>(vec, pc, pf, vw, vb, red, d_red, d_lex32,
                                  B, S, h, V);
    RETURN_IF_LAUNCH_FAILED();
    row_sum_kernel<<<row_blocks(M), kPointThreads, 0, s>>>(d_lex32, M, V,
                                                           d_vec);
    RETURN_IF_LAUNCH_FAILED();
    column_chunk_kernel<<<dim3(blocks_for(V), tiles(M, kColumnChunk)),
                          kPointThreads, 0, s>>>(d_lex32, M, V, dvb_part);
    RETURN_IF_LAUNCH_FAILED();
  }
  row_sum_kernel<<<1, kPointThreads, 0, s>>>(d_blank, 1, M, d_bb);
  RETURN_IF_LAUNCH_FAILED();
  const Sum sums[] = {{dvb_part, tiles(M, kColumnChunk),
                       static_cast<size_t>(V), d_vb}};
  const int status = sum_all(sums, s);
  if (status != 0) return status;
  return joint_backward(pc, pf, vw, bw, d_blank, d_lex32, dpf_part, dbw_part,
                        dw_part, d_pc, d_pf, d_vw, d_bw, B, S, h, V, splits,
                        s);
}

const char* frame_reduce_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
