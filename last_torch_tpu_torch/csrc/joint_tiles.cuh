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

// The joint network's tile products and backward, shared by joint_head.cu
// (every context state's joint and heads) and sharded_scan.cu (one frame's
// vocab-shard reduction; its float32 forward and both backwards). Rows m = b * S + s run over the (batch row,
// context state) pairs; joint32[m] = tanh(pc[s] + pf[b]) is formed as the
// products stage their operands and never reaches device memory.
//
// * float32: 64 x 64 tiles through FMAs on the CUDA cores (`accumulate`,
//   operands from producers).
// * bfloat16: 128 x 128 tiles through WMMA (`mainloop`, `drain`), 16-deep
//   stages read into registers under the previous stage's products; the
//   producers (CotRows, HeadRowsT, ...) read one operand entry or four.
// * `joint_backward`: from the cotangents g_lex [B, S, V] and g_blank
//   [B, S], the gradients d_pc, d_pf, d_vocab_w and d_blank_w (the
//   contract of joint_head_backward in joint_head.cu). With round_blank
//   the blank cotangent, blank_w and the joint of d_blank_w are rounded to
//   the compute type, as the joint+head TPU kernel rounds them; without it
//   they stay float32, as the frame-reduce TPU kernel keeps them.
//   Partials belong to one block each and are reduced by a second launch:
//   no atomics.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include <initializer_list>

#include "tile_product.cuh"

namespace joint_tiles {

using namespace lattice_tiles;

constexpr int kPointThreads = 256;

// ---------------------------------------------------------------------------
// float32: 64 x 64 tiles through FMAs.

// acc += sum_{d in [d0, d1)} A(r, d) B(d, c) over the 64 x 64 tile (a 4 x 4
// block per thread: rows ty * kTM + i, columns tx * kTN + j), where a(r, d)
// and b(d, c) produce the operands (0 outside them). AT / BT name the
// producers' contiguous axis in device memory (AT: r, else d; BT: d, else
// c), which the staging walks with consecutive threads. Every thread of the
// block must call it (it synchronises).
template <bool AT, bool BT, class AF, class BF>
__device__ __forceinline__ void accumulate(float (&acc)[kTM][kTN],
                                           const AF& a, const BF& b, int d0,
                                           int d1) {
  __shared__ float a_tile[kBK][kBM + 4];  // [d][r]
  __shared__ float b_tile[kBK][kBN];      // [d][c]
  const int tid = threadIdx.x;
  const int tx = tid % (kBN / kTN), ty = tid / (kBN / kTN);
  for (int k0 = d0; k0 < d1; k0 += kBK) {
    for (int idx = tid; idx < kBM * kBK; idx += kThreads) {
      const int r = AT ? idx % kBM : idx / kBK;
      const int c = AT ? idx / kBM : idx % kBK;
      a_tile[c][r] = k0 + c < d1 ? a(r, k0 + c) : 0.f;
    }
    for (int idx = tid; idx < kBK * kBN; idx += kThreads) {
      const int r = BT ? idx % kBK : idx / kBN;
      const int c = BT ? idx / kBK : idx % kBN;
      b_tile[r][c] = k0 + r < d1 ? b(k0 + r, c) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float x[kTM], w[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) x[i] = a_tile[kk][ty * kTM + i];
#pragma unroll
      for (int j = 0; j < kTN; ++j) w[j] = b_tile[kk][tx * kTN + j];
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
#pragma unroll
        for (int j = 0; j < kTN; ++j) {
          acc[i][j] = fmaf(x[i], w[j], acc[i][j]);
        }
      }
    }
    __syncthreads();
  }
}

__device__ __forceinline__ void zero(float (&acc)[kTM][kTN]) {
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;
  }
}


// du for a (64-state, 64-hidden) tile, batch row by batch row: d_pc summed
// in registers, the state sums of du into dpf_part [S tiles, B, h] and of
// joint32 g_blank into dbw_part [S tiles, h]. Grid (ceil(S / 64),
// ceil(h / 64)).
__global__ void __launch_bounds__(kThreads)
    joint_grad_f32_kernel(const float* __restrict__ pc,       // [S, h]
                          const float* __restrict__ pf,       // [B, h]
                          const float* __restrict__ vw,       // [h, V]
                          const float* __restrict__ bw,       // [h]
                          const float* __restrict__ g_blank,  // [B, S]
                          const float* __restrict__ g_lex,    // [B, S, V]
                          float* __restrict__ dpf_part,
                          float* __restrict__ dbw_part,
                          float* __restrict__ d_pc,           // [S, h]
                          int B, int S, int h, int V) {
  __shared__ float cand_f[kBM / kTM][kBN];
  __shared__ float cand_w[kBM / kTM][kBN];
  const int s0 = blockIdx.x * kBM, k0 = blockIdx.y * kBN;
  const int tid = threadIdx.x;
  const int tx = tid % (kBN / kTN), ty = tid / (kBN / kTN);
  float acc_pc[kTM][kTN];
  zero(acc_pc);
  float run_bw = 0.f;  // column k0 + tid, tid < 64
  for (int b = 0; b < B; ++b) {
    const size_t row0 = static_cast<size_t>(b) * S + s0;
    auto cot = [&](int r, int y) {
      return s0 + r < S ? g_lex[(row0 + r) * V + y] : 0.f;
    };
    auto head_t = [&](int y, int c) {
      return k0 + c < h ? vw[static_cast<size_t>(k0 + c) * V + y] : 0.f;
    };
    float dj[kTM][kTN];
    zero(dj);
    accumulate<false, true>(dj, cot, head_t, 0, V);
    float col_f[kTN], col_w[kTN];
#pragma unroll
    for (int j = 0; j < kTN; ++j) col_f[j] = col_w[j] = 0.f;
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const int s = s0 + ty * kTM + i;
      if (s >= S) continue;
      const float gb = g_blank[row0 + ty * kTM + i];
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const int k = k0 + tx * kTN + j;
        if (k >= h) continue;
        const float jt = tanhf(pc[static_cast<size_t>(s) * h + k] +
                               pf[static_cast<size_t>(b) * h + k]);
        const float du = fmaf(gb, bw[k], dj[i][j]) * (1.f - jt * jt);
        acc_pc[i][j] += du;
        col_f[j] += du;
        col_w[j] = fmaf(jt, gb, col_w[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      cand_f[ty][tx * kTN + j] = col_f[j];
      cand_w[ty][tx * kTN + j] = col_w[j];
    }
    __syncthreads();
    if (tid < kBN && k0 + tid < h) {
      float sf = 0.f, sw = 0.f;
      for (int g = 0; g < kBM / kTM; ++g) {
        sf += cand_f[g][tid];
        sw += cand_w[g][tid];
      }
      dpf_part[(static_cast<size_t>(blockIdx.x) * B + b) * h + k0 + tid] = sf;
      run_bw += sw;
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int s = s0 + ty * kTM + i;
    if (s >= S) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int k = k0 + tx * kTN + j;
      if (k < h) d_pc[static_cast<size_t>(s) * h + k] = acc_pc[i][j];
    }
  }
  if (tid < kBN && k0 + tid < h) {
    dbw_part[static_cast<size_t>(blockIdx.x) * h + k0 + tid] = run_bw;
  }
}

// d_vocab_w partial for a (64-hidden, 64-label) tile over the split's range
// of (batch row, 64-state slice) pairs: dw_part [splits, h, V]. Grid
// (ceil(h / 64), ceil(V / 64), splits).
__global__ void __launch_bounds__(kThreads)
    weight_grad_f32_kernel(const float* __restrict__ pc,     // [S, h]
                           const float* __restrict__ pf,     // [B, h]
                           const float* __restrict__ g_lex,  // [B, S, V]
                           float* __restrict__ dw_part,      // [splits, h, V]
                           int B, int S, int h, int V, int slices_per_split) {
  const int k0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int s_slices = (S + kBM - 1) / kBM;
  const int q0 = blockIdx.z * slices_per_split;
  const int q1 = min(B * s_slices, q0 + slices_per_split);
  float acc[kTM][kTN];
  zero(acc);
  for (int q = q0; q < q1; ++q) {
    const int b = q / s_slices, s0 = q % s_slices * kBM;
    const float* pf_b = pf + static_cast<size_t>(b) * h + k0;
    const float* pc_s = pc + static_cast<size_t>(s0) * h + k0;
    const float* g_s = g_lex + (static_cast<size_t>(b) * S + s0) * V + n0;
    auto joint_t = [&](int r, int d) {
      return k0 + r < h ? tanhf(pc_s[static_cast<size_t>(d) * h + r] + pf_b[r])
                        : 0.f;
    };
    auto cot = [&](int d, int c) {
      return n0 + c < V ? g_s[static_cast<size_t>(d) * V + c] : 0.f;
    };
    accumulate<true, false>(acc, joint_t, cot, 0, min(kBM, S - s0));
  }
  const int tx = threadIdx.x % (kBN / kTN), ty = threadIdx.x / (kBN / kTN);
  float* part = dw_part + static_cast<size_t>(blockIdx.z) * h * V;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int k = k0 + ty * kTM + i;
    if (k >= h) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int y = n0 + tx * kTN + j;
      if (y < V) part[static_cast<size_t>(k) * V + y] = acc[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16: 128 x 128 tiles through WMMA.

constexpr int kHM = 128;  // rows per tile
constexpr int kHN = 128;  // columns per tile
constexpr int kHK = 16;   // depth per stage
constexpr int kStage = kHM * kHK / kThreads;  // operand entries per thread
static_assert(kHN * kHK / kThreads == kStage, "B stage share");
// Shared-memory strides (bfloat16 entries) of the staged operands, [r][d]
// or, transposed, [d][r]; B [d][c] or [c][d]. The padding keeps WMMA's
// 32-byte row alignment and spreads the rows over the banks.
constexpr int kLdDeep = kHK + 8;   // 24
constexpr int kLdWide = kHM + 8;   // 136
constexpr int kOperand = kHM * kLdDeep;  // >= kHK * kLdWide entries
static_assert(kOperand >= kHK * kLdWide, "operand buffer");
// The per-warp result scratch: 16 rows x 32 columns of float32.
constexpr int kLdScratch = 32 + 4;
constexpr int kScratch = 16 * kLdScratch;
constexpr int kSmemBytes = 2 * kOperand * 2 > kThreads / 32 * kScratch * 4
                               ? 2 * kOperand * 2
                               : kThreads / 32 * kScratch * 4;

using AccFrag = nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16,
                                       16, float>;
// The block's 128 x 128 running sum: warp (wm, wn) of the 4 x 2 warps keeps
// rows wm * 32 + i * 16 and columns wn * 64 + j * 16 in c[i][j].
struct Tile128 {
  AccFrag c[2][4];
};

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// Operand producers for the bfloat16 products: load(r, k0, d) (A) or
// load(k0, d, c) (B) reads the device memory of one entry at depth k0 + d
// (k0 the stage's first depth) into a Raw value, which finish() turns into
// the operand at the store, after the stage's products; load4 reads the
// entry and the next 3 along the producer's contiguous axis with 16-byte
// loads (the vector path: h and V multiples of 4, 16-byte aligned
// tensors). Out-of-range entries are Raw{}, which finish() maps to 0.

__device__ __forceinline__ float4 load16(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ void spread(float4 x, float* out) {
  out[0] = x.x, out[1] = x.y, out[2] = x.z, out[3] = x.w;
}

__device__ __forceinline__ void spread(float4 x, float4 y, float2* out) {
  out[0] = make_float2(x.x, y.x), out[1] = make_float2(x.y, y.y);
  out[2] = make_float2(x.z, y.z), out[3] = make_float2(x.w, y.w);
}

// A plain float32 operand.
struct Plain {
  using Raw = float;
  __device__ __forceinline__ static float finish(float x) { return x; }
};

// tanh(pc + pf), from the pair.
struct Joint {
  using Raw = float2;
  __device__ __forceinline__ static float finish(Raw x) {
    return tanhf(x.x + x.y);
  }
};

// The cotangent rows of one batch row's state tile, A [r = state][d =
// label].
struct CotRows : Plain {
  const float* g;  // g_lex at the tile's first row
  int V, rows;
  __device__ __forceinline__ Raw load(int r, int k0, int d) const {
    return r < rows ? g[static_cast<size_t>(r) * V + k0 + d] : 0.f;
  }
  __device__ __forceinline__ void load4(int r, int k0, int d, Raw* out) const {
    spread(r < rows ? load16(g + static_cast<size_t>(r) * V + k0 + d)
                    : float4{},
           out);
  }
};

// The head's weights transposed, B [d = label][c = hidden unit].
struct HeadRowsT : Plain {
  const float* vw;
  int V, h, k0_h;
  __device__ __forceinline__ Raw load(int k0, int d, int c) const {
    return k0_h + c < h ? vw[static_cast<size_t>(k0_h + c) * V + k0 + d]
                        : 0.f;
  }
  __device__ __forceinline__ void load4(int k0, int d, int c, Raw* out) const {
    spread(k0_h + c < h ? load16(vw + static_cast<size_t>(k0_h + c) * V + k0 + d)
                        : float4{},
           out);
  }
};

// The joint transposed over the (batch row, state) depth of d_vocab_w:
// depth D = b S_pad + s, S_pad = S rounded up to kHK, so that a stage lies
// in one batch row. A [r = hidden unit][d].
struct JointDepthT : Joint {
  const float* pc;
  const float* pf;
  int S, S_pad, h, k0_h;
  __device__ __forceinline__ Raw load(int r, int k0, int d) const {
    const int b = k0 / S_pad, s = k0 - b * S_pad + d;
    return s < S && k0_h + r < h
               ? make_float2(pc[static_cast<size_t>(s) * h + k0_h + r],
                             pf[static_cast<size_t>(b) * h + k0_h + r])
               : Raw{};
  }
  __device__ __forceinline__ void load4(int r, int k0, int d, Raw* out) const {
    const int b = k0 / S_pad, s = k0 - b * S_pad + d;
    if (s < S && k0_h + r < h) {
      spread(load16(pc + static_cast<size_t>(s) * h + k0_h + r),
             load16(pf + static_cast<size_t>(b) * h + k0_h + r), out);
    } else {
      out[0] = out[1] = out[2] = out[3] = Raw{};
    }
  }
};

// The cotangent over the same depth, B [d][c = label].
struct CotDepth : Plain {
  const float* g_lex;
  int S, S_pad, V, n0;
  __device__ __forceinline__ Raw load(int k0, int d, int c) const {
    const int b = k0 / S_pad, s = k0 - b * S_pad + d;
    return s < S && n0 + c < V
               ? g_lex[(static_cast<size_t>(b) * S + s) * V + n0 + c]
               : 0.f;
  }
  __device__ __forceinline__ void load4(int k0, int d, int c, Raw* out) const {
    const int b = k0 / S_pad, s = k0 - b * S_pad + d;
    spread(s < S && n0 + c < V
               ? load16(g_lex + (static_cast<size_t>(b) * S + s) * V + n0 + c)
               : float4{},
           out);
  }
};

// Where entry i of a thread's stage share lies: (row or column, depth) of
// an operand of `wide` x kHK entries whose contiguous axis is the wide one
// (Wide) or the depth, in runs of `run` entries (1, or 4 on the vector
// path) that consecutive threads take in turn.
template <bool Wide, int run, int wide>
__device__ __forceinline__ int2 place(int i) {
  const int idx = threadIdx.x + (i / run) * kThreads;
  return Wide ? make_int2(idx % (wide / run) * run + i % run,
                          idx / (wide / run))
              : make_int2(idx / (kHK / run), idx % (kHK / run) * run + i % run);
}

// acc += A B over depths [d0, d1) (d0 a multiple of kHK), A [kHM rows,
// depth] from `a`, B [depth, kHN columns] from `b`, both rounded to
// bfloat16 as they are staged; AT / BT as in `accumulate`; Vec loads 4
// entries at a time (d1 a multiple of 4 where the depth is contiguous).
// After each stage is staged, hook(k0, a_tile) may read it ([r][d], stride
// kLdDeep, when !AT). Every thread of the block must call it (it
// synchronises); `smem` is free again when it returns.
template <bool AT, bool BT, bool Vec, class AP, class BP, class Hook>
__device__ __forceinline__ void mainloop(Tile128& acc, const AP& a,
                                         const BP& b, int d0, int d1,
                                         __nv_bfloat16* smem,
                                         const Hook& hook) {
  using namespace nvcuda;
  using ALayout =
      typename std::conditional<AT, wmma::col_major, wmma::row_major>::type;
  using BLayout =
      typename std::conditional<BT, wmma::col_major, wmma::row_major>::type;
  constexpr int lda = AT ? kLdWide : kLdDeep;
  constexpr int ldb = BT ? kLdDeep : kLdWide;
  constexpr int run = Vec ? 4 : 1;
  __nv_bfloat16* a_tile = smem;
  __nv_bfloat16* b_tile = smem + kOperand;
  const int warp = threadIdx.x / 32;
  const int wm = warp / 2, wn = warp % 2;
  typename AP::Raw ra[kStage];
  typename BP::Raw rb[kStage];
  // place() gives A's (row, depth) and B's (column, depth).
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < kStage; i += run) {
      const int2 p = place<AT, run, kHM>(i);
      if (k0 + p.y < d1) {
        if constexpr (Vec) {
          a.load4(p.x, k0, p.y, &ra[i]);
        } else {
          ra[i] = a.load(p.x, k0, p.y);
        }
      } else {
#pragma unroll
        for (int j = 0; j < run; ++j) ra[i + j] = typename AP::Raw{};
      }
    }
#pragma unroll
    for (int i = 0; i < kStage; i += run) {
      const int2 p = place<!BT, run, kHN>(i);  // (column, depth)
      if (k0 + p.y < d1) {
        if constexpr (Vec) {
          b.load4(k0, p.y, p.x, &rb[i]);
        } else {
          rb[i] = b.load(k0, p.y, p.x);
        }
      } else {
#pragma unroll
        for (int j = 0; j < run; ++j) rb[i + j] = typename BP::Raw{};
      }
    }
  };
  if (d0 < d1) fetch(d0);
  for (int k0 = d0; k0 < d1; k0 += kHK) {
    __syncthreads();  // the previous stage's fragments are loaded
#pragma unroll
    for (int i = 0; i < kStage; ++i) {
      const int2 p = place<AT, run, kHM>(i);
      a_tile[AT ? p.y * kLdWide + p.x : p.x * kLdDeep + p.y] =
          __float2bfloat16(AP::finish(ra[i]));
    }
#pragma unroll
    for (int i = 0; i < kStage; ++i) {
      const int2 p = place<!BT, run, kHN>(i);
      b_tile[BT ? p.x * kLdDeep + p.y : p.y * kLdWide + p.x] =
          __float2bfloat16(BP::finish(rb[i]));
    }
    __syncthreads();
    hook(k0, a_tile);
    if (k0 + kHK < d1) fetch(k0 + kHK);  // in flight under the products
#pragma unroll
    for (int kk = 0; kk < kHK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, ALayout>
          fa[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = wm * 32 + i * 16;
        wmma::load_matrix_sync(
            fa[i], AT ? &a_tile[kk * kLdWide + r] : &a_tile[r * kLdDeep + kk],
            lda);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = wn * 64 + j * 16;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, BLayout> fb;
        wmma::load_matrix_sync(
            fb, BT ? &b_tile[c * kLdDeep + kk] : &b_tile[kk * kLdWide + c],
            ldb);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          wmma::mma_sync(acc.c[i][j], fa[i], fb, acc.c[i][j]);
        }
      }
    }
  }
  __syncthreads();
}

__device__ __forceinline__ void zero(Tile128& acc) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) nvcuda::wmma::fill_fragment(acc.c[i][j], 0.f);
  }
}

// Calls out(r, c, value, half) for every entry of the block's tile, the
// warp's 32 x 64 piece 16 x 32 at a time through its scratch in `smem`
// (free: after mainloop): lane l takes column wn * 64 + half * 32 + l of
// 16 rows in turn, so that 32 lanes write 32 consecutive columns.
template <class Out>
__device__ __forceinline__ void drain(Tile128& acc, __nv_bfloat16* smem,
                                      const Out& out) {
  using namespace nvcuda;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 2, wn = warp % 2;
  float* scratch = reinterpret_cast<float*>(smem) + warp * kScratch;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      wmma::store_matrix_sync(scratch, acc.c[i][2 * half], kLdScratch,
                              wmma::mem_row_major);
      wmma::store_matrix_sync(scratch + 16, acc.c[i][2 * half + 1],
                              kLdScratch, wmma::mem_row_major);
      __syncwarp();
#pragma unroll 4
      for (int rr = 0; rr < 16; ++rr) {
        out(wm * 32 + i * 16 + rr, wn * 64 + half * 32 + lane,
            scratch[rr * kLdScratch + lane], half);
      }
      __syncwarp();
    }
  }
}

struct NoHook {
  __device__ __forceinline__ void operator()(int, const __nv_bfloat16*) const {}
};


// du for a (128-row, 128-hidden) tile of the rows m = b S + s into du
// [B, S, h], and the row sums of T(joint32) T(g_blank) into dbw_part
// [row tiles, h] (RoundBlank; joint32 g_blank without it). Grid
// (ceil(B S / 128), ceil(h / 128)).
template <bool Vec, bool RoundBlank>
__global__ void __launch_bounds__(kThreads, 2)
    joint_grad_bf16_kernel(const float* __restrict__ pc, const float* __restrict__ pf,
                           const float* __restrict__ vw, const float* __restrict__ bw,
                           const float* __restrict__ g_blank,
                           const float* __restrict__ g_lex,
                           float* __restrict__ dbw_part,
                           float* __restrict__ du,
                           int B, int S, int h, int V) {
  __shared__ __align__(128) __nv_bfloat16 smem[kSmemBytes / 2];
  __shared__ size_t pc_off[kHM], pf_off[kHM];
  __shared__ float col_w[4][kHN];
  const int M = B * S;
  const int m0 = blockIdx.x * kHM, k0_h = blockIdx.y * kHN;
  const int tid = threadIdx.x;
  if (tid < kHM) {
    const int m = m0 + tid < M ? m0 + tid : 0;
    pc_off[tid] = static_cast<size_t>(m % S) * h;
    pf_off[tid] = static_cast<size_t>(m / S) * h;
  }
  Tile128 acc;
  zero(acc);
  mainloop<false, true, Vec>(
      acc, CotRows{{}, g_lex + static_cast<size_t>(m0) * V, V, min(kHM, M - m0)},
      HeadRowsT{{}, vw, V, h, k0_h}, 0, V, smem, NoHook{});
  float sum_w[2] = {0.f, 0.f};
  drain(acc, smem, [&](int r, int c, float dj, int half) {
    const int m = m0 + r, k = k0_h + c;
    if (m >= M || k >= h) return;
    const float gb = RoundBlank ? bf16_round(g_blank[m]) : g_blank[m];
    const float jt = tanhf(pc[pc_off[r] + k] + pf[pf_off[r] + k]);
    du[static_cast<size_t>(m) * h + k] =
        fmaf(gb, RoundBlank ? bf16_round(bw[k]) : bw[k], dj) * (1.f - jt * jt);
    sum_w[half] = fmaf(RoundBlank ? bf16_round(jt) : jt, gb, sum_w[half]);
  });
  const int warp = tid / 32, lane = tid % 32;
  const int wm = warp / 2, wn = warp % 2;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    col_w[wm][wn * 64 + half * 32 + lane] = sum_w[half];
  }
  __syncthreads();
  if (tid < kHN && k0_h + tid < h) {
    float sw = 0.f;
#pragma unroll
    for (int g = 0; g < 4; ++g) sw += col_w[g][tid];
    dbw_part[static_cast<size_t>(blockIdx.x) * h + k0_h + tid] = sw;
  }
}

// out[q, b h + k] = sum of du[b, s, k] over the states s of chunk q
// (kStateChunk states). Grid (ceil(B h / 256), ceil(S / kStateChunk)).
constexpr int kStateChunk = 32;

__global__ void __launch_bounds__(kPointThreads)
    state_chunk_sum_kernel(const float* __restrict__ du, int B, int S, int h,
                           float* __restrict__ out) {
  const size_t i = static_cast<size_t>(blockIdx.x) * kPointThreads +
                   threadIdx.x;
  const size_t n = static_cast<size_t>(B) * h;
  if (i >= n) return;
  const int b = static_cast<int>(i / h), k = static_cast<int>(i % h);
  const int s0 = blockIdx.y * kStateChunk, s1 = min(S, s0 + kStateChunk);
  const float* p = du + (static_cast<size_t>(b) * S + s0) * h + k;
  float total = 0.f;
  for (int s = s0; s < s1; ++s, p += h) total += *p;
  out[blockIdx.y * n + i] = total;
}

// d_vocab_w partial for a (128-hidden, 128-label) tile over the split's
// stages of the (batch row, state) depth: dw_part [splits, h, V]. Grid
// (ceil(h / 128), ceil(V / 128), splits).
template <bool Vec>
__global__ void __launch_bounds__(kThreads, 2)
    weight_grad_bf16_kernel(const float* __restrict__ pc,
                            const float* __restrict__ pf,
                            const float* __restrict__ g_lex,
                            float* __restrict__ dw_part, int B, int S, int h,
                            int V, int stages_per_split) {
  __shared__ __align__(128) __nv_bfloat16 smem[kSmemBytes / 2];
  const int k0_h = blockIdx.x * kHM, n0 = blockIdx.y * kHN;
  const int S_pad = (S + kHK - 1) / kHK * kHK;
  const int d0 = blockIdx.z * stages_per_split * kHK;
  const int d1 = min(B * S_pad, d0 + stages_per_split * kHK);
  Tile128 acc;
  zero(acc);
  mainloop<true, false, Vec>(acc, JointDepthT{{}, pc, pf, S, S_pad, h, k0_h},
                        CotDepth{{}, g_lex, S, S_pad, V, n0}, d0, d1, smem,
                        NoHook{});
  float* part = dw_part + static_cast<size_t>(blockIdx.z) * h * V;
  drain(acc, smem, [&](int r, int c, float v, int) {
    const int k = k0_h + r, y = n0 + c;
    if (k < h && y < V) part[static_cast<size_t>(k) * V + y] = v;
  });
}

// ---------------------------------------------------------------------------

// out[i] = sum_q in[q * n + i].
__global__ void __launch_bounds__(kPointThreads)
    sum_rows_kernel(const float* __restrict__ in, int rows, size_t n,
                    float* __restrict__ out) {
  const size_t idx = static_cast<size_t>(blockIdx.x) * kPointThreads +
                     threadIdx.x;
  if (idx >= n) return;
  float total = 0.f;
  for (int q = 0; q < rows; ++q) total += in[static_cast<size_t>(q) * n + idx];
  out[idx] = total;
}

#define RETURN_IF_FAILED(expr)                              \
  do {                                                      \
    const cudaError_t err = (expr);                         \
    if (err != cudaSuccess) return static_cast<int>(err);   \
  } while (0)
#define RETURN_IF_LAUNCH_FAILED() RETURN_IF_FAILED(cudaGetLastError())

inline int blocks_for(size_t n) {
  return static_cast<int>((n + kPointThreads - 1) / kPointThreads);
}

__host__ __device__ inline int tiles(int n, int tile) {
  return (n + tile - 1) / tile;
}

// Whether the bfloat16 products may stage with 16-byte loads: h and V
// multiples of 4 and the operands they read so 16-byte aligned.
inline bool vector_path(int h, int V, std::initializer_list<const void*> ps) {
  if (h % 4 != 0 || V % 4 != 0) return false;
  for (const void* p : ps) {
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  }
  return true;
}

struct Sum {
  const float* in;
  int rows;
  size_t n;
  float* out;
};

template <int N>
int sum_all(const Sum (&sums)[N], cudaStream_t stream) {
  for (const auto& sum : sums) {
    if (sum.n == 0) continue;
    sum_rows_kernel<<<blocks_for(sum.n), kPointThreads, 0, stream>>>(
        sum.in, sum.rows, sum.n, sum.out);
    RETURN_IF_LAUNCH_FAILED();
  }
  return 0;
}

// The backward of the joint and heads on `stream`; returns the first error
// (0 on success). dtype 0 = float32, 1 = bfloat16 (the compute type);
// every pointer is float32: pc [S, h], pf [B, h], vw [h, V], bw [h],
// g_blank [B, S], g_lex [B, S, V]; outputs d_pc [S, h], d_pf [B, h], d_vw
// [h, V], d_bw [h]. Scratch (float32):
//   float32: dpf_part [ceil(S / 64), B, h], dbw_part [ceil(S / 64), h];
//     dpc_part unused; dw_part [splits, h, V], splits >= 1 dividing the
//     B * ceil(S / 64) (batch row, state tile) pairs of the d_vocab_w
//     contraction.
//   bfloat16: dpf_part [ceil(S / 32), B, h], dbw_part [ceil(B S / 128), h],
//     dpc_part [B, S, h] (du); dw_part [splits, h, V], splits dividing the
//     B * ceil(S / 16) 16-state stages.
// round_blank: see the top of this file (float32 rounds nothing).
inline int joint_backward(int dtype, bool round_blank, const float* pc,
                          const float* pf, const float* vw, const float* bw,
                          const float* g_blank, const float* g_lex,
                          float* dpf_part, float* dbw_part, float* dpc_part,
                          float* dw_part, float* d_pc, float* d_pf,
                          float* d_vw, float* d_bw, int B, int S, int h,
                          int V, int splits, cudaStream_t s) {
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t Bh = static_cast<size_t>(B) * h;
  if (dtype == 0) {
    const int s_tiles = tiles(S, kBM);
    const int per_split = splits > 0 ? (B * s_tiles + splits - 1) / splits : 0;
    if (S > 0 && h > 0) {
      joint_grad_f32_kernel<<<dim3(s_tiles, tiles(h, kBN)), kThreads, 0, s>>>(
          pc, pf, vw, bw, g_blank, g_lex, dpf_part, dbw_part, d_pc, B, S, h,
          V);
      RETURN_IF_LAUNCH_FAILED();
    }
    if (h > 0 && V > 0) {
      weight_grad_f32_kernel<<<dim3(tiles(h, kBM), tiles(V, kBN), splits),
                               kThreads, 0, s>>>(pc, pf, g_lex, dw_part, B, S,
                                                 h, V, per_split);
      RETURN_IF_LAUNCH_FAILED();
    }
    const Sum sums[] = {{dpf_part, s_tiles, Bh, d_pf},
                        {dbw_part, s_tiles, static_cast<size_t>(h), d_bw},
                        {dw_part, splits, static_cast<size_t>(h) * V, d_vw}};
    return sum_all(sums, s);
  }
  const int M = B * S;
  const int stages = B * tiles(S, kHK);
  const int per_split = splits > 0 ? (stages + splits - 1) / splits : 0;
  const bool vec = vector_path(h, V, {pc, pf, vw, g_lex});
  if (M > 0 && h > 0) {
    const auto kernel =
        vec ? (round_blank ? joint_grad_bf16_kernel<true, true>
                           : joint_grad_bf16_kernel<true, false>)
            : (round_blank ? joint_grad_bf16_kernel<false, true>
                           : joint_grad_bf16_kernel<false, false>);
    kernel<<<dim3(tiles(M, kHM), tiles(h, kHN)), kThreads, 0, s>>>(
        pc, pf, vw, bw, g_blank, g_lex, dbw_part, dpc_part, B, S, h, V);
    RETURN_IF_LAUNCH_FAILED();
    state_chunk_sum_kernel<<<dim3(blocks_for(Bh), tiles(S, kStateChunk)),
                             kPointThreads, 0, s>>>(dpc_part, B, S, h,
                                                    dpf_part);
    RETURN_IF_LAUNCH_FAILED();
  }
  if (h > 0 && V > 0) {
    const auto kernel = vec ? weight_grad_bf16_kernel<true>
                            : weight_grad_bf16_kernel<false>;
    kernel<<<dim3(tiles(h, kHM), tiles(V, kHN), splits), kThreads, 0, s>>>(
        pc, pf, g_lex, dw_part, B, S, h, V, per_split);
    RETURN_IF_LAUNCH_FAILED();
  }
  const Sum sums[] = {
      {dpf_part, M > 0 ? tiles(S, kStateChunk) : 0, Bh, d_pf},
      {dbw_part, tiles(M, kHM), static_cast<size_t>(h), d_bw},
      {dw_part, splits, static_cast<size_t>(h) * V, d_vw},
      {dpc_part, B, static_cast<size_t>(S) * h, d_pc}};
  return sum_all(sums, s);
}

}  // namespace joint_tiles
