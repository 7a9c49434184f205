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

// The joint network's float32 tile products and backward, for
// sharded_scan.cu (one frame's vocab-shard reduction; its float32 forward
// and backward). Rows m = b * S + s run over the (batch row, context state)
// pairs; joint32[m] = tanh(pc[s] + pf[b]) is formed as the products stage
// their operands and never reaches device memory.
//
// * 64 x 64 tiles through FMAs on the CUDA cores (`accumulate`, operands
//   from producers).
// * `joint_backward`: from the cotangents g_lex [B, S, V] and g_blank
//   [B, S], the gradients d_pc, d_pf, d_vocab_w and d_blank_w (the float32
//   contract of joint_head_backward in joint_head.cu, which runs its own
//   float32 route on simt_tiles.cuh). Partials belong to one block each and
//   are reduced by a second launch: no atomics.
// (The bfloat16 backwards run on wgmma: head_grads.cuh.)

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
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

// The float32 backward of the joint and heads on `stream`; returns the
// first error (0 on success). Every pointer is float32: pc [S, h], pf [B,
// h], vw [h, V], bw [h], g_blank [B, S], g_lex [B, S, V]; outputs d_pc [S,
// h], d_pf [B, h], d_vw [h, V], d_bw [h]. Scratch: dpf_part [ceil(S / 64),
// B, h], dbw_part [ceil(S / 64), h], dw_part [splits, h, V], splits >= 1
// dividing the B * ceil(S / 64) (batch row, state tile) pairs of the
// d_vocab_w contraction. Nothing is rounded (the compute type is float32).
inline int joint_backward(const float* pc, const float* pf, const float* vw,
                          const float* bw, const float* g_blank,
                          const float* g_lex, float* dpf_part,
                          float* dbw_part, float* dw_part, float* d_pc,
                          float* d_pf, float* d_vw, float* d_bw, int B,
                          int S, int h, int V, int splits, cudaStream_t s) {
  const size_t Bh = static_cast<size_t>(B) * h;
  const int s_tiles = tiles(S, kBM);
  const int per_split = splits > 0 ? (B * s_tiles + splits - 1) / splits : 0;
  if (S > 0 && h > 0) {
    joint_grad_f32_kernel<<<dim3(s_tiles, tiles(h, kBN)), kThreads, 0, s>>>(
        pc, pf, vw, bw, g_blank, g_lex, dpf_part, dbw_part, d_pc, B, S, h, V);
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

}  // namespace joint_tiles
