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

// The 64 x 64 tile product shared by the lattice kernels (viterbi.cu,
// fused_scan.cu), with the type helpers around it.
//
// tile_product<AT, BT>(A, lda, B, ldb, m0, n0, M, N, K, acc) computes, for
// the output tile at rows m0.., columns n0..,
//
//   acc[i][j] = sum_k A(m0 + ty*kTM + i, k) * B(k, n0 + tx*kTN + j)
//
// with A(m, k) = AT ? A[k*lda + m] : A[m*lda + k] and
// B(k, n) = BT ? B[n*ldb + k] : B[k*ldb + n], for k in [0, K), where
// tid = ty * 16 + tx over 256 threads. Rows >= M, columns >= N and depths
// >= K read as 0. Every thread of the block must call it (it
// synchronises). bfloat16 inputs multiply on the tensor cores through WMMA
// (mma.sync, float32 accumulation), staged in shared memory in 64-deep
// slices with 16-byte loads along the contiguous axis where alignment
// allows; float32 inputs, kept for exact comparison with the plain
// versions, use float32 FMAs on the CUDA cores.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace lattice_tiles {

constexpr int kBM = 64;   // rows per tile
constexpr int kBN = 64;   // columns per tile
constexpr int kBK = 16;   // depth per shared-memory stage (float32)
constexpr int kWK = 64;   // depth per shared-memory stage (WMMA)
constexpr int kTM = 4;    // rows per thread
constexpr int kTN = 4;    // columns per thread
constexpr int kThreads = (kBM / kTM) * (kBN / kTN);  // 256

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's cast
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// float32: FMAs on the CUDA cores from shared-memory tiles, a 4 x 4
// register tile per thread.
template <bool AT, bool BT>
__device__ __forceinline__ void tile_product(const float* __restrict__ A,
                                             int lda,
                                             const float* __restrict__ B,
                                             int ldb, int m0, int n0, int M,
                                             int N, int K,
                                             float (&acc)[kTM][kTN]) {
  __shared__ float a_tile[kBK][kBM + 4];  // [k][m]
  __shared__ float b_tile[kBK][kBN];      // [k][n]
  const int tid = threadIdx.x;
  const int tx = tid % (kBN / kTN), ty = tid / (kBN / kTN);
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;
  }
  for (int k0 = 0; k0 < K; k0 += kBK) {
    for (int idx = tid; idx < kBM * kBK; idx += kThreads) {
      // AT: consecutive threads walk m (contiguous); else k.
      const int r = AT ? idx % kBM : idx / kBK;
      const int c = AT ? idx / kBM : idx % kBK;
      const int m = m0 + r, k = k0 + c;
      a_tile[c][r] =
          (m < M && k < K)
              ? (AT ? A[static_cast<size_t>(k) * lda + m]
                    : A[static_cast<size_t>(m) * lda + k])
              : 0.f;
    }
    for (int idx = tid; idx < kBK * kBN; idx += kThreads) {
      const int r = BT ? idx % kBK : idx / kBN;  // k
      const int c = BT ? idx / kBK : idx % kBN;  // n
      const int k = k0 + r, n = n0 + c;
      b_tile[r][c] =
          (k < K && n < N)
              ? (BT ? B[static_cast<size_t>(n) * ldb + k]
                    : B[static_cast<size_t>(k) * ldb + n])
              : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[kTM], w[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) a[i] = a_tile[kk][ty * kTM + i];
#pragma unroll
      for (int j = 0; j < kTN; ++j) w[j] = b_tile[kk][tx * kTN + j];
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
      }
    }
    __syncthreads();
  }
}

// Stages a 64 x 64 slice of an operand into shared memory as `rows` x
// `cols` with row stride ld_s, where rows run along the strided axis of the
// source and cols along its contiguous axis: src(r, c) = src[r*ld + c],
// valid while r < row_limit and c < col_limit. vec: 16-byte loads (the
// source, ld and col_limit allow them).
__device__ __forceinline__ void stage_slice(
    __nv_bfloat16* __restrict__ dst, int ld_s,
    const __nv_bfloat16* __restrict__ src, int ld, int row_limit,
    int col_limit, bool vec) {
  const int tid = threadIdx.x;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  if (vec) {
    const uint4 none = make_uint4(0, 0, 0, 0);
    for (int idx = tid; idx < 64 * 64 / 8; idx += kThreads) {
      const int r = idx / 8, c = idx % 8 * 8;
      *reinterpret_cast<uint4*>(dst + r * ld_s + c) =
          (r < row_limit && c < col_limit)
              ? *reinterpret_cast<const uint4*>(src +
                                                static_cast<size_t>(r) * ld +
                                                c)
              : none;
    }
  } else {
    for (int idx = tid; idx < 64 * 64; idx += kThreads) {
      const int r = idx / 64, c = idx % 64;
      dst[r * ld_s + c] = (r < row_limit && c < col_limit)
                              ? src[static_cast<size_t>(r) * ld + c]
                              : zero;
    }
  }
}

// bfloat16: WMMA on the tensor cores. Each of the 8 warps owns a 16 x 32
// piece of the tile; the float32 result goes through shared memory into
// the threads' 4 x 4 layout. Shared tiles keep the source's contiguous
// axis contiguous, and the fragments read them row- or column-major.
template <bool AT, bool BT>
__device__ __forceinline__ void tile_product(
    const __nv_bfloat16* __restrict__ A, int lda,
    const __nv_bfloat16* __restrict__ B, int ldb, int m0, int n0, int M,
    int N, int K, float (&acc)[kTM][kTN]) {
  using namespace nvcuda;
  constexpr int kLd = 64 + 8, kLdC = kBN + 4;
  // A: [m][k] (row-major fragment) or, AT, [k][m] (column-major); B: [k][n]
  // (row-major) or, BT, [n][k] (column-major).
  __shared__ __align__(32) __nv_bfloat16 a_tile[64 * kLd];
  __shared__ __align__(32) __nv_bfloat16 b_tile[64 * kLd];
  __shared__ __align__(32) float c_tile[kBM][kLdC];
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / 2, wn = warp % 2;  // 4 x 2 warps over 64 x 64
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> c_frag[2];
  wmma::fill_fragment(c_frag[0], 0.f);
  wmma::fill_fragment(c_frag[1], 0.f);
  // 16-byte loads need the contiguous extent and the stride in whole
  // groups of 8 and an aligned base, so that a group is wholly inside or
  // outside the ragged edge.
  const bool a_vec = lda % 8 == 0 && (AT ? M : K) % 8 == 0 && aligned16(A);
  const bool b_vec = ldb % 8 == 0 && (BT ? K : N) % 8 == 0 && aligned16(B);
  for (int k0 = 0; k0 < K; k0 += kWK) {
    if (AT) {
      stage_slice(a_tile, kLd, A + static_cast<size_t>(k0) * lda + m0, lda,
                  K - k0, M - m0, a_vec);
    } else {
      stage_slice(a_tile, kLd, A + static_cast<size_t>(m0) * lda + k0, lda,
                  M - m0, K - k0, a_vec);
    }
    if (BT) {
      stage_slice(b_tile, kLd, B + static_cast<size_t>(n0) * ldb + k0, ldb,
                  N - n0, K - k0, b_vec);
    } else {
      stage_slice(b_tile, kLd, B + static_cast<size_t>(k0) * ldb + n0, ldb,
                  K - k0, N - n0, b_vec);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kWK; kk += 16) {
      using ALayout = typename std::conditional<AT, wmma::col_major,
                                                wmma::row_major>::type;
      using BLayout = typename std::conditional<BT, wmma::col_major,
                                                wmma::row_major>::type;
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, ALayout>
          a_frag;
      wmma::load_matrix_sync(a_frag,
                             AT ? &a_tile[kk * kLd + wm * 16]
                                : &a_tile[wm * 16 * kLd + kk],
                             kLd);
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int col = wn * 32 + n * 16;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, BLayout>
            b_frag;
        wmma::load_matrix_sync(
            b_frag, BT ? &b_tile[col * kLd + kk] : &b_tile[kk * kLd + col],
            kLd);
        wmma::mma_sync(c_frag[n], a_frag, b_frag, c_frag[n]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    wmma::store_matrix_sync(&c_tile[wm * 16][wn * 32 + n * 16], c_frag[n],
                            kLdC, wmma::mem_row_major);
  }
  __syncthreads();
  const int tx = tid % (kBN / kTN), ty = tid / (kBN / kTN);
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      acc[i][j] = c_tile[ty * kTM + i][tx * kTN + j];
    }
  }
  __syncthreads();
}

}  // namespace lattice_tiles
