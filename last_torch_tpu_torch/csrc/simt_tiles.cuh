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

// Exact float32 products on the CUDA cores (no TF32), shared by the
// numerator's float32 route (numerator_scan.cu, namespace simt) and the
// joint+head's (joint_head.cu, namespace fp32).
//
// A block of 256 threads owns a 64 x 256 output tile, 8 x 8 entries a
// thread (rows ty * 8 + i, columns tx * 4 + j and 128 + tx * 4 + j; tx =
// lane, ty = warp), and walks the depth in 16-deep slices double-buffered
// in shared memory: the next slice's loads are in flight (in registers)
// under the current slice's 1024 FMAs a thread, whose operands come from
// shared memory as 16-byte broadcasts (64 FMAs per four loads).
//
// The operand loaders name the layout of each operand in device memory:
// RowsA / ColsA (A [64 rows][depth], the depth or the rows contiguous),
// RowsB / ColsB (B [depth][256 columns], the columns or the depth
// contiguous). They read padded buffers (rows of 64, zeros past the valid
// extent), so they take no masks along the depth. The *Edge loaders read
// an unpadded operand (a caller's tensor): rows, columns and depth past
// their limits read as zero, with 16-byte loads where Vec (the contiguous
// extent and stride multiples of 4, a 16-byte aligned base), else scalar.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace simt_tiles {
namespace {

constexpr int kM = 64, kN = 256, kK = 16, kThreads = 256;

struct Smem {
  float a[2][kK][kM];
  float b[2][kK][kN];
};

// The tile column of a thread's j-th entry (0 <= j < 8).
__device__ __forceinline__ int col(int j) {
  return (j < 4 ? 0 : kN / 2 - 4) + threadIdx.x % 32 * 4 + j;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Four consecutive entries p[0..3], those at e >= n zero; 16-byte load
// where Vec and all four are valid.
template <bool Vec>
__device__ __forceinline__ float4 ld4_edge(const float* p, int n) {
  if (Vec && n >= 4) return ld4(p);
  return make_float4(n > 0 ? p[0] : 0.f, n > 1 ? p[1] : 0.f,
                     n > 2 ? p[2] : 0.f, n > 3 ? p[3] : 0.f);
}

// A slice of A [64 rows][16 deep] into shared memory [depth][row], as a
// thread of RowsA holds it (row tid % 64, depth 4 (tid / 64) + 0..3).
__device__ __forceinline__ void store_rows_a(const float4& r,
                                             float (&s)[kK][kM]) {
  const int m = threadIdx.x % kM, kq = threadIdx.x / kM;
  s[kq * 4][m] = r.x, s[kq * 4 + 1][m] = r.y;
  s[kq * 4 + 2][m] = r.z, s[kq * 4 + 3][m] = r.w;
}

// As a thread of ColsA holds it (depth tid / 16, rows 4 (tid % 16) + 0..3).
__device__ __forceinline__ void store_cols_a(const float4& r,
                                             float (&s)[kK][kM]) {
  const int k = threadIdx.x / 16, m = threadIdx.x % 16 * 4;
  *reinterpret_cast<float4*>(&s[k][m]) = r;
}

// As a thread of RowsB holds it (depth tid / 16, columns 4 (tid % 16) +
// 64 i + 0..3).
__device__ __forceinline__ void store_rows_b(const float4 (&r)[4],
                                             float (&s)[kK][kN]) {
  const int k = threadIdx.x / 16, n = threadIdx.x % 16 * 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    *reinterpret_cast<float4*>(&s[k][n + i * 64]) = r[i];
  }
}

// A [64 rows][depth] with the depth contiguous: row m at p + m * ld.
struct RowsA {
  const float* p;
  int ld;
  __device__ void load(int step, float4& r) const {
    const int m = threadIdx.x % kM, kq = threadIdx.x / kM;
    r = ld4(p + static_cast<size_t>(m) * ld + step * kK + kq * 4);
  }
  __device__ void store(const float4& r, float (&s)[kK][kM]) const {
    store_rows_a(r, s);
  }
};

// RowsA over an unpadded operand: rows past `rows` and depth past `depth`
// zero.
template <bool Vec>
struct RowsAEdge {
  const float* p;
  int ld, rows, depth;
  __device__ void load(int step, float4& r) const {
    const int m = threadIdx.x % kM, k = step * kK + threadIdx.x / kM * 4;
    r = m < rows ? ld4_edge<Vec>(p + static_cast<size_t>(m) * ld + k,
                                 depth - k)
                 : float4{};
  }
  __device__ void store(const float4& r, float (&s)[kK][kM]) const {
    store_rows_a(r, s);
  }
};

// A [64 rows][depth] with the rows contiguous: depth d at p + d * ld + m0
// (the head gradient's joint^T, the depth walking the items' rows).
struct ColsA {
  const float* p;
  int ld, m0;
  __device__ void load(int step, float4& r) const {
    const int k = threadIdx.x / 16, m = threadIdx.x % 16 * 4;
    r = ld4(p + static_cast<size_t>(step * kK + k) * ld + m0 + m);
  }
  __device__ void store(const float4& r, float (&s)[kK][kM]) const {
    store_cols_a(r, s);
  }
};

// ColsA over an unpadded operand: rows (absolute, m0 + m) past `rows` and
// depth past `depth` zero.
template <bool Vec>
struct ColsAEdge {
  const float* p;
  int ld, m0, rows, depth;
  __device__ void load(int step, float4& r) const {
    const int k = step * kK + threadIdx.x / 16;
    const int m = m0 + threadIdx.x % 16 * 4;
    r = k < depth ? ld4_edge<Vec>(p + static_cast<size_t>(k) * ld + m,
                                  rows - m)
                  : float4{};
  }
  __device__ void store(const float4& r, float (&s)[kK][kM]) const {
    store_cols_a(r, s);
  }
};

// B [depth][256 columns] with the columns contiguous: depth d at p + d * ld
// + n0, columns past `cols` zero (in whole groups of 64).
struct RowsB {
  const float* p;
  int ld, n0, cols;
  __device__ void load(int step, float4 (&r)[4]) const {
    const int k = threadIdx.x / 16, n = threadIdx.x % 16 * 4;
    const float* q = p + static_cast<size_t>(step * kK + k) * ld + n0 + n;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      r[i] = n0 + i * 64 < cols ? ld4(q + i * 64) : float4{};
    }
  }
  __device__ void store(const float4 (&r)[4], float (&s)[kK][kN]) const {
    store_rows_b(r, s);
  }
};

// RowsB over an unpadded operand: columns (absolute) past `cols` and depth
// past `depth` zero.
template <bool Vec>
struct RowsBEdge {
  const float* p;
  int ld, n0, cols, depth;
  __device__ void load(int step, float4 (&r)[4]) const {
    const int k = step * kK + threadIdx.x / 16;
    const int n = n0 + threadIdx.x % 16 * 4;
    const float* q = p + static_cast<size_t>(k) * ld + n;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      r[i] = k < depth ? ld4_edge<Vec>(q + i * 64, cols - n - i * 64)
                       : float4{};
    }
  }
  __device__ void store(const float4 (&r)[4], float (&s)[kK][kN]) const {
    store_rows_b(r, s);
  }
};

// B [depth][256 columns] with the depth contiguous: column n at p + (n0 +
// n) * ld, columns past `cols` zero (the head transposed).
struct ColsB {
  const float* p;
  int ld, n0, cols;
  __device__ void load(int step, float4 (&r)[4]) const {
    const int n = n0 + threadIdx.x;
    const float* q = p + static_cast<size_t>(n) * ld + step * kK;
#pragma unroll
    for (int i = 0; i < 4; ++i) r[i] = n < cols ? ld4(q + i * 4) : float4{};
  }
  __device__ void store(const float4 (&r)[4], float (&s)[kK][kN]) const {
    const int n = threadIdx.x;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      s[i * 4][n] = r[i].x, s[i * 4 + 1][n] = r[i].y;
      s[i * 4 + 2][n] = r[i].z, s[i * 4 + 3][n] = r[i].w;
    }
  }
};

// acc = A B over `steps` 16-deep slices. Every thread of the block calls
// it; the shared memory is free again when it returns.
template <class LA, class LB>
__device__ __forceinline__ void product(float (&acc)[8][8], Smem& sm,
                                        int steps, const LA& la,
                                        const LB& lb) {
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }
  if (steps == 0) return;
  float4 ra, rb[4];
  la.load(0, ra);
  lb.load(0, rb);
  la.store(ra, sm.a[0]);
  lb.store(rb, sm.b[0]);
  __syncthreads();
  for (int s = 0; s < steps; ++s) {
    const int cur = s & 1;
    if (s + 1 < steps) {
      la.load(s + 1, ra);
      lb.load(s + 1, rb);
    }
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      const float4 a0 = ld4(&sm.a[cur][k][ty * 8]);
      const float4 a1 = ld4(&sm.a[cur][k][ty * 8 + 4]);
      const float4 b0 = ld4(&sm.b[cur][k][tx * 4]);
      const float4 b1 = ld4(&sm.b[cur][k][kN / 2 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
    if (s + 1 < steps) {
      la.store(ra, sm.a[cur ^ 1]);
      lb.store(rb, sm.b[cur ^ 1]);
    }
    __syncthreads();
  }
}

// Column sums of the block's tile from each thread's partial over its own
// rows, part[j] for the column col(j): summed over the 8 row groups through
// sm.b's space (free after a product), then out(c, total) for each of the
// 256 columns by the thread c. Every thread calls it.
template <class Out>
__device__ __forceinline__ void reduce_columns(const float (&part)[8],
                                               Smem& sm, const Out& out) {
  float(*red)[kN] = reinterpret_cast<float(*)[kN]>(&sm.b[0][0][0]);
  const int ty = threadIdx.x / 32;
#pragma unroll
  for (int j = 0; j < 8; ++j) red[ty][col(j)] = part[j];
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int g = 0; g < kThreads / 32; ++g) total += red[g][threadIdx.x];
  out(threadIdx.x, total);
  __syncthreads();
}

// Column sums of the block's 64 x 256 tile over the rows i of each thread
// for which in(i): v[i][j] summed over those and over the 8 row groups
// (reduce_columns). Every thread calls it.
template <class In, class Out>
__device__ __forceinline__ void column_sums(const float (&v)[8][8], Smem& sm,
                                            const In& in, const Out& out) {
  float part[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float total = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) total += in(i) ? v[i][j] : 0.f;
    part[j] = total;
  }
  reduce_columns(part, sm, out);
}

}  // namespace
}  // namespace simt_tiles
