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

// Locally normalized (HAT / log-softmax) numerator weights on Hopper, forward
// and backward.
//
// Replaces the Pallas TPU kernels of last_torch_tpu/ops/numerator_scan.py:
// _fwd_kernel (pallas_call at numerator_scan.py:263) and _bwd_kernel
// (pallas_call at :334), the custom VJP of
// LocallyNormalizedWeightFn.label_weights. Rows r = b * U1 + u run over the
// (batch, label position) pairs. For every frame t and row r:
//
//   joint32 = tanh(pc[r] + pf[t, b])                   (f32)
//   logits  = T(joint32) . T(W) + vb                   (f32 sums), [V]
//   z       = logsumexp(logits)
//   ly      = joint32 . wy[r] + by[r];  blank = joint32 . bw + bb    (f32)
//   hat:         nb = logsig(blank), nl = ly - z + logsig(-blank)
//   log_softmax: za = logaddexp(blank, z), nb = blank - za, nl = ly - za
//
// with T the compute type (float32 or bfloat16). The backward takes the
// cotangents (gb, gl) of (nb, nl) and, with the saved z and blank, forms
//   hat:         ds = -gl e^(logits - z),   d_blank = gb (1 - sig) - gl sig
//   log_softmax: ds = -(gb + gl) e^(logits - za),
//                d_blank = gb - (gb + gl) e^(blank - za)
//   dj = T(ds) . T(W)^T + gl wy[r] + d_blank bw,  du = dj (1 - joint32^2)
// and the sums d_pf[t, b] = sum_u du, d_pc[r] = sum_t du, d_wy[r] =
// sum_t gl joint32, d_W = sum_{t,r} T(joint32)^T T(ds), d_vb = sum ds,
// d_bw = sum d_blank joint32, d_by[r] = sum_t gl, d_bb = sum d_blank.
//
// What bounds it here. Per frame the forward runs one [R, h] x [h, V] head
// product (2 T R h V = 1.36 TFLOP at B=8, U1=101, T=1600, h=512, V=1024)
// and the backward three (the replayed logits, dj and d_W): compute-bound
// products, since only the [T, R] scalars and [T, B, h] d_pf cross device
// memory per frame. In float32 (the training default) they run on the CUDA
// cores (67 TFLOP/s peak), in bfloat16 on the tensor cores.
//
// What the design does about it (first, simple version):
// * The weights have no recurrence over time: each frame's outputs depend
//   on that frame alone. The TPU walked T as a sequential grid axis only to
//   keep W and its gradient sums resident in VMEM. Here the forward is one
//   launch over all frames, grid (row tiles, label splits, frames), and one
//   small merge launch; no host time loop.
// * A block stages the joint of its 64 rows in shared memory, formed from
//   pc and pf as it loads (the [T, R, h] joint, 1.3 GB in float32 at B=8,
//   is never stored), and walks its label strips against it: float32 FMAs
//   from a k-major tile, or WMMA bfloat16 products from a row-major one.
//   The tile holds at most kChunk hidden units (512 float32, 1024
//   bfloat16), so its shared memory does not grow with h: up to kChunk the
//   joint is staged once for all strips; past it, each strip re-stages the
//   joint chunk by chunk and sums the chunks' products. The logsumexp over
//   V is an online (max, sum) per row over the strips, merged across
//   splits as fused_scan.cu does.
// * The backward stages, per chunk of frames sized by the caller, the
//   rounded joint and ds ([Tc, R, h] and [Tc, R, V] in the compute type), so
//   that d_W = joint^T ds is one contraction over the chunk's rows. Every
//   cross-frame sum is a buffer in which each element belongs to one block
//   per launch (d_W per split of the contraction, d_pc / d_wy / d_bw per
//   frame split, d_vb per (frame, row tile)), reduced by separate launches:
//   no atomics, deterministic sums. g = 0 rows give exact zeros: every
//   gradient term is a product with gb or gl, and e^(logits - z) <= 1.
// * The [B, U1] rows are flattened with no padding to 8 or 128: ragged R,
//   V and h are masked in the loads. wgmma, TMA and pipelining are later
//   work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>

#include "tile_product.cuh"

namespace {

using namespace lattice_tiles;

constexpr int kRows = 64;             // rows per block tile
constexpr int kLdT = kBM + 4;         // k-major float32 joint tile stride
constexpr int kLdW = 64 + 8;          // bfloat16 W slice stride
constexpr int kLdC = kBN + 4;         // float32 accumulator tile stride
constexpr int kPointThreads = 256;

enum Mode { kForward = 0, kGradient = 1 };

__device__ __forceinline__ float safe_shift(float m) {
  return m == -INFINITY ? 0.f : m;
}

__device__ __forceinline__ void lse_merge(float& m, float& l, float m2,
                                          float l2) {
  const float mm = fmaxf(m, m2);
  const float c = safe_shift(mm);
  l = l * expf(m - c) + l2 * expf(m2 - c);
  m = mm;
}

__device__ __forceinline__ float lse_value(float m, float l) {
  return l > 0.f ? safe_shift(m) + logf(l) : -INFINITY;
}

__device__ __forceinline__ float log_add(float a, float b) {
  const float m = fmaxf(a, b);
  if (m == -INFINITY) return -INFINITY;
  return m + log1pf(expf(fminf(a, b) - m));
}

__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

__host__ __device__ inline int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// Shared-memory layout of the joint tile, which holds hc = min(h, kChunk)
// hidden units: float32 k-major [round_up(hc, kBK)][kLdT] plus a
// [kBK][kBN] W slice; bfloat16 row-major [kRows][round_up(hc, kWK) + 8]
// plus a [kWK][kLdW] W slice and a float32 [kBM][kLdC] accumulator tile.
// Both add [kBM / kTM][kBN] floats for column sums.
template <typename T>
struct Resident;

template <>
struct Resident<float> {
  static constexpr int kChunk = 512;
  static __host__ __device__ int ld(int) { return kLdT; }
  static __host__ __device__ size_t bytes(int h) {
    const int hc = h < kChunk ? h : kChunk;
    return sizeof(float) * (static_cast<size_t>(round_up(hc, kBK)) * kLdT +
                            kBK * kBN + (kBM / kTM) * kBN);
  }
};

template <>
struct Resident<__nv_bfloat16> {
  static constexpr int kChunk = 1024;
  static __host__ __device__ int ld(int h) {
    return round_up(h < kChunk ? h : kChunk, kWK) + 8;
  }
  static __host__ __device__ size_t bytes(int h) {
    return sizeof(__nv_bfloat16) *
               (static_cast<size_t>(kRows) * ld(h) + kWK * kLdW) +
           sizeof(float) * (kBM * kLdC + (kBM / kTM) * kBN);
  }
};

__device__ __forceinline__ void store_joint(float* js, int ldj, int row,
                                            int k, float j) {
  js[k * kLdT + row] = j;
}

__device__ __forceinline__ void store_joint(__nv_bfloat16* js, int ldj,
                                            int row, int k, float j) {
  js[row * ldj + k] = __float2bfloat16(j);
}

// Stages hidden units [c0, c0 + hc) of rows r0.. of frame t into the joint
// tile, zero outside [R, h] (up to the tile's padded depth hc_pad). With
// blank_out, also sums the float32 blank and label scores of each row over
// the chunks into dots [2][kRows] (the chunk c0 = 0 starts them) and, at
// the last chunk, writes them (ly into ly_out). Each row belongs to one
// warp, whose lane 0 alone touches its sums.
template <typename T>
__device__ void stage_joint(T* js, int ldj, const float* __restrict__ pc,
                            const float* __restrict__ pf_t,
                            const float* __restrict__ bw,
                            const float* __restrict__ bb,
                            const float* __restrict__ wy,
                            const float* __restrict__ by, int r0, int R,
                            int U1, int h, int c0, int hc, int hc_pad,
                            float (*dots)[kRows],
                            float* __restrict__ blank_out,
                            float* __restrict__ ly_out) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int row = warp; row < kRows; row += kThreads / 32) {
    const int r = r0 + row;
    const bool valid = r < R;
    const float* pc_row = pc + static_cast<size_t>(r) * h + c0;
    const float* pf_row =
        pf_t + static_cast<size_t>(valid ? r / U1 : 0) * h + c0;
    const float* wy_row = wy + static_cast<size_t>(r) * h + c0;
    float dot_b = 0.f, dot_y = 0.f;
    for (int k = lane; k < hc_pad; k += 32) {
      float j = 0.f;
      if (valid && k < hc) {
        j = tanhf(pc_row[k] + pf_row[k]);
        if (blank_out != nullptr) {
          dot_b = fmaf(j, bw[c0 + k], dot_b);
          dot_y = fmaf(j, wy_row[k], dot_y);
        }
      }
      store_joint(js, ldj, row, k, j);
    }
    if (blank_out != nullptr) {
      for (int o = 16; o > 0; o >>= 1) {
        dot_b += __shfl_xor_sync(0xffffffffu, dot_b, o);
        dot_y += __shfl_xor_sync(0xffffffffu, dot_y, o);
      }
      if (lane == 0 && valid) {
        if (c0 > 0) {
          dot_b += dots[0][row];
          dot_y += dots[1][row];
        }
        if (c0 + hc < h) {
          dots[0][row] = dot_b;
          dots[1][row] = dot_y;
        } else {
          blank_out[r] = dot_b + bb[0];
          ly_out[r] = dot_y + by[r];
        }
      }
    }
  }
}

// acc[i][j] = sum_k joint(ty*kTM + i, k) W[k, y0 + tx*kTN + j] from the
// resident tile, k < h; columns >= V read W as 0.
__device__ __forceinline__ void resident_product(
    const float* __restrict__ js, int ldj, float* __restrict__ w_tile,
    float* __restrict__ c_tile, const float* __restrict__ W, int V, int y0,
    int h, float (&acc)[kTM][kTN]) {
  const int tid = threadIdx.x;
  const int tx = tid % (kBN / kTN), ty = tid / (kBN / kTN);
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;
  }
  for (int k0 = 0; k0 < h; k0 += kBK) {
    for (int idx = tid; idx < kBK * kBN; idx += kThreads) {
      const int r = idx / kBN, c = idx % kBN;
      const int k = k0 + r, y = y0 + c;
      w_tile[r * kBN + c] =
          (k < h && y < V) ? W[static_cast<size_t>(k) * V + y] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[kTM], w[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) a[i] = js[(k0 + kk) * kLdT + ty * kTM + i];
#pragma unroll
      for (int j = 0; j < kTN; ++j) w[j] = w_tile[kk * kBN + tx * kTN + j];
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
      }
    }
    __syncthreads();
  }
}

__device__ __forceinline__ void resident_product(
    const __nv_bfloat16* __restrict__ js, int ldj,
    __nv_bfloat16* __restrict__ w_tile, float* __restrict__ c_tile,
    const __nv_bfloat16* __restrict__ W, int V, int y0, int h,
    float (&acc)[kTM][kTN]) {
  using namespace nvcuda;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / 2, wn = warp % 2;  // 4 x 2 warps over 64 x 64
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> c_frag[2];
  wmma::fill_fragment(c_frag[0], 0.f);
  wmma::fill_fragment(c_frag[1], 0.f);
  const bool w_vec = V % 8 == 0 && aligned16(W);
  for (int k0 = 0; k0 < h; k0 += kWK) {
    stage_slice(w_tile, kLdW, W + static_cast<size_t>(k0) * V + y0, V, h - k0,
                V - y0, w_vec);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kWK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major>
          a_frag;
      wmma::load_matrix_sync(a_frag, &js[wm * 16 * ldj + k0 + kk], ldj);
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major>
            b_frag;
        wmma::load_matrix_sync(b_frag, &w_tile[kk * kLdW + wn * 32 + n * 16],
                               kLdW);
        wmma::mma_sync(c_frag[n], a_frag, b_frag, c_frag[n]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    wmma::store_matrix_sync(&c_tile[wm * 16 * kLdC + wn * 32 + n * 16],
                            c_frag[n], kLdC, wmma::mem_row_major);
  }
  __syncthreads();
  const int tx = tid % (kBN / kTN), ty = tid / (kBN / kTN);
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      acc[i][j] = c_tile[(ty * kTM + i) * kLdC + tx * kTN + j];
    }
  }
  __syncthreads();
}

// The head product over one split of the label strips for a 64-row tile of
// frame t0 + blockIdx.z. Grid (ceil(R / 64), splits, frames).
//
// kForward: the online (max, sum) of the logits per row into part_m /
// part_l [splits, frames, R]; split 0 also writes blank and ly [frames, R].
// kGradient: ds = coef e^(logits - ref) into ds [frames, R, V] (compute
// type) and its float32 column sums per (frame, row tile) into dvb_part
// [frames, ceil(R / 64), V]; split 0 also writes the rounded joint into
// jc [frames, R, h]. CHUNKED: h exceeds the joint tile's chunk (a launch
// without it takes h <= Resident<T>::kChunk and compiles to one chunk).
template <typename T, int MODE, bool CHUNKED>
__global__ void __launch_bounds__(kThreads)
    head_kernel(const float* __restrict__ pc,      // [R, h]
                const float* __restrict__ pf,      // [T, B, h] from frame t0
                const T* __restrict__ W,           // [h, V]
                const float* __restrict__ vb,      // [V]
                const float* __restrict__ bw,      // [h]
                const float* __restrict__ bb,      // [1]
                const float* __restrict__ wy,      // [R, h]
                const float* __restrict__ by,      // [R]
                float* __restrict__ part_m,        // kForward
                float* __restrict__ part_l,        // kForward
                float* __restrict__ blank_out,     // kForward, [frames, R]
                float* __restrict__ ly_out,        // kForward, [frames, R]
                const float* __restrict__ g_b,     // kGradient, [frames, R]
                const float* __restrict__ g_l,     // kGradient, [frames, R]
                const float* __restrict__ z,       // kGradient, [frames, R]
                const float* __restrict__ blank,   // kGradient, [frames, R]
                T* __restrict__ ds,                // kGradient
                T* __restrict__ jc,                // kGradient
                float* __restrict__ dvb_part,      // kGradient
                int R, int B, int U1, int h, int V, int hat,
                int strips_per_split) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float dots[2][kRows];
  const int ldj = Resident<T>::ld(h);
  const int chunk = CHUNKED ? Resident<T>::kChunk : h;
  const int num_chunks = CHUNKED ? (h + chunk - 1) / chunk : 1;
  // The tile's depth: the products read whole kBK (float32) or kWK
  // (bfloat16) slices, zero past the chunk.
  const int h_pad = sizeof(T) == 4 ? round_up(min(h, chunk), kBK)
                                   : round_up(min(h, chunk), kWK);
  T* js = reinterpret_cast<T*>(smem);
  T* w_tile;
  float* c_tile = nullptr;
  float* cand;
  if (sizeof(T) == 4) {
    w_tile = js + static_cast<size_t>(h_pad) * kLdT;
    cand = reinterpret_cast<float*>(w_tile + kBK * kBN);
  } else {
    w_tile = js + static_cast<size_t>(kRows) * ldj;
    c_tile = reinterpret_cast<float*>(w_tile + kWK * kLdW);
    cand = c_tile + kBM * kLdC;
  }
  const int tid = threadIdx.x;
  const int tx = tid % (kBN / kTN), ty = tid / (kBN / kTN);
  const int r0 = blockIdx.x * kRows;
  const int f = blockIdx.z;  // frame within the launch
  const size_t fr = static_cast<size_t>(f) * R;
  const int strips = (V + kBN - 1) / kBN;
  const int strip_begin = blockIdx.y * strips_per_split;
  const int strip_end = min(strips, strip_begin + strips_per_split);
  const bool first_split = blockIdx.y == 0;

  // Stages chunk c of the joint; `outputs`: also the per-row outputs of the
  // first split (blank and ly in kForward, the rounded joint in kGradient),
  // written once per row.
  auto stage = [&](int c, bool outputs) {
    const int c0 = CHUNKED ? c * chunk : 0;
    const int hc = CHUNKED ? min(chunk, h - c0) : h;
    const bool scores = MODE == kForward && first_split && outputs;
    stage_joint<T>(js, ldj, pc, pf + static_cast<size_t>(f) * B * h, bw, bb,
                   wy, by, r0, R, U1, h, c0, hc,
                   sizeof(T) == 4 ? round_up(hc, kBK) : round_up(hc, kWK),
                   dots, scores ? blank_out + fr : nullptr,
                   scores ? ly_out + fr : nullptr);
    __syncthreads();
    if (MODE == kGradient && first_split && outputs) {
      // The rounded joint, for the d_W contraction (row-major [R, h]).
      for (int idx = tid; idx < kRows * hc; idx += kThreads) {
        const int row = idx / hc, k = idx % hc;
        if (r0 + row < R) {
          jc[(fr + r0 + row) * h + c0 + k] =
              sizeof(T) == 4 ? js[k * kLdT + row] : js[row * ldj + k];
        }
      }
    }
  };
  if (num_chunks == 1 || strip_begin >= strip_end) {
    for (int c = 0; c < num_chunks; ++c) stage(c, true);
  }

  // Per-row constants of this thread's rows.
  float run_m[kTM], run_l[kTM], coef[kTM], ref[kTM];
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    run_m[i] = -INFINITY;
    run_l[i] = 0.f;
    coef[i] = 0.f;
    ref[i] = 0.f;
    const int r = r0 + ty * kTM + i;
    if (MODE == kGradient && r < R) {
      const float gb = g_b[fr + r], gl = g_l[fr + r];
      const float zz = z[fr + r];
      if (hat) {
        coef[i] = -gl;
        ref[i] = zz;
      } else {
        coef[i] = -(gb + gl);
        ref[i] = log_add(blank[fr + r], zz);
      }
    }
  }

  for (int strip = strip_begin; strip < strip_end; ++strip) {
    const int y0 = strip * kBN;
    float val[kTM][kTN];
    if (num_chunks == 1) {
      resident_product(js, ldj, w_tile, c_tile, W, V, y0, h, val);
    } else {
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
#pragma unroll
        for (int j = 0; j < kTN; ++j) val[i][j] = 0.f;
      }
      for (int c = 0; c < num_chunks; ++c) {
        stage(c, strip == strip_begin);
        float part[kTM][kTN];
        resident_product(js, ldj, w_tile, c_tile,
                         W + static_cast<size_t>(c) * chunk * V, V, y0,
                         min(chunk, h - c * chunk), part);
#pragma unroll
        for (int i = 0; i < kTM; ++i) {
#pragma unroll
          for (int j = 0; j < kTN; ++j) val[i][j] += part[i][j];
        }
      }
    }
    float bias[kTN];
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int y = y0 + tx * kTN + j;
      bias[j] = y < V ? vb[y] : 0.f;
    }
    if (MODE == kForward) {
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
        float v[kTN];
        float m = -INFINITY;
#pragma unroll
        for (int j = 0; j < kTN; ++j) {
          const int y = y0 + tx * kTN + j;
          v[j] = y < V ? val[i][j] + bias[j] : -INFINITY;
          m = fmaxf(m, v[j]);
        }
        // The 16 threads of a row group are lanes of one half-warp.
        for (int o = 8; o > 0; o >>= 1) {
          m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
        }
        const float c = safe_shift(m);
        float l = 0.f;
#pragma unroll
        for (int j = 0; j < kTN; ++j) l += expf(v[j] - c);
        for (int o = 8; o > 0; o >>= 1) {
          l += __shfl_xor_sync(0xffffffffu, l, o);
        }
        lse_merge(run_m[i], run_l[i], m, l);
      }
    } else {
      float col[kTN];
#pragma unroll
      for (int j = 0; j < kTN; ++j) col[j] = 0.f;
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
        const int r = r0 + ty * kTM + i;
        if (r >= R) continue;
#pragma unroll
        for (int j = 0; j < kTN; ++j) {
          const int y = y0 + tx * kTN + j;
          if (y >= V) continue;
          const float d = coef[i] * expf(val[i][j] + bias[j] - ref[i]);
          ds[(fr + r) * V + y] = from_float<T>(d);
          col[j] += d;
        }
      }
#pragma unroll
      for (int j = 0; j < kTN; ++j) cand[ty * kBN + tx * kTN + j] = col[j];
      __syncthreads();
      if (tid < kBN && y0 + tid < V) {
        float total = 0.f;
        for (int g = 0; g < kBM / kTM; ++g) total += cand[g * kBN + tid];
        dvb_part[(static_cast<size_t>(f) * gridDim.x + blockIdx.x) * V + y0 +
                 tid] = total;
      }
      __syncthreads();
    }
  }

  if (MODE == kForward && tx == 0) {
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const int r = r0 + ty * kTM + i;
      if (r < R) {
        const size_t at =
            (static_cast<size_t>(blockIdx.y) * gridDim.z + f) * R + r;
        part_m[at] = run_m[i];
        part_l[at] = run_l[i];
      }
    }
  }
}

// z = merged logsumexp; nb, nl from it, blank and ly (held in nl on entry).
// One thread per (frame, row).
__global__ void __launch_bounds__(kPointThreads)
    forward_merge_kernel(const float* __restrict__ part_m,
                         const float* __restrict__ part_l, int splits,
                         const float* __restrict__ blank,
                         float* __restrict__ nb, float* __restrict__ nl,
                         float* __restrict__ z, size_t n, int hat) {
  const size_t idx = static_cast<size_t>(blockIdx.x) * kPointThreads +
                     threadIdx.x;
  if (idx >= n) return;
  float m = -INFINITY, l = 0.f;
  for (int s = 0; s < splits; ++s) {
    lse_merge(m, l, part_m[s * n + idx], part_l[s * n + idx]);
  }
  const float zz = lse_value(m, l);
  const float bl = blank[idx];
  const float ly = nl[idx];
  z[idx] = zz;
  if (hat) {
    nb[idx] = log_sigmoid(bl);
    nl[idx] = ly - zz + log_sigmoid(-bl);
  } else {
    const float za = log_add(bl, zz);
    nb[idx] = bl - za;
    nl[idx] = ly - za;
  }
}

__device__ __forceinline__ float blank_cotangent(float gb, float gl, float zz,
                                                 float bl, int hat) {
  if (hat) {
    const float sig = 1.f / (1.f + expf(-bl));
    return gb * (1.f - sig) - gl * sig;
  }
  return gb - (gb + gl) * expf(bl - log_add(bl, zz));
}

// d_W partial: dw_acc[split] += jc^T ds over the split's range of the
// chunk's rows. Grid (ceil(V / 64), ceil(h / 64), splits).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    head_grad_kernel(const T* __restrict__ jc,     // [rows, h]
                     const T* __restrict__ ds,     // [rows, V]
                     float* __restrict__ dw_acc,   // [splits, h, V]
                     int rows, int h, int V, int rows_per_split) {
  const int y0 = blockIdx.x * kBN;
  const int h0 = blockIdx.y * kBM;
  const int q0 = blockIdx.z * rows_per_split;
  const int q1 = min(rows, q0 + rows_per_split);
  if (q0 >= q1) return;
  float acc[kTM][kTN];
  tile_product<true, false>(jc + static_cast<size_t>(q0) * h, h,
                            ds + static_cast<size_t>(q0) * V, V, h0, y0, h, V,
                            q1 - q0, acc);
  const int tx = threadIdx.x % (kBN / kTN), ty = threadIdx.x / (kBN / kTN);
  float* out = dw_acc + static_cast<size_t>(blockIdx.z) * h * V;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int hh = h0 + ty * kTM + i;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int y = y0 + tx * kTN + j;
      if (hh < h && y < V) out[static_cast<size_t>(hh) * V + y] += acc[i][j];
    }
  }
}

// dj = ds W^T + gl wy + d_blank bw and du = dj (1 - joint32^2) for a (hidden
// tile, 64 label positions of batch row b) over the frames f = split,
// split + splits, ... of the chunk: du and gl joint32 summed over those
// frames into dpc_acc / dwy_acc [splits, R, h], d_blank joint32 into dbw_acc
// [splits, B * utiles, h], and per frame the position sums of du into
// dpf_part [utiles, frames, B, h]. Grid (ceil(h / 64), B * utiles, splits).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    joint_grad_kernel(const T* __restrict__ ds,       // [frames, R, V]
                      const T* __restrict__ W,        // [h, V]
                      const float* __restrict__ pc,   // [R, h]
                      const float* __restrict__ pf,   // [T, B, h] at t0
                      const float* __restrict__ wy,   // [R, h]
                      const float* __restrict__ bw,   // [h]
                      const float* __restrict__ g_b,  // [frames, R]
                      const float* __restrict__ g_l,
                      const float* __restrict__ z,
                      const float* __restrict__ blank,
                      float* __restrict__ dpc_acc, float* __restrict__ dwy_acc,
                      float* __restrict__ dbw_acc,
                      float* __restrict__ dpf_part, int frames, int R, int B,
                      int U1, int h, int V, int hat) {
  __shared__ float cand_f[kBM / kTM][kBN];
  __shared__ float cand_w[kBM / kTM][kBN];
  const int utiles = (U1 + kBM - 1) / kBM;
  const int b = blockIdx.y / utiles, ut = blockIdx.y % utiles;
  const int u0 = ut * kBM;
  const int h0 = blockIdx.x * kBN;
  const int tid = threadIdx.x;
  const int tx = tid % (kBN / kTN), ty = tid / (kBN / kTN);
  const int row0 = b * U1 + u0;  // first row of the tile
  const int rows = min(kBM, U1 - u0);
  float acc_pc[kTM][kTN], acc_wy[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc_pc[i][j] = acc_wy[i][j] = 0.f;
  }
  float run_bw = 0.f;  // column h0 + tid, tid < 64
  for (int f = blockIdx.z; f < frames; f += gridDim.z) {
    const size_t fr = static_cast<size_t>(f) * R;
    float acc[kTM][kTN];
    tile_product<false, true>(ds + (fr + row0) * V, V, W, V, 0, h0, rows, h,
                              V, acc);
    float col_f[kTN], col_w[kTN];
#pragma unroll
    for (int j = 0; j < kTN; ++j) col_f[j] = col_w[j] = 0.f;
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const int u = ty * kTM + i;
      if (u >= rows) continue;
      const int r = row0 + u;
      const float gb = g_b[fr + r], gl = g_l[fr + r];
      const float db = blank_cotangent(gb, gl, z[fr + r], blank[fr + r], hat);
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const int hh = h0 + tx * kTN + j;
        if (hh >= h) continue;
        const float jt = tanhf(pc[static_cast<size_t>(r) * h + hh] +
                               pf[(static_cast<size_t>(f) * B + b) * h + hh]);
        const float dj = acc[i][j] + gl * wy[static_cast<size_t>(r) * h + hh] +
                         db * bw[hh];
        const float du = dj * (1.f - jt * jt);
        acc_pc[i][j] += du;
        acc_wy[i][j] += gl * jt;
        col_f[j] += du;
        col_w[j] += db * jt;
      }
    }
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      cand_f[ty][tx * kTN + j] = col_f[j];
      cand_w[ty][tx * kTN + j] = col_w[j];
    }
    __syncthreads();
    if (tid < kBN && h0 + tid < h) {
      float sf = 0.f, sw = 0.f;
      for (int g = 0; g < kBM / kTM; ++g) {
        sf += cand_f[g][tid];
        sw += cand_w[g][tid];
      }
      dpf_part[((static_cast<size_t>(ut) * frames + f) * B + b) * h + h0 +
               tid] = sf;
      run_bw += sw;
    }
    __syncthreads();
  }
  const size_t split_rows = static_cast<size_t>(blockIdx.z) * R;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int u = ty * kTM + i;
    if (u >= rows) continue;
    const size_t at = (split_rows + row0 + u) * h;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int hh = h0 + tx * kTN + j;
      if (hh >= h) continue;
      dpc_acc[at + hh] += acc_pc[i][j];
      dwy_acc[at + hh] += acc_wy[i][j];
    }
  }
  if (tid < kBN && h0 + tid < h) {
    dbw_acc[(static_cast<size_t>(blockIdx.z) * gridDim.y + blockIdx.y) * h +
            h0 + tid] += run_bw;
  }
}

// d_by[r] = sum_t gl[t, r]; db_row[r] = sum_t d_blank[t, r]. One thread per
// row.
__global__ void __launch_bounds__(kPointThreads)
    bias_grad_kernel(const float* __restrict__ g_b,
                     const float* __restrict__ g_l,
                     const float* __restrict__ z,
                     const float* __restrict__ blank, int frames, int R,
                     int hat, float* __restrict__ d_by,
                     float* __restrict__ db_row) {
  const int r = blockIdx.x * kPointThreads + threadIdx.x;
  if (r >= R) return;
  float sy = 0.f, sb = 0.f;
  for (int t = 0; t < frames; ++t) {
    const size_t at = static_cast<size_t>(t) * R + r;
    sy += g_l[at];
    sb += blank_cotangent(g_b[at], g_l[at], z[at], blank[at], hat);
  }
  d_by[r] = sy;
  db_row[r] = sb;
}

// out[i] = (accumulate ? out[i] : 0) + sum_q in[q * n + i].
__global__ void __launch_bounds__(kPointThreads)
    sum_rows_kernel(const float* __restrict__ in, int rows, size_t n,
                    float* __restrict__ out, int accumulate) {
  const size_t idx = static_cast<size_t>(blockIdx.x) * kPointThreads +
                     threadIdx.x;
  if (idx >= n) return;
  float total = accumulate ? out[idx] : 0.f;
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

// The head kernel for hidden size h (chunked past Resident<T>::kChunk),
// allowed Resident<T>::bytes(h) of dynamic shared memory (over 48 KB);
// fails when the card has less.
template <typename T, int MODE>
int head_launch_setup(int h, size_t* bytes,
                      decltype(&head_kernel<T, MODE, false>)* kernel) {
  *kernel = h > Resident<T>::kChunk ? head_kernel<T, MODE, true>
                                    : head_kernel<T, MODE, false>;
  *bytes = Resident<T>::bytes(h);
  RETURN_IF_FAILED(cudaFuncSetAttribute(
      *kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(*bytes)));
  return 0;
}

template <typename T>
int run_forward(const float* pc, const float* pf, const T* W,
                const float* vb, const float* bw, const float* bb,
                const float* wy, const float* by, float* part_m,
                float* part_l, float* nb, float* nl, float* z, float* blank,
                int num_frames, int B, int U1, int h, int V, int hat,
                int max_splits, cudaStream_t stream) {
  const int R = B * U1;
  const int strips = (V + kBN - 1) / kBN;
  const int per_split =
      (strips + max_splits - 1) / (max_splits > 0 ? max_splits : 1);
  const int splits = (strips + per_split - 1) / per_split;
  if (num_frames == 0 || R == 0) return 0;
  size_t bytes = 0;
  decltype(&head_kernel<T, kForward, false>) kernel = nullptr;
  const int status = head_launch_setup<T, kForward>(h, &bytes, &kernel);
  if (status != 0) return status;
  const dim3 grid((R + kRows - 1) / kRows, splits, num_frames);
  kernel<<<grid, kThreads, bytes, stream>>>(
      pc, pf, W, vb, bw, bb, wy, by, part_m, part_l, blank, nl, nullptr,
      nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, R, B, U1, h, V,
      hat, per_split);
  RETURN_IF_LAUNCH_FAILED();
  const size_t n = static_cast<size_t>(num_frames) * R;
  forward_merge_kernel<<<blocks_for(n), kPointThreads, 0, stream>>>(
      part_m, part_l, splits, blank, nb, nl, z, n, hat);
  RETURN_IF_LAUNCH_FAILED();
  return 0;
}

template <typename T>
int run_backward(const float* pc, const float* pf, const T* W,
                 const float* vb, const float* bw, const float* bb,
                 const float* wy, const float* by, const float* z,
                 const float* blank, const float* g_b, const float* g_l,
                 T* jc, T* ds, float* dvb_part, float* dw_acc,
                 float* dpc_acc, float* dwy_acc, float* dbw_acc,
                 float* dpf_part, float* db_row, float* d_pf, float* d_pc,
                 float* d_wy, float* d_w, float* d_vb, float* d_bw,
                 float* d_by, float* d_bb, int num_frames, int B, int U1,
                 int h, int V, int hat, int chunk, int max_splits,
                 int max_ksplits, int fsplits, cudaStream_t stream) {
  const int R = B * U1;
  const int row_tiles = (R + kRows - 1) / kRows;
  const int strips = (V + kBN - 1) / kBN;
  const int h_tiles = (h + kBN - 1) / kBN;
  const int utiles = (U1 + kBM - 1) / kBM;
  const int per_split =
      (strips + max_splits - 1) / (max_splits > 0 ? max_splits : 1);
  const int splits = (strips + per_split - 1) / per_split;
  size_t bytes = 0;
  decltype(&head_kernel<T, kGradient, false>) kernel = nullptr;
  if (num_frames > 0 && R > 0) {
    const int status = head_launch_setup<T, kGradient>(h, &bytes, &kernel);
    if (status != 0) return status;
  }
  for (int t0 = 0; t0 < num_frames; t0 += chunk) {
    const int frames = min(chunk, num_frames - t0);
    const size_t fr = static_cast<size_t>(t0) * R;
    const float* pf_c = pf + static_cast<size_t>(t0) * B * h;
    kernel<<<dim3(row_tiles, splits, frames), kThreads, bytes, stream>>>(
            pc, pf_c, W, vb, bw, bb, wy, by, nullptr, nullptr, nullptr,
            nullptr, g_b + fr, g_l + fr, z + fr, blank + fr, ds, jc,
            dvb_part, R, B, U1, h, V, hat, per_split);
    RETURN_IF_LAUNCH_FAILED();
    const int rows = frames * R;
    int rows_per_split =
        (rows + max_ksplits - 1) / (max_ksplits > 0 ? max_ksplits : 1);
    rows_per_split = round_up(rows_per_split, kWK);
    const int ksplits = (rows + rows_per_split - 1) / rows_per_split;
    head_grad_kernel<T><<<dim3(strips, h_tiles, ksplits), kThreads, 0,
                          stream>>>(jc, ds, dw_acc, rows, h, V,
                                    rows_per_split);
    RETURN_IF_LAUNCH_FAILED();
    joint_grad_kernel<T><<<dim3(h_tiles, B * utiles, fsplits), kThreads, 0,
                           stream>>>(
        ds, W, pc, pf_c, wy, bw, g_b + fr, g_l + fr, z + fr, blank + fr,
        dpc_acc, dwy_acc, dbw_acc, dpf_part, frames, R, B, U1, h, V, hat);
    RETURN_IF_LAUNCH_FAILED();
    sum_rows_kernel<<<blocks_for(V), kPointThreads, 0, stream>>>(
        dvb_part, frames * row_tiles, V, d_vb, t0 > 0);
    RETURN_IF_LAUNCH_FAILED();
    const size_t n_pf = static_cast<size_t>(frames) * B * h;
    sum_rows_kernel<<<blocks_for(n_pf), kPointThreads, 0, stream>>>(
        dpf_part, utiles, n_pf, d_pf + static_cast<size_t>(t0) * B * h, 0);
    RETURN_IF_LAUNCH_FAILED();
  }
  if (R > 0) {
    bias_grad_kernel<<<blocks_for(R), kPointThreads, 0, stream>>>(
        g_b, g_l, z, blank, num_frames, R, hat, d_by, db_row);
    RETURN_IF_LAUNCH_FAILED();
  }
  const struct {
    const float* in;
    int rows;
    size_t n;
    float* out;
  } sums[] = {{dpc_acc, fsplits, static_cast<size_t>(R) * h, d_pc},
              {dwy_acc, fsplits, static_cast<size_t>(R) * h, d_wy},
              {dw_acc, max_ksplits, static_cast<size_t>(h) * V, d_w},
              {dbw_acc, fsplits * B * utiles, static_cast<size_t>(h), d_bw},
              {db_row, R, 1, d_bb}};
  for (const auto& sum : sums) {
    sum_rows_kernel<<<blocks_for(sum.n), kPointThreads, 0, stream>>>(
        sum.in, sum.rows, sum.n, sum.out, 0);
    RETURN_IF_LAUNCH_FAILED();
  }
  if (num_frames == 0) {  // no chunk ran: d_vb is all zeros
    sum_rows_kernel<<<blocks_for(V), kPointThreads, 0, stream>>>(
        dvb_part, 0, V, d_vb, 0);
    RETURN_IF_LAUNCH_FAILED();
  }
  return 0;
}

}  // namespace

extern "C" {

// Dynamic shared memory one head block requests for hidden size h (dtype 0 =
// float32, 1 = bfloat16): it grows with h up to the joint tile's chunk
// (512 float32, 1024 bfloat16 hidden units) and stays there.
size_t numerator_head_smem_bytes(int dtype, int h) {
  return dtype == 0 ? Resident<float>::bytes(h)
                    : Resident<__nv_bfloat16>::bytes(h);
}

// The forward on `stream`; returns the first error (0 on success). The
// caller allocates everything: part_m / part_l [max_splits, T, R] scratch,
// outputs nb, nl, z, blank [T, R]. W is [h, V] in the compute type (dtype 0 =
// float32, 1 = bfloat16); everything else is float32; R = B * U1.
int numerator_forward(int dtype, const float* pc, const float* pf,
                      const void* W, const float* vb, const float* bw,
                      const float* bb, const float* wy, const float* by,
                      float* part_m, float* part_l, float* nb, float* nl,
                      float* z, float* blank, int num_frames, int B, int U1,
                      int h, int V, int hat, int max_splits, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return run_forward<float>(pc, pf, static_cast<const float*>(W), vb, bw,
                              bb, wy, by, part_m, part_l, nb, nl, z, blank,
                              num_frames, B, U1, h, V, hat, max_splits, s);
  }
  if (dtype == 1) {
    return run_forward<__nv_bfloat16>(
        pc, pf, static_cast<const __nv_bfloat16*>(W), vb, bw, bb, wy, by,
        part_m, part_l, nb, nl, z, blank, num_frames, B, U1, h, V, hat,
        max_splits, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The backward on `stream`; returns the first error. Scratch, in the compute
// type: jc [chunk, R, h], ds [chunk, R, V]; float32: dvb_part [chunk,
// ceil(R / 64), V], dpf_part [ceil(U1 / 64), chunk, B, h], db_row [R];
// zeroed accumulators dw_acc [max_ksplits, h, V], dpc_acc / dwy_acc
// [fsplits, R, h], dbw_acc [fsplits, B * ceil(U1 / 64), h]. Outputs d_pf
// [T, B, h], d_pc / d_wy [R, h], d_w [h, V], d_vb [V], d_bw [h], d_by [R],
// d_bb [1].
int numerator_backward(int dtype, const float* pc, const float* pf,
                       const void* W, const float* vb, const float* bw,
                       const float* bb, const float* wy, const float* by,
                       const float* z, const float* blank, const float* g_b,
                       const float* g_l, void* jc, void* ds, float* dvb_part,
                       float* dw_acc, float* dpc_acc, float* dwy_acc,
                       float* dbw_acc, float* dpf_part, float* db_row,
                       float* d_pf, float* d_pc, float* d_wy, float* d_w,
                       float* d_vb, float* d_bw, float* d_by, float* d_bb,
                       int num_frames, int B, int U1, int h, int V, int hat,
                       int chunk, int max_splits, int max_ksplits,
                       int fsplits, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return run_backward<float>(
        pc, pf, static_cast<const float*>(W), vb, bw, bb, wy, by, z, blank,
        g_b, g_l, static_cast<float*>(jc), static_cast<float*>(ds), dvb_part,
        dw_acc, dpc_acc, dwy_acc, dbw_acc, dpf_part, db_row, d_pf, d_pc, d_wy,
        d_w, d_vb, d_bw, d_by, d_bb, num_frames, B, U1, h, V, hat, chunk,
        max_splits, max_ksplits, fsplits, s);
  }
  if (dtype == 1) {
    return run_backward<__nv_bfloat16>(
        pc, pf, static_cast<const __nv_bfloat16*>(W), vb, bw, bb, wy, by, z,
        blank, g_b, g_l, static_cast<__nv_bfloat16*>(jc),
        static_cast<__nv_bfloat16*>(ds), dvb_part, dw_acc, dpc_acc, dwy_acc,
        dbw_acc, dpf_part, db_row, d_pf, d_pc, d_wy, d_w, d_vb, d_bw, d_by,
        d_bb, num_frames, B, U1, h, V, hat, chunk, max_splits, max_ksplits,
        fsplits, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* numerator_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
