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
// product over every (frame, row) pair (2 T R h V = 1.36 TFLOP at B=8,
// U1=101, T=1600, h=512, V=1024) and the backward three (the replayed
// logits, dj and d_W): compute-bound products. The string DP masks every
// frame past a row's length and every label position past its labels, so
// their cotangents are zero and they contribute exactly zero to the
// backward, which skips them: at bench shapes half of the pairs.
// In float32 (the training default) the products run on the CUDA cores
// (67 TFLOP/s peak), in bfloat16 on the tensor cores (989 TFLOP/s).
//
// What the design does about it:
// * Forward. The weights have no recurrence over time: each frame's
//   outputs depend on that frame alone. The TPU walked T as a sequential
//   grid axis only to keep W resident in VMEM. Here the forward walks the
//   (frame, 64-row tile) items of all T frames in chunks of frames (the
//   backward's items and slots, every item live: the forward has no
//   lengths, and JAX's defines every (t, r) output), three launches a
//   chunk. forward_joint_kernel writes the chunk's joint in the compute
//   type ([slots, 64, hp], zero past R and h) and, from the float32 joint,
//   the float32 scores blank and ly. The head product then reduces each
//   row over a label strip to one online (max, sum) pair in its epilogue,
//   no logits stored: bfloat16 on wgmma (hopper::row_lse_kernel, 128-label
//   strips), float32 exact on the FMA tiles (simt::row_lse_kernel,
//   256-label strips); both persistent grids walk the chunk's items.
//   forward_merge_kernel merges the strips into z, nb and nl. The joint is
//   formed once per item, not once per label strip, and the head's tiles
//   come from the L2 cache; any h works (the depth is walked in 64-deep
//   stages).
// * Backward: live tiles only. The [B, U1] rows are flattened (no padding
//   to 8 or 128) into 64-row tiles, which may hold the end of one batch row
//   and the start of the next. mark_kernel flags each (frame, row tile)
//   whose rows hold a nonzero cotangent and list_kernel (one block, a
//   prefix sum) compacts the flags into a list of items, by chunk of
//   frames, tile and frame, with per (chunk, tile) offsets and per chunk
//   counts in device memory. Every later launch reads its chunk's count
//   from there: no host synchronisation. A chunk's items get consecutive
//   slots of 64 rows in its staging buffers (sized by the caller for
//   every tile of the chunk's frames live).
// * Per chunk, five launches (six in float32). joint_pass_kernel forms the
//   live items' joint in the compute type (and, in bfloat16, the float32
//   joint32 for the tanh derivative), zero past R and h, with the sums
//   that need no product (d_wy, and d_bw per tile). The ds product replays
//   the logits per (item, label strip) and in its epilogue writes ds =
//   coef e^(logits - ref) once, in the compute type (0 past V and on rows
//   whose coef is 0), with its column sums (d_vb). The d_joint product (dj
//   = ds . W^T, K = Vp) adds gl wy[r] + d_blank bw and takes the tanh
//   derivative in its epilogue. In bfloat16 it runs per (row tile, hidden
//   strip, split) over the tile's items, keeping d_pc = sum_t du in
//   registers and summing du over each batch row's positions in the tile
//   (d_pf partials, summed per frame by dpf_sum_kernel). In float32, where
//   those 64 running sums a thread left one block an SM, it stores du per
//   item (float32) from a persistent grid at two blocks an SM, and
//   du_sum_kernel forms the d_pc and d_pf partials from it: on an H100,
//   26.1 against 42.1 ms for the product at the HAT step's shape, plus 2.6
//   ms for the sums (PERF.md; in bfloat16 storing du lost, 37.7 + 7.1
//   against 32.3 ms). The d_W product (joint^T ds) splits the chunk's
//   items over its blocks. Every cross-frame sum is a buffer in which each
//   element belongs to one block (d_W, d_pc per split, d_vb per block of
//   the ds product, d_bw per tile, d_wy per (tile, hidden strip)), zeroed
//   once and reduced by one launch at the end: no atomics, deterministic
//   sums for the same inputs.
// * bfloat16 runs the backward's three products on wgmma with TMA operands
//   (wgmma_tiles.cuh: a 4-stage mbarrier ring, one consumer warpgroup, two
//   blocks an SM): the ds product here (lex_grad_kernel, a persistent grid
//   over the chunk's items by 128-label strip), the d_joint product
//   (head_grads.cuh's num_joint_grad_kernel) and d_W (head_grads.cuh's
//   head_grad_kernel, the item count read from device memory).
// * float32 stays exact FP32 on the CUDA cores (no TF32), as the plain
//   versions require: namespace simt, 64 x 256 block tiles, 8 x 8 entries a
//   thread from 16-byte shared-memory broadcasts (64 FMAs per four loads),
//   16-deep slices double-buffered through registers, the same live list
//   and slots.
// * g = 0 rows give exact zeros: every gradient term is a product with gb
//   or gl, ds is written as 0 where its coefficient is 0, and e^(logits -
//   z) <= 1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "head_grads.cuh"
#include "simt_tiles.cuh"
#include "tile_product.cuh"

namespace {

using namespace lattice_tiles;

constexpr int kRows = 64;             // rows per block tile
constexpr int kPointThreads = 256;

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

__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

__host__ __device__ inline int round_up(int x, int m) {
  return (x + m - 1) / m * m;
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
    const float za = head_grads::log_add_exp(bl, zz);
    nb[idx] = bl - za;
    nl[idx] = ly - za;
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
    sb += head_grads::row_cotangent(g_b[at], g_l[at], z[at], blank[at], hat)
              .d_blank;
  }
  d_by[r] = sy;
  db_row[r] = sb;
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

// ---------------------------------------------------------------------------
// The backward. Items are the (frame t, 64-row tile) pairs whose rows hold a
// nonzero cotangent at t, found on the device (mark_kernel, list_kernel) and
// walked by the products in chunks of frames; slot = an item's position
// among its chunk's, the row block it owns in the chunk's staging buffers.

constexpr int kListThreads = 1024;
constexpr int kPassCols = 32;  // hidden units per joint-pass block

// flags[t R64 + k] = 1 where a row of tile k holds a nonzero g_b or g_l at
// frame t, else 0. A warp per (t, k). Grid ceil(T R64 / 8).
__global__ void __launch_bounds__(kPointThreads)
    mark_kernel(const float* __restrict__ g_b, const float* __restrict__ g_l,
                int* __restrict__ flags, int T, int R, int R64) {
  const long long w = static_cast<long long>(blockIdx.x) *
                          (kPointThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (w >= static_cast<long long>(T) * R64) return;
  const int t = static_cast<int>(w / R64), k = static_cast<int>(w % R64);
  bool live = false;
  for (int row = lane; row < kRows; row += 32) {
    const int r = k * kRows + row;
    if (r < R) {
      const size_t at = static_cast<size_t>(t) * R + r;
      live |= g_b[at] != 0.f || g_l[at] != 0.f;
    }
  }
  live = __any_sync(0xffffffffu, live);
  if (lane == 0) flags[w] = live ? 1 : 0;
}

// The live list, one block: the (t, tile) flags in pos_of, in the order
// (chunk of Tc frames, tile, frame), compacted by a prefix sum. Writes
// items[pos] = t R64 + tile, pos_of[t R64 + tile] = pos (-1 where dead),
// groups[c R64 + tile] = the first position of (chunk c, tile) and
// groups[C R64] = the count, count[c] = chunk c's items.
__global__ void __launch_bounds__(kListThreads)
    list_kernel(int* __restrict__ pos_of, int* __restrict__ items,
                int* __restrict__ groups, int* __restrict__ count, int T,
                int R64, int Tc) {
  __shared__ int warp_sums[kListThreads / 32];
  __shared__ int carry;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int chunks = (T + Tc - 1) / Tc;
  const int n = T * R64;
  if (tid == 0) carry = 0;
  __syncthreads();
  for (int j0 = 0; j0 < n; j0 += kListThreads) {
    const int j = j0 + tid;
    int flag = 0, index = 0, group = -1;
    if (j < n) {
      const int c = min(j / (Tc * R64), chunks - 1);
      const int local = j - c * Tc * R64;
      const int len = min(Tc, T - c * Tc);
      const int tile = local / len, tl = local % len;
      index = (c * Tc + tl) * R64 + tile;
      flag = pos_of[index];
      if (tl == 0) group = c * R64 + tile;
    }
    int x = flag;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) warp_sums[warp] = x;
    __syncthreads();
    if (warp == 0) {
      int y = warp_sums[lane];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, y, o);
        if (lane >= o) y += v;
      }
      warp_sums[lane] = y;
    }
    __syncthreads();
    const int pos = carry + (warp > 0 ? warp_sums[warp - 1] : 0) + x - flag;
    if (j < n) {
      if (group >= 0) groups[group] = pos;
      pos_of[index] = flag ? pos : -1;
      if (flag) items[pos] = index;
    }
    __syncthreads();
    if (tid == 0) carry += warp_sums[kListThreads / 32 - 1];
    __syncthreads();
  }
  if (tid == 0) groups[chunks * R64] = carry;
  __syncthreads();
  for (int c = tid; c < chunks; c += kListThreads) {
    count[c] = groups[(c + 1) * R64] - groups[c * R64];
  }
}

// Four joint entries (from float32 values) into the joint row: 8 or 16
// bytes, hh a multiple of 4.
__device__ __forceinline__ void store4(float* out, const float (&j)[4]) {
  *reinterpret_cast<float4*>(out) = make_float4(j[0], j[1], j[2], j[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* out,
                                       const float (&j)[4]) {
  __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(out);
  o[0] = __floats2bfloat162_rn(j[0], j[1]);
  o[1] = __floats2bfloat162_rn(j[2], j[3]);
}

// The forward's joint pass of a chunk of frames from t0: item slot = (t -
// t0) R64 + k (every (frame, 64-row tile) of the chunk), joint[slot, row,
// hh] = T(tanh(pc[r] + pf[t, b(r)])) for r = 64 k + row (zero past R and h,
// up to hp), and each row's float32 scores from the float32 joint, blank[t,
// r] = joint32 . bw + bb and ly[t, r] = joint32 . wy[r] + by[r] (JAX's
// float32 dots). A warp per row, each lane 4 consecutive hidden units at a
// time (16-byte loads, one 8- or 16-byte store) where h % 4 == 0 and the
// inputs are 16-byte aligned, else one. Grid (frames R64).
template <typename T>
__global__ void __launch_bounds__(kPointThreads)
    forward_joint_kernel(const float* __restrict__ pc,  // [R, h]
                         const float* __restrict__ pf,  // [T, B, h]
                         const float* __restrict__ bw,  // [h]
                         const float* __restrict__ bb,  // [1]
                         const float* __restrict__ wy,  // [R, h]
                         const float* __restrict__ by,  // [R]
                         T* __restrict__ joint,         // [slots, 64, hp]
                         float* __restrict__ blank,     // [T, R]
                         float* __restrict__ ly,        // [T, R]
                         int t0, int R, int B, int U1, int h, int hp,
                         int R64) {
  const int slot = blockIdx.x;
  const int t = t0 + slot / R64, k = slot % R64;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool vec = h % 4 == 0 && aligned16(pc) && aligned16(pf) &&
                   aligned16(bw) && aligned16(wy);
  for (int row = warp; row < kRows; row += kPointThreads / 32) {
    const int r = k * kRows + row;
    const bool valid = r < R;
    const size_t rr = valid ? r : 0;
    const float* pc_row = pc + rr * h;
    const float* pf_row =
        pf + (static_cast<size_t>(t) * B + (valid ? r / U1 : 0)) * h;
    const float* wy_row = wy + rr * h;
    T* out = joint + (static_cast<size_t>(slot) * kRows + row) * hp;
    float dot_b = 0.f, dot_y = 0.f;
    if (vec) {
      for (int hh = lane * 4; hh < hp; hh += 128) {
        float j[4] = {0.f, 0.f, 0.f, 0.f};
        if (valid && hh < h) {
          const float4 c = *reinterpret_cast<const float4*>(pc_row + hh);
          const float4 f = *reinterpret_cast<const float4*>(pf_row + hh);
          const float4 w = *reinterpret_cast<const float4*>(bw + hh);
          const float4 y = *reinterpret_cast<const float4*>(wy_row + hh);
          j[0] = tanhf(c.x + f.x);
          j[1] = tanhf(c.y + f.y);
          j[2] = tanhf(c.z + f.z);
          j[3] = tanhf(c.w + f.w);
          dot_b = fmaf(j[0], w.x, fmaf(j[1], w.y, fmaf(j[2], w.z,
                       fmaf(j[3], w.w, dot_b))));
          dot_y = fmaf(j[0], y.x, fmaf(j[1], y.y, fmaf(j[2], y.z,
                       fmaf(j[3], y.w, dot_y))));
        }
        store4(out + hh, j);
      }
    } else {
      for (int hh = lane; hh < hp; hh += 32) {
        float j = 0.f;
        if (valid && hh < h) {
          j = tanhf(pc_row[hh] + pf_row[hh]);
          dot_b = fmaf(j, bw[hh], dot_b);
          dot_y = fmaf(j, wy_row[hh], dot_y);
        }
        out[hh] = from_float<T>(j);
      }
    }
    for (int o = 16; o > 0; o >>= 1) {
      dot_b += __shfl_xor_sync(0xffffffffu, dot_b, o);
      dot_y += __shfl_xor_sync(0xffffffffu, dot_y, o);
    }
    if (lane == 0 && valid) {
      const size_t at = static_cast<size_t>(t) * R + r;
      blank[at] = dot_b + bb[0];
      ly[at] = dot_y + by[r];
    }
  }
}

// The head in the compute type, padded with zeros: wp [hp, Vp] from W [h,
// V]. Grid ceil(hp Vp / 256).
template <typename T>
__global__ void __launch_bounds__(kPointThreads)
    pad_head_kernel(const float* __restrict__ W, T* __restrict__ wp, int h,
                    int V, int hp, int Vp) {
  const size_t i = static_cast<size_t>(blockIdx.x) * kPointThreads +
                   threadIdx.x;
  if (i >= static_cast<size_t>(hp) * Vp) return;
  const int k = static_cast<int>(i / Vp), y = static_cast<int>(i % Vp);
  wp[i] = from_float<T>(k < h && y < V ? W[static_cast<size_t>(k) * V + y]
                                       : 0.f);
}

// The joint pass of a chunk: for each live item of row tile blockIdx.x,
// joint[slot, row, hh] = T(tanh(pc[r] + pf[t, b(r)])) (zero past R and h)
// and, where joint32 is set, the float32 tanh; and the cross-frame sums that
// need no product, d_wy[r] += gl joint32 and dbw_part[tile] += sum_r
// d_blank joint32, owned by this block. A thread takes one hidden unit of
// the block's 32 and 8 rows. Grid (R64, hp / 32).
template <typename T>
__global__ void __launch_bounds__(kPointThreads)
    joint_pass_kernel(const float* __restrict__ pc,     // [R, h]
                      const float* __restrict__ pf,     // [T, B, h]
                      const float* __restrict__ g_b,    // [T, R]
                      const float* __restrict__ g_l,
                      const float* __restrict__ z,
                      const float* __restrict__ blank,
                      const int* __restrict__ items,
                      const int* __restrict__ groups,   // the chunk's
                      T* __restrict__ joint,            // [slots, 64, hp]
                      float* __restrict__ joint32,      // [slots, 64, h]
                      float* __restrict__ d_wy,         // [R, h], added
                      float* __restrict__ dbw_part,     // [R64, h], added
                      int R, int B, int U1, int h, int hp, int R64,
                      int hat) {
  __shared__ float gl_s[kRows], db_s[kRows];
  __shared__ float bw_s[kPointThreads / kPassCols][kPassCols];
  const int tile = blockIdx.x, r0 = tile * kRows;
  const int c = threadIdx.x % kPassCols, rg = threadIdx.x / kPassCols;
  const int hh = blockIdx.y * kPassCols + c;
  constexpr int kPer = kRows * kPassCols / kPointThreads;  // rows a thread
  const int base = groups[0];
  float wy_acc[kPer], bw_acc = 0.f;
#pragma unroll
  for (int i = 0; i < kPer; ++i) wy_acc[i] = 0.f;
  for (int pos = groups[tile]; pos < groups[tile + 1]; ++pos) {
    const int t = items[pos] / R64;
    const size_t slot = pos - base;
    if (threadIdx.x < kRows) {
      const int r = r0 + threadIdx.x;
      float gl = 0.f, db = 0.f;
      if (r < R) {
        const size_t at = static_cast<size_t>(t) * R + r;
        const head_grads::RowCotangent rc = head_grads::row_cotangent(
            g_b[at], g_l[at], z[at], blank[at], hat);
        gl = rc.gl;
        db = rc.d_blank;
      }
      gl_s[threadIdx.x] = gl;
      db_s[threadIdx.x] = db;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int row = rg + i * (kPointThreads / kPassCols), r = r0 + row;
      float jt = 0.f;
      if (r < R && hh < h) {
        jt = tanhf(pc[static_cast<size_t>(r) * h + hh] +
                   pf[(static_cast<size_t>(t) * B + r / U1) * h + hh]);
        wy_acc[i] = fmaf(gl_s[row], jt, wy_acc[i]);
        bw_acc = fmaf(db_s[row], jt, bw_acc);
        if (joint32 != nullptr) {
          joint32[(slot * kRows + row) * h + hh] = jt;
        }
      }
      joint[(slot * kRows + row) * hp + hh] = from_float<T>(jt);
    }
    __syncthreads();
  }
  bw_s[rg][c] = bw_acc;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int r = r0 + rg + i * (kPointThreads / kPassCols);
    if (r < R && hh < h) d_wy[static_cast<size_t>(r) * h + hh] += wy_acc[i];
  }
  __syncthreads();
  if (rg == 0 && hh < h) {
    float total = 0.f;
#pragma unroll
    for (int g = 0; g < kPointThreads / kPassCols; ++g) total += bw_s[g][c];
    dbw_part[static_cast<size_t>(tile) * h + hh] += total;
  }
}

// float32: the sums of du over a chunk's items (grid (R64, ceil(h / 32))):
// block (tile, 32 hidden units) walks the tile's items, adding du into d_pc
// (owned by this block) and, per item, summing du over each batch row's
// rows of the tile into dpf_part[slot, b - b_first(tile)]. A thread takes
// one hidden unit and 8 rows.
__global__ void __launch_bounds__(kPointThreads)
    du_sum_kernel(const float* __restrict__ du,      // [slots, 64, h]
                  const int* __restrict__ groups,    // the chunk's
                  float* __restrict__ d_pc,          // [R, h], added
                  float* __restrict__ dpf_part,      // [slots, J, h]
                  int R, int U1, int h, int J) {
  __shared__ float red[kPointThreads / kPassCols][kPassCols];
  constexpr int kGroups = kPointThreads / kPassCols;
  constexpr int kPer = kRows / kGroups;
  const int tile = blockIdx.x, r0 = tile * kRows;
  const int c = threadIdx.x % kPassCols, rg = threadIdx.x / kPassCols;
  const int hh = blockIdx.y * kPassCols + c;
  const int b_first = r0 / U1, b_last = (min(R, r0 + kRows) - 1) / U1;
  const int base = groups[0];
  float pc_acc[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) pc_acc[i] = 0.f;
  for (int pos = groups[tile]; pos < groups[tile + 1]; ++pos) {
    const size_t slot = pos - base;
    float v[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int row = rg + i * kGroups;
      v[i] = r0 + row < R && hh < h ? du[(slot * kRows + row) * h + hh] : 0.f;
      pc_acc[i] += v[i];
    }
    for (int bb = b_first; bb <= b_last; ++bb) {
      float total = 0.f;
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        total += (r0 + rg + i * kGroups) / U1 == bb ? v[i] : 0.f;
      }
      red[rg][c] = total;
      __syncthreads();
      if (rg == 0 && hh < h) {
        float sum = 0.f;
#pragma unroll
        for (int g = 0; g < kGroups; ++g) sum += red[g][c];
        dpf_part[(slot * J + bb - b_first) * h + hh] = sum;
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int r = r0 + rg + i * kGroups;
    if (r < R && hh < h) d_pc[static_cast<size_t>(r) * h + hh] += pc_acc[i];
  }
}

// d_pf[t, b] for the chunk's frames [t0, t0 + frames): the sum, over the
// row tiles k that hold batch row b, of dpf_part[slot(t, k), b - b_first(k)]
// (nothing where (t, k) is dead). Grid ceil(frames B h / 256).
__global__ void __launch_bounds__(kPointThreads)
    dpf_sum_kernel(const float* __restrict__ dpf_part,  // [slots, J, h]
                   const int* __restrict__ pos_of,
                   const int* __restrict__ groups,      // the chunk's
                   float* __restrict__ d_pf,            // [T, B, h]
                   int t0, int frames, int B, int U1, int h, int R64, int J) {
  const size_t i = static_cast<size_t>(blockIdx.x) * kPointThreads +
                   threadIdx.x;
  if (i >= static_cast<size_t>(frames) * B * h) return;
  const int hh = static_cast<int>(i % h);
  const int b = static_cast<int>(i / h % B);
  const int t = t0 + static_cast<int>(i / h / B);
  const int base = groups[0];
  float total = 0.f;
  for (int k = b * U1 / kRows; k <= (b * U1 + U1 - 1) / kRows; ++k) {
    const int pos = pos_of[t * R64 + k];
    if (pos >= 0) {
      total += dpf_part[(static_cast<size_t>(pos - base) * J + b -
                         k * kRows / U1) * h + hh];
    }
  }
  d_pf[(static_cast<size_t>(t) * B + b) * h + hh] = total;
}

// ---------------------------------------------------------------------------
// float32 products: register-blocked FMAs on the CUDA cores
// (simt_tiles.cuh: 64 x 256 block tiles, 8 x 8 entries a thread, 16-deep
// slices double-buffered). Every operand is a padded buffer (rows of 64, hp
// or Vp columns, zeros past R, h and V), so the loads take no masks along
// the depth.
namespace simt {

using simt_tiles::col;
using simt_tiles::ColsA;
using simt_tiles::ColsB;
using simt_tiles::column_sums;
using simt_tiles::kK;
using simt_tiles::kM;
using simt_tiles::kN;
using simt_tiles::kThreads;
using simt_tiles::product;
using simt_tiles::RowsA;
using simt_tiles::RowsB;
using simt_tiles::Smem;

struct Args {
  const float* vb;       // [V]
  const float* bw;       // [h]
  const float* wy;       // [R, h]
  const float* g_b;      // [T, R], and g_l, z, blank
  const float* g_l;
  const float* z;
  const float* blank;
  const float* wp;       // [hp, Vp], the padded head
  const float* joint;    // [slots, 64, hp]
  float* ds;             // [slots, 64, Vp]
  const int* items;
  const int* groups;     // the chunk's [R64 + 1]
  const int* count;      // the chunk's item count
  float* dvb_part;       // [P, V], added
  float* du;             // [slots, 64, h], written
  float* dw;             // [splits, h, V], added
  int R, h, hp, V, Vp, R64, hat;
};

// ds of each item (grid (P, ceil(Vp / 256)): block p walks the chunk's
// items p, p + P, ...): logits = joint . wp + vb, ds = coef e^(logits -
// ref) (0 past V and where coef is 0), and its column sums, added into
// dvb_part[p].
__global__ void __launch_bounds__(kThreads, 2) lex_grad_kernel(const Args p) {
  __shared__ Smem sm;
  __shared__ float vb[kN], sums[kN];
  const int n0 = blockIdx.y * kN, ty = threadIdx.x / 32;
  {
    const int y = n0 + threadIdx.x;
    vb[threadIdx.x] = y < p.V ? p.vb[y] : 0.f;
    sums[threadIdx.x] = 0.f;
  }
  __syncthreads();
  const int base = p.groups[0], count = *p.count;
  for (int slot = blockIdx.x; slot < count; slot += gridDim.x) {
    const int v = p.items[base + slot], t = v / p.R64, r0 = v % p.R64 * kM;
    float acc[8][8];
    product(acc, sm, p.hp / kK,
            RowsA{p.joint + static_cast<size_t>(slot) * kM * p.hp, p.hp},
            RowsB{p.wp, p.Vp, n0, p.Vp});
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = ty * 8 + i, r = r0 + row;
      head_grads::RowCotangent rc{0.f, 0.f, 0.f, 0.f};
      if (r < p.R) {
        const size_t at = static_cast<size_t>(t) * p.R + r;
        rc = head_grads::row_cotangent(p.g_b[at], p.g_l[at], p.z[at],
                                       p.blank[at], p.hat);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int y = n0 + col(j);
        acc[i][j] = y < p.V && rc.coef != 0.f
                        ? rc.coef * expf(acc[i][j] + vb[col(j)] - rc.ref)
                        : 0.f;
      }
      float* out = p.ds + (static_cast<size_t>(slot) * kM + row) * p.Vp + n0;
#pragma unroll
      for (int h4 = 0; h4 < 2; ++h4) {
        const int c = col(h4 * 4);
        if (n0 + c < p.Vp) {
          *reinterpret_cast<float4*>(out + c) =
              make_float4(acc[i][h4 * 4], acc[i][h4 * 4 + 1],
                          acc[i][h4 * 4 + 2], acc[i][h4 * 4 + 3]);
        }
      }
    }
    column_sums(acc, sm, [](int) { return true; },
                [&](int c, float total) { sums[c] += total; });
  }
  const int y = n0 + threadIdx.x;
  if (y < p.V) {
    p.dvb_part[static_cast<size_t>(blockIdx.x) * p.V + y] += sums[threadIdx.x];
  }
}

// dj = ds . wp^T + gl wy[r] + d_blank bw and du = dj (1 - joint^2) of each
// item on 256 hidden units (grid (blocks, ceil(hp / 256)): block p walks
// the chunk's items p, p + blocks, ...), stored into du[slot].
__global__ void __launch_bounds__(kThreads, 2) joint_grad_kernel(const Args p) {
  __shared__ Smem sm;
  __shared__ float gl_s[kM], db_s[kM];
  const int n0 = blockIdx.y * kN, ty = threadIdx.x / 32;
  const int base = p.groups[0], count = *p.count;
  for (int slot = blockIdx.x; slot < count; slot += gridDim.x) {
    const int v = p.items[base + slot], t = v / p.R64, r0 = v % p.R64 * kM;
    if (threadIdx.x < kM) {
      const int r = r0 + threadIdx.x;
      head_grads::RowCotangent rc{0.f, 0.f, 0.f, 0.f};
      if (r < p.R) {
        const size_t at = static_cast<size_t>(t) * p.R + r;
        rc = head_grads::row_cotangent(p.g_b[at], p.g_l[at], p.z[at],
                                       p.blank[at], p.hat);
      }
      gl_s[threadIdx.x] = rc.gl;
      db_s[threadIdx.x] = rc.d_blank;
    }
    float acc[8][8];
    product(acc, sm, p.Vp / kK,
            RowsA{p.ds + static_cast<size_t>(slot) * kM * p.Vp, p.Vp},
            ColsB{p.wp, p.Vp, n0, p.hp});
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = ty * 8 + i, r = r0 + row;
      if (r >= p.R) continue;
      const size_t at = (static_cast<size_t>(slot) * kM + row);
      const float* jrow = p.joint + at * p.hp;
      const float* wrow = p.wy + static_cast<size_t>(r) * p.h;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int hh = n0 + col(j);
        if (hh < p.h) {
          const float jt = jrow[hh];
          p.du[at * p.h + hh] =
              (acc[i][j] + gl_s[row] * wrow[hh] + db_s[row] * p.bw[hh]) *
              (1.f - jt * jt);
        }
      }
    }
    __syncthreads();  // gl_s and db_s are the next item's
  }
}

// d_W partial of a (64 hidden units, 256 labels) tile over the chunk's
// items of one split (grid (hp / 64, ceil(Vp / 256), splits)): joint^T ds
// over their rows, added into dw[split].
__global__ void __launch_bounds__(kThreads, 2) head_grad_kernel(const Args p) {
  __shared__ Smem sm;
  const int m0 = blockIdx.x * kM, n0 = blockIdx.y * kN, ty = threadIdx.x / 32;
  const int count = *p.count;
  const int begin = count * static_cast<int>(blockIdx.z) / gridDim.z;
  const int end = count * (static_cast<int>(blockIdx.z) + 1) / gridDim.z;
  if (begin == end) return;
  float acc[8][8];
  product(acc, sm, (end - begin) * (kM / kK),
          ColsA{p.joint + static_cast<size_t>(begin) * kM * p.hp, p.hp, m0},
          RowsB{p.ds + static_cast<size_t>(begin) * kM * p.Vp, p.Vp, n0,
                p.Vp});
  float* out = p.dw + static_cast<size_t>(blockIdx.z) * p.h * p.V;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int hh = m0 + ty * 8 + i;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int y = n0 + col(j);
      if (hh < p.h && y < p.V) {
        out[static_cast<size_t>(hh) * p.V + y] += acc[i][j];
      }
    }
  }
}

// The forward's logits of each item on 256 labels (grid (P, ceil(Vp /
// 256)): block p walks the chunk's items p, p + P, ...): joint . wp + vb in
// exact float32, reduced per row over the 256 labels to one online (max,
// sum) pair (a warp holds 8 whole rows: a shuffle over its lanes), written
// to part_m / part_l [strips, frames R] at f R + r.
__global__ void __launch_bounds__(kThreads, 2)
    row_lse_kernel(const float* __restrict__ joint,  // [slots, 64, hp]
                   const float* __restrict__ wp,     // [hp, Vp]
                   const float* __restrict__ vb_in,  // [V]
                   float* __restrict__ part_m, float* __restrict__ part_l,
                   int count, int R, int R64, int hp, int V, int Vp) {
  __shared__ Smem sm;
  __shared__ float vb[kN];  // -inf past V
  const int n0 = blockIdx.y * kN, ty = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  vb[threadIdx.x] = n0 + threadIdx.x < V ? vb_in[n0 + threadIdx.x]
                                         : -INFINITY;
  const size_t n = static_cast<size_t>(count / R64) * R;
  float* out_m = part_m + blockIdx.y * n;
  float* out_l = part_l + blockIdx.y * n;
  for (int slot = blockIdx.x; slot < count; slot += gridDim.x) {
    const int f = slot / R64, r0 = slot % R64 * kM;
    float acc[8][8];
    // product() synchronises the block before it reads shared memory, so
    // vb is in place.
    product(acc, sm, hp / kK,
            RowsA{joint + static_cast<size_t>(slot) * kM * hp, hp},
            RowsB{wp, Vp, n0, Vp});
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float m = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        acc[i][j] += vb[col(j)];
        m = fmaxf(m, acc[i][j]);
      }
      for (int o = 16; o > 0; o >>= 1) {
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      }
      const float c = safe_shift(m);
      float l = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) l += expf(acc[i][j] - c);
      for (int o = 16; o > 0; o >>= 1) {
        l += __shfl_xor_sync(0xffffffffu, l, o);
      }
      const int r = r0 + ty * 8 + i;
      if (lane == 0 && r < R) {
        out_m[static_cast<size_t>(f) * R + r] = m;
        out_l[static_cast<size_t>(f) * R + r] = l;
      }
    }
  }
}

}  // namespace simt

// ---------------------------------------------------------------------------
// bfloat16 products on wgmma (wgmma_tiles.cuh, head_grads.cuh).
namespace hopper {

using namespace head_grads;
using wgmma_tiles::kBK;
using wgmma_tiles::kBN;
using wgmma_tiles::kConsumers;
using wgmma_tiles::kRows;
using wgmma_tiles::kThreads;

struct LexGrad {
  const float* vb;     // [V]
  const float* g_b;    // [T, R], and g_l, z, blank
  const float* g_l;
  const float* z;
  const float* blank;
  const int* items;
  const int* groups;   // the chunk's [R64 + 1]
  const int* count;    // the chunk's item count
  bf16* ds;            // [slots, 64, Vp]
  float* dvb_part;     // [P, V], added
  int R, R64, hp, V, Vp, hat;
};

// Epilogue scratch: the strip's vb and per consumer warp a row of kBN
// column sums.
constexpr int kLexGradExtra = 5 * kBN * 4;

// ds of each item on a 128-label strip (grid (P, ceil(Vp / 128)): block p
// walks the chunk's items p, p + P, ...): logits on wgmma (A = joint,
// K-major; B = the head, MN-major) plus vb, ds = coef e^(logits - ref) in
// bfloat16 (0 past V and where coef is 0), its float32 column sums added
// into dvb_part[p].
__global__ void __launch_bounds__(kThreads, 2)
    lex_grad_kernel(const __grid_constant__ Maps maps, const LexGrad p) {
  extern __shared__ uint8_t raw[];
  const Ring<4> ring(raw);
  const int n0 = blockIdx.y * kBN, blocks = gridDim.x;
  const int count = *p.count, base = p.groups[0];
  const int first = blockIdx.x;
  const int units = count > first ? (count - first + blocks - 1) / blocks : 0;
  const int kts = p.hp / kBK;
  if (ring.producer()) {
    produce(ring, units * kts, [&](int q, uint8_t* a, uint8_t* b,
                                   uint64_t* bar) {
      const int slot = first + q / kts * blocks, k0 = q % kts * kBK;
      tma_load(a, maps.joint, k0, 0, slot, bar);
      tma_load(b, maps.vw, n0, k0, bar);
      tma_load(b + kBox, maps.vw, n0 + 64, k0, bar);
    });
    return;
  }
  float* vb = reinterpret_cast<float*>(ring.extra);  // [kBN]
  float* red = vb + kBN;                             // [warps][kBN]
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  vb[t] = n0 + t < p.V ? p.vb[n0 + t] : 0.f;
#pragma unroll
  for (int w = 0; w < 4; ++w) red[w * kBN + t] = 0.f;
  named_barrier(1, kConsumers);
  float d[64];
  consume<false, true>(ring, units, kts, d, [&](int unit, float(&acc)[64]) {
    const int slot = first + unit * blocks;
    const int v = p.items[base + slot], tt = v / p.R64;
    const int r0 = v % p.R64 * kRows;
    RowCotangent rc[2];
    int row[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      row[half] = acc_row(half * 2);
      const int r = r0 + row[half];
      rc[half] = RowCotangent{0.f, 0.f, 0.f, 0.f};
      if (r < p.R) {
        const size_t at = static_cast<size_t>(tt) * p.R + r;
        rc[half] = row_cotangent(p.g_b[at], p.g_l[at], p.z[at], p.blank[at],
                                 p.hat);
      }
    }
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int c0 = j * 8 + (lane % 4) * 2;
      float dv[2][2], cs[2] = {0.f, 0.f};
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool in = n0 + c0 + e < p.V;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float x =
              in && rc[half].coef != 0.f
                  ? rc[half].coef * expf(acc[j * 4 + half * 2 + e] +
                                         vb[c0 + e] - rc[half].ref)
                  : 0.f;
          dv[half][e] = x;
          cs[e] += x;
        }
      }
      if (n0 + c0 < p.Vp) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          *reinterpret_cast<__nv_bfloat162*>(
              p.ds + (static_cast<size_t>(slot) * kRows + row[half]) * p.Vp +
              n0 + c0) = __floats2bfloat162_rn(dv[half][0], dv[half][1]);
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
#pragma unroll
        for (int e = 0; e < 2; ++e) red[warp * kBN + c0 + e] += cs[e];
      }
    }
  });
  named_barrier(1, kConsumers);
  if (n0 + t < p.V) {
    float total = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) total += red[w * kBN + t];
    p.dvb_part[static_cast<size_t>(blockIdx.x) * p.V + n0 + t] += total;
  }
}

cudaError_t launch_lex_grad(const Maps& maps, const LexGrad& p, int blocks,
                            cudaStream_t stream) {
  constexpr int kSmem = smem_bytes(4, kLexGradExtra);
  const cudaError_t err = allow_smem<lex_grad_kernel>(kSmem);
  if (err != cudaSuccess) return err;
  lex_grad_kernel<<<dim3(blocks, cdiv(p.Vp, kBN)), kThreads, kSmem,
                    stream>>>(maps, p);
  return cudaGetLastError();
}

struct RowLse {
  const float* vb;  // [V]
  float* part_m;    // [strips, frames R]
  float* part_l;
  int count;        // the chunk's items, frames R64
  int R, R64, hp, V;
};

// Epilogue scratch: the strip's vb (-inf past V).
constexpr int kRowLseExtra = kBN * 4;

// The forward's logits of each item on a 128-label strip (grid (P,
// ceil(Vp / 128)): block p walks the chunk's items p, p + P, ...): on
// wgmma (A = joint, K-major; B = the head, MN-major), plus vb, reduced per
// row over the strip to one online (max, sum) pair, in registers and over
// the 4 lanes that share the row, written to part_m / part_l [strips,
// frames R] at f R + r.
__global__ void __launch_bounds__(kThreads, 2)
    row_lse_kernel(const __grid_constant__ Maps maps, const RowLse p) {
  extern __shared__ uint8_t raw[];
  const Ring<4> ring(raw);
  const int n0 = blockIdx.y * kBN, blocks = gridDim.x;
  const int first = blockIdx.x;
  const int units =
      p.count > first ? (p.count - first + blocks - 1) / blocks : 0;
  const int kts = p.hp / kBK;
  if (ring.producer()) {
    produce(ring, units * kts, [&](int q, uint8_t* a, uint8_t* b,
                                   uint64_t* bar) {
      const int slot = first + q / kts * blocks, k0 = q % kts * kBK;
      tma_load(a, maps.joint, k0, 0, slot, bar);
      tma_load(b, maps.vw, n0, k0, bar);
      tma_load(b + kBox, maps.vw, n0 + 64, k0, bar);
    });
    return;
  }
  float* vb = reinterpret_cast<float*>(ring.extra);  // [kBN]
  const int t = threadIdx.x, lane = t % 32;
  vb[t] = n0 + t < p.V ? p.vb[n0 + t] : -INFINITY;
  named_barrier(1, kConsumers);
  const size_t n = static_cast<size_t>(p.count / p.R64) * p.R;
  float* out_m = p.part_m + blockIdx.y * n;
  float* out_l = p.part_l + blockIdx.y * n;
  float d[64];
  consume<false, true>(ring, units, kts, d, [&](int unit, float(&acc)[64]) {
    const int slot = first + unit * blocks;
    const int f = slot / p.R64, r0 = slot % p.R64 * kRows;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float bias = vb[j * 8 + (lane % 4) * 2 + e];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float& x = acc[j * 4 + half * 2 + e];
          x += bias;
          m[half] = fmaxf(m[half], x);
        }
      }
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      for (int o = 1; o < 4; o <<= 1) {
        m[half] = fmaxf(m[half], __shfl_xor_sync(0xffffffffu, m[half], o));
      }
    }
    const float c[2] = {safe_shift(m[0]), safe_shift(m[1])};
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          l[half] += expf(acc[j * 4 + half * 2 + e] - c[half]);
        }
      }
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      for (int o = 1; o < 4; o <<= 1) {
        l[half] += __shfl_xor_sync(0xffffffffu, l[half], o);
      }
      const int r = r0 + acc_row(half * 2);
      if (lane % 4 == 0 && r < p.R) {
        out_m[static_cast<size_t>(f) * p.R + r] = m[half];
        out_l[static_cast<size_t>(f) * p.R + r] = l[half];
      }
    }
  });
}

cudaError_t launch_row_lse(const Maps& maps, const RowLse& p, int blocks,
                           int Vp, cudaStream_t stream) {
  constexpr int kSmem = smem_bytes(4, kRowLseExtra);
  const cudaError_t err = allow_smem<row_lse_kernel>(kSmem);
  if (err != cudaSuccess) return err;
  row_lse_kernel<<<dim3(blocks, cdiv(Vp, kBN)), kThreads, kSmem, stream>>>(
      maps, p);
  return cudaGetLastError();
}

}  // namespace hopper

// The forward (the file's top comment). Every (frame, 64-row tile) item is
// live: the forward has no lengths, and every (t, r) output is defined. Per
// chunk of Tc frames: the joint pass (the joint of the chunk's items in the
// compute type, blank and ly in float32), the head product with the row
// (max, sum) over each label strip in its epilogue (bfloat16 on wgmma,
// float32 on the FMA tiles; `blocks` persistent blocks per strip), and the
// merge of the strips into z, nb and nl.
template <typename T>
int run_forward(const float* pc, const float* pf, const float* W,
                const float* vb, const float* bw, const float* bb,
                const float* wy, const float* by, T* wp, T* joint,
                float* part_m, float* part_l, float* nb, float* nl,
                float* z, float* blank, int num_frames, int B, int U1,
                int h, int V, int hat, int Tc, int blocks,
                cudaStream_t stream) {
  constexpr bool kBf16 = sizeof(T) == 2;
  const int R = B * U1;
  if (num_frames == 0 || R == 0) return 0;
  if (h == 0 || V == 0 || Tc < 1 || blocks < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int R64 = (R + kRows - 1) / kRows;
  const int hp = round_up(h, 64), Vp = round_up(V, 64);
  const int strips = kBf16 ? (Vp + wgmma_tiles::kBN - 1) / wgmma_tiles::kBN
                           : (Vp + simt::kN - 1) / simt::kN;
  pad_head_kernel<T><<<blocks_for(static_cast<size_t>(hp) * Vp),
                       kPointThreads, 0, stream>>>(W, wp, h, V, hp, Vp);
  RETURN_IF_LAUNCH_FAILED();
  wgmma_tiles::Maps maps{};
  if constexpr (kBf16) {  // the product reads the joint and the head
    const cuuint64_t joint_dims[3] = {static_cast<cuuint64_t>(hp), kRows,
                                      static_cast<cuuint64_t>(Tc) * R64};
    const cuuint64_t vw_dims[2] = {static_cast<cuuint64_t>(Vp),
                                   static_cast<cuuint64_t>(hp)};
    RETURN_IF_FAILED(wgmma_tiles::box_map(&maps.joint, joint, 3, joint_dims));
    RETURN_IF_FAILED(wgmma_tiles::box_map(&maps.vw, wp, 2, vw_dims));
  }
  for (int t0 = 0; t0 < num_frames; t0 += Tc) {
    const int frames = min(Tc, num_frames - t0), count = frames * R64;
    forward_joint_kernel<T><<<count, kPointThreads, 0, stream>>>(
        pc, pf, bw, bb, wy, by, joint, blank, nl, t0, R, B, U1, h, hp, R64);
    RETURN_IF_LAUNCH_FAILED();
    if constexpr (kBf16) {
      RETURN_IF_FAILED(hopper::launch_row_lse(
          maps, hopper::RowLse{vb, part_m, part_l, count, R, R64, hp, V},
          blocks, Vp, stream));
    } else {
      simt::row_lse_kernel<<<dim3(blocks, strips), simt::kThreads, 0,
                             stream>>>(joint, wp, vb, part_m, part_l, count,
                                       R, R64, hp, V, Vp);
      RETURN_IF_LAUNCH_FAILED();
    }
    const size_t n = static_cast<size_t>(frames) * R;
    const size_t at = static_cast<size_t>(t0) * R;
    forward_merge_kernel<<<blocks_for(n), kPointThreads, 0, stream>>>(
        part_m, part_l, strips, blank + at, nb + at, nl + at, z + at, n, hat);
    RETURN_IF_LAUNCH_FAILED();
  }
  return 0;
}

// Pointers into the caller's workspace (numerator_backward's scratch).
struct Scratch {
  int* pos_of;       // [T, R64]
  int* items;        // [T R64]
  int* groups;       // [chunks R64 + 1]
  int* count;        // [chunks]
  void* wp;          // [hp, Vp], compute type
  void* joint;       // [cap, 64, hp], compute type
  float* joint32;    // [cap, 64, h] (bfloat16 only)
  void* ds;          // [cap, 64, Vp], compute type
  float* du;         // [cap, 64, h] (float32 only)
  float* dpf_part;   // [cap, J, h]
  float* dvb_part;   // [blocks, V]
  float* dbw_part;   // [R64, h]
  float* dpc_part;   // [jgrid (bfloat16) or 1 (float32), R, h]
  float* dw_part;    // [ksplits, h, V]
  float* db_row;     // [R]
};

struct Grads {
  float *d_pf, *d_pc, *d_wy, *d_w, *d_vb, *d_bw, *d_by, *d_bb;
};

// The backward (the file's top comment). Tc frames a chunk; `blocks` the
// ds product's persistent blocks per label strip; `jgrid` the d_joint
// product's splits of a row tile's items (bfloat16) or its persistent
// blocks per hidden strip (float32); ksplits the d_W product's splits; J
// the most batch rows a row tile holds.
template <typename T>
int run_backward(const float* pc, const float* pf, const float* W,
                 const float* vb, const float* bw, const float* wy,
                 const float* z, const float* blank, const float* g_b,
                 const float* g_l, const Scratch& w, const Grads& g,
                 int num_frames, int B, int U1, int h, int V, int hat, int Tc,
                 int blocks, int jgrid, int ksplits, int J,
                 cudaStream_t stream) {
  constexpr bool kBf16 = sizeof(T) == 2;
  const int R = B * U1;
  if (h == 0 || V == 0) return static_cast<int>(cudaErrorInvalidValue);
  if (num_frames == 0 || R == 0) {
    const struct {
      float* out;
      size_t n;
    } outs[] = {{g.d_pf, static_cast<size_t>(num_frames) * B * h},
                {g.d_pc, static_cast<size_t>(R) * h},
                {g.d_wy, static_cast<size_t>(R) * h},
                {g.d_w, static_cast<size_t>(h) * V},
                {g.d_vb, static_cast<size_t>(V)},
                {g.d_bw, static_cast<size_t>(h)},
                {g.d_by, static_cast<size_t>(R)},
                {g.d_bb, 1}};
    for (const auto& out : outs) {
      RETURN_IF_FAILED(cudaMemsetAsync(out.out, 0, out.n * sizeof(float),
                                       stream));
    }
    return 0;
  }
  if (Tc < 1 || blocks < 1 || jgrid < 1 || ksplits < 1 || J < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int R64 = (R + kRows - 1) / kRows;
  const int hp = round_up(h, 64), Vp = round_up(V, 64);
  const int chunks = (num_frames + Tc - 1) / Tc;
  const struct {
    float* out;
    size_t n;
  } zeros[] = {{g.d_wy, static_cast<size_t>(R) * h},
               {w.dpc_part, static_cast<size_t>(kBf16 ? jgrid : 1) * R * h},
               {w.dvb_part, static_cast<size_t>(blocks) * V},
               {w.dbw_part, static_cast<size_t>(R64) * h},
               {w.dw_part, static_cast<size_t>(ksplits) * h * V}};
  for (const auto& out : zeros) {
    RETURN_IF_FAILED(
        cudaMemsetAsync(out.out, 0, out.n * sizeof(float), stream));
  }
  const size_t pairs = static_cast<size_t>(num_frames) * R64;
  mark_kernel<<<blocks_for(pairs * 32), kPointThreads, 0, stream>>>(
      g_b, g_l, w.pos_of, num_frames, R, R64);
  RETURN_IF_LAUNCH_FAILED();
  list_kernel<<<1, kListThreads, 0, stream>>>(w.pos_of, w.items, w.groups,
                                             w.count, num_frames, R64, Tc);
  RETURN_IF_LAUNCH_FAILED();
  T* wp = static_cast<T*>(w.wp);
  T* joint = static_cast<T*>(w.joint);
  T* ds = static_cast<T*>(w.ds);
  pad_head_kernel<T><<<blocks_for(static_cast<size_t>(hp) * Vp),
                       kPointThreads, 0, stream>>>(W, wp, h, V, hp, Vp);
  RETURN_IF_LAUNCH_FAILED();
  wgmma_tiles::Maps maps;
  if constexpr (kBf16) {
    const int cap = Tc * R64;
    RETURN_IF_FAILED(wgmma_tiles::make_maps(&maps, joint, ds, wp, cap, kRows,
                                            kRows, hp, Vp));
  }
  for (int c = 0; c < chunks; ++c) {
    const int t0 = c * Tc, frames = min(Tc, num_frames - t0);
    const int* groups = w.groups + c * R64;
    const int* count = w.count + c;
    joint_pass_kernel<T><<<dim3(R64, hp / kPassCols), kPointThreads, 0,
                           stream>>>(
        pc, pf, g_b, g_l, z, blank, w.items, groups, joint,
        kBf16 ? w.joint32 : nullptr, g.d_wy, w.dbw_part, R, B, U1, h, hp,
        R64, hat);
    RETURN_IF_LAUNCH_FAILED();
    if constexpr (kBf16) {
      using namespace head_grads;
      RETURN_IF_FAILED(hopper::launch_lex_grad(
          maps,
          hopper::LexGrad{vb, g_b, g_l, z, blank, w.items, groups, count, ds,
                          w.dvb_part, R, R64, hp, V, Vp, hat},
          blocks, stream));
      RETURN_IF_FAILED(launch_num_joint_grad(
          maps,
          NumJointGrad{bw, wy, g_b, g_l, z, blank, w.joint32, w.items, groups,
                       w.dpf_part, w.dpc_part, R, U1, h, R64, J, Vp, hat},
          hp, jgrid, stream));
      RETURN_IF_FAILED(launch_head_grad(
          maps, HeadGrad{nullptr, w.dw_part, 0, kRows, h, V, 1, 0, count},
          hp, Vp, ksplits, stream));
    } else {
      const simt::Args a{vb,    bw,    wy,         g_b,  g_l,       z,
                         blank, wp,    joint,      ds,   w.items,   groups,
                         count, w.dvb_part, w.du, w.dw_part, R,    h,
                         hp,    V,     Vp,         R64,  hat};
      simt::lex_grad_kernel<<<dim3(blocks, (Vp + simt::kN - 1) / simt::kN),
                              simt::kThreads, 0, stream>>>(a);
      RETURN_IF_LAUNCH_FAILED();
      simt::joint_grad_kernel<<<dim3(jgrid, (hp + simt::kN - 1) / simt::kN),
                                simt::kThreads, 0, stream>>>(a);
      RETURN_IF_LAUNCH_FAILED();
      du_sum_kernel<<<dim3(R64, (h + kPassCols - 1) / kPassCols),
                      kPointThreads, 0, stream>>>(w.du, groups, w.dpc_part,
                                                  w.dpf_part, R, U1, h, J);
      RETURN_IF_LAUNCH_FAILED();
      simt::head_grad_kernel<<<dim3(hp / simt::kM,
                                    (Vp + simt::kN - 1) / simt::kN, ksplits),
                               simt::kThreads, 0, stream>>>(a);
      RETURN_IF_LAUNCH_FAILED();
    }
    dpf_sum_kernel<<<blocks_for(static_cast<size_t>(frames) * B * h),
                     kPointThreads, 0, stream>>>(w.dpf_part, w.pos_of, groups,
                                                 g.d_pf, t0, frames, B, U1, h,
                                                 R64, J);
    RETURN_IF_LAUNCH_FAILED();
  }
  bias_grad_kernel<<<blocks_for(R), kPointThreads, 0, stream>>>(
      g_b, g_l, z, blank, num_frames, R, hat, g.d_by, w.db_row);
  RETURN_IF_LAUNCH_FAILED();
  head_grads::Sums sums{};
  const auto add = [&](const float* in, int rows, int n, float* out) {
    sums.job[sums.count++] = {in, rows, n, out};
  };
  add(w.dpc_part, kBf16 ? jgrid : 1, R * h, g.d_pc);
  add(w.dw_part, ksplits, h * V, g.d_w);
  add(w.dvb_part, blocks, V, g.d_vb);
  add(w.dbw_part, R64, h, g.d_bw);
  add(w.db_row, R, 1, g.d_bb);
  RETURN_IF_FAILED(head_grads::launch_sums(sums, stream));
  return 0;
}
}  // namespace

extern "C" {

// The forward on `stream`; returns the first error (0 on success). The
// caller allocates everything: outputs nb, nl, z, blank [T, R]; scratch (R64
// = ceil(R / 64), hp / Vp: h / V rounded up to 64) wp [hp, Vp] and joint
// [chunk R64, 64, hp] in the compute type (dtype 0 float32, 1 bfloat16),
// part_m / part_l [strips, chunk R] float32 (strips: ceil(Vp / 128) in
// bfloat16, ceil(Vp / 256) in float32); every other pointer is float32 (W
// [h, V], rounded to the compute type here); R = B * U1. chunk: frames a
// chunk; blocks: the head product's persistent blocks per label strip.
int numerator_forward(int dtype, const float* pc, const float* pf,
                      const float* W, const float* vb, const float* bw,
                      const float* bb, const float* wy, const float* by,
                      float* part_m, float* part_l, float* nb, float* nl,
                      float* z, float* blank, int num_frames, int B, int U1,
                      int h, int V, int hat, int chunk, int blocks, void* wp,
                      void* joint, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return run_forward<float>(pc, pf, W, vb, bw, bb, wy, by,
                              static_cast<float*>(wp),
                              static_cast<float*>(joint), part_m, part_l, nb,
                              nl, z, blank, num_frames, B, U1, h, V, hat,
                              chunk, blocks, s);
  }
  if (dtype == 1) {
    return run_forward<__nv_bfloat16>(
        pc, pf, W, vb, bw, bb, wy, by, static_cast<__nv_bfloat16*>(wp),
        static_cast<__nv_bfloat16*>(joint), part_m, part_l, nb, nl, z, blank,
        num_frames, B, U1, h, V, hat, chunk, blocks, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The backward on `stream`; returns the first error. Every pointer is
// float32 but the scratch's ints and compute-type buffers: pc [R, h], pf
// [T, B, h], W [h, V], vb [V], bw [h], wy [R, h]; z, blank, g_b, g_l [T,
// R]. Scratch (R64 = ceil(R / 64), hp / Vp: h / V rounded up to 64, cap =
// chunk R64 item slots; int32: pos_of [T R64], items [T R64], groups
// [ceil(T / chunk) R64 + 1], count [ceil(T / chunk)]; the compute type
// (dtype 0 float32, 1 bfloat16): wp [hp, Vp], joint [cap, 64, hp], ds
// [cap, 64, Vp]; float32: joint32 [cap, 64, h] (bfloat16 only), du [cap,
// 64, h] (float32 only), dpf_part [cap, J, h], dvb_part [blocks, V],
// dbw_part [R64, h], dpc_part [bfloat16 jgrid, float32 1, R, h], dw_part
// [ksplits, h, V], db_row [R]). Outputs d_pf [T, B, h], d_pc / d_wy [R,
// h], d_w [h, V], d_vb [V], d_bw [h], d_by [R], d_bb [1]. chunk: frames a
// chunk; blocks: the ds product's blocks per label strip; jgrid: the
// d_joint product's splits of a row tile's items (bfloat16) or its blocks
// per hidden strip (float32); J: the most batch rows a 64-row tile holds.
int numerator_backward(int dtype, const float* pc, const float* pf,
                       const float* W, const float* vb, const float* bw,
                       const float* wy, const float* z, const float* blank,
                       const float* g_b, const float* g_l, int* pos_of,
                       int* items, int* groups, int* count, void* wp,
                       void* joint, float* joint32, void* ds, float* du,
                       float* dpf_part, float* dvb_part, float* dbw_part,
                       float* dpc_part, float* dw_part, float* db_row,
                       float* d_pf, float* d_pc, float* d_wy, float* d_w,
                       float* d_vb, float* d_bw, float* d_by, float* d_bb,
                       int num_frames, int B, int U1, int h, int V, int hat,
                       int chunk, int blocks, int jgrid, int ksplits,
                       int J, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Scratch w{pos_of,   items,    groups,   count,    wp,
                  joint,    joint32,  ds,       du,       dpf_part,
                  dvb_part, dbw_part, dpc_part, dw_part,  db_row};
  const Grads g{d_pf, d_pc, d_wy, d_w, d_vb, d_bw, d_by, d_bb};
  if (dtype == 0) {
    return run_backward<float>(pc, pf, W, vb, bw, wy, z, blank, g_b, g_l, w,
                               g, num_frames, B, U1, h, V, hat, chunk, blocks,
                               jgrid, ksplits, J, s);
  }
  if (dtype == 1) {
    return run_backward<__nv_bfloat16>(pc, pf, W, vb, bw, wy, z, blank, g_b,
                                       g_l, w, g, num_frames, B, U1, h, V,
                                       hat, chunk, blocks, jgrid, ksplits,
                                       J, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The backward's live list alone (mark_kernel, list_kernel) on `stream`:
// pos_of [T, ceil(R / 64)], items [T ceil(R / 64)], groups [ceil(T /
// chunk) ceil(R / 64) + 1], count [ceil(T / chunk)], int32, from g_b, g_l
// [T, R] float32.
int numerator_live_tiles(const float* g_b, const float* g_l, int* pos_of,
                         int* items, int* groups, int* count, int T, int R,
                         int chunk, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (T == 0 || R == 0) return 0;
  if (chunk < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int R64 = (R + kRows - 1) / kRows;
  mark_kernel<<<blocks_for(static_cast<size_t>(T) * R64 * 32), kPointThreads,
                0, s>>>(g_b, g_l, pos_of, T, R, R64);
  RETURN_IF_LAUNCH_FAILED();
  list_kernel<<<1, kListThreads, 0, s>>>(pos_of, items, groups, count, T,
                                        R64, chunk);
  RETURN_IF_LAUNCH_FAILED();
  return 0;
}

const char* numerator_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
