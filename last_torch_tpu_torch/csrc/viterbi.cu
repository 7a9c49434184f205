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

// Tropical (Viterbi) forward of the GNAT recognition lattice on Hopper.
//
// Replaces the Pallas TPU kernel
// last_torch_tpu/ops/viterbi.py::_viterbi_forward_kernel (pallas_call at
// viterbi.py:282), with normalize 'none', 'hat' or 'log_softmax'. For
// every frame t and batch row b:
//
//   joint[s]   = compute_dtype(tanh(pc[s] + pf[t, b]))          (f32 tanh)
//   lex[s, y]  = joint[s] . vocab_w[:, y] + vocab_b[y]          (f32 sum)
//   blank[s]   = joint[s] . blank_w + blank_b                   (f32 sum)
//   c[s]       = 0 (none); lse_y lex[s, :] + softplus(blank[s]) (hat), and
//                blank[s] becomes -softplus(-blank[s]); logaddexp(blank[s],
//                lse_y lex[s, :]) (log_softmax), and blank[s] -= c[s]
//   red[y], arg[y] = max / argmax_s ((vec[s] - c[s]) + lex[s, y])
//                                                   (lowest s wins ties)
//   expand(red) = [-inf, red[0], ..., red[V-1]]                 (S = V + 1)
//
// with vec = alpha for the first max-pass of a frame and vec = expand(red)
// of the previous pass for the k - 1 further passes of FrameLabelDependent
// (k), then the FrameDependent / FrameLabelDependent update with its
// winning expansion count jstar and the padding hold (padded frames keep
// alpha and write jstar = 0).
//
// What bounds it here. Per frame and pass the head is a [B*S, h] x [h, V]
// product: 2*B*S*V*h = 413 GFLOP at B=384, S=1025, V=1024, h=512, against
// 403 MB of bf16 joint and 1 MB of vocab_w; what the products' epilogues
// store, the float32 lex a later pass reads, is 1.61 GB a frame, and what
// they pull from the L2 cache depends on the order in which they walk their
// tiles (head_product.cuh). The state that must cross frames (alpha, [B, S]
// f32) is tiny.
//
// What the design does about it:
// * The TPU grid carried alpha across (t, b) grid steps in VMEM scratch.
//   Hopper blocks run in no order and carry nothing, so the time loop runs
//   on the host side of this file, a few launches per frame on the
//   caller's stream.
// * bfloat16 (namespace hopper) runs on head_product.cuh, the machinery of
//   the lattice forwards: once per call the padded bfloat16 head vw16; per
//   frame, over its live rows only (counted once per call on the host,
//   listed first on the device; padding rows launch nothing), the joint
//   pass writes the bfloat16 joint [B, S, hp] and the blank (bfloat16
//   joint . bfloat16 blank_w + blank_b, summed in float32), then the first
//   max-pass is the unit product (wgmma on TMA operands, two consumer
//   warpgroups, a persistent grid) with a (max, argmax) epilogue per
//   64-state unit and label (column_max_kernel), merged by merge_kernel.
//   With two or more passes a frame (FLD(k >= 2)) that product also stores
//   lex ([B, S, V] float32: 1.61 GB at B=384, S=1025, V=1024, so the later
//   passes find none of it in the 50 MB L2) and the later passes read it
//   back (max_pass_kernel<kLoad>, one partial per 64-state tile of a live
//   row; streaming 16-byte loads, at 90% of the device's bandwidth), as
//   the 'cache' log-partition forward does. Keeping a row's lex in L2
//   instead (a cluster of CTAs a row, its later passes from their slots)
//   measured slower on an H100 (PERF.md).
// * The products walk their tiles strip-stationary where the head strip
//   fits in shared memory (hp <= 576): one block an SM owns a 128-label
//   strip of vw16 for the frame's launch, loaded once, and streams only the
//   joint of the unit pairs, which the blocks of every strip take in one
//   order at one pace, so each pair's joint is read from device memory once
//   and from the L2 cache for the other strips; the block's two warpgroups
//   alternate on the tensor cores. Deeper heads keep the pair walk (two
//   blocks an SM, each tile streaming its strip). Each tile sums the same 8
//   depth stages in the same order on either walk: the outputs are the
//   same bits.
// * Local normalization. The TPU normalized each row inside its tile, since
//   its vocab axis was not tiled; a block here owns a 128-label strip and
//   never sees a whole row. Normalization subtracts one constant c[s] from
//   every lexical score of state s, so the max-passes can run unchanged on
//   vec - c once c is known. A normalized frame therefore starts with the
//   unit product whose epilogue stores lex and reduces each row over its
//   strip to one (max, sum) pair (row_reduce_kernel, partials [strips, B,
//   S]); norm_merge_kernel forms c and the normalized blank; then every
//   max-pass reads the staged lex (kLoad). (vec - c) + lex rounds
//   differently from vec + (lex - c), as the TPU summed: argmaxes may
//   differ only on ties.
// * Ties: every merge (within a thread, across lanes and warps, across
//   units and in merge_kernel) keeps the larger value, then the lower
//   state (beats, head_product::pick), so the lowest state wins whatever
//   the order of the merges. An all-NaN column reports state 0.
// * float32, kept for exact comparison with the plain version: FMAs on the
//   CUDA cores in 64 x 64 tiles (tile_product.cuh, shared with
//   fused_scan.cu), a block per 64-label strip of a batch row and split of
//   the states, its running (max, argmax) per column in registers, the
//   splits merged by merge_kernel; lex staged as above.
// * No padding of V to 128 lanes or of S to a tile: the ragged edges are
//   masked in the loads and in the reduction. Padding frames skip all work
//   but the alpha hold (their arg rows are written 0).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

#include "head_product.cuh"
#include "tile_product.cuh"

namespace {

using namespace lattice_tiles;

constexpr int kJointThreads = 128;
constexpr int kUpdateThreads = 256;

enum LexMode { kCompute = 0, kComputeStore = 1, kLoad = 2 };

// The (value, state) order of the reduction: larger value first, then the
// lower state index. Matches jnp.argmax within a tile plus the strict '>'
// across tiles of the TPU kernel (viterbi.py:155-157).
__device__ __forceinline__ bool beats(float v, int s, float best_v,
                                      int best_s) {
  return v > best_v || (v == best_v && s < best_s);
}

// joint[b, s, :] = tanh(pc[s] + pf_t[b]); blank[b, s] = joint . bw + bb
// (float32). Grid (S, B), kJointThreads threads.
__global__ void __launch_bounds__(kJointThreads)
    joint_blank_kernel(const float* __restrict__ pf_t,  // [B, h]
                       const int* __restrict__ is_pad_t,  // [B]
                       const float* __restrict__ pc,    // [S, h]
                       const float* __restrict__ bw,    // [h]
                       const float* __restrict__ bb,    // [1]
                       float* __restrict__ joint,       // [B, S, h]
                       float* __restrict__ blank,       // [B, S]
                       int S, int h) {
  const int s = blockIdx.x;
  const int b = blockIdx.y;
  if (is_pad_t[b]) return;  // a padding frame's joint and blank are unused
  const float* pc_row = pc + static_cast<size_t>(s) * h;
  const float* pf_row = pf_t + static_cast<size_t>(b) * h;
  float* out = joint + (static_cast<size_t>(b) * S + s) * h;
  float partial = 0.f;
  for (int k = threadIdx.x; k < h; k += kJointThreads) {
    const float j = tanhf(pc_row[k] + pf_row[k]);
    out[k] = j;
    partial = fmaf(j, bw[k], partial);
  }
  __shared__ float warp_sums[kJointThreads / 32];
  for (int o = 16; o > 0; o >>= 1) {
    partial += __shfl_down_sync(0xffffffffu, partial, o);
  }
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = partial;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.f;
    for (int w = 0; w < kJointThreads / 32; ++w) total += warp_sums[w];
    blank[static_cast<size_t>(b) * S + s] = total + bb[0];
  }
}

// One max-pass over one split of the states for a 64-label strip of batch
// row b: the split's (max, argmax) over s of vec[b, s] + lex[b, s, y].
// Grid (ceil(V / kBN), splits, rows), kThreads threads: blockIdx.z is the
// row b (rows null, padding rows return) or the live row rows[blockIdx.z].
// Splitting the states puts several blocks on every SM; merge_kernel
// combines the splits. kLoad reads the staged lex with the streaming
// (evict-first) hint: a frame's lex is far larger than the L2 cache, so a
// line kept after its read serves no later read, and the cache keeps the
// products' operands and stores instead; Vec (V % 4 == 0) reads a thread's
// 4 labels of a state in one 16-byte load.
template <int MODE, bool Vec = false>
__global__ void __launch_bounds__(kThreads)
    max_pass_kernel(const float* __restrict__ joint,  // [B, S, h]
                    const float* __restrict__ vw,     // [h, V]
                    const float* __restrict__ vb,     // [V]
                    const float* __restrict__ vec,    // [B, S]
                    const float* __restrict__ cnorm,  // [B, S] or null
                    float* __restrict__ lex,          // [B, S, V] or unused
                    float* __restrict__ part_v,       // [splits, B, V]
                    int* __restrict__ part_s,         // [splits, B, V]
                    const int* __restrict__ is_pad_t,  // [B]
                    const int* __restrict__ rows,  // [B], the live first
                    int B, int S, int h, int V, int tiles_per_split) {
  __shared__ float cand_v[kBM / kTM][kBN];
  __shared__ int cand_s[kBM / kTM][kBN];

  const int b = rows == nullptr ? blockIdx.z : rows[blockIdx.z];
  if (rows == nullptr && is_pad_t[b]) return;  // nothing of it is used
  const int y0 = blockIdx.x * kBN;
  const int s_begin = blockIdx.y * tiles_per_split * kBM;
  const int s_end = min(S, s_begin + tiles_per_split * kBM);
  const int tid = threadIdx.x;
  const int tx = tid % (kBN / kTN);  // column group
  const int ty = tid / (kBN / kTN);  // row group
  const float* joint_b = joint + static_cast<size_t>(b) * S * h;
  const float* vec_b = vec + static_cast<size_t>(b) * S;
  const float* c_b =
      cnorm == nullptr ? nullptr : cnorm + static_cast<size_t>(b) * S;
  float* lex_b = lex + static_cast<size_t>(b) * S * V;

  float bias[kTN];
#pragma unroll
  for (int j = 0; j < kTN; ++j) {
    const int y = y0 + tx * kTN + j;
    bias[j] = y < V ? vb[y] : 0.f;
  }
  // Running (max, argmax) of column y0 + tid, held by threads tid < kBN.
  float run_v = -INFINITY;
  int run_s = INT_MAX;

  for (int s0 = s_begin; s0 < s_end; s0 += kBM) {
    float val[kTM][kTN];
    if (MODE == kLoad && Vec) {
      static_assert(kTN == 4, "a thread's labels are one 16-byte load");
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
        const int s = s0 + ty * kTM + i, y = y0 + tx * kTN;
        const float4 q =
            s < S && y < V
                ? __ldcs(reinterpret_cast<const float4*>(
                      lex_b + static_cast<size_t>(s) * V + y))
                : make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
        val[i][0] = q.x;
        val[i][1] = q.y;
        val[i][2] = q.z;
        val[i][3] = q.w;
      }
    } else if (MODE == kLoad) {
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
        const int s = s0 + ty * kTM + i;
#pragma unroll
        for (int j = 0; j < kTN; ++j) {
          const int y = y0 + tx * kTN + j;
          val[i][j] = (s < S && y < V)
                          ? __ldcs(lex_b + static_cast<size_t>(s) * V + y)
                          : -INFINITY;
        }
      }
    } else {
      float acc[kTM][kTN];
      tile_product<false, false>(joint_b, h, vw, V, s0, y0, S, V, h, acc);
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
        const int s = s0 + ty * kTM + i;
#pragma unroll
        for (int j = 0; j < kTN; ++j) {
          val[i][j] = acc[i][j] + bias[j];
          const int y = y0 + tx * kTN + j;
          if (MODE == kComputeStore && s < S && y < V) {
            lex_b[static_cast<size_t>(s) * V + y] = val[i][j];
          }
        }
      }
    }

    // This thread's best row per column, then the 16 row groups per column
    // merged into the running (max, argmax).
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      float best_v = -INFINITY;
      int best_s = INT_MAX;
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
        const int s = s0 + ty * kTM + i;
        if (s < S) {
          const float v =
              (c_b == nullptr ? vec_b[s] : vec_b[s] - c_b[s]) + val[i][j];
          if (beats(v, s, best_v, best_s)) {
            best_v = v;
            best_s = s;
          }
        }
      }
      cand_v[ty][tx * kTN + j] = best_v;
      cand_s[ty][tx * kTN + j] = best_s;
    }
    __syncthreads();
    if (tid < kBN) {
      for (int r = 0; r < kBM / kTM; ++r) {
        if (beats(cand_v[r][tid], cand_s[r][tid], run_v, run_s)) {
          run_v = cand_v[r][tid];
          run_s = cand_s[r][tid];
        }
      }
    }
    __syncthreads();
  }

  if (tid < kBN && y0 + tid < V) {
    const size_t out = (static_cast<size_t>(blockIdx.y) * B + b) * V + y0 + tid;
    part_v[out] = run_v;
    part_s[out] = run_s;
  }
}

// Online log-sum-exp: a pair (m, l) stands for m + log(l); l = 0 is -inf.
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

__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

// The normalizing pass of a frame over one split of the label strips for a
// 64-state tile of batch row b: stores lex[b, s, y] and the online (max,
// sum) of lex over y per state into part_m / part_l [splits, B, S].
// Grid (ceil(S / 64), splits, B); norm_merge_kernel combines the splits.
__global__ void __launch_bounds__(kThreads)
    norm_pass_kernel(const float* __restrict__ joint,   // [B, S, h]
                     const float* __restrict__ vw,      // [h, V]
                     const float* __restrict__ vb,      // [V]
                     float* __restrict__ lex,           // [B, S, V]
                     float* __restrict__ part_m,        // [splits, B, S]
                     float* __restrict__ part_l,        // [splits, B, S]
                     const int* __restrict__ is_pad_t,  // [B]
                     int S, int h, int V, int strips_per_split) {
  const int b = blockIdx.z;
  if (is_pad_t[b]) return;
  const int B = gridDim.z;
  const int s0 = blockIdx.x * kBM;
  const int y_begin = blockIdx.y * strips_per_split * kBN;
  const int y_end = min(V, y_begin + strips_per_split * kBN);
  const int tx = threadIdx.x % (kBN / kTN), ty = threadIdx.x / (kBN / kTN);
  const float* joint_b = joint + static_cast<size_t>(b) * S * h;
  float* lex_b = lex + static_cast<size_t>(b) * S * V;
  float run_m[kTM], run_l[kTM];
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    run_m[i] = -INFINITY;
    run_l[i] = 0.f;
  }
  for (int y0 = y_begin; y0 < y_end; y0 += kBN) {
    float val[kTM][kTN];
    tile_product<false, false>(joint_b, h, vw, V, s0, y0, S, V, h, val);
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const int s = s0 + ty * kTM + i;
      float v[kTN];
      float m = -INFINITY;
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const int y = y0 + tx * kTN + j;
        v[j] = y < V ? val[i][j] + vb[y] : -INFINITY;
        if (s < S && y < V) lex_b[static_cast<size_t>(s) * V + y] = v[j];
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
  }
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const int s = s0 + ty * kTM + i;
      if (s < S) {
        const size_t out = (static_cast<size_t>(blockIdx.y) * B + b) * S + s;
        part_m[out] = run_m[i];
        part_l[out] = run_l[i];
      }
    }
  }
}

// Merges the normalizing pass: c[b, s] and the normalized blank[b, s] (in
// place). normalize 1 = hat, 2 = log_softmax. One thread per (b, s).
__global__ void __launch_bounds__(kUpdateThreads)
    norm_merge_kernel(const float* __restrict__ part_m,
                      const float* __restrict__ part_l, int splits,
                      const int* __restrict__ is_pad_t,  // [B]
                      float* __restrict__ blank,         // [B, S]
                      float* __restrict__ cnorm,         // [B, S]
                      int B, int S, int normalize) {
  const int idx = blockIdx.x * kUpdateThreads + threadIdx.x;
  if (idx >= B * S || is_pad_t[idx / S]) return;
  float m = -INFINITY, l = 0.f;
  for (int z = 0; z < splits; ++z) {
    const size_t at = static_cast<size_t>(z) * B * S + idx;
    lse_merge(m, l, part_m[at], part_l[at]);
  }
  const float lse = l > 0.f ? safe_shift(m) + logf(l) : -INFINITY;
  const float bl = blank[idx];
  if (normalize == 1) {
    cnorm[idx] = lse + softplus(bl);
    blank[idx] = -softplus(-bl);
  } else {
    const float hi = fmaxf(bl, lse);
    const float c =
        hi == -INFINITY ? hi : hi + log1pf(expf(fminf(bl, lse) - hi));
    cnorm[idx] = c;
    blank[idx] = bl - c;
  }
}

// Merges the splits of a max-pass, in any order under `beats`:
//   red[b, 1 + y], arg[b, y] = max / argmax over all states.
// Writes red in expanded form (column 0 = -inf), the next pass's vec.
// One thread per (b, y).
__global__ void __launch_bounds__(kUpdateThreads)
    merge_kernel(const float* __restrict__ part_v,  // [splits, B, V]
                 const int* __restrict__ part_s,    // [splits, B, V]
                 const int* __restrict__ is_pad_t,  // [B]
                 float* __restrict__ red,           // [B, S]
                 int* __restrict__ arg,             // row b at b * arg_stride
                 int arg_stride, int splits, int B, int S, int V) {
  const int idx = blockIdx.x * kUpdateThreads + threadIdx.x;
  if (idx >= B * V) return;
  const int b = idx / V, y = idx % V;
  int* arg_out = arg + static_cast<size_t>(b) * arg_stride + y;
  if (is_pad_t[b]) {  // padding frame: alpha is held; its arg row is 0
    *arg_out = 0;
    return;
  }
  float best_v = -INFINITY;
  int best_s = INT_MAX;
  for (int z = 0; z < splits; ++z) {
    const size_t at = (static_cast<size_t>(z) * B + b) * V + y;
    if (beats(part_v[at], part_s[at], best_v, best_s)) {
      best_v = part_v[at];
      best_s = part_s[at];
    }
  }
  red[static_cast<size_t>(b) * S + 1 + y] = best_v;
  // Only all-NaN columns leave best_s unset; report state 0 for them.
  *arg_out = best_s == INT_MAX ? 0 : best_s;
  if (y == 0) red[static_cast<size_t>(b) * S] = -INFINITY;
}

// The frame's alpha update (viterbi.py:177-202). One thread per (b, s).
__global__ void __launch_bounds__(kUpdateThreads)
    update_kernel(const float* __restrict__ alpha,   // [B, S]
                  const float* __restrict__ blank,   // [B, S]
                  const float* __restrict__ last,    // [passes, B, S]
                  const int* __restrict__ is_pad_t,  // [B]
                  float* __restrict__ alpha_out,     // [B, S]
                  int* __restrict__ jstar_t,         // [B, S]
                  int B, int S, int max_expansions, int frame_dependent) {
  const int idx = blockIdx.x * kUpdateThreads + threadIdx.x;
  if (idx >= B * S) return;
  const int b = idx / S;
  const float a = alpha[idx];
  const float bl = blank[idx];
  float new_a;
  int js;
  if (frame_dependent) {
    // One blank-or-lexical arc: jstar 0 = blank (stay), 1 = lexical move.
    const float stay = a + bl;
    const float move = last[idx];
    js = move > stay ? 1 : 0;
    new_a = fmaxf(stay, move);
  } else {
    // Up to k lexical arcs then a blank; strict '>' keeps the smallest j.
    float acc = a + bl;
    js = 0;
    for (int j = 1; j <= max_expansions; ++j) {
      const float cand = last[static_cast<size_t>(j - 1) * B * S + idx] + bl;
      if (cand > acc) {
        acc = cand;
        js = j;
      }
    }
    new_a = acc;
  }
  if (is_pad_t[b]) {
    new_a = a;
    js = 0;
  }
  alpha_out[idx] = new_a;
  jstar_t[idx] = js;
}

// The bfloat16 route's last merge of a frame folded into its update; one
// thread per (b, s). The last pass's red[b, s] merges the partials of
// label s - 1 under `beats` (-inf at state 0 and on padding rows), written
// to last + (passes - 1) B S, and its argmax to the pass's arg row (0 on
// padding rows, and for all-NaN columns); then alpha as update_kernel
// updates it.
__global__ void __launch_bounds__(kUpdateThreads)
    merge_update_kernel(const float* __restrict__ part_v,  // [splits, B, V]
                        const int* __restrict__ part_s, int splits,
                        const float* __restrict__ alpha,   // [B, S]
                        const float* __restrict__ blank,   // [B, S]
                        float* __restrict__ last,          // [passes, B, S]
                        const int* __restrict__ is_pad_t,  // [B]
                        float* __restrict__ alpha_out,     // [B, S]
                        int* __restrict__ jstar_t,         // [B, S]
                        int* __restrict__ arg,  // row b at b * arg_stride
                        int arg_stride, int B, int S, int V, int passes,
                        int max_expansions, int frame_dependent) {
  const int idx = blockIdx.x * kUpdateThreads + threadIdx.x;
  if (idx >= B * S) return;
  const int b = idx / S, s = idx % S;
  const bool pad = is_pad_t[b];
  float best_v = -INFINITY;
  int best_s = INT_MAX;
  if (!pad && s >= 1) {
    for (int z0 = 0; z0 < splits; z0 += 8) {  // 8 splits' loads in flight
      float pv[8];
      int ps[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const size_t at = (static_cast<size_t>(z0 + i) * B + b) * V + s - 1;
        pv[i] = z0 + i < splits ? part_v[at] : -INFINITY;
        ps[i] = z0 + i < splits ? part_s[at] : INT_MAX;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (beats(pv[i], ps[i], best_v, best_s)) {
          best_v = pv[i];
          best_s = ps[i];
        }
      }
    }
  }
  const size_t bs = static_cast<size_t>(B) * S;
  last[(passes - 1) * bs + idx] = best_v;
  if (s >= 1) {
    arg[static_cast<size_t>(b) * arg_stride + s - 1] =
        best_s == INT_MAX ? 0 : best_s;
  }
  const float a = alpha[idx];
  if (pad) {
    alpha_out[idx] = a;
    jstar_t[idx] = 0;
    return;
  }
  const float bl = blank[idx];
  float acc = a + bl;
  int js = 0;
  if (frame_dependent) {
    js = best_v > acc ? 1 : 0;
    acc = fmaxf(acc, best_v);
  } else {
    // Up to k lexical arcs then a blank; strict '>' keeps the smallest j.
    for (int j = 1; j <= max_expansions; ++j) {
      const float cand =
          (j == passes ? best_v : last[(j - 1) * bs + idx]) + bl;
      if (cand > acc) {
        acc = cand;
        js = j;
      }
    }
  }
  alpha_out[idx] = acc;
  jstar_t[idx] = js;
}

#define RETURN_IF_LAUNCH_FAILED()              \
  do {                                         \
    const cudaError_t err = cudaGetLastError(); \
    if (err != cudaSuccess) return static_cast<int>(err); \
  } while (0)

// The float32 forward: per frame the joint and blank of every row, with
// normalization the normalizing pass and its merge, then each max-pass (a
// split of the states per block) and its merge, then the update.
int run_forward(const float* pf, const float* pc, const float* vw,
                const float* vb, const float* bw, const float* bb,
                const int* is_pad, float* joint,
                float* blank, float* lex, float* part_v, int* part_s,
                float* part_m, float* part_l, float* cnorm, float* last,
                float* alpha, int* arg, int* jstar, int num_frames, int B,
                int S, int h, int V, int max_expansions, int frame_dependent,
                int normalize, int max_splits, int max_ysplits,
                cudaStream_t stream) {
  const int passes =
      frame_dependent ? 1 : (max_expansions > 1 ? max_expansions : 1);
  // Staged lex: for the later passes of FLD(k >= 2), and for normalization,
  // whose pass stores it for every max-pass (FD: 225.6-228.1 ms staged
  // against 362.6-365.2 ms recomputing the product, PERF.md).
  const bool stage = passes >= 2 || normalize != 0;
  const size_t bs = static_cast<size_t>(B) * S;
  const int tiles = (S + kBM - 1) / kBM;
  const int tiles_per_split =
      (tiles + max_splits - 1) / (max_splits > 0 ? max_splits : 1);
  const int splits = (tiles + tiles_per_split - 1) / tiles_per_split;
  const int strips = (V + kBN - 1) / kBN;
  const int strips_per_split =
      (strips + max_ysplits - 1) / (max_ysplits > 0 ? max_ysplits : 1);
  const int ysplits = (strips + strips_per_split - 1) / strips_per_split;
  const dim3 joint_grid(S, B);
  const dim3 pass_grid(strips, splits, B);
  const dim3 norm_grid(tiles, ysplits, B);
  const int update_blocks =
      static_cast<int>((bs + kUpdateThreads - 1) / kUpdateThreads);
  const int merge_blocks = (B * V + kUpdateThreads - 1) / kUpdateThreads;
  const float* c = normalize != 0 ? cnorm : nullptr;
  for (int t = 0; t < num_frames; ++t) {
    const float* alpha_cur = alpha + (t % 2) * bs;
    float* alpha_next = alpha + ((t + 1) % 2) * bs;
    const int* is_pad_t = is_pad + static_cast<size_t>(t) * B;
    joint_blank_kernel<<<joint_grid, kJointThreads, 0, stream>>>(
        pf + static_cast<size_t>(t) * B * h, is_pad_t, pc, bw, bb, joint,
        blank, S, h);
    RETURN_IF_LAUNCH_FAILED();
    if (normalize != 0) {
      norm_pass_kernel<<<norm_grid, kThreads, 0, stream>>>(
          joint, vw, vb, lex, part_m, part_l, is_pad_t, S, h, V,
          strips_per_split);
      RETURN_IF_LAUNCH_FAILED();
      norm_merge_kernel<<<update_blocks, kUpdateThreads, 0, stream>>>(
          part_m, part_l, ysplits, is_pad_t, blank, cnorm, B, S, normalize);
      RETURN_IF_LAUNCH_FAILED();
    }
    const float* vec = alpha_cur;
    for (int j = 0; j < passes; ++j) {
      if (!stage) {
        max_pass_kernel<kCompute><<<pass_grid, kThreads, 0, stream>>>(
            joint, vw, vb, vec, c, lex, part_v, part_s, is_pad_t, nullptr, B,
            S, h, V, tiles_per_split);
      } else if (j == 0 && normalize == 0) {
        max_pass_kernel<kComputeStore><<<pass_grid, kThreads, 0, stream>>>(
            joint, vw, vb, vec, c, lex, part_v, part_s, is_pad_t, nullptr, B,
            S, h, V, tiles_per_split);
      } else {
        max_pass_kernel<kLoad><<<pass_grid, kThreads, 0, stream>>>(
            joint, vw, vb, vec, c, lex, part_v, part_s, is_pad_t, nullptr, B,
            S, h, V, tiles_per_split);
      }
      RETURN_IF_LAUNCH_FAILED();
      float* red = last + j * bs;
      merge_kernel<<<merge_blocks, kUpdateThreads, 0, stream>>>(
          part_v, part_s, is_pad_t, red,
          arg + (static_cast<size_t>(t) * B * passes + j) * V, passes * V,
          splits, B, S, V);
      RETURN_IF_LAUNCH_FAILED();
      vec = red;
    }
    update_kernel<<<update_blocks, kUpdateThreads, 0, stream>>>(
        alpha_cur, blank, last, is_pad_t, alpha_next,
        jstar + static_cast<size_t>(t) * bs, B, S, max_expansions,
        frame_dependent);
    RETURN_IF_LAUNCH_FAILED();
  }
  return 0;
}

// ---------------------------------------------------------------------------
// The bfloat16 forward on head_product.cuh's wgmma products.
namespace hopper {

using bf16 = __nv_bfloat16;

#define RETURN_IF_ERROR(expr)                                 \
  do {                                                        \
    const cudaError_t err = (expr);                           \
    if (err != cudaSuccess) return static_cast<int>(err);     \
  } while (0)

// Once per call the padded head vw16 [hp, Vp]; per frame t with live[t] >
// 0 rows (their indices first in rows[t]) the joint [B, S, hp] and blank of
// those rows; with normalization row_reduce_kernel (lex stored, strip
// partials; in the walk lanes names, as column_max_kernel) and
// norm_merge_kernel; then each max-pass: the first without
// normalization as column_max_kernel over alpha (storing lex with two or
// more passes), the others as max_pass_kernel<kLoad> over the staged lex
// of the live rows (64-state tiles, one partial each), each merged by
// merge_kernel into the pass's expansion and arg table, the last one by
// merge_update_kernel with the frame's update. Padding rows launch no product: the merges write
// their arg rows 0 and the update holds their alpha. A frame with no live
// row runs only the merges and the update.
int run_forward(const float* pf, const float* pc, const float* vw,
                const float* vb, const float* bw, const float* bb,
                const int* is_pad, const int* live, const int* rows,
                bf16* joint, bf16* vw16, float* blank, float* lex,
                float* part_v, int* part_s, float* part_m, float* part_l,
                float* cnorm, float* last, float* alpha, int* arg,
                int* jstar, int T, int B, int S, int h, int V,
                int max_expansions, int frame_dependent, int normalize,
                int sms, int lanes, cudaStream_t stream) {
  const int passes =
      frame_dependent ? 1 : (max_expansions > 1 ? max_expansions : 1);
  const bool stage = passes >= 2 || normalize != 0;
  if ((T > 0 && live == nullptr) || sms < 1 || lanes < 0 ||
      (stage && lex == nullptr) ||
      (normalize != 0 &&
       (part_m == nullptr || part_l == nullptr || cnorm == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int hp = wgmma_tiles::round_up(h, wgmma_tiles::kBK);
  const int Vp = wgmma_tiles::round_up(V, wgmma_tiles::kBK);
  const int t64 = wgmma_tiles::cdiv(S, 64);
  const int strips = wgmma_tiles::cdiv(Vp, wgmma_tiles::kBN);
  const size_t bs = static_cast<size_t>(B) * S;
  const int update_blocks =
      static_cast<int>((bs + kUpdateThreads - 1) / kUpdateThreads);
  const int merge_blocks = (B * V + kUpdateThreads - 1) / kUpdateThreads;
  const float* c = normalize != 0 ? cnorm : nullptr;
  const bool vec_lex =
      V % 4 == 0 && reinterpret_cast<uintptr_t>(lex) % 16 == 0;
  RETURN_IF_ERROR(head_product::joint_pass(pc, pf, vw, bw, bb, nullptr,
                                           joint, vw16, blank, 0, S, h, V,
                                           /*head=*/true, stream));
  for (int t = 0; t < T; ++t) {
    const int L = live[t];
    const float* alpha_cur = alpha + (t % 2) * bs;
    float* alpha_next = alpha + ((t + 1) % 2) * bs;
    const int* is_pad_t = is_pad + static_cast<size_t>(t) * B;
    const int* rows_t = rows + static_cast<size_t>(t) * B;
    if (L > 0) {
      RETURN_IF_ERROR(head_product::joint_pass(
          pc, pf + static_cast<size_t>(t) * B * h, vw, bw, bb, rows_t, joint,
          vw16, blank, L, S, h, V, /*head=*/false, stream));
      if (normalize != 0) {
        const head_product::RowReduce p{vb, rows_t, lex, part_m, part_l, B,
                                        S,  V,      hp,  Vp,     L};
        RETURN_IF_ERROR(
            head_product::row_product(joint, vw16, p, sms, lanes,
                                      stream));
        norm_merge_kernel<<<update_blocks, kUpdateThreads, 0, stream>>>(
            part_m, part_l, strips, is_pad_t, blank, cnorm, B, S, normalize);
        RETURN_IF_LAUNCH_FAILED();
      }
    }
    const float* vec = alpha_cur;
    for (int j = 0; j < passes; ++j) {
      if (L > 0 && j == 0 && normalize == 0) {
        const head_product::ColumnMax p{
            vb, vec, rows_t, part_v, part_s, passes >= 2 ? lex : nullptr,
            B,  S,   V,      hp,     Vp,     L};
        RETURN_IF_ERROR(
            head_product::max_product(joint, vw16, p, sms, lanes,
                                      stream));
      } else if (L > 0) {
        // kLoad reads no joint or head; a block per live row's 64-state
        // tile and 64-label strip.
        const dim3 grid((V + kBN - 1) / kBN, t64, L);
        if (vec_lex) {
          max_pass_kernel<kLoad, true><<<grid, kThreads, 0, stream>>>(
              nullptr, nullptr, vb, vec, c, lex, part_v, part_s, is_pad_t,
              rows_t, B, S, h, V, 1);
        } else {
          max_pass_kernel<kLoad><<<grid, kThreads, 0, stream>>>(
              nullptr, nullptr, vb, vec, c, lex, part_v, part_s, is_pad_t,
              rows_t, B, S, h, V, 1);
        }
        RETURN_IF_LAUNCH_FAILED();
      }
      int* arg_j = arg + (static_cast<size_t>(t) * B * passes + j) * V;
      if (j + 1 == passes) {  // merged with the update
        merge_update_kernel<<<update_blocks, kUpdateThreads, 0, stream>>>(
            part_v, part_s, t64, alpha_cur, blank, last, is_pad_t,
            alpha_next, jstar + static_cast<size_t>(t) * bs, arg_j,
            passes * V, B, S, V, passes, max_expansions, frame_dependent);
        RETURN_IF_LAUNCH_FAILED();
        break;
      }
      float* red = last + j * bs;
      merge_kernel<<<merge_blocks, kUpdateThreads, 0, stream>>>(
          part_v, part_s, is_pad_t, red, arg_j, passes * V, t64, B, S, V);
      RETURN_IF_LAUNCH_FAILED();
      vec = red;
    }
  }
  return 0;
}

#undef RETURN_IF_ERROR

}  // namespace hopper

}  // namespace

extern "C" {

// Runs the whole forward on `stream` and returns the first launch error
// (0 on success). The caller allocates everything; the final alpha is left
// in slot num_frames % 2 of `alpha` ([2, B, S], slot 0 holds alpha0 on
// entry). dtype 0 = float32, 1 = bfloat16 (the compute type). normalize 0
// = none, 1 = hat, 2 = log_softmax. `lex` ([B, S, V] float32) is used, and
// needed, with two or more passes per frame or with normalization: the
// frame's lexical scores are staged there for the later passes; cnorm [B,
// S] holds the per-state normalizers with normalization.
// In bfloat16 the frames run on head_product.cuh's wgmma products over
// their live rows: live [T] (host memory) counts each frame's real rows and
// rows [T, B] (device) lists them first; vw ([h, V]) and bw ([h]) are
// float32 (the kernels round them), joint is bfloat16 [B, S, hp] and vw16
// bfloat16 [hp, Vp] (hp, Vp: h and V rounded up to 64), part_v / part_s
// are [ceil(S / 64), B, V], part_m / part_l [ceil(Vp / 128), B, S] (with
// normalization), the products run on persistent blocks in the walk the
// caller chose: with lanes > 0 strip-stationary, `lanes` blocks a 128-label
// strip (hp <= 576), else in unit pairs on two blocks each of the card's
// `sms` SMs; max_splits / max_ysplits are not used.
// In float32 vw, bw and joint ([B, S, h]) are float32, live, rows and vw16
// are not used, part_v / part_s hold [max_splits, B, V] per-split maxima
// (the states split into at most max_splits ranges of whole 64-state
// tiles) and part_m / part_l [max_ysplits, B, S] per-split row partials
// (the labels split into at most max_ysplits ranges of whole 64-label
// strips).
int viterbi_forward(int dtype, const float* pf, const float* pc,
                    const void* vw, const float* vb, const void* bw,
                    const float* bb, const int* is_pad, void* joint,
                    float* blank, float* lex, float* part_v, int* part_s,
                    float* part_m, float* part_l, float* cnorm, float* last,
                    float* alpha, int* arg, int* jstar, int num_frames, int B,
                    int S, int h, int V, int max_expansions,
                    int frame_dependent, int normalize, int max_splits,
                    int max_ysplits, const int* live, const int* rows,
                    void* vw16, int sms, int lanes, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (normalize < 0 || normalize > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == 0) {
    return run_forward(
        pf, pc, static_cast<const float*>(vw), vb,
        static_cast<const float*>(bw), bb, is_pad,
        static_cast<float*>(joint), blank, lex, part_v, part_s, part_m,
        part_l, cnorm, last, alpha, arg, jstar, num_frames, B, S, h, V,
        max_expansions, frame_dependent, normalize, max_splits, max_ysplits,
        s);
  }
  if (dtype == 1) {
    using hopper::bf16;
    return hopper::run_forward(
        pf, pc, static_cast<const float*>(vw), vb,
        static_cast<const float*>(bw), bb, is_pad, live, rows,
        static_cast<bf16*>(joint), static_cast<bf16*>(vw16), blank, lex,
        part_v, part_s, part_m, part_l, cnorm, last, alpha, arg, jstar,
        num_frames, B, S, h, V, max_expansions, frame_dependent, normalize,
        sms, lanes, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* viterbi_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
