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

// Log-partition (GN loss denominator) forward and backward, and the per-frame
// posteriors, of the GNAT recognition lattice on Hopper.
//
// Replaces the Pallas TPU kernels of last_torch_tpu/ops/fused_scan.py:
// _fused_forward_kernel (pallas_call at fused_scan.py:1474, 'cache' mode with
// the expansion slabs streamed) and _fused_backward_kernel (pallas_call at
// :1709); their vocabulary-tiled 'online' variants _online_forward_kernel
// (:712, same pallas_call as the forward) and _online_backward_kernel (:867,
// same as the backward); and _fused_marginals_kernel (pallas_call at
// :2008). Bigram FullNGram (S = V + 1), JointWeightFn, FrameDependent (FD)
// or FrameLabelDependent(k) (FLD). Per frame t and batch row b:
//
//   joint[s]  = compute_dtype(tanh(pc[s] + pf[t, b]))            (f32 tanh)
//   lex[s, y] = joint[s] . vocab_w[:, y] + vocab_b[y]            (f32 sums)
//   blank[s]  = joint[s] . blank_w + blank_b
//   red(vec)[y] = logsumexp_s(vec[s] + lex[s, y]);  expand(red) puts red in
//                 states 1..V and -inf in state 0
//
// Forward: FD alpha' = logaddexp(alpha + blank, expand(red(alpha))); FLD:
// acc = alpha + blank, then k times last = expand(red(last)) (from alpha),
// acc = logaddexp(acc, last + blank). Padding frames hold alpha. Outputs:
// the history of alpha before each frame and the k expansion slabs (only
// when the backward will read them), and the final alpha.
//
// Backward, frames in reverse, beta from 0: nb recursion
// nb_{k-1} = blank + beta, nb_{j-1} = logaddexp(blank + beta,
// logsumexp_y(lex[s, y] + nb_j[1 + y])), the last one is the next beta (FD:
// one step from beta). Marginals, with a_j the slabs (a_0 = alpha):
//   d_blank = g * sum_j exp(a_j + blank + beta - log_z)
//   d_lex   = compute_dtype(g * sum_j exp(a_j[s] + lex[s, y] + nb_j[1 + y]
//                                         - log_z))
// then the head and tanh gradients:
//   dvw += joint^T d_lex, dvb += sum d_lex, dbw += sum joint32 * d_blank,
//   dbb += sum d_blank, d_joint = d_lex vocab_w^T + d_blank blank_w,
//   d_pre = d_joint (1 - joint32^2), dpf[t, b] = sum_s d_pre,
//   dpc += sum_b d_pre.
//
// What bounds it here. Per frame the forward runs one head product
// [B*S, h] x [h, V] (2*B*S*V*h = 8.6 GFLOP at B=8, S=1025, V=1024, h=512)
// and the backward three of that size (lex, dvw, d_joint): compute-bound
// products on the tensor cores (989 TFLOP/s bf16); around them sit
// per-element exps, tanh derivatives and row and column sums, and a few
// small launches per frame. Only [B, S]-sized state and the head-gradient
// sums cross frames.
//
// What the design does about it:
// * The TPU grid carried alpha / beta and the head-gradient sums across its
//   sequential (t, b) grid in VMEM scratch. Hopper blocks run in no order
//   and carry nothing, so the time loop runs on the host side of this file,
//   a few launches per frame on the caller's stream, and every cross-frame
//   sum is a device buffer in which each element belongs to one block per
//   frame (no atomics); one reduce launch each at the end. Sums are
//   therefore deterministic.
// * The TPU cached E = exp(lex - rowmax) in 80 MB of VMEM and ran every
//   in-frame reduction as a matvec against it. A block here has 227 KB, and
//   one that owns a label strip never sees a whole row, so the logsumexps
//   are online (max, sum) pairs over the states (forward, per label) or the
//   labels (backward, per state) a block covers, merged across blocks with
//   the same log-add.
// * The marginals are formed directly, exp(a + lex + nb - log_z), each term
//   at most about 1, so the TPU's factored form and its clip at 80
//   (fused_scan.py:468-474) are not needed; padding rows and padded states
//   never enter a sum, so all-padding rows and g = 0 rows give exact zeros.
// * The bfloat16 forward of both modes (namespace hopper) runs on
//   head_product.cuh, the machinery it shares with the joint+head forward,
//   the frame reduction and the Viterbi forward: per frame, over its live
//   rows only (counted once per call on the host, listed first on the
//   device), the joint pass writes the bfloat16 joint [B, S, hp] and the
//   blank head once, then each reduction is the column-reduce product
//   (wgmma on TMA operands, two consumer warpgroups, a persistent grid)
//   with the (max, sum) over each 64-state unit in its epilogue, merged by
//   col_merge_kernel; the padded bfloat16 head is formed once per call. In
//   'cache' mode the first reduction of a frame also stores lex (float32
//   [B, S, V]) and the later ones read it back (col_pass_kernel<kLoad>),
//   which measured 5-7% faster than recomputing the product at B=8, B=32
//   and V=4096 (PERF.md): the product is bound by the operands the L2
//   cache delivers, a lex read by the bytes alone. In 'online' mode every
//   reduction is the product. The last merge of a frame runs in its
//   update.
// * The float32 comparison mode, the trigram and the float32 marginals:
//   tile_product.cuh's 64 x 64 tiles (WMMA in bfloat16, FMAs in float32).
//   The forward's first reduction runs in the epilogue of the head
//   product; in 'cache' mode with two or more per frame the product stores
//   lex (float32) for the others.
// * The bfloat16 backward (namespace hopper, both modes) runs its products
//   on wgmma (wgmma_tiles.cuh: m64n128k16 from shared memory, operands brought
//   by TMA through a 4-stage mbarrier ring, two blocks an SM), over each
//   frame's live rows only: the host counts them once per call and lists
//   them first, so padding rows launch nothing and the grids shrink with
//   the batch as utterances end. Per frame: joint_blank_kernel writes the
//   joint once in bfloat16 for the products (8.4 MB at B=8; forming it
//   while staging would cost a tanh per entry and label strip, more than
//   the product) and once in float32 for the tanh derivative, then
//   the k row reductions (lex_pass_kernel: the product, + vb, the strip's
//   (max, sum) per state; the last also the marginals d_lex, written once
//   in bfloat16, and their column sums), and the two gradient products of
//   head_grads.cuh: dvw over the live (row, state) depth split over blocks,
//   and d_joint with the tanh derivative in its epilogue, one block running
//   the rows of its split so that d_pc stays in registers ([splits, S, h]
//   across frames, not [B, S, h]). lex is recomputed by every reduction:
//   staging it (float32 [B, S, V]) for the later reductions measured slower
//   at B=8, where it fits in the L2 cache, and at B=32 alike (PERF.md).
//   d_joint does
//   not share the d_lex block: holding a state tile's [64, h] d_joint
//   beside its lex strip needs more registers than two blocks an SM
//   leave.

// 'online' mode (large V). The staged buffers of the cache mode are [B, S,
// V]: the forward's float32 lex (537 MB per frame at B=8, V=4096) and the
// backward's bfloat16 d_lex (268 MB there, 4.3 GB at V=16384), growing as
// V^2. The online mode keeps no buffer of that size, as the TPU's online
// kernels kept no lexical cache. Its forward recomputes the head product
// for every reduction (in bfloat16 the column-reduce product without its
// lex store; in float32 col_pass_kernel's kCompute path): FLD(k) costs k
// products per frame against 1.
// Its bfloat16 backward is the cache mode's wgmma frame loop with the last
// row reduction, its merge and both gradient products run per chunk of
// states: the chunk's marginals go to a d_lex of [B, chunk, Vp] (chunk a
// multiple of 64 states, 1024 from ops/fused_scan.py: 67 MB at B=8,
// V=4096, against 268 MB for all S), its own TMA map so that no load reads
// past it, and the two products read it before the next chunk overwrites
// it. The products are the cache mode's, k + 2 per frame for FLD(k), and
// so are the other buffers: the joint (bfloat16 and float32, [B, S, h])
// and d_pc carried in registers over [dsplits, S, h]. Launches per frame:
// the joint, 2 per earlier reduction, 4 per chunk (reduction, merge, two
// products) and d(pf): 24 at B=8, V=4096, FLD(2) (5 chunks), against 8 in
// 'cache'. The float32 online backward keeps its WMMA tiles: the last
// reduction's marginals recomputed by marginal_kernel<kCompute> per chunk,
// then head_grad_kernel and joint_grad_kernel on tile_product.cuh, d_pc in
// a float32 [B, S, h] buffer. The forward's expansion slabs are read by the
// backward in both modes, where the TPU's online backward replayed them.

// Marginals (the confidence API). The backward's recurrence with g = 1 and
// no gradient products: per frame the blank posteriors
//   bm[b, s] = sum_j exp(a_j + blank + beta - log_z)
// and the label posteriors summed over the states,
//   lp[b, y] = sum_j sum_s exp(a_j[s] + lex[s, y] + nb_j[1 + y] - log_z),
// a column sum that crosses the blocks splitting the states: each (row,
// state tile) block writes its own partial, one reduce launch per frame adds
// them (no atomics, deterministic). In float32 lex is staged for the frame
// ([B, S, V]) and read back by marginal_kernel. In bfloat16 (FD, FLD(k >=
// 1); hopper::run_marginals) the frames run the bfloat16 backward's wgmma
// row reductions over their live rows, the last one in its marginals mode:
// the posteriors and their column sums in its epilogue, in float32, unrounded
// (the backward rounds its d_lex to bfloat16); every reduction recomputes the
// head product, so nothing of [B, S, V] is held (134 MB of float32 lex at
// B=32, V=1024 before), and no gradient product runs. What bounds it: the
// k head products a frame-row (2 S h V each) on the tensor cores; under
// FLD(2) twice the one-product bound that the forward meets by staging lex.
//
// Trigram mode (trigram_forward / trigram_backward). Replaces the Pallas TPU
// kernels of last_torch_tpu/ops/trigram_scan.py: _trigram_forward_kernel
// (pallas_call at trigram_scan.py:627) and _trigram_backward_kernel
// (pallas_call at :1088). FullNGram(context_size=2): S = 1 + V + V^2
// states in the context's own order (0 the start, 1..V the unigrams,
// 1 + V + (q - 1) V + (p - 1) the bigram (q, p)). The arc with label y + 1
// out of a state whose last symbol is p reaches 1 + V + (p - 1) V + y
// (dest_base), out of the start state the unigram 1 + y. So destination
// (p, y) sums only over "segment p" (unigram p and the V bigrams (q, p)),
// and segment p's V destinations are contiguous: a block that owns (row,
// segment) writes its reduced row straight to them. The TPU kernels' layout
// machinery (the segment-major b-major state layout, the identity-matrix
// (p <-> y) transpose and the shift-matrix beta gather, the blank folded
// into a spare lex lane) has no use here and is not ported.
//   bfloat16, FD and FLD(k >= 1), V <= 128: namespace segments below (a
// block per segment and group of rows, the joint formed in the wgmma
// operand; 1 + (k - 1) launches a frame forward, k + 2 backward). The
// float32 comparison mode, FLD(0) and larger V or h keep the first design:
// forward, per frame: the joint and blank (joint_blank_kernel), lex staged
// in float32 (lex_kernel: the head product of the bigram mode, stored), then
// one segment sweep per FD frame or k for FLD(k) (segment_sweep_kernel: the
// online (max, sum) over the segment's V + 1 strided source rows, pure
// CUDA-core work), then the bigram mode's update_kernel. Its backward is the
// bigram cache backward (run_backward) with the row reductions and the
// marginals reading nb at dest_base(s) + y in place of 1 + y. What bounds
// it: the head products (2 S V h per frame-row, 0.27 GFLOP at V=64, h=512)
// are small beside the joint's S h tanhf and its [B, S, h] round trips
// through memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "head_grads.cuh"
#include "head_product.cuh"
#include "tile_product.cuh"

namespace {

using namespace lattice_tiles;

constexpr int kJointThreads = 128;
constexpr int kPointThreads = 256;
constexpr int kMaxAlphas = 9;  // a_0..a_k, k <= 8

enum LexMode { kCompute = 0, kComputeStore = 1, kLoad = 2 };

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

__device__ __forceinline__ float lse_value(float m, float l) {
  return l > 0.f ? safe_shift(m) + logf(l) : -INFINITY;
}

__device__ __forceinline__ float log_add(float a, float b) {
  const float m = fmaxf(a, b);
  if (m == -INFINITY) return -INFINITY;
  return m + log1pf(expf(fminf(a, b) - m));
}

// The arc with label y + 1 out of state s reaches dest_base(s) + y. Bigram:
// 1 + y from every state. Trigram: the start state reaches the unigram
// 1 + y; a state whose last symbol is p (unigram p, bigram (q, p)) reaches
// the bigram (p, y + 1). Every s >= 0 gives an index inside [0, S).
template <bool TRI>
__device__ __forceinline__ int dest_base(int s, int V) {
  if (!TRI || s == 0) return 1;
  const int p = s <= V ? s : (s - 1 - V) % V + 1;
  return 1 + V + (p - 1) * V;
}

// The frame's slabs: a_0 = alpha before the frame, a_j its j-th expansion.
struct Alphas {
  const float* a[kMaxAlphas];
  int n;
};

// The (a_j, nb_j) pairs of the lexical marginals.
struct Pairs {
  const float* a[kMaxAlphas];
  const float* nb[kMaxAlphas];
  int n;
};

// joint[b, s, :h] = cast(tanh(pc[s] + pf_t[b])) (rows ld apart, zero past
// h; with joint32, also the float32 tanh); blank[b, s] = joint . bw + bb;
// with nb_top, nb_top[b, s] = blank[b, s] + beta[b, s]. Padding rows skip
// the work, writing a zero joint row when zero_pad is set (the backward's
// contraction over rows reads it). Grid (S, B).
template <typename T>
__global__ void __launch_bounds__(kJointThreads)
    joint_blank_kernel(const float* __restrict__ pf_t,    // [B, h]
                       const int* __restrict__ is_pad_t,  // [B]
                       const float* __restrict__ pc,      // [S, h]
                       const T* __restrict__ bw,          // [h]
                       const float* __restrict__ bb,      // [1]
                       const float* __restrict__ beta,    // [B, S] or null
                       float* __restrict__ nb_top,        // [B, S] or null
                       T* __restrict__ joint,             // [B, S, ld]
                       float* __restrict__ joint32,       // [B, S, h] or null
                       float* __restrict__ blank,         // [B, S]
                       int S, int h, int ld, int zero_pad) {
  const int s = blockIdx.x;
  const int b = blockIdx.y;
  T* out = joint + (static_cast<size_t>(b) * S + s) * ld;
  if (is_pad_t[b]) {
    if (zero_pad) {
      for (int k = threadIdx.x; k < h; k += kJointThreads) {
        out[k] = from_float<T>(0.f);
      }
    }
    return;
  }
  const float* pc_row = pc + static_cast<size_t>(s) * h;
  const float* pf_row = pf_t + static_cast<size_t>(b) * h;
  for (int k = h + threadIdx.x; k < ld; k += kJointThreads) {
    out[k] = from_float<T>(0.f);
  }
  float* out32 = joint32 == nullptr
                     ? nullptr
                     : joint32 + (static_cast<size_t>(b) * S + s) * h;
  float partial = 0.f;
  for (int k = threadIdx.x; k < h; k += kJointThreads) {
    const float j32 = tanhf(pc_row[k] + pf_row[k]);
    if (out32 != nullptr) out32[k] = j32;
    const T j = from_float<T>(j32);
    out[k] = j;
    partial = fmaf(to_float(j), to_float(bw[k]), partial);
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
    const size_t at = static_cast<size_t>(b) * S + s;
    blank[at] = total + bb[0];
    if (nb_top != nullptr) nb_top[at] = blank[at] + beta[at];
  }
}

// The lexical tile [s0.., y0..] of batch row b, as val[i][j]: from the head
// product (storing it to lex with kComputeStore) or from the staged lex.
// Outside [S, V] the values are -inf (kLoad) or unspecified (otherwise).
template <typename T, int MODE>
__device__ __forceinline__ void lex_tile(const T* __restrict__ joint_b,
                                         const T* __restrict__ vw,
                                         const float* __restrict__ vb,
                                         float* __restrict__ lex_b, int s0,
                                         int y0, int S, int h, int V,
                                         float (&val)[kTM][kTN]) {
  const int tx = threadIdx.x % (kBN / kTN), ty = threadIdx.x / (kBN / kTN);
  if (MODE == kLoad) {
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const int s = s0 + ty * kTM + i;
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const int y = y0 + tx * kTN + j;
        val[i][j] = (s < S && y < V) ? lex_b[static_cast<size_t>(s) * V + y]
                                     : -INFINITY;
      }
    }
    return;
  }
  tile_product<false, false>(joint_b, h, vw, V, s0, y0, S, V, h, val);
#pragma unroll
  for (int j = 0; j < kTN; ++j) {
    const int y = y0 + tx * kTN + j;
    const float bias = y < V ? vb[y] : 0.f;
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const int s = s0 + ty * kTM + i;
      val[i][j] += bias;
      if (MODE == kComputeStore && s < S && y < V) {
        lex_b[static_cast<size_t>(s) * V + y] = val[i][j];
      }
    }
  }
}

// Forward reduction over one split of the states for a 64-label strip of
// row b: the online (max, sum) of vec[b, s] + lex[b, s, y] over s, per y.
// Grid (ceil(V / 64), splits, B); col_merge_kernel combines the splits.
template <int MODE>
__global__ void __launch_bounds__(kThreads)
    col_pass_kernel(const float* __restrict__ joint,    // [B, S, h]
                    const float* __restrict__ vw,       // [h, V]
                    const float* __restrict__ vb,       // [V]
                    const float* __restrict__ vec,      // [B, S]
                    float* __restrict__ lex,            // [B, S, V] or null
                    float* __restrict__ part_m,         // [splits, B, V]
                    float* __restrict__ part_l,         // [splits, B, V]
                    const int* __restrict__ is_pad_t,   // [B]
                    int S, int h, int V, int tiles_per_split) {
  __shared__ float cand_m[kBM / kTM][kBN];
  __shared__ float cand_l[kBM / kTM][kBN];
  const int b = blockIdx.z;
  if (is_pad_t[b]) return;  // a padding frame's reductions are unused
  const int B = gridDim.z;
  const int y0 = blockIdx.x * kBN;
  const int s_begin = blockIdx.y * tiles_per_split * kBM;
  const int s_end = min(S, s_begin + tiles_per_split * kBM);
  const int tid = threadIdx.x;
  const int tx = tid % (kBN / kTN), ty = tid / (kBN / kTN);
  const float* joint_b = joint + static_cast<size_t>(b) * S * h;
  const float* vec_b = vec + static_cast<size_t>(b) * S;
  float* lex_b =
      lex == nullptr ? nullptr : lex + static_cast<size_t>(b) * S * V;
  float run_m = -INFINITY, run_l = 0.f;  // column y0 + tid, tid < 64
  for (int s0 = s_begin; s0 < s_end; s0 += kBM) {
    float val[kTM][kTN];
    lex_tile<float, MODE>(joint_b, vw, vb, lex_b, s0, y0, S, h, V, val);
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      float v[kTM];
      float m = -INFINITY;
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
        const int s = s0 + ty * kTM + i;
        v[i] = s < S ? vec_b[s] + val[i][j] : -INFINITY;
        m = fmaxf(m, v[i]);
      }
      const float c = safe_shift(m);
      float l = 0.f;
#pragma unroll
      for (int i = 0; i < kTM; ++i) l += expf(v[i] - c);
      cand_m[ty][tx * kTN + j] = m;
      cand_l[ty][tx * kTN + j] = l;
    }
    __syncthreads();
    if (tid < kBN) {
      for (int r = 0; r < kBM / kTM; ++r) {
        lse_merge(run_m, run_l, cand_m[r][tid], cand_l[r][tid]);
      }
    }
    __syncthreads();
  }
  if (tid < kBN && y0 + tid < V) {
    const size_t out = (static_cast<size_t>(blockIdx.y) * B + b) * V + y0 + tid;
    part_m[out] = run_m;
    part_l[out] = run_l;
  }
}

// Merges the splits of a forward reduction: out[b] = expand(red) (state 0
// -inf); padding rows get all -inf. One thread per (b, y).
__global__ void __launch_bounds__(kPointThreads)
    col_merge_kernel(const float* __restrict__ part_m,
                     const float* __restrict__ part_l,
                     const int* __restrict__ is_pad_t,
                     float* __restrict__ out,  // [B, S]
                     int splits, int B, int S, int V) {
  const int idx = blockIdx.x * kPointThreads + threadIdx.x;
  if (idx >= B * V) return;
  const int b = idx / V, y = idx % V;
  float* row = out + static_cast<size_t>(b) * S;
  if (y == 0) row[0] = -INFINITY;
  if (is_pad_t[b]) {
    row[1 + y] = -INFINITY;
    return;
  }
  // Latency-bound: 8 splits' loads in flight before their merges.
  float m = -INFINITY, l = 0.f;
  for (int z0 = 0; z0 < splits; z0 += 8) {
    float pm[8], pl[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const size_t at = (static_cast<size_t>(z0 + i) * B + b) * V + y;
      pm[i] = z0 + i < splits ? part_m[at] : -INFINITY;
      pl[i] = z0 + i < splits ? part_l[at] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (z0 + i < splits) lse_merge(m, l, pm[i], pl[i]);
    }
  }
  row[1 + y] = lse_value(m, l);
}

// The frame's alpha update; one thread per (b, s). last + j * last_stride
// is the j-th expansion (FD: the one reduction).
__global__ void __launch_bounds__(kPointThreads)
    update_kernel(const float* __restrict__ alpha,   // [B, S]
                  const float* __restrict__ blank,   // [B, S]
                  const float* __restrict__ last, size_t last_stride,
                  const int* __restrict__ is_pad_t,  // [B]
                  float* __restrict__ alpha_out,     // [B, S]
                  float* __restrict__ hist_t,        // [B, S] or null
                  int B, int S, int passes, int frame_dependent) {
  const int idx = blockIdx.x * kPointThreads + threadIdx.x;
  if (idx >= B * S) return;
  const float a = alpha[idx];
  if (hist_t != nullptr) hist_t[idx] = a;
  if (is_pad_t[idx / S]) {
    alpha_out[idx] = a;
    return;
  }
  const float bl = blank[idx];
  float acc = a + bl;
  if (frame_dependent) {
    acc = log_add(acc, last[idx]);
  } else {
    for (int j = 0; j < passes; ++j) {
      acc = log_add(acc, last[j * last_stride + idx] + bl);
    }
  }
  alpha_out[idx] = acc;
}

// The trigram forward's staged lex: the head product of a (64-state tile,
// 64-label strip) of row b, stored in float32. Padding rows skip (their
// sweeps read no lex). Grid (ceil(V / 64), ceil(S / 64), B).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    lex_kernel(const T* __restrict__ joint,        // [B, S, h]
               const T* __restrict__ vw,           // [h, V]
               const float* __restrict__ vb,       // [V]
               float* __restrict__ lex,            // [B, S, V]
               const int* __restrict__ is_pad_t,   // [B]
               int S, int h, int V) {
  const int b = blockIdx.z;
  if (is_pad_t[b]) return;  // uniform per block
  float val[kTM][kTN];
  lex_tile<T, kComputeStore>(joint + static_cast<size_t>(b) * S * h, vw, vb,
                             lex + static_cast<size_t>(b) * S * V,
                             blockIdx.y * kBM, blockIdx.x * kBN, S, h, V, val);
}

// One trigram expansion of row b into segment p's destinations:
//   out[dest_base(p) + y] = logsumexp_s (vec[s] + lex[s, y])
// over the states s of segment p (p = 0: the start state alone; p >= 1:
// unigram p and the bigrams (q, p), rows V apart). The p = 0 block also
// writes -inf to the start state, which no arc enters; padding rows get
// -inf everywhere. The 256 threads are 4 groups of 64 labels; each group
// keeps an online (max, sum) over every 4th source state, and the groups
// merge through shared memory. Grid (V + 1, B).
__global__ void __launch_bounds__(kThreads)
    segment_sweep_kernel(const float* __restrict__ lex,     // [B, S, V]
                         const float* __restrict__ vec,     // [B, S]
                         const int* __restrict__ is_pad_t,  // [B]
                         float* __restrict__ out,           // [B, S]
                         int S, int V) {
  constexpr int kGroups = kThreads / kBN;
  __shared__ float cand_m[kGroups][kBN];
  __shared__ float cand_l[kGroups][kBN];
  const int p = blockIdx.x, b = blockIdx.y;
  const int lane = threadIdx.x % kBN, group = threadIdx.x / kBN;
  const bool pad = is_pad_t[b] != 0;
  const int sources = p == 0 ? 1 : V + 1;
  const float* vec_b = vec + static_cast<size_t>(b) * S;
  const float* lex_b = lex + static_cast<size_t>(b) * S * V;
  float* out_b = out + static_cast<size_t>(b) * S + dest_base<true>(p, V);
  if (p == 0 && threadIdx.x == 0) out[static_cast<size_t>(b) * S] = -INFINITY;
  for (int y0 = 0; y0 < V; y0 += kBN) {
    const int y = y0 + lane;
    float m = -INFINITY, l = 0.f;
    if (!pad && y < V) {
      for (int i = group; i < sources; i += kGroups) {
        // i = 0: unigram p (the start state for p = 0); i = q: bigram (q, p).
        const int s = i == 0 ? p : 1 + V + (i - 1) * V + (p - 1);
        const float v = vec_b[s] + lex_b[static_cast<size_t>(s) * V + y];
        if (v > m) {
          l = l * expf(m - v) + 1.f;
          m = v;
        } else if (v > -INFINITY) {
          l += expf(v - m);
        }
      }
    }
    cand_m[group][lane] = m;
    cand_l[group][lane] = l;
    __syncthreads();
    if (group == 0 && y < V) {
      for (int r = 1; r < kGroups; ++r) {
        lse_merge(m, l, cand_m[r][lane], cand_l[r][lane]);
      }
      out_b[y] = lse_value(m, l);
    }
    __syncthreads();
  }
}

// Backward reduction over one split of the labels for a 64-state tile of
// row b: the online (max, sum) of lex[b, s, y] + nbv[b, dest_base(s) + y]
// over y, per s. Grid (ceil(S / 64), splits, B); row_merge_kernel combines
// the splits.
template <typename T, int MODE, bool TRI>
__global__ void __launch_bounds__(kThreads)
    row_pass_kernel(const T* __restrict__ joint,       // [B, S, h]
                    const T* __restrict__ vw,          // [h, V]
                    const float* __restrict__ vb,      // [V]
                    const float* __restrict__ nbv,     // [B, S]
                    float* __restrict__ lex,           // [B, S, V] or null
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
  const T* joint_b = joint + static_cast<size_t>(b) * S * h;
  float* lex_b =
      lex == nullptr ? nullptr : lex + static_cast<size_t>(b) * S * V;
  const float* nbv_b = nbv + static_cast<size_t>(b) * S;
  float run_m[kTM], run_l[kTM];
  int base[kTM];  // trigram: each row's destinations
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    run_m[i] = -INFINITY;
    run_l[i] = 0.f;
    base[i] = dest_base<TRI>(s0 + ty * kTM + i, V);
  }
  for (int y0 = y_begin; y0 < y_end; y0 += kBN) {
    float val[kTM][kTN];
    lex_tile<T, MODE>(joint_b, vw, vb, lex_b, s0, y0, S, h, V, val);
    float nb[kTN];  // bigram: every row's destinations are 1 + y
    if (!TRI) {
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const int y = y0 + tx * kTN + j;
        nb[j] = y < V ? nbv_b[1 + y] : -INFINITY;
      }
    }
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      float v[kTN];
      float m = -INFINITY;
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const int y = y0 + tx * kTN + j;
        const float n =
            !TRI ? nb[j] : (y < V ? nbv_b[base[i] + y] : -INFINITY);
        v[j] = val[i][j] + n;
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

// Merges the splits of a backward reduction into the next nb:
// out = logaddexp(blank + beta, lse). The final one writes the next beta
// (held on padding rows), d_blank and its running sum. One thread per
// (b, s) for the states [s_begin, s_begin + s_count). Without g (the
// marginals) the cotangent is 1 and d_blank is the blank posterior; without
// dbb_acc no sum is kept.
__global__ void __launch_bounds__(kPointThreads)
    row_merge_kernel(const float* __restrict__ part_m,
                     const float* __restrict__ part_l, int splits,
                     const int* __restrict__ is_pad_t,
                     const float* __restrict__ blank,  // [B, S]
                     const float* __restrict__ beta,   // [B, S]
                     float* __restrict__ out,          // [B, S]
                     int final_stage, Alphas alphas,
                     const float* __restrict__ log_z,  // [B]
                     const float* __restrict__ g,      // [B] or null
                     float* __restrict__ d_blank,      // [B, S]
                     float* __restrict__ dbb_acc,      // [B, S] or null
                     int B, int S, int s_begin, int s_count) {
  const int i = blockIdx.x * kPointThreads + threadIdx.x;
  if (i >= B * s_count) return;
  const int b = i / s_count;
  const size_t idx = static_cast<size_t>(b) * S + s_begin + i % s_count;
  const float bt = beta[idx];
  if (is_pad_t[b]) {
    if (final_stage) {
      out[idx] = bt;
      d_blank[idx] = 0.f;
    }
    return;
  }
  float m = -INFINITY, l = 0.f;
  // Unrolled so that the loads of several splits are in flight at once:
  // with few rows (one chunk of states) the merge is latency-bound.
#pragma unroll 8
  for (int z = 0; z < splits; ++z) {
    const size_t at = static_cast<size_t>(z) * B * S + idx;
    lse_merge(m, l, part_m[at], part_l[at]);
  }
  const float bl = blank[idx];
  out[idx] = log_add(bl + bt, lse_value(m, l));
  if (final_stage) {
    const float lz = log_z[b];
    float total = 0.f;
    for (int j = 0; j < alphas.n; ++j) {
      total += expf(alphas.a[j][idx] + bl + bt - lz);
    }
    const float db = g == nullptr ? total : g[b] * total;
    d_blank[idx] = db;
    if (dbb_acc != nullptr) dbb_acc[idx] += db;
  }
}

// The lexical marginals of one (64-state tile, 64-label strip) of row b,
//   m[s, y] = gb * sum_p exp(a_p[s] + lex[s, y] + nb_p[dest_base(s) + y]
//                            - log_z)
// with gb = g[b] (1 without g), lex staged (kLoad) or from the head product
// (kCompute). The tiles run over the states [s_begin, s_begin + s_count).
// With d_lex ([B, s_count, V], row s at s - s_begin) the tile is stored
// there rounded to T, and the column sums are of the rounded values; without
// it, of m. Column sums go to col[b, tile, y], added (accumulate) or
// written. Padding rows write zero d_lex and no column sums. Grid
// (ceil(V / 64), ceil(s_count / 64), B).
template <typename T, int MODE, bool TRI>
__global__ void __launch_bounds__(kThreads)
    marginal_kernel(const T* __restrict__ joint,        // [B, S, h]
                    const T* __restrict__ vw,           // [h, V]
                    const float* __restrict__ vb,       // [V]
                    float* __restrict__ lex,            // [B, S, V] or null
                    Pairs pairs,
                    const float* __restrict__ log_z,    // [B]
                    const float* __restrict__ g,        // [B] or null
                    const int* __restrict__ is_pad_t,   // [B]
                    T* __restrict__ d_lex,              // or null
                    float* __restrict__ col,            // [B, tiles, V]
                    int accumulate, int S, int h, int V, int s_begin,
                    int s_count, int tiles) {
  __shared__ float cand[kBM / kTM][kBN];
  const int b = blockIdx.z;
  const int y0 = blockIdx.x * kBN;
  const int tile = s_begin / kBM + blockIdx.y;
  const int s0 = tile * kBM;
  const int s_end = s_begin + s_count;
  const int tid = threadIdx.x;
  const int tx = tid % (kBN / kTN), ty = tid / (kBN / kTN);
  const size_t row0 = static_cast<size_t>(b) * S;
  T* d_lex_b = d_lex == nullptr
                   ? nullptr
                   : d_lex + static_cast<size_t>(b) * s_count * V;
  if (is_pad_t[b]) {  // uniform per block
    if (d_lex_b == nullptr) return;
    for (int i = 0; i < kTM; ++i) {
      const int s = s0 + ty * kTM + i;
      for (int j = 0; j < kTN; ++j) {
        const int y = y0 + tx * kTN + j;
        if (s < s_end && y < V) {
          d_lex_b[static_cast<size_t>(s - s_begin) * V + y] =
              from_float<T>(0.f);
        }
      }
    }
    return;
  }
  float val[kTM][kTN];
  lex_tile<T, MODE>(joint + row0 * h, vw, vb,
                    lex == nullptr ? nullptr : lex + row0 * V, s0, y0, S, h,
                    V, val);
  const float lz = log_z[b], gb = g == nullptr ? 1.f : g[b];
  float sums[kTN];
#pragma unroll
  for (int j = 0; j < kTN; ++j) sums[j] = 0.f;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int s = s0 + ty * kTM + i;
    if (s >= s_end) continue;
    const size_t dest0 = row0 + dest_base<TRI>(s, V);
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int y = y0 + tx * kTN + j;
      if (y >= V) continue;
      float total = 0.f;
      for (int p = 0; p < pairs.n; ++p) {
        total += expf(pairs.a[p][row0 + s] + val[i][j] +
                      pairs.nb[p][dest0 + y] - lz);
      }
      float m = gb * total;
      if (d_lex_b != nullptr) {
        const T d = from_float<T>(m);
        d_lex_b[static_cast<size_t>(s - s_begin) * V + y] = d;
        m = to_float(d);
      }
      sums[j] += m;
    }
  }
#pragma unroll
  for (int j = 0; j < kTN; ++j) cand[ty][tx * kTN + j] = sums[j];
  __syncthreads();
  if (tid < kBN && y0 + tid < V) {
    float total = 0.f;
    for (int r = 0; r < kBM / kTM; ++r) total += cand[r][tid];
    float* out = col + (static_cast<size_t>(b) * tiles + tile) * V + y0 + tid;
    *out = accumulate ? *out + total : total;
  }
}

// lp[b, y] = sum over state tiles of part[b, tile, y]; zero on padding rows.
// One thread per (b, y).
__global__ void __launch_bounds__(kPointThreads)
    label_sum_kernel(const float* __restrict__ part,  // [B, tiles, V]
                     const int* __restrict__ is_pad_t,
                     float* __restrict__ lp,  // [B, V]
                     int B, int tiles, int V) {
  const int idx = blockIdx.x * kPointThreads + threadIdx.x;
  if (idx >= B * V) return;
  const int b = idx / V, y = idx % V;
  float total = 0.f;
  if (!is_pad_t[b]) {
    for (int st = 0; st < tiles; ++st) {
      total += part[(static_cast<size_t>(b) * tiles + st) * V + y];
    }
  }
  lp[idx] = total;
}

// dvw_acc[split] += joint^T d_lex over the split's range of the chunk's
// rows: (b, s) for every b and s in [s_begin, s_begin + s_count), b major;
// d_lex holds the chunk ([B, s_count, V]). A chunk of all S states is one
// run of B*S rows. Grid (ceil(V / 64), ceil(h / 64), splits).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    head_grad_kernel(const T* __restrict__ joint,   // [B, S, h]
                     const T* __restrict__ d_lex,   // [B, s_count, V]
                     float* __restrict__ dvw_acc,   // [splits, h, V]
                     int B, int S, int s_begin, int s_count, int h, int V,
                     int rows_per_split) {
  const int y0 = blockIdx.x * kBN;
  const int h0 = blockIdx.y * kBM;
  const int rows = B * s_count;
  const int r0 = blockIdx.z * rows_per_split;
  const int r1 = min(rows, r0 + rows_per_split);
  if (r0 >= r1) return;
  float acc[kTM][kTN];
  if (s_count == S) {
    tile_product<true, false>(joint + static_cast<size_t>(r0) * h, h,
                              d_lex + static_cast<size_t>(r0) * V, V, h0, y0,
                              h, V, r1 - r0, acc);
  } else {
    // One product per batch row in the range (the rows of the joint jump
    // from one row's chunk to the next's).
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
#pragma unroll
      for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;
    }
    for (int r = r0; r < r1;) {
      const int b = r / s_count, s = r % s_count;
      const int n = min(r1 - r, s_count - s);
      float part[kTM][kTN];
      tile_product<true, false>(
          joint + (static_cast<size_t>(b) * S + s_begin + s) * h, h,
          d_lex + static_cast<size_t>(r) * V, V, h0, y0, h, V, n, part);
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] += part[i][j];
      }
      r += n;
    }
  }
  const int tx = threadIdx.x % (kBN / kTN), ty = threadIdx.x / (kBN / kTN);
  float* out = dvw_acc + static_cast<size_t>(blockIdx.z) * h * V;
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

// d_joint = d_lex vocab_w^T + d_blank blank_w for a (state tile, hidden
// tile) of row b, then d_pre = d_joint (1 - joint32^2) into dpc_acc, its
// state sums into dpf_part and the blank-head sums into dbw_acc. The tiles
// run over the chunk's states [s_begin, s_begin + s_count), whose d_lex is
// [B, s_count, V]. Grid (ceil(h / 64), ceil(s_count / 64), B).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    joint_grad_kernel(const T* __restrict__ d_lex,      // [B, s_count, V]
                      const T* __restrict__ vw,         // [h, V]
                      const float* __restrict__ bw32,   // [h]
                      const float* __restrict__ d_blank,  // [B, S]
                      const float* __restrict__ pc,     // [S, h]
                      const float* __restrict__ pf_t,   // [B, h]
                      const int* __restrict__ is_pad_t,  // [B]
                      float* __restrict__ dpc_acc,      // [B, S, h]
                      float* __restrict__ dpf_part,     // [tiles, B, h]
                      float* __restrict__ dbw_acc,      // [B, tiles, h]
                      int S, int h, int V, int s_begin, int s_count,
                      int tiles) {
  __shared__ float cand_f[kBM / kTM][kBN];
  __shared__ float cand_w[kBM / kTM][kBN];
  const int b = blockIdx.z;
  if (is_pad_t[b]) return;  // dpf_reduce_kernel writes the zero row
  const int B = gridDim.z;
  const int h0 = blockIdx.x * kBN;
  const int tile = s_begin / kBM + blockIdx.y;
  const int s0 = tile * kBM;
  const int tid = threadIdx.x;
  const int tx = tid % (kBN / kTN), ty = tid / (kBN / kTN);
  float acc[kTM][kTN];
  tile_product<false, true>(d_lex + static_cast<size_t>(b) * s_count * V, V,
                            vw, V, s0 - s_begin, h0, s_count, h, V, acc);
  float col_f[kTN], col_w[kTN];
#pragma unroll
  for (int j = 0; j < kTN; ++j) col_f[j] = col_w[j] = 0.f;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int s = s0 + ty * kTM + i;
    if (s >= s_begin + s_count) continue;
    const float db = d_blank[static_cast<size_t>(b) * S + s];
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int hh = h0 + tx * kTN + j;
      if (hh >= h) continue;
      const float jt = tanhf(pc[static_cast<size_t>(s) * h + hh] +
                             pf_t[static_cast<size_t>(b) * h + hh]);
      const float dp = (acc[i][j] + db * bw32[hh]) * (1.f - jt * jt);
      dpc_acc[(static_cast<size_t>(b) * S + s) * h + hh] += dp;
      col_f[j] += dp;
      col_w[j] += jt * db;
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
    for (int r = 0; r < kBM / kTM; ++r) {
      sf += cand_f[r][tid];
      sw += cand_w[r][tid];
    }
    dpf_part[(static_cast<size_t>(tile) * B + b) * h + h0 + tid] = sf;
    dbw_acc[(static_cast<size_t>(b) * tiles + tile) * h + h0 + tid] += sw;
  }
}

// dpf[t, b] = sum over state tiles of dpf_part; zero on padding rows.
__global__ void __launch_bounds__(kPointThreads)
    dpf_reduce_kernel(const float* __restrict__ dpf_part,
                      const int* __restrict__ is_pad_t,
                      float* __restrict__ dpf_t,  // [B, h]
                      int B, int h, int tiles) {
  const int idx = blockIdx.x * kPointThreads + threadIdx.x;
  if (idx >= B * h) return;
  float total = 0.f;
  if (!is_pad_t[idx / h]) {
    for (int st = 0; st < tiles; ++st) {
      total += dpf_part[static_cast<size_t>(st) * B * h + idx];
    }
  }
  dpf_t[idx] = total;
}

// out[i] = sum_r in[r * n + i].
__global__ void __launch_bounds__(kPointThreads)
    sum_rows_kernel(const float* __restrict__ in, int rows, int n,
                    float* __restrict__ out) {
  const int idx = blockIdx.x * kPointThreads + threadIdx.x;
  if (idx >= n) return;
  float total = 0.f;
  for (int r = 0; r < rows; ++r) total += in[static_cast<size_t>(r) * n + idx];
  out[idx] = total;
}

#define RETURN_IF_LAUNCH_FAILED()                          \
  do {                                                     \
    const cudaError_t err = cudaGetLastError();            \
    if (err != cudaSuccess) return static_cast<int>(err);  \
  } while (0)

inline int blocks_for(size_t n) {
  return static_cast<int>((n + kPointThreads - 1) / kPointThreads);
}

// The float32 forward (both modes).
int run_forward(const float* pf, const float* pc, const float* vw,
                const float* vb, const float* bw, const float* bb,
                const int* is_pad, float* joint, float* blank, float* lex,
                float* part_m, float* part_l, float* last, float* alpha,
                float* hist, float* slabs, int num_frames, int B, int S,
                int h, int V, int max_expansions, int frame_dependent,
                int online, int max_splits, cudaStream_t stream) {
  const int passes = frame_dependent ? 1 : max_expansions;
  // Online: every reduction recomputes the product (no lex buffer).
  const bool stage = !online && passes >= 2;
  const size_t bs = static_cast<size_t>(B) * S;
  const int tiles = (S + kBM - 1) / kBM;
  const int tiles_per_split =
      (tiles + max_splits - 1) / (max_splits > 0 ? max_splits : 1);
  const int splits = (tiles + tiles_per_split - 1) / tiles_per_split;
  const dim3 joint_grid(S, B);
  const dim3 pass_grid((V + kBN - 1) / kBN, splits, B);
  for (int t = 0; t < num_frames; ++t) {
    const float* alpha_cur = alpha + (t % 2) * bs;
    float* alpha_next = alpha + ((t + 1) % 2) * bs;
    const int* is_pad_t = is_pad + static_cast<size_t>(t) * B;
    joint_blank_kernel<float><<<joint_grid, kJointThreads, 0, stream>>>(
        pf + static_cast<size_t>(t) * B * h, is_pad_t, pc, bw, bb, nullptr,
        nullptr, joint, nullptr, blank, S, h, h, 0);
    RETURN_IF_LAUNCH_FAILED();
    // The j-th expansion of the frame: a slab, or a scratch row.
    float* last_t = slabs != nullptr ? slabs + t * bs : last;
    const size_t last_stride =
        slabs != nullptr ? static_cast<size_t>(num_frames) * bs : bs;
    const float* vec = alpha_cur;
    for (int j = 0; j < passes; ++j) {
      if (!stage) {
        col_pass_kernel<kCompute><<<pass_grid, kThreads, 0, stream>>>(
            joint, vw, vb, vec, nullptr, part_m, part_l, is_pad_t, S, h, V,
            tiles_per_split);
      } else if (j == 0) {
        col_pass_kernel<kComputeStore><<<pass_grid, kThreads, 0, stream>>>(
            joint, vw, vb, vec, lex, part_m, part_l, is_pad_t, S, h, V,
            tiles_per_split);
      } else {
        col_pass_kernel<kLoad><<<pass_grid, kThreads, 0, stream>>>(
            joint, vw, vb, vec, lex, part_m, part_l, is_pad_t, S, h, V,
            tiles_per_split);
      }
      RETURN_IF_LAUNCH_FAILED();
      float* red = last_t + j * last_stride;
      col_merge_kernel<<<blocks_for(static_cast<size_t>(B) * V),
                         kPointThreads, 0, stream>>>(part_m, part_l, is_pad_t,
                                                     red, splits, B, S, V);
      RETURN_IF_LAUNCH_FAILED();
      vec = red;
    }
    update_kernel<<<blocks_for(bs), kPointThreads, 0, stream>>>(
        alpha_cur, blank, last_t, last_stride, is_pad_t, alpha_next,
        hist != nullptr ? hist + t * bs : nullptr, B, S, passes,
        frame_dependent);
    RETURN_IF_LAUNCH_FAILED();
  }
  return 0;
}

// The trigram forward: per frame the joint and blank, lex staged (when a
// sweep reads it), the segment sweeps, and the update of the bigram mode.
template <typename T>
int run_trigram_forward(const float* pf, const float* pc, const T* vw,
                        const float* vb, const T* bw, const float* bb,
                        const int* is_pad, T* joint, float* blank, float* lex,
                        float* last, float* alpha, float* hist, float* slabs,
                        int num_frames, int B, int S, int h, int V,
                        int max_expansions, int frame_dependent,
                        cudaStream_t stream) {
  const int passes = frame_dependent ? 1 : max_expansions;
  const size_t bs = static_cast<size_t>(B) * S;
  const dim3 joint_grid(S, B);
  const dim3 lex_grid((V + kBN - 1) / kBN, (S + kBM - 1) / kBM, B);
  const dim3 sweep_grid(V + 1, B);
  for (int t = 0; t < num_frames; ++t) {
    const float* alpha_cur = alpha + (t % 2) * bs;
    float* alpha_next = alpha + ((t + 1) % 2) * bs;
    const int* is_pad_t = is_pad + static_cast<size_t>(t) * B;
    joint_blank_kernel<T><<<joint_grid, kJointThreads, 0, stream>>>(
        pf + static_cast<size_t>(t) * B * h, is_pad_t, pc, bw, bb, nullptr,
        nullptr, joint, nullptr, blank, S, h, h, 0);
    RETURN_IF_LAUNCH_FAILED();
    if (passes > 0) {
      lex_kernel<T><<<lex_grid, kThreads, 0, stream>>>(joint, vw, vb, lex,
                                                       is_pad_t, S, h, V);
      RETURN_IF_LAUNCH_FAILED();
    }
    float* last_t = slabs != nullptr ? slabs + t * bs : last;
    const size_t last_stride =
        slabs != nullptr ? static_cast<size_t>(num_frames) * bs : bs;
    const float* vec = alpha_cur;
    for (int j = 0; j < passes; ++j) {
      float* red = last_t + j * last_stride;
      segment_sweep_kernel<<<sweep_grid, kThreads, 0, stream>>>(
          lex, vec, is_pad_t, red, S, V);
      RETURN_IF_LAUNCH_FAILED();
      vec = red;
    }
    update_kernel<<<blocks_for(bs), kPointThreads, 0, stream>>>(
        alpha_cur, blank, last_t, last_stride, is_pad_t, alpha_next,
        hist != nullptr ? hist + t * bs : nullptr, B, S, passes,
        frame_dependent);
    RETURN_IF_LAUNCH_FAILED();
  }
  return 0;
}

// What the reverse scans (backward and marginals) share: their sizes, and
// one frame's beta step.
struct ReverseScan {
  int B, S, h, V, k, passes, frame_dependent, tiles, strips,
      strips_per_split, ysplits;

  ReverseScan(int B_, int S_, int h_, int V_, int max_expansions,
              int frame_dependent_, int max_ysplits)
      : B(B_), S(S_), h(h_), V(V_), frame_dependent(frame_dependent_) {
    k = frame_dependent ? 0 : max_expansions;
    passes = frame_dependent ? 1 : max_expansions;
    tiles = (S + kBM - 1) / kBM;
    strips = (V + kBN - 1) / kBN;
    strips_per_split =
        (strips + max_ysplits - 1) / (max_ysplits > 0 ? max_ysplits : 1);
    ysplits = (strips + strips_per_split - 1) / strips_per_split;
  }

  // Frame t of T: joint and blank, then the row reductions (FD once on
  // beta; FLD on nb_{k-1}, ..., nb_0, each giving the nb below it and the
  // last the next beta, d_blank and its sum). With `lex` the first stores
  // the frame's lex and the others read it; without, each recomputes the
  // product (online). Fills the frame's slabs and (a_j, nb_j) pairs.
  template <typename T, bool TRI>
  int step(int t, int T_, const float* pf, const int* is_pad,
           const float* pc, const T* vw, const float* vb, const T* bw,
           const float* bb, const float* log_z, const float* g,
           const float* hist, const float* slabs, T* joint, float* blank,
           float* lex, float* part_m, float* part_l, float* nb,
           const float* beta_cur, float* beta_next, float* d_blank,
           float* dbb_acc, int zero_pad, Pairs& pairs,
           cudaStream_t stream) const {
    const size_t bs = static_cast<size_t>(B) * S;
    const int* is_pad_t = is_pad + static_cast<size_t>(t) * B;
    joint_blank_kernel<T><<<dim3(S, B), kJointThreads, 0, stream>>>(
        pf + static_cast<size_t>(t) * B * h, is_pad_t, pc, bw, bb, beta_cur,
        k >= 1 ? nb + (k - 1) * bs : nullptr, joint, nullptr, blank, S, h, h,
        zero_pad);
    RETURN_IF_LAUNCH_FAILED();
    Alphas alphas;
    alphas.n = 1 + k;
    alphas.a[0] = hist + t * bs;
    for (int j = 0; j < k; ++j) {
      alphas.a[1 + j] = slabs + (static_cast<size_t>(j) * T_ + t) * bs;
    }
    const dim3 row_grid(tiles, ysplits, B);
    for (int p = 0; p < passes; ++p) {
      const float* nbv = frame_dependent ? beta_cur : nb + (k - 1 - p) * bs;
      if (lex == nullptr) {
        row_pass_kernel<T, kCompute, TRI><<<row_grid, kThreads, 0, stream>>>(
            joint, vw, vb, nbv, nullptr, part_m, part_l, is_pad_t, S, h, V,
            strips_per_split);
      } else if (p == 0) {
        row_pass_kernel<T, kComputeStore, TRI>
            <<<row_grid, kThreads, 0, stream>>>(
            joint, vw, vb, nbv, lex, part_m, part_l, is_pad_t, S, h, V,
            strips_per_split);
      } else {
        row_pass_kernel<T, kLoad, TRI><<<row_grid, kThreads, 0, stream>>>(
            joint, vw, vb, nbv, lex, part_m, part_l, is_pad_t, S, h, V,
            strips_per_split);
      }
      RETURN_IF_LAUNCH_FAILED();
      const bool final_stage = p == passes - 1;
      row_merge_kernel<<<blocks_for(bs), kPointThreads, 0, stream>>>(
          part_m, part_l, ysplits, is_pad_t, blank, beta_cur,
          final_stage ? beta_next : nb + (k - 2 - p) * bs, final_stage,
          alphas, log_z, g, d_blank, dbb_acc, B, S, 0, S);
      RETURN_IF_LAUNCH_FAILED();
    }
    if (passes == 0) {  // FLD(0): the next beta is blank + beta
      row_merge_kernel<<<blocks_for(bs), kPointThreads, 0, stream>>>(
          part_m, part_l, 0, is_pad_t, blank, beta_cur, beta_next, 1, alphas,
          log_z, g, d_blank, dbb_acc, B, S, 0, S);
      RETURN_IF_LAUNCH_FAILED();
    }
    pairs.n = passes;
    if (frame_dependent) {
      pairs.a[0] = alphas.a[0];
      pairs.nb[0] = beta_cur;
    } else {
      for (int j = 0; j < k; ++j) {
        pairs.a[j] = alphas.a[j];
        pairs.nb[j] = nb + j * bs;
      }
    }
    return 0;
  }
};

// ---------------------------------------------------------------------------
// The bfloat16 backward of the bigram on wgmma (FD and FLD(k >= 1)), in
// either mode: 'cache' forms d_lex for all S states at once, 'online' for
// a chunk of them at a time.
namespace hopper {

using namespace head_grads;
using wgmma_tiles::kBK;
using wgmma_tiles::kBN;

// One row reduction of a frame over its live rows and the states
// [s_begin, s_begin + s_count) (s_begin a multiple of 64): the head
// product of a (64-state tile, 128-label strip) on wgmma, A = joint [B, S,
// hp] (K-major), B = vw [hp, Vp] (MN-major), then lex = product + vb and
// the strip's online (max, sum) of lex + nbv[1 + y] per state into part_m /
// part_l [strips, B, S]. The last reduction of the frame (Last) also forms
// the lexical marginals
//   d_lex[s, y] = bf16(g * sum_p exp(a_p[s] + lex[s, y] + nb_p[1 + y]
//                                    - log_z))
// into d_lex [B, s_count, Vp] (row s at s - s_begin, zero past V), and adds
// their column sums over the tile to dvb [B, ceil(S / 64), V].
struct LexPass {
  const float* vb;       // [V]
  const float* nbv;      // [B, S]
  float* part_m;         // [strips, B, S]
  float* part_l;
  const int* rows;       // the frame's live rows first
  Pairs pairs;
  const float* log_z;    // [B]
  const float* g;        // [B]
  bf16* d_lex;
  float* dvb;
  int B, S, hp, V, Vp;
  int s_begin, s_count;  // the states of this launch
};

// Epilogue scratch: the strip's vb and nbv[1 + y] (and each pair's
// nb_p[1 + y] when their count is known), and for the last reduction per
// consumer warp a row of kBN column sums.
template <int NPairs>
constexpr int lex_pass_extra() {
  return ((2 + (NPairs > 0 ? NPairs : 0)) * kBN +
          (NPairs != 0 ? 4 * kBN : 0)) * 4;
}

// NPairs > 0: the last reduction with that many (a_p, nb_p) pairs, known
// at compile time (FD, FLD(1): 1; FLD(2): 2); -1: the last reduction with
// pairs.n of them; 0: an earlier reduction. Marginals (a last reduction of
// the marginals scan, run_marginals): g = 1 (p.g is not read), no d_lex,
// the marginals summed unrounded and their column sums written, not added,
// to dvb (the frame's lp_part). Grid (live rows * ceil(s_count / 64),
// ceil(Vp / 128)).
template <int NPairs, bool Marginals = false>
__global__ void __launch_bounds__(wgmma_tiles::kThreads, 2)
    lex_pass_kernel(const __grid_constant__ Maps maps, const LexPass p) {
  constexpr bool Last = NPairs != 0;
  static_assert(Last || !Marginals, "the marginals are a last reduction");
  extern __shared__ uint8_t raw[];
  const Ring<4> ring(raw);
  const int launch_tiles = cdiv(p.s_count, 64);
  const int b = p.rows[blockIdx.x / launch_tiles];
  const int s0 = p.s_begin + blockIdx.x % launch_tiles * 64;
  const int n0 = blockIdx.y * kBN, s_end = p.s_begin + p.s_count;
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
  constexpr int kP = NPairs > 0 ? NPairs : 1;
  float* vb = reinterpret_cast<float*>(ring.extra);  // [kBN]
  float* nbv = vb + kBN;                             // [kBN]
  float* nbq = nbv + kBN;                            // [NPairs][kBN]
  float* red = nbq + (NPairs > 0 ? NPairs : 0) * kBN;  // [warps][kBN]
  {
    const int t = threadIdx.x, y = n0 + t;
    const bool in = y < p.V;
    vb[t] = in ? p.vb[y] : 0.f;
    nbv[t] = in ? p.nbv[row0 + 1 + y] : -INFINITY;
    if constexpr (NPairs > 0) {
#pragma unroll
      for (int q = 0; q < kP; ++q) {
        nbq[q * kBN + t] = in ? p.pairs.nb[q][row0 + 1 + y] : 0.f;
      }
    }
  }
  named_barrier(1, wgmma_tiles::kConsumers);
  float d[64];
  consume<false, true>(ring, 1, p.hp / kBK, d, [](int, float(&)[64]) {});
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int srow[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) srow[half] = s0 + acc_row(half * 2);
  // d becomes lex (the entries past S or V are never read).
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float bias = vb[j * 8 + (lane % 4) * 2 + e];
#pragma unroll
      for (int half = 0; half < 2; ++half) d[j * 4 + half * 2 + e] += bias;
    }
  }
  // The strip's (max, sum) per state; the 4 lanes of a row share it.
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int y = n0 + j * 8 + (lane % 4) * 2 + e;
      if (y < p.V) {
        const float nb = nbv[y - n0];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          m[half] = fmaxf(m[half], d[j * 4 + half * 2 + e] + nb);
        }
      }
    }
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    for (int o = 1; o < 4; o <<= 1) {
      m[half] = fmaxf(m[half], __shfl_xor_sync(0xffffffffu, m[half], o));
    }
  }
  const float lz = Last ? p.log_z[b] : 0.f;
  const float gb = Last && !Marginals ? p.g[b] : 0.f;
  // The marginal of a total over the pairs: rounded to bfloat16 with the
  // cotangent for d_lex, or the posterior itself.
  auto marginal = [&](float total) {
    if constexpr (Marginals) {
      return total;
    } else {
      return __bfloat162float(__float2bfloat16(gb * total));
    }
  };
  // Stores the marginals dv of the thread's 2 x 2 entries of column group j
  // to d_lex (not in the marginals scan) and their column sums to red.
  auto put_marginals = [&](int j, const float (&dv)[2][2]) {
    const int y0 = n0 + j * 8 + (lane % 4) * 2;
    float cs[2] = {dv[0][0] + dv[1][0], dv[0][1] + dv[1][1]};
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int s = srow[half];
      if (!Marginals && s < s_end && y0 < p.Vp) {
        const size_t at =
            static_cast<size_t>(b) * p.s_count + (s - p.s_begin);
        *reinterpret_cast<__nv_bfloat162*>(p.d_lex + at * p.Vp + y0) =
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
  };
  if constexpr (NPairs > 0) {
    // The row sums and the marginals in one pass. Pair 0's nb is nbv, so
    // its term exp(a_0 + lex + nb_0 - log_z) is the row sum's exp(lex + nbv
    // - m) times exp(a_0 - log_z + m), at most about 1 (an arc's
    // posterior).
    float arow[kP][2], f0[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
#pragma unroll
      for (int q = 0; q < kP; ++q) {
        arow[q][half] = srow[half] < s_end
                            ? p.pairs.a[q][row0 + srow[half]] - lz
                            : -INFINITY;
      }
      f0[half] = expf(arow[0][half] + safe_shift(m[half]));
    }
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      float dv[2][2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = j * 8 + (lane % 4) * 2 + e, y = n0 + c;
        float nbq_y[kP];
#pragma unroll
        for (int q = 1; q < kP; ++q) nbq_y[q] = nbq[q * kBN + c];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float v = 0.f;
          if (srow[half] < s_end && y < p.V) {
            const float x = d[j * 4 + half * 2 + e];
            const float row = expf(x + nbv[c] - safe_shift(m[half]));
            l[half] += row;
            float total = row * f0[half];
#pragma unroll
            for (int q = 1; q < kP; ++q) {
              total += expf(arow[q][half] + x + nbq_y[q]);
            }
            v = marginal(total);
          }
          dv[half][e] = v;
        }
      }
      put_marginals(j, dv);
    }
  } else {
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int y = n0 + j * 8 + (lane % 4) * 2 + e;
        if (y < p.V) {
          const float nb = nbv[y - n0];
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            l[half] += expf(d[j * 4 + half * 2 + e] + nb - safe_shift(m[half]));
          }
        }
      }
    }
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    for (int o = 1; o < 4; o <<= 1) {
      l[half] += __shfl_xor_sync(0xffffffffu, l[half], o);
    }
    const int s = srow[half];
    if (lane % 4 == 0 && s < s_end) {
      const size_t at = (static_cast<size_t>(blockIdx.y) * p.B + b) * p.S + s;
      p.part_m[at] = m[half];
      p.part_l[at] = l[half];
    }
  }
  if constexpr (NPairs < 0) {  // the marginals, any number of pairs
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      float dv[2][2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int y = n0 + j * 8 + (lane % 4) * 2 + e;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int s = srow[half];
          float v = 0.f;
          if (s < s_end && y < p.V) {
            const float x = d[j * 4 + half * 2 + e] - lz;
            float total = 0.f;
            for (int q = 0; q < p.pairs.n; ++q) {
              total += expf(p.pairs.a[q][row0 + s] + x +
                            p.pairs.nb[q][row0 + 1 + y]);
            }
            v = marginal(total);
          }
          dv[half][e] = v;
        }
      }
      put_marginals(j, dv);
    }
  }
  if constexpr (Last) {
    named_barrier(1, wgmma_tiles::kConsumers);
    const int t = threadIdx.x, y = n0 + t;
    if (y < p.V) {
      float total = 0.f;
#pragma unroll
      for (int w = 0; w < 4; ++w) total += red[w * kBN + t];
      float* out =
          p.dvb + (static_cast<size_t>(b) * cdiv(p.S, 64) + s0 / 64) * p.V + y;
      if constexpr (Marginals) {
        *out = total;
      } else {
        *out += total;
      }
    }
  }
}

template <int NPairs, bool Marginals = false>
cudaError_t launch_lex_pass(const Maps& maps, const LexPass& p, int live,
                            cudaStream_t stream) {
  constexpr int kSmem = smem_bytes(4, lex_pass_extra<NPairs>());
  const cudaError_t err =
      allow_smem<lex_pass_kernel<NPairs, Marginals>>(kSmem);
  if (err != cudaSuccess) return err;
  lex_pass_kernel<NPairs, Marginals>
      <<<dim3(live * cdiv(p.s_count, 64), cdiv(p.Vp, kBN)),
         wgmma_tiles::kThreads, kSmem, stream>>>(maps, p);
  return cudaGetLastError();
}

#define RETURN_IF_ERROR(expr)                               \
  do {                                                      \
    const cudaError_t err = (expr);                         \
    if (err != cudaSuccess) return static_cast<int>(err);   \
  } while (0)

// The frame loop. Per frame t with live[t] > 0 rows (their indices first in
// rows[t]): the joint and blank (joint_blank_kernel, rows hp apart), the
// k - 1 earlier row reductions over all states (lex_pass_kernel<0>, each
// merged by row_merge_kernel), then per chunk of `chunk` states (all S of
// them in 'cache' mode, a multiple of 64 in 'online' mode, the last chunk
// ragged) the last row reduction with the marginals into d_lex [B, chunk,
// Vp], its merge (the next beta and d_blank of the chunk's states) and the
// two gradient products over the live rows (head_grads.cuh), and the
// frame's d(pf). A frame with no live row only holds beta. Then the sums of
// the cross-frame partials.
int run_backward(const float* pf, const float* pc, const bf16* vw,
                 const float* vb, const bf16* bw, const float* bw32,
                 const float* bb, const int* is_pad, const float* log_z,
                 const float* g, const float* hist, const float* slabs,
                 bf16* joint, float* joint32, float* blank, bf16* d_lex,
                 float* d_blank, float* part_m, float* part_l, float* nb,
                 float* beta, float* dpf, float* dpf_part, float* dpc_acc,
                 float* dvw_acc, float* dvb_acc, float* dbw_acc,
                 float* dbb_acc, float* dpc, float* dvw, float* dvb,
                 float* dbw, float* dbb, int T, int B, int S, int h, int V,
                 int max_expansions, int frame_dependent, int ksplits,
                 int dsplits, const int* live, const int* rows, int chunk,
                 cudaStream_t stream) {
  const int k = frame_dependent ? 0 : max_expansions;
  const int passes = frame_dependent ? 1 : max_expansions;
  if (passes < 1 || k + 1 > kMaxAlphas || ksplits < 1 || dsplits < 1 ||
      (T > 0 && live == nullptr) || chunk < 1 ||
      (chunk < S && chunk % 64 != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  chunk = std::min(chunk, S);
  const int hp = round_up(h, kBK), Vp = round_up(V, kBK);
  const int strips = cdiv(Vp, kBN), t64 = cdiv(S, 64);
  const size_t bs = static_cast<size_t>(B) * S;
  // d_lex holds one chunk: a map of the whole chunk and one of the ragged
  // last, so that TMA reads nothing past the buffer.
  Maps maps, last_maps;
  if (B > 0 && S > 0) {
    RETURN_IF_ERROR(make_maps(&maps, joint, d_lex, vw, B, S, chunk, hp, Vp));
    last_maps = maps;
    if (S % chunk != 0) {
      RETURN_IF_ERROR(lex_map(&last_maps.d_lex, d_lex, B, S % chunk, Vp));
    }
  }
  for (int n = 0; n < T; ++n) {
    const int t = T - 1 - n, L = live[t];
    const int* is_pad_t = is_pad + static_cast<size_t>(t) * B;
    const int* rows_t = rows + static_cast<size_t>(t) * B;
    const float* pf_t = pf + static_cast<size_t>(t) * B * h;
    const float* beta_cur = beta + (n % 2) * bs;
    float* beta_next = beta + ((n + 1) % 2) * bs;
    if (L > 0) {
      joint_blank_kernel<bf16><<<dim3(S, B), kJointThreads, 0, stream>>>(
          pf_t, is_pad_t, pc, bw, bb, beta_cur,
          k >= 1 ? nb + (k - 1) * bs : nullptr, joint, joint32, blank, S, h,
          hp, 0);
      RETURN_IF_ERROR(cudaGetLastError());
    }
    Alphas alphas;
    alphas.n = 1 + k;
    alphas.a[0] = hist + t * bs;
    for (int j = 0; j < k; ++j) {
      alphas.a[1 + j] = slabs + (static_cast<size_t>(j) * T + t) * bs;
    }
    Pairs pairs;
    pairs.n = passes;
    for (int j = 0; j < passes; ++j) {
      pairs.a[j] = alphas.a[j];
      pairs.nb[j] = frame_dependent ? beta_cur : nb + j * bs;
    }
    for (int p = 0; p < passes; ++p) {
      const bool last = p == passes - 1;
      LexPass lp{vb, frame_dependent ? beta_cur : nb + (k - 1 - p) * bs,
                 part_m, part_l, rows_t, pairs, log_z, g, d_lex, dvb_acc, B,
                 S, hp, V, Vp, 0, S};
      if (!last) {
        if (L > 0) RETURN_IF_ERROR(launch_lex_pass<0>(maps, lp, L, stream));
        row_merge_kernel<<<blocks_for(bs), kPointThreads, 0, stream>>>(
            part_m, part_l, L > 0 ? strips : 0, is_pad_t, blank, beta_cur,
            nb + (k - 2 - p) * bs, 0, alphas, log_z, g, d_blank, dbb_acc, B,
            S, 0, S);
        RETURN_IF_ERROR(cudaGetLastError());
        continue;
      }
      // The last reduction, chunk by chunk (one chunk of S when no row is
      // live: the merge alone holds beta).
      const int step = L > 0 ? chunk : S;
      for (int s_begin = 0; s_begin < S; s_begin += step) {
        const int count = std::min(step, S - s_begin);
        const Maps& m = count == chunk ? maps : last_maps;
        lp.s_begin = s_begin;
        lp.s_count = count;
        if (L > 0) {
          RETURN_IF_ERROR(
              passes == 1   ? launch_lex_pass<1>(m, lp, L, stream)
              : passes == 2 ? launch_lex_pass<2>(m, lp, L, stream)
                            : launch_lex_pass<-1>(m, lp, L, stream));
        }
        row_merge_kernel<<<blocks_for(static_cast<size_t>(B) * count),
                           kPointThreads, 0, stream>>>(
            part_m, part_l, L > 0 ? strips : 0, is_pad_t, blank, beta_cur,
            beta_next, 1, alphas, log_z, g, d_blank, dbb_acc, B, S, s_begin,
            count);
        RETURN_IF_ERROR(cudaGetLastError());
        if (L > 0) {
          RETURN_IF_ERROR(launch_head_grad(
              m, HeadGrad{rows_t, dvw_acc, L, count, h, V, 1, s_begin}, hp,
              Vp, ksplits, stream));
          RETURN_IF_ERROR(launch_joint_grad(
              m,
              JointGrad{bw32, d_blank, joint32, rows_t, dpf_part, dbw_acc,
                        dpc_acc, L, B, S, h, Vp, 1, s_begin, count},
              hp, std::min(dsplits, L), stream));
        }
      }
    }
    dpf_reduce_kernel<<<blocks_for(static_cast<size_t>(B) * h), kPointThreads,
                        0, stream>>>(dpf_part, is_pad_t,
                                     dpf + static_cast<size_t>(t) * B * h, B,
                                     h, t64);
    RETURN_IF_ERROR(cudaGetLastError());
  }
  const Sums sums{{{dpc_acc, dsplits, S * h, dpc},
                   {dvw_acc, ksplits, h * V, dvw},
                   {dvb_acc, B * t64, V, dvb},
                   {dbw_acc, B * t64, h, dbw},
                   {dbb_acc, B * S, 1, dbb}},
                  5};
  RETURN_IF_ERROR(launch_sums(sums, stream));
  return 0;
}

// The bfloat16 marginals scan (FD, FLD(k >= 1)): run_backward's frame loop
// without its gradient work. Per frame t with live[t] > 0 rows (their
// indices first in rows[t]) the bfloat16 joint and the blank of those rows
// (no float32 joint: no tanh derivative is taken), the k - 1 earlier row
// reductions (lex_pass_kernel<0>, each merged by row_merge_kernel), the
// last with the marginals epilogue (lex_pass_kernel<NPairs, true>: the
// frame's label posteriors per (row, 64-state tile) into lp_part [B,
// ceil(S / 64), V]), its merge with g = 1 (the next beta and the blank
// posteriors bm[t]), and label_sum_kernel (lp[t], zero on padding rows).
// Every reduction recomputes the head product: no [B, S, V] buffer. A frame
// with no live row only holds beta and writes zeros. vw is the padded head
// [hp, Vp], joint [B, S, hp]; part_m / part_l are [ceil(Vp / 128), B, S].
int run_marginals(const float* pf, const float* pc, const bf16* vw,
                  const float* vb, const bf16* bw, const float* bb,
                  const int* is_pad, const float* log_z, const float* hist,
                  const float* slabs, bf16* joint, float* blank,
                  float* part_m, float* part_l, float* nb, float* beta,
                  float* lp_part, float* bm, float* lp, int T, int B, int S,
                  int h, int V, int max_expansions, int frame_dependent,
                  const int* live, const int* rows, cudaStream_t stream) {
  const int k = frame_dependent ? 0 : max_expansions;
  const int passes = frame_dependent ? 1 : max_expansions;
  if (passes < 1 || k + 1 > kMaxAlphas || (T > 0 && live == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int hp = round_up(h, kBK), Vp = round_up(V, kBK);
  const int strips = cdiv(Vp, kBN), t64 = cdiv(S, 64);
  const size_t bs = static_cast<size_t>(B) * S;
  // The products read the joint and the head; there is no d_lex.
  Maps maps{};
  if (B > 0 && S > 0) {
    const cuuint64_t joint_dims[3] = {static_cast<cuuint64_t>(hp),
                                      static_cast<cuuint64_t>(S),
                                      static_cast<cuuint64_t>(B)};
    const cuuint64_t vw_dims[2] = {static_cast<cuuint64_t>(Vp),
                                   static_cast<cuuint64_t>(hp)};
    RETURN_IF_ERROR(box_map(&maps.joint, joint, 3, joint_dims));
    RETURN_IF_ERROR(box_map(&maps.vw, vw, 2, vw_dims));
  }
  for (int n = 0; n < T; ++n) {
    const int t = T - 1 - n, L = live[t];
    const int* is_pad_t = is_pad + static_cast<size_t>(t) * B;
    const int* rows_t = rows + static_cast<size_t>(t) * B;
    const float* beta_cur = beta + (n % 2) * bs;
    float* beta_next = beta + ((n + 1) % 2) * bs;
    if (L > 0) {
      joint_blank_kernel<bf16><<<dim3(S, B), kJointThreads, 0, stream>>>(
          pf + static_cast<size_t>(t) * B * h, is_pad_t, pc, bw, bb,
          beta_cur, k >= 1 ? nb + (k - 1) * bs : nullptr, joint, nullptr,
          blank, S, h, hp, 0);
      RETURN_IF_ERROR(cudaGetLastError());
    }
    Alphas alphas;
    alphas.n = 1 + k;
    alphas.a[0] = hist + t * bs;
    for (int j = 0; j < k; ++j) {
      alphas.a[1 + j] = slabs + (static_cast<size_t>(j) * T + t) * bs;
    }
    Pairs pairs;
    pairs.n = passes;
    for (int j = 0; j < passes; ++j) {
      pairs.a[j] = alphas.a[j];
      pairs.nb[j] = frame_dependent ? beta_cur : nb + j * bs;
    }
    for (int p = 0; p < passes; ++p) {
      const bool last = p == passes - 1;
      const LexPass lp{vb, frame_dependent ? beta_cur : nb + (k - 1 - p) * bs,
                       part_m, part_l, rows_t, pairs, log_z, nullptr,
                       nullptr, lp_part, B, S, hp, V, Vp, 0, S};
      if (L > 0) {
        RETURN_IF_ERROR((
            !last         ? launch_lex_pass<0>(maps, lp, L, stream)
            : passes == 1 ? launch_lex_pass<1, true>(maps, lp, L, stream)
            : passes == 2 ? launch_lex_pass<2, true>(maps, lp, L, stream)
                          : launch_lex_pass<-1, true>(maps, lp, L, stream)));
      }
      row_merge_kernel<<<blocks_for(bs), kPointThreads, 0, stream>>>(
          part_m, part_l, L > 0 ? strips : 0, is_pad_t, blank, beta_cur,
          last ? beta_next : nb + (k - 2 - p) * bs, last, alphas, log_z,
          nullptr, bm + t * bs, nullptr, B, S, 0, S);
      RETURN_IF_ERROR(cudaGetLastError());
    }
    label_sum_kernel<<<blocks_for(static_cast<size_t>(B) * V), kPointThreads,
                       0, stream>>>(lp_part, is_pad_t,
                                    lp + static_cast<size_t>(t) * B * V, B,
                                    t64, V);
    RETURN_IF_ERROR(cudaGetLastError());
  }
  return 0;
}

// The frame's last merge folded into its update; one thread per (b, s).
// The last expansion red[b, s] merges the partials of label s - 1 (-inf at
// state 0 and on padding rows) and is written to last + (passes - 1) *
// last_stride; then alpha as update_kernel updates it (passes >= 1).
__global__ void __launch_bounds__(kPointThreads)
    merge_update_kernel(const float* __restrict__ part_m,  // [splits, B, V]
                        const float* __restrict__ part_l, int splits,
                        const float* __restrict__ alpha,   // [B, S]
                        const float* __restrict__ blank,   // [B, S]
                        float* __restrict__ last, size_t last_stride,
                        const int* __restrict__ is_pad_t,  // [B]
                        float* __restrict__ alpha_out,     // [B, S]
                        float* __restrict__ hist_t,        // [B, S] or null
                        int B, int S, int V, int passes,
                        int frame_dependent) {
  const int idx = blockIdx.x * kPointThreads + threadIdx.x;
  if (idx >= B * S) return;
  const int b = idx / S, s = idx % S;
  const bool pad = is_pad_t[b];
  float m = -INFINITY, l = 0.f;
  if (!pad && s >= 1) {
    for (int z0 = 0; z0 < splits; z0 += 8) {  // 8 splits' loads in flight
      float pm[8], pl[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const size_t at = (static_cast<size_t>(z0 + i) * B + b) * V + s - 1;
        pm[i] = z0 + i < splits ? part_m[at] : -INFINITY;
        pl[i] = z0 + i < splits ? part_l[at] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (z0 + i < splits) lse_merge(m, l, pm[i], pl[i]);
      }
    }
  }
  const float red = lse_value(m, l);
  last[(passes - 1) * last_stride + idx] = red;
  const float a = alpha[idx];
  if (hist_t != nullptr) hist_t[idx] = a;
  if (pad) {
    alpha_out[idx] = a;
    return;
  }
  const float bl = blank[idx];
  float acc = a + bl;
  if (frame_dependent) {
    acc = log_add(acc, red);
  } else {
    for (int j = 0; j + 1 < passes; ++j) {
      acc = log_add(acc, last[j * last_stride + idx] + bl);
    }
    acc = log_add(acc, red + bl);
  }
  alpha_out[idx] = acc;
}

// The bfloat16 forward (FD, FLD(k)), either mode, on head_product.cuh.
// Once per call the padded head vw16 [hp, Vp]; per frame t with live[t] >
// 0 rows (their indices first in rows[t]) the joint [B, S, hp] and blank of
// those rows, then each reduction as the column-reduce product over vec
// (alpha, then the last expansion), its partials [ceil(S / 64), B, V]
// merged into the frame's expansion (-inf on padding rows): by
// col_merge_kernel, the last by merge_update_kernel with the update. In
// 'cache' mode with two or more reductions the first also stores lex ([B,
// S, V] float32, not null then) and the later ones read it back
// (col_pass_kernel<kLoad>, 64-state tiles, one partial each) in place of
// the product; 'online' runs the product for every reduction and takes no
// lex. A frame with no live row runs only the merges and the update, which
// hold alpha.
int run_forward(const float* pf, const float* pc, const float* vw,
                const float* vb, const float* bw, const float* bb,
                const int* is_pad, const int* live, const int* rows,
                bf16* joint, bf16* vw16, float* blank, float* lex,
                float* part_m, float* part_l, float* last, float* alpha,
                float* hist, float* slabs, int T, int B, int S, int h, int V,
                int max_expansions, int frame_dependent, int online,
                int max_blocks, cudaStream_t stream) {
  const int passes = frame_dependent ? 1 : max_expansions;
  const bool stage = !online && passes >= 2;
  if ((T > 0 && live == nullptr) || max_blocks < 1 ||
      (stage && lex == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int hp = round_up(h, kBK), Vp = round_up(V, kBK), t64 = cdiv(S, 64);
  const size_t bs = static_cast<size_t>(B) * S;
  RETURN_IF_ERROR(head_product::joint_pass(pc, pf, vw, bw, bb, nullptr,
                                           joint, vw16, blank, 0, S, h, V,
                                           /*head=*/true, stream));
  for (int t = 0; t < T; ++t) {
    const int L = live[t];
    const float* alpha_cur = alpha + (t % 2) * bs;
    float* alpha_next = alpha + ((t + 1) % 2) * bs;
    const int* is_pad_t = is_pad + static_cast<size_t>(t) * B;
    const int* rows_t = rows + static_cast<size_t>(t) * B;
    float* hist_t = hist != nullptr ? hist + t * bs : nullptr;
    if (L > 0) {
      RETURN_IF_ERROR(head_product::joint_pass(
          pc, pf + static_cast<size_t>(t) * B * h, vw, bw, bb, rows_t, joint,
          vw16, blank, L, S, h, V, /*head=*/false, stream));
    }
    // The j-th expansion of the frame: a slab, or a scratch row.
    float* last_t = slabs != nullptr ? slabs + t * bs : last;
    const size_t last_stride =
        slabs != nullptr ? static_cast<size_t>(T) * bs : bs;
    const float* vec = alpha_cur;
    for (int j = 0; j < passes; ++j) {
      if (L > 0 && j > 0 && stage) {
        // kLoad reads no joint or head.
        col_pass_kernel<kLoad>
            <<<dim3(cdiv(V, lattice_tiles::kBN), t64, B),
               lattice_tiles::kThreads, 0, stream>>>(
                nullptr, nullptr, vb, vec, lex, part_m, part_l, is_pad_t, S,
                h, V, 1);
        RETURN_IF_ERROR(cudaGetLastError());
      } else if (L > 0) {
        float* store = stage && j == 0 ? lex : nullptr;
        const head_product::ColumnReduce p{
            vb, vec, rows_t, part_m, part_l, store, B, S, V, hp, Vp, L};
        RETURN_IF_ERROR(
            head_product::reduce_product(joint, vw16, p, max_blocks, stream));
      }
      if (j + 1 == passes) break;  // merged with the update
      float* red = last_t + j * last_stride;
      col_merge_kernel<<<blocks_for(static_cast<size_t>(B) * V),
                         kPointThreads, 0, stream>>>(part_m, part_l, is_pad_t,
                                                     red, t64, B, S, V);
      RETURN_IF_ERROR(cudaGetLastError());
      vec = red;
    }
    if (passes == 0) {
      update_kernel<<<blocks_for(bs), kPointThreads, 0, stream>>>(
          alpha_cur, blank, last_t, last_stride, is_pad_t, alpha_next,
          hist_t, B, S, passes, frame_dependent);
    } else {
      merge_update_kernel<<<blocks_for(bs), kPointThreads, 0, stream>>>(
          part_m, part_l, t64, alpha_cur, blank, last_t, last_stride,
          is_pad_t, alpha_next, hist_t, B, S, V, passes, frame_dependent);
    }
    RETURN_IF_ERROR(cudaGetLastError());
  }
  return 0;
}

#undef RETURN_IF_ERROR

}  // namespace hopper

// ---------------------------------------------------------------------------
// The bfloat16 trigram on wgmma, by segment (FD and FLD(k >= 1), V <= 128).
// A block owns segment p (the source states whose last symbol is p: unigram
// p and the bigrams (q, p); for p = 0 the start state) and a group of G
// batch rows, one warpgroup a row: grid (V + 1, ceil(B / G)). The bigrams
// (q, p), rows V apart, are product tiles of 64 rows (one at V <= 64); the
// unigram (the start state for p = 0) is an extra row taken on the CUDA
// cores beside them. The segment's destinations (p, 1..V) are contiguous,
// so the block reduces over its sources in registers and writes the
// reduced row in place. The joint is formed in the product's operand,
// never in memory: per 64-deep chunk each thread takes tanhf of pc + pf for
// its entries and rounds them to bfloat16 into the swizzled A tile of wgmma
// (the blank head's dot product taken from the same values), the whole
// padded head resident in shared memory (one TMA batch a block); A is
// double-buffered, so one chunk's products run under the next chunk's tanh.
// At V=64 each joint entry feeds one 64-label strip, so forming it once per
// use costs no extra tanh; the [B, S, h] joint of the first design (34 MB a
// frame at B=8) is gone, and so is the backward's float32 [B, S, h] d_pc
// accumulator.
//
// Forward, per frame: head_kernel<.., true> (alpha's update of the frame
// before at the block's own sources, deferred to here so that it reads
// only values of earlier launches; the history; the product; blank; lex
// staged in float32 when a later expansion reads it; the first expansion),
// then segment_sweep_kernel for each later expansion: FD and FLD(1) one
// launch a frame, FLD(2) two, and one update_kernel after the last frame.
// Backward, per frame: head_kernel<.., false> (the joint and the product
// again; blank and float32 lex staged), one row_kernel per earlier row
// reduction (FLD(k): k - 1; they need blank at destinations of other
// blocks, hence the launch boundary), grad_kernel (the last row reduction,
// the next beta, d_blank, the marginals d_lex rounded to bfloat16 into
// shared memory, never to device memory; then per 64-wide chunk of h, the
// chunks split over the warpgroups, the joint recomputed in the
// accumulator layout, d_joint = d_lex vw^T and d_vw += joint^T d_lex on
// wgmma, the tanh derivative, d_pc summed over the block's rows into
// [groups, S, h], d_pf and d_bw column sums) and dpf_reduce_kernel: FLD(2)
// four launches a frame, FD and FLD(1) three.
// What bounds it: the joint's tanhf (S h per frame-row forward, twice that
// backward), above the products at V=64: 2 MUFU operations each (ex2,
// rcp) but about 40 FP32-pipe instructions, whose issue rate binds first.
namespace segments {

using wgmma_tiles::allow_smem;
using wgmma_tiles::bf16;
using wgmma_tiles::box_map;
using wgmma_tiles::cdiv;
using wgmma_tiles::descriptor;
using wgmma_tiles::kAtom;
using wgmma_tiles::kBox;
using wgmma_tiles::mbar_expect;
using wgmma_tiles::mbar_init;
using wgmma_tiles::mbar_wait;
using wgmma_tiles::named_barrier;
using wgmma_tiles::round_up;
using wgmma_tiles::tma_load;
using wgmma_tiles::wgmma_commit;
using wgmma_tiles::wgmma_fence;
using wgmma_tiles::wgmma_wait;

constexpr int kThreads = 128;  // one warpgroup
constexpr int kRows = 64;      // source rows per product tile
constexpr int kMaxSmem = 232448;

// Makes the threads' shared-memory stores visible to wgmma's reads.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A B for a 64 x 64 x 16 piece from shared memory; TransA / TransB 1
// for MN-major.
template <int TransA, int TransB>
__device__ __forceinline__ void wgmma64(float (&d)[32], uint64_t desc_a,
                                        uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TransA), "n"(TransB));
}

// The descriptors of k16 step j of a swizzled [64][64] bfloat16 box: its
// 64 depths contiguous (K-major) or its 64 rows or columns (MN-major).
__device__ __forceinline__ uint64_t kmajor(const uint8_t* box, int j) {
  return descriptor(box + j * 32, 16, kAtom);
}

__device__ __forceinline__ uint64_t mnmajor(const uint8_t* box, int j) {
  return descriptor(box + j * 2 * kAtom, kBox, kAtom);
}

// Byte offset of (row, col) in a [64][64] bfloat16 box with the 128-byte
// swizzle (TMA's and wgmma's layout).
__device__ __forceinline__ int swizzled(int row, int col) {
  return row * 128 + ((((col >> 3) ^ row) & 7) << 4) + (col & 7) * 2;
}

// Row and column (of 64) of accumulator entry e of thread lt of a
// warpgroup (wgmma's m64nN float32 layout).
__device__ __forceinline__ int acc_r(int e, int lt) {
  return lt / 32 * 16 + (lt % 32) / 4 + ((e >> 1) & 1) * 8;
}

__device__ __forceinline__ int acc_c(int e, int lt) {
  return (e >> 2) * 8 + (lt % 4) * 2 + (e & 1);
}

__device__ __forceinline__ uint32_t pack(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// Segment p's sources: the bigrams (q, p), q = 1..V, rows V apart, in
// product tiles of 64 (none for p = 0; one for V <= 64), and one extra row
// taken on the CUDA cores: unigram p, or for p = 0 the start state. Its
// destinations start at seg_dest(p).
__device__ __forceinline__ int seg_tiles(int p, int V) {
  return p == 0 ? 0 : cdiv(V, kRows);
}

// The state of row r of bigram tile `tile` of segment p, or -1 past V.
__device__ __forceinline__ int seg_bigram(int p, int tile, int r, int V) {
  const int q = tile * kRows + r + 1;
  return q <= V ? 1 + V + (q - 1) * V + (p - 1) : -1;
}

__device__ __forceinline__ int seg_dest(int p, int V) {
  return p == 0 ? 1 : 1 + V + (p - 1) * V;
}

// v[e] = row[k + e] for the 8 depths at k, zero past h.
__device__ __forceinline__ void load8(const float* row, int k, int h,
                                      float (&v)[8]) {
  if ((h & 3) == 0 && k + 8 <= h) {
    const float4 a = *reinterpret_cast<const float4*>(row + k);
    const float4 b = *reinterpret_cast<const float4*>(row + k + 4);
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
    v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = k + e < h ? row[k + e] : 0.f;
  }
}

__device__ __forceinline__ uint8_t* aligned(uint8_t* raw) {
  return reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t{1023});
}

// The rows of block group `group` (G of them, b >= B absent) and the mask
// of those that are live this frame.
template <int G>
__device__ __forceinline__ unsigned group_rows(int group, int B,
                                               const int* is_pad_t,
                                               int (&rows)[G]) {
  unsigned live = 0;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    rows[g] = group * G + g;
    if (rows[g] < B && !is_pad_t[rows[g]]) live |= 1u << g;
  }
  return live;
}

struct Head {
  const float* pc;        // [S, h]
  const float* pf_t;      // [B, h]
  const int* is_pad_t;    // [B]
  const float* vb;        // [V]
  const float* bw;        // [h] float32, rounded to bfloat16 here
  const float* bb;        // [1]
  float* blank;           // [B, S]: the frame's, at the block's sources
  float* lex;             // [B, S, V] float32 (+ vb), or null
  // Forward only.
  const float* alpha_prev;  // [B, S] alpha before frame t - 1; null at t = 0
  float* alpha;             // [B, S] alpha before frame t (read at t = 0)
  const int* is_pad_prev;   // [B] or null
  Alphas prev;              // frame t - 1's expansions
  float* hist_t;            // [B, S] or null
  float* red;               // [B, S]: the frame's first expansion
  int frame_dependent;
  int B, S, h, hp, V;
};

// head_kernel's shared memory: A [2 stages][G] boxes (one per warpgroup),
// the whole padded head [hp / 64][NS] boxes, an mbarrier, then floats per
// warpgroup: alpha at the sources [NS * 64 + 4] (the extra row's at NS *
// 64), the running column (max, sum) [NS * 64] each, a warp exchange
// [4][64] each (at the end, the extra row's lex quarters [2][NS * 64] in
// each), the extra row's joint chunk [2 stages][64] and blank partials [4];
// then the rounded blank head [hp] and the live rows' pf [G][hp].
template <int G, int NS>
struct HeadSmem {
  static constexpr int kA = 0;
  static constexpr int kW = kA + 2 * G * kBox;
  __host__ __device__ static constexpr int bar(int hp) {
    return kW + hp / 64 * NS * kBox;
  }
  __host__ __device__ static constexpr int floats(int hp) {
    return bar(hp) + 16;
  }
  static constexpr int kVec = 0;
  static constexpr int kRunM = kVec + G * (NS * 64 + 4);
  static constexpr int kRunL = kRunM + G * NS * 64;
  static constexpr int kWm = kRunL + G * NS * 64;
  static constexpr int kWl = kWm + G * 4 * 64;
  static constexpr int kJx = kWl + G * 4 * 64;
  static constexpr int kBx = kJx + G * 2 * 64;
  static constexpr int kBw = kBx + G * 4;
  __host__ __device__ static constexpr int bytes(int hp) {
    return 1024 + floats(hp) + (kBw + (G + 1) * hp) * 4;
  }
};

// The product of a frame: per live row the lexical weights (+ vb) of
// segment blockIdx.x's sources, blank at the sources, lex stored when p.lex
// is set. Warpgroup w owns row w of the group: the bigram tile on wgmma with
// the joint formed in its A operand (the whole head resident, brought by TMA
// once), and the extra row on the CUDA cores beside it. Forward: first alpha
// at the sources (frame t - 1's update, deferred here), then the column
// (max, sum) over the sources of alpha + lex per label, written as the first
// expansion at the destinations (-inf on padding rows, and at the start
// state). Grid (V + 1, ceil(B / G)), G warpgroups.
template <int G, int NS, bool Forward>
__global__ void __launch_bounds__(G * kThreads, 1)
    head_kernel(const __grid_constant__ CUtensorMap vw_map, const Head p) {
  using L = HeadSmem<G, NS>;
  constexpr int kExtra = NS * 64;  // the extra row's slot in vec
  extern __shared__ uint8_t raw[];
  uint8_t* sm = aligned(raw);
  const int tid = threadIdx.x, wg = tid / kThreads, lt = tid % kThreads;
  const int seg = blockIdx.x, V = p.V, h = p.h, hp = p.hp, nk = hp / 64;
  const int tiles = seg_tiles(seg, V), sx = seg;  // sx: the extra row
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::bar(hp));
  float* fl = reinterpret_cast<float*>(sm + L::floats(hp));
  int rows[G];
  const unsigned live = group_rows<G>(blockIdx.y, p.B, p.is_pad_t, rows);
  const bool mine = (live >> wg) & 1;  // this warpgroup's row is live
  const int b = rows[wg];
  float* vec = fl + L::kVec + wg * (NS * 64 + 4);
  float* run_m = fl + L::kRunM + wg * NS * 64;
  float* run_l = fl + L::kRunL + wg * NS * 64;
  float* wm = fl + L::kWm + wg * 4 * 64;
  float* wl = fl + L::kWl + wg * 4 * 64;
  float* jxs = fl + L::kJx + wg * 2 * 64;
  float* lx = wm;  // the exchange is free once the tiles are done
  float* bx = fl + L::kBx + wg * 4;
  float* bwr = fl + L::kBw;
  float* pfs = bwr + hp + wg * hp;
  if (tid == 0) {
    mbar_init(full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int k = tid; k < hp; k += G * kThreads) {
    bwr[k] = k < h ? round_bf16(p.bw[k]) : 0.f;
  }
  for (int k = lt; k < hp; k += kThreads) {
    pfs[k] = mine && k < h ? p.pf_t[static_cast<size_t>(b) * h + k] : 0.f;
  }
  const size_t row0 = static_cast<size_t>(b) * p.S;
  if constexpr (Forward) {
    // alpha at the sources: frame t - 1's update (it reads that frame's
    // blank, written by this block, and expansions, written by the
    // launches of that frame), or the initial alpha at t = 0.
    for (int i = lt; i <= kExtra && b < p.B; i += kThreads) {
      const int s = i == kExtra      ? sx
                    : i / 64 < tiles ? seg_bigram(seg, i / 64, i % 64, V)
                                     : -1;
      if (s < 0) continue;
      const size_t at = row0 + s;
      float a;
      if (p.alpha_prev == nullptr) {
        a = p.alpha[at];
      } else {
        a = p.alpha_prev[at];
        if (!p.is_pad_prev[b]) {
          const float bl = p.blank[at];
          float acc = a + bl;
          if (p.frame_dependent) {
            acc = log_add(acc, p.prev.a[0][at]);
          } else {
            for (int j = 0; j < p.prev.n; ++j) {
              acc = log_add(acc, p.prev.a[j][at] + bl);
            }
          }
          a = acc;
        }
        p.alpha[at] = a;
      }
      if (p.hist_t != nullptr) p.hist_t[at] = a;
      vec[i] = a;
    }
    for (int i = lt; i < NS * 64; i += kThreads) {
      run_m[i] = -INFINITY;
      run_l[i] = 0.f;
    }
  }
  __syncthreads();
  const int warp = lt / 32, lane = lt % 32;
  const int c8 = lt & 7, rsub = lt >> 3;
  auto a_box = [&](int st) { return sm + L::kA + (st * G + wg) * kBox; };
  auto w_box = [&](int c, int n) { return sm + L::kW + (c * NS + n) * kBox; };
  if (live != 0) {
    if (tid == 0) {  // the whole head, once
      mbar_expect(full, nk * NS * kBox);
      for (int c = 0; c < nk; ++c) {
#pragma unroll
        for (int n = 0; n < NS; ++n) {
          tma_load(w_box(c, n), vw_map, n * 64, c * 64, full);
        }
      }
    }
    float acc[NS][32];
    // The extra row's lex: labels yp, yp + 1 of each strip over the depths
    // of quarter kq of each chunk; its blank: depth lt of each chunk.
    const int yp = lane * 2, kq = warp;
    float lxa[NS][2];
#pragma unroll
    for (int n = 0; n < NS; ++n) lxa[n][0] = lxa[n][1] = 0.f;
    float bxa = 0.f;
    int q = 0;  // chunks so far
    for (int tile = 0; tile < (tiles > 0 ? tiles : 1); ++tile) {
      const bool product = tile < tiles;
      float bpart[4] = {0.f, 0.f, 0.f, 0.f};
      for (int c = 0; c < nk; ++c, ++q) {
        if (!mine) continue;
        const int st = q & 1;
        if (product) {
          // The joint of the tile's rows over the chunk's depths, each
          // thread 8 depths of 4 rows; their pc first (one round trip).
          const int k0 = c * 64 + c8 * 8;
          float pcv[4][8];
          int state[4];
#pragma unroll
          for (int pass = 0; pass < 4; ++pass) {
            state[pass] = seg_bigram(seg, tile, rsub + 16 * pass, V);
            if (state[pass] >= 0) {
              load8(p.pc + static_cast<size_t>(state[pass]) * h, k0, h,
                    pcv[pass]);
            }
          }
          float bwv[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) bwv[e] = bwr[k0 + e];
#pragma unroll
          for (int pass = 0; pass < 4; ++pass) {
            const int r = rsub + 16 * pass;
            uint32_t packed[4] = {0u, 0u, 0u, 0u};
            if (state[pass] >= 0) {
#pragma unroll
              for (int e = 0; e < 8; e += 2) {
                float j[2];
#pragma unroll
                for (int u = 0; u < 2; ++u) {
                  const int k = k0 + e + u;
                  j[u] = k < h ? tanhf(pcv[pass][e + u] + pfs[k]) : 0.f;
                }
                packed[e / 2] = pack(j[0], j[1]);
                bpart[pass] =
                    fmaf(round_bf16(j[0]), bwv[e],
                         fmaf(round_bf16(j[1]), bwv[e + 1], bpart[pass]));
              }
            }
            *reinterpret_cast<uint4*>(a_box(st) + r * 128 +
                                      ((c8 ^ (r & 7)) << 4)) =
                make_uint4(packed[0], packed[1], packed[2], packed[3]);
          }
        }
        float* jx = jxs + st * 64;
        if (tile == 0 && lt < 64) {  // the extra row's joint chunk
          const int k = c * 64 + lt;
          const float j =
              k < h ? round_bf16(tanhf(p.pc[static_cast<size_t>(sx) * h + k] +
                                       pfs[k]))
                    : 0.f;
          jx[lt] = j;
          bxa = fmaf(j, bwr[k], bxa);
        }
        fence_proxy_async();
        named_barrier(1 + wg, kThreads);
        if (q == 0) mbar_wait(full, 0);
        if (product) {
          wgmma_fence();
#pragma unroll
          for (int n = 0; n < NS; ++n) {
            fence_acc(acc[n]);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              wgmma64<0, 1>(acc[n], kmajor(a_box(st), j),
                            mnmajor(w_box(c, n), j), c > 0 || j > 0);
            }
          }
          wgmma_commit();
        }
        if (tile == 0) {  // the extra row's lex, under the products
          float jk[16];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float4 v = reinterpret_cast<const float4*>(jx + kq * 16)[i];
            jk[4 * i] = v.x, jk[4 * i + 1] = v.y;
            jk[4 * i + 2] = v.z, jk[4 * i + 3] = v.w;
          }
#pragma unroll
          for (int n = 0; n < NS; ++n) {
            const uint8_t* w = w_box(c, n);
            float sum[2][2] = {{0.f, 0.f}, {0.f, 0.f}};  // two chains each
#pragma unroll
            for (int i = 0; i < 16; ++i) {
              const float2 wv = __bfloat1622float2(
                  *reinterpret_cast<const __nv_bfloat162*>(
                      w + swizzled(kq * 16 + i, yp)));
              sum[i & 1][0] = fmaf(jk[i], wv.x, sum[i & 1][0]);
              sum[i & 1][1] = fmaf(jk[i], wv.y, sum[i & 1][1]);
            }
            lxa[n][0] += sum[0][0] + sum[1][0];
            lxa[n][1] += sum[0][1] + sum[1][1];
          }
        }
        // The chunk before is done, in every warp's view (a warpgroup's
        // product completes as one): its A stage can be formed again.
        if (product) wgmma_wait<1>();
      }
      if (!mine || !product) continue;
      wgmma_wait<0>();
#pragma unroll
      for (int n = 0; n < NS; ++n) fence_acc(acc[n]);
      // blank of the tile's rows: the 8 threads of a row hold its partials.
#pragma unroll
      for (int pass = 0; pass < 4; ++pass) {
        float v = bpart[pass];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        const int s = seg_bigram(seg, tile, rsub + 16 * pass, V);
        if (c8 == 0 && s >= 0) p.blank[row0 + s] = v + p.bb[0];
      }
      // lex = product + vb; stored; the column (max, sum) of alpha + lex.
      float vr[2];
      size_t lex_row[2];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = acc_r(half * 2, lt);
        const int s = seg_bigram(seg, tile, r, V);
        vr[half] = -INFINITY;
        lex_row[half] = SIZE_MAX;
        if (s >= 0) {
          lex_row[half] = (row0 + s) * V;
          if constexpr (Forward) vr[half] = vec[tile * 64 + r];
        }
      }
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        float(&d)[32] = acc[n];
#pragma unroll
        for (int e = 0; e < 32; e += 2) {
          const int y = n * 64 + acc_c(e, lt);  // even: y, y + 1 adjacent
          d[e] += y < V ? p.vb[y] : 0.f;
          d[e + 1] += y + 1 < V ? p.vb[y + 1] : 0.f;
          const size_t lr = lex_row[(e >> 1) & 1];
          if (p.lex == nullptr || lr == SIZE_MAX || y >= V) continue;
          if (y + 1 < V && V % 2 == 0) {
            *reinterpret_cast<float2*>(p.lex + lr + y) =
                make_float2(d[e], d[e + 1]);
          } else {
            p.lex[lr + y] = d[e];
            if (y + 1 < V) p.lex[lr + y + 1] = d[e + 1];
          }
        }
        if constexpr (Forward) {
          // Per column: the max over the thread's 2 rows, then over the
          // 8 lanes of its column group, then the sum of exp.
          float cm[16], cl[16];
#pragma unroll
          for (int j = 0; j < 8; ++j) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int y = n * 64 + j * 8 + (lane % 4) * 2 + e;
              float m = -INFINITY;
              if (y < V) {
                m = fmaxf(vr[0] + d[j * 4 + e], vr[1] + d[j * 4 + 2 + e]);
              }
              for (int o = 4; o < 32; o <<= 1) {
                m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
              }
              cm[j * 2 + e] = m;
            }
          }
#pragma unroll
          for (int j = 0; j < 8; ++j) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int y = n * 64 + j * 8 + (lane % 4) * 2 + e;
              const float c = safe_shift(cm[j * 2 + e]);
              float l = 0.f;
              if (y < V) {
                l = expf(vr[0] + d[j * 4 + e] - c) +
                    expf(vr[1] + d[j * 4 + 2 + e] - c);
              }
              for (int o = 4; o < 32; o <<= 1) {
                l += __shfl_xor_sync(0xffffffffu, l, o);
              }
              cl[j * 2 + e] = l;
            }
          }
          if (lane < 4) {
#pragma unroll
            for (int j = 0; j < 8; ++j) {
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int col = j * 8 + lane * 2 + e;
                wm[warp * 64 + col] = cm[j * 2 + e];
                wl[warp * 64 + col] = cl[j * 2 + e];
              }
            }
          }
          named_barrier(1 + wg, kThreads);
          if (lt < 64) {
            const int at = n * 64 + lt;
            float m = run_m[at], l = run_l[at];
#pragma unroll
            for (int w = 0; w < 4; ++w) {
              lse_merge(m, l, wm[w * 64 + lt], wl[w * 64 + lt]);
            }
            run_m[at] = m;
            run_l[at] = l;
          }
          named_barrier(1 + wg, kThreads);
        }
      }
    }
    if (mine) {
      // The extra row: its lex (four quarters of the depths), blank, and
      // its term in the column (max, sum).
      float* lxq = (kq < 2 ? lx : wl) + kq % 2 * NS * 64;
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        lxq[n * 64 + yp] = lxa[n][0];
        lxq[n * 64 + yp + 1] = lxa[n][1];
      }
      float v = bxa;
      for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      if (lane == 0) bx[warp] = v;  // warps 2, 3 add zero
      named_barrier(1 + wg, kThreads);
      for (int y = lt; y < V; y += kThreads) {
        const float lex = (lx[y] + lx[NS * 64 + y]) +
                          (wl[y] + wl[NS * 64 + y]) + p.vb[y];
        if (p.lex != nullptr) p.lex[(row0 + sx) * V + y] = lex;
        if constexpr (Forward) {
          lse_merge(run_m[y], run_l[y], vec[kExtra] + lex, 1.f);
        }
      }
      if (lt == 0) p.blank[row0 + sx] = bx[0] + bx[1] + bx[2] + bx[3] + p.bb[0];
      named_barrier(1 + wg, kThreads);
    }
  }
  if constexpr (Forward) {
    if (b < p.B) {
      float* out = p.red + row0;
      const int dest0 = seg_dest(seg, V);
      for (int y = lt; y < V; y += kThreads) {
        out[dest0 + y] = mine ? lse_value(run_m[y], run_l[y]) : -INFINITY;
      }
      if (seg == 0 && lt == 0) out[0] = -INFINITY;  // no arc enters it
    }
  }
}

// The earlier row reductions of the backward:
//   out[b, s] = log_add(blank + beta, logsumexp_y(lex[b, s, y] + x[dest]))
// with dest = dest_base(s) + y and x = x1 (+ x2 when given); -inf on
// padding rows (never read). One warp per (b, s), V <= 128: the max, then
// the sum of exp.
__global__ void __launch_bounds__(256)
    row_kernel(const float* __restrict__ lex,     // [B, S, V]
               const float* __restrict__ blank,   // [B, S]
               const float* __restrict__ beta,    // [B, S]
               const float* __restrict__ x1,      // [B, S]
               const float* __restrict__ x2,      // [B, S] or null
               const int* __restrict__ is_pad_t,  // [B]
               float* __restrict__ out,           // [B, S]
               int B, int S, int V) {
  const int idx = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (idx >= B * S) return;
  const int b = idx / S, s = idx % S;
  if (is_pad_t[b]) {
    if (lane == 0) out[idx] = -INFINITY;
    return;
  }
  const size_t d0 = static_cast<size_t>(b) * S + dest_base<true>(s, V);
  const float* lx = lex + static_cast<size_t>(idx) * V;
  float v[4];
  float m = -INFINITY;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int y = lane + 32 * i;
    v[i] = y < V ? lx[y] + x1[d0 + y] + (x2 != nullptr ? x2[d0 + y] : 0.f)
                 : -INFINITY;
    m = fmaxf(m, v[i]);
  }
  for (int o = 16; o > 0; o >>= 1) {
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  }
  const float c = safe_shift(m);
  float l = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) l += expf(v[i] - c);
  for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
  if (lane == 0) out[idx] = log_add(blank[idx] + beta[idx], lse_value(m, l));
}

struct Grad {
  const float* pc;        // [S, h]
  const float* pf_t;      // [B, h]
  const int* is_pad_t;    // [B]
  const float* lex;       // [B, S, V] (+ vb), from head_kernel
  const float* blank;     // [B, S]
  const float* beta;      // [B, S]: beta after the frame
  const float* x;         // the last reduction's nb, or null: blank + beta
  Pairs pairs;            // (a_j, nb_{j + 1}); nb null: blank + beta
  Alphas alphas;          // a_0..a_k of d_blank
  const float* log_z;     // [B]
  const float* g;         // [B]
  const float* bw32;      // [h]
  float* beta_next;       // [B, S]
  float* dpc_acc;         // [groups, S, h]
  float* dvw_acc;         // [blocks, h, V]
  float* dvb_acc;         // [blocks, V]
  float* dbw_acc;         // [blocks, h]
  float* dbb_acc;         // [blocks]
  float* dpf_part;        // [V + 1, B, h]
  int B, S, h, hp, V, Vp;
};

// grad_kernel's shared memory: d_lex of the bigram tiles [NS][G][NS] boxes,
// per warpgroup a joint box, a float32 joint [64 * 64] in the accumulator
// layout (phase 1: the nb vectors [1 + kMaxAlphas][128]) and a head chunk
// [NS] boxes, an mbarrier each, then floats: d_blank of the tile rows
// [NS][G][64] and of the extra rows [4], the extra rows' d_lex [G][128], per
// warpgroup a warp exchange [2][4][64], d_pf sums [G][64], d_bw sums [64],
// the extra rows' joint chunks [G][64], d_joint [G][64], d_pre sum [64] and
// pc chunk [64], the d_vb sums [G][128], a block sum [G][4], the float32
// blank head [hp] and the live rows' pf [G][hp].
template <int G, int NS>
struct GradSmem {
  static constexpr int kD = 0;
  static constexpr int kJ = kD + NS * G * NS * kBox;
  static constexpr int kF = kJ + G * kBox;
  static constexpr int kBc = kF + G * 64 * 64 * 4;
  static constexpr int kBar = kBc + G * NS * kBox;
  static constexpr int kFloats = kBar + 32;
  static constexpr int kDbl = 0;
  static constexpr int kDbx = kDbl + NS * G * 64;
  static constexpr int kDlx = kDbx + 4;
  static constexpr int kWs = kDlx + G * 128;
  static constexpr int kDpf = kWs + G * 512;
  static constexpr int kDbw = kDpf + G * G * 64;
  static constexpr int kJx = kDbw + G * 64;
  static constexpr int kDjx = kJx + G * G * 64;
  static constexpr int kDpx = kDjx + G * G * 64;
  static constexpr int kPcx = kDpx + G * 64;
  static constexpr int kDvb = kPcx + G * 64;
  static constexpr int kSum = kDvb + G * 128;
  static constexpr int kBw = kSum + G * 4;
  __host__ __device__ static constexpr int bytes(int hp) {
    return 1024 + kFloats + (kBw + (G + 1) * hp) * 4;
  }
};

// The last row reduction and the gradients of a frame for segment
// blockIdx.x and the rows of group blockIdx.y. Phase 1, warpgroup w for row
// w: the next beta at the sources (held on padding rows), d_blank, the
// marginals
//   d_lex[s, y] = bf16(g * sum_j exp(a_j[s] + lex[s, y] + nb_j[dest] - lz))
// of the bigram tiles into shared memory and of the extra row beside them,
// their column sums into dvb_acc. Phase 2, warpgroup w for the chunks c = w,
// w + G, ... of h and every row: the joint recomputed, d_joint = d_lex vw^T
// and d_vw += joint^T d_lex on wgmma (the extra row on the CUDA cores), d_pre
// = (d_joint + d_blank bw) (1 - joint^2), its sums over the rows into
// dpc_acc and over the sources into dpf_part, and sum joint d_blank into
// dbw_acc: every sum of a chunk lives in one warpgroup. NP: the (a_j, nb_j)
// pairs, 0 for any count. Grid (V + 1, ceil(B / G)), G warpgroups.
template <int G, int NS, int NP>
__global__ void __launch_bounds__(G * kThreads, 1)
    grad_kernel(const __grid_constant__ CUtensorMap vw_map, const Grad p) {
  using L = GradSmem<G, NS>;
  extern __shared__ uint8_t raw[];
  uint8_t* sm = aligned(raw);
  float* fl = reinterpret_cast<float*>(sm + L::kFloats);
  const int tid = threadIdx.x, wg = tid / kThreads, lt = tid % kThreads;
  const int warp = lt / 32, lane = lt % 32;
  const int seg = blockIdx.x, V = p.V, Vp = p.Vp;
  const int h = p.h, hp = p.hp, nk = hp / 64;
  const int block = blockIdx.y * gridDim.x + seg;
  const int tiles = seg_tiles(seg, V), sx = seg;  // sx: the extra row
  const int dest0 = seg_dest(seg, V);
  int rows[G];
  const unsigned live = group_rows<G>(blockIdx.y, p.B, p.is_pad_t, rows);
  const bool mine = (live >> wg) & 1;
  const int b = rows[wg];
  auto d_box = [&](int tile, int g) {
    return sm + L::kD + ((tile * G + g) * NS) * kBox;
  };
  uint8_t* jbox = sm + L::kJ + wg * kBox;
  float* jf = reinterpret_cast<float*>(sm + L::kF) + wg * 4096;
  uint8_t* bc = sm + L::kBc + wg * NS * kBox;
  uint64_t* bar = reinterpret_cast<uint64_t*>(sm + L::kBar) + wg;
  float* dbl = fl + L::kDbl;
  float* dbx = fl + L::kDbx;
  float* dlx = fl + L::kDlx;
  float* wsum = fl + L::kWs + wg * 512;
  float* dpf_s = fl + L::kDpf + wg * G * 64;
  float* dbw_s = fl + L::kDbw + wg * 64;
  float* jxg = fl + L::kJx + wg * G * 64;
  float* djxg = fl + L::kDjx + wg * G * 64;
  float* dpx = fl + L::kDpx + wg * 64;
  float* pcx = fl + L::kPcx + wg * 64;
  float* dvb_s = fl + L::kDvb;
  float* bsum = fl + L::kSum;
  float* bws = fl + L::kBw;
  float* pfs_all = bws + hp;
  for (int k = tid; k < hp; k += G * kThreads) bws[k] = k < h ? p.bw32[k] : 0.f;
  for (int k = lt; k < hp; k += kThreads) {
    pfs_all[wg * hp + k] =
        mine && k < h ? p.pf_t[static_cast<size_t>(b) * h + k] : 0.f;
  }
  for (int i = lt; i < G * 64; i += kThreads) dpf_s[i] = 0.f;
  if (lt < 64) dbw_s[lt] = dpx[lt] = 0.f;
  if (lt == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // Each warpgroup's first chunk of the head, under phase 1.
  auto load_chunk = [&](int c) {
    mbar_expect(bar, NS * kBox);
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      tma_load(bc + n * kBox, vw_map, n * 64, c * 64, bar);
    }
  };
  if (live != 0 && lt == 0 && wg < nk) load_chunk(wg);

  // Phase 1 (CUDA cores), warpgroup wg for its row.
  constexpr int kP = NP > 0 ? NP : 1;
  float dbb_reg = 0.f;
  const int npairs = p.pairs.n;
  const size_t row0 = static_cast<size_t>(b) * p.S;
  auto pair_sum = [&](const float (&ar)[kP], size_t at, float lz, float xv,
                      int y, const float* nbq) {
    float total = 0.f;
    if constexpr (NP > 0) {
#pragma unroll
      for (int j = 0; j < NP; ++j) total += expf(ar[j] + xv + nbq[j * 128 + y]);
    } else {
      for (int j = 0; j < npairs; ++j) {
        total += expf(p.pairs.a[j][at] - lz + xv + nbq[j * 128 + y]);
      }
    }
    return total;
  };
  auto d_blank = [&](size_t at, float bl, float bt, float lz, float gb) {
    float total = 0.f;
    for (int j = 0; j < p.alphas.n; ++j) {
      total += expf(p.alphas.a[j][at] + bl + bt - lz);
    }
    return gb * total;
  };
  if (b < p.B && !mine) {  // a padding row holds beta
    for (int i = lt; i <= tiles * kRows; i += kThreads) {
      const int s =
          i == tiles * kRows ? sx : seg_bigram(seg, i / 64, i % 64, V);
      if (s >= 0) p.beta_next[row0 + s] = p.beta[row0 + s];
    }
  }
  if (mine) {
    float* xs = jf;  // [1 + kMaxAlphas][128] in phase 1
    float* nbq = xs + 128;
    const float lz = p.log_z[b], gb = p.g[b];
    for (int y = lt; y < 128; y += kThreads) {
      const size_t d = row0 + dest0 + y;
      const bool in = y < V;
      const float bb = in ? p.blank[d] + p.beta[d] : -INFINITY;
      xs[y] = !in ? -INFINITY : p.x != nullptr ? p.x[d] : bb;
      for (int j = 0; j < npairs; ++j) {
        nbq[j * 128 + y] =
            !in ? -INFINITY : p.pairs.nb[j] != nullptr ? p.pairs.nb[j][d] : bb;
      }
    }
    named_barrier(1 + wg, kThreads);
    const int r = lt >> 1, half = lt & 1, cols = Vp / 2;
    for (int tile = 0; tile < tiles; ++tile) {
      const int s = seg_bigram(seg, tile, r, V);
      const bool ok = s >= 0;
      const size_t at = row0 + (ok ? s : 0);
      float ar[kP];
      float bl = 0.f, bt = 0.f;
      if (ok) {
        bl = p.blank[at];
        bt = p.beta[at];
#pragma unroll
        for (int j = 0; j < kP; ++j) {
          ar[j] = NP > 0 ? p.pairs.a[j][at] - lz : 0.f;
        }
      }
      if (half == 0) {
        const float db = ok ? d_blank(at, bl, bt, lz, gb) : 0.f;
        dbl[(tile * G + wg) * 64 + r] = db;
        dbb_reg += db;
      }
      float m = -INFINITY, l = 0.f;
      const float* lxp = p.lex + at * V;
      for (int y0 = half * cols; y0 < (half + 1) * cols; y0 += 8) {
        float lxv[8];  // the 8 loads first
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          lxv[e] = ok && y0 + e < V ? lxp[y0 + e] : 0.f;
        }
        uint32_t packed[4];
#pragma unroll
        for (int e = 0; e < 8; e += 2) {
          float dv[2];
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int y = y0 + e + u;
            dv[u] = 0.f;
            if (ok && y < V) {
              const float xv = lxv[e + u];
              const float v = xv + xs[y];
              if (v > m) {
                l = l * expf(m - v) + 1.f;
                m = v;
              } else if (v > -INFINITY) {
                l += expf(v - m);
              }
              dv[u] = gb * pair_sum(ar, at, lz, xv, y, nbq);
            }
          }
          packed[e / 2] = pack(dv[0], dv[1]);
        }
        *reinterpret_cast<uint4*>(d_box(tile, wg) + (y0 / 64) * kBox +
                                  swizzled(r, y0 % 64)) =
            make_uint4(packed[0], packed[1], packed[2], packed[3]);
      }
      lse_merge(m, l, __shfl_xor_sync(0xffffffffu, m, 1),
                __shfl_xor_sync(0xffffffffu, l, 1));
      if (ok && half == 0) {
        p.beta_next[at] = log_add(bl + bt, lse_value(m, l));
      }
    }
    // The extra row: label lt per thread, its reduction over the labels
    // through the warp exchange.
    {
      const size_t at = row0 + sx;
      const float bl = p.blank[at], bt = p.beta[at];
      float ar[kP];
#pragma unroll
      for (int j = 0; j < kP; ++j) ar[j] = NP > 0 ? p.pairs.a[j][at] - lz : 0.f;
      const int y = lt;
      float v = -INFINITY, dv = 0.f;
      if (y < V) {
        const float xv = p.lex[at * V + y];
        v = xv + xs[y];
        dv = round_bf16(gb * pair_sum(ar, at, lz, xv, y, nbq));
      }
      dlx[wg * 128 + y] = dv;
      float m = v;
      for (int o = 16; o > 0; o >>= 1) {
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      }
      if (lane == 0) wsum[warp] = m;
      named_barrier(1 + wg, kThreads);
      m = fmaxf(fmaxf(wsum[0], wsum[1]), fmaxf(wsum[2], wsum[3]));
      float l = v > -INFINITY ? expf(v - m) : 0.f;
      for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
      if (lane == 0) wsum[4 + warp] = l;
      named_barrier(1 + wg, kThreads);
      if (lt == 0) {
        l = wsum[4] + wsum[5] + wsum[6] + wsum[7];
        p.beta_next[at] = log_add(bl + bt, lse_value(m, l));
        const float db = d_blank(at, bl, bt, lz, gb);
        dbx[wg] = db;
        dbb_reg += db;
      }
    }
    named_barrier(1 + wg, kThreads);
    // dvb: the column sums of the row's rounded d_lex.
    if (lt < V) {
      float total = dlx[wg * 128 + lt];
      for (int tile = 0; tile < tiles; ++tile) {
        const uint8_t* d = d_box(tile, wg) + (lt / 64) * kBox;
        for (int rr = 0; rr < kRows; ++rr) {
          total += __bfloat162float(
              *reinterpret_cast<const bf16*>(d + swizzled(rr, lt % 64)));
        }
      }
      dvb_s[wg * 128 + lt] = total;
    }
  }
  fence_proxy_async();
  __syncthreads();

  // Phase 2: warpgroup wg takes the chunks c = wg, wg + G, ... of h.
  if (live != 0) {
    for (int c = wg, kc = 0; c < nk; c += G, ++kc) {
      float dvw[NS][32];
#pragma unroll
      for (int n = 0; n < NS; ++n) {
#pragma unroll
        for (int e = 0; e < 32; ++e) dvw[n][e] = 0.f;
      }
      bool waited = false;
      // The extra row's pc of the chunk, read under the tiles.
      if (lt < 64) {
        pcx[lt] = c * 64 + lt < h
                      ? p.pc[static_cast<size_t>(sx) * h + c * 64 + lt]
                      : 0.f;
      }
      float* out = p.dpc_acc + static_cast<size_t>(blockIdx.y) * p.S * h;
      for (int tile = 0; tile < tiles; ++tile) {
        int src[2];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          src[half] = seg_bigram(seg, tile, acc_r(half * 2, lt), V);
        }
        float dpc[32];
#pragma unroll
        for (int e = 0; e < 32; ++e) dpc[e] = 0.f;
        for (int g = 0; g < G; ++g) {
          if (!((live >> g) & 1)) continue;
          const float* pfs = pfs_all + g * hp;
          // The joint of the tile's rows over the chunk in the accumulator
          // layout: float32 into jf for the tanh derivative, bfloat16 into
          // the joint box for d_vw. Half the entries at a time (their pc
          // loads first): the registers also hold d_vw and d_pc.
#pragma unroll 1
          for (int e0 = 0; e0 < 32; e0 += 16) {
            float pcv[16];
#pragma unroll
            for (int e = 0; e < 16; e += 2) {
              const int s = src[((e0 + e) >> 1) & 1];
              const int hh = c * 64 + acc_c(e0 + e, lt);
              const float* row = p.pc + static_cast<size_t>(s) * h + hh;
              if (s >= 0 && (h & 1) == 0 && hh + 1 < h) {
                const float2 v = *reinterpret_cast<const float2*>(row);
                pcv[e] = v.x, pcv[e + 1] = v.y;
              } else {
                pcv[e] = s >= 0 && hh < h ? row[0] : 0.f;
                pcv[e + 1] = s >= 0 && hh + 1 < h ? row[1] : 0.f;
              }
            }
#pragma unroll
            for (int e = 0; e < 16; e += 2) {
              const int s = src[((e0 + e) >> 1) & 1];
              const int col = acc_c(e0 + e, lt), hh = c * 64 + col;
              float jt[2];
#pragma unroll
              for (int u = 0; u < 2; ++u) {
                jt[u] = s >= 0 && hh + u < h
                            ? tanhf(pcv[e + u] + pfs[hh + u])
                            : 0.f;
                jf[(e0 + e + u) * kThreads + lt] = jt[u];
              }
              *reinterpret_cast<uint32_t*>(
                  jbox + swizzled(acc_r(e0 + e, lt), col)) =
                  pack(jt[0], jt[1]);
            }
          }
          fence_proxy_async();
          named_barrier(1 + wg, kThreads);
          if (!waited) {
            mbar_wait(bar, kc & 1);
            waited = true;
          }
          float dj[32];
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < NS * 4; ++kk) {
            wgmma64<0, 0>(dj, kmajor(d_box(tile, g) + (kk / 4) * kBox, kk % 4),
                          kmajor(bc + (kk / 4) * kBox, kk % 4), kk > 0);
          }
#pragma unroll
          for (int n = 0; n < NS; ++n) {
            fence_acc(dvw[n]);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              wgmma64<1, 1>(dvw[n], mnmajor(jbox, j),
                            mnmajor(d_box(tile, g) + n * kBox, j), 1);
            }
          }
          wgmma_commit();
          wgmma_wait<0>();
          fence_acc(dj);
#pragma unroll
          for (int n = 0; n < NS; ++n) fence_acc(dvw[n]);
          // The tanh derivative, and the column sums of d_pre (d_pf) and
          // joint * d_blank (d_bw).
          float db[2];
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            db[half] = dbl[(tile * G + g) * 64 + acc_r(half * 2, lt)];
          }
#pragma unroll
          for (int j = 0; j < 8; ++j) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int col = j * 8 + (lane % 4) * 2 + e;
              const float bw = bws[c * 64 + col];
              float cf = 0.f, cw = 0.f;
#pragma unroll
              for (int half = 0; half < 2; ++half) {
                const int idx = j * 4 + half * 2 + e;
                const float jt = jf[idx * kThreads + lt];
                const float dp = (dj[idx] + db[half] * bw) * (1.f - jt * jt);
                dpc[idx] += dp;
                cf += dp;
                cw += jt * db[half];
              }
              for (int o = 4; o < 32; o <<= 1) {
                cf += __shfl_xor_sync(0xffffffffu, cf, o);
                cw += __shfl_xor_sync(0xffffffffu, cw, o);
              }
              if (lane < 4) {
                wsum[warp * 64 + col] = cf;
                wsum[256 + warp * 64 + col] = cw;
              }
            }
          }
          named_barrier(1 + wg, kThreads);
          if (lt < 64) {
            float sf = 0.f, sw = 0.f;
#pragma unroll
            for (int w = 0; w < 4; ++w) {
              sf += wsum[w * 64 + lt];
              sw += wsum[256 + w * 64 + lt];
            }
            dpf_s[g * 64 + lt] += sf;
            dbw_s[lt] += sw;
          }
        }
        // The tile's d_pc, summed over the group's rows: this block owns
        // (group, s) for its sources and this warpgroup the chunk.
#pragma unroll
        for (int e0 = 0; e0 < 32; e0 += 8) {
          float* dst[8];
          float old[8];
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            const int e = e0 + u, s = src[(e >> 1) & 1];
            const int hh = c * 64 + acc_c(e, lt);
            dst[u] = s >= 0 && hh < h ? out + static_cast<size_t>(s) * h + hh
                                      : nullptr;
            old[u] = dst[u] != nullptr ? *dst[u] : 0.f;
          }
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            if (dst[u] != nullptr) *dst[u] = old[u] + dpc[e0 + u];
          }
        }
      }
      if (!waited) mbar_wait(bar, kc & 1);  // no tile: the extra rows read it
      named_barrier(1 + wg, kThreads);  // pcx is written
      // The extra rows on the CUDA cores, every live row at once: the
      // joint chunks, d_joint = d_lex vw^T, d_pre and its sums, d_vw.
      for (int i = lt; i < G * 64; i += kThreads) {
        const int g = i / 64, k = i % 64, hh = c * 64 + k;
        const bool in = ((live >> g) & 1) && hh < h;
        jxg[i] = in ? tanhf(pcx[k] + pfs_all[g * hp + hh]) : 0.f;
        float sum[4] = {0.f, 0.f, 0.f, 0.f};  // four chains
        if ((live >> g) & 1) {
#pragma unroll 4
          for (int y = 0; y < Vp; ++y) {
            sum[y & 3] = fmaf(dlx[g * 128 + y],
                              __bfloat162float(*reinterpret_cast<const bf16*>(
                                  bc + (y / 64) * kBox + swizzled(k, y % 64))),
                              sum[y & 3]);
          }
        }
        djxg[i] = (sum[0] + sum[1]) + (sum[2] + sum[3]);
      }
      named_barrier(1 + wg, kThreads);
      if (lt < 64) {
        const int hh = c * 64 + lt;
        float dp_sum = 0.f, dw_sum = 0.f;
        for (int g = 0; g < G; ++g) {
          if (!((live >> g) & 1)) continue;
          const float jt = jxg[g * 64 + lt], db = dbx[g];
          const float dp = (djxg[g * 64 + lt] + db * bws[hh]) * (1.f - jt * jt);
          dpf_s[g * 64 + lt] += dp;
          dp_sum += dp;
          dw_sum += jt * db;
        }
        dpx[lt] += dp_sum;
        dbw_s[lt] += dw_sum;
      }
      for (int g = 0; g < G; ++g) {
        if (!((live >> g) & 1)) continue;
#pragma unroll
        for (int n = 0; n < NS; ++n) {
#pragma unroll
          for (int e = 0; e < 32; ++e) {
            dvw[n][e] = fmaf(round_bf16(jxg[g * 64 + acc_r(e, lt)]),
                             dlx[g * 128 + n * 64 + acc_c(e, lt)], dvw[n][e]);
          }
        }
      }
      named_barrier(1 + wg, kThreads);
      // Every read of the chunk's head is done: the next one.
      if (lt == 0 && c + G < nk) load_chunk(c + G);
      // The chunk's sums: d_pc of the extra row, d_vw, d_pf, d_bw.
      const int hh = c * 64 + lt % 64;
      float* dvw_out = p.dvw_acc + static_cast<size_t>(block) * h * V;
#pragma unroll
      for (int n = 0; n < NS; ++n) {  // all 32 loads in flight, then stores
        float old[32];
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int hr = c * 64 + acc_r(e, lt), y = n * 64 + acc_c(e, lt);
          old[e] = hr < h && y < V ? dvw_out[static_cast<size_t>(hr) * V + y]
                                   : 0.f;
        }
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int hr = c * 64 + acc_r(e, lt), y = n * 64 + acc_c(e, lt);
          if (hr < h && y < V) {
            dvw_out[static_cast<size_t>(hr) * V + y] = old[e] + dvw[n][e];
          }
        }
      }
      if (lt < 64 && hh < h) {
        p.dpc_acc[(static_cast<size_t>(blockIdx.y) * p.S + sx) * h + hh] +=
            dpx[lt];
        for (int g = 0; g < G; ++g) {
          if ((live >> g) & 1) {
            p.dpf_part[(static_cast<size_t>(seg) * p.B + rows[g]) * h + hh] =
                dpf_s[g * 64 + lt];
          }
        }
        p.dbw_acc[static_cast<size_t>(block) * h + hh] += dbw_s[lt];
      }
      if (lt < 64) {
        for (int g = 0; g < G; ++g) dpf_s[g * 64 + lt] = 0.f;
        dbw_s[lt] = dpx[lt] = 0.f;
      }
    }
  }
  // Phase 3: the block's d_vb and d_bb.
  __syncthreads();
  if (tid < V) {
    float total = 0.f;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if ((live >> g) & 1) total += dvb_s[g * 128 + tid];
    }
    p.dvb_acc[static_cast<size_t>(block) * V + tid] += total;
  }
  for (int o = 16; o > 0; o >>= 1) {
    dbb_reg += __shfl_xor_sync(0xffffffffu, dbb_reg, o);
  }
  if (lane == 0) bsum[wg * 4 + warp] = dbb_reg;
  __syncthreads();
  if (tid == 0) {
    float total = 0.f;
    for (int w = 0; w < G * 4; ++w) total += bsum[w];
    p.dbb_acc[block] += total;
  }
}

#define RETURN_IF_ERROR(expr)                               \
  do {                                                      \
    const cudaError_t err = (expr);                         \
    if (err != cudaSuccess) return static_cast<int>(err);   \
  } while (0)

// Dynamic shared memory of the route for a call of hidden size h, V labels
// and `passes` reductions a frame: the larger of head_kernel's and
// grad_kernel's, so that forward and backward take one route; 0 where the
// route does not run the call (FLD(0), more than kMaxAlphas - 1 reductions,
// V > 128, or buffers past a block's shared memory).
inline int route_smem(int h, int V, int passes) {
  const int hp = round_up(h, 64), Vp = round_up(V, 64);
  if (passes < 1 || passes + 1 > kMaxAlphas || Vp > 128) return 0;
  const int head = Vp <= 64 ? HeadSmem<4, 1>::bytes(hp)
                            : HeadSmem<2, 2>::bytes(hp);
  const int grad = Vp <= 64 ? GradSmem<4, 1>::bytes(hp)
                            : GradSmem<2, 2>::bytes(hp);
  const int bytes = head > grad ? head : grad;
  return bytes <= kMaxSmem ? bytes : 0;
}

cudaError_t head_map(CUtensorMap* map, const bf16* vw16, int hp, int Vp) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(Vp),
                              static_cast<cuuint64_t>(hp)};
  return box_map(map, vw16, 2, dims);
}

// The forward's frames (module comment above): head_kernel, the later
// expansions' segment sweeps, and the last frame's update. Expansion j of
// frame t lives at cur(t, j): the slabs, or `last` [2, k, B, S] by frame
// parity (frame t + 1's update reads frame t's while writing its own).
// The entry point runs it where route_smem is not 0.
template <int G, int NS>
int forward_frames(const float* pf, const float* pc, const bf16* vw16,
                   const float* vb, const float* bw, const float* bb,
                   const int* is_pad, float* blank, float* lex, float* last,
                   float* alpha, float* hist, float* slabs, int T, int B,
                   int S, int h, int V, int passes, int frame_dependent,
                   cudaStream_t stream) {
  const int hp = round_up(h, 64), Vp = round_up(V, 64);
  const size_t bs = static_cast<size_t>(B) * S;
  constexpr auto kernel = head_kernel<G, NS, true>;
  const int smem = HeadSmem<G, NS>::bytes(hp);
  if (passes >= 2 && lex == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (T == 0 || B == 0) return 0;
  RETURN_IF_ERROR(allow_smem<kernel>(smem));
  CUtensorMap map;
  RETURN_IF_ERROR(head_map(&map, vw16, hp, Vp));
  const size_t stride = slabs != nullptr ? static_cast<size_t>(T) * bs : bs;
  auto cur = [&](int t, int j) {
    return slabs != nullptr ? slabs + t * bs + j * stride
                            : last + ((t % 2) * passes + j) * bs;
  };
  const dim3 grid(V + 1, cdiv(B, G));
  for (int t = 0; t < T; ++t) {
    const int* is_pad_t = is_pad + static_cast<size_t>(t) * B;
    Head p{pc, pf + static_cast<size_t>(t) * B * h, is_pad_t, vb, bw, bb,
           blank, passes >= 2 ? lex : nullptr};
    p.alpha_prev = t > 0 ? alpha + ((t - 1) % 2) * bs : nullptr;
    p.alpha = alpha + (t % 2) * bs;
    p.is_pad_prev = t > 0 ? is_pad_t - B : nullptr;
    p.prev.n = t > 0 ? passes : 0;
    for (int j = 0; j < p.prev.n; ++j) p.prev.a[j] = cur(t - 1, j);
    p.hist_t = hist != nullptr ? hist + t * bs : nullptr;
    p.red = cur(t, 0);
    p.frame_dependent = frame_dependent;
    p.B = B, p.S = S, p.h = h, p.hp = hp, p.V = V;
    kernel<<<grid, G * kThreads, smem, stream>>>(map, p);
    RETURN_IF_ERROR(cudaGetLastError());
    for (int j = 1; j < passes; ++j) {
      segment_sweep_kernel<<<dim3(V + 1, B), lattice_tiles::kThreads, 0,
                             stream>>>(lex, cur(t, j - 1), is_pad_t,
                                       cur(t, j), S, V);
      RETURN_IF_ERROR(cudaGetLastError());
    }
  }
  update_kernel<<<blocks_for(bs), kPointThreads, 0, stream>>>(
      alpha + ((T - 1) % 2) * bs, blank, cur(T - 1, 0), stride,
      is_pad + static_cast<size_t>(T - 1) * B, alpha + (T % 2) * bs, nullptr,
      B, S, passes, frame_dependent);
  RETURN_IF_ERROR(cudaGetLastError());
  return 0;
}

// The backward's frames (module comment above), then the sums of the
// cross-frame partials. nb holds nb_1..nb_{k-1} ([max(k - 1, 1), B, S]);
// nb_k = blank + beta is formed where it is read. The entry point runs it
// where route_smem is not 0.
template <int G, int NS>
int backward_frames(const float* pf, const float* pc, const bf16* vw16,
                    const float* vb, const float* bw32, const float* bb,
                    const int* is_pad, const float* log_z, const float* g,
                    const float* hist, const float* slabs, float* blank,
                    float* lex, float* nb, float* beta, float* dpf,
                    float* dpf_part, float* dpc_acc, float* dvw_acc,
                    float* dvb_acc, float* dbw_acc, float* dbb_acc,
                    float* dpc, float* dvw, float* dvb, float* dbw,
                    float* dbb, int T, int B, int S, int h, int V,
                    int max_expansions, int frame_dependent,
                    cudaStream_t stream) {
  const int k = frame_dependent ? 0 : max_expansions;
  const int passes = frame_dependent ? 1 : max_expansions;
  const int hp = round_up(h, 64), Vp = round_up(V, 64);
  const int groups = cdiv(B, G), blocks = (V + 1) * groups;
  const size_t bs = static_cast<size_t>(B) * S;
  constexpr auto head = head_kernel<G, NS, false>;
  // grad_kernel knows the pair count of FD, FLD(1) and FLD(2).
  const auto grad = passes == 1   ? grad_kernel<G, NS, 1>
                    : passes == 2 ? grad_kernel<G, NS, 2>
                                  : grad_kernel<G, NS, 0>;
  const int head_smem = HeadSmem<G, NS>::bytes(hp);
  const int grad_smem = GradSmem<G, NS>::bytes(hp);
  CUtensorMap map;
  if (T > 0 && B > 0) {
    RETURN_IF_ERROR(allow_smem<head>(head_smem));
    RETURN_IF_ERROR((passes == 1 ? allow_smem<grad_kernel<G, NS, 1>>(grad_smem)
                     : passes == 2
                         ? allow_smem<grad_kernel<G, NS, 2>>(grad_smem)
                         : allow_smem<grad_kernel<G, NS, 0>>(grad_smem)));
    RETURN_IF_ERROR(head_map(&map, vw16, hp, Vp));
  }
  const dim3 grid(V + 1, groups);
  auto nb_at = [&](int j) { return nb + (j - 1) * bs; };  // nb_j, 1 <= j < k
  for (int n = 0; n < T; ++n) {
    const int t = T - 1 - n;
    const int* is_pad_t = is_pad + static_cast<size_t>(t) * B;
    const float* pf_t = pf + static_cast<size_t>(t) * B * h;
    const float* beta_cur = beta + (n % 2) * bs;
    float* beta_next = beta + ((n + 1) % 2) * bs;
    Head hd{pc, pf_t, is_pad_t, vb, bw32, bb, blank, lex};
    hd.B = B, hd.S = S, hd.h = h, hd.hp = hp, hd.V = V;
    head<<<grid, G * kThreads, head_smem, stream>>>(map, hd);
    RETURN_IF_ERROR(cudaGetLastError());
    for (int j = k - 1; j >= 1; --j) {  // nb_j from nb_{j+1}
      const bool top = j + 1 == k;
      row_kernel<<<cdiv(static_cast<int>(bs), 8), 256, 0, stream>>>(
          lex, blank, beta_cur, top ? blank : nb_at(j + 1),
          top ? beta_cur : nullptr, is_pad_t, nb_at(j), B, S, V);
      RETURN_IF_ERROR(cudaGetLastError());
    }
    Grad p{pc, pf_t, is_pad_t, lex, blank, beta_cur};
    p.x = frame_dependent ? beta_cur : k == 1 ? nullptr : nb_at(1);
    p.alphas.n = 1 + k;
    p.alphas.a[0] = hist + t * bs;
    for (int j = 0; j < k; ++j) {
      p.alphas.a[1 + j] = slabs + (static_cast<size_t>(j) * T + t) * bs;
    }
    p.pairs.n = passes;
    for (int j = 0; j < passes; ++j) {
      p.pairs.a[j] = p.alphas.a[j];
      p.pairs.nb[j] = frame_dependent ? beta_cur
                      : j + 1 == k    ? nullptr
                                      : nb_at(j + 1);
    }
    p.log_z = log_z, p.g = g, p.bw32 = bw32, p.beta_next = beta_next;
    p.dpc_acc = dpc_acc, p.dvw_acc = dvw_acc, p.dvb_acc = dvb_acc;
    p.dbw_acc = dbw_acc, p.dbb_acc = dbb_acc, p.dpf_part = dpf_part;
    p.B = B, p.S = S, p.h = h, p.hp = hp, p.V = V, p.Vp = Vp;
    grad<<<grid, G * kThreads, grad_smem, stream>>>(map, p);
    RETURN_IF_ERROR(cudaGetLastError());
    dpf_reduce_kernel<<<blocks_for(static_cast<size_t>(B) * h),
                        kPointThreads, 0, stream>>>(
        dpf_part, is_pad_t, dpf + static_cast<size_t>(t) * B * h, B, h,
        V + 1);
    RETURN_IF_ERROR(cudaGetLastError());
  }
  using head_grads::Sums;
  const Sums sums{{{dpc_acc, groups, S * h, dpc},
                   {dvw_acc, blocks, h * V, dvw},
                   {dvb_acc, blocks, V, dvb},
                   {dbw_acc, blocks, h, dbw},
                   {dbb_acc, blocks, 1, dbb}},
                  5};
  RETURN_IF_ERROR(head_grads::launch_sums(sums, stream));
  return 0;
}

#undef RETURN_IF_ERROR

}  // namespace segments

template <typename T, bool TRI>
int run_backward(const float* pf, const float* pc, const T* vw,
                 const float* vb, const T* bw, const float* bw32,
                 const float* bb, const int* is_pad, const float* log_z,
                 const float* g, const float* hist, const float* slabs,
                 T* joint, float* blank, float* lex, T* d_lex, float* d_blank,
                 float* part_m, float* part_l, float* nb, float* beta,
                 float* dpf, float* dpf_part, float* dpc_acc, float* dvw_acc,
                 float* dvb_acc, float* dbw_acc, float* dbb_acc, float* dpc,
                 float* dvw, float* dvb, float* dbw, float* dbb,
                 int num_frames, int B, int S, int h, int V,
                 int max_expansions, int frame_dependent, int online,
                 int chunk_states, int max_ysplits, int max_ksplits,
                 cudaStream_t stream) {
  const ReverseScan scan(B, S, h, V, max_expansions, frame_dependent,
                         max_ysplits);
  if (scan.k + 1 > kMaxAlphas) return static_cast<int>(cudaErrorInvalidValue);
  // Cache: one chunk of all S states over the staged lex. Online (float32
  // here; bfloat16 runs in hopper::run_backward): chunks of whole tiles,
  // lex recomputed; d_lex holds one chunk.
  const int chunk = online ? chunk_states : S;
  if (chunk <= 0 || (chunk < S && chunk % kBM != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t bs = static_cast<size_t>(B) * S;
  const int tiles = scan.tiles, strips = scan.strips;
  const int h_tiles = (h + kBM - 1) / kBM;
  const int max_rows = B * chunk;
  int rows_per_split =
      (max_rows + max_ksplits - 1) / (max_ksplits > 0 ? max_ksplits : 1);
  rows_per_split = (rows_per_split + kWK - 1) / kWK * kWK;
  const int ksplits = (max_rows + rows_per_split - 1) / rows_per_split;
  for (int n = 0; n < num_frames; ++n) {
    const int t = num_frames - 1 - n;
    const int* is_pad_t = is_pad + static_cast<size_t>(t) * B;
    const float* pf_t = pf + static_cast<size_t>(t) * B * h;
    Pairs pairs;
    const int status = scan.step<T, TRI>(
        t, num_frames, pf, is_pad, pc, vw, vb, bw, bb, log_z, g, hist, slabs,
        joint, blank, online ? nullptr : lex, part_m, part_l, nb,
        beta + (n % 2) * bs, beta + ((n + 1) % 2) * bs, d_blank, dbb_acc, 1,
        pairs, stream);
    if (status != 0) return status;
    for (int s_begin = 0; s_begin < S; s_begin += chunk) {
      const int s_count = min(chunk, S - s_begin);
      const int chunk_tiles = (s_count + kBM - 1) / kBM;
      if (online) {
        marginal_kernel<T, kCompute, TRI>
            <<<dim3(strips, chunk_tiles, B), kThreads, 0, stream>>>(
            joint, vw, vb, nullptr, pairs, log_z, g, is_pad_t, d_lex,
            dvb_acc, 1, S, h, V, s_begin, s_count, tiles);
      } else {
        marginal_kernel<T, kLoad, TRI>
            <<<dim3(strips, chunk_tiles, B), kThreads, 0, stream>>>(
            joint, vw, vb, lex, pairs, log_z, g, is_pad_t, d_lex, dvb_acc, 1,
            S, h, V, s_begin, s_count, tiles);
      }
      RETURN_IF_LAUNCH_FAILED();
      head_grad_kernel<T><<<dim3(strips, h_tiles, ksplits), kThreads, 0,
                            stream>>>(joint, d_lex, dvw_acc, B, S, s_begin,
                                      s_count, h, V, rows_per_split);
      RETURN_IF_LAUNCH_FAILED();
      joint_grad_kernel<T><<<dim3(h_tiles, chunk_tiles, B), kThreads, 0,
                             stream>>>(d_lex, vw, bw32, d_blank, pc, pf_t,
                                       is_pad_t, dpc_acc, dpf_part, dbw_acc,
                                       S, h, V, s_begin, s_count, tiles);
      RETURN_IF_LAUNCH_FAILED();
    }
    dpf_reduce_kernel<<<blocks_for(static_cast<size_t>(B) * h), kPointThreads,
                        0, stream>>>(dpf_part, is_pad_t,
                                     dpf + static_cast<size_t>(t) * B * h, B,
                                     h, tiles);
    RETURN_IF_LAUNCH_FAILED();
  }
  const struct {
    const float* in;
    int rows, n;
    float* out;
  } sums[] = {{dpc_acc, B, S * h, dpc},
              {dvw_acc, ksplits, h * V, dvw},
              {dvb_acc, B * tiles, V, dvb},
              {dbw_acc, B * tiles, h, dbw},
              {dbb_acc, B * S, 1, dbb}};
  for (const auto& sum : sums) {
    sum_rows_kernel<<<blocks_for(sum.n), kPointThreads, 0, stream>>>(
        sum.in, sum.rows, sum.n, sum.out);
    RETURN_IF_LAUNCH_FAILED();
  }
  return 0;
}

template <typename T>
int run_marginals(const float* pf, const float* pc, const T* vw,
                  const float* vb, const T* bw, const float* bb,
                  const int* is_pad, const float* log_z, const float* hist,
                  const float* slabs, T* joint, float* blank, float* lex,
                  float* part_m, float* part_l, float* nb, float* beta,
                  float* lp_part, float* bm, float* lp, int num_frames, int B,
                  int S, int h, int V, int max_expansions,
                  int frame_dependent, int max_ysplits, cudaStream_t stream) {
  const ReverseScan scan(B, S, h, V, max_expansions, frame_dependent,
                         max_ysplits);
  if (scan.k + 1 > kMaxAlphas) return static_cast<int>(cudaErrorInvalidValue);
  const size_t bs = static_cast<size_t>(B) * S;
  for (int n = 0; n < num_frames; ++n) {
    const int t = num_frames - 1 - n;
    const int* is_pad_t = is_pad + static_cast<size_t>(t) * B;
    Pairs pairs;
    // g = 1: d_blank is the frame's blank posterior, written in place.
    const int status = scan.step<T, false>(
        t, num_frames, pf, is_pad, pc, vw, vb, bw, bb, log_z, nullptr, hist,
        slabs, joint, blank, lex, part_m, part_l, nb, beta + (n % 2) * bs,
        beta + ((n + 1) % 2) * bs, bm + t * bs, nullptr, 0, pairs, stream);
    if (status != 0) return status;
    marginal_kernel<T, kLoad, false>
        <<<dim3(scan.strips, scan.tiles, B), kThreads, 0, stream>>>(
        joint, vw, vb, lex, pairs, log_z, nullptr, is_pad_t, nullptr, lp_part,
        0, S, h, V, 0, S, scan.tiles);
    RETURN_IF_LAUNCH_FAILED();
    label_sum_kernel<<<blocks_for(static_cast<size_t>(B) * V), kPointThreads,
                       0, stream>>>(lp_part, is_pad_t,
                                    lp + static_cast<size_t>(t) * B * V, B,
                                    scan.tiles, V);
    RETURN_IF_LAUNCH_FAILED();
  }
  return 0;
}

// The dtype dispatch of the backward's entry points (fused_backward,
// trigram_backward).
template <bool TRI>
int backward_entry(int dtype, const float* pf, const float* pc,
                   const void* vw, const float* vb, const void* bw,
                   const float* bw32, const float* bb, const int* is_pad,
                   const float* log_z, const float* g, const float* hist,
                   const float* slabs, void* joint, float* blank, float* lex,
                   void* d_lex, float* d_blank, float* part_m, float* part_l,
                   float* nb, float* beta, float* dpf, float* dpf_part,
                   float* dpc_acc, float* dvw_acc, float* dvb_acc,
                   float* dbw_acc, float* dbb_acc, float* dpc, float* dvw,
                   float* dvb, float* dbw, float* dbb, int num_frames, int B,
                   int S, int h, int V, int max_expansions,
                   int frame_dependent, int online, int chunk_states,
                   int max_ysplits, int max_ksplits, const int* live,
                   const int* rows, int dsplits, float* joint32,
                   void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int passes = frame_dependent ? 1 : max_expansions;
  if (!TRI && dtype == 1 && passes >= 1) {  // either mode
    using hopper::bf16;
    return hopper::run_backward(
        pf, pc, static_cast<const bf16*>(vw), vb,
        static_cast<const bf16*>(bw), bw32, bb, is_pad, log_z, g, hist,
        slabs, static_cast<bf16*>(joint), joint32, blank,
        static_cast<bf16*>(d_lex), d_blank, part_m, part_l, nb, beta, dpf,
        dpf_part, dpc_acc, dvw_acc, dvb_acc, dbw_acc, dbb_acc, dpc, dvw, dvb,
        dbw, dbb, num_frames, B, S, h, V, max_expansions, frame_dependent,
        max_ksplits, dsplits, live, rows, online ? chunk_states : S, s);
  }
  if (dtype == 0) {
    return run_backward<float, TRI>(
        pf, pc, static_cast<const float*>(vw), vb,
        static_cast<const float*>(bw), bw32, bb, is_pad, log_z, g, hist,
        slabs, static_cast<float*>(joint), blank, lex,
        static_cast<float*>(d_lex), d_blank, part_m, part_l, nb, beta, dpf,
        dpf_part, dpc_acc, dvw_acc, dvb_acc, dbw_acc, dbb_acc, dpc, dvw, dvb,
        dbw, dbb, num_frames, B, S, h, V, max_expansions, frame_dependent,
        online, chunk_states, max_ysplits, max_ksplits, s);
  }
  if (dtype == 1) {
    return run_backward<__nv_bfloat16, TRI>(
        pf, pc, static_cast<const __nv_bfloat16*>(vw), vb,
        static_cast<const __nv_bfloat16*>(bw), bw32, bb, is_pad, log_z, g,
        hist, slabs, static_cast<__nv_bfloat16*>(joint), blank, lex,
        static_cast<__nv_bfloat16*>(d_lex), d_blank, part_m, part_l, nb,
        beta, dpf, dpf_part, dpc_acc, dvw_acc, dvb_acc, dbw_acc, dbb_acc, dpc,
        dvw, dvb, dbw, dbb, num_frames, B, S, h, V, max_expansions,
        frame_dependent, online, chunk_states, max_ysplits, max_ksplits, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// Runs the whole forward on `stream` and returns the first launch error
// (0 on success). The caller allocates everything. `alpha` is [2, B, S]
// with alpha0 in slot 0 on entry; the final alpha is left in slot
// num_frames % 2. With `slabs` ([k, T, B, S]) the expansions are written
// there, else to `last` ([max(k, 1), B, S]); `hist` ([T, B, S]) may be
// null. dtype 0 = float32, 1 = bfloat16 (the compute type).
// In bfloat16 (either mode) the frames run on head_product.cuh's wgmma
// column reduction over their live rows: live [T] (host memory) counts
// each frame's real rows and rows [T, B] (device) lists them first; vw
// ([h, V]) and bw ([h]) are then float32, joint is bfloat16 [B, S, hp] and
// vw16 bfloat16 [hp, Vp] (hp, Vp: h and V rounded up to 64), part_m /
// part_l are [ceil(S / 64), B, V], the product runs on at most max_blocks
// persistent blocks, and with `online` 0 `lex` ([B, S, V] float32) is
// staged by the first reduction for the later ones: it is needed with two
// or more reductions per frame, and not used with fewer, nor with
// `online` 1, where every reduction runs the product.
// In float32 vw, bw and joint ([B, S, h]) are float32, live, rows and vw16
// are not used, part_m / part_l hold [max_splits, B, V] per-split
// partials, and `lex` ([B, S, V]) is used only with two or more reductions
// per frame and `online` 0; with `online` 1 every reduction recomputes the
// head product and `lex` may be null.
int fused_forward(int dtype, const float* pf, const float* pc, const void* vw,
                  const float* vb, const void* bw, const float* bb,
                  const int* is_pad, void* joint, float* blank, float* lex,
                  float* part_m, float* part_l, float* last, float* alpha,
                  float* hist, float* slabs, int num_frames, int B, int S,
                  int h, int V, int max_expansions, int frame_dependent,
                  int online, int max_splits, const int* live,
                  const int* rows, void* vw16, int max_blocks, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    using hopper::bf16;
    return hopper::run_forward(
        pf, pc, static_cast<const float*>(vw), vb,
        static_cast<const float*>(bw), bb, is_pad, live, rows,
        static_cast<bf16*>(joint), static_cast<bf16*>(vw16), blank, lex,
        part_m, part_l, last, alpha, hist, slabs, num_frames, B, S, h, V,
        max_expansions, frame_dependent, online, max_blocks, s);
  }
  if (dtype == 0) {
    return run_forward(
        pf, pc, static_cast<const float*>(vw), vb,
        static_cast<const float*>(bw), bb, is_pad, static_cast<float*>(joint),
        blank, lex, part_m, part_l, last, alpha, hist, slabs, num_frames, B,
        S, h, V, max_expansions, frame_dependent, online, max_splits, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Runs the whole backward on `stream`; returns the first launch error. The
// caller allocates everything: scratch joint ([B, S, h] in the compute
// type), blank / d_blank ([B, S]), lex ([B, S, V]; null with `online`),
// d_lex in the compute type ([B, S, V]; with `online`, [B, chunk_states,
// V], chunk_states a multiple of 64 or at least S), part_m / part_l
// ([max_ysplits, B, S]), nb ([max(k, 1), B, S]), beta ([2, B, S], zero in
// slot 0 on entry; the final beta is left in slot num_frames % 2), dpf_part
// ([ceil(S/64), B, h]); zeroed accumulators dpc_acc [B, S, h], dvw_acc
// [max_ksplits, h, V], dvb_acc [B, ceil(S/64), V], dbw_acc [B, ceil(S/64),
// h], dbb_acc [B, S]; outputs dpf [T, B, h], dpc [S, h], dvw [h, V], dvb
// [V], dbw [h], dbb [1].
// In bfloat16, FD or FLD(k >= 1), either mode, the frames run on the wgmma
// kernels of `hopper` over their live rows: live [T] (host memory) counts
// each frame's real rows and rows [T, B] (device) lists them first. Then vw
// and joint are padded: vw [hp, Vp], joint [B, S, hp] (hp, Vp: h and V
// rounded up to 64, vw's padding zero), with joint32 [B, S, h] (float32)
// beside it; d_lex is [B, S, Vp] in 'cache' mode and [B, chunk_states, Vp]
// in 'online' mode; part_m / part_l are [ceil(Vp / 128), B, S]; dpc_acc is
// [dsplits, S, h] and dvw_acc [max_ksplits, h, V], every split used; lex is
// not used (each row reduction recomputes the head product) and may be
// null. Elsewhere live, rows and joint32 may be null.
int fused_backward(int dtype, const float* pf, const float* pc,
                   const void* vw, const float* vb, const void* bw,
                   const float* bw32, const float* bb, const int* is_pad,
                   const float* log_z, const float* g, const float* hist,
                   const float* slabs, void* joint, float* blank, float* lex,
                   void* d_lex, float* d_blank, float* part_m, float* part_l,
                   float* nb, float* beta, float* dpf, float* dpf_part,
                   float* dpc_acc, float* dvw_acc, float* dvb_acc,
                   float* dbw_acc, float* dbb_acc, float* dpc, float* dvw,
                   float* dvb, float* dbw, float* dbb, int num_frames, int B,
                   int S, int h, int V, int max_expansions,
                   int frame_dependent, int online, int chunk_states,
                   int max_ysplits, int max_ksplits, const int* live,
                   const int* rows, int dsplits, float* joint32,
                   void* stream) {
  return backward_entry<false>(
      dtype, pf, pc, vw, vb, bw, bw32, bb, is_pad, log_z, g, hist, slabs,
      joint, blank, lex, d_lex, d_blank, part_m, part_l, nb, beta, dpf,
      dpf_part, dpc_acc, dvw_acc, dvb_acc, dbw_acc, dbb_acc, dpc, dvw, dvb,
      dbw, dbb, num_frames, B, S, h, V, max_expansions, frame_dependent,
      online, chunk_states, max_ysplits, max_ksplits, live, rows, dsplits,
      joint32, stream);
}

// The trigram forward (FullNGram(2), S = 1 + V + V^2) on `stream`; returns
// the first launch error. Arguments as fused_forward's, without the
// bigram's split partials and `online`: `lex` ([B, S, V]) is always staged
// when a frame has a sweep.
int trigram_forward(int dtype, const float* pf, const float* pc,
                    const void* vw, const float* vb, const void* bw,
                    const float* bb, const int* is_pad, void* joint,
                    float* blank, float* lex, float* last, float* alpha,
                    float* hist, float* slabs, int num_frames, int B, int S,
                    int h, int V, int max_expansions, int frame_dependent,
                    void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return run_trigram_forward<float>(
        pf, pc, static_cast<const float*>(vw), vb,
        static_cast<const float*>(bw), bb, is_pad, static_cast<float*>(joint),
        blank, lex, last, alpha, hist, slabs, num_frames, B, S, h, V,
        max_expansions, frame_dependent, s);
  }
  if (dtype == 1) {
    return run_trigram_forward<__nv_bfloat16>(
        pf, pc, static_cast<const __nv_bfloat16*>(vw), vb,
        static_cast<const __nv_bfloat16*>(bw), bb, is_pad,
        static_cast<__nv_bfloat16*>(joint), blank, lex, last, alpha, hist,
        slabs, num_frames, B, S, h, V, max_expansions, frame_dependent, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The trigram backward on `stream`; returns the first launch error.
// Arguments as fused_backward's in its cache mode (lex and d_lex [B, S, V]
// staged), with the trigram's destinations.
int trigram_backward(int dtype, const float* pf, const float* pc,
                     const void* vw, const float* vb, const void* bw,
                     const float* bw32, const float* bb, const int* is_pad,
                     const float* log_z, const float* g, const float* hist,
                     const float* slabs, void* joint, float* blank,
                     float* lex, void* d_lex, float* d_blank, float* part_m,
                     float* part_l, float* nb, float* beta, float* dpf,
                     float* dpf_part, float* dpc_acc, float* dvw_acc,
                     float* dvb_acc, float* dbw_acc, float* dbb_acc,
                     float* dpc, float* dvw, float* dvb, float* dbw,
                     float* dbb, int num_frames, int B, int S, int h, int V,
                     int max_expansions, int frame_dependent,
                     int max_ysplits, int max_ksplits, void* stream) {
  return backward_entry<true>(
      dtype, pf, pc, vw, vb, bw, bw32, bb, is_pad, log_z, g, hist, slabs,
      joint, blank, lex, d_lex, d_blank, part_m, part_l, nb, beta, dpf,
      dpf_part, dpc_acc, dvw_acc, dvb_acc, dbw_acc, dbb_acc, dpc, dvw, dvb,
      dbw, dbb, num_frames, B, S, h, V, max_expansions, frame_dependent, 0, S,
      max_ysplits, max_ksplits, nullptr, nullptr, 0, nullptr, stream);
}

// Runs the marginals' reverse scan on `stream`; returns the first launch
// error. Inputs as the backward's (log_z, hist, slabs from the forward);
// scratch joint ([B, S, h] in the compute type), blank ([B, S]), lex ([B,
// S, V]), part_m / part_l ([max_ysplits, B, S]), nb ([max(k, 1), B, S]),
// beta ([2, B, S], zero in slot 0 on entry), lp_part ([B, ceil(S/64), V]);
// outputs bm [T, B, S] (blank posteriors) and lp [T, B, V] (label
// posteriors summed over the states), zero on padding frames.
// In bfloat16, FD or FLD(k >= 1), the frames run on the backward's wgmma
// row reductions over their live rows (hopper::run_marginals): live [T]
// (host memory) counts each frame's real rows and rows [T, B] (device)
// lists them first; vw is then the padded head [hp, Vp] and joint [B, S,
// hp] (hp, Vp: h and V rounded up to 64, vw's padding zero), part_m /
// part_l are [ceil(Vp / 128), B, S], and lex is not used (each reduction
// recomputes the head product) and may be null. Elsewhere live and rows
// may be null.
int fused_marginals(int dtype, const float* pf, const float* pc,
                    const void* vw, const float* vb, const void* bw,
                    const float* bb, const int* is_pad, const float* log_z,
                    const float* hist, const float* slabs, void* joint,
                    float* blank, float* lex, float* part_m, float* part_l,
                    float* nb, float* beta, float* lp_part, float* bm,
                    float* lp, int num_frames, int B, int S, int h, int V,
                    int max_expansions, int frame_dependent, int max_ysplits,
                    const int* live, const int* rows, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int passes = frame_dependent ? 1 : max_expansions;
  if (dtype == 1 && passes >= 1) {
    using hopper::bf16;
    return hopper::run_marginals(
        pf, pc, static_cast<const bf16*>(vw), vb,
        static_cast<const bf16*>(bw), bb, is_pad, log_z, hist, slabs,
        static_cast<bf16*>(joint), blank, part_m, part_l, nb, beta, lp_part,
        bm, lp, num_frames, B, S, h, V, max_expansions, frame_dependent,
        live, rows, s);
  }
  if (dtype == 0) {
    return run_marginals<float>(
        pf, pc, static_cast<const float*>(vw), vb,
        static_cast<const float*>(bw), bb, is_pad, log_z, hist, slabs,
        static_cast<float*>(joint), blank, lex, part_m, part_l, nb, beta,
        lp_part, bm, lp, num_frames, B, S, h, V, max_expansions,
        frame_dependent, max_ysplits, s);
  }
  if (dtype == 1) {
    return run_marginals<__nv_bfloat16>(
        pf, pc, static_cast<const __nv_bfloat16*>(vw), vb,
        static_cast<const __nv_bfloat16*>(bw), bb, is_pad, log_z, hist, slabs,
        static_cast<__nv_bfloat16*>(joint), blank, lex, part_m, part_l, nb,
        beta, lp_part, bm, lp, num_frames, B, S, h, V, max_expansions,
        frame_dependent, max_ysplits, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Bytes of dynamic shared memory the bfloat16 trigram by segment takes for
// a call of hidden size h, V labels and `passes` reductions a frame (1 for
// FD, k for FLD(k)), or 0 where trigram_segment_forward and
// trigram_segment_backward do not run it and the caller takes
// trigram_forward / trigram_backward.
int trigram_segment_smem(int h, int V, int passes) {
  return segments::route_smem(h, V, passes);
}

// The bfloat16 trigram by segment (namespace segments), FD or FLD(k >= 1)
// where trigram_segment_smem is not 0, on `stream`; returns the first
// launch error. vw16 is the padded bfloat16 head [hp, Vp] (hp, Vp: h and V
// rounded up to 64, zeros past h and V), bw the float32 blank head [h],
// blank [B, S] scratch, lex [B, S, V] float32 scratch (may be null with one
// reduction a frame), last [2, k, B, S] the expansions when slabs is null;
// alpha, hist and slabs as trigram_forward's.
int trigram_segment_forward(const float* pf, const float* pc,
                            const void* vw16, const float* vb,
                            const float* bw, const float* bb,
                            const int* is_pad, float* blank, float* lex,
                            float* last, float* alpha, float* hist,
                            float* slabs, int num_frames, int B, int S,
                            int h, int V, int max_expansions,
                            int frame_dependent, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int passes = frame_dependent ? 1 : max_expansions;
  const int Vp = wgmma_tiles::round_up(V, 64);
  const auto* head = static_cast<const segments::bf16*>(vw16);
  if (segments::route_smem(h, V, passes) == 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return Vp <= 64 ? segments::forward_frames<4, 1>(
                        pf, pc, head, vb, bw, bb, is_pad, blank, lex, last,
                        alpha, hist, slabs, num_frames, B, S, h, V, passes,
                        frame_dependent, s)
                  : segments::forward_frames<2, 2>(
                        pf, pc, head, vb, bw, bb, is_pad, blank, lex, last,
                        alpha, hist, slabs, num_frames, B, S, h, V, passes,
                        frame_dependent, s);
}

// Its backward on `stream`; returns the first launch error. vw16, bw32 and
// blank as the forward's; lex [B, S, V] float32 scratch; nb [max(k - 1, 1),
// B, S]; beta [2, B, S] zero in slot 0 on entry (the final beta is left in
// slot num_frames % 2); dpf_part [V + 1, B, h]; zeroed accumulators
// dpc_acc [ceil(B / G), S, h], dvw_acc [blocks, h, V], dvb_acc [blocks, V],
// dbw_acc [blocks, h], dbb_acc [blocks] (G = 4 for V <= 64, else 2; blocks
// = (V + 1) ceil(B / G)); outputs as trigram_backward's.
int trigram_segment_backward(
    const float* pf, const float* pc, const void* vw16, const float* vb,
    const float* bw32, const float* bb, const int* is_pad,
    const float* log_z, const float* g, const float* hist,
    const float* slabs, float* blank, float* lex, float* nb, float* beta,
    float* dpf, float* dpf_part, float* dpc_acc, float* dvw_acc,
    float* dvb_acc, float* dbw_acc, float* dbb_acc, float* dpc, float* dvw,
    float* dvb, float* dbw, float* dbb, int num_frames, int B, int S, int h,
    int V, int max_expansions, int frame_dependent, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int Vp = wgmma_tiles::round_up(V, 64);
  const auto* head = static_cast<const segments::bf16*>(vw16);
  if (segments::route_smem(h, V, frame_dependent ? 1 : max_expansions) ==
      0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return Vp <= 64
             ? segments::backward_frames<4, 1>(
                   pf, pc, head, vb, bw32, bb, is_pad, log_z, g, hist, slabs,
                   blank, lex, nb, beta, dpf, dpf_part, dpc_acc, dvw_acc,
                   dvb_acc, dbw_acc, dbb_acc, dpc, dvw, dvb, dbw, dbb,
                   num_frames, B, S, h, V, max_expansions, frame_dependent, s)
             : segments::backward_frames<2, 2>(
                   pf, pc, head, vb, bw32, bb, is_pad, log_z, g, hist, slabs,
                   blank, lex, nb, beta, dpf, dpf_part, dpc_acc, dvw_acc,
                   dvb_acc, dbw_acc, dbb_acc, dpc, dvw, dvb, dbw, dbb,
                   num_frames, B, S, h, V, max_expansions, frame_dependent,
                   s);
}

const char* fused_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
