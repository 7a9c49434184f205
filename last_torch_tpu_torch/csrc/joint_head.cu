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
// plain versions, runs on the CUDA cores (67 TFLOP/s).
//
// What the design does about it:
// * bfloat16 forward (namespace hopper), two launches. joint_pass_kernel
//   forms every joint entry once per call, tanh(pc + pf) rounded to
//   bfloat16 into a [B S, hp] scratch (hp: h rounded up to 64, zero past h;
//   8.4 MB at the headline, resident in the 50 MB L2), with the blank head
//   as a warp's dot over the rounded row; its last hp rows round vocab_w
//   into a padded [hp, Vp] bfloat16 copy (zero past h and V). The TPU
//   kernel kept the whole head resident in VMEM and formed each joint tile
//   once; here the joint is formed once and both operands of the product
//   reach shared memory by TMA. head_product_kernel runs on the backward's
//   wgmma machinery (wgmma_tiles.cuh: m64n128k16 from 128-byte-swizzled
//   shared memory, one producer thread streaming 64-deep stages through a
//   3-stage mbarrier ring) with two consumer warpgroups, which share each
//   stage's head boxes: a (128-row, 128-label) tile reads 128 KB of
//   operands from the L2 cache at h=512, where a 64-row tile read 192 KB
//   for half the work, and those reads bound the product. It runs as a
//   persistent grid: each of at most two blocks an SM walks over output
//   tiles, the ring loading the next tile's stages while the warpgroups
//   add vb and store the last one. The stores go from registers, 16 bytes
//   a thread (a pair of lanes swaps halves so that each holds four
//   consecutive labels) where V is a multiple of 4; else each warp passes
//   its rows through a shared-memory scratch and stores 32 consecutive
//   labels of a row at a time. Both carry the streaming (evict-first)
//   hint: the output must not push the joint and the head out of the L2
//   cache. With two blocks an SM one block's stores run under the other's
//   products.
// * bfloat16 backward: 128 x 128 output tiles per block, 8 warps of 32 x 64
//   through WMMA (mma.sync, float32 accumulation), 16-deep stages, two
//   blocks per SM; the joint formed slice by slice as the operand is staged
//   in shared memory (joint_tiles.cuh's mainloop). Each thread loads its
//   share of the next stage into registers before the current stage's
//   products and converts and stores it after them; where h and V are
//   multiples of 4 it loads 16 bytes at a time. The d_joint product runs
//   per (row tile, hidden tile) over the B S rows, one wave of blocks at
//   the headline shape, and writes du [B, S, h], whose batch-row sums
//   (d_pc) and state sums (d_pf, by 32-state chunks) are reductions. d_pf /
//   d_blank_w go to per-tile partials; d_vocab_w splits its long
//   contraction (over B S rows) across blocks into per-split partials, as
//   many splits as fill one wave. Every partial belongs to one block and is
//   reduced by a second launch: no atomics, deterministic sums.
// * float32: one 64 x 64 tile per block through FMAs (a 4 x 4 register
//   tile per thread), as tile_product.cuh's products but with producers in
//   place of loads, the joint formed as it is staged; the blank head a
//   warp-per-row dot.
// * The forward writes blank [B, S] and lexical [B, S, V] as two contiguous
//   outputs.
// The backward and its tile machinery live in joint_tiles.cuh, shared with
// sharded_scan.cu's frame reduction.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "joint_tiles.cuh"
#include "wgmma_tiles.cuh"

namespace {

// ---------------------------------------------------------------------------
// bfloat16 forward on wgmma.
namespace hopper {

using namespace wgmma_tiles;

constexpr int kPassThreads = 256;  // a warp per row

// Rows [0, B S) of the grid: joint[m, :hp] = bf16(tanh(pc[m % S] + pf[m /
// S])) (zero past h) and blank[m] = joint[m] . bf16(bw) + bb; rows [B S,
// B S + hp): vw16[k, :Vp] = bf16(vw[k, :V]) (zero past V or h). A lane
// takes 4 consecutive entries, with 16-byte loads where Vec (h and V
// multiples of 4, the inputs 16-byte aligned). Grid ceil((B S + hp) / 8).
template <bool Vec>
__global__ void __launch_bounds__(kPassThreads)
    joint_pass_kernel(const float* __restrict__ pc,  // [S, h]
                      const float* __restrict__ pf,  // [B, h]
                      const float* __restrict__ vw,  // [h, V]
                      const float* __restrict__ bw,  // [h]
                      const float* __restrict__ bb,  // [1]
                      bf16* __restrict__ joint,      // [B S, hp]
                      bf16* __restrict__ vw16,       // [hp, Vp]
                      float* __restrict__ blank,     // [B S]
                      int B, int S, int h, int hp, int V, int Vp) {
  const int M = B * S;
  const int row = blockIdx.x * (kPassThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  // Entries k..k+3 of a row of n valid ones (zero past n).
  const auto load4 = [&](const float* src, int k, int n, float (&x)[4]) {
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
    bf16* out = joint + static_cast<size_t>(row) * hp;
    float dot = 0.f;
    for (int k = lane * 4; k < hp; k += 128) {
      float c[4], f[4], w[4], j[4];
      load4(pc_s, k, h, c);
      load4(pf_b, k, h, f);
      load4(bw, k, h, w);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        j[e] = k + e < h
                   ? __bfloat162float(__float2bfloat16(tanhf(c[e] + f[e])))
                   : 0.f;
        dot = fmaf(j[e], __bfloat162float(__float2bfloat16(w[e])), dot);
      }
      store4(out + k, j);
    }
    for (int o = 16; o > 0; o >>= 1) {
      dot += __shfl_xor_sync(0xffffffffu, dot, o);
    }
    if (lane == 0) blank[row] = dot + bb[0];
  } else if (row < M + hp) {
    const int k = row - M;
    const float* src = vw + static_cast<size_t>(k) * V;
    bf16* out = vw16 + static_cast<size_t>(k) * Vp;
    for (int y = lane * 4; y < Vp; y += 128) {
      float x[4];
      load4(src, y, k < h ? V : 0, x);
      store4(out + y, x);
    }
  }
}

// The product's operands: the joint [B S, hp] (K-major) and vw16 [hp, Vp]
// (MN-major), bfloat16, in 64 x 64 boxes.
struct ProductMaps {
  CUtensorMap joint, vw;
};

struct HeadProduct {
  const float* vb;  // [V]
  float* lex;       // [M, V]
  int M, V, hp, Vp;
};

// The product's block: two consumer warpgroups, each 64 rows of a 128-row
// tile, sharing the tile's 128-label strip of the head, and a producer
// warp. A stage holds 64 depths: the two row boxes, then the strip's two
// column boxes. Sharing the head's boxes between two row tiles cuts the
// operand bytes per output tile from 192 KB to 128 KB (h=512), which the L2
// cache has to deliver.
constexpr int kGroups = 2;
constexpr int kTileRows = kGroups * kRows;
constexpr int kProductThreads = kGroups * kConsumers + 32;
constexpr int kProductStages = 3;
constexpr int kProductStageBytes = kGroups * kBox + 2 * kBox;
// Where V is not a multiple of 4 the rows are not 16-byte aligned: each
// warp then stores through its own [8 rows][33] float32 scratch, 32
// consecutive labels of a row at a time (small enough to keep two blocks
// an SM).
constexpr int kStageLd = 33;
constexpr int kStoreScratch = kGroups * 4 * 8 * kStageLd * 4;
template <bool Vec>
constexpr int product_smem() {
  return 1024 + kProductStages * kProductStageBytes + 2 * kProductStages * 8 +
         (Vec ? 0 : kStoreScratch);
}

// The ring of the two-warpgroup block, as wgmma_tiles.cuh's consume reads
// it: a(s) is the calling warpgroup's row box.
struct ProductRing {
  static constexpr int kStages = kProductStages;
  uint8_t* stages;
  uint64_t* full;
  uint64_t* empty;
  float* scratch;  // the store scratch, where there is one

  __device__ __forceinline__ explicit ProductRing(uint8_t* raw) {
    stages = reinterpret_cast<uint8_t*>(
        (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t{1023});
    full = reinterpret_cast<uint64_t*>(stages + kStages * kProductStageBytes);
    empty = full + kStages;
    scratch = reinterpret_cast<float*>(empty + kStages);
    if (threadIdx.x == 0) {
      for (int s = 0; s < kStages; ++s) {
        mbar_init(full + s, 1);
        mbar_init(empty + s, kGroups * kConsumers / 32);
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }

  __device__ __forceinline__ uint8_t* row_boxes(int s) const {
    return stages + s * kProductStageBytes;
  }
  __device__ __forceinline__ uint8_t* a(int s) const {
    return row_boxes(s) + threadIdx.x / kConsumers * kBox;
  }
  __device__ __forceinline__ uint8_t* b(int s) const {
    return row_boxes(s) + kGroups * kBox;
  }
};

// lex = joint vw16 + vb over (128-row, 128-label) tiles, tile t at row tile
// t / strips and strip t % strips; block i computes the tiles i, i +
// gridDim.x, ... (a persistent grid: the ring runs on from one tile into
// the next while the warpgroups store the last). Vec: V is a multiple of
// 4 (16-byte stores from registers); else through the store scratch.
template <bool Vec>
__global__ void __launch_bounds__(kProductThreads, 2)
    head_product_kernel(const __grid_constant__ ProductMaps maps,
                        const HeadProduct p) {
  extern __shared__ uint8_t raw[];
  const ProductRing ring(raw);
  const int strips = cdiv(p.Vp, kBN), kts = p.hp / kBK;
  const int total = cdiv(p.M, kTileRows) * strips;
  const int mine = cdiv(total - static_cast<int>(blockIdx.x), gridDim.x);
  const auto corner = [&](int i, int& m0, int& n0) {
    const int t = blockIdx.x + i * gridDim.x;
    m0 = t / strips * kTileRows;
    n0 = t % strips * kBN;
  };
  if (threadIdx.x >= kGroups * kConsumers) {  // the producer warp
    if (threadIdx.x != kGroups * kConsumers) return;
    for (int q = 0; q < mine * kts; ++q) {
      const int s = q % kProductStages;
      mbar_wait(ring.empty + s, ((q / kProductStages) & 1) ^ 1);
      mbar_expect(ring.full + s, kProductStageBytes);
      int m0, n0;
      corner(q / kts, m0, n0);
      const int k0 = q % kts * kBK;
      uint8_t* rows = ring.row_boxes(s);
      tma_load(rows, maps.joint, k0, m0, ring.full + s);
      tma_load(rows + kBox, maps.joint, k0, m0 + kRows, ring.full + s);
      tma_load(ring.b(s), maps.vw, n0, k0, ring.full + s);
      tma_load(ring.b(s) + kBox, maps.vw, n0 + 64, k0, ring.full + s);
    }
    return;
  }
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const bool odd = lane & 1;
  float d[64];
  consume<false, true>(ring, mine, kts, d, [&](int i, float(&acc)[64]) {
    int m0, n0;
    corner(i, m0, n0);
    if constexpr (!Vec) {
      // The warp's rows warp * 16 + half * 8 + r of the tile (acc_row
      // spans the 128 rows over both warpgroups), 32 labels at a time.
      float* stage = ring.scratch + warp * 8 * kStageLd;
#pragma unroll
      for (int g = 0; g < kBN / 32; ++g) {
        const int y = n0 + g * 32 + lane;
        const float bias = y < p.V ? p.vb[y] : 0.f;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              stage[lane / 4 * kStageLd + jj * 8 + (lane % 4) * 2 + e] =
                  acc[(g * 4 + jj) * 4 + half * 2 + e];
            }
          }
          __syncwarp();
#pragma unroll
          for (int r = 0; r < 8; ++r) {
            const int row = m0 + warp * 16 + half * 8 + r;
            if (row < p.M && y < p.V) {
              __stcs(p.lex + static_cast<size_t>(row) * p.V + y,
                     stage[r * kStageLd + lane] + bias);
            }
          }
          __syncwarp();
        }
      }
      return;
    }
    int m[2];  // acc_row spans the 128 rows over both warpgroups
#pragma unroll
    for (int half = 0; half < 2; ++half) m[half] = m0 + acc_row(half * 2);
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int y = n0 + j * 8 + (lane % 4) * 2;  // the thread's 2 labels
      float v[2][2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float bias = y + e < p.V ? p.vb[y + e] : 0.f;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          v[half][e] = acc[j * 4 + half * 2 + e] + bias;
        }
      }
      // Lanes 2c and 2c + 1 swap halves: the even one takes row m[0],
      // labels y..y+3, the odd one row m[1], labels y-2..y+1.
      const float s0 = odd ? v[0][0] : v[1][0];
      const float s1 = odd ? v[0][1] : v[1][1];
      const float r0 = __shfl_xor_sync(0xffffffffu, s0, 1);
      const float r1 = __shfl_xor_sync(0xffffffffu, s1, 1);
      const int row = odd ? m[1] : m[0], col = odd ? y - 2 : y;
      if (row < p.M && col < p.V) {
        __stcs(reinterpret_cast<float4*>(
                   p.lex + static_cast<size_t>(row) * p.V + col),
               odd ? make_float4(r0, r1, v[1][0], v[1][1])
                   : make_float4(v[0][0], v[0][1], r0, r1));
      }
    }
  });
}

// The bfloat16 forward: the joint pass, then (V > 0) the product on
// `blocks` persistent blocks (at most the number of output tiles).
cudaError_t forward(const float* pc, const float* pf, const float* vw,
                    const float* bw, const float* vb, const float* bb,
                    float* blank, float* lex, bf16* joint, bf16* vw16, int B,
                    int S, int h, int V, int blocks, cudaStream_t stream) {
  const int M = B * S, hp = round_up(h, kBK), Vp = round_up(V, kBK);
  if (joint == nullptr || vw16 == nullptr || hp == 0) {
    return cudaErrorInvalidValue;
  }
  const auto pass = joint_tiles::vector_path(h, V, {pc, pf, vw, bw})
                        ? joint_pass_kernel<true>
                        : joint_pass_kernel<false>;
  pass<<<cdiv(M + hp, kPassThreads / 32), kPassThreads, 0, stream>>>(
      pc, pf, vw, bw, bb, joint, vw16, blank, B, S, h, hp, V, Vp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || V == 0) return err;
  const int total = cdiv(M, kTileRows) * cdiv(Vp, kBN);
  if (blocks < 1 || blocks > total) return cudaErrorInvalidValue;
  ProductMaps maps;
  const cuuint64_t joint_dims[2] = {static_cast<cuuint64_t>(hp),
                                    static_cast<cuuint64_t>(M)};
  const cuuint64_t vw_dims[2] = {static_cast<cuuint64_t>(Vp),
                                 static_cast<cuuint64_t>(hp)};
  err = box_map(&maps.joint, joint, 2, joint_dims);
  if (err == cudaSuccess) err = box_map(&maps.vw, vw16, 2, vw_dims);
  if (err != cudaSuccess) return err;
  const bool vec = V % 4 == 0 && reinterpret_cast<uintptr_t>(lex) % 16 == 0;
  err = vec ? allow_smem<head_product_kernel<true>>(product_smem<true>())
            : allow_smem<head_product_kernel<false>>(product_smem<false>());
  if (err != cudaSuccess) return err;
  const HeadProduct p{vb, lex, M, V, hp, Vp};
  if (vec) {
    head_product_kernel<true>
        <<<blocks, kProductThreads, product_smem<true>(), stream>>>(maps, p);
  } else {
    head_product_kernel<false>
        <<<blocks, kProductThreads, product_smem<false>(), stream>>>(maps, p);
  }
  return cudaGetLastError();
}

}  // namespace hopper

using namespace joint_tiles;

// ---------------------------------------------------------------------------
// float32: 64 x 64 tiles through FMAs.

// blank [B, S] and lexical [B, S, V] for a (64-row, 64-label) tile.
// Grid (ceil(B S / 64), max(1, ceil(V / 64))).
__global__ void __launch_bounds__(kThreads)
    forward_f32_kernel(const float* __restrict__ pc,   // [S, h]
                       const float* __restrict__ pf,   // [B, h]
                       const float* __restrict__ vw,   // [h, V]
                       const float* __restrict__ bw,   // [h]
                       const float* __restrict__ vb,   // [V]
                       const float* __restrict__ bb,   // [1]
                       float* __restrict__ blank,      // [B, S]
                       float* __restrict__ lex,        // [B, S, V]
                       int B, int S, int h, int V) {
  __shared__ size_t pc_off[kBM], pf_off[kBM];
  const int M = B * S;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int tid = threadIdx.x;
  const int tx = tid % (kBN / kTN), ty = tid / (kBN / kTN);
  if (tid < kBM) {
    const int m = m0 + tid < M ? m0 + tid : 0;
    pc_off[tid] = static_cast<size_t>(m % S) * h;
    pf_off[tid] = static_cast<size_t>(m / S) * h;
  }
  __syncthreads();
  if (n0 < V) {
    auto joint = [&](int r, int k) {
      return m0 + r < M ? tanhf(pc[pc_off[r] + k] + pf[pf_off[r] + k]) : 0.f;
    };
    auto head = [&](int k, int c) {
      return n0 + c < V ? vw[static_cast<size_t>(k) * V + n0 + c] : 0.f;
    };
    float acc[kTM][kTN];
    zero(acc);
    accumulate<false, false>(acc, joint, head, 0, h);
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const int m = m0 + ty * kTM + i;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const int y = n0 + tx * kTN + j;
        if (y < V) lex[static_cast<size_t>(m) * V + y] = acc[i][j] + vb[y];
      }
    }
  }
  if (blockIdx.y == 0) {
    const int warp = tid / 32, lane = tid % 32;
    for (int row = warp; row < kBM; row += kThreads / 32) {
      if (m0 + row >= M) break;
      float dot = 0.f;
      for (int k = lane; k < h; k += 32) {
        dot = fmaf(tanhf(pc[pc_off[row] + k] + pf[pf_off[row] + k]), bw[k],
                   dot);
      }
      for (int o = 16; o > 0; o >>= 1) {
        dot += __shfl_xor_sync(0xffffffffu, dot, o);
      }
      if (lane == 0) blank[m0 + row] = dot + bb[0];
    }
  }
}

}  // namespace

extern "C" {

// The forward on `stream`; returns the first error (0 on success). dtype 0 =
// float32, 1 = bfloat16 (the compute type); the inputs are float32: pc
// [S, h], pf [B, h], vw [h, V], bw [h], vb [V], bb [1], outputs blank
// [B, S] and lex [B, S, V]. bfloat16 also takes the scratch joint16 [B S,
// hp] and vw16 [hp, Vp] (bfloat16; hp, Vp: h and V rounded up to 64) and
// the product's persistent grid, `blocks` (1 to its output tiles,
// ceil(B S / 128) ceil(Vp / 128)); float32 ignores them.
int joint_head_forward(int dtype, const float* pc, const float* pf,
                       const float* vw, const float* bw, const float* vb,
                       const float* bb, float* blank, float* lex, int B,
                       int S, int h, int V, void* joint16, void* vw16,
                       int blocks, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = B * S;
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return 0;
  if (dtype == 1) {
    return static_cast<int>(hopper::forward(
        pc, pf, vw, bw, vb, bb, blank, lex,
        static_cast<hopper::bf16*>(joint16), static_cast<hopper::bf16*>(vw16),
        B, S, h, V, blocks, s));
  }
  const dim3 grid(tiles(M, kBM), V > 0 ? tiles(V, kBN) : 1);
  forward_f32_kernel<<<grid, kThreads, 0, s>>>(pc, pf, vw, bw, vb, bb, blank,
                                               lex, B, S, h, V);
  RETURN_IF_LAUNCH_FAILED();
  return 0;
}

// The backward on `stream`; returns the first error. Outputs d_pc [S, h],
// d_pf [B, h], d_vw [h, V], d_bw [h]; the scratch is joint_backward's
// (joint_tiles.cuh). The blank cotangent, blank_w and the joint of d_bw are
// rounded to the compute type, as the TPU kernel rounds them.
int joint_head_backward(int dtype, const float* pc, const float* pf,
                        const float* vw, const float* bw,
                        const float* g_blank, const float* g_lex,
                        float* dpf_part, float* dbw_part, float* dpc_part,
                        float* dw_part, float* d_pc, float* d_pf,
                        float* d_vw, float* d_bw, int B, int S, int h, int V,
                        int splits, void* stream) {
  return joint_backward(dtype, /*round_blank=*/true, pc, pf, vw, bw, g_blank,
                        g_lex, dpf_part, dbw_part, dpc_part, dw_part, d_pc,
                        d_pf, d_vw, d_bw, B, S, h, V, splits,
                        static_cast<cudaStream_t>(stream));
}

const char* joint_head_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
