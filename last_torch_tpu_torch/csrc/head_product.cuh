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

// The bfloat16 head product of the forwards on Hopper, shared by
// joint_head.cu (the joint+head forward), fused_scan.cu (the bigram
// log-partition forward, both modes), sharded_scan.cu (the frame
// reduction) and viterbi.cu (the Viterbi forward): lex = joint vw16 + vb
// over the (batch row, state) rows, with one of five epilogues.
//
// * joint_pass_kernel forms each joint entry once, tanh(pc[s] + pf[b])
//   rounded to bfloat16 into a [B, S, hp] scratch (hp: h rounded up to 64,
//   zero past h), with the blank head as a warp's dot over the rounded row,
//   over a list of live batch rows; and the padded bfloat16 head vw16 [hp,
//   Vp] (zero past h and V) from the float32 head.
// * The products run on wgmma_tiles.cuh's machinery (m64n128k16 from
//   128-byte-swizzled shared memory, one producer thread streaming 64-deep
//   stages through an mbarrier ring) with two consumer warpgroups: a
//   block's tile is two 64-row units by a 128-label strip. Each runs as a
//   persistent grid, in one of two walks over the output tiles:
//   - the pair walk (PairWalk): each of at most two blocks an SM takes the
//     tiles i, i + grid, ... (the 8 strips of a unit pair on neighbouring
//     blocks), streaming each tile's two joint boxes and the strip's two
//     head boxes at each of the 8 depth stages: 256 KB from the L2 cache a
//     tile at h=512, reused for 16.8 MFLOP; the other block of the SM runs
//     its products under one block's epilogue.
//   - the strip-stationary walk (StripWalk, the Viterbi's two products
//     where the strip fits, hp <= 576): one block an SM owns one 128-label
//     strip for the launch, loads it once (hp x 128 bfloat16, 128 KB at
//     h=512) and streams only the joint, 128 KB a tile, in 8 KB boxes
//     through an 8-stage ring. The lanes of all strips walk the unit pairs
//     in one order at one pace (lane j takes the pairs j, j + lanes, ...),
//     so each pair's joint comes from device memory once and from the L2
//     cache for the other strips: at B=384 a frame's joint is 403 MB and
//     its lex 1.61 GB, far past the 50 MB L2. The two warpgroups take the
//     pair's two units in ping-pong, each starting its products once the
//     other has issued its own, so one's epilogue runs under the other's
//     products.
// * head_product_kernel (the joint+head forward) stores lex [B S, V] in
//   float32: 16 bytes a thread from registers where V is a multiple of 4,
//   else through a per-warp shared-memory scratch, with the streaming hint.
// * The unit products walk 64 consecutive states of one live batch row at
//   a time (a 3-d TMA map [B, S, hp] zero-fills past S, so no unit
//   straddles two rows); the two units of a block are consecutive units of
//   the live rows' list (a block may span the end of one row and the start
//   of the next): at S=1025 a row has 17 units of 64 states (1088 rows,
//   6.1% padding) where 128-state tiles would give 9 (1152, 12.4%), and
//   pairing the halves of one row's 128-state tile measured 0.8-1.8% slower
//   (PERF.md). Each may also store lex (float32 [B, S, V]) for a caller's
//   later passes. Their epilogues:
//   - column_reduce_kernel (the two lattice forwards, on the pair walk):
//     each warpgroup adds
//     vb[y] and vec[b, s] to its unit and reduces every column over the
//     unit's states to one online (max, sum) pair: over the thread's two
//     rows in registers, over the 8 lanes that hold a column by a
//     reduce-scatter of __shfl_xor, over the 4 warps through shared memory.
//     One pair per (unit, b, y) goes to part_m / part_l [ceil(S / 64), B,
//     V], owned by one block (no atomics, deterministic); a merge launch of
//     the caller combines them. Rows past S and states whose vec is -inf
//     add nothing; labels past V are never written.
//   - column_max_kernel (the Viterbi forward's max-pass, on either walk):
//     the same path with (max, lowest argmax) pairs in the Viterbi order,
//     into part_v / part_s.
//   - row_reduce_kernel (the Viterbi forward's local normalization, on
//     either walk): lex
//     stored, and each row reduced over the strip's labels to one (max,
//     sum) pair, in registers and over the 4 lanes that share the row, into
//     part_m / part_l [ceil(Vp / 128), B, S].
//
// Everything here has internal linkage, as in wgmma_tiles.cuh: the
// libraries that include it share no state.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <initializer_list>

#include "wgmma_tiles.cuh"

namespace head_product {
namespace {

using namespace wgmma_tiles;

constexpr int kPassThreads = 256;  // a warp per row

// Whether 16-byte loads serve the joint pass: h and V multiples of 4 and
// every input 16-byte aligned.
inline bool vector_loads(int h, int V, std::initializer_list<const void*> ps) {
  if (h % 4 != 0 || V % 4 != 0) return false;
  for (const void* p : ps) {
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  }
  return true;
}

// Rows [0, live S) of the grid: with slot = row / S, s = row % S and b =
// rows[slot] (rows null: b = slot), joint[b, s, :hp] = bf16(tanh(pc[s] +
// pf[b])) (zero past h) and blank[b, s] = joint[b, s] . bf16(bw) + bb; the
// next head_rows (0 or hp) rows: vw16[k, :Vp] = bf16(vw[k, :V]) (zero past
// V or h). A lane takes 4 consecutive entries, with 16-byte loads where
// Vec. Grid ceil((live S + head_rows) / 8).
template <bool Vec>
__global__ void __launch_bounds__(kPassThreads)
    joint_pass_kernel(const float* __restrict__ pc,  // [S, h]
                      const float* __restrict__ pf,  // [B, h]
                      const float* __restrict__ vw,  // [h, V]
                      const float* __restrict__ bw,  // [h]
                      const float* __restrict__ bb,  // [1]
                      const int* __restrict__ rows,  // [live] or null
                      bf16* __restrict__ joint,      // [B, S, hp]
                      bf16* __restrict__ vw16,       // [hp, Vp]
                      float* __restrict__ blank,     // [B, S]
                      int live, int S, int h, int hp, int V, int Vp,
                      int head_rows) {
  const long long M = static_cast<long long>(live) * S;
  const long long row =
      static_cast<long long>(blockIdx.x) * (kPassThreads / 32) +
      threadIdx.x / 32;
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
    const int slot = static_cast<int>(row / S), s = static_cast<int>(row % S);
    const int b = rows == nullptr ? slot : rows[slot];
    const size_t m = static_cast<size_t>(b) * S + s;
    const float* pc_s = pc + static_cast<size_t>(s) * h;
    const float* pf_b = pf + static_cast<size_t>(b) * h;
    bf16* out = joint + m * hp;
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
    if (lane == 0) blank[m] = dot + bb[0];
  } else if (row < M + head_rows) {
    const int k = static_cast<int>(row - M);
    const float* src = vw + static_cast<size_t>(k) * V;
    bf16* out = vw16 + static_cast<size_t>(k) * Vp;
    for (int y = lane * 4; y < Vp; y += 128) {
      float x[4];
      load4(src, y, k < h ? V : 0, x);
      store4(out + y, x);
    }
  }
}

// The joint pass on `stream`: the joint and blank of the `live` rows
// (their batch indices in rows, or 0..live-1 where rows is null) and, with
// `head`, vw16 from vw. pf is [B, h] of the rows' frame.
cudaError_t joint_pass(const float* pc, const float* pf, const float* vw,
                       const float* bw, const float* bb, const int* rows,
                       bf16* joint, bf16* vw16, float* blank, int live, int S,
                       int h, int V, bool head, cudaStream_t stream) {
  const int hp = round_up(h, kBK), Vp = round_up(V, kBK);
  if (hp == 0 || joint == nullptr || (head && vw16 == nullptr)) {
    return cudaErrorInvalidValue;
  }
  const int head_rows = head ? hp : 0;
  const long long n = static_cast<long long>(live) * S + head_rows;
  if (n == 0) return cudaSuccess;
  const auto pass = vector_loads(h, V, {pc, pf, vw, bw})
                        ? joint_pass_kernel<true>
                        : joint_pass_kernel<false>;
  pass<<<static_cast<unsigned>(cdiv(static_cast<int>(n), kPassThreads / 32)),
         kPassThreads, 0, stream>>>(pc, pf, vw, bw, bb, rows, joint, vw16,
                                    blank, live, S, h, hp, V, Vp, head_rows);
  return cudaGetLastError();
}

// The block: two consumer warpgroups, each 64 rows of the tile, sharing
// the tile's 128-label strip of the head, and a producer warp. A stage
// holds 64 depths: the two row boxes, then the strip's two column boxes.
constexpr int kGroups = 2;
constexpr int kTileRows = kGroups * kRows;
constexpr int kProductThreads = kGroups * kConsumers + 32;
constexpr int kProductStages = 3;
constexpr int kProductStageBytes = kGroups * kBox + 2 * kBox;
constexpr int kRingBytes =
    1024 + kProductStages * kProductStageBytes + 2 * kProductStages * 8;

// The ring of the two-warpgroup block, as wgmma_tiles.cuh's consume reads
// it: a(s) is the calling warpgroup's row box.
struct ProductRing {
  static constexpr int kStages = kProductStages;
  uint8_t* stages;
  uint64_t* full;
  uint64_t* empty;
  float* scratch;  // the epilogue's scratch, where there is one

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
  static __device__ __forceinline__ bool producer() {
    return threadIdx.x >= kGroups * kConsumers;
  }
};

// The products' operands: the joint (K-major; [B S, hp] for the stored
// product, [B, S, hp] for the column reduction) and vw16 [hp, Vp]
// (MN-major), bfloat16, in 64 x 64 boxes.
struct ProductMaps {
  CUtensorMap joint, vw;
};

cudaError_t product_maps(ProductMaps* maps, const bf16* joint,
                         const bf16* vw16, int rank, int B, int S, int hp,
                         int Vp) {
  const cuuint64_t joint_dims[3] = {
      static_cast<cuuint64_t>(hp),
      static_cast<cuuint64_t>(rank == 2 ? static_cast<long long>(B) * S : S),
      static_cast<cuuint64_t>(B)};
  const cuuint64_t vw_dims[2] = {static_cast<cuuint64_t>(Vp),
                                 static_cast<cuuint64_t>(hp)};
  cudaError_t err = box_map(&maps->joint, joint, rank, joint_dims);
  if (err == cudaSuccess) err = box_map(&maps->vw, vw16, 2, vw_dims);
  return err;
}

// ---------------------------------------------------------------------------
// Stored lex: the joint+head forward.

struct HeadProduct {
  const float* vb;  // [V]
  float* lex;       // [M, V]
  int M, V, hp, Vp;
};

// Where V is not a multiple of 4 the rows are not 16-byte aligned: each
// warp then stores through its own [8 rows][33] float32 scratch, 32
// consecutive labels of a row at a time (small enough to keep two blocks
// an SM).
constexpr int kStageLd = 33;
constexpr int kStoreScratch = kGroups * 4 * 8 * kStageLd * 4;
template <bool Vec>
constexpr int product_smem() {
  return kRingBytes + (Vec ? 0 : kStoreScratch);
}

// lex = joint vw16 + vb over (128-row, 128-label) tiles, tile t at row tile
// t / strips and strip t % strips; block i computes the tiles i, i +
// gridDim.x, ... Vec: V is a multiple of 4 (16-byte stores from
// registers); else through the store scratch.
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
  if (ProductRing::producer()) {
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

// The stored product of M = B S rows on `blocks` persistent blocks (1 to
// its output tiles, ceil(M / 128) ceil(Vp / 128)).
cudaError_t store_product(const bf16* joint, const bf16* vw16,
                          const float* vb, float* lex, int B, int S, int h,
                          int V, int blocks, cudaStream_t stream) {
  const int M = B * S, hp = round_up(h, kBK), Vp = round_up(V, kBK);
  const int total = cdiv(M, kTileRows) * cdiv(Vp, kBN);
  if (blocks < 1 || blocks > total) return cudaErrorInvalidValue;
  ProductMaps maps;
  cudaError_t err = product_maps(&maps, joint, vw16, 2, B, S, hp, Vp);
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

// ---------------------------------------------------------------------------
// Products over the live rows' 64-state units: the lattice forwards and the
// Viterbi forward.


// Output tiles: pairs of 64-state units by 128-label strips.
__host__ __device__ __forceinline__ int reduce_tiles(int live, int S,
                                                     int Vp) {
  return cdiv(live * cdiv(S, kRows), kGroups) * cdiv(Vp, kBN);
}

// The tiles of a unit product. Unit u is the states [u % t64 * 64, + 64)
// of batch row rows[u / t64] (rows null: u / t64); tile t is the unit pair
// t / strips (units 2 (t / strips) and the next) by strip t % strips, and
// block i computes the tiles i, i + gridDim.x, ... The first unit of a pair
// is always a real one; the second may not be (the pair past the last
// unit), and its warpgroup then multiplies the first unit's rows again and
// writes nothing. Each kernel computes its grid's sizes up front and finds
// a unit through its own `unit` lambda: a shared struct of them kept more
// registers live through the epilogue (336 B of spills against 100 in the
// column reduction's Store instantiation, 5-7% slower; PERF.md).
//
// The producer thread of a unit product: each of the block's mine tiles,
// kts stages of the two units' row boxes and the strip's two head boxes.
template <class Unit>
__device__ __forceinline__ void produce_units(const ProductRing& ring,
                                              const ProductMaps& maps,
                                              const Unit& unit, int strips,
                                              int kts, int mine) {
  if (threadIdx.x != kGroups * kConsumers) return;
  for (int i = 0, q = 0; i < mine; ++i) {
    const int t = blockIdx.x + i * gridDim.x;
    const int pair = t / strips, n0 = t % strips * kBN;
    int b[2], s0[2];
    unit(kGroups * pair, b[0], s0[0]);
    if (!unit(kGroups * pair + 1, b[1], s0[1])) b[1] = b[0], s0[1] = s0[0];
    for (int kt = 0; kt < kts; ++kt, ++q) {
      const int s = q % kProductStages;
      mbar_wait(ring.empty + s, ((q / kProductStages) & 1) ^ 1);
      mbar_expect(ring.full + s, kProductStageBytes);
      const int k0 = kt * kBK;
      uint8_t* boxes = ring.row_boxes(s);
      tma_load(boxes, maps.joint, k0, s0[0], b[0], ring.full + s);
      tma_load(boxes + kBox, maps.joint, k0, s0[1], b[1], ring.full + s);
      tma_load(ring.b(s), maps.vw, n0, k0, ring.full + s);
      tma_load(ring.b(s) + kBox, maps.vw, n0 + 64, k0, ring.full + s);
    }
  }
}

// The thread's two states of its warpgroup's unit from s0 (acc_row spans
// the 128 rows of both warpgroups); they may lie past S.
__device__ __forceinline__ void unit_states(int s0, int (&s)[2]) {
  const int group = threadIdx.x / kConsumers;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    s[half] = s0 + acc_row(half * 2) - group * kRows;
  }
}

// Stores the thread's lex entries of the labels y0, y0 + 1 of its two
// states x[half][e] into lex [B, S, V] at row0 (float2 where V is even).
__device__ __forceinline__ void store_lex(float* lex, size_t row0,
                                          const int (&s)[2], int y0, int S,
                                          int V, const float (&x)[2][2]) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float* out = lex + (row0 + s[half]) * V + y0;
    if (s[half] >= S || y0 >= V) continue;
    if (V % 2 == 0) {
      *reinterpret_cast<float2*>(out) = make_float2(x[half][0], x[half][1]);
    } else {
      out[0] = x[half][0];
      if (y0 + 1 < V) out[1] = x[half][1];
    }
  }
}

// Epilogue scratch: per warpgroup and warp a row of kBN pairs (float32
// and float32, or float32 and int).
constexpr int kReduceScratch = kGroups * 4 * 2 * kBN * 4;

// The two walks of a unit product's tiles. Each kernel builds its Walk's
// ring over its dynamic shared memory (ring(raw, kts)), runs produce on the
// producer thread and compute on the two consumer warpgroups. compute hands
// each warpgroup its units u (unit 2 pair + group of each pair): fetch(u),
// what the epilogue reads of the unit besides the product, then
// epilogue(fetched, n0, acc) with the unit's sum by the strip at label n0.
//
// The pair walk: tile t = blockIdx.x + i gridDim.x is the unit pair t /
// strips by strip t % strips, a ring of 32 KB stages (both units' boxes and
// the strip's two head boxes), two blocks an SM; fetch runs in the
// epilogue.
struct PairWalk {
  static constexpr int kBlocksPerSM = 2;
  static constexpr bool kStationary = false;
  using Ring = ProductRing;

  static __device__ __forceinline__ Ring ring(uint8_t* raw, int) {
    return Ring(raw);
  }
  static constexpr int smem(int, int extra) { return kRingBytes + extra; }
  // At most max_blocks blocks, one a tile.
  static int blocks(int live, int S, int Vp, int max_blocks) {
    return std::min(max_blocks, reduce_tiles(live, S, Vp));
  }
  static __device__ __forceinline__ int mine(int units, int strips) {
    const int total = cdiv(units, kGroups) * strips;
    return cdiv(total - static_cast<int>(blockIdx.x), gridDim.x);
  }
  template <class Unit>
  static __device__ __forceinline__ void produce(const Ring& ring,
                                                 const ProductMaps& maps,
                                                 const Unit& unit, int units,
                                                 int strips, int kts) {
    produce_units(ring, maps, unit, strips, kts, mine(units, strips));
  }
  template <class Fetch, class Epilogue>
  static __device__ __forceinline__ void compute(const Ring& ring, int units,
                                                 int strips, int kts,
                                                 const Fetch& fetch,
                                                 const Epilogue& epilogue) {
    float d[64];
    consume<false, true>(
        ring, mine(units, strips), kts, d, [&](int i, float(&acc)[64]) {
          const int t = blockIdx.x + i * gridDim.x;
          const int u = kGroups * (t / strips) + threadIdx.x / kConsumers;
          epilogue(fetch(u), t % strips * kBN, acc);
        });
  }
};

// The strip-stationary walk: block i owns strip i % strips as lane i /
// strips of lanes = gridDim.x / strips, and lane j takes the unit pairs j,
// j + lanes, ... The strip is loaded once into shared memory ([kts][two 64
// x 64 boxes], as a pair-walk stage holds them); the ring's stages are one
// unit's 64 x 64 joint box each, in the order the warpgroups consume them:
// the first unit's kts stages of a pair, then the second's, then the next
// pair's. Warpgroup 0 starts a pair once warpgroup 1 has issued the last
// pair's products (turn[1]), warpgroup 1 once warpgroup 0 has issued this
// pair's (turn[0]): the two alternate on the tensor cores, one's epilogue
// under the other's products. A warpgroup fetches its unit before its
// products, so the loads of the unit's row and vec are in flight under
// them. One block an SM.
constexpr int kStripStages = 8;
constexpr int kMaxBlockSmem = 227 * 1024;  // an sm_90 block's dynamic limit

struct StripRing {
  uint8_t* strip;   // [kts][2 boxes]
  uint8_t* stages;  // kStripStages joint boxes
  uint64_t* full;
  uint64_t* empty;
  uint64_t* strip_full;
  uint64_t* turn;  // [kGroups]
  float* scratch;  // the epilogue's scratch, where there is one

  __device__ __forceinline__ StripRing(uint8_t* raw, int kts) {
    strip = reinterpret_cast<uint8_t*>(
        (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t{1023});
    stages = strip + kts * 2 * kBox;
    full = reinterpret_cast<uint64_t*>(stages + kStripStages * kBox);
    empty = full + kStripStages;
    strip_full = empty + kStripStages;
    turn = strip_full + 1;
    scratch = reinterpret_cast<float*>(turn + kGroups);
    if (threadIdx.x == 0) {
      for (int s = 0; s < kStripStages; ++s) {
        mbar_init(full + s, 1);
        mbar_init(empty + s, kConsumers / 32);  // one warpgroup's warps
      }
      mbar_init(strip_full, 1);
      for (int g = 0; g < kGroups; ++g) mbar_init(turn + g, kConsumers / 32);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }

  __device__ __forceinline__ uint8_t* stage(int s) const {
    return stages + s * kBox;
  }
  static __device__ __forceinline__ bool producer() {
    return threadIdx.x >= kGroups * kConsumers;
  }
};

struct StripWalk {
  static constexpr int kBlocksPerSM = 1;
  static constexpr bool kStationary = true;
  using Ring = StripRing;
  static_assert(kGroups == 2, "the turns alternate two warpgroups");

  static __device__ __forceinline__ Ring ring(uint8_t* raw, int kts) {
    return Ring(raw, kts);
  }
  static constexpr int smem(int kts, int extra) {
    return 1024 + kts * 2 * kBox + kStripStages * kBox +
           (2 * kStripStages + 1 + kGroups) * 8 + extra;
  }
  // Every strip's lanes: max_blocks / strips (at least 1), no more than
  // the unit pairs.
  static int blocks(int live, int S, int Vp, int max_blocks) {
    const int strips = cdiv(Vp, kBN);
    const int pairs = cdiv(live * cdiv(S, kRows), kGroups);
    return strips * std::min(std::max(1, max_blocks / strips), pairs);
  }
  // The block's strip, at label strip(strips) * kBN.
  static __device__ __forceinline__ int strip(int strips) {
    return blockIdx.x % strips;
  }
  template <class Unit>
  static __device__ __forceinline__ void produce(const Ring& ring,
                                                 const ProductMaps& maps,
                                                 const Unit& unit, int units,
                                                 int strips, int kts) {
    if (threadIdx.x != kGroups * kConsumers) return;
    const int n0 = strip(strips) * kBN;
    const int lanes = gridDim.x / strips, pairs = cdiv(units, kGroups);
    mbar_expect(ring.strip_full, kts * 2 * kBox);
    for (int kt = 0; kt < kts; ++kt) {
      uint8_t* boxes = ring.strip + kt * 2 * kBox;
      tma_load(boxes, maps.vw, n0, kt * kBK, ring.strip_full);
      tma_load(boxes + kBox, maps.vw, n0 + 64, kt * kBK, ring.strip_full);
    }
    int q = 0;
    for (int pair = blockIdx.x / strips; pair < pairs; pair += lanes) {
      for (int g = 0; g < kGroups; ++g) {
        int b, s0;
        if (!unit(kGroups * pair + g, b, s0)) break;  // past the last unit
        for (int kt = 0; kt < kts; ++kt, ++q) {
          const int s = q % kStripStages;
          mbar_wait(ring.empty + s, ((q / kStripStages) & 1) ^ 1);
          mbar_expect(ring.full + s, kBox);
          tma_load(ring.stage(s), maps.joint, kt * kBK, s0, b, ring.full + s);
        }
      }
    }
  }
  template <class Fetch, class Epilogue>
  static __device__ __forceinline__ void compute(const Ring& ring, int units,
                                                 int strips, int kts,
                                                 const Fetch& fetch,
                                                 const Epilogue& epilogue) {
    const int group = threadIdx.x / kConsumers;
    const bool leader = threadIdx.x % 32 == 0;
    const int n0 = strip(strips) * kBN;
    const int lanes = gridDim.x / strips, pairs = cdiv(units, kGroups);
    float d[64];
    mbar_wait(ring.strip_full, 0);
    int i = 0;
    for (int pair = blockIdx.x / strips; pair < pairs; pair += lanes, ++i) {
      const int u = kGroups * pair + group;
      // Only the last pair may lack its second unit; no pair follows it.
      if (u >= units) break;
      const auto fetched = fetch(u);
      if (group == 1) {
        mbar_wait(ring.turn, i & 1);
      } else if (i > 0) {
        mbar_wait(ring.turn + 1, (i - 1) & 1);
      }
      const int q0 = (kGroups * i + group) * kts;
      for (int kt = 0; kt < kts; ++kt) {
        const int q = q0 + kt, s = q % kStripStages;
        mbar_wait(ring.full + s, (q / kStripStages) & 1);
        fence_acc(d);
        wgmma_fence();
        mma_stage<false, true>(d, ring.stage(s), ring.strip + kt * 2 * kBox,
                               kt == 0);
        wgmma_commit();
        fence_acc(d);
        if (kt > 0) {  // the previous stage's products are done: free it
          wgmma_wait<1>();
          fence_acc(d);
          if (leader) mbar_arrive(ring.empty + (q - 1) % kStripStages);
        }
      }
      if (leader) mbar_arrive(ring.turn + group);  // the products are issued
      wgmma_wait<0>();
      fence_acc(d);
      if (leader) mbar_arrive(ring.empty + (q0 + kts - 1) % kStripStages);
      epilogue(fetched, n0, d);
    }
  }
};

// The thread's vb of its labels n0 + j * 8 + (lane % 4) * 2 + e of a strip
// (0 past V), read once where the walk keeps one strip.
__device__ __forceinline__ void strip_bias(const float* vb, int V, int n0,
                                           float (&bias)[kBN / 8][2]) {
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int y = n0 + j * 8 + (threadIdx.x % 4) * 2 + e;
      bias[j][e] = y < V ? vb[y] : 0.f;
    }
  }
}

// The deepest strip the Viterbi's products can keep resident: the strip,
// the ring and the column epilogue's scratch fill an SM's shared memory at
// hp = 576. The caller chooses the walk (ops/viterbi.py::strip_lanes); a
// strip walk past this depth is refused.
constexpr int kMaxStripDepth = 576;
static_assert(StripWalk::smem(kMaxStripDepth / kBK, kReduceScratch) <=
                      kMaxBlockSmem &&
                  StripWalk::smem(kMaxStripDepth / kBK + 1, kReduceScratch) >
                      kMaxBlockSmem,
              "kMaxStripDepth is the deepest strip that fits");

// The launch of a unit product on its Walk's persistent grid (no launch
// without live rows): at most max_blocks blocks the pair walk, max_blocks
// / strips lanes a strip the strip walk, each with `extra` bytes of
// epilogue scratch. joint is [B, S, hp], vw16 [hp, Vp].
template <auto Kernel, class Walk = PairWalk, class P>
cudaError_t launch_units(const bf16* joint, const bf16* vw16, const P& p,
                         int extra, int max_blocks, cudaStream_t stream) {
  if (p.live == 0 || p.S == 0) return cudaSuccess;
  if (p.hp == 0 || p.hp % kBK != 0 || p.Vp % kBK != 0 || max_blocks < 1) {
    return cudaErrorInvalidValue;
  }
  const int smem = Walk::smem(p.hp / kBK, extra);
  ProductMaps maps;
  cudaError_t err = product_maps(&maps, joint, vw16, 3, p.B, p.S, p.hp, p.Vp);
  if (err == cudaSuccess) err = allow_smem<Kernel>(smem);
  if (err != cudaSuccess) return err;
  const int blocks = Walk::blocks(p.live, p.S, p.Vp, max_blocks);
  Kernel<<<blocks, kProductThreads, smem, stream>>>(maps, p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// lex reduced over the states, (max, sum): the lattice forwards.

// (m, l) merged with the online pair (m2, l2): m the larger, one exp. An
// empty pair has m = -inf and l = 0. The exps take non-positive arguments
// x, where __expf's relative error is about |x| 2^-22: below 3e-6 for x >
// -12, and a term below that adds less than 1e-5 of the largest.
__device__ __forceinline__ void merge_pair(float& m, float& l, float m2,
                                           float l2) {
  const bool first = m >= m2;
  const float big = first ? m : m2, small = first ? m2 : m;
  const float lb = first ? l : l2, ls = first ? l2 : l;
  l = small == -INFINITY ? lb : fmaf(ls, __expf(small - big), lb);
  m = big;
}

// One level of the epilogue's reduce-scatter over the 8 lanes that hold the
// same columns: the lane keeps the upper or the lower H of its 2 H pairs,
// sends the others to the lane Bit apart and merges what it receives.
template <int H, int Bit>
__device__ __forceinline__ void scatter_level(float (&pm)[8], float (&pl)[8]) {
  const bool upper = threadIdx.x & Bit;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float sm = upper ? pm[i] : pm[i + H];
    const float sl = upper ? pl[i] : pl[i + H];
    pm[i] = upper ? pm[i + H] : pm[i];
    pl[i] = upper ? pl[i + H] : pl[i];
    merge_pair(pm[i], pl[i], __shfl_xor_sync(0xffffffffu, sm, Bit),
               __shfl_xor_sync(0xffffffffu, sl, Bit));
  }
}

// The lane's column of quarter q after the reduce-scatter (of the 8 lanes
// lane % 4 + 4 i, lane bit 4 kept the upper 4 pairs, bit 8 the upper 2,
// bit 16 the upper one): its index c in the strip's kBN.
__device__ __forceinline__ int scattered_column(int q) {
  const int lane = threadIdx.x % 32;
  const int k = q * 8 + (lane & 4 ? 4 : 0) + (lane & 8 ? 2 : 0) +
                (lane & 16 ? 1 : 0);
  return (k >> 1) * 8 + (lane % 4) * 2 + (k & 1);
}

// For each 64-state unit (b, s0) of a live row and each label y < V:
//   (m, l) = online logsumexp over s in [s0, s0 + 64) of vec[b, s] +
//            lex[b, s, y],   lex = joint[b, s] . vw16[:, y] + vb[y],
// into part_m / part_l at ((s0 / 64) B + b) V + y: m the largest term
// (-inf if none is finite), l = sum exp(term - m) (0 if none). With lex
// non-null, lex[b, s, y] is also stored (float32, [B, S, V]; the kernel's
// Store instantiation).
struct ColumnReduce {
  const float* vb;   // [V]
  const float* vec;  // [B, S]
  const int* rows;   // the live rows first (null: 0..live-1)
  float* part_m;     // [ceil(S / 64), B, V]
  float* part_l;
  float* lex;        // [B, S, V] or null
  int B, S, V, hp, Vp;
  int live;          // the rows reduced
};

template <bool Store>
__global__ void __launch_bounds__(kProductThreads, 2)
    column_reduce_kernel(const __grid_constant__ ProductMaps maps,
                         const ColumnReduce p) {
  extern __shared__ uint8_t raw[];
  const ProductRing ring(raw);
  const int strips = cdiv(p.Vp, kBN), kts = p.hp / kBK;
  const int t64 = cdiv(p.S, kRows);
  const int units = p.live * t64;
  const int total = cdiv(units, kGroups) * strips;
  const int mine = cdiv(total - static_cast<int>(blockIdx.x), gridDim.x);
  // Unit u's batch row and first state; false where u is no unit.
  const auto unit = [&](int u, int& b, int& s0) {
    if (u >= units) return false;
    const int slot = u / t64;
    b = p.rows == nullptr ? slot : p.rows[slot];
    s0 = u % t64 * kRows;
    return true;
  };
  if (ProductRing::producer()) {
    produce_units(ring, maps, unit, strips, kts, mine);
    return;
  }
  const int group = threadIdx.x / kConsumers, lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32 % 4;  // in the warpgroup
  float* red_m = ring.scratch + group * 2 * 4 * kBN;  // [4][kBN]
  float* red_l = red_m + 4 * kBN;                     // [4][kBN]
  float d[64];
  consume<false, true>(ring, mine, kts, d, [&](int i, float(&acc)[64]) {
    const int t = blockIdx.x + i * gridDim.x;
    const int pair = t / strips, n0 = t % strips * kBN;
    int b = 0, s0 = 0;
    const bool real = unit(kGroups * pair + group, b, s0);
    const size_t row0 = static_cast<size_t>(b) * p.S;
    // The thread's two states (acc_row spans the 128 rows of both
    // warpgroups) and their vec; -inf past S and on no unit.
    int s[2];
    float vec[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      s[half] = s0 + acc_row(half * 2) - group * kRows;
      vec[half] = real && s[half] < p.S ? p.vec[row0 + s[half]] : -INFINITY;
    }
    // A quarter of the strip at a time (few registers beside acc): the
    // thread's (max, sum) pair over its two rows of each of its 8 columns
    // k = 2 jj + e there (label n0 + (4 q + jj) * 8 + (lane % 4) * 2 + e),
    // then a reduce-scatter over the 8 lanes of rows lane / 4 (and + 8),
    // each level halving the pairs a lane holds (7 merges and 14 shuffles a
    // quarter, where a butterfly per column takes 48 shuffles); the lane
    // keeps column k0 of each quarter.
    const int k0 = (lane & 4 ? 4 : 0) + (lane & 8 ? 2 : 0) + (lane & 16 ? 1 : 0);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float pm[8], pl[8];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = q * 4 + jj;
        const int y0 = n0 + j * 8 + (lane % 4) * 2;  // 2 labels
        float x[2][2];  // lex of [half][e]
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float bias = y0 + e < p.V ? p.vb[y0 + e] : 0.f;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            x[half][e] = acc[j * 4 + half * 2 + e] + bias;
          }
        }
        if (Store && real) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            float* out = p.lex + (row0 + s[half]) * p.V + y0;
            if (s[half] >= p.S || y0 >= p.V) continue;
            if (p.V % 2 == 0) {
              *reinterpret_cast<float2*>(out) =
                  make_float2(x[half][0], x[half][1]);
            } else {
              out[0] = x[half][0];
              if (y0 + 1 < p.V) out[1] = x[half][1];
            }
          }
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float v0 = vec[0] + x[0][e], v1 = vec[1] + x[1][e];
          const float big = fmaxf(v0, v1), small = fminf(v0, v1);
          pm[jj * 2 + e] = big;
          pl[jj * 2 + e] = big == -INFINITY     ? 0.f
                           : small == -INFINITY ? 1.f
                                                : 1.f + __expf(small - big);
        }
      }
      scatter_level<4, 4>(pm, pl);
      scatter_level<2, 8>(pm, pl);
      scatter_level<1, 16>(pm, pl);
      const int k = q * 8 + k0;
      const int c = (k >> 1) * 8 + (lane % 4) * 2 + (k & 1);
      red_m[warp * kBN + c] = pm[0];
      red_l[warp * kBN + c] = pl[0];
    }
    named_barrier(1 + group, kConsumers);
    const int c = threadIdx.x % kConsumers, y = n0 + c;
    if (real && y < p.V) {
      float m = red_m[c], l = red_l[c];
#pragma unroll
      for (int w = 1; w < 4; ++w) {
        merge_pair(m, l, red_m[w * kBN + c], red_l[w * kBN + c]);
      }
      const size_t at =
          (static_cast<size_t>(s0 / kRows) * p.B + b) * p.V + y;
      p.part_m[at] = m;
      p.part_l[at] = l;
    }
    named_barrier(1 + group, kConsumers);  // the scratch is free again
  });
}

// The column reduction of p.live rows (none: no launch) on at most
// max_blocks persistent blocks. joint is [B, S, hp], vw16 [hp, Vp].
cudaError_t reduce_product(const bf16* joint, const bf16* vw16,
                           const ColumnReduce& p, int max_blocks,
                           cudaStream_t stream) {
  return p.lex != nullptr
             ? launch_units<column_reduce_kernel<true>>(
                   joint, vw16, p, kReduceScratch, max_blocks, stream)
             : launch_units<column_reduce_kernel<false>>(
                   joint, vw16, p, kReduceScratch, max_blocks, stream);
}

// ---------------------------------------------------------------------------
// lex reduced over the states, (max, argmax): the Viterbi forward.

// A state index that no state has: an empty (max, argmax) pair is (-inf,
// kNoState).
constexpr int kNoState = 0x7fffffff;

// (v, s) takes (v2, s2) where that beats it in the Viterbi order: the
// larger value, then the lower state. A NaN value never wins, so a pair
// never holds one, and the order is total: any order of merges gives the
// lowest state of the largest value.
__device__ __forceinline__ void pick(float& v, int& s, float v2, int s2) {
  if (v2 > v || (v2 == v && s2 < s)) {
    v = v2;
    s = s2;
  }
}

// scatter_level for (max, argmax) pairs.
template <int H, int Bit>
__device__ __forceinline__ void argmax_level(float (&pv)[8], int (&ps)[8]) {
  const bool upper = threadIdx.x & Bit;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float sv = upper ? pv[i] : pv[i + H];
    const int ss = upper ? ps[i] : ps[i + H];
    pv[i] = upper ? pv[i + H] : pv[i];
    ps[i] = upper ? ps[i + H] : ps[i];
    pick(pv[i], ps[i], __shfl_xor_sync(0xffffffffu, sv, Bit),
         __shfl_xor_sync(0xffffffffu, ss, Bit));
  }
}

// For each 64-state unit (b, s0) of a live row and each label y < V:
//   (v, s) = max and lowest argmax over s in [s0, s0 + 64) of vec[b, s] +
//            lex[b, s, y],   lex = joint[b, s] . vw16[:, y] + vb[y],
// into part_v / part_s at ((s0 / 64) B + b) V + y ((-inf, kNoState) where
// every term is NaN). With lex non-null, lex[b, s, y] is also stored
// (float32, [B, S, V]; the Store instantiation).
struct ColumnMax {
  const float* vb;   // [V]
  const float* vec;  // [B, S]
  const int* rows;   // the live rows first (null: 0..live-1)
  float* part_v;     // [ceil(S / 64), B, V]
  int* part_s;
  float* lex;        // [B, S, V] or null
  int B, S, V, hp, Vp;
  int live;
};

// column_reduce_kernel's product and reduction path with (max, argmax)
// pairs: over the thread's two rows in registers, the 8 lanes of a column,
// the 4 warps through shared memory. One writer per (unit, b, y), no
// atomics. Walk: PairWalk or StripWalk.
template <bool Store, class Walk>
__global__ void __launch_bounds__(kProductThreads, Walk::kBlocksPerSM)
    column_max_kernel(const __grid_constant__ ProductMaps maps,
                      const ColumnMax p) {
  extern __shared__ uint8_t raw[];
  const int strips = cdiv(p.Vp, kBN), kts = p.hp / kBK;
  const auto ring = Walk::ring(raw, kts);
  const int t64 = cdiv(p.S, kRows);
  const int units = p.live * t64;
  // Unit u's batch row and first state; false where u is no unit.
  const auto unit = [&](int u, int& b, int& s0) {
    if (u >= units) return false;
    const int slot = u / t64;
    b = p.rows == nullptr ? slot : p.rows[slot];
    s0 = u % t64 * kRows;
    return true;
  };
  if (Walk::Ring::producer()) {
    Walk::produce(ring, maps, unit, units, strips, kts);
    return;
  }
  const int group = threadIdx.x / kConsumers, lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32 % 4;  // in the warpgroup
  float* red_v = ring.scratch + group * 2 * 4 * kBN;     // [4][kBN]
  int* red_s = reinterpret_cast<int*>(red_v + 4 * kBN);  // [4][kBN]
  float bias[kBN / 8][2];
  if constexpr (Walk::kStationary) {
    strip_bias(p.vb, p.V, Walk::strip(strips) * kBN, bias);
  }
  // The unit's row, its thread's two states and their vec and index (-inf
  // and kNoState past S and on no unit).
  struct Fetched {
    size_t row0;
    int b, s0, s[2], state[2];
    float vec[2];
    bool real;
  };
  const auto fetch = [&](int u) {
    Fetched f;
    f.b = f.s0 = 0;
    f.real = unit(u, f.b, f.s0);
    f.row0 = static_cast<size_t>(f.b) * p.S;
    unit_states(f.s0, f.s);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const bool in = f.real && f.s[half] < p.S;
      f.vec[half] = in ? p.vec[f.row0 + f.s[half]] : -INFINITY;
      f.state[half] = in ? f.s[half] : kNoState;
    }
    return f;
  };
  Walk::compute(ring, units, strips, kts, fetch, [&](const Fetched& f, int n0,
                                                     float(&acc)[64]) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float pv[8];
      int ps[8];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = q * 4 + jj;
        const int y0 = n0 + j * 8 + (lane % 4) * 2;  // 2 labels
        float x[2][2];  // lex of [half][e]
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float b = Walk::kStationary ? bias[j][e]
                          : y0 + e < p.V    ? p.vb[y0 + e]
                                            : 0.f;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            x[half][e] = acc[j * 4 + half * 2 + e] + b;
          }
        }
        if (Store && f.real) store_lex(p.lex, f.row0, f.s, y0, p.S, p.V, x);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float v = -INFINITY;
          int at = kNoState;
          pick(v, at, f.vec[0] + x[0][e], f.state[0]);
          pick(v, at, f.vec[1] + x[1][e], f.state[1]);
          pv[jj * 2 + e] = v;
          ps[jj * 2 + e] = at;
        }
      }
      argmax_level<4, 4>(pv, ps);
      argmax_level<2, 8>(pv, ps);
      argmax_level<1, 16>(pv, ps);
      const int c = scattered_column(q);
      red_v[warp * kBN + c] = pv[0];
      red_s[warp * kBN + c] = ps[0];
    }
    named_barrier(1 + group, kConsumers);
    const int c = threadIdx.x % kConsumers, y = n0 + c;
    if (f.real && y < p.V) {
      float v = red_v[c];
      int at = red_s[c];
#pragma unroll
      for (int w = 1; w < 4; ++w) {
        pick(v, at, red_v[w * kBN + c], red_s[w * kBN + c]);
      }
      const size_t out =
          (static_cast<size_t>(f.s0 / kRows) * p.B + f.b) * p.V + y;
      p.part_v[out] = v;
      p.part_s[out] = at;
    }
    named_barrier(1 + group, kConsumers);  // the scratch is free again
  });
}

// The launch of a Viterbi product in the walk its caller chose: with
// lanes > 0 the strip walk, that many lanes a strip (refused past
// kMaxStripDepth), else the pair walk on the card's sms SMs.
template <auto StripKernel, auto PairKernel, class P>
cudaError_t launch_viterbi_units(const bf16* joint, const bf16* vw16,
                                 const P& p, int extra, int sms, int lanes,
                                 cudaStream_t stream) {
  if (lanes > 0) {
    if (p.hp > kMaxStripDepth) return cudaErrorInvalidValue;
    return launch_units<StripKernel, StripWalk>(
        joint, vw16, p, extra, lanes * cdiv(p.Vp, kBN), stream);
  }
  return launch_units<PairKernel, PairWalk>(
      joint, vw16, p, extra, PairWalk::kBlocksPerSM * sms, stream);
}

// The (max, argmax) column reduction of p.live rows (none: no launch).
cudaError_t max_product(const bf16* joint, const bf16* vw16,
                        const ColumnMax& p, int sms, int lanes,
                        cudaStream_t stream) {
  return p.lex != nullptr
             ? launch_viterbi_units<column_max_kernel<true, StripWalk>,
                                    column_max_kernel<true, PairWalk>>(
                   joint, vw16, p, kReduceScratch, sms, lanes, stream)
             : launch_viterbi_units<column_max_kernel<false, StripWalk>,
                                    column_max_kernel<false, PairWalk>>(
                   joint, vw16, p, kReduceScratch, sms, lanes, stream);
}

// ---------------------------------------------------------------------------
// lex stored and reduced over the labels: the Viterbi forward's local
// normalization.

// For each state s of a live row b's units and each 128-label strip n:
// lex[b, s, y] = joint[b, s] . vw16[:, y] + vb[y] stored (float32, [B, S,
// V]) and (m, l) = logsumexp of lex[b, s, y] over the strip's labels y < V
// into part_m / part_l at (n B + b) S + s: m the strip's largest, l = sum
// exp(lex - m).
struct RowReduce {
  const float* vb;  // [V]
  const int* rows;  // the live rows first (null: 0..live-1)
  float* lex;       // [B, S, V]
  float* part_m;    // [ceil(Vp / 128), B, S]
  float* part_l;
  int B, S, V, hp, Vp;
  int live;
};

// The unit product with a row epilogue: a thread's two rows over its 32
// labels of the strip in registers, then the 4 lanes that share the rows
// (lane % 4) by __shfl_xor. One writer per (strip, b, s), no atomics, no
// epilogue scratch. The exps are expf's: the normalizer enters every path
// weight once a frame. Walk: PairWalk or StripWalk.
template <class Walk>
__global__ void __launch_bounds__(kProductThreads, Walk::kBlocksPerSM)
    row_reduce_kernel(const __grid_constant__ ProductMaps maps,
                      const RowReduce p) {
  extern __shared__ uint8_t raw[];
  const int strips = cdiv(p.Vp, kBN), kts = p.hp / kBK;
  const auto ring = Walk::ring(raw, kts);
  const int t64 = cdiv(p.S, kRows);
  const int units = p.live * t64;
  // Unit u's batch row and first state; false where u is no unit.
  const auto unit = [&](int u, int& b, int& s0) {
    if (u >= units) return false;
    const int slot = u / t64;
    b = p.rows == nullptr ? slot : p.rows[slot];
    s0 = u % t64 * kRows;
    return true;
  };
  if (Walk::Ring::producer()) {
    Walk::produce(ring, maps, unit, units, strips, kts);
    return;
  }
  const int lane = threadIdx.x % 32;
  float bias[kBN / 8][2];
  if constexpr (Walk::kStationary) {
    strip_bias(p.vb, p.V, Walk::strip(strips) * kBN, bias);
  }
  struct Fetched {
    int b, s0;
    bool real;
  };
  const auto fetch = [&](int u) {
    Fetched f;
    f.b = f.s0 = 0;
    f.real = unit(u, f.b, f.s0);
    return f;
  };
  Walk::compute(ring, units, strips, kts, fetch, [&](const Fetched& f, int n0,
                                                     float(&acc)[64]) {
    if (!f.real) return;
    const size_t row0 = static_cast<size_t>(f.b) * p.S;
    int s[2];
    unit_states(f.s0, s);
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int y0 = n0 + j * 8 + (lane % 4) * 2;  // 2 labels
      float x[2][2];  // lex of [half][e]
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool in = y0 + e < p.V;
        const float b = Walk::kStationary ? bias[j][e]
                        : in              ? p.vb[y0 + e]
                                          : 0.f;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          x[half][e] = acc[j * 4 + half * 2 + e] + b;
          acc[j * 4 + half * 2 + e] = in ? x[half][e] : -INFINITY;
          m[half] = fmaxf(m[half], acc[j * 4 + half * 2 + e]);
        }
      }
      store_lex(p.lex, row0, s, y0, p.S, p.V, x);
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      m[half] = fmaxf(m[half], __shfl_xor_sync(0xffffffffu, m[half], 1));
      m[half] = fmaxf(m[half], __shfl_xor_sync(0xffffffffu, m[half], 2));
      const float shift = m[half] == -INFINITY ? 0.f : m[half];
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          l[half] += expf(acc[j * 4 + half * 2 + e] - shift);
        }
      }
      l[half] += __shfl_xor_sync(0xffffffffu, l[half], 1);
      l[half] += __shfl_xor_sync(0xffffffffu, l[half], 2);
    }
    if (lane % 4 == 0) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        if (s[half] >= p.S) continue;
        const size_t at =
            (static_cast<size_t>(n0 / kBN) * p.B + f.b) * p.S + s[half];
        p.part_m[at] = m[half];
        p.part_l[at] = l[half];
      }
    }
  });
}

// The row reduction of p.live rows, as max_product (no epilogue scratch).
cudaError_t row_product(const bf16* joint, const bf16* vw16,
                        const RowReduce& p, int sms, int lanes,
                        cudaStream_t stream) {
  if (p.lex == nullptr) return cudaErrorInvalidValue;
  return launch_viterbi_units<row_reduce_kernel<StripWalk>,
                              row_reduce_kernel<PairWalk>>(
      joint, vw16, p, 0, sms, lanes, stream);
}

}  // namespace
}  // namespace head_product
