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

// The two head-gradient products of a frame, on wgmma (wgmma_tiles.cuh),
// shared by the bfloat16 backward of the bigram log partition
// (fused_scan.cu), of the frame reduction (sharded_scan.cu) and of the
// joint+head (joint_head.cu), with the numerator backward's d_joint
// product (numerator_scan.cu) beside them. From the
// frame's bfloat16 joint [B, S, hp] and lexical cotangent d_lex [B, S, Vp]
// (both padded with zeros past h and V; Maps), over the frame's live batch
// rows:
//
//   head_grad:  d_vw[hh, y] = sum_{b, s} joint[b, s, hh] d_lex[b, s, y]
//     A = joint^T and B = d_lex, both MN-major (the contraction runs over
//     their rows). The (b, 64-state) depth tiles of the live rows are
//     split evenly over gridDim.z blocks, each writing or adding its own
//     partial [splits, h, V].
//     The live rows' count may come from device memory (count), as the
//     numerator backward's list of live (frame, row tile) items does.
//   joint_grad: du[b, s, hh] = (d_lex[b, s] . vw[hh] + d_blank[b, s]
//     bw[hh]) (1 - joint32[b, s, hh]^2), joint32 = tanh(pc[s] + pf[b]) in
//     float32 (written by the kernel that forms the bfloat16 joint: a tanh
//     in this epilogue left it latency-bound), bw and d_blank float32
//     (unrounded). A block owns (64 states, 128 hidden units) and runs the
//     live rows of its split one after another (one segment each, the ring
//     running on across them), so that
//     d_pc = sum_b du stays in its registers: the cross-frame buffer is
//     [splits, S, h], not [B, S, h]. Per row it writes the state sums of du
//     (dpf_part [S/64, B, h]) and writes or adds those of joint32 d_blank
//     (dbw [B, S/64, h]).
//     With RoundBlank, d_blank, bw and the joint of dbw are rounded to
//     bfloat16 (the joint+head backward's contract).
//   num_joint_grad: the numerator backward's d_joint product (HAT /
//     log-softmax numerator, numerator_scan.cu). Rows are (frame, 64-row
//     tile) items of the device's live list; a block owns (row tile, 128
//     hidden units, split) and runs the tile's items of its split one
//     after another, so that d_pc = sum_t du stays in its registers. Its
//     epilogue adds gl wy[r] + d_blank bw to ds . W^T, takes the tanh
//     derivative, and sums du over each batch row's label positions in the
//     tile (a tile may hold the end of one batch row and the start of the
//     next): d_pf's partials [slots, J, h].
//
// Every partial belongs to one block; nothing is summed with atomics.

#pragma once

#include <algorithm>

#include "wgmma_tiles.cuh"

namespace head_grads {
namespace {

using namespace wgmma_tiles;

__device__ __forceinline__ int live_row(const int* rows, int i) {
  return rows == nullptr ? i : rows[i];
}

// out (+)= v, as accumulate says.
__device__ __forceinline__ void put(float* out, float v, int accumulate) {
  *out = accumulate ? *out + v : v;
}

struct HeadGrad {
  const int* rows;  // the live rows (null: 0..live-1)
  float* out;       // [splits, h, V]
  int live, S, h, V, accumulate;  // S: the states of d_lex (the chunk's)
  int s_begin;      // the chunk's first state in the joint
  const int* count;  // where set, the live rows' count on the device
};

// Grid (hp / 64, ceil(Vp / 128), splits).
__global__ void __launch_bounds__(kThreads, 2)
    head_grad_kernel(const __grid_constant__ Maps maps, const HeadGrad p) {
  extern __shared__ uint8_t raw[];
  const Ring<4> ring(raw);
  const int m0 = blockIdx.x * kRows, n0 = blockIdx.y * kBN;
  const int t64 = cdiv(p.S, 64);
  const int live = p.count != nullptr ? *p.count : p.live;
  const long long total = static_cast<long long>(live) * t64;
  const int k_begin = static_cast<int>(total * blockIdx.z / gridDim.z);
  const int tiles =
      static_cast<int>(total * (blockIdx.z + 1) / gridDim.z) - k_begin;
  if (ring.producer()) {
    produce(ring, tiles, [&](int q, uint8_t* a, uint8_t* b, uint64_t* bar) {
      const int kq = k_begin + q;
      const int row = live_row(p.rows, kq / t64), s0 = kq % t64 * 64;
      tma_load(a, maps.joint, m0, p.s_begin + s0, row, bar);
      tma_load(b, maps.d_lex, n0, s0, row, bar);
      tma_load(b + kBox, maps.d_lex, n0 + 64, s0, row, bar);
    });
    return;
  }
  float d[64];
  zero(d);
  if (tiles > 0) {
    consume<true, true>(ring, 1, tiles, d, [](int, float(&)[64]) {});
  } else if (p.accumulate) {
    return;
  }
  float* out = p.out + static_cast<size_t>(blockIdx.z) * p.h * p.V;
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int hh = m0 + acc_row(i), y = n0 + acc_col(i);
    if (hh < p.h && y < p.V) {
      put(out + static_cast<size_t>(hh) * p.V + y, d[i], p.accumulate);
    }
  }
}

struct JointGrad {
  const float* bw;        // [h]
  const float* d_blank;   // [B, S]
  const float* joint32;   // [B, S, h]
  const int* rows;        // the live rows (null: 0..live-1)
  float* dpf_part;        // [ceil(S / 64), B, h], written
  float* dbw;             // [B, ceil(S / 64), h]
  float* dpc;             // [splits, S, h]
  int live, B, S, h, Vp, accumulate;
  int s_begin, s_count;   // the chunk of states that d_lex holds
};

// Epilogue scratch: per consumer warp, two rows of kBN column sums.
constexpr int kJointGradExtra = 4 * 2 * kBN * 4;

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// Grid (ceil(s_count / 64), ceil(hp / 128), splits), splits <= live.
// RoundBlank: d_blank, bw and the joint of dbw rounded to bfloat16 (the
// joint+head contract); else float32 (the frame reduction's).
template <bool RoundBlank>
__global__ void __launch_bounds__(kThreads, 2)
    joint_grad_kernel(const __grid_constant__ Maps maps, const JointGrad p) {
  extern __shared__ uint8_t raw[];
  const Ring<4> ring(raw);
  // s0 among the S states, c0 among the chunk's (d_lex's rows).
  const int c0 = blockIdx.x * kRows, s0 = p.s_begin + c0, n0 = blockIdx.y * kBN;
  const int s_end = p.s_begin + p.s_count;
  const int r_begin = p.live * blockIdx.z / gridDim.z;
  const int segments = p.live * (blockIdx.z + 1) / gridDim.z - r_begin;
  const int kts = p.Vp / kBK;
  if (ring.producer()) {
    produce(ring, segments * kts, [&](int q, uint8_t* a, uint8_t* b,
                                      uint64_t* bar) {
      const int row = live_row(p.rows, r_begin + q / kts), k0 = q % kts * kBK;
      tma_load(a, maps.d_lex, k0, c0, row, bar);
      tma_load(b, maps.vw, k0, n0, bar);
      tma_load(b + kBox, maps.vw, k0, n0 + 64, bar);
    });
    return;
  }
  float* red = reinterpret_cast<float*>(ring.extra);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int t64 = cdiv(p.S, 64), tile = s0 / 64;
  int srow[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) srow[half] = s0 + acc_row(half * 2);
  float dpc[64];
  zero(dpc);
  float d[64];
  consume<false, false>(ring, segments, kts, d, [&](int seg,
                                                    float(&acc)[64]) {
    const int b = live_row(p.rows, r_begin + seg);
    const float* jrow[2];
    float db[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const size_t row = static_cast<size_t>(b) * p.S + srow[half];
      db[half] = srow[half] < s_end ? p.d_blank[row] : 0.f;
      if (RoundBlank) db[half] = round_bf16(db[half]);
      jrow[half] = p.joint32 + row * p.h;
    }
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      float cf[2] = {0.f, 0.f}, cw[2] = {0.f, 0.f};
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int hh = n0 + j * 8 + (lane % 4) * 2 + e;
        if (hh < p.h) {
          const float bw = RoundBlank ? round_bf16(p.bw[hh]) : p.bw[hh];
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int s = srow[half], i = j * 4 + half * 2 + e;
            if (s < s_end) {
              const float jt = jrow[half][hh];
              const float dp = fmaf(db[half], bw, acc[i]) * (1.f - jt * jt);
              dpc[i] += dp;
              cf[e] += dp;
              cw[e] = fmaf(RoundBlank ? round_bf16(jt) : jt, db[half],
                           cw[e]);
            }
          }
        }
      }
      // Sum over the warp's 16 rows (lanes with one lane % 4).
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          cf[e] += __shfl_xor_sync(0xffffffffu, cf[e], o);
          cw[e] += __shfl_xor_sync(0xffffffffu, cw[e], o);
        }
      }
      if (lane < 4) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = j * 8 + lane * 2 + e;
          red[(warp * 2) * kBN + c] = cf[e];
          red[(warp * 2 + 1) * kBN + c] = cw[e];
        }
      }
    }
    named_barrier(1, kConsumers);
    const int t = threadIdx.x, hh = n0 + t;
    if (hh < p.h) {
      float sf = 0.f, sw = 0.f;
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        sf += red[(w * 2) * kBN + t];
        sw += red[(w * 2 + 1) * kBN + t];
      }
      p.dpf_part[(static_cast<size_t>(tile) * p.B + b) * p.h + hh] = sf;
      put(p.dbw + (static_cast<size_t>(b) * t64 + tile) * p.h + hh, sw,
          p.accumulate);
    }
    named_barrier(1, kConsumers);
  });
  if (segments == 0) return;
  float* out = p.dpc + static_cast<size_t>(blockIdx.z) * p.S * p.h;
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int s = srow[(i >> 1) & 1], hh = n0 + acc_col(i);
    if (s < s_end && hh < p.h) {
      put(out + static_cast<size_t>(s) * p.h + hh, dpc[i], p.accumulate);
    }
  }
}

// The numerator's per-row cotangent terms (numerator_scan.cu's contract):
// coef e^(logits - ref) is ds; d_blank the blank score's cotangent.
struct RowCotangent {
  float coef, ref, gl, d_blank;
};

__device__ __forceinline__ float log_add_exp(float a, float b) {
  const float m = fmaxf(a, b);
  if (m == -INFINITY) return -INFINITY;
  return m + log1pf(expf(fminf(a, b) - m));
}

__device__ __forceinline__ RowCotangent row_cotangent(float gb, float gl,
                                                      float z, float blank,
                                                      int hat) {
  if (hat) {
    const float sig = 1.f / (1.f + expf(-blank));
    return {-gl, z, gl, gb * (1.f - sig) - gl * sig};
  }
  const float za = log_add_exp(blank, z);
  return {-(gb + gl), za, gl, gb - (gb + gl) * expf(blank - za)};
}

struct NumJointGrad {
  const float* bw;       // [h]
  const float* wy;       // [R, h]
  const float* g_b;      // [T, R], and g_l, z, blank
  const float* g_l;
  const float* z;
  const float* blank;
  const float* joint32;  // [slots, 64, h], the staged float32 joint
  const int* items;      // t * R64 + tile of each live item, by position
  const int* groups;     // the chunk's [R64 + 1] item positions per tile
  float* dpf_part;       // [slots, J, h], written
  float* dpc;            // [splits, R, h], added
  int R, U1, h, R64, J, Vp, hat;
};

// Grid (R64, ceil(hp / 128), splits). maps: d_lex = ds [slots, 64, Vp],
// vw = the head [hp, Vp], both bfloat16.
__global__ void __launch_bounds__(kThreads, 2)
    num_joint_grad_kernel(const __grid_constant__ Maps maps,
                          const NumJointGrad p) {
  extern __shared__ uint8_t raw[];
  const Ring<4> ring(raw);
  const int tile = blockIdx.x, n0 = blockIdx.y * kBN;
  const int base = p.groups[0];
  const int first = p.groups[tile], n = p.groups[tile + 1] - first;
  const int seg_begin = first + n * static_cast<int>(blockIdx.z) / gridDim.z;
  const int segments =
      first + n * (static_cast<int>(blockIdx.z) + 1) / gridDim.z - seg_begin;
  const int kts = p.Vp / kBK;
  if (ring.producer()) {
    produce(ring, segments * kts, [&](int q, uint8_t* a, uint8_t* b,
                                      uint64_t* bar) {
      const int slot = seg_begin + q / kts - base, k0 = q % kts * kBK;
      tma_load(a, maps.d_lex, k0, 0, slot, bar);
      tma_load(b, maps.vw, k0, n0, bar);
      tma_load(b + kBox, maps.vw, k0, n0 + 64, bar);
    });
    return;
  }
  if (segments == 0) return;
  float* red = reinterpret_cast<float*>(ring.extra);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = tile * kRows;
  int row[2], r[2], b[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    row[half] = acc_row(half * 2);
    r[half] = r0 + row[half];
    b[half] = r[half] < p.R ? r[half] / p.U1 : -1;
  }
  const int b_first = r0 / p.U1, b_last = (min(p.R, r0 + kRows) - 1) / p.U1;
  float dpc[64];
  zero(dpc);
  float d[64];
  consume<false, false>(ring, segments, kts, d, [&](int seg,
                                                    float(&acc)[64]) {
    const int pos = seg_begin + seg, slot = pos - base;
    const int t = p.items[pos] / p.R64;
    RowCotangent rc[2];
    const float* jrow[2];
    const float* wrow[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      if (b[half] >= 0) {
        const size_t at = static_cast<size_t>(t) * p.R + r[half];
        rc[half] = row_cotangent(p.g_b[at], p.g_l[at], p.z[at], p.blank[at],
                                 p.hat);
      } else {
        rc[half] = {0.f, 0.f, 0.f, 0.f};
      }
      jrow[half] = p.joint32 + (static_cast<size_t>(slot) * kRows + row[half]) *
                                   p.h;
      wrow[half] = p.wy + static_cast<size_t>(b[half] >= 0 ? r[half] : 0) *
                              p.h;
    }
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int hh = n0 + j * 8 + (lane % 4) * 2 + e;
        const float bw = hh < p.h ? p.bw[hh] : 0.f;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int i = j * 4 + half * 2 + e;
          float du = 0.f;
          if (hh < p.h && b[half] >= 0) {
            const float jt = jrow[half][hh];
            du = (acc[i] + rc[half].gl * wrow[half][hh] +
                  rc[half].d_blank * bw) *
                 (1.f - jt * jt);
          }
          dpc[i] += du;
          acc[i] = du;
        }
      }
    }
    // d_pf: the column sums of du over each batch row's rows of the tile.
    for (int bb = b_first; bb <= b_last; ++bb) {
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        float cf[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          cf[e] = (b[0] == bb ? acc[j * 4 + e] : 0.f) +
                  (b[1] == bb ? acc[j * 4 + 2 + e] : 0.f);
        }
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            cf[e] += __shfl_xor_sync(0xffffffffu, cf[e], o);
          }
        }
        if (lane < 4) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            red[warp * kBN + j * 8 + lane * 2 + e] = cf[e];
          }
        }
      }
      named_barrier(1, kConsumers);
      const int c = threadIdx.x, hh = n0 + c;
      if (hh < p.h) {
        float total = 0.f;
#pragma unroll
        for (int w = 0; w < 4; ++w) total += red[w * kBN + c];
        p.dpf_part[(static_cast<size_t>(slot) * p.J + bb - b_first) * p.h +
                   hh] = total;
      }
      named_barrier(1, kConsumers);
    }
  });
  float* out = p.dpc + static_cast<size_t>(blockIdx.z) * p.R * p.h;
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int half = (i >> 1) & 1, hh = n0 + acc_col(i);
    if (b[half] >= 0 && hh < p.h) {
      out[static_cast<size_t>(r[half]) * p.h + hh] += dpc[i];
    }
  }
}

// Up to kMaxSums reductions in one launch: out[i] = sum_r in[r * n + i].
constexpr int kMaxSums = 8;

struct Sums {
  struct {
    const float* in;
    int rows, n;
    float* out;
  } job[kMaxSums];
  int count;
};

// Grid (ceil(max n / 256), count).
__global__ void __launch_bounds__(kSumThreads) sums_kernel(const Sums sums) {
  const auto& job = sums.job[blockIdx.y];
  const int i = blockIdx.x * kSumThreads + threadIdx.x;
  if (i >= job.n) return;
  float total = 0.f;
  for (int r = 0; r < job.rows; ++r) {
    total += job.in[static_cast<size_t>(r) * job.n + i];
  }
  job.out[i] = total;
}

cudaError_t launch_sums(const Sums& sums, cudaStream_t stream) {
  int blocks = 1;
  for (int j = 0; j < sums.count; ++j) {
    blocks = std::max(blocks, cdiv(sums.job[j].n, kSumThreads));
  }
  sums_kernel<<<dim3(blocks, sums.count), kSumThreads, 0, stream>>>(sums);
  return cudaGetLastError();
}

cudaError_t launch_num_joint_grad(const Maps& maps, const NumJointGrad& p,
                                  int hp, int splits, cudaStream_t stream) {
  constexpr int kSmem = smem_bytes(4, 4 * kBN * 4);
  const cudaError_t err = allow_smem<num_joint_grad_kernel>(kSmem);
  if (err != cudaSuccess) return err;
  num_joint_grad_kernel<<<dim3(p.R64, cdiv(hp, kBN), splits), kThreads, kSmem,
                          stream>>>(maps, p);
  return cudaGetLastError();
}

cudaError_t launch_head_grad(const Maps& maps, const HeadGrad& p, int hp,
                             int Vp, int splits, cudaStream_t stream) {
  constexpr int kSmem = smem_bytes(4, 0);
  const cudaError_t err = allow_smem<head_grad_kernel>(kSmem);
  if (err != cudaSuccess) return err;
  head_grad_kernel<<<dim3(hp / kRows, cdiv(Vp, kBN), splits), kThreads,
                     kSmem, stream>>>(maps, p);
  return cudaGetLastError();
}

template <bool RoundBlank = false>
cudaError_t launch_joint_grad(const Maps& maps, const JointGrad& p, int hp,
                              int splits, cudaStream_t stream) {
  constexpr int kSmem = smem_bytes(4, kJointGradExtra);
  const cudaError_t err = allow_smem<joint_grad_kernel<RoundBlank>>(kSmem);
  if (err != cudaSuccess) return err;
  joint_grad_kernel<RoundBlank>
      <<<dim3(cdiv(p.s_count, kRows), cdiv(hp, kBN), splits), kThreads, kSmem,
         stream>>>(maps, p);
  return cudaGetLastError();
}

}  // namespace
}  // namespace head_grads
