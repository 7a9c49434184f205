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

// Relative-position self-attention of the Conformer encoder (Transformer-XL
// scores) on Hopper, forward only, in float32.
//
// Replaces no TPU kernel: the JAX package has no Conformer with relative
// positions. It exists because no library kernel computes the
// Transformer-XL position term without materialising it. For batch row b,
// head h, query i and key j < len[b] (T the padded length, hd = 64):
//
//   s[i, j] = ((q[i] + u) . k[j] + (q[i] + v) . pos[T - 1 - i + j]) / 8
//   out[i]  = sum_j softmax_j(s[i, :])[j] * v[j]     (i < len[b]; else 0)
//
// pos ([2T - 1, H, hd]) holds the projected encodings of the relative
// positions T - 1, ..., -(T - 1) in that order (row T - 1 - (i - j) for the
// distance i - j, ESPnet's layout). The plain composition writes the
// position scores [B, H, T, 2T - 1], shifts them into [B, H, T, T] and
// softmaxes: ~75 GB of traffic a layer at B=256, T=799, H=8.
//
// What bounds it here. With TF32 off the products run on the CUDA cores'
// float32 FMA pipes: 6 T^2 d operations an utterance and layer (the
// content and position scores and the weighted sum of values), ~3 TFLOP a
// call of the benchmark's Conformer (L) cell, 67 TFLOP/s at peak; its
// bytes (q, k, v, the positions, out) are ~1.7 GB a layer. So operations.
//
// Design. One block of 256 threads takes 64 queries of one (b, h) and walks
// the key tiles of 64 up to len[b] with an online softmax (flash style), so
// no score leaves the block. A tile's position scores need the 127
// distances i - j of its 64 x 64 pairs: those rows of pos are staged in
// shared memory beside q + u, q + v (both [hd][64], staged once a block)
// and k ([hd][64]). Each thread owns a 4 x 4 patch of scores (queries
// 4 ty.., keys 4 tx..); at each depth it reads 4 (q + u), 4 k, 4 (q + v)
// and the 8 position values its 7 distances a - c + 3 need, all as
// 16-byte shared loads, for 32 FMAs. The probabilities go back to shared
// memory over k's buffer ([64][68], query-major) and the thread then owns
// a 4 x 4 patch of the output (queries 4 ty.., features 4 tx..), so the
// row statistics stay in its registers. Query tiles past len[b] only write
// zeros; keys past len[b] get weight 0 (the reference's -1e9 mask gives 0
// too: every row has key 0). 100 KB of shared memory: two blocks an SM.

#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int kHeadDim = 64;
constexpr int kBM = 64;  // queries a block
constexpr int kBN = 64;  // keys a tile
constexpr int kThreads = 256;
constexpr int kQStride = kBM + 4;  // q + u, q + v: [kHeadDim][kQStride]
constexpr int kKStride = kBN + 4;  // k: [kHeadDim][kKStride]
constexpr int kSStride = kBN + 4;  // probabilities: [kBM][kSStride]
constexpr int kPCols = kBM + kBN;  // 127 distances, one padding column
constexpr int kPStride = kPCols + 4;  // pos: [kHeadDim][kPStride]
constexpr int kSmemFloats = 2 * kHeadDim * kQStride + kHeadDim * kKStride +
                            kBN * kHeadDim + kHeadDim * kPStride;
constexpr size_t kSmemBytes = sizeof(float) * kSmemFloats;
static_assert(kBM * kSStride <= kHeadDim * kKStride,
              "the probabilities reuse k's buffer");

__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float4 smem4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// q, k, v: row (b, i) of head h at [b * batch_stride + i * row_stride +
// h * kHeadDim], 64 contiguous floats; pos [2T - 1, H * kHeadDim]; u, v
// biases [H, kHeadDim]; out [B, T, H * kHeadDim].
__global__ void __launch_bounds__(kThreads, 2)
rel_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, long long batch_stride,
                     long long row_stride, const float* __restrict__ pos,
                     const float* __restrict__ bias_u,
                     const float* __restrict__ bias_v,
                     const int* __restrict__ lengths, float* __restrict__ out,
                     int T, int H, float scale) {
  extern __shared__ float4 smem_raw[];
  float* qu = reinterpret_cast<float*>(smem_raw);
  float* qv = qu + kHeadDim * kQStride;
  float* kt = qv + kHeadDim * kQStride;
  float* ps = kt;  // the probabilities, once a tile's scores are done
  float* vs = kt + kHeadDim * kKStride;
  float* pw = vs + kBN * kHeadDim;

  const int i0 = blockIdx.x * kBM, h = blockIdx.y, b = blockIdx.z;
  const int len = lengths[b];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const long long d_model = static_cast<long long>(H) * kHeadDim;
  float* out_b = out + static_cast<long long>(b) * T * d_model + h * kHeadDim;

  if (i0 >= len) {
    for (int idx = tid; idx < kBM * (kHeadDim / 4); idx += kThreads) {
      const int r = idx / (kHeadDim / 4), c4 = idx % (kHeadDim / 4);
      if (i0 + r < T) {
        reinterpret_cast<float4*>(out_b + (i0 + r) * d_model)[c4] =
            make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    return;
  }

  const long long head = static_cast<long long>(b) * batch_stride +
                         h * kHeadDim;
  // q + u and q + v, depth-major: thread r = tid % 64 takes query i0 + r.
  for (int g = tid / kBM; g < kHeadDim / 4; g += kThreads / kBM) {
    const int r = tid % kBM, i = i0 + r;
    const float4 x = i < T ? load4(q + head + i * row_stride + 4 * g)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
    const float4 bu = load4(bias_u + h * kHeadDim + 4 * g);
    const float4 bv = load4(bias_v + h * kHeadDim + 4 * g);
    float* a = qu + 4 * g * kQStride + r;
    float* c = qv + 4 * g * kQStride + r;
    a[0] = x.x + bu.x; a[kQStride] = x.y + bu.y;
    a[2 * kQStride] = x.z + bu.z; a[3 * kQStride] = x.w + bu.w;
    c[0] = x.x + bv.x; c[kQStride] = x.y + bv.y;
    c[2 * kQStride] = x.z + bv.z; c[3 * kQStride] = x.w + bv.w;
  }

  float m_row[4], l_row[4], o[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m_row[a] = -INFINITY;
    l_row[a] = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) o[a][c] = 0.f;
  }
  // Column of pw holding distance (4 ty + a) - (4 tx + c) within the tile,
  // less a - c + 3: pw column = distance + kBN - 1.
  const int pbase = (ty - tx) * 4 + (kBN - 4);
  const int rows = 2 * T - 1;

  for (int j0 = 0; j0 < len; j0 += kBN) {
    __syncthreads();  // the previous tile's probabilities and values read
    for (int g = tid / kBN; g < kHeadDim / 4; g += kThreads / kBN) {
      const int r = tid % kBN, j = j0 + r;
      const float4 x = j < T ? load4(k + head + j * row_stride + 4 * g)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
      float* a = kt + 4 * g * kKStride + r;
      a[0] = x.x; a[kKStride] = x.y; a[2 * kKStride] = x.z;
      a[3 * kKStride] = x.w;
    }
    for (int idx = tid; idx < kBN * (kHeadDim / 4); idx += kThreads) {
      const int r = idx / (kHeadDim / 4), c4 = idx % (kHeadDim / 4);
      const int j = j0 + r;
      reinterpret_cast<float4*>(vs + r * kHeadDim)[c4] =
          j < T ? load4(v + head + j * row_stride + 4 * c4)
                : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    // Distance i - j = i0 - j0 + col - (kBN - 1) is pos row T - 1 - it.
    for (int g = tid / kPCols; g < kHeadDim / 4; g += kThreads / kPCols) {
      const int col = tid % kPCols;
      const int row = T - 1 - (i0 - j0 + col - (kBN - 1));
      const float4 x = (col < kPCols - 1 && row >= 0 && row < rows)
                           ? load4(pos + row * d_model + h * kHeadDim + 4 * g)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
      float* a = pw + 4 * g * kPStride + col;
      a[0] = x.x; a[kPStride] = x.y; a[2 * kPStride] = x.z;
      a[3 * kPStride] = x.w;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[a][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < kHeadDim; ++d) {
      const float4 a4 = smem4(qu + d * kQStride + ty * 4);
      const float4 k4 = smem4(kt + d * kKStride + tx * 4);
      const float4 b4 = smem4(qv + d * kQStride + ty * 4);
      const float4 p0 = smem4(pw + d * kPStride + pbase);
      const float4 p1 = smem4(pw + d * kPStride + pbase + 4);
      const float qa[4] = {a4.x, a4.y, a4.z, a4.w};
      const float kk[4] = {k4.x, k4.y, k4.z, k4.w};
      const float qb[4] = {b4.x, b4.y, b4.z, b4.w};
      const float p[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          s[a][c] = fmaf(qb[a], p[a - c + 3], fmaf(qa[a], kk[c], s[a][c]));
    }

    // Online softmax over the tile: a row's 64 keys lie across the 16
    // threads of one half-warp (the lanes that share ty).
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const bool live = j0 + tx * 4 + c < len;
        s[a][c] = live ? s[a][c] * scale : -INFINITY;
        mx = fmaxf(mx, s[a][c]);
      }
#pragma unroll
      for (int w = 1; w < 16; w *= 2)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float m_new = fmaxf(m_row[a], mx);
      const float corr = expf(m_row[a] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[a][c] = expf(s[a][c] - m_new);
        sum += s[a][c];
      }
#pragma unroll
      for (int w = 1; w < 16; w *= 2)
        sum += __shfl_xor_sync(0xffffffffu, sum, w);
      l_row[a] = l_row[a] * corr + sum;
      m_row[a] = m_new;
#pragma unroll
      for (int c = 0; c < 4; ++c) o[a][c] *= corr;
    }
    __syncthreads();  // every thread done with k before ps overwrites it
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      *reinterpret_cast<float4*>(ps + (ty * 4 + a) * kSStride + tx * 4) =
          make_float4(s[a][0], s[a][1], s[a][2], s[a][3]);
    }
    __syncthreads();

#pragma unroll 2
    for (int jj = 0; jj < kBN; jj += 4) {
      float4 pr[4], vr[4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
        pr[a] = smem4(ps + (ty * 4 + a) * kSStride + jj);
#pragma unroll
      for (int x = 0; x < 4; ++x)
        vr[x] = smem4(vs + (jj + x) * kHeadDim + tx * 4);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float pa[4] = {pr[a].x, pr[a].y, pr[a].z, pr[a].w};
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          o[a][0] = fmaf(pa[x], vr[x].x, o[a][0]);
          o[a][1] = fmaf(pa[x], vr[x].y, o[a][1]);
          o[a][2] = fmaf(pa[x], vr[x].z, o[a][2]);
          o[a][3] = fmaf(pa[x], vr[x].w, o[a][3]);
        }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = i0 + ty * 4 + a;
    if (i >= T) continue;
    float4 r = make_float4(0.f, 0.f, 0.f, 0.f);
    if (i < len) {
      const float inv = 1.f / l_row[a];
      r = make_float4(o[a][0] * inv, o[a][1] * inv, o[a][2] * inv,
                      o[a][3] * inv);
    }
    *reinterpret_cast<float4*>(out_b + i * d_model + tx * 4) = r;
  }
}

// cudaFuncSetAttribute holds for the current device only: kept per device.
constexpr int kMaxDevices = 64;

cudaError_t allow_smem() {
  static bool allowed[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < kMaxDevices && allowed[device]) return cudaSuccess;
  err = cudaFuncSetAttribute(rel_attention_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kSmemBytes));
  if (err == cudaSuccess && device < kMaxDevices) allowed[device] = true;
  return err;
}

}  // namespace

extern "C" {

// Launches the forward on `stream` and returns the launch error (0 on
// success). q, k, v: float32 rows of 64 contiguous features per head, row
// (b, i) of head h at b * batch_stride + i * row_stride + 64 h (strides in
// floats, multiples of 4, pointers 16-byte aligned); pos [2T - 1, 64 H],
// bias_u / bias_v [H, 64], lengths [B] int32 (each 0..T), out [B, T, 64 H].
int rel_attention_forward(const float* q, const float* k, const float* v,
                          long long batch_stride, long long row_stride,
                          const float* pos, const float* bias_u,
                          const float* bias_v, const int* lengths,
                          float* out, int B, int T, int H, int head_dim,
                          float scale, cudaStream_t stream) {
  if (head_dim != kHeadDim || B <= 0 || T <= 0 || H <= 0 || H > 65535 ||
      B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = allow_smem();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + kBM - 1) / kBM, H, B);
  rel_attention_kernel<<<grid, kThreads, kSmemBytes, stream>>>(
      q, k, v, batch_stride, row_stride, pos, bias_u, bias_v, lengths, out, T,
      H, scale);
  return static_cast<int>(cudaGetLastError());
}

const char* rel_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
