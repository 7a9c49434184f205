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

// Hopper warpgroup products for the bfloat16 backward kernels of
// fused_scan.cu, sharded_scan.cu, joint_head.cu and numerator_scan.cu, and
// the gradient products they share (head_grads.cuh).
//
// A block is one consumer warpgroup and one producer warp. Its tile is 64
// rows by kBN = 128 columns, the float32 sum in the warpgroup's registers
// (64 per thread), multiplied with wgmma.mma_async m64n128k16 from bfloat16
// operands in shared memory. One thread of the producer warp streams the
// operands through a ring of kStages stages of kBK = 64 depths with TMA
// (cp.async.bulk.tensor, three 64 x 64 boxes a stage, zero-filled past the
// tensors' edges); each stage has a "full" mbarrier, which the copies
// complete (expect_tx / complete_tx), and an "empty" one, which each
// consumer warp arrives on once its products of the stage are done
// (wgmma.wait_group), so that loads run up to kStages stages ahead of the
// products. A ring of 72-96 KB and at most 200 registers a thread leave
// room for two blocks on an SM: one block's epilogue runs under the other's
// products.
//
// Layouts: the TMA boxes are 64 entries (128 bytes) wide with the 128-byte
// swizzle (16-byte chunk c of row r at chunk c ^ (r % 8)), the layout wgmma
// reads through its SW128 descriptors. An operand whose depth is contiguous
// in device memory (K-major) is staged as [row][64 depths]; one whose rows
// or columns are contiguous (MN-major, wgmma's transposed operand) as
// blocks of [64 depths][64 rows or columns], 8 KB apart. The operands are
// the callers' own bfloat16 buffers, padded to multiples of 64 along h and
// V (hp, Vp) with zeros.
//
// Everything here has internal linkage: the libraries that include it
// share no state (its statics would otherwise be unified across them).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace wgmma_tiles {
namespace {

using bf16 = __nv_bfloat16;

constexpr int kBK = 64;            // depths per stage
constexpr int kBN = 128;           // columns per tile
constexpr int kRows = 64;          // rows per tile: one warpgroup
constexpr int kConsumers = 128;
constexpr int kThreads = kConsumers + 32;  // + the producer warp
constexpr int kBox = 64 * 128;             // one 64 x 64 bfloat16 box
constexpr int kABytes = kBox;
constexpr int kBBytes = 2 * kBox;
constexpr int kStageBytes = kABytes + kBBytes;
constexpr int kAtom = 1024;  // the swizzle repeats every 8 rows of 128 bytes
constexpr int kSumThreads = 256;

// Dynamic shared memory of a ring of `stages` and `extra` bytes of
// epilogue scratch: 1024 of alignment slack, the ring, its barriers, the
// scratch.
constexpr int smem_bytes(int stages, int extra) {
  return 1024 + stages * kStageBytes + 2 * stages * 8 + extra;
}

__host__ __device__ constexpr int round_up(int n, int m) {
  return (n + m - 1) / m * m;
}

__host__ __device__ constexpr int cdiv(int n, int m) { return (n + m - 1) / m; }

// ---------------------------------------------------------------------------
// PTX wrappers.

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Arrives and expects `bytes` more of asynchronous copies this phase.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Waits until the barrier's phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// One TMA box of a 2-d or 3-d tensor map at coordinates (c0 innermost, ...)
// into dst; completes `bar`'s transaction bytes.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap& map,
                                         int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(&map)), "r"(c0), "r"(c1),
      "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap& map,
                                         int c0, int c1, int c2,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(&map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous products.
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A B for a 64 x 128 x 16 piece; TransA / TransB 1 for MN-major.
template <int TransA, int TransB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t desc_a,
                                                 uint64_t desc_b,
                                                 int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TransA), "n"(TransB));
}

// The SW128 shared-memory descriptor of an operand piece at p.
__device__ __forceinline__ uint64_t descriptor(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  const uint32_t a = smem_u32(p);
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (1ull << 62);
}

// A stage's products: A its 64 rows, B its kBN columns, kBK depths in four
// k16 steps; `first` overwrites d. K-major steps advance 32 bytes along the
// swizzled rows, MN-major ones 16 depth rows (two swizzle atoms); MN-major
// blocks of 64 columns lie kBox apart.
template <bool AMN, bool BMN>
__device__ __forceinline__ void mma_stage(float (&d)[64], const uint8_t* a,
                                          const uint8_t* b, bool first) {
#pragma unroll
  for (int j = 0; j < kBK / 16; ++j) {
    const uint8_t* pa = a + (AMN ? j * 2 * kAtom : j * 32);
    const uint8_t* pb = b + (BMN ? j * 2 * kAtom : j * 32);
    wgmma_m64n128k16<AMN, BMN>(d, descriptor(pa, AMN ? kBox : 16, kAtom),
                               descriptor(pb, BMN ? kBox : 16, kAtom),
                               first && j == 0 ? 0 : 1);
  }
}

// The block's shared memory: a ring of Stages, its barriers and `extra`
// scratch.
template <int Stages>
struct Ring {
  static constexpr int kStages = Stages;
  uint8_t* stages;
  uint64_t* full;
  uint64_t* empty;
  uint8_t* extra;

  __device__ __forceinline__ explicit Ring(uint8_t* raw) {
    stages = reinterpret_cast<uint8_t*>(
        (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t{1023});
    full = reinterpret_cast<uint64_t*>(stages + kStages * kStageBytes);
    empty = full + kStages;
    extra = reinterpret_cast<uint8_t*>(empty + kStages);
    if (threadIdx.x == 0) {
      for (int s = 0; s < kStages; ++s) {
        mbar_init(full + s, 1);          // the producer's expect_tx
        mbar_init(empty + s, kConsumers / 32);
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }

  __device__ __forceinline__ uint8_t* a(int s) const {
    return stages + s * kStageBytes;
  }
  __device__ __forceinline__ uint8_t* b(int s) const {
    return a(s) + kABytes;
  }
  static __device__ __forceinline__ bool producer() {
    return threadIdx.x >= kConsumers;
  }
};

// The producer: one thread issues `tiles` stages, load(q, a, b, bar)
// issuing stage q's three boxes (kStageBytes) on bar.
template <class R, class Load>
__device__ __forceinline__ void produce(const R& ring, int tiles,
                                        const Load& load) {
  constexpr int kStages = R::kStages;
  if (threadIdx.x != kConsumers) return;
  for (int q = 0; q < tiles; ++q) {
    const int s = q % kStages;
    mbar_wait(ring.empty + s, ((q / kStages) & 1) ^ 1);
    mbar_expect(ring.full + s, kStageBytes);
    load(q, ring.a(s), ring.b(s), ring.full + s);
  }
}

// The consumers: segments of kts stages each (kts >= 1), the sum of each
// in d (overwritten at its first stage), then epilogue(seg, d).
template <bool AMN, bool BMN, class R, class Epilogue>
__device__ __forceinline__ void consume(const R& ring, int segments,
                                        int kts, float (&d)[64],
                                        const Epilogue& epilogue) {
  constexpr int kStages = R::kStages;
  const bool leader = threadIdx.x % 32 == 0;
  int q = 0;
  for (int seg = 0; seg < segments; ++seg) {
    for (int kt = 0; kt < kts; ++kt, ++q) {
      const int s = q % kStages;
      mbar_wait(ring.full + s, (q / kStages) & 1);
      fence_acc(d);
      wgmma_fence();
      mma_stage<AMN, BMN>(d, ring.a(s), ring.b(s), kt == 0);
      wgmma_commit();
      fence_acc(d);
      if (kt > 0) {  // the previous stage's products are done: free it
        wgmma_wait<1>();
        fence_acc(d);
        if (leader) mbar_arrive(ring.empty + (q - 1) % kStages);
      }
    }
    wgmma_wait<0>();
    fence_acc(d);
    if (leader) mbar_arrive(ring.empty + (q - 1) % kStages);
    epilogue(seg, d);
  }
}

// Row (of 64) and column (of kBN) of this thread's accumulator entry i:
// wgmma's m64nN float32 layout. Entry j * 4 + half * 2 + e lies in row
// acc_row(half * 2), column j * 8 + (lane % 4) * 2 + e.
__device__ __forceinline__ int acc_row(int i) {
  return threadIdx.x / 32 * 16 + (threadIdx.x % 32) / 4 + ((i >> 1) & 1) * 8;
}

__device__ __forceinline__ int acc_col(int i) {
  return (i >> 2) * 8 + (threadIdx.x % 4) * 2 + (i & 1);
}

__device__ __forceinline__ void zero(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.f;
}

// ---------------------------------------------------------------------------
// Host side.

// Raises a kernel's dynamic shared memory limit to `bytes` on the current
// device (once per kernel, device and size: the attribute holds only for
// the device that is current when it is set).
constexpr int kMaxDevices = 64;

template <auto Kernel>
cudaError_t allow_smem(int bytes) {
  static int allowed[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < kMaxDevices && allowed[device] >= bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(Kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess && device < kMaxDevices) allowed[device] = bytes;
  return err;
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, through the runtime (no link to the
// driver library).
cudaError_t encoder(EncodeTiled* out) {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || p == nullptr) {
      return cudaErrorNotSupported;
    }
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  *out = fn;
  return cudaSuccess;
}

// The map of a row-major bfloat16 tensor of `rank` (2 or 3) dimensions,
// dims innermost first (the innermost a multiple of 8), in 64 x 64 (x 1)
// boxes with the 128-byte swizzle; reads past the dims give zeros.
//
// A map is a function of (base, rank, dims) alone, and encoding one is a
// driver call that costs the host more than launching a kernel. The
// callers' scratch comes back at the same addresses from PyTorch's caching
// allocator call after call, so each thread keeps its last kMapCache maps
// and reuses one whose base, rank and dims match.
constexpr int kMapCache = 16;

struct CachedMap {
  CUtensorMap map;
  const void* base;
  int rank;
  cuuint64_t dims[3];
};

cudaError_t box_map(CUtensorMap* map, const bf16* base, int rank,
                    const cuuint64_t* dims) {
  thread_local CachedMap cache[kMapCache] = {};
  thread_local int next = 0;
  for (const CachedMap& c : cache) {
    if (c.base == base && c.rank == rank && c.dims[0] == dims[0] &&
        c.dims[1] == dims[1] && (rank < 3 || c.dims[2] == dims[2])) {
      *map = c.map;
      return cudaSuccess;
    }
  }
  EncodeTiled encode = nullptr;
  const cudaError_t err = encoder(&encode);
  if (err != cudaSuccess) return err;
  cuuint64_t strides[2] = {dims[0] * 2, dims[0] * dims[1] * 2};
  const cuuint32_t box[3] = {64, 64, 1}, unit[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<bf16*>(base),
      dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return cudaErrorInvalidValue;
  CachedMap& slot = cache[next];
  next = (next + 1) % kMapCache;
  slot.map = *map;
  slot.base = base;
  slot.rank = rank;
  for (int i = 0; i < 3; ++i) slot.dims[i] = i < rank ? dims[i] : 0;
  return cudaSuccess;
}

// The three operand maps of a frame's products: joint [B, S, hp], d_lex
// [B, lex_states, Vp] (lex_states = S, or a chunk of the states: d_lex
// then holds only the chunk's) and the head vw [hp, Vp], bfloat16.
struct Maps {
  CUtensorMap joint, d_lex, vw;
};

cudaError_t lex_map(CUtensorMap* map, const bf16* d_lex, int B,
                    int lex_states, int Vp) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(Vp),
                              static_cast<cuuint64_t>(lex_states),
                              static_cast<cuuint64_t>(B)};
  return box_map(map, d_lex, 3, dims);
}

cudaError_t make_maps(Maps* maps, const bf16* joint, const bf16* d_lex,
                      const bf16* vw, int B, int S, int lex_states, int hp,
                      int Vp) {
  const cuuint64_t joint_dims[3] = {static_cast<cuuint64_t>(hp),
                                    static_cast<cuuint64_t>(S),
                                    static_cast<cuuint64_t>(B)};
  const cuuint64_t vw_dims[2] = {static_cast<cuuint64_t>(Vp),
                                 static_cast<cuuint64_t>(hp)};
  cudaError_t err = box_map(&maps->joint, joint, 3, joint_dims);
  if (err == cudaSuccess) err = lex_map(&maps->d_lex, d_lex, B, lex_states, Vp);
  if (err == cudaSuccess) err = box_map(&maps->vw, vw, 2, vw_dims);
  return err;
}

}  // namespace
}  // namespace wgmma_tiles
