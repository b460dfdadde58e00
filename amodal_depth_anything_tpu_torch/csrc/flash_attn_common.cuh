// Shared device helpers of the flash-attention kernels (forward and backward)
// for NVIDIA Hopper (sm_90a): tile sizes, strided addressing, cp.async
// copies, bf16 packing and the float32 tile loader. Included by
// flash_attn_fwd.cu and flash_attn_bwd.cu (through sm90.cuh, also by
// fused_epilogue.cu).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;         // query rows per block
constexpr int kBN = 64;         // key rows per K/V tile
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kLog2e = 1.4426950408889634f;

// (batch, head, token) strides in elements; the head dim is contiguous
struct Strides {
  long long b, h, n;
};

// ------------------------------------------------------------ float32 path

constexpr int kF32Threads = 256;     // 16 x 16 threads, each a 4x4 patch
constexpr int kPLd = kBN + 4;        // padded rows of a 64 x 64 f32 score tile

// Stage rows [row0, row0 + 64) of one (b, h) slice into smem (row stride
// `ld` floats, DPAD columns), times `mul`, zero-filling rows at or past
// `rows` and the columns from the head dim `d` (a multiple of 4) to DPAD.
template <int DPAD>
__device__ __forceinline__ void stage_tile_f32(float* dst, int ld,
                                               const float* src,
                                               long long row_stride, int row0,
                                               int rows, float mul, int d) {
  for (int i = threadIdx.x; i < 64 * (DPAD / 4); i += kF32Threads) {
    const int r = i / (DPAD / 4);
    const int c = (i % (DPAD / 4)) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < rows && c < d) {
      v = *reinterpret_cast<const float4*>(
          src + (long long)(row0 + r) * row_stride + c);
      v.x *= mul; v.y *= mul; v.z *= mul; v.w *= mul;
    }
    *reinterpret_cast<float4*>(dst + r * ld + c) = v;
  }
}

// The float32 kernels' output columns: a thread (tx of 16) holds kCols of
// the DPAD, in groups of kVec contiguous ones:
// column(g, e) = g * 16 * kVec + tx * kVec + e
template <int DPAD>
struct F32Cols {
  static constexpr int kLd = DPAD + 4;   // Q/K rows: float4-aligned,
                                         // conflict-free broadcast reads
  static constexpr int kCols = DPAD / 16;
  static constexpr int kVec = DPAD % 64 == 0 ? 4 : DPAD % 32 == 0 ? 2 : 1;
  static constexpr int kGroups = kCols / kVec;
};

template <int VEC>
__device__ __forceinline__ void load_vec(float* dst, const float* src) {
  if constexpr (VEC == 4) {
    const float4 t = *reinterpret_cast<const float4*>(src);
    dst[0] = t.x; dst[1] = t.y; dst[2] = t.z; dst[3] = t.w;
  } else if constexpr (VEC == 2) {
    const float2 t = *reinterpret_cast<const float2*>(src);
    dst[0] = t.x; dst[1] = t.y;
  } else {
    dst[0] = *src;
  }
}

template <int VEC>
__device__ __forceinline__ void store_vec(float* dst, const float* src,
                                          float mul) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(dst) =
        make_float4(src[0] * mul, src[1] * mul, src[2] * mul, src[3] * mul);
  } else if constexpr (VEC == 2) {
    *reinterpret_cast<float2*>(dst) = make_float2(src[0] * mul, src[1] * mul);
  } else {
    *dst = src[0] * mul;
  }
}

__device__ __forceinline__ float lanes16_max(float x) {
  #pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float lanes16_sum(float x) {
  #pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// ----------------------------------------------------------- bfloat16 path

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::
                   "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all_but_newest() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

}  // namespace
