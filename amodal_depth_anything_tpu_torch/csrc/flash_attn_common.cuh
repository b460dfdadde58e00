// Shared device helpers of the flash-attention kernels (forward and backward)
// for NVIDIA Hopper (sm_90a): tile sizes, strided addressing, cp.async staging,
// ldmatrix / mma.sync (bf16 in, f32 accumulate) wrappers and the float32
// tile loader. Included by flash_attn_fwd.cu and flash_attn_bwd.cu.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kD = 64;          // head dim of the backward kernels; the
                                // forward is templated on a padded head dim
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
constexpr int kF32Ld = kD + 4;       // padded smem rows: float4-aligned,
                                     // conflict-free broadcast reads

// Stage rows [row0, row0 + 64) of one (b, h) slice into smem (row stride
// `ld` floats, DPAD columns), times `mul`, zero-filling rows at or past
// `rows` and the columns from the head dim `d` (a multiple of 4) to DPAD.
template <int DPAD = kD>
__device__ __forceinline__ void stage_tile_f32(float* dst, int ld,
                                               const float* src,
                                               long long row_stride, int row0,
                                               int rows, float mul,
                                               int d = DPAD) {
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
constexpr int kBf16Threads = 128;    // 4 warps x 16 query rows
constexpr int kBf16Ld = kD + 8;      // 144-byte smem rows: ldmatrix reads
                                     // 8 rows without bank conflicts

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

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4],
                                                  const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a (16x16, row-major) * b (16x8, col-major); bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Start the cp.async copies of rows [row0, row0 + 64) of one (b, h) slice
// into a [64][DPAD + 8] smem tile, zero-filling rows at or past `rows` and
// the columns from the head dim `d` (a multiple of 8) to DPAD.
template <int DPAD = kD>
__device__ __forceinline__ void load_tile_bf16(bf16* dst, const bf16* src,
                                               long long row_stride, int row0,
                                               int rows, int d = DPAD) {
  for (int i = threadIdx.x; i < 64 * (DPAD / 8); i += kBf16Threads) {
    const int r = i / (DPAD / 8);
    const int c = (i % (DPAD / 8)) * 8;
    const bool valid = row0 + r < rows && c < d;
    cp_async16(dst + r * (DPAD + 8) + c,
               valid ? src + (long long)(row0 + r) * row_stride + c : src,
               valid);
  }
}

}  // namespace
