// Fused matmul + LayerScale + residual for NVIDIA Hopper (sm_90a), CUDA C++
// by hand.
//
// Replaces the Pallas TPU kernel
//   amodal_depth_anything_tpu/ops/fused_epilogue.py::_kernel
// and computes the same function in one pass:
//   out = resid + gamma * (x @ w + b)
// with x [M, K], w [K, N], resid and out [M, N] in float32 or bfloat16 and
// b, gamma [N] in float32; the product accumulates in float32, bias, gamma
// and the residual are applied to the accumulator in float32 registers, and
// the result is rounded once, to x's dtype. The product's [M, N] result never
// reaches device memory.
//
// Bound on this card: 2*M*K*N operations against (M*K + K*N + 2*M*N)
// elements moved. At the trunks' shapes (M = 5480 .. 42640, K and N in 1024
// .. 4096) that is 300-700 operations per byte in bfloat16: compute-bound,
// about 0.2 ms at [42640, 1536] x [1536, 1536] on 989 TFLOP/s; what the
// fusion saves is the write and two reads of the [M, N] product that a
// separate epilogue pass would add, not the product itself.
//
// Design. The TPU kernel keeps all of W resident in VMEM (up to 9.4 MB) and
// walks M in 256-row blocks; a Hopper block has 227 KB of shared memory, so
// here the grid tiles both M and N (128 x 128 outputs per block of 256
// threads) and every block streams 128 x BK tiles of x and BK x 128 tiles of
// w over K through a cp.async double buffer, so the next pair of tiles loads
// while this one computes. W is re-read by every row of blocks, out of the
// 50 MB L2. Any M, K and N that are multiples of 8 (16-byte vector loads)
// are taken: rows past M, columns past N and the tail of K load as zeros and
// are never stored, so no caller pads tokens.
//
//  * bfloat16: 8 warps as 4 (M) x 2 (N), each a 32 x 64 patch as 2 x 8
//    mma.sync m16n8k16 tiles (bf16 in, f32 accumulate), BK = 32. ldmatrix
//    feeds x as A fragments and, with .trans, the row-major w tile as B
//    fragments. mma.sync reaches only part of Hopper's tensor-core rate
//    (wgmma and TMA are later work).
//  * float32: each thread an 8 x 8 patch (two 4-row and two 4-column
//    groups, 64 apart), scalar FMAs, BK = 16: exact to float32 (TF32 tensor
//    cores keep ~3 digits and would miss a 2e-5 bar), bounded by the
//    67 TFLOP/s of the FP32 units.

#include "flash_attn_common.cuh"

namespace {

constexpr int kTM = 128;        // output rows per block
constexpr int kTN = 128;        // output columns per block
constexpr int kThreads = 256;

// Start the cp.async copies of a [ROWS][COLS] tile (row stride `ld` elements
// in smem) whose top-left element is src[row0][col0]; elements at rows >=
// `rows` or columns >= `cols` (a multiple of the 16-byte vector) load as 0.
template <typename T, int ROWS, int COLS>
__device__ __forceinline__ void load_tile(T* dst, int ld, const T* src,
                                          long long row_stride, int row0,
                                          int rows, int col0, int cols) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = COLS / kVec;
  for (int i = threadIdx.x; i < ROWS * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * kVec;
    const bool valid = row0 + r < rows && col0 + c < cols;
    cp_async16(dst + r * ld + c,
               valid ? src + (long long)(row0 + r) * row_stride + col0 + c
                     : src,
               valid);
  }
}

// ----------------------------------------------------------- bfloat16 path

constexpr int kBkBf16 = 32;
constexpr int kLdA = kBkBf16 + 8;   // 80-byte rows: 16-byte chunks per row
constexpr int kLdB = kTN + 8;       // odd, so ldmatrix has no bank conflicts

__global__ void __launch_bounds__(kThreads)
fused_epilogue_bf16(const bf16* __restrict__ x, const bf16* __restrict__ w,
                    const float* __restrict__ bias,
                    const float* __restrict__ gamma,
                    const bf16* __restrict__ resid, bf16* __restrict__ out,
                    int m, int k, int n) {
  __shared__ __align__(16) bf16 as[2][kTM * kLdA];
  __shared__ __align__(16) bf16 bs[2][kBkBf16 * kLdB];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wm = (warp & 3) * 32;   // the warp's rows in the block tile
  const int wn = (warp >> 2) * 64;  // ... and its columns
  const int m0 = blockIdx.y * kTM;
  const int n0 = blockIdx.x * kTN;

  float acc[2][8][4];
  #pragma unroll
  for (int i = 0; i < 2; ++i)
    #pragma unroll
    for (int j = 0; j < 8; ++j)
      #pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  load_tile<bf16, kTM, kBkBf16>(as[0], kLdA, x, k, m0, m, 0, k);
  load_tile<bf16, kBkBf16, kTN>(bs[0], kLdB, w, n, 0, k, n0, n);
  cp_async_commit();

  const int n_tiles = (k + kBkBf16 - 1) / kBkBf16;
  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < n_tiles) {  // prefetch the next pair into the other buffer
      const int k0 = (t + 1) * kBkBf16;
      load_tile<bf16, kTM, kBkBf16>(as[buf ^ 1], kLdA, x, k, m0, m, k0, k);
      load_tile<bf16, kBkBf16, kTN>(bs[buf ^ 1], kLdB, w, n, k0, k, n0, n);
    }
    cp_async_commit();
    cp_async_wait_all_but_newest();  // tile pair t has landed
    __syncthreads();

    #pragma unroll
    for (int kk = 0; kk < kBkBf16 / 16; ++kk) {
      uint32_t af[2][4];
      #pragma unroll
      for (int i = 0; i < 2; ++i)
        ldmatrix_x4(af[i], as[buf] + (wm + i * 16 + (lane & 15)) * kLdA +
                               kk * 16 + (lane >> 4) * 8);
      #pragma unroll
      for (int j = 0; j < 8; j += 2) {
        uint32_t bf[4];  // B fragments of column tiles j and j + 1
        ldmatrix_x4_trans(bf, bs[buf] + (kk * 16 + (lane & 7) +
                                         ((lane >> 3) & 1) * 8) * kLdB +
                                  wn + j * 8 + (lane >> 4) * 8);
        #pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma_bf16(acc[i][j], af[i], bf[0], bf[1]);
          mma_bf16(acc[i][j + 1], af[i], bf[2], bf[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with buffer `buf`
  }

  // epilogue on the accumulator: rows g = lane/4 and g + 8 of each 16-row
  // tile, columns 2*(lane%4) and +1 of each 8-wide tile (the C fragment)
  #pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = n0 + wn + j * 8 + 2 * (lane & 3);
    if (col >= n) continue;   // n is even: col + 1 < n as well
    const float2 bv = *reinterpret_cast<const float2*>(bias + col);
    const float2 gv = *reinterpret_cast<const float2*>(gamma + col);
    #pragma unroll
    for (int i = 0; i < 2; ++i)
      #pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = m0 + wm + i * 16 + (lane >> 2) + r * 8;
        if (row >= m) continue;
        const long long at = (long long)row * n + col;
        const float2 rv = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(resid + at));
        *reinterpret_cast<__nv_bfloat162*>(out + at) = __floats2bfloat162_rn(
            rv.x + gv.x * (acc[i][j][2 * r] + bv.x),
            rv.y + gv.y * (acc[i][j][2 * r + 1] + bv.y));
      }
  }
}

// ------------------------------------------------------------ float32 path

constexpr int kBkF32 = 16;
constexpr int kLdAF32 = kBkF32 + 4;   // float4-aligned rows; the two rows a
                                      // warp reads at once sit 16 banks apart

__global__ void __launch_bounds__(kThreads)
fused_epilogue_f32(const float* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ bias,
                   const float* __restrict__ gamma,
                   const float* __restrict__ resid, float* __restrict__ out,
                   int m, int k, int n) {
  __shared__ __align__(16) float as[2][kTM * kLdAF32];
  __shared__ __align__(16) float bs[2][kBkF32 * kTN];

  const int tx = threadIdx.x & 15;   // columns 4tx + j and 64 + 4tx + j
  const int ty = threadIdx.x >> 4;   // rows 4ty + i and 64 + 4ty + i
  const int m0 = blockIdx.y * kTM;
  const int n0 = blockIdx.x * kTN;

  float acc[8][8];
  #pragma unroll
  for (int i = 0; i < 8; ++i)
    #pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  load_tile<float, kTM, kBkF32>(as[0], kLdAF32, x, k, m0, m, 0, k);
  load_tile<float, kBkF32, kTN>(bs[0], kTN, w, n, 0, k, n0, n);
  cp_async_commit();

  const int n_tiles = (k + kBkF32 - 1) / kBkF32;
  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < n_tiles) {
      const int k0 = (t + 1) * kBkF32;
      load_tile<float, kTM, kBkF32>(as[buf ^ 1], kLdAF32, x, k, m0, m, k0, k);
      load_tile<float, kBkF32, kTN>(bs[buf ^ 1], kTN, w, n, k0, k, n0, n);
    }
    cp_async_commit();
    cp_async_wait_all_but_newest();
    __syncthreads();

    #pragma unroll
    for (int kk = 0; kk < kBkF32; kk += 4) {
      float4 av[8];
      #pragma unroll
      for (int i = 0; i < 8; ++i)
        av[i] = *reinterpret_cast<const float4*>(
            as[buf] + ((i >> 2) * 64 + ty * 4 + (i & 3)) * kLdAF32 + kk);
      #pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float4 b0 = *reinterpret_cast<const float4*>(
            bs[buf] + (kk + u) * kTN + tx * 4);
        const float4 b1 = *reinterpret_cast<const float4*>(
            bs[buf] + (kk + u) * kTN + 64 + tx * 4);
        #pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float a = u == 0 ? av[i].x : u == 1 ? av[i].y : u == 2 ? av[i].z : av[i].w;
          acc[i][0] += a * b0.x; acc[i][1] += a * b0.y;
          acc[i][2] += a * b0.z; acc[i][3] += a * b0.w;
          acc[i][4] += a * b1.x; acc[i][5] += a * b1.y;
          acc[i][6] += a * b1.z; acc[i][7] += a * b1.w;
        }
      }
    }
    __syncthreads();
  }

  #pragma unroll
  for (int jg = 0; jg < 2; ++jg) {
    const int col = n0 + jg * 64 + tx * 4;
    if (col >= n) continue;   // n is a multiple of 4: the whole vector is in
    const float4 bv = *reinterpret_cast<const float4*>(bias + col);
    const float4 gv = *reinterpret_cast<const float4*>(gamma + col);
    #pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = m0 + (i >> 2) * 64 + ty * 4 + (i & 3);
      if (row >= m) continue;
      const long long at = (long long)row * n + col;
      const float4 rv = *reinterpret_cast<const float4*>(resid + at);
      const float* a = acc[i] + jg * 4;
      *reinterpret_cast<float4*>(out + at) =
          make_float4(rv.x + gv.x * (a[0] + bv.x), rv.y + gv.y * (a[1] + bv.y),
                      rv.z + gv.z * (a[2] + bv.z), rv.w + gv.w * (a[3] + bv.w));
    }
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, w, resid, out); bias and gamma are
// float32. All tensors contiguous and 16-byte aligned; k and n multiples of
// 8. Returns the cudaError_t of the launch (0 on success).
extern "C" int fused_epilogue(int dtype, const void* x, const void* w,
                              const void* bias, const void* gamma,
                              const void* resid, void* out, int m, int k,
                              int n, void* stream) {
  if (m < 1 || k < 8 || n < 8 || k % 8 != 0 || n % 8 != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((n + kTN - 1) / kTN, (m + kTM - 1) / kTM);
  const float* b = static_cast<const float*>(bias);
  const float* g = static_cast<const float*>(gamma);
  if (dtype == 0) {
    fused_epilogue_f32<<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), b, g,
        static_cast<const float*>(resid), static_cast<float*>(out), m, k, n);
  } else if (dtype == 1) {
    fused_epilogue_bf16<<<grid, kThreads, 0, s>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w), b, g,
        static_cast<const bf16*>(resid), static_cast<bf16*>(out), m, k, n);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
