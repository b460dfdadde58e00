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
// here the output is cut into tiles and x and w stream through shared
// memory over K. Any M and any K and N that are multiples of 8 (the 16-byte
// rule of vector loads and of a tensor map's strides) are taken: what lies
// past M, N or K loads as zeros and rows past M and columns past N are never
// stored, so no caller pads tokens.
//
//  * bfloat16: the tensor cores' full-rate path, wgmma fed by TMA. A
//    persistent grid (one block of three warpgroups per SM) walks 128 x 256
//    output tiles, N fastest, so that the tiles in flight share a few
//    128-row bands of x and all of w out of the 50 MB L2. One thread, the
//    loader (its warpgroup gives its registers away with setmaxnreg), keeps
//    a ring of three stages full: per stage one TMA box of x (128 rows x
//    64 k) and four of w (64 k x 64 columns each), written with the
//    128-byte swizzle and reported to the stage's "full" mbarrier. Each of
//    the two consumer warpgroups owns 64 rows of the tile: per stage four
//    wgmma m64n256k16 read x K-major and w MN-major (the transpose bit: w
//    stays [K, N], no transposed copy) straight from shared memory, one
//    group of them stays in flight while the stage before it is handed back
//    through its "empty" mbarrier, and the loader runs ahead into the next
//    tile during the epilogue. The epilogue never touches device memory from a
//    consumer thread (a tile stored from the accumulator fragments stalls the
//    consumers on eight partial rows a store): the loader also fetches the
//    residual's tile by TMA into a 64 KB buffer while the product runs; the
//    consumers read it there in the accumulator's fragment layout (the swizzle
//    makes that free of bank conflicts), apply bias, gamma and the residual in
//    float32 registers, write the rounded result back in place and arrive on a
//    third mbarrier; a second thread of the loader's warpgroup, the storer,
//    sends the tile off with a TMA store (which clips rows past M and columns
//    past N) and frees the buffer for the next residual once the store has
//    read it. So the consumers go straight on to the next tile's product while
//    the store drains.
//  * float32: 256 threads, each an 8 x 8 patch (two 4-row and two 4-column
//    groups, 64 apart), scalar FMAs on a cp.async double buffer, BK = 16:
//    exact to float32 (TF32 tensor cores keep ~3 digits and would miss a
//    2e-5 bar), bounded by the 67 TFLOP/s of the FP32 units.

#include "sm90.cuh"

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

constexpr int kWideTN = 256;             // output columns per tile: the widest
                                         // wgmma
constexpr int kBK = 64;                  // one 128-byte swizzled row of bf16
constexpr int kStages = 3;
constexpr int kGemmThreads = 384;        // two consumer warpgroups, then the
                                         // loader's and the storer's
constexpr int kXTile = kTM * kBK;        // elements per stage: 16 KB of x
constexpr int kBox = 64 * kTM;           // a 64-column box of 128 rows (or
                                         // 64 k), 16 KB
constexpr int kBoxes = kWideTN / 64;     // ... four of w, and of the residual
constexpr int kWTile = kBoxes * kBK * 64;
constexpr int kStageBytes = 2 * (kXTile + kWTile);
constexpr int kCTile = kBoxes * kBox;    // the residual / output tile, 64 KB
constexpr int kGemmSmemBytes = kStages * kStageBytes + 2 * kCTile +
                               (2 * kStages + 3) * 8 +
                               kSwizzleAtom;   // room to align the tiles

__global__ void __launch_bounds__(kGemmThreads, 1)
fused_epilogue_bf16(const __grid_constant__ CUtensorMap map_x,
                    const __grid_constant__ CUtensorMap map_w,
                    const __grid_constant__ CUtensorMap map_resid,
                    const __grid_constant__ CUtensorMap map_out,
                    const float* __restrict__ bias,
                    const float* __restrict__ gamma, int m, int k, int n) {
  extern __shared__ uint8_t smem_raw[];
  // the swizzle pattern is a function of the address: 1024-byte aligned tiles
  uint8_t* smem = smem_raw + ((kSwizzleAtom - smem_addr(smem_raw)) &
                              (kSwizzleAtom - 1));
  bf16* xs = reinterpret_cast<bf16*>(smem);
  bf16* ws = xs + kStages * kXTile;
  bf16* cs = ws + kStages * kWTile;   // residual in, output out
  uint64_t* full = reinterpret_cast<uint64_t*>(cs + kCTile);
  uint64_t* empty = full + kStages;
  uint64_t* c_full = empty + kStages;   // the residual's tile has landed
  uint64_t* c_ready = c_full + 1;       // ... has become the output tile
  uint64_t* c_empty = c_ready + 1;      // ... has been read by its store

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);    // the loader's arrive; TMA adds the bytes
      mbar_init(empty + s, 2);   // one thread of each consumer warpgroup
    }
    mbar_init(c_full, 1);
    mbar_init(c_ready, 256);     // every consumer thread
    mbar_init(c_empty, 1);       // the storer
    mbar_init_fence();
  }
  __syncthreads();

  const int n_tiles = (n + kWideTN - 1) / kWideTN;
  const int tiles = ((m + kTM - 1) / kTM) * n_tiles;
  const int k_tiles = (k + kBK - 1) / kBK;
  const int wg = threadIdx.x >> 7;

  if (wg == 2) {
    setmaxnreg_dec<40>();
    if (threadIdx.x == 2 * 128) {
      // -------------------------------------------------------------- loader
      tma_prefetch_map(&map_x);
      tma_prefetch_map(&map_w);
      tma_prefetch_map(&map_resid);
      // the residual follows the stages that the consumers can start on
      const int resid_at = k_tiles < kStages ? k_tiles - 1 : kStages - 1;
      int stage = 0;
      uint32_t phase = 0, c_phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile / n_tiles) * kTM;
        const int n0 = (tile % n_tiles) * kWideTN;
        for (int kt = 0; kt < k_tiles; ++kt) {
          mbar_wait(empty + stage, phase ^ 1);   // free from the start
          mbar_arrive_expect_tx(full + stage, kStageBytes);
          tma_load_2d(xs + stage * kXTile, &map_x, full + stage, kt * kBK, m0);
          #pragma unroll
          for (int c = 0; c < kBoxes; ++c)
            tma_load_2d(ws + stage * kWTile + c * kBK * 64, &map_w,
                        full + stage, n0 + 64 * c, kt * kBK);
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
          if (kt == resid_at) {
            mbar_wait(c_empty, c_phase ^ 1);   // the tile before has left
            mbar_arrive_expect_tx(c_full, 2 * kCTile);
            #pragma unroll
            for (int c = 0; c < kBoxes; ++c)
              tma_load_2d(cs + c * kBox, &map_resid, c_full, n0 + 64 * c, m0);
            c_phase ^= 1;
          }
        }
      }
    } else if (threadIdx.x == 2 * 128 + 32) {
      // -------------------------------------------------------------- storer
      tma_prefetch_map(&map_out);
      uint32_t c_phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile / n_tiles) * kTM;
        const int n0 = (tile % n_tiles) * kWideTN;
        mbar_wait(c_ready, c_phase);
        #pragma unroll
        for (int c = 0; c < kBoxes; ++c)
          tma_store_2d(&map_out, cs + c * kBox, n0 + 64 * c, m0);
        tma_store_commit();
        tma_store_wait_read();
        mbar_arrive(c_empty);
        c_phase ^= 1;
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    setmaxnreg_inc<232>();
    const int lane = threadIdx.x & 31;
    const int row_in_tile = wg * 64 + ((threadIdx.x >> 5) & 3) * 16 +
                            (lane >> 2);          // and 8 further down
    const int col_in_tile = 2 * (lane & 3);       // and +1, in each 8 columns
    const bool elected = (threadIdx.x & 127) == 0;
    int stage = 0;
    uint32_t phase = 0, c_phase = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int n0 = (tile % n_tiles) * kWideTN;

      float acc[kWideTN / 2];
      int prev = 0;
      for (int kt = 0; kt < k_tiles; ++kt) {
        mbar_wait(full + stage, phase);
        const uint64_t dx = wgmma_desc(xs + stage * kXTile + wg * 64 * kBK,
                                       16, kSwizzleAtom);
        const uint64_t dw = wgmma_desc(ws + stage * kWTile, 2 * kBK * 64,
                                       kSwizzleAtom);
        wgmma_fence();
        #pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk)
          wgmma_ss<1>(acc, wgmma_desc_advance(dx, kk * 32),
                      wgmma_desc_advance(dw, kk * 16 * kSwizzleRow),
                      (kt | kk) != 0);   // the tile's first one overwrites
        wgmma_commit();
        if (kt > 0) {   // the stage before this one has been read
          wgmma_wait<1>();
          if (elected) mbar_arrive(empty + prev);
        }
        prev = stage;
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      if (elected) mbar_arrive(empty + prev);
      wgmma_pin(acc);

      // Epilogue on the accumulator fragments: the residual is read from,
      // and the rounded result written back to, the tile in shared memory.
      // Row r of a 64-column box keeps its 16-byte chunk c at c ^ (r % 8)
      // (the 128-byte swizzle), so a warp's eight rows hit all 32 banks.
      mbar_wait(c_full, c_phase);
      c_phase ^= 1;
      #pragma unroll
      for (int j = 0; j < kWideTN / 8; ++j) {
        const int col = n0 + j * 8 + col_in_tile;   // n is even: col + 1 too
        float2 bv = make_float2(0.f, 0.f), gv = bv;
        if (col < n) {
          bv = *reinterpret_cast<const float2*>(bias + col);
          gv = *reinterpret_cast<const float2*>(gamma + col);
        }
        #pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = row_in_tile + r * 8;
          __nv_bfloat162* at = reinterpret_cast<__nv_bfloat162*>(
              cs + (j >> 3) * kBox + row * 64 + (((j & 7) ^ (row & 7)) << 3) +
              col_in_tile);
          const float2 rv = __bfloat1622float2(*at);
          *at = __floats2bfloat162_rn(
              rv.x + gv.x * (acc[4 * j + 2 * r] + bv.x),
              rv.y + gv.y * (acc[4 * j + 2 * r + 1] + bv.y));
        }
      }
      fence_proxy_async();   // these writes, before the TMA store reads them
      mbar_arrive(c_ready);
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
// 8. Returns the cudaError_t of the tensor-map encode or the launch (0 on
// success).
extern "C" int fused_epilogue(int dtype, const void* x, const void* w,
                              const void* bias, const void* gamma,
                              const void* resid, void* out, int m, int k,
                              int n, void* stream) {
  if (m < 1 || k < 8 || n < 8 || k % 8 != 0 || n % 8 != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int m_tiles = (m + kTM - 1) / kTM, n_tiles = (n + kTN - 1) / kTN;
  const float* b = static_cast<const float*>(bias);
  const float* g = static_cast<const float*>(gamma);
  if (dtype == 0) {
    fused_epilogue_f32<<<dim3(n_tiles, m_tiles), kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), b, g,
        static_cast<const float*>(resid), static_cast<float*>(out), m, k, n);
  } else if (dtype == 1) {
    // x as (k, m) boxes of 64 x 128, w as (n, k) boxes of 64 x 64, the
    // residual and the output as (n, m) boxes of 64 x 128
    CUtensorMap map_x, map_w, map_resid, map_out;
    const long long dims_x[2] = {k, m}, dims_w[2] = {n, k}, dims_c[2] = {n, m};
    const long long stride_x[1] = {k}, stride_n[1] = {n};
    const int box_x[2] = {kBK, kTM}, box_w[2] = {64, kBK}, box_c[2] = {64, kTM};
    if (!encode_tensor_map_bf16(&map_x, x, 2, dims_x, stride_x, box_x) ||
        !encode_tensor_map_bf16(&map_w, w, 2, dims_w, stride_n, box_w) ||
        !encode_tensor_map_bf16(&map_resid, resid, 2, dims_c, stride_n,
                                box_c) ||
        !encode_tensor_map_bf16(&map_out, out, 2, dims_c, stride_n, box_c))
      return (int)cudaErrorInvalidValue;
    int device = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   device);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(fused_epilogue_bf16,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kGemmSmemBytes);
    if (err != cudaSuccess) return (int)err;
    const int tiles = m_tiles * ((n + kWideTN - 1) / kWideTN);
    const int blocks = tiles < sms ? tiles : sms;   // persistent: one per SM
    fused_epilogue_bf16<<<blocks, kGemmThreads, kGemmSmemBytes, s>>>(
        map_x, map_w, map_resid, map_out, b, g, m, k, n);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
