// Flash-attention forward for NVIDIA Hopper (sm_90a), CUDA C++ by hand.
//
// Replaces the Pallas TPU kernel
//   amodal_depth_anything_tpu/ops/flash_attention.py::_attn_fwd_kernel
// and computes the same function: O = softmax(sm_scale * Q K^T) V over
// q [B, H, Nq, d] and k, v [B, H, Nk, d], with the softmax in float32 in the
// exp2 domain (log2(e) folded into the scale), keys at index >= kv_len
// excluded, an optional natural-log log-sum-exp per query row, and float32
// or bfloat16 operands. With bfloat16 operands P is rounded to bfloat16
// before P.V and the product accumulates in float32, as on the TPU; float32
// operands run in full float32.
//
// Head dims. The TPU kernel pads d to its 128 lanes; here both kernels are
// templates on a padded head dim DPAD, a multiple of 16 (the K step of
// mma.sync m16n8k16), instantiated at 16, 32, 48, 64, 80 and 160.
// A head dim d <= 160 (a multiple of 4 in float32, of 8 in bfloat16: the
// 16-byte vector loads) runs in the smallest DPAD >= d with the shared-
// memory columns from d to DPAD zero-filled, which changes no result: the
// DINOv2 trunks' 64, the SD-1.5 UNet's 40, 80 and 160 (as 48, 80, 160).
//
// Bound on this card: 4*B*H*Nq*kv_len*d operations against
// 2*B*H*(Nq+kv_len)*d elements moved. Self-attention on the main paths
// (N = 1370 at d = 64, N = 4096 at d = 40) is compute-bound by a wide
// margin; cross-attention onto 77 keys does 2*77 operations per q/o element
// and is memory-bound in bfloat16 (float32 is held to the 67 TFLOP/s of the
// FP32 units outside the tensor cores).
//
// Design. The TPU kernel keeps all of K/V resident in VMEM; at N = 5330 that
// is ~1.4 MB per head, far above the 227 KB of shared memory a block may
// use. Both kernels here follow the FlashAttention-2 schedule instead: one
// block per (batch, head, 64-row query tile) walks 64-row K/V tiles staged
// in shared memory and keeps an online softmax (running max and sum per
// row), the 64 x DPAD output accumulator in float32 registers, dividing by
// the sum once at the end. Query rows past Nq are never stored and key
// columns past kv_len are masked to -inf (their K/V rows load as zero), so
// no caller has to pad the sequence, and Nq and Nk are independent.
//
//  * bfloat16: 4 warps, 16 query rows each, on the tensor cores with
//    mma.sync m16n8k16 (bf16 in, f32 accumulate). Q stays in registers as
//    A fragments; K/V tiles arrive by cp.async into a double buffer, so the
//    next tile loads while this one computes; ldmatrix feeds K (and, with
//    .trans, V) as B fragments; the score accumulator of S = QK^T is reused
//    as the A fragment of P.V after rounding P to bf16. Shared memory is
//    dynamic: 640 * (DPAD + 8) bytes, 107.5 KB at DPAD = 160. mma.sync
//    reaches only part of Hopper's tensor-core rate (wgmma and TMA are
//    later work).
//  * float32: 256 threads, each 4 rows x 4 keys of the score tile and 4 rows
//    x DPAD/16 columns of the output tile, scalar FMAs on float32 smem
//    tiles: exact to float32 (TF32 tensor cores would lose the parity the
//    float32 path exists for), bounded by the 67 TFLOP/s of the FP32 units.
//
// Operands are addressed through (batch, head, token) strides with a unit
// stride on the head dim, so the q/k/v views of one fused qkv projection
// and an output laid out [B, N, H, D] need no copies.

#include "flash_attn_common.cuh"

namespace {

// ------------------------------------------------------------ float32 path

constexpr int kPLd = kBN + 4;   // padded rows of the 64 x 64 P tile

template <int DPAD>
struct F32Tile {
  static constexpr int kLd = DPAD + 4;   // Q and K rows: float4-aligned,
                                         // conflict-free broadcast reads
  // output columns per thread, in groups of kVec contiguous ones:
  // column(g, e) = g * 16 * kVec + tx * kVec + e
  static constexpr int kCols = DPAD / 16;
  static constexpr int kVec = DPAD % 64 == 0 ? 4 : DPAD % 32 == 0 ? 2 : 1;
  static constexpr int kGroups = kCols / kVec;
  static constexpr int kSmemBytes = 4 * (kBM * kLd      // Q (pre-scaled)
                                         + kBN * kLd    // K
                                         + kBN * DPAD   // V
                                         + kBM * kPLd); // P
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

template <int DPAD>
__global__ void __launch_bounds__(kF32Threads)
flash_attn_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, float* __restrict__ o,
                   float* __restrict__ lse, int nq, int kv_len, int d,
                   float scale_log2, Strides sq, Strides sk, Strides sv,
                   Strides so, long long lse_sb, long long lse_sh) {
  using T = F32Tile<DPAD>;
  constexpr int kLd = T::kLd, kCols = T::kCols, kVec = T::kVec;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + kBM * kLd;
  float* vs = ks + kBN * kLd;
  float* ps = vs + kBN * DPAD;

  const int tx = threadIdx.x & 15;   // score cols tx + 16j
  const int ty = threadIdx.x >> 4;   // rows 4ty + i
  const int q0 = blockIdx.x * kBM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;

  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  stage_tile_f32<DPAD>(qs, kLd, q + b * sq.b + h * sq.h, sq.n, q0, nq,
                       scale_log2, d);

  float m[4], l[4], acc[4][kCols];
  #pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
    #pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < kv_len; k0 += kBN) {
    __syncthreads();  // the previous tile's P.V is done with ks/vs/ps
    stage_tile_f32<DPAD>(ks, kLd, kb, sk.n, k0, kv_len, 1.f, d);
    stage_tile_f32<DPAD>(vs, DPAD, vb, sv.n, k0, kv_len, 1.f, d);
    __syncthreads();

    // S = (scale * log2e * Q) K^T for rows 4ty+i, cols tx+16j
    float s[4][4];
    #pragma unroll
    for (int i = 0; i < 4; ++i)
      #pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    #pragma unroll 4
    for (int c = 0; c < DPAD; c += 4) {
      float4 qv[4], kv[4];
      #pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(qs + (ty * 4 + i) * kLd + c);
      #pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(ks + (tx + 16 * j) * kLd + c);
      #pragma unroll
      for (int i = 0; i < 4; ++i)
        #pragma unroll
        for (int j = 0; j < 4; ++j)
          s[i][j] += qv[i].x * kv[j].x + qv[i].y * kv[j].y +
                     qv[i].z * kv[j].z + qv[i].w * kv[j].w;
    }

    // online softmax; every tile holds at least one key < kv_len, so the
    // new running max is finite
    #pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
      #pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (k0 + tx + 16 * j >= kv_len) s[i][j] = -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], lanes16_max(mx));
      const float alpha = exp2f(m[i] - m_new);
      float rs = 0.f;
      #pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = exp2f(s[i][j] - m_new);
        rs += p;
        ps[(ty * 4 + i) * kPLd + tx + 16 * j] = p;
      }
      l[i] = l[i] * alpha + lanes16_sum(rs);
      m[i] = m_new;
      #pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    // acc += P V for rows 4ty+i and this thread's output columns
    #pragma unroll 2
    for (int kk = 0; kk < kBN; kk += 4) {
      float4 pv[4];
      #pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(ps + (ty * 4 + i) * kPLd + kk);
      #pragma unroll
      for (int u = 0; u < 4; ++u) {
        float vv[kCols];
        #pragma unroll
        for (int g = 0; g < T::kGroups; ++g)
          load_vec<kVec>(vv + g * kVec, vs + (kk + u) * DPAD + g * 16 * kVec +
                                            tx * kVec);
        #pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = u == 0 ? pv[i].x : u == 1 ? pv[i].y : u == 2 ? pv[i].z : pv[i].w;
          #pragma unroll
          for (int j = 0; j < kCols; ++j) acc[i][j] += p * vv[j];
        }
      }
    }
  }

  float* ob = o + b * so.b + h * so.h;
  #pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= nq) continue;
    const float inv = 1.f / l[i];
    #pragma unroll
    for (int g = 0; g < T::kGroups; ++g) {
      const int col = g * 16 * kVec + tx * kVec;   // d is a multiple of 4
      if (col < d)
        store_vec<kVec>(ob + (long long)row * so.n + col, acc[i] + g * kVec,
                        inv);
    }
    if (lse != nullptr && tx == 0)
      lse[b * lse_sb + h * lse_sh + row] = m[i] * kLn2 + logf(l[i]);
  }
}

// ----------------------------------------------------------- bfloat16 path

template <int DPAD>
constexpr int kBf16SmemBytes = 2 * (kBM + 4 * kBN) * (DPAD + 8);  // Q, 2 K, 2 V

template <int DPAD>
__global__ void __launch_bounds__(kBf16Threads)
flash_attn_fwd_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ o,
                    float* __restrict__ lse, int nq, int kv_len, int d,
                    float scale_log2, Strides sq, Strides sk, Strides sv,
                    Strides so, long long lse_sb, long long lse_sh) {
  constexpr int kLd = DPAD + 8;     // 16-byte chunks per row odd: ldmatrix
                                    // reads 8 rows without bank conflicts
  constexpr int kSteps = DPAD / 16; // k steps of Q K^T
  constexpr int kDTiles = DPAD / 8; // 8-wide column tiles of the output
  extern __shared__ float4 smem4[];
  bf16* qs = reinterpret_cast<bf16*>(smem4);
  bf16* ks = qs + kBM * kLd;        // two K tiles, then two V tiles
  bf16* vs = ks + 2 * kBN * kLd;
  constexpr int kTile = kBN * kLd;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * kBM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const bf16* kb = k + b * sk.b + h * sk.h;
  const bf16* vb = v + b * sv.b + h * sv.h;

  load_tile_bf16<DPAD>(qs, q + b * sq.b + h * sq.h, sq.n, q0, nq, d);
  load_tile_bf16<DPAD>(ks, kb, sk.n, 0, kv_len, d);
  load_tile_bf16<DPAD>(vs, vb, sv.n, 0, kv_len, d);
  cp_async_commit();

  // per thread: rows g = lane/4 and g + 8 of the warp's 16; in each 8-wide
  // column tile, columns 2*(lane%4) and +1 (the mma C-fragment layout)
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float acc[kDTiles][4];
  #pragma unroll
  for (int j = 0; j < kDTiles; ++j)
    #pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  uint32_t qf[kSteps][4];  // Q as A fragments, one per 16-wide k step

  const int n_tiles = (kv_len + kBN - 1) / kBN;
  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < n_tiles) {  // prefetch the next tile into the other buffer
      load_tile_bf16<DPAD>(ks + (buf ^ 1) * kTile, kb, sk.n, (t + 1) * kBN,
                           kv_len, d);
      load_tile_bf16<DPAD>(vs + (buf ^ 1) * kTile, vb, sv.n, (t + 1) * kBN,
                           kv_len, d);
    }
    cp_async_commit();
    cp_async_wait_all_but_newest();  // tile t (and Q) have landed
    __syncthreads();
    if (t == 0) {
      #pragma unroll
      for (int kk = 0; kk < kSteps; ++kk)
        ldmatrix_x4(qf[kk], qs + (warp * 16 + (lane & 15)) * kLd + kk * 16 +
                                (lane >> 4) * 8);
    }

    // S = Q K^T: 16 rows x 64 keys per warp
    float s[8][4];
    #pragma unroll
    for (int j = 0; j < 8; ++j)
      #pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    #pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      #pragma unroll
      for (int j = 0; j < 8; j += 2) {
        uint32_t kf[4];  // B fragments of key tiles j and j + 1 at step kk
        ldmatrix_x4(kf, ks + buf * kTile +
                            ((j + (lane >> 4)) * 8 + (lane & 7)) * kLd +
                            kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[j], qf[kk], kf[0], kf[1]);
        mma_bf16(s[j + 1], qf[kk], kf[2], kf[3]);
      }
    }

    // online softmax in the exp2 domain; keys >= kv_len -> -inf
    const int col0 = t * kBN + 2 * (lane & 3);
    float mx[2] = {-INFINITY, -INFINITY};
    #pragma unroll
    for (int j = 0; j < 8; ++j)
      #pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale_log2;
        if (col0 + j * 8 + (e & 1) >= kv_len) x = -INFINITY;
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2];
    #pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);  // finite: a key < kv_len
      alpha[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];  // this thread's share of the row sum
    }
    #pragma unroll
    for (int j = 0; j < 8; ++j)
      #pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[j][e] - m[e >> 1]);
        s[j][e] = p;
        l[e >> 1] += p;
      }
    #pragma unroll
    for (int j = 0; j < kDTiles; ++j)
      #pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] *= alpha[e >> 1];

    // acc += P V; P's C fragments of two column tiles form one A fragment
    #pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t pf[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      #pragma unroll
      for (int jd = 0; jd < kDTiles; jd += 2) {
        uint32_t vf[4];  // B fragments of d tiles jd and jd + 1
        ldmatrix_x4_trans(vf, vs + buf * kTile +
                                  (kk * 16 + (lane & 7) +
                                   ((lane >> 3) & 1) * 8) * kLd +
                                  jd * 8 + (lane >> 4) * 8);
        mma_bf16(acc[jd], pf, vf[0], vf[1]);
        mma_bf16(acc[jd + 1], pf, vf[2], vf[3]);
      }
    }
    __syncthreads();  // every warp is done with buffer `buf`
  }

  bf16* ob = o + b * so.b + h * so.h;
  #pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = q0 + warp * 16 + (lane >> 2) + r * 8;
    if (row >= nq) continue;
    const float inv = 1.f / l[r];
    #pragma unroll
    for (int j = 0; j < kDTiles; ++j) {
      const int col = j * 8 + 2 * (lane & 3);   // d is a multiple of 8
      if (col < d)
        *reinterpret_cast<__nv_bfloat162*>(ob + (long long)row * so.n + col) =
            __floats2bfloat162_rn(acc[j][2 * r] * inv, acc[j][2 * r + 1] * inv);
    }
    if (lse != nullptr && (lane & 3) == 0)
      lse[b * lse_sb + h * lse_sh + row] = m[r] * kLn2 + logf(l[r]);
  }
}

struct Args {
  const void *q, *k, *v;
  void *o;
  float* lse;
  int nq, kv_len, d;
  float scale_log2;
  Strides sq, sk, sv, so;
  long long lse_sb, lse_sh;
};

// above 48 KB of dynamic shared memory only after opting in (per device)
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int DPAD>
cudaError_t launch(int dtype, const Args& a, dim3 grid, cudaStream_t s) {
  if (dtype == 0) {
    constexpr int smem = F32Tile<DPAD>::kSmemBytes;
    const cudaError_t err = allow_smem(flash_attn_fwd_f32<DPAD>, smem);
    if (err != cudaSuccess) return err;
    flash_attn_fwd_f32<DPAD><<<grid, kF32Threads, smem, s>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<float*>(a.o), a.lse,
        a.nq, a.kv_len, a.d, a.scale_log2, a.sq, a.sk, a.sv, a.so, a.lse_sb,
        a.lse_sh);
  } else {
    constexpr int smem = kBf16SmemBytes<DPAD>;
    const cudaError_t err = allow_smem(flash_attn_fwd_bf16<DPAD>, smem);
    if (err != cudaSuccess) return err;
    flash_attn_fwd_bf16<DPAD><<<grid, kBf16Threads, smem, s>>>(
        static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
        static_cast<const bf16*>(a.v), static_cast<bf16*>(a.o), a.lse, a.nq,
        a.kv_len, a.d, a.scale_log2, a.sq, a.sk, a.sv, a.so, a.lse_sb,
        a.lse_sh);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. d: the head dim, <= 160 and a multiple
// of 4 (float32) or 8 (bfloat16). strides: 12 values, (batch, head, token)
// for q, k, v, o in elements (the head dim is contiguous). lse: float32
// [.., Nq] addressed by (lse_sb, lse_sh, 1), or null. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int flash_attn_fwd(int dtype, const void* q, const void* k,
                              const void* v, void* o, void* lse, int batch,
                              int heads, int nq, int kv_len, int d,
                              float sm_scale, const long long* st,
                              long long lse_sb, long long lse_sh,
                              void* stream) {
  if ((dtype != 0 && dtype != 1) || d < 1 || d > 160 ||
      d % (dtype == 0 ? 4 : 8) != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((nq + kBM - 1) / kBM, heads, batch);
  const Args a{q, k, v, o, static_cast<float*>(lse), nq, kv_len, d,
               sm_scale * kLog2e,
               Strides{st[0], st[1], st[2]}, Strides{st[3], st[4], st[5]},
               Strides{st[6], st[7], st[8]}, Strides{st[9], st[10], st[11]},
               lse_sb, lse_sh};
  if (d <= 16) return (int)launch<16>(dtype, a, grid, s);
  if (d <= 32) return (int)launch<32>(dtype, a, grid, s);
  if (d <= 48) return (int)launch<48>(dtype, a, grid, s);
  if (d <= 64) return (int)launch<64>(dtype, a, grid, s);
  if (d <= 80) return (int)launch<80>(dtype, a, grid, s);
  return (int)launch<160>(dtype, a, grid, s);
}
