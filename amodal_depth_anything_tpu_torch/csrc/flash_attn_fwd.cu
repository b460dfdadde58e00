// Flash-attention forward for NVIDIA Hopper (sm_90a), CUDA C++ by hand.
//
// Replaces the Pallas TPU kernel
//   amodal_depth_anything_tpu/ops/flash_attention.py::_attn_fwd_kernel
// and computes the same function: O = softmax(sm_scale * Q K^T) V over
// [B, H, N, 64] operands, with the softmax in float32 in the exp2 domain
// (log2(e) folded into the scale), keys at index >= kv_len excluded, an
// optional natural-log log-sum-exp per query row, and float32 or bfloat16
// operands. With bfloat16 operands P is rounded to bfloat16 before P.V and
// the product accumulates in float32, as on the TPU; float32 operands run
// in full float32.
//
// Bound on this card: 4*B*H*Nq*kv_len*64 operations against 2*B*H*(Nq+Nk)*64
// elements moved, i.e. ~340 operations per byte at N = 1370 in bfloat16 --
// compute-bound wherever the main path calls it (about 11.7 us per vitg
// launch at 518 px, B = 1, on 989 TFLOP/s of bf16 tensor cores; float32 is
// held to the 67 TFLOP/s of the FP32 units outside the tensor cores).
//
// Design. The TPU kernel keeps all of K/V resident in VMEM; at N = 5330 that
// is ~1.4 MB per head, far above the 227 KB of shared memory a block may
// use. Both kernels here follow the FlashAttention-2 schedule instead: one
// block per (batch, head, 64-row query tile) walks 64-row K/V tiles staged
// in shared memory and keeps an online softmax (running max and sum per
// row), the 64x64 output accumulator in float32 registers, dividing by the
// sum once at the end. Query rows past Nq are never stored and key columns
// past kv_len are masked to -inf (their K/V rows load as zero), so no
// caller has to pad the sequence.
//
//  * bfloat16: 4 warps, 16 query rows each, on the tensor cores with
//    mma.sync m16n8k16 (bf16 in, f32 accumulate). Q stays in registers as
//    A fragments; K/V tiles arrive by cp.async into a double buffer, so the
//    next tile loads while this one computes; ldmatrix feeds K (and, with
//    .trans, V) as B fragments; the score accumulator of S = QK^T is reused
//    as the A fragment of P.V after rounding P to bf16. mma.sync reaches only
//    part of Hopper's tensor-core rate (wgmma and TMA are later work).
//  * float32: 256 threads, each a 4x4 patch of the score and output tiles,
//    scalar FMAs on float32 smem tiles: exact to float32 (TF32 tensor cores
//    would lose the parity the float32 path exists for), bounded by the
//    67 TFLOP/s of the FP32 units.
//
// Operands are addressed through (batch, head, token) strides with a unit
// stride on the head dim, so the q/k/v views of one fused qkv projection
// and an output laid out [B, N, H, D] need no copies.

#include "flash_attn_common.cuh"

namespace {

// ------------------------------------------------------------ float32 path

constexpr int kF32SmemBytes = 4 * (kBM * kF32Ld      // Q (pre-scaled)
                                   + kBN * kF32Ld    // K
                                   + kBN * kD        // V
                                   + kBM * kF32Ld);  // P


__global__ void __launch_bounds__(kF32Threads)
flash_attn_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, float* __restrict__ o,
                   float* __restrict__ lse, int nq, int kv_len,
                   float scale_log2, Strides sq, Strides sk, Strides sv,
                   Strides so, long long lse_sb, long long lse_sh) {
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + kBM * kF32Ld;
  float* vs = ks + kBN * kF32Ld;
  float* ps = vs + kBN * kD;

  const int tx = threadIdx.x & 15;   // score cols tx + 16j; output cols 4tx + j
  const int ty = threadIdx.x >> 4;   // rows 4ty + i
  const int q0 = blockIdx.x * kBM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;

  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  stage_tile_f32(qs, kF32Ld, q + b * sq.b + h * sq.h, sq.n, q0, nq,
                 scale_log2);

  float m[4], l[4], acc[4][4];
  #pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
    #pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < kv_len; k0 += kBN) {
    __syncthreads();  // the previous tile's P.V is done with ks/vs/ps
    stage_tile_f32(ks, kF32Ld, kb, sk.n, k0, kv_len, 1.f);
    stage_tile_f32(vs, kD, vb, sv.n, k0, kv_len, 1.f);
    __syncthreads();

    // S = (scale * log2e * Q) K^T for rows 4ty+i, cols tx+16j
    float s[4][4];
    #pragma unroll
    for (int i = 0; i < 4; ++i)
      #pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    #pragma unroll 4
    for (int d = 0; d < kD; d += 4) {
      float4 qv[4], kv[4];
      #pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(qs + (ty * 4 + i) * kF32Ld + d);
      #pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(ks + (tx + 16 * j) * kF32Ld + d);
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
        ps[(ty * 4 + i) * kF32Ld + tx + 16 * j] = p;
      }
      l[i] = l[i] * alpha + lanes16_sum(rs);
      m[i] = m_new;
      #pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    // acc += P V for rows 4ty+i, cols 4tx+j
    #pragma unroll 2
    for (int kk = 0; kk < kBN; kk += 4) {
      float4 pv[4];
      #pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(ps + (ty * 4 + i) * kF32Ld + kk);
      #pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float4 vv = *reinterpret_cast<const float4*>(vs + (kk + u) * kD + tx * 4);
        #pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = u == 0 ? pv[i].x : u == 1 ? pv[i].y : u == 2 ? pv[i].z : pv[i].w;
          acc[i][0] += p * vv.x;
          acc[i][1] += p * vv.y;
          acc[i][2] += p * vv.z;
          acc[i][3] += p * vv.w;
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
    *reinterpret_cast<float4*>(ob + (long long)row * so.n + tx * 4) =
        make_float4(acc[i][0] * inv, acc[i][1] * inv, acc[i][2] * inv,
                    acc[i][3] * inv);
    if (lse != nullptr && tx == 0)
      lse[b * lse_sb + h * lse_sh + row] = m[i] * kLn2 + logf(l[i]);
  }
}

// ----------------------------------------------------------- bfloat16 path


__global__ void __launch_bounds__(kBf16Threads)
flash_attn_fwd_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ o,
                    float* __restrict__ lse, int nq, int kv_len,
                    float scale_log2, Strides sq, Strides sk, Strides sv,
                    Strides so, long long lse_sb, long long lse_sh) {
  __shared__ __align__(16) bf16 qs[kBM * kBf16Ld];
  __shared__ __align__(16) bf16 ks[2][kBN * kBf16Ld];
  __shared__ __align__(16) bf16 vs[2][kBN * kBf16Ld];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * kBM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const bf16* kb = k + b * sk.b + h * sk.h;
  const bf16* vb = v + b * sv.b + h * sv.h;

  load_tile_bf16(qs, q + b * sq.b + h * sq.h, sq.n, q0, nq);
  load_tile_bf16(ks[0], kb, sk.n, 0, kv_len);
  load_tile_bf16(vs[0], vb, sv.n, 0, kv_len);
  cp_async_commit();

  // per thread: rows g = lane/4 and g + 8 of the warp's 16; in each 8-wide
  // column tile, columns 2*(lane%4) and +1 (the mma C-fragment layout)
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float acc[8][4];
  #pragma unroll
  for (int j = 0; j < 8; ++j)
    #pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  uint32_t qf[4][4];  // Q as A fragments, one per 16-wide k step

  const int n_tiles = (kv_len + kBN - 1) / kBN;
  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < n_tiles) {  // prefetch the next tile into the other buffer
      load_tile_bf16(ks[buf ^ 1], kb, sk.n, (t + 1) * kBN, kv_len);
      load_tile_bf16(vs[buf ^ 1], vb, sv.n, (t + 1) * kBN, kv_len);
    }
    cp_async_commit();
    cp_async_wait_all_but_newest();  // tile t (and Q) have landed
    __syncthreads();
    if (t == 0) {
      #pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        ldmatrix_x4(qf[kk], qs + (warp * 16 + (lane & 15)) * kBf16Ld +
                                kk * 16 + (lane >> 4) * 8);
    }

    // S = Q K^T: 16 rows x 64 keys per warp
    float s[8][4];
    #pragma unroll
    for (int j = 0; j < 8; ++j) {
      #pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
      #pragma unroll
      for (int kk = 0; kk < 4; kk += 2) {
        uint32_t kf[4];  // B fragments of k steps kk and kk + 1
        ldmatrix_x4(kf, ks[buf] + (j * 8 + (lane & 7)) * kBf16Ld + kk * 16 +
                            (lane >> 3) * 8);
        mma_bf16(s[j], qf[kk], kf[0], kf[1]);
        mma_bf16(s[j], qf[kk + 1], kf[2], kf[3]);
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
        acc[j][e] *= alpha[e >> 1];
      }

    // acc += P V; P's C fragments of two column tiles form one A fragment
    #pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t pf[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      #pragma unroll
      for (int jd = 0; jd < 8; jd += 2) {
        uint32_t vf[4];  // B fragments of d tiles jd and jd + 1
        ldmatrix_x4_trans(vf, vs[buf] + (kk * 16 + (lane & 7) +
                                         ((lane >> 3) & 1) * 8) * kBf16Ld +
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
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(ob + (long long)row * so.n + j * 8 +
                                         2 * (lane & 3)) =
          __floats2bfloat162_rn(acc[j][2 * r] * inv, acc[j][2 * r + 1] * inv);
    if (lse != nullptr && (lane & 3) == 0)
      lse[b * lse_sb + h * lse_sh + row] = m[r] * kLn2 + logf(l[r]);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. strides: 12 values, (batch, head, token)
// for q, k, v, o in elements (the head dim is contiguous). lse: float32
// [.., Nq] addressed by (lse_sb, lse_sh, 1), or null. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int flash_attn_fwd(int dtype, const void* q, const void* k,
                              const void* v, void* o, void* lse, int batch,
                              int heads, int nq, int kv_len, float sm_scale,
                              const long long* st, long long lse_sb,
                              long long lse_sh, void* stream) {
  const float scale_log2 = sm_scale * 1.4426950408889634f;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((nq + kBM - 1) / kBM, heads, batch);
  const Strides sq{st[0], st[1], st[2]}, sk{st[3], st[4], st[5]},
      sv{st[6], st[7], st[8]}, so{st[9], st[10], st[11]};
  float* l = static_cast<float*>(lse);
  if (dtype == 0) {
    // above 48 KB of dynamic shared memory only after opting in (per device)
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attn_fwd_f32, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kF32SmemBytes);
    if (err != cudaSuccess) return (int)err;
    flash_attn_fwd_f32<<<grid, kF32Threads, kF32SmemBytes, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), l, nq, kv_len,
        scale_log2, sq, sk, sv, so, lse_sb, lse_sh);
  } else if (dtype == 1) {
    flash_attn_fwd_bf16<<<grid, kBf16Threads, 0, s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<bf16*>(o), l, nq, kv_len,
        scale_log2, sq, sk, sv, so, lse_sb, lse_sh);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
