// Flash-attention backward for NVIDIA Hopper (sm_90a), CUDA C++ by hand.
//
// Replaces the two Pallas TPU kernels
//   amodal_depth_anything_tpu/ops/flash_attention.py::_attn_bwd_dq_kernel
//   amodal_depth_anything_tpu/ops/flash_attention.py::_attn_bwd_dkv_kernel
// and computes the same functions over [B, H, N, 64] operands. With the
// forward's natural-log LSE per query row and delta = rowsum(dO * O):
//   P  = exp(sm_scale * Q K^T - LSE)      (0 for keys at index >= kv_len)
//   dP = dO V^T
//   dS = P * (dP - delta)
//   dQ = sm_scale * dS K                  (flash_attn_bwd_dq)
//   dV = P^T dO,  dK = sm_scale * dS^T Q  (flash_attn_bwd_dkv)
// Rows of dK and dV at index >= kv_len are written as zero, and query rows
// at index >= q_len contribute nothing to dK and dV (a caller that pads a
// self-attention sequence passes q_len = kv_len). The exponential runs in
// the exp2 domain in float32. With bfloat16 operands P stays float32 in
// dS = P * (dP - delta); dS is rounded to bfloat16 before dS K and dS^T Q,
// and P^T before P^T dO, the TPU kernels' rounding points; every product
// accumulates in float32. float32 operands run in full float32.
//
// Bound on this card: the dQ kernel does 6*B*H*Nq*kv_len*64 operations
// (S, dP, dS K), the dK/dV kernel 8*B*H*q_len*kv_len*64 (S^T, dP^T, P^T dO,
// dS^T Q), each against about 2*B*H*(Nq+Nk)*64 elements read and B*H*N*64
// (or twice that) written: several hundred operations per byte at N = 1370
// in bfloat16, so both are bound by operations wherever training calls
// them (989 TFLOP/s of bf16 tensor cores; float32 is held to the 67 TFLOP/s
// of the FP32 units outside the tensor cores).
//
// Design. The TPU kernels keep a whole stream resident in VMEM (K and V in
// the dQ kernel, Q and dO in the dK/dV kernel); a Hopper block has at most
// 227 KB of shared memory, so both kernels here stream 64-row tiles of the
// other stream, as the forward does, and keep the TPU split into two
// kernels so that every output element is summed by one thread in a fixed
// order: no atomics, no second pass, the same bits on every run.
//
//  * dQ: one block per (batch, head, 64-row query tile). Q and dO stay in
//    registers; the block walks 64-row K/V tiles, rebuilds S and dP, and
//    sums dQ in float32 registers.
//  * dK/dV: one block per (batch, head, 64-row key tile). It works on the
//    transposed problem, S^T = K Q^T and dP^T = V dO^T, so that K and V stay
//    in registers and the key rows are the accumulator rows; it walks 64-row
//    Q/dO tiles with their LSE and delta and sums dK and dV in registers.
//  * bfloat16: 4 warps of 16 rows on mma.sync m16n8k16 tensor-core
//    operations. The streamed tiles arrive by cp.async into a double
//    buffer; ldmatrix feeds them as B fragments, plain for the products
//    that contract over the head dim and .trans for those that contract
//    over the streamed rows; the score accumulators are reused as A
//    fragments after rounding. The resident operands are staged through the
//    second buffer before the loop starts, which keeps the block within
//    48 KB of static shared memory. mma.sync reaches only part of Hopper's
//    tensor-core rate; a fused single kernel, wgmma and TMA are later work.
//  * float32: 256 threads, each a 4x4 patch of the score and output tiles,
//    scalar FMAs on float32 smem tiles (TF32 would miss the parity bar).
//
// Operands are addressed through (batch, head, token) strides with a unit
// stride on the head dim; LSE and delta are contiguous [B, H, Nq] float32.

#include "flash_attn_common.cuh"

namespace {

// ------------------------------------------------------------ float32 path

constexpr int kTileF32 = 64 * kF32Ld;   // floats in one padded smem tile
constexpr int kDqF32SmemBytes = 4 * 5 * kTileF32;             // Q dO K V dS
constexpr int kDkvF32SmemBytes = 4 * (6 * kTileF32 + 2 * 64);  // K V Q dO P^T
                                                              // dS^T + stats

// acc[i][j] += sum_kk a[(4ty+i)][kk] * b[kk][4tx+j] over a 64-deep tile
__device__ __forceinline__ void accum_rows_f32(float acc[4][4], const float* a,
                                               const float* b, int ty,
                                               int tx) {
  #pragma unroll 2
  for (int kk = 0; kk < 64; kk += 4) {
    float4 av[4];
    #pragma unroll
    for (int i = 0; i < 4; ++i)
      av[i] = *reinterpret_cast<const float4*>(a + (ty * 4 + i) * kF32Ld + kk);
    #pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float4 bv =
          *reinterpret_cast<const float4*>(b + (kk + u) * kF32Ld + tx * 4);
      #pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float x = u == 0 ? av[i].x : u == 1 ? av[i].y
                      : u == 2 ? av[i].z : av[i].w;
        acc[i][0] += x * bv.x;
        acc[i][1] += x * bv.y;
        acc[i][2] += x * bv.z;
        acc[i][3] += x * bv.w;
      }
    }
  }
}

// out[i][j] = sum_d a[(4ty+i)][d] * b[(tx+16j)][d]
__device__ __forceinline__ void dot_rows_f32(float out[4][4], const float* a,
                                             const float* b, int ty, int tx) {
  #pragma unroll
  for (int i = 0; i < 4; ++i)
    #pragma unroll
    for (int j = 0; j < 4; ++j) out[i][j] = 0.f;
  #pragma unroll 4
  for (int d = 0; d < kD; d += 4) {
    float4 av[4], bv[4];
    #pragma unroll
    for (int i = 0; i < 4; ++i)
      av[i] = *reinterpret_cast<const float4*>(a + (ty * 4 + i) * kF32Ld + d);
    #pragma unroll
    for (int j = 0; j < 4; ++j)
      bv[j] = *reinterpret_cast<const float4*>(b + (tx + 16 * j) * kF32Ld + d);
    #pragma unroll
    for (int i = 0; i < 4; ++i)
      #pragma unroll
      for (int j = 0; j < 4; ++j)
        out[i][j] += av[i].x * bv[j].x + av[i].y * bv[j].y +
                     av[i].z * bv[j].z + av[i].w * bv[j].w;
  }
}

__global__ void __launch_bounds__(kF32Threads)
flash_attn_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, float* __restrict__ dq,
                      int nq, int kv_len, float sm_scale, Strides sq,
                      Strides sk, Strides sv, Strides sdo, Strides sdq) {
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* dos = qs + kTileF32;
  float* ks = dos + kTileF32;
  float* vs = ks + kTileF32;
  float* dss = vs + kTileF32;

  const int tx = threadIdx.x & 15;   // score cols tx + 16j; output cols 4tx + j
  const int ty = threadIdx.x >> 4;   // rows 4ty + i
  const int q0 = blockIdx.x * kBM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const float scale_log2 = sm_scale * kLog2e;

  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  // Q carries sm_scale * log2(e), as in the forward kernel, so that S and
  // the LSE round alike and P = exp2(S - LSE) loses nothing to the scale
  stage_tile_f32(qs, kF32Ld, q + b * sq.b + h * sq.h, sq.n, q0, nq,
                 scale_log2);
  stage_tile_f32(dos, kF32Ld, dout + b * sdo.b + h * sdo.h, sdo.n, q0, nq,
                 1.f);

  const long long stat0 = ((long long)b * gridDim.y + h) * nq;
  float lse2[4], dl[4], acc[4][4];
  #pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    lse2[i] = row < nq ? lse[stat0 + row] * kLog2e : 0.f;
    dl[i] = row < nq ? delta[stat0 + row] : 0.f;
    #pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < kv_len; k0 += kBN) {
    __syncthreads();  // the previous tile's dS.K is done with ks/dss
    stage_tile_f32(ks, kF32Ld, kb, sk.n, k0, kv_len, 1.f);
    stage_tile_f32(vs, kF32Ld, vb, sv.n, k0, kv_len, 1.f);
    __syncthreads();

    float s[4][4], dp[4][4];
    dot_rows_f32(s, qs, ks, ty, tx);     // Q K^T
    dot_rows_f32(dp, dos, vs, ty, tx);   // dO V^T
    #pragma unroll
    for (int i = 0; i < 4; ++i)
      #pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = k0 + tx + 16 * j < kv_len
                            ? exp2f(s[i][j] - lse2[i]) : 0.f;
        dss[(ty * 4 + i) * kF32Ld + tx + 16 * j] = p * (dp[i][j] - dl[i]);
      }
    __syncthreads();
    accum_rows_f32(acc, dss, ks, ty, tx);  // dQ += dS K
  }

  float* ob = dq + b * sdq.b + h * sdq.h;
  #pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= nq) continue;
    *reinterpret_cast<float4*>(ob + (long long)row * sdq.n + tx * 4) =
        make_float4(acc[i][0] * sm_scale, acc[i][1] * sm_scale,
                    acc[i][2] * sm_scale, acc[i][3] * sm_scale);
  }
}

__global__ void __launch_bounds__(kF32Threads)
flash_attn_bwd_dkv_f32(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v,
                       const float* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       float* __restrict__ dk, float* __restrict__ dv, int nq,
                       int nk, int q_len, int kv_len, float sm_scale,
                       Strides sq, Strides sk, Strides sv, Strides sdo,
                       Strides sdk, Strides sdv) {
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);
  float* vs = ks + kTileF32;
  float* qs = vs + kTileF32;
  float* dos = qs + kTileF32;
  float* pts = dos + kTileF32;
  float* dsts = pts + kTileF32;
  float* lses = dsts + kTileF32;   // [64], log2 units
  float* dls = lses + 64;          // [64]

  const int tx = threadIdx.x & 15;   // query cols tx + 16j; output cols 4tx + j
  const int ty = threadIdx.x >> 4;   // key rows 4ty + i
  const int k0 = blockIdx.x * kBN;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const float scale_log2 = sm_scale * kLog2e;

  float dka[4][4], dva[4][4];
  #pragma unroll
  for (int i = 0; i < 4; ++i)
    #pragma unroll
    for (int j = 0; j < 4; ++j) dka[i][j] = dva[i][j] = 0.f;

  if (k0 < kv_len) {  // key tiles at or past kv_len only write zeros
    const float* qb = q + b * sq.b + h * sq.h;
    const float* dob = dout + b * sdo.b + h * sdo.h;
    const long long stat0 = ((long long)b * gridDim.y + h) * nq;
    stage_tile_f32(ks, kF32Ld, k + b * sk.b + h * sk.h, sk.n, k0, kv_len, 1.f);
    stage_tile_f32(vs, kF32Ld, v + b * sv.b + h * sv.h, sv.n, k0, kv_len, 1.f);

    for (int q0 = 0; q0 < q_len; q0 += kBM) {
      __syncthreads();  // the previous tile's products are done with smem
      stage_tile_f32(qs, kF32Ld, qb, sq.n, q0, q_len, scale_log2);
      stage_tile_f32(dos, kF32Ld, dob, sdo.n, q0, q_len, 1.f);
      if (threadIdx.x < 64) {
        const int row = q0 + threadIdx.x;
        lses[threadIdx.x] = row < q_len ? lse[stat0 + row] * kLog2e : 0.f;
      } else if (threadIdx.x < 128) {
        const int row = q0 + threadIdx.x - 64;
        dls[threadIdx.x - 64] = row < q_len ? delta[stat0 + row] : 0.f;
      }
      __syncthreads();

      float st[4][4], dpt[4][4];
      dot_rows_f32(st, ks, qs, ty, tx);     // K Q^T
      dot_rows_f32(dpt, vs, dos, ty, tx);   // V dO^T
      #pragma unroll
      for (int i = 0; i < 4; ++i)
        #pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j;
          const float p = q0 + c < q_len
                              ? exp2f(st[i][j] - lses[c]) : 0.f;
          pts[(ty * 4 + i) * kF32Ld + c] = p;
          dsts[(ty * 4 + i) * kF32Ld + c] = p * (dpt[i][j] - dls[c]);
        }
      __syncthreads();
      accum_rows_f32(dva, pts, dos, ty, tx);   // dV += P^T dO
      accum_rows_f32(dka, dsts, qs, ty, tx);   // dK += dS^T Q
    }
  }

  float* dkb = dk + b * sdk.b + h * sdk.h;
  float* dvb = dv + b * sdv.b + h * sdv.h;
  #pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + ty * 4 + i;
    if (row >= nk) continue;
    // a masked key row inside a live tile has summed P = exp(-LSE) terms
    // (its K row was staged as zeros): write literal zeros, not a product
    // that an overflowed sum would turn into NaN
    const bool live = row < kv_len;
    // the staged Q carried sm_scale * log2(e): dK = ln(2) * dS^T (Q scaled)
    *reinterpret_cast<float4*>(dkb + (long long)row * sdk.n + tx * 4) =
        live ? make_float4(dka[i][0] * kLn2, dka[i][1] * kLn2,
                           dka[i][2] * kLn2, dka[i][3] * kLn2)
             : make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(dvb + (long long)row * sdv.n + tx * 4) =
        live ? make_float4(dva[i][0], dva[i][1], dva[i][2], dva[i][3])
             : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// ----------------------------------------------------------- bfloat16 path

// 4 bytes global -> shared, asynchronously; zero-filled when !valid
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::
                   "r"(smem_addr(dst)), "l"(src), "r"(valid ? 4 : 0));
}

// The warp's 16 rows of a [64][kBf16Ld] smem tile as four A fragments, one
// per 16-wide step over the head dim.
__device__ __forceinline__ void load_a_frags(uint32_t f[4][4], const bf16* tile,
                                             int warp, int lane) {
  #pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    ldmatrix_x4(f[kk], tile + (warp * 16 + (lane & 15)) * kBf16Ld + kk * 16 +
                           (lane >> 4) * 8);
}

// c[j] = a (16 x 64, A fragments) * tile^T, tile [64 rows][64]: the product
// contracts over the head dim, 16 rows x 64 tile rows per warp.
__device__ __forceinline__ void mma_a_tile_t(float c[8][4],
                                             const uint32_t a[4][4],
                                             const bf16* tile, int lane) {
  #pragma unroll
  for (int j = 0; j < 8; ++j) {
    #pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = 0.f;
    #pragma unroll
    for (int kk = 0; kk < 4; kk += 2) {
      uint32_t bf[4];  // B fragments of k steps kk and kk + 1
      ldmatrix_x4(bf, tile + (j * 8 + (lane & 7)) * kBf16Ld + kk * 16 +
                          (lane >> 3) * 8);
      mma_bf16(c[j], a[kk], bf[0], bf[1]);
      mma_bf16(c[j], a[kk + 1], bf[2], bf[3]);
    }
  }
}

// acc += x (16 x 64 float32 C fragments, rounded to bf16) * tile, tile
// [64 rows][64]: the product contracts over the tile's rows.
__device__ __forceinline__ void mma_c_tile(float acc[8][4],
                                           const float x[8][4],
                                           const bf16* tile, int lane) {
  #pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    // the C fragments of two column tiles form one A fragment
    const uint32_t af[4] = {pack_bf16(x[2 * kk][0], x[2 * kk][1]),
                            pack_bf16(x[2 * kk][2], x[2 * kk][3]),
                            pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]),
                            pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3])};
    #pragma unroll
    for (int jd = 0; jd < 8; jd += 2) {
      uint32_t bf[4];  // B fragments of d tiles jd and jd + 1
      ldmatrix_x4_trans(bf, tile + (kk * 16 + (lane & 7) +
                                    ((lane >> 3) & 1) * 8) * kBf16Ld +
                                jd * 8 + (lane >> 4) * 8);
      mma_bf16(acc[jd], af, bf[0], bf[1]);
      mma_bf16(acc[jd + 1], af, bf[2], bf[3]);
    }
  }
}

// Store the warp's 16 x 64 float32 accumulator, times `mul`, as bf16 rows
// [row0 + warp*16, +16) of one (b, h) slice; rows at or past `rows` are
// skipped and rows at or past `live` are written as zero.
__device__ __forceinline__ void store_acc_bf16(bf16* dst, long long row_stride,
                                               const float acc[8][4],
                                               float mul, int row0, int rows,
                                               int live, int warp, int lane) {
  #pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + warp * 16 + (lane >> 2) + r * 8;
    if (row >= rows) continue;
    // literal zeros for a dead row: its sums of P = exp(-LSE) terms may
    // have overflowed, and inf * 0 is NaN
    const bool keep = row < live;
    #pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + (long long)row * row_stride +
                                         j * 8 + 2 * (lane & 3)) =
          keep ? __floats2bfloat162_rn(acc[j][2 * r] * mul,
                                       acc[j][2 * r + 1] * mul)
               : __floats2bfloat162_rn(0.f, 0.f);
  }
}

__global__ void __launch_bounds__(kBf16Threads)
flash_attn_bwd_dq_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v,
                       const bf16* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta, bf16* __restrict__ dq,
                       int nq, int kv_len, float sm_scale, Strides sq,
                       Strides sk, Strides sv, Strides sdo, Strides sdq) {
  __shared__ __align__(16) bf16 ks[2][kBN * kBf16Ld];
  __shared__ __align__(16) bf16 vs[2][kBN * kBf16Ld];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * kBM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const float scale_log2 = sm_scale * kLog2e;
  const bf16* kb = k + b * sk.b + h * sk.h;
  const bf16* vb = v + b * sv.b + h * sv.h;

  // Q and dO pass through the second buffer into registers
  load_tile_bf16(ks[1], q + b * sq.b + h * sq.h, sq.n, q0, nq);
  load_tile_bf16(vs[1], dout + b * sdo.b + h * sdo.h, sdo.n, q0, nq);
  load_tile_bf16(ks[0], kb, sk.n, 0, kv_len);
  load_tile_bf16(vs[0], vb, sv.n, 0, kv_len);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  uint32_t qf[4][4], dof[4][4];
  load_a_frags(qf, ks[1], warp, lane);
  load_a_frags(dof, vs[1], warp, lane);
  __syncthreads();  // before the first prefetch overwrites the buffer

  // per thread: rows g = lane/4 and g + 8 of the warp's 16; in each 8-wide
  // column tile, columns 2*(lane%4) and +1 (the mma C-fragment layout)
  const long long stat0 = ((long long)b * gridDim.y + h) * nq;
  float lse2[2], dl[2];
  #pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + (lane >> 2) + r * 8;
    lse2[r] = row < nq ? lse[stat0 + row] * kLog2e : 0.f;
    dl[r] = row < nq ? delta[stat0 + row] : 0.f;
  }
  float acc[8][4];
  #pragma unroll
  for (int j = 0; j < 8; ++j)
    #pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  const int n_tiles = (kv_len + kBN - 1) / kBN;
  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < n_tiles) {  // prefetch the next tile into the other buffer
      load_tile_bf16(ks[buf ^ 1], kb, sk.n, (t + 1) * kBN, kv_len);
      load_tile_bf16(vs[buf ^ 1], vb, sv.n, (t + 1) * kBN, kv_len);
    }
    cp_async_commit();
    cp_async_wait_all_but_newest();  // tile t has landed
    __syncthreads();

    float s[8][4], dp[8][4];
    mma_a_tile_t(s, qf, ks[buf], lane);     // Q K^T
    mma_a_tile_t(dp, dof, vs[buf], lane);   // dO V^T
    const int col0 = t * kBN + 2 * (lane & 3);
    #pragma unroll
    for (int j = 0; j < 8; ++j)
      #pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = col0 + j * 8 + (e & 1) < kv_len
                            ? exp2f(s[j][e] * scale_log2 - lse2[e >> 1]) : 0.f;
        s[j][e] = p * (dp[j][e] - dl[e >> 1]);   // dS
      }
    mma_c_tile(acc, s, ks[buf], lane);      // dQ += dS K
    __syncthreads();  // every warp is done with buffer `buf`
  }

  store_acc_bf16(dq + b * sdq.b + h * sdq.h, sdq.n, acc, sm_scale, q0, nq, nq,
                 warp, lane);
}

__global__ void __launch_bounds__(kBf16Threads)
flash_attn_bwd_dkv_bf16(const bf16* __restrict__ q,
                        const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const bf16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        bf16* __restrict__ dk, bf16* __restrict__ dv, int nq,
                        int nk, int q_len, int kv_len, float sm_scale,
                        Strides sq, Strides sk, Strides sv, Strides sdo,
                        Strides sdk, Strides sdv) {
  __shared__ __align__(16) bf16 qs[2][kBM * kBf16Ld];
  __shared__ __align__(16) bf16 dos[2][kBM * kBf16Ld];
  __shared__ __align__(16) float lses[2][kBM];   // natural-log units
  __shared__ __align__(16) float dls[2][kBM];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int k0 = blockIdx.x * kBN;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const float scale_log2 = sm_scale * kLog2e;

  float dka[8][4], dva[8][4];
  #pragma unroll
  for (int j = 0; j < 8; ++j)
    #pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;

  if (k0 < kv_len) {  // key tiles at or past kv_len only write zeros
    const bf16* qb = q + b * sq.b + h * sq.h;
    const bf16* dob = dout + b * sdo.b + h * sdo.h;
    const float* lseb = lse + ((long long)b * gridDim.y + h) * nq;
    const float* dlb = delta + ((long long)b * gridDim.y + h) * nq;

    // one 64-row tile of Q, dO, LSE and delta into buffer `buf`
    auto load_q_tile = [&](int buf, int row0) {
      load_tile_bf16(qs[buf], qb, sq.n, row0, q_len);
      load_tile_bf16(dos[buf], dob, sdo.n, row0, q_len);
      const int i = threadIdx.x & 63;
      const bool valid = row0 + i < q_len;
      if (threadIdx.x < 64)
        cp_async4(&lses[buf][i], lseb + (valid ? row0 + i : 0), valid);
      else
        cp_async4(&dls[buf][i], dlb + (valid ? row0 + i : 0), valid);
    };

    // K and V pass through the second buffer into registers
    load_tile_bf16(qs[1], k + b * sk.b + h * sk.h, sk.n, k0, kv_len);
    load_tile_bf16(dos[1], v + b * sv.b + h * sv.h, sv.n, k0, kv_len);
    load_q_tile(0, 0);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    uint32_t kf[4][4], vf[4][4];
    load_a_frags(kf, qs[1], warp, lane);
    load_a_frags(vf, dos[1], warp, lane);
    __syncthreads();  // before the first prefetch overwrites the buffer

    const int n_tiles = (q_len + kBM - 1) / kBM;
    for (int t = 0; t < n_tiles; ++t) {
      const int buf = t & 1;
      if (t + 1 < n_tiles) load_q_tile(buf ^ 1, (t + 1) * kBM);
      cp_async_commit();
      cp_async_wait_all_but_newest();  // tile t has landed
      __syncthreads();

      // rows: this warp's 16 keys; columns: the tile's 64 queries
      float st[8][4], dpt[8][4];
      mma_a_tile_t(st, kf, qs[buf], lane);     // K Q^T
      mma_a_tile_t(dpt, vf, dos[buf], lane);   // V dO^T
      #pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = j * 8 + 2 * (lane & 3);
        const float2 l2 = *reinterpret_cast<const float2*>(&lses[buf][c]);
        const float2 d2 = *reinterpret_cast<const float2*>(&dls[buf][c]);
        #pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float l = (e & 1) ? l2.y : l2.x;
          const float dd = (e & 1) ? d2.y : d2.x;
          const float p = t * kBM + c + (e & 1) < q_len
                              ? exp2f(st[j][e] * scale_log2 - l * kLog2e)
                              : 0.f;
          st[j][e] = p;                      // P^T
          dpt[j][e] = p * (dpt[j][e] - dd);  // dS^T
        }
      }
      mma_c_tile(dva, st, dos[buf], lane);   // dV += P^T dO
      mma_c_tile(dka, dpt, qs[buf], lane);   // dK += dS^T Q
      __syncthreads();  // every warp is done with buffer `buf`
    }
  }

  store_acc_bf16(dk + b * sdk.b + h * sdk.h, sdk.n, dka, sm_scale, k0, nk,
                 kv_len, warp, lane);
  store_acc_bf16(dv + b * sdv.b + h * sdv.h, sdv.n, dva, 1.f, k0, nk, kv_len,
                 warp, lane);
}

Strides strides_at(const long long* st, int i) {
  return Strides{st[3 * i], st[3 * i + 1], st[3 * i + 2]};
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q, dout, dq: [B, H, Nq, 64]; k, v:
// [B, H, Nk, 64]; strides: 15 values, (batch, head, token) for q, k, v, dout,
// dq in elements (the head dim is contiguous). lse, delta: contiguous
// [B, H, Nq] float32. Returns the cudaError_t of the launch (0 on success).
extern "C" int flash_attn_bwd_dq(int dtype, const void* q, const void* k,
                                 const void* v, const void* dout,
                                 const void* lse, const void* delta, void* dq,
                                 int batch, int heads, int nq, int kv_len,
                                 float sm_scale, const long long* st,
                                 void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((nq + kBM - 1) / kBM, heads, batch);
  const Strides sq = strides_at(st, 0), sk = strides_at(st, 1),
                sv = strides_at(st, 2), sdo = strides_at(st, 3),
                sdq = strides_at(st, 4);
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(delta);
  if (dtype == 0) {
    // above 48 KB of dynamic shared memory only after opting in (per device)
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attn_bwd_dq_f32, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kDqF32SmemBytes);
    if (err != cudaSuccess) return (int)err;
    flash_attn_bwd_dq_f32<<<grid, kF32Threads, kDqF32SmemBytes, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), l, d,
        static_cast<float*>(dq), nq, kv_len, sm_scale, sq, sk, sv, sdo, sdq);
  } else if (dtype == 1) {
    flash_attn_bwd_dq_bf16<<<grid, kBf16Threads, 0, s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const bf16*>(dout), l, d,
        static_cast<bf16*>(dq), nq, kv_len, sm_scale, sq, sk, sv, sdo, sdq);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// As flash_attn_bwd_dq, with dk, dv: [B, H, Nk, 64] and 18 strides: q, k, v,
// dout, dk, dv. Rows of dk and dv in [kv_len, nk) are written as zero;
// query rows at or past q_len are left out of the sums.
extern "C" int flash_attn_bwd_dkv(int dtype, const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const void* lse, const void* delta,
                                  void* dk, void* dv, int batch, int heads,
                                  int nq, int nk, int q_len, int kv_len,
                                  float sm_scale, const long long* st,
                                  void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((nk + kBN - 1) / kBN, heads, batch);
  const Strides sq = strides_at(st, 0), sk = strides_at(st, 1),
                sv = strides_at(st, 2), sdo = strides_at(st, 3),
                sdk = strides_at(st, 4), sdv = strides_at(st, 5);
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(delta);
  if (dtype == 0) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attn_bwd_dkv_f32, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kDkvF32SmemBytes);
    if (err != cudaSuccess) return (int)err;
    flash_attn_bwd_dkv_f32<<<grid, kF32Threads, kDkvF32SmemBytes, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), l, d,
        static_cast<float*>(dk), static_cast<float*>(dv), nq, nk, q_len,
        kv_len, sm_scale, sq, sk, sv, sdo, sdk, sdv);
  } else if (dtype == 1) {
    flash_attn_bwd_dkv_bf16<<<grid, kBf16Threads, 0, s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const bf16*>(dout), l, d,
        static_cast<bf16*>(dk), static_cast<bf16*>(dv), nq, nk, q_len, kv_len,
        sm_scale, sq, sk, sv, sdo, sdk, sdv);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
