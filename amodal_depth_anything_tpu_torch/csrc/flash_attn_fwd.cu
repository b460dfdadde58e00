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
// Bound on this card: 4*B*H*Nq*kv_len*d operations against
// 2*B*H*(Nq+kv_len)*d elements moved. Self-attention on the main paths
// (N = 1370 at d = 64, N = 4096 at d = 40) is compute-bound by a wide
// margin; cross-attention onto 77 keys does 2*77 operations per q/o element
// and is memory-bound in bfloat16 (float32 is held to the 67 TFLOP/s of the
// FP32 units outside the tensor cores).
//
// Design. The TPU kernel keeps all of K/V resident in VMEM; at N = 5330 that
// is ~1.4 MB per head, far above the 227 KB of shared memory a block may
// use. Every kernel here streams K/V tiles through shared memory instead and
// keeps an online softmax (running max and sum per row) and the output
// accumulator in float32 registers, dividing by the sum once at the end.
// Query rows past Nq are never stored and key columns past kv_len are masked
// to -inf (their K/V rows load as zero), so no caller has to pad the
// sequence, and Nq and Nk are independent. Operands are addressed through
// (batch, head, token) strides with a unit stride on the head dim, so the
// q/k/v views of one fused qkv projection and an output laid out
// [B, N, H, D] need no copies.
//
// Which kernel runs is a fixed table by dtype and head dim d:
//
//   bfloat16, d <= 64   flash_attn_fwd_bf16_wgmma<ceil(d / 16)>
//   bfloat16, d <= 80   flash_attn_fwd_bf16<80>    (mma.sync)
//   bfloat16, d <= 160  flash_attn_fwd_bf16<160>   (mma.sync)
//   float32,  d <= 160  flash_attn_fwd_f32<DPAD>, DPAD the smallest of
//                       16, 32, 48, 64, 80, 160 that holds d
//
//  * bfloat16, d <= 64 (both DINOv2 trunks' 64, the SD-1.5 UNet's 40): the
//    tensor cores' full-rate path, wgmma fed by TMA, FlashAttention-3's
//    shape at its simplest. A block is three warpgroups on 128 query rows.
//    One thread of the producer warpgroup (which gives its registers away
//    with setmaxnreg) starts TMA loads through 4-D tensor maps over (d,
//    token, head, batch) that the C entry encodes from the strides it is
//    given: Q once, then K and V tiles of 128 keys into a ring of three
//    stages, each tile a 128 x 64 box with the 128-byte swizzle, each stage
//    with a "full" and an "empty" mbarrier for K and another pair for V.
//    TMA fills what lies outside the tensor with zeros: rows past Nq or
//    kv_len (the K and V maps end at kv_len) and, for d < 64, the columns
//    from d on. Each of the two consumer warpgroups owns 64 query rows: S =
//    Q K^T is ceil(d / 16) wgmma m64n128k16 with both operands in shared
//    memory; the online softmax runs on the accumulator fragments in
//    registers; P, rounded to bfloat16, is regrouped in place into m64k16 A
//    fragments (no shuffle) and P.V is eight wgmma m64nNk16, N = 16 *
//    ceil(d / 16), with V as the MN-major B operand straight from its
//    [keys, d] tile. So d = 40 pays for 48 columns, not 64. What bounds the
//    kernel is the softmax (FP32 and exp work of two warps a scheduler),
//    so the products are made to run under it: tile t's S goes out together
//    with tile t-1's P.V, the softmax of tile t runs while P.V is still in
//    flight, and the two warpgroups take turns on the tensor cores over a
//    pair of named barriers, so that one's softmax falls under the other's
//    products.
//  * bfloat16, 64 < d <= 160 (the UNet's 80 and 160, launch-bound shapes of
//    at most 1024 tokens): 4 warps, 16 query rows each, mma.sync m16n8k16.
//    Q stays in registers as A fragments; 64-key K/V tiles arrive by
//    cp.async into a double buffer; ldmatrix feeds K (and, with .trans, V)
//    as B fragments; the score accumulator is reused as the A fragment of
//    P.V. Shared memory is dynamic: 640 * (DPAD + 8) bytes, 107.5 KB at 160.
//  * float32: 256 threads, each 4 rows x 4 keys of the score tile and 4 rows
//    x DPAD/16 columns of the output tile, scalar FMAs on float32 smem
//    tiles: exact to float32 (TF32 tensor cores would lose the parity the
//    float32 path exists for), bounded by the 67 TFLOP/s of the FP32 units.
//    The shared-memory columns from d to DPAD are zero-filled, which changes
//    no result.

#include "sm90.cuh"

namespace {

// ------------------------------------------------------------ float32 path

template <int DPAD>
struct F32Tile : F32Cols<DPAD> {
  static constexpr int kLd = F32Cols<DPAD>::kLd;
  static constexpr int kSmemBytes = 4 * (kBM * kLd      // Q (pre-scaled)
                                         + kBN * kLd    // K
                                         + kBN * DPAD   // V
                                         + kBM * kPLd); // P
};

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

// ------------------------------------- bfloat16 path, d > 64: mma.sync

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

// ------------------------------------ bfloat16 path, d <= 64: wgmma + TMA

constexpr int kWgRows = 128;             // query rows per block, keys per tile
constexpr int kWgStages = 3;
constexpr int kWgThreads = 384;          // two consumer warpgroups, then the
                                         // producer's
constexpr int kWgTile = kWgRows * 64;    // elements of a Q, K or V tile
constexpr int kWgTileBytes = 2 * kWgTile;
constexpr int kWgSmemBytes = (1 + 2 * kWgStages) * kWgTileBytes +
                             (1 + 4 * kWgStages) * 8 +
                             kSwizzleAtom;   // room to align the tiles

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The online softmax of one 64 x 128 score tile held as accumulator
// fragments: s becomes P = exp2(scale * s - new max) in place, m (the running
// max of scale * s) and l (this thread's share of the row sums) are brought
// up to date, and alpha is what the output so far must be multiplied by. The
// max is taken over the raw scores, of s or, for a negative scale (NEG), of
// -s: rounding is monotonic, so |scale| times that is exactly the max of the
// rounded scale * s, and the scale costs no instruction of its own: it is
// the multiplier of the one fused multiply-add under the exponential. In a
// RAGGED tile (the last one, when kv_len is no multiple of 128) keys >=
// kv_len are left out of the max and get P = 0.
template <bool RAGGED, bool NEG>
__device__ __forceinline__ void softmax_body(float (&s)[64], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             float scale_log2, int key0,
                                             int kv_len) {
  float mx[2] = {-INFINITY, -INFINITY};
  #pragma unroll
  for (int i = 0; i < 64; ++i) {
    if (RAGGED && key0 + (i >> 2) * 8 + (i & 1) >= kv_len) continue;
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], NEG ? -s[i] : s[i]);
  }
  #pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    // finite: every tile holds a key < kv_len
    const float m_new = fmaxf(m[r], mx[r] * fabsf(scale_log2));
    alpha[r] = exp2_approx(m[r] - m_new);
    m[r] = m_new;
    l[r] *= alpha[r];
  }
  #pragma unroll
  for (int i = 0; i < 64; ++i) {
    s[i] = exp2_approx(fmaf(s[i], scale_log2, -m[(i >> 1) & 1]));
    if (RAGGED && key0 + (i >> 2) * 8 + (i & 1) >= kv_len) s[i] = 0.f;
    l[(i >> 1) & 1] += s[i];
  }
}

// tile_end: one past the tile's last key
__device__ __forceinline__ void softmax_tile(float (&s)[64], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             float scale_log2, int key0,
                                             int tile_end, int kv_len) {
  if (scale_log2 < 0.f) {
    if (tile_end > kv_len)
      softmax_body<true, true>(s, m, l, alpha, scale_log2, key0, kv_len);
    else
      softmax_body<false, true>(s, m, l, alpha, scale_log2, key0, kv_len);
  } else if (tile_end > kv_len) {
    softmax_body<true, false>(s, m, l, alpha, scale_log2, key0, kv_len);
  } else {
    softmax_body<false, false>(s, m, l, alpha, scale_log2, key0, kv_len);
  }
}

// P, rounded to bf16, regrouped into the A fragments of eight k16 steps: the
// accumulator's column tiles 2kk and 2kk + 1 are one m64k16 A fragment
__device__ __forceinline__ void pack_p(uint32_t (&pf)[8][4],
                                       const float (&s)[64]) {
  #pragma unroll
  for (int i = 0; i < 64; i += 2)
    pf[i >> 3][(i >> 1) & 3] = pack_bf16(s[i], s[i + 1]);
}

template <int KSTEPS>   // k16 steps over the head dim: ceil(d / 16)
__global__ void __launch_bounds__(kWgThreads, 1)
flash_attn_fwd_bf16_wgmma(const __grid_constant__ CUtensorMap map_q,
                          const __grid_constant__ CUtensorMap map_k,
                          const __grid_constant__ CUtensorMap map_v,
                          bf16* __restrict__ o, float* __restrict__ lse,
                          int nq, int kv_len, int d, float scale_log2,
                          Strides so, long long lse_sb, long long lse_sh) {
  constexpr int kNV = 16 * KSTEPS;      // output columns computed
  extern __shared__ uint8_t smem_raw[];
  // the swizzle pattern is a function of the address: 1024-byte aligned tiles
  uint8_t* smem = smem_raw + ((kSwizzleAtom - smem_addr(smem_raw)) &
                              (kSwizzleAtom - 1));
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + kWgTile;
  bf16* vs = ks + kWgStages * kWgTile;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(vs + kWgStages * kWgTile);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + kWgStages;
  uint64_t* k_empty = v_full + kWgStages;
  uint64_t* v_empty = k_empty + kWgStages;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(k_full + s, 1);   // the producer's arrive; TMA adds the bytes
      mbar_init(v_full + s, 1);
      mbar_init(k_empty + s, 2);  // one thread of each consumer warpgroup
      mbar_init(v_empty + s, 2);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int q0 = blockIdx.x * kWgRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int n_tiles = (kv_len + kWgRows - 1) / kWgRows;
  const int wg = threadIdx.x >> 7;

  if (wg == 2) {
    // ------------------------------------------------------------ producer
    setmaxnreg_dec<40>();
    if (threadIdx.x == 2 * 128) {
      tma_prefetch_map(&map_q);
      tma_prefetch_map(&map_k);
      tma_prefetch_map(&map_v);
      mbar_arrive_expect_tx(q_full, kWgTileBytes);
      tma_load_4d(qs, &map_q, q_full, 0, q0, h, b);
      int stage = 0;
      uint32_t phase = 0;
      for (int t = 0; t < n_tiles; ++t) {
        mbar_wait(k_empty + stage, phase ^ 1);   // free from the start
        mbar_arrive_expect_tx(k_full + stage, kWgTileBytes);
        tma_load_4d(ks + stage * kWgTile, &map_k, k_full + stage, 0,
                    t * kWgRows, h, b);
        mbar_wait(v_empty + stage, phase ^ 1);
        mbar_arrive_expect_tx(v_full + stage, kWgTileBytes);
        tma_load_4d(vs + stage * kWgTile, &map_v, v_full + stage, 0,
                    t * kWgRows, h, b);
        if (++stage == kWgStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    setmaxnreg_inc<232>();
    const int lane = threadIdx.x & 31;
    // per thread: rows row0 and row0 + 8; in each 8-wide column tile,
    // columns col0 and col0 + 1 (the accumulator layout, see sm90.cuh)
    const int row0 = q0 + wg * 64 + ((threadIdx.x >> 5) & 3) * 16 +
                     (lane >> 2);
    const int col0 = 2 * (lane & 3);
    const bool elected = (threadIdx.x & 127) == 0;

    float m[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.f, 0.f};
    float alpha[2];
    float acc[kNV / 2];
    #pragma unroll
    for (int i = 0; i < kNV / 2; ++i) acc[i] = 0.f;
    uint32_t pf[8][4];    // the tile before's P in bf16, read by its P.V

    // Tile t's S = Q K^T (ceil(d / 16) wgmma m64n128k16, operands in shared
    // memory) is started together with tile t-1's O += P V (eight wgmma
    // m64nNk16, P from registers, V [keys, d] the MN-major B operand), so
    // that tile t's softmax runs while the tensor cores work on P V.
    if (wg == 1) turn_pass(wg);   // warpgroup 0 goes first
    mbar_wait(q_full, 0);
    const uint64_t dq = wgmma_desc(qs + wg * 64 * 64, 16, kSwizzleAtom);
    const auto start_s = [&](float (&s)[64], int stage) {
      const uint64_t dk = wgmma_desc(ks + stage * kWgTile, 16, kSwizzleAtom);
      #pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk)
        wgmma_ss<0>(s, wgmma_desc_advance(dq, kk * 32),
                    wgmma_desc_advance(dk, kk * 32), kk != 0);
      wgmma_commit();
    };
    const auto start_pv = [&](int stage) {
      const uint64_t dv = wgmma_desc(vs + stage * kWgTile, 16, kSwizzleAtom);
      #pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        wgmma_rs(acc, pf[kk], wgmma_desc_advance(dv, kk * 16 * kSwizzleRow));
      wgmma_commit();
    };

    {   // tile 0: nothing to overlap with yet
      float s[64];
      mbar_wait(k_full, 0);
      turn_wait(wg);
      wgmma_fence();
      start_s(s, 0);
      turn_pass(wg);
      wgmma_wait<0>();
      wgmma_pin(s);
      if (elected) mbar_arrive(k_empty);
      softmax_tile(s, m, l, alpha, scale_log2, col0, kWgRows, kv_len);
      pack_p(pf, s);   // acc is 0: nothing to rescale
    }
    int k_stage = 1 % kWgStages, v_stage = 0;
    uint32_t k_phase = kWgStages == 1, v_phase = 0;
    for (int t = 1; t < n_tiles; ++t) {
      float s[64];
      mbar_wait(k_full + k_stage, k_phase);
      turn_wait(wg);
      wgmma_fence();   // acc, rescaled, and pf were written by ordinary code
      start_s(s, k_stage);
      mbar_wait(v_full + v_stage, v_phase);
      start_pv(v_stage);
      turn_pass(wg);

      wgmma_wait<1>();   // S is complete, P V may still run
      wgmma_pin(s);
      if (elected) mbar_arrive(k_empty + k_stage);
      if (++k_stage == kWgStages) {
        k_stage = 0;
        k_phase ^= 1;
      }
      softmax_tile(s, m, l, alpha, scale_log2, t * kWgRows + col0,
                   (t + 1) * kWgRows, kv_len);
      wgmma_wait<0>();
      wgmma_pin(acc);
      if (elected) mbar_arrive(v_empty + v_stage);
      if (++v_stage == kWgStages) {
        v_stage = 0;
        v_phase ^= 1;
      }
      pack_p(pf, s);
      if (alpha[0] != 1.f || alpha[1] != 1.f) {   // a row's max has moved
        #pragma unroll
        for (int i = 0; i < kNV / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
      }
    }
    mbar_wait(v_full + v_stage, v_phase);   // the last tile's P V
    turn_wait(wg);
    wgmma_fence();
    start_pv(v_stage);
    turn_pass(wg);
    wgmma_wait<0>();
    wgmma_pin(acc);

    bf16* ob = o + b * so.b + h * so.h;
    #pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      const int row = row0 + r * 8;
      if (row >= nq) continue;
      const float inv = 1.f / l[r];
      #pragma unroll
      for (int j = 0; j < kNV / 8; ++j) {
        const int col = j * 8 + col0;   // d is a multiple of 8
        if (col < d)
          *reinterpret_cast<__nv_bfloat162*>(ob + (long long)row * so.n + col) =
              __floats2bfloat162_rn(acc[4 * j + 2 * r] * inv,
                                    acc[4 * j + 2 * r + 1] * inv);
      }
      if (lse != nullptr && col0 == 0)
        lse[b * lse_sb + h * lse_sh + row] = m[r] * kLn2 + logf(l[r]);
    }
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
  } else if constexpr (DPAD > 64) {
    constexpr int smem = kBf16SmemBytes<DPAD>;
    const cudaError_t err = allow_smem(flash_attn_fwd_bf16<DPAD>, smem);
    if (err != cudaSuccess) return err;
    flash_attn_fwd_bf16<DPAD><<<grid, kBf16Threads, smem, s>>>(
        static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
        static_cast<const bf16*>(a.v), static_cast<bf16*>(a.o), a.lse, a.nq,
        a.kv_len, a.d, a.scale_log2, a.sq, a.sk, a.sv, a.so, a.lse_sb,
        a.lse_sh);
  } else {
    return cudaErrorInvalidValue;   // bf16 at d <= 64 is launch_wgmma's
  }
  return cudaGetLastError();
}

// One operand's tensor map: (d, token, head, batch) in boxes of 64 columns
// x 128 tokens of one head.
bool attention_map(CUtensorMap* map, const void* base, int d, int tokens,
                   int heads, int batch, const Strides& st) {
  const long long dims[4] = {d, tokens, heads, batch};
  const long long strides[3] = {st.n, st.h, st.b};
  const int box[4] = {64, kWgRows, 1, 1};
  return encode_tensor_map_bf16(map, base, 4, dims, strides, box);
}

template <int KSTEPS>
cudaError_t launch_wgmma(const Args& a, const CUtensorMap& map_q,
                         const CUtensorMap& map_k, const CUtensorMap& map_v,
                         dim3 grid, cudaStream_t s) {
  const cudaError_t err =
      allow_smem(flash_attn_fwd_bf16_wgmma<KSTEPS>, kWgSmemBytes);
  if (err != cudaSuccess) return err;
  flash_attn_fwd_bf16_wgmma<KSTEPS><<<grid, kWgThreads, kWgSmemBytes, s>>>(
      map_q, map_k, map_v, static_cast<bf16*>(a.o), a.lse, a.nq, a.kv_len,
      a.d, a.scale_log2, a.so, a.lse_sb, a.lse_sh);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. d: the head dim, <= 160 and a multiple
// of 4 (float32) or 8 (bfloat16). strides: 12 values, (batch, head, token)
// for q, k, v, o in elements (the head dim is contiguous), multiples of the
// 16-byte vector. lse: float32 [.., Nq] addressed by (lse_sb, lse_sh, 1), or
// null. Returns the cudaError_t of the tensor-map encode or the launch (0 on
// success).
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
  const Args a{q, k, v, o, static_cast<float*>(lse), nq, kv_len, d,
               sm_scale * kLog2e,
               Strides{st[0], st[1], st[2]}, Strides{st[3], st[4], st[5]},
               Strides{st[6], st[7], st[8]}, Strides{st[9], st[10], st[11]},
               lse_sb, lse_sh};
  if (dtype == 1 && d <= 64) {
    CUtensorMap map_q, map_k, map_v;
    if (!attention_map(&map_q, q, d, nq, heads, batch, a.sq) ||
        !attention_map(&map_k, k, d, kv_len, heads, batch, a.sk) ||
        !attention_map(&map_v, v, d, kv_len, heads, batch, a.sv))
      return (int)cudaErrorInvalidValue;
    const dim3 grid((nq + kWgRows - 1) / kWgRows, heads, batch);
    if (d <= 16) return (int)launch_wgmma<1>(a, map_q, map_k, map_v, grid, s);
    if (d <= 32) return (int)launch_wgmma<2>(a, map_q, map_k, map_v, grid, s);
    if (d <= 48) return (int)launch_wgmma<3>(a, map_q, map_k, map_v, grid, s);
    return (int)launch_wgmma<4>(a, map_q, map_k, map_v, grid, s);
  }
  const dim3 grid((nq + kBM - 1) / kBM, heads, batch);
  if (d <= 16) return (int)launch<16>(dtype, a, grid, s);
  if (d <= 32) return (int)launch<32>(dtype, a, grid, s);
  if (d <= 48) return (int)launch<48>(dtype, a, grid, s);
  if (d <= 64) return (int)launch<64>(dtype, a, grid, s);
  if (d <= 80) return (int)launch<80>(dtype, a, grid, s);
  return (int)launch<160>(dtype, a, grid, s);
}
