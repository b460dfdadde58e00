// Flash-attention backward for NVIDIA Hopper (sm_90a), CUDA C++ by hand.
//
// Replaces the two Pallas TPU kernels
//   amodal_depth_anything_tpu/ops/flash_attention.py::_attn_bwd_dq_kernel
//   amodal_depth_anything_tpu/ops/flash_attention.py::_attn_bwd_dkv_kernel
// and computes the same functions over [B, H, N, d] operands, d <= 160. With
// the forward's natural-log LSE per query row and delta = rowsum(dO * O):
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
// Bound on this card: the dQ kernel does 6*B*H*Nq*kv_len*d operations (S,
// dP, dS K), the dK/dV kernel 8*B*H*q_len*kv_len*d (S^T, dP^T, P^T dO, dS^T
// Q), each against about 2*B*H*(Nq+Nk)*d elements read and B*H*N*d (or
// twice that) written: several hundred operations per byte at N = 1370 in
// bfloat16, so both are bound by operations wherever training calls them
// (989 TFLOP/s of bf16 tensor cores; float32 is held to the 67 TFLOP/s of
// the FP32 units outside the tensor cores). Onto a short key set (kv_len <=
// 80: the SD-1.5 UNet's 77 context keys, its mid block's 64 tokens) one pass
// does 10*B*H*Nq*kv_len*d operations against 3*B*H*Nq*d elements moved (q
// and dO read, dq written; K, V, dK and dV are small): 1.7 kv_len
// operations a byte (128 onto 77 keys, under the card's 295), bound by
// bytes.
//
// Design. The TPU kernels keep a whole stream resident in VMEM (K and V in
// the dQ kernel, Q and dO in the dK/dV kernel); a Hopper block has at most
// 227 KB of shared memory, so both kernels here stream tiles of the other
// stream, and keep the TPU split into two kernels so that every output
// element is summed by one thread in a fixed order: no atomics, no second
// pass, the same bits on every run. The dK/dV kernel works on the transposed
// problem, S^T = K Q^T and dP^T = V dO^T, so that the key rows are the
// accumulator rows. Onto a short key set that split reads Q and dO twice,
// computes S and dP twice, and gives dK/dV one block per 64 or 128 key rows
// (64 blocks on 132 SMs at [8,8,4096,40] x 77), each walking all of its
// head's query tiles: there one kernel takes every key in one tile and
// makes one pass over the query rows, dQ whole and dK, dV as partial sums a
// block; a second, small kernel sums the blocks' partial sums in index
// order (still no atomics: the same bits on every run, as the captured
// train steps need). Which kernel runs is a fixed table by dtype, kv_len and
// head dim d (the forward's):
//
//   bfloat16, kv_len <= 80
//                       flash_attn_bwd_bf16_short<KSTEPS, NK>, KSTEPS as the
//                       pair's below (boxes of d columns at 3), NK 16 up to
//                       16 keys and 80 above (kShortKeys, kShortFewKeys),
//                       then flash_attn_bwd_short_sum where a head's query
//                       tiles span several blocks
//   bfloat16, d <= 32   flash_attn_bwd_dq_bf16_wgmma<ceil(d / 16)>,
//                       flash_attn_bwd_dkv_bf16_wgmma<ceil(d / 16), 2>
//   bfloat16, d <= 48   flash_attn_bwd_dq_bf16_wgmma<3>,
//                       flash_attn_bwd_dkv_bf16_wgmma<3, 2> (both on
//                       boxes of d columns)
//   bfloat16, d <= 64   flash_attn_bwd_dq_bf16_wgmma<4>,
//                       flash_attn_bwd_dkv_bf16_wgmma<4, 2>
//   bfloat16, d <= 80   ..._dq_bf16_wgmma<5>, ..._dkv_bf16_wgmma<5, 2>
//   bfloat16, d <= 160  ..._dq_bf16_wgmma<10>, ..._dkv_bf16_wgmma<10, 2>
//   float32,  d <= 160  flash_attn_bwd_{dq,dkv}_f32<DPAD>, DPAD the
//                       smallest of 16, 32, 48, 64, 80, 160 that holds d
//
// (the dK/dV template's second argument counts its consumer warpgroups)
//
//  * bfloat16 on wgmma fed by TMA, the forward's shape. A block is three
//    warpgroups on resident rows (query rows in dQ, key rows in dK/dV) that
//    land once by TMA; one thread of the producer warpgroup (setmaxnreg 40)
//    streams 64-row tiles of the other pair (K and V; Q and dO) into a ring
//    of up to four stages through 4-D tensor maps over (d, token, head,
//    batch). As in the forward, a tile's head dim lies in 64-column boxes of
//    the 128-byte swizzle (one up to d = 64, two at 80, three at 160). Each
//    consumer warpgroup (setmaxnreg 232) owns 64 resident rows, the wgmma M.
//    Per tile: the two score products (S and dP; S^T and dP^T) are KSTEPS
//    wgmma m64n64k16 each with both operands in shared memory, K-major over
//    the head dim; P and dS are rebuilt on the accumulator fragments and,
//    rounded to bfloat16, regrouped in place into m64k16 A fragments for
//    the products that contract over the tile's 64 rows (dS K; P^T dO and
//    dS^T Q): four wgmma m64nNk16, N = 16 * ceil(d / 16) up to 64, then 80
//    and 160, with the streamed tile as the MN-major B operand straight from
//    its [rows, d] boxes (the descriptor's leading byte offset steps from
//    box to box).
//    The two warpgroups take turns on the tensor cores over named barriers,
//    so that one's exponentials run under the other's products. dQ up to
//    d = 80 also overlaps within a warpgroup: tile t's score products go out
//    together with tile t-1's dS K (the dQ accumulator, S, dP and tile
//    t-1's dS fragments: 120 registers a thread at d = 80). dK/dV cannot:
//    its dK and dV accumulators, P^T and dS^T beside the next tile's scores
//    are more registers than ptxas will hold for wgmmas in flight (it
//    serialises every wgmma, C7512: `tools/kernel_ablation.py`,
//    dkv_pipelined), so each of its warpgroups keeps one batch in flight
//    and takes two turns a tile. Up to d = 64 a dK/dV block holds 128 key
//    rows and each warpgroup sums both dK and dV over its 64. Above, both
//    accumulators beside both score tiles are 144 registers a thread at
//    d = 80 and 224 at 160, past what ptxas keeps wgmmas in flight with, so
//    a block holds 64 key rows and splits the work by product (kDkvSplit):
//    one warpgroup computes S^T, P^T and dV += P^T dO and hands P^T
//    (float32) to the other through shared memory, which computes dP^T,
//    dS^T and dK += dS^T Q; two products each a tile, none computed twice.
//    dQ at d = 160 splits the same way (kDqSplit): its accumulator beside S
//    and dP is 144 registers, so a block holds 64 query rows; one warpgroup
//    computes S and P and hands P to the other, which computes dP, dS and
//    dQ += dS K (80 + 32 registers). The first's exponentials run under the
//    second's products and the second's dS under the first's, without
//    turns: one product a tile against two. TMA zero-fills what lies
//    outside the tensor: rows past the maps' ends (kv_len for K and V;
//    q_len for Q and dO in the dK/dV kernel) and the columns from d on; at
//    32 < d <= 48 both kernels read boxes of d columns instead, as the
//    forward does, and zero the columns from d to 48 themselves (dQ's K
//    and V where their keys fill at least half a streamed tile,
//    dq_kv_narrow). In
//    the dK/dV kernel a second producer warp copies each tile's LSE (times
//    log2 e; +inf for rows at or past q_len, so that their P is exactly 0)
//    and delta into the stage beside the tiles, and arrives on the stage's
//    barrier with the TMA bytes; in the dQ kernel the keys at or past
//    kv_len of the last tile are masked by a second instance of the tile
//    body.
//  * bfloat16 onto a short key set (kv_len <= 80), flash_attn_bwd_bf16_short:
//    a block is a score warpgroup (two at 33 <= d <= 48, each on every other
//    tile), a dV and a dK warpgroup over `items` 64-row query tiles of one
//    (batch, head), as few as fill every block the card holds (the
//    forward's rule). K and V land once by TMA and stay (boxes of d columns
//    at KSTEPS 3); Q and dO tiles come by TMA through a ring of up to four
//    stages, refilled by one thread of the dK warpgroup, the last to read a
//    stage (a producer warpgroup would cut every thread to the 128
//    registers of a 512-thread block, too few for the d = 160 sums). A
//    score warpgroup computes, a tile at a time, S = Q K^T and dP = dO V^T
//    (KSTEPS wgmma m64n80k16 / m64n16k16 each), P = exp2(c S - LSE2) and dS
//    = P (dP - delta) in float32 on the fragments (LSE2 = +inf past Nq; keys
//    past kv_len 0), hands P and dS, rounded to bf16 with the rows at or
//    past q_len zeroed, to the other two through a ring of [64 rows, 80
//    keys] tiles in the 128-byte swizzle, and sums dQ = s dS K whole (dS
//    from registers, K the MN-major B), out by TMA store; the LSE and delta
//    of the next tile are read during this tile's products. The dV
//    warpgroup sums dV^T += dO^T P and the dK warpgroup dK^T += Q^T dS over
//    the block's tiles: the head dim as M (one m64 chunk up to d = 64, two
//    at 80, three at 160: 40 registers each onto 80 keys) and the keys as
//    N, both operands MN-major from shared memory (the transpose of A is
//    the dO / Q tile as it landed). Where a head's tiles fit one block it
//    writes dK (times s) and dV itself; otherwise each block writes its
//    float32 partial sums to a workspace the op allocates, [B, H, slabs,
//    keys, head dim], and flash_attn_bwd_short_sum adds them up.
//  * float32: 256 threads, each a 4x4 patch of the score tiles and 4 rows x
//    DPAD/16 columns of the output tiles, scalar FMAs on float32 smem tiles
//    (TF32 would miss the parity bar); 64-row tiles of DPAD + 4 floats, the
//    P^T and dS^T tiles 64 wide: 203 KB of shared memory at DPAD = 160.
//
// Operands are addressed through (batch, head, token) strides with a unit
// stride on the head dim; LSE and delta are contiguous [B, H, Nq] float32.

#include "sm90.cuh"

namespace {

// ------------------------------------------------------------ float32 path

template <int DPAD>
struct BwdF32 : F32Cols<DPAD> {
  static constexpr int kLd = F32Cols<DPAD>::kLd;
  static constexpr int kTile = 64 * kLd;     // floats in a Q, dO, K or V tile
  static constexpr int kDqSmemBytes = 4 * (4 * kTile + 64 * kPLd);  // + dS
  static constexpr int kDkvSmemBytes =
      4 * (4 * kTile + 2 * 64 * kPLd + 2 * 64);   // + P^T, dS^T, stats
};

// out[i][j] = sum_c a[(4ty+i)][c] * b[(tx+16j)][c] over DPAD columns
template <int DPAD>
__device__ __forceinline__ void dot_rows_f32(float out[4][4], const float* a,
                                             const float* b, int ty, int tx) {
  constexpr int kLd = F32Cols<DPAD>::kLd;
  #pragma unroll
  for (int i = 0; i < 4; ++i)
    #pragma unroll
    for (int j = 0; j < 4; ++j) out[i][j] = 0.f;
  #pragma unroll 4
  for (int c = 0; c < DPAD; c += 4) {
    float4 av[4], bv[4];
    #pragma unroll
    for (int i = 0; i < 4; ++i)
      av[i] = *reinterpret_cast<const float4*>(a + (ty * 4 + i) * kLd + c);
    #pragma unroll
    for (int j = 0; j < 4; ++j)
      bv[j] = *reinterpret_cast<const float4*>(b + (tx + 16 * j) * kLd + c);
    #pragma unroll
    for (int i = 0; i < 4; ++i)
      #pragma unroll
      for (int j = 0; j < 4; ++j)
        out[i][j] += av[i].x * bv[j].x + av[i].y * bv[j].y +
                     av[i].z * bv[j].z + av[i].w * bv[j].w;
  }
}

// acc[i][c] += sum_kk x[(4ty+i)][kk] * b[kk][column(c)] over a 64-row tile
// x ([64][kPLd]) and b ([64][kLd]); columns as F32Cols
template <int DPAD>
__device__ __forceinline__ void accum_rows_f32(
    float (&acc)[4][F32Cols<DPAD>::kCols], const float* x, const float* b,
    int ty, int tx) {
  using C = F32Cols<DPAD>;
  #pragma unroll 2
  for (int kk = 0; kk < 64; kk += 4) {
    float4 xv[4];
    #pragma unroll
    for (int i = 0; i < 4; ++i)
      xv[i] = *reinterpret_cast<const float4*>(x + (ty * 4 + i) * kPLd + kk);
    #pragma unroll
    for (int u = 0; u < 4; ++u) {
      float bv[C::kCols];
      #pragma unroll
      for (int g = 0; g < C::kGroups; ++g)
        load_vec<C::kVec>(bv + g * C::kVec,
                          b + (kk + u) * C::kLd + g * 16 * C::kVec +
                              tx * C::kVec);
      #pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float xs = u == 0 ? xv[i].x : u == 1 ? xv[i].y
                       : u == 2 ? xv[i].z : xv[i].w;
        #pragma unroll
        for (int c = 0; c < C::kCols; ++c) acc[i][c] += xs * bv[c];
      }
    }
  }
}

// Store a thread's 4 rows x kCols of an output tile, times `mul`; rows at or
// past `rows` are skipped, rows at or past `live` written as zero, columns
// at or past d (a multiple of 4) skipped.
template <int DPAD>
__device__ __forceinline__ void store_rows_f32(
    float* dst, long long row_stride,
    const float (&acc)[4][F32Cols<DPAD>::kCols], float mul, int row0,
    int rows, int live, int d, int ty, int tx) {
  using C = F32Cols<DPAD>;
  const float zeros[C::kVec] = {};
  #pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty * 4 + i;
    if (row >= rows) continue;
    #pragma unroll
    for (int g = 0; g < C::kGroups; ++g) {
      const int col = g * 16 * C::kVec + tx * C::kVec;
      if (col < d)
        // literal zeros for a dead row: its sums of P = exp(-LSE) terms
        // may have overflowed, and inf * 0 is NaN
        store_vec<C::kVec>(dst + (long long)row * row_stride + col,
                           row < live ? acc[i] + g * C::kVec : zeros,
                           row < live ? mul : 0.f);
    }
  }
}

template <int DPAD>
__global__ void __launch_bounds__(kF32Threads)
flash_attn_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, float* __restrict__ dq,
                      int nq, int kv_len, int d, float sm_scale, Strides sq,
                      Strides sk, Strides sv, Strides sdo, Strides sdq) {
  using T = BwdF32<DPAD>;
  constexpr int kLd = T::kLd;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* dos = qs + T::kTile;
  float* ks = dos + T::kTile;
  float* vs = ks + T::kTile;
  float* dss = vs + T::kTile;

  const int tx = threadIdx.x & 15;   // score cols tx + 16j
  const int ty = threadIdx.x >> 4;   // rows 4ty + i
  const int q0 = blockIdx.x * kBM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const float scale_log2 = sm_scale * kLog2e;

  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  // Q carries sm_scale * log2(e), as in the forward kernel, so that S and
  // the LSE round alike and P = exp2(S - LSE) loses nothing to the scale
  stage_tile_f32<DPAD>(qs, kLd, q + b * sq.b + h * sq.h, sq.n, q0, nq,
                       scale_log2, d);
  stage_tile_f32<DPAD>(dos, kLd, dout + b * sdo.b + h * sdo.h, sdo.n, q0, nq,
                       1.f, d);

  const long long stat0 = ((long long)b * gridDim.y + h) * nq;
  float lse2[4], dl[4], acc[4][T::kCols];
  #pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    lse2[i] = row < nq ? lse[stat0 + row] * kLog2e : 0.f;
    dl[i] = row < nq ? delta[stat0 + row] : 0.f;
    #pragma unroll
    for (int c = 0; c < T::kCols; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < kv_len; k0 += kBN) {
    __syncthreads();  // the previous tile's dS.K is done with ks/dss
    stage_tile_f32<DPAD>(ks, kLd, kb, sk.n, k0, kv_len, 1.f, d);
    stage_tile_f32<DPAD>(vs, kLd, vb, sv.n, k0, kv_len, 1.f, d);
    __syncthreads();

    float s[4][4], dp[4][4];
    dot_rows_f32<DPAD>(s, qs, ks, ty, tx);     // Q K^T
    dot_rows_f32<DPAD>(dp, dos, vs, ty, tx);   // dO V^T
    #pragma unroll
    for (int i = 0; i < 4; ++i)
      #pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = k0 + tx + 16 * j < kv_len
                            ? exp2f(s[i][j] - lse2[i]) : 0.f;
        dss[(ty * 4 + i) * kPLd + tx + 16 * j] = p * (dp[i][j] - dl[i]);
      }
    __syncthreads();
    accum_rows_f32<DPAD>(acc, dss, ks, ty, tx);  // dQ += dS K
  }

  store_rows_f32<DPAD>(dq + b * sdq.b + h * sdq.h, sdq.n, acc, sm_scale, q0,
                       nq, nq, d, ty, tx);
}

template <int DPAD>
__global__ void __launch_bounds__(kF32Threads)
flash_attn_bwd_dkv_f32(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v,
                       const float* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       float* __restrict__ dk, float* __restrict__ dv, int nq,
                       int nk, int q_len, int kv_len, int d, float sm_scale,
                       Strides sq, Strides sk, Strides sv, Strides sdo,
                       Strides sdk, Strides sdv) {
  using T = BwdF32<DPAD>;
  constexpr int kLd = T::kLd;
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);
  float* vs = ks + T::kTile;
  float* qs = vs + T::kTile;
  float* dos = qs + T::kTile;
  float* pts = dos + T::kTile;
  float* dsts = pts + 64 * kPLd;
  float* lses = dsts + 64 * kPLd;   // [64], log2 units
  float* dls = lses + 64;           // [64]

  const int tx = threadIdx.x & 15;   // query cols tx + 16j
  const int ty = threadIdx.x >> 4;   // key rows 4ty + i
  const int k0 = blockIdx.x * kBN;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const float scale_log2 = sm_scale * kLog2e;

  float dka[4][T::kCols], dva[4][T::kCols];
  #pragma unroll
  for (int i = 0; i < 4; ++i)
    #pragma unroll
    for (int c = 0; c < T::kCols; ++c) dka[i][c] = dva[i][c] = 0.f;

  if (k0 < kv_len) {  // key tiles at or past kv_len only write zeros
    const float* qb = q + b * sq.b + h * sq.h;
    const float* dob = dout + b * sdo.b + h * sdo.h;
    const long long stat0 = ((long long)b * gridDim.y + h) * nq;
    stage_tile_f32<DPAD>(ks, kLd, k + b * sk.b + h * sk.h, sk.n, k0, kv_len,
                         1.f, d);
    stage_tile_f32<DPAD>(vs, kLd, v + b * sv.b + h * sv.h, sv.n, k0, kv_len,
                         1.f, d);

    for (int q0 = 0; q0 < q_len; q0 += kBM) {
      __syncthreads();  // the previous tile's products are done with smem
      stage_tile_f32<DPAD>(qs, kLd, qb, sq.n, q0, q_len, scale_log2, d);
      stage_tile_f32<DPAD>(dos, kLd, dob, sdo.n, q0, q_len, 1.f, d);
      if (threadIdx.x < 64) {
        const int row = q0 + threadIdx.x;
        lses[threadIdx.x] = row < q_len ? lse[stat0 + row] * kLog2e : 0.f;
      } else if (threadIdx.x < 128) {
        const int row = q0 + threadIdx.x - 64;
        dls[threadIdx.x - 64] = row < q_len ? delta[stat0 + row] : 0.f;
      }
      __syncthreads();

      float st[4][4], dpt[4][4];
      dot_rows_f32<DPAD>(st, ks, qs, ty, tx);     // K Q^T
      dot_rows_f32<DPAD>(dpt, vs, dos, ty, tx);   // V dO^T
      #pragma unroll
      for (int i = 0; i < 4; ++i)
        #pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j;
          const float p = q0 + c < q_len
                              ? exp2f(st[i][j] - lses[c]) : 0.f;
          pts[(ty * 4 + i) * kPLd + c] = p;
          dsts[(ty * 4 + i) * kPLd + c] = p * (dpt[i][j] - dls[c]);
        }
      __syncthreads();
      accum_rows_f32<DPAD>(dva, pts, dos, ty, tx);   // dV += P^T dO
      accum_rows_f32<DPAD>(dka, dsts, qs, ty, tx);   // dK += dS^T Q
    }
  }

  // the staged Q carried sm_scale * log2(e): dK = ln(2) * dS^T (Q scaled)
  store_rows_f32<DPAD>(dk + b * sdk.b + h * sdk.h, sdk.n, dka, kLn2, k0, nk,
                       kv_len, d, ty, tx);
  store_rows_f32<DPAD>(dv + b * sdv.b + h * sdv.h, sdv.n, dva, 1.f, k0, nk,
                       kv_len, d, ty, tx);
}

// ------------------------------------------- bfloat16 path: wgmma + TMA

constexpr int kWgStream = 64;              // rows of a streamed tile
template <int WGS>                         // WGS consumer warpgroups
constexpr int kWgsThreads = 128 * (WGS + 1);
constexpr int kWgKStepBytes = 16 * kSwizzleRow;   // 16 rows of a tile

// Whether flash_attn_bwd_dkv_bf16_wgmma<KSTEPS> splits its two sums over two
// warpgroups. Up to d = 64 each warpgroup holds both the dK and the dV
// accumulator (8 KSTEPS registers each) beside the two score tiles (64):
// 128 at d = 64. Above, that is 144 registers at d = 80 and 224 at 160, and
// ptxas serialises every wgmma of the kernel (C7512), so one warpgroup
// sums dV and the other dK over the same 64 key rows: 8 KSTEPS + 32 each.
template <int KSTEPS>
constexpr bool kDkvSplit = KSTEPS > 4;

// Whether flash_attn_bwd_dq_bf16_wgmma<KSTEPS> splits its products over two
// warpgroups. Up to d = 80 each warpgroup holds the dQ accumulator (8
// KSTEPS registers), S and dP (64) and the tile before's dS fragments (16)
// with wgmmas in flight: 120 at d = 80. At d = 160 that is 160, and 144
// without the overlap, and ptxas serialises every wgmma (C7512), so one
// warpgroup computes S and P and the other dP, dS and dQ over the same 64
// query rows: 32 and 8 KSTEPS + 32.
template <int KSTEPS>
constexpr bool kDqSplit = KSTEPS > 5;

// The tiles of a wgmma backward block over KSTEPS k16 steps of the head dim:
// two resident operands of kRes rows (Q and dO in dQ, K and V in dK/dV:
// 128 rows, 64 a consumer warpgroup, or 64 rows shared by both warpgroups
// when SPLIT), then a ring of kStages stages, each two streamed 64-row tiles
// (K and V; Q and dO) and a tile's LSE and delta (dK/dV), as many stages as
// fit up to four; each tile kBoxes boxes of 64 head-dim columns. A SPLIT
// block also holds one 64 x 64 float32 P tile (P^T in dK/dV), which its
// first warpgroup hands to its second.
template <int KSTEPS, bool SPLIT, int WGS = 2, bool NARROW = false>
struct BwdTiles {
  static constexpr bool kSplit = SPLIT;
  static constexpr bool kNarrow = NARROW;   // boxes of d columns (sm90.cuh)
  static constexpr int kBoxes = kHeadBoxes<KSTEPS>;
  static constexpr int kRes = SPLIT ? 64 : 64 * WGS;
  static constexpr int kResBox = kRes * 64;         // elements of a box
  static constexpr int kStrBox = kWgStream * 64;
  static constexpr int kResTile = kBoxes * kResBox;
  static constexpr int kStrTile = kBoxes * kStrBox;
  static constexpr int kStageBytes = 2 * 2 * kStrTile + 2 * 64 * 4;
  static constexpr int kPBytes = SPLIT ? 64 * 64 * 4 : 0;
  static constexpr int kRoom =
      kSmemMax - kSwizzleAtom - 11 * 8 - 2 * 2 * kResTile - kPBytes;
  static constexpr int kStages = kRoom / kStageBytes < 4
                                     ? kRoom / kStageBytes : 4;
  static constexpr int kSmemBytes = 2 * 2 * kResTile +
                                    kStages * kStageBytes + kPBytes +
                                    (3 + 2 * kStages) * 8 + kSwizzleAtom;
  // registers a thread: the consumers take what the producer gives away
  // (65536 a block: 40 + 2 x 232 or 32 + 3 x 160 a warpgroup's threads)
  static constexpr int kProducerRegs = WGS == 2 ? 40 : 32;
  static constexpr int kConsumerRegs = WGS == 2 ? 232 : 160;
  static_assert(kStages >= 2 && kSmemBytes <= kSmemMax, "shared memory");
  static_assert(WGS == 2 || !SPLIT, "a split block is two warpgroups");
};

// dQ at KSTEPS 3: whether it reads Q and dO (and K and V, dq_kv_narrow) in
// boxes of d columns, as dK/dV does: a 64-column box over 40 columns makes
// TMA zero-fill 24 columns of every row (`tools/kernel_ablation.py`,
// dq_box64)
constexpr bool kNarrowDqBoxes = true;
// dQ's consumer warpgroups at KSTEPS 3 (each on 64 query rows; three are
// compiled for the 128 registers a thread of a 512-thread block:
// `tools/kernel_ablation.py`, dq_three_warpgroups), two elsewhere
constexpr int kDqNarrowWarpgroups = 2;
template <int KSTEPS>
constexpr int kDqWarpgroups = KSTEPS == 3 ? kDqNarrowWarpgroups : 2;
template <int KSTEPS>
using DqTiles = BwdTiles<KSTEPS, kDqSplit<KSTEPS>, kDqWarpgroups<KSTEPS>,
                         KSTEPS == 3 && kNarrowDqBoxes>;

// dQ's streamed K and V come in boxes of d columns where their keys fill at
// least half a tile (the forward's rule, kv_boxes_narrow): onto DepthFM's 77
// keys, not onto one. The host's maps and the kernel's byte counts and zero
// fill all follow it.
template <typename T>
__host__ __device__ __forceinline__ bool dq_kv_narrow(int kv_len) {
  return T::kNarrow && kv_len >= kWgStream / 2;
}

// dK/dV at KSTEPS 3: whether it reads its operands in boxes of d columns
// (attention_map in sm90.cuh), and its consumer warpgroups (three on 192
// key rows are compiled for the 128 registers a thread of a 512-thread
// block, spill and serialise their wgmmas: C7512, `tools/kernel_ablation.py`,
// dkv_three_warpgroups)
constexpr bool kNarrowBoxes = true;
constexpr int kDkvNarrowWarpgroups = 2;
template <int KSTEPS, int WGS>
using DkvTiles = BwdTiles<KSTEPS, kDkvSplit<KSTEPS>, WGS,
                          KSTEPS == 3 && kNarrowBoxes>;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// An m64n64 score accumulator, rounded to bf16, regrouped into the A
// fragments of four k16 steps: its column tiles 2kk and 2kk + 1 are one
// m64k16 A fragment
__device__ __forceinline__ void pack_a(uint32_t (&f)[4][4],
                                       const float (&s)[32]) {
  #pragma unroll
  for (int i = 0; i < 32; i += 2)
    f[i >> 3][(i >> 1) & 3] = pack_bf16(s[i], s[i + 1]);
}

// s (+)= A B^T over KSTEPS k16 steps of the head dim, both operands K-major
// 128-byte-swizzled tiles in shared memory (A 64 rows, B 64 rows), their
// boxes A_BOX and B_BOX elements apart
template <int KSTEPS, int A_BOX, int B_BOX>
__device__ __forceinline__ void scores(float (&s)[32], const bf16* a,
                                       const bf16* b) {
  const uint64_t da = wgmma_desc(a, 16, kSwizzleAtom);
  const uint64_t db = wgmma_desc(b, 16, kSwizzleAtom);
  #pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk)
    wgmma_ss<0>(s, kstep_desc(da, kk, 2 * A_BOX),
                kstep_desc(db, kk, 2 * B_BOX), kk != 0);
}

// acc += F tile, F the A fragments of a 64 x 64 operand, tile a streamed
// [64 rows, d] tile read as the MN-major B operand (16 rows a k16 step, its
// 64-column boxes LBO apart): N = 16 * KSTEPS columns
template <int KSTEPS>
__device__ __forceinline__ void accumulate(float (&acc)[8 * KSTEPS],
                                           const uint32_t (&f)[4][4],
                                           const bf16* tile) {
  const uint64_t db = wgmma_desc(tile, 2 * kWgStream * 64, kSwizzleAtom);
  #pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs(acc, f[kk], wgmma_desc_advance(db, kk * kWgKStepBytes));
}

// Store a warpgroup's 64 x (16 KSTEPS) accumulator, times `mul`, as bf16
// rows of one (b, h) slice (row0: the thread's first row, as in the
// accumulator layout of sm90.cuh); rows at or past `rows` are skipped, rows
// at or past `live` written as zero, columns from d skipped.
template <int KSTEPS>
__device__ __forceinline__ void store_wg_bf16(bf16* dst, long long row_stride,
                                              const float (&acc)[8 * KSTEPS],
                                              float mul, int row0, int rows,
                                              int live, int d, int col0) {
  #pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r * 8;
    if (row >= rows) continue;
    const bool keep = row < live;   // literal zeros for a dead row
    #pragma unroll
    for (int j = 0; j < 2 * KSTEPS; ++j) {
      const int col = j * 8 + col0;   // d is a multiple of 8
      if (col < d)
        *reinterpret_cast<__nv_bfloat162*>(dst + (long long)row * row_stride +
                                           col) =
            keep ? __floats2bfloat162_rn(acc[4 * j + 2 * r] * mul,
                                         acc[4 * j + 2 * r + 1] * mul)
                 : __floats2bfloat162_rn(0.f, 0.f);
    }
  }
}

// The shared memory of a wgmma backward block (BwdTiles T): the two
// resident tiles, then the ring of stages, each two streamed tiles and 64
// LSE and delta values, the P^T tile of a split block, then the barriers;
// tiles aligned to 1024 bytes (the swizzle pattern is a function of the
// address).
template <typename T>
struct WgSmem {
  bf16* res0;         // Q (dQ) or K (dK/dV)
  bf16* res1;         // dO (dQ) or V (dK/dV)
  bf16* str0;         // [stage]: K (dQ) or Q (dK/dV)
  bf16* str1;         // [stage]: V (dQ) or dO (dK/dV)
  float* lse2;        // [stage][64], log2 units (dK/dV)
  float* dl;          // [stage][64] (dK/dV)
  float4* pt;         // P (dQ) or P^T (dK/dV) of a split block: [8][128],
                      // each consumer thread's 32 accumulator values
  uint64_t* res_full;
  uint64_t* full;     // [stage]
  uint64_t* empty;    // [stage]
  uint64_t* pt_full;  // P written (128 arrivals: the first warpgroup)
  uint64_t* pt_empty; // P read (128 arrivals: the second warpgroup)

  __device__ explicit WgSmem(uint8_t* raw) {
    uint8_t* p = raw + ((kSwizzleAtom - smem_addr(raw)) & (kSwizzleAtom - 1));
    res0 = reinterpret_cast<bf16*>(p);
    res1 = res0 + T::kResTile;
    str0 = res1 + T::kResTile;
    str1 = str0 + T::kStages * T::kStrTile;
    lse2 = reinterpret_cast<float*>(str1 + T::kStages * T::kStrTile);
    dl = lse2 + T::kStages * 64;
    pt = reinterpret_cast<float4*>(dl + T::kStages * 64);
    res_full = reinterpret_cast<uint64_t*>(
        reinterpret_cast<uint8_t*>(pt) + T::kPBytes);
    full = res_full + 1;
    empty = full + T::kStages;
    pt_full = empty + T::kStages;
    pt_empty = pt_full + 1;
  }
};

// The producer thread: the two resident tiles at row r0, then the streamed
// tiles of n_tiles into the ring, each stage once both consumers released
// it (and, for dK/dV, the stats warp has also arrived on `full`); d columns
// a row where the boxes are narrow (the resident ones T::kNarrow, the
// streamed ones str_narrow)
template <typename T>
__device__ __forceinline__ void produce(const WgSmem<T>& sm,
                                        const CUtensorMap* res_map0,
                                        const CUtensorMap* res_map1,
                                        const CUtensorMap* str_map0,
                                        const CUtensorMap* str_map1, int r0,
                                        int n_tiles, int h, int b, int d,
                                        bool str_narrow) {
  const uint32_t res_row = T::kNarrow ? 2 * d : 2 * 64 * T::kBoxes;
  const uint32_t str_row = str_narrow ? 2 * d : 2 * 64 * T::kBoxes;
  tma_prefetch_map(res_map0);
  tma_prefetch_map(res_map1);
  tma_prefetch_map(str_map0);
  tma_prefetch_map(str_map1);
  mbar_arrive_expect_tx(sm.res_full, 2 * T::kRes * res_row);
  tma_load_boxes<T::kBoxes>(sm.res0, T::kResBox, res_map0, sm.res_full, r0,
                            h, b);
  tma_load_boxes<T::kBoxes>(sm.res1, T::kResBox, res_map1, sm.res_full, r0,
                            h, b);
  int stage = 0;
  uint32_t phase = 0;
  for (int t = 0; t < n_tiles; ++t) {
    mbar_wait(sm.empty + stage, phase ^ 1);   // free from the start
    mbar_arrive_expect_tx(sm.full + stage, 2 * kWgStream * str_row);
    tma_load_boxes<T::kBoxes>(sm.str0 + stage * T::kStrTile, T::kStrBox,
                              str_map0, sm.full + stage, t * kWgStream, h, b);
    tma_load_boxes<T::kBoxes>(sm.str1 + stage * T::kStrTile, T::kStrBox,
                              str_map1, sm.full + stage, t * kWgStream, h, b);
    if (++stage == T::kStages) {
      stage = 0;
      phase ^= 1;
    }
  }
}

// The dK/dV kernel's score tile body: P^T = exp2(c S^T - LSE2) in place
// (exactly 0 for query rows at or past q_len, whose LSE2 is +inf), then
// dS^T = P^T (dP^T - delta) in place, the LSE and delta of the tile's query
// columns read from the stage
__device__ __forceinline__ void dkv_tile_p(float (&st)[32], const float* l2,
                                           float c, int col0) {
  #pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 l = *reinterpret_cast<const float2*>(l2 + j * 8 + col0);
    #pragma unroll
    for (int e = 0; e < 4; ++e)
      st[4 * j + e] = ex2(fmaf(st[4 * j + e], c, -((e & 1) ? l.y : l.x)));
  }
}

__device__ __forceinline__ void dkv_tile_ds(float (&dpt)[32],
                                            const float (&pt)[32],
                                            const float* dl, int col0) {
  #pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 dd = *reinterpret_cast<const float2*>(dl + j * 8 + col0);
    #pragma unroll
    for (int e = 0; e < 4; ++e)
      dpt[4 * j + e] =
          pt[4 * j + e] * (dpt[4 * j + e] - ((e & 1) ? dd.y : dd.x));
  }
}

// The two warpgroups of a split dK/dV block (T::kSplit) over its 64 key rows,
// each with one accumulator and one score tile (8 KSTEPS + 32 registers):
// the dV warpgroup computes S^T = K Q^T, P^T and dV += P^T dO, and hands
// P^T, float32 as the accumulator holds it, to the dK warpgroup through
// shared memory (thread i of one warpgroup holds the same elements as
// thread i of the other); the dK warpgroup computes dP^T = V dO^T, dS^T =
// P^T (dP^T - delta) and dK += dS^T Q. Each takes two turns a tile, one
// for its score product and one for its accumulating product.
template <int KSTEPS, typename T>
__device__ __forceinline__ void dkv_split_dv(float (&acc)[8 * KSTEPS],
                                             const WgSmem<T>& sm,
                                             int n_tiles, float c, int col0,
                                             bool elected) {
  const int i = threadIdx.x & 127;
  int stage = 0;
  uint32_t phase = 0;
  for (int t = 0; t < n_tiles; ++t) {
    float st[32];
    uint32_t pf[4][4];   // P^T in bf16
    mbar_wait(sm.full + stage, phase);
    turn_wait(0);
    wgmma_fence();
    scores<KSTEPS, T::kResBox, T::kStrBox>(st, sm.res0,
                                           sm.str0 + stage * T::kStrTile);
    wgmma_commit();
    turn_pass(0);
    wgmma_wait<0>();
    wgmma_pin(st);
    dkv_tile_p(st, sm.lse2 + stage * 64, c, col0);
    mbar_wait(sm.pt_empty, (t & 1) ^ 1);   // free from the start
    #pragma unroll
    for (int j = 0; j < 8; ++j)
      sm.pt[j * 128 + i] = make_float4(st[4 * j], st[4 * j + 1],
                                       st[4 * j + 2], st[4 * j + 3]);
    mbar_arrive(sm.pt_full);
    pack_a(pf, st);
    turn_wait(0);
    wgmma_fence();   // pf was written by ordinary code
    accumulate<KSTEPS>(acc, pf, sm.str1 + stage * T::kStrTile);
    wgmma_commit();
    turn_pass(0);
    wgmma_wait<0>();   // the stage is free
    wgmma_pin(acc);
    if (elected) mbar_arrive(sm.empty + stage);
    if (++stage == T::kStages) {
      stage = 0;
      phase ^= 1;
    }
  }
}

template <int KSTEPS, typename T>
__device__ __forceinline__ void dkv_split_dk(float (&acc)[8 * KSTEPS],
                                             const WgSmem<T>& sm,
                                             int n_tiles, int col0,
                                             bool elected) {
  const int i = threadIdx.x & 127;
  int stage = 0;
  uint32_t phase = 0;
  for (int t = 0; t < n_tiles; ++t) {
    float dpt[32];
    uint32_t dsf[4][4];   // dS^T in bf16
    mbar_wait(sm.full + stage, phase);
    turn_wait(1);
    wgmma_fence();
    scores<KSTEPS, T::kResBox, T::kStrBox>(dpt, sm.res1,
                                           sm.str1 + stage * T::kStrTile);
    wgmma_commit();
    turn_pass(1);
    wgmma_wait<0>();
    wgmma_pin(dpt);
    // dS^T = P^T (dP^T - delta), P^T read four values at a time, so that
    // no second tile of registers is live beside dP^T and dK
    mbar_wait(sm.pt_full, t & 1);
    #pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float4 p = sm.pt[j * 128 + i];
      const float2 dd = *reinterpret_cast<const float2*>(
          sm.dl + stage * 64 + j * 8 + col0);
      dpt[4 * j] = p.x * (dpt[4 * j] - dd.x);
      dpt[4 * j + 1] = p.y * (dpt[4 * j + 1] - dd.y);
      dpt[4 * j + 2] = p.z * (dpt[4 * j + 2] - dd.x);
      dpt[4 * j + 3] = p.w * (dpt[4 * j + 3] - dd.y);
    }
    mbar_arrive(sm.pt_empty);
    pack_a(dsf, dpt);
    turn_wait(1);
    wgmma_fence();   // dsf was written by ordinary code
    accumulate<KSTEPS>(acc, dsf, sm.str0 + stage * T::kStrTile);
    wgmma_commit();
    turn_pass(1);
    wgmma_wait<0>();   // the stage is free
    wgmma_pin(acc);
    if (elected) mbar_arrive(sm.empty + stage);
    if (++stage == T::kStages) {
      stage = 0;
      phase ^= 1;
    }
  }
}

template <int KSTEPS,   // k16 steps over the head dim: ceil(d / 16) up to 4,
                        // then 5 or 10
          int WGS>      // consumer warpgroups: 2, or 3 (KSTEPS 3, joint)
__global__ void __launch_bounds__(kWgsThreads<WGS>, 1)
flash_attn_bwd_dkv_bf16_wgmma(const __grid_constant__ CUtensorMap map_q,
                              const __grid_constant__ CUtensorMap map_k,
                              const __grid_constant__ CUtensorMap map_v,
                              const __grid_constant__ CUtensorMap map_do,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              bf16* __restrict__ dk, bf16* __restrict__ dv,
                              int nq, int nk, int q_len, int kv_len, int d,
                              float sm_scale, Strides sdk, Strides sdv) {
  using T = DkvTiles<KSTEPS, WGS>;
  extern __shared__ uint8_t smem_raw[];
  const WgSmem<T> sm(smem_raw);
  const int k0 = blockIdx.x * T::kRes;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int wg = threadIdx.x >> 7;
  const int lane = threadIdx.x & 31;
  // per consumer thread: key rows row0 and row0 + 8; in each 8-wide column
  // tile, columns col0 and col0 + 1 (the accumulator layout, sm90.cuh); a
  // split block's two warpgroups share its 64 key rows
  const int row0 = k0 + (T::kSplit ? 0 : wg * 64) +
                   ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
  const int col0 = 2 * (lane & 3);
  // warpgroup 0 stores dV, 1 dK when split; each both otherwise
  const bool stores_dk = !T::kSplit || wg == 1;
  const bool stores_dv = !T::kSplit || wg == 0;

  if (k0 >= kv_len) {   // key rows at or past kv_len only write zeros
    if (wg < WGS) {
      const float zero[8 * KSTEPS] = {};
      if (stores_dk)
        store_wg_bf16<KSTEPS>(dk + b * sdk.b + h * sdk.h, sdk.n, zero, 0.f,
                              row0, nk, 0, d, col0);
      if (stores_dv)
        store_wg_bf16<KSTEPS>(dv + b * sdv.b + h * sdv.h, sdv.n, zero, 0.f,
                              row0, nk, 0, d, col0);
    }
    return;
  }

  if (threadIdx.x == 0) {
    mbar_init(sm.res_full, 1);
    for (int s = 0; s < T::kStages; ++s) {
      // the TMA thread's arrive (the bytes come with it) and the stats
      // warp's 32 lanes
      mbar_init(sm.full + s, 1 + 32);
      mbar_init(sm.empty + s, WGS);   // one thread of each consumer warpgroup
    }
    if (T::kSplit) {
      mbar_init(sm.pt_full, 128);
      mbar_init(sm.pt_empty, 128);
    }
    mbar_init_fence();
  }
  __syncthreads();
  const int n_tiles = (q_len + kWgStream - 1) / kWgStream;

  if (wg == WGS) {
    // ------------------------------------------------------------ producer
    setmaxnreg_dec<T::kProducerRegs>();
    const int warp = (threadIdx.x >> 5) & 3;
    if (threadIdx.x == WGS * 128) {
      produce(sm, &map_k, &map_v, &map_q, &map_do, k0, n_tiles, h, b, d,
              T::kNarrow);
    } else if (warp == 1) {
      // the stats warp: each tile's LSE (in log2 units; +inf for query rows
      // at or past q_len) and delta into the stage
      const long long stat0 = ((long long)b * gridDim.y + h) * nq;
      int stage = 0;
      uint32_t phase = 0;
      for (int t = 0; t < n_tiles; ++t) {
        mbar_wait(sm.empty + stage, phase ^ 1);
        #pragma unroll
        for (int r = lane; r < 64; r += 32) {
          const int row = t * kWgStream + r;
          const bool live = row < q_len;
          sm.lse2[stage * 64 + r] =
              live ? lse[stat0 + row] * kLog2e : INFINITY;
          sm.dl[stage * 64 + r] = live ? delta[stat0 + row] : 0.f;
        }
        mbar_arrive(sm.full + stage);
        if (++stage == T::kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    setmaxnreg_inc<T::kConsumerRegs>();
    if (T::kNarrow) {
      // A narrow box brings d columns: the k16 steps' columns from d on
      // are zeros written here once, while the first loads are under way
      // (K and V, and Q and dO in the stages in use).
      const int used = min(n_tiles, T::kStages) * kWgStream;
      zero_chunks(sm.res0, 2 * T::kRes, d / 8, 2 * KSTEPS, threadIdx.x,
                  128 * WGS);
      zero_chunks(sm.str0, used, d / 8, 2 * KSTEPS, threadIdx.x, 128 * WGS);
      zero_chunks(sm.str1, used, d / 8, 2 * KSTEPS, threadIdx.x, 128 * WGS);
      fence_proxy_async();
      consumers_sync<WGS>();
    }
    const bool elected = (threadIdx.x & 127) == 0;
    const float c = sm_scale * kLog2e;

    if (wg == WGS - 1) turn_pass<WGS>(wg);   // warpgroup 0 goes first
    mbar_wait(sm.res_full, 0);
    if constexpr (T::kSplit) {
      float acc[8 * KSTEPS];
      #pragma unroll
      for (int i = 0; i < 8 * KSTEPS; ++i) acc[i] = 0.f;
      if (wg == 1) {
        dkv_split_dk<KSTEPS>(acc, sm, n_tiles, col0, elected);
        store_wg_bf16<KSTEPS>(dk + b * sdk.b + h * sdk.h, sdk.n, acc,
                              sm_scale, row0, nk, kv_len, d, col0);
      } else {
        dkv_split_dv<KSTEPS>(acc, sm, n_tiles, c, col0, elected);
        store_wg_bf16<KSTEPS>(dv + b * sdv.b + h * sdv.h, sdv.n, acc, 1.f,
                              row0, nk, kv_len, d, col0);
      }
    } else {
      const bf16* kw = sm.res0 + wg * 64 * 64;   // this warpgroup's key rows
      const bf16* vw = sm.res1 + wg * 64 * 64;
      float dka[8 * KSTEPS], dva[8 * KSTEPS];
      #pragma unroll
      for (int i = 0; i < 8 * KSTEPS; ++i) dka[i] = dva[i] = 0.f;

      // A tile is two batches of wgmmas: S^T = K Q^T and dP^T = V dO^T,
      // then dV += P^T dO and dK += dS^T Q, each batch on a turn of its
      // own, so that one warpgroup's exponentials run under the other's
      // products. Only one batch is in flight per warpgroup: tile t's score
      // accumulators beside tile t-1's accumulating products would need
      // more registers than ptxas has and it would serialise every wgmma
      // (C7512).
      int stage = 0;
      uint32_t phase = 0;
      for (int t = 0; t < n_tiles; ++t) {
        float st[32], dpt[32];
        mbar_wait(sm.full + stage, phase);
        turn_wait(wg);
        wgmma_fence();
        scores<KSTEPS, T::kResBox, T::kStrBox>(st, kw,
                                               sm.str0 + stage * T::kStrTile);
        wgmma_commit();
        scores<KSTEPS, T::kResBox, T::kStrBox>(dpt, vw,
                                               sm.str1 + stage * T::kStrTile);
        wgmma_commit();
        turn_pass<WGS>(wg);
        wgmma_wait<1>();   // S^T is complete, dP^T may still run
        wgmma_pin(st);
        dkv_tile_p(st, sm.lse2 + stage * 64, c, col0);
        wgmma_wait<0>();
        wgmma_pin(dpt);
        dkv_tile_ds(dpt, st, sm.dl + stage * 64, col0);
        uint32_t pf[4][4], dsf[4][4];   // P^T and dS^T in bf16
        pack_a(pf, st);
        pack_a(dsf, dpt);

        turn_wait(wg);
        wgmma_fence();   // pf, dsf were written by ordinary code
        accumulate<KSTEPS>(dva, pf, sm.str1 + stage * T::kStrTile);
        accumulate<KSTEPS>(dka, dsf, sm.str0 + stage * T::kStrTile);
        wgmma_commit();
        turn_pass<WGS>(wg);
        wgmma_wait<0>();   // the stage is free
        wgmma_pin(dka);
        wgmma_pin(dva);
        if (elected) mbar_arrive(sm.empty + stage);
        if (++stage == T::kStages) {
          stage = 0;
          phase ^= 1;
        }
      }

      store_wg_bf16<KSTEPS>(dk + b * sdk.b + h * sdk.h, sdk.n, dka, sm_scale,
                            row0, nk, kv_len, d, col0);
      store_wg_bf16<KSTEPS>(dv + b * sdv.b + h * sdv.h, sdv.n, dva, 1.f,
                            row0, nk, kv_len, d, col0);
    }
  }
}

// The dQ kernel's P on a score tile: P = exp2(c S - LSE2) in place; in a
// RAGGED tile (the last one, when kv_len is no multiple of 64) keys at or
// past kv_len get P = 0.
template <bool RAGGED>
__device__ __forceinline__ void dq_tile_p(float (&s)[32],
                                          const float (&lse2)[2], float c,
                                          int key0, int kv_len) {
  #pragma unroll
  for (int i = 0; i < 32; ++i) {
    float p = ex2(fmaf(s[i], c, -lse2[(i >> 1) & 1]));
    if (RAGGED && key0 + (i >> 2) * 8 + (i & 1) >= kv_len) p = 0.f;
    s[i] = p;
  }
}

// The dQ kernel's score tile body: P in place of S, as dq_tile_p, and dS =
// P (dP - delta) in place of dP
template <bool RAGGED>
__device__ __forceinline__ void dq_tile(float (&s)[32], float (&dp)[32],
                                        const float (&lse2)[2],
                                        const float (&dl)[2], float c,
                                        int key0, int kv_len) {
  dq_tile_p<RAGGED>(s, lse2, c, key0, kv_len);
  #pragma unroll
  for (int i = 0; i < 32; ++i) dp[i] = s[i] * (dp[i] - dl[(i >> 1) & 1]);
}

// A consumer warpgroup of a dQ block that is not split, over its own 64
// query rows (qw, dow: its rows of Q and dO): tile t's S = Q K^T and dP =
// dO V^T go out together with tile t-1's dQ += dS K, so that tile t's
// exponentials run under that product (the registers allow it here, unlike
// in the dK/dV kernel), each batch on a turn of its own.
template <int KSTEPS, typename T, int WGS = kDqWarpgroups<KSTEPS>>
__device__ __forceinline__ void dq_joint(float (&acc)[8 * KSTEPS],
                                         const WgSmem<T>& sm, const bf16* qw,
                                         const bf16* dow, int wg, int n_tiles,
                                         const float (&lse2)[2],
                                         const float (&dl)[2], float c,
                                         int col0, int kv_len,
                                         bool elected) {
  constexpr int kA = T::kResBox, kB = T::kStrBox;
  uint32_t dsf[4][4];   // the tile before's dS, bf16
  const auto tile = [&](float (&s)[32], float (&dp)[32], int t) {
    if ((t + 1) * kWgStream > kv_len)
      dq_tile<true>(s, dp, lse2, dl, c, t * kWgStream + col0, kv_len);
    else
      dq_tile<false>(s, dp, lse2, dl, c, t * kWgStream + col0, kv_len);
  };
  if (wg == WGS - 1) turn_pass<WGS>(wg);   // warpgroup 0 goes first
  {   // tile 0: nothing to overlap with yet
    float s[32], dp[32];
    mbar_wait(sm.full, 0);
    turn_wait(wg);
    wgmma_fence();
    scores<KSTEPS, kA, kB>(s, qw, sm.str0);
    wgmma_commit();
    scores<KSTEPS, kA, kB>(dp, dow, sm.str1);
    wgmma_commit();
    turn_pass<WGS>(wg);
    wgmma_wait<0>();
    wgmma_pin(s);
    wgmma_pin(dp);
    tile(s, dp, 0);
    pack_a(dsf, dp);
  }
  int prev = 0, stage = 1 % T::kStages;
  uint32_t phase = T::kStages == 1;
  for (int t = 1; t < n_tiles; ++t) {
    float s[32], dp[32];
    mbar_wait(sm.full + stage, phase);
    turn_wait(wg);
    wgmma_fence();   // dsf was written by ordinary code
    scores<KSTEPS, kA, kB>(s, qw, sm.str0 + stage * T::kStrTile);
    wgmma_commit();
    scores<KSTEPS, kA, kB>(dp, dow, sm.str1 + stage * T::kStrTile);
    wgmma_commit();
    accumulate<KSTEPS>(acc, dsf, sm.str0 + prev * T::kStrTile);
    wgmma_commit();
    turn_pass<WGS>(wg);

    wgmma_wait<1>();   // S and dP are complete, dS K may still run
    wgmma_pin(s);
    wgmma_pin(dp);
    tile(s, dp, t);
    wgmma_wait<0>();   // tile t-1's dS K: its stage is free
    wgmma_pin(acc);
    if (elected) mbar_arrive(sm.empty + prev);
    pack_a(dsf, dp);
    prev = stage;
    if (++stage == T::kStages) {
      stage = 0;
      phase ^= 1;
    }
  }
  turn_wait(wg);   // the last tile's dS K
  wgmma_fence();
  accumulate<KSTEPS>(acc, dsf, sm.str0 + prev * T::kStrTile);
  wgmma_commit();
  turn_pass<WGS>(wg);
  wgmma_wait<0>();
  wgmma_pin(acc);
}

// The two warpgroups of a split dQ block (T::kSplit) over its 64 query rows:
// the P warpgroup computes S = Q K^T and P, and hands P, float32 as the
// accumulator holds it, to the dS warpgroup through shared memory (thread i
// of one warpgroup holds the same elements as thread i of the other); the
// dS warpgroup computes dP = dO V^T, dS = P (dP - delta) and dQ += dS K.
// The first runs one product a tile and the second two, so neither waits
// for turns: the first's exponentials run under the second's products and
// the second's dS under the first's S.
template <int KSTEPS, typename T>
__device__ __forceinline__ void dq_split_p(const WgSmem<T>& sm, int n_tiles,
                                           const float (&lse2)[2], float c,
                                           int col0, int kv_len,
                                           bool elected) {
  const int i = threadIdx.x & 127;
  int stage = 0;
  uint32_t phase = 0;
  for (int t = 0; t < n_tiles; ++t) {
    float s[32];
    mbar_wait(sm.full + stage, phase);
    wgmma_fence();
    scores<KSTEPS, T::kResBox, T::kStrBox>(s, sm.res0,
                                           sm.str0 + stage * T::kStrTile);
    wgmma_commit();
    wgmma_wait<0>();   // done with the stage's K
    wgmma_pin(s);
    if (elected) mbar_arrive(sm.empty + stage);
    if ((t + 1) * kWgStream > kv_len)
      dq_tile_p<true>(s, lse2, c, t * kWgStream + col0, kv_len);
    else
      dq_tile_p<false>(s, lse2, c, t * kWgStream + col0, kv_len);
    mbar_wait(sm.pt_empty, (t & 1) ^ 1);   // free from the start
    #pragma unroll
    for (int j = 0; j < 8; ++j)
      sm.pt[j * 128 + i] = make_float4(s[4 * j], s[4 * j + 1], s[4 * j + 2],
                                       s[4 * j + 3]);
    mbar_arrive(sm.pt_full);
    if (++stage == T::kStages) {
      stage = 0;
      phase ^= 1;
    }
  }
}

template <int KSTEPS, typename T>
__device__ __forceinline__ void dq_split_ds(float (&acc)[8 * KSTEPS],
                                            const WgSmem<T>& sm, int n_tiles,
                                            const float (&dl)[2],
                                            bool elected) {
  const int i = threadIdx.x & 127;
  int stage = 0;
  uint32_t phase = 0;
  for (int t = 0; t < n_tiles; ++t) {
    float dp[32];
    uint32_t dsf[4][4];   // dS in bf16
    mbar_wait(sm.full + stage, phase);
    wgmma_fence();
    scores<KSTEPS, T::kResBox, T::kStrBox>(dp, sm.res1,
                                           sm.str1 + stage * T::kStrTile);
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_pin(dp);
    // dS = P (dP - delta), P read four values at a time, so that no second
    // tile of registers is live beside dP and dQ
    mbar_wait(sm.pt_full, t & 1);
    #pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float4 p = sm.pt[j * 128 + i];
      dp[4 * j] = p.x * (dp[4 * j] - dl[0]);
      dp[4 * j + 1] = p.y * (dp[4 * j + 1] - dl[0]);
      dp[4 * j + 2] = p.z * (dp[4 * j + 2] - dl[1]);
      dp[4 * j + 3] = p.w * (dp[4 * j + 3] - dl[1]);
    }
    mbar_arrive(sm.pt_empty);
    pack_a(dsf, dp);
    wgmma_fence();   // dsf was written by ordinary code
    accumulate<KSTEPS>(acc, dsf, sm.str0 + stage * T::kStrTile);   // dS K
    wgmma_commit();
    wgmma_wait<0>();   // the stage is free
    wgmma_pin(acc);
    if (elected) mbar_arrive(sm.empty + stage);
    if (++stage == T::kStages) {
      stage = 0;
      phase ^= 1;
    }
  }
}

template <int KSTEPS>   // k16 steps over the head dim: ceil(d / 16) up to 4,
                        // then 5 or 10
__global__ void __launch_bounds__(kWgsThreads<kDqWarpgroups<KSTEPS>>, 1)
flash_attn_bwd_dq_bf16_wgmma(const __grid_constant__ CUtensorMap map_q,
                             const __grid_constant__ CUtensorMap map_k,
                             const __grid_constant__ CUtensorMap map_v,
                             const __grid_constant__ CUtensorMap map_do,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             bf16* __restrict__ dq, int nq, int kv_len, int d,
                             float sm_scale, Strides sdq) {
  using T = DqTiles<KSTEPS>;
  constexpr int WGS = kDqWarpgroups<KSTEPS>;
  extern __shared__ uint8_t smem_raw[];
  const WgSmem<T> sm(smem_raw);

  if (threadIdx.x == 0) {
    mbar_init(sm.res_full, 1);
    for (int s = 0; s < T::kStages; ++s) {
      mbar_init(sm.full + s, 1);      // the producer's arrive; TMA adds bytes
      mbar_init(sm.empty + s, WGS);   // one thread of each consumer warpgroup
    }
    if (T::kSplit) {
      mbar_init(sm.pt_full, 128);
      mbar_init(sm.pt_empty, 128);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int q0 = blockIdx.x * T::kRes;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int n_tiles = (kv_len + kWgStream - 1) / kWgStream;
  const int wg = threadIdx.x >> 7;

  if (wg == WGS) {
    // ------------------------------------------------------------ producer
    setmaxnreg_dec<T::kProducerRegs>();
    if (threadIdx.x == WGS * 128)
      produce(sm, &map_q, &map_do, &map_k, &map_v, q0, n_tiles, h, b, d,
              dq_kv_narrow<T>(kv_len));
  } else {
    // ----------------------------------------------------------- consumers
    setmaxnreg_inc<T::kConsumerRegs>();
    if (T::kNarrow) {
      // A narrow box brings d columns: the k16 steps' columns from d on
      // are zeros written here once, while the first loads are under way
      // (Q and dO, and K and V in the stages in use where they are
      // narrow).
      constexpr int kThreads = 128 * WGS;
      zero_chunks(sm.res0, 2 * T::kRes, d / 8, 2 * KSTEPS, threadIdx.x,
                  kThreads);
      if (dq_kv_narrow<T>(kv_len)) {
        const int used = min(n_tiles, T::kStages) * kWgStream;
        zero_chunks(sm.str0, used, d / 8, 2 * KSTEPS, threadIdx.x, kThreads);
        zero_chunks(sm.str1, used, d / 8, 2 * KSTEPS, threadIdx.x, kThreads);
      }
      fence_proxy_async();
      consumers_sync<WGS>();
    }
    const int lane = threadIdx.x & 31;
    // per thread: query rows row0 and row0 + 8; in each 8-wide column tile,
    // key columns col0 and col0 + 1 (the accumulator layout, sm90.cuh); a
    // split block's two warpgroups share its 64 query rows
    const int row0 = q0 + (T::kSplit ? 0 : wg * 64) +
                     ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
    const int col0 = 2 * (lane & 3);
    const bool elected = (threadIdx.x & 127) == 0;
    const float c = sm_scale * kLog2e;

    const long long stat0 = ((long long)b * gridDim.y + h) * nq;
    float lse2[2], dl[2];
    #pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + r * 8;   // rows past nq are never stored
      lse2[r] = row < nq ? lse[stat0 + row] * kLog2e : 0.f;
      dl[r] = row < nq ? delta[stat0 + row] : 0.f;
    }
    float acc[8 * KSTEPS];
    #pragma unroll
    for (int i = 0; i < 8 * KSTEPS; ++i) acc[i] = 0.f;

    mbar_wait(sm.res_full, 0);
    if constexpr (T::kSplit) {
      if (wg == 0) {   // the P warpgroup stores nothing
        dq_split_p<KSTEPS>(sm, n_tiles, lse2, c, col0, kv_len, elected);
        return;
      }
      dq_split_ds<KSTEPS>(acc, sm, n_tiles, dl, elected);
    } else {
      dq_joint<KSTEPS>(acc, sm, sm.res0 + wg * 64 * 64,
                       sm.res1 + wg * 64 * 64, wg, n_tiles, lse2, dl, c, col0,
                       kv_len, elected);
    }
    store_wg_bf16<KSTEPS>(dq + b * sdq.b + h * sdq.h, sdq.n, acc, sm_scale,
                          row0, nq, nq, d, col0);
  }
}

// ----------------- bfloat16 onto a short key set: one pass, then a sum

// kv_len up to kShortKeys runs flash_attn_bwd_bf16_short<KSTEPS, NK>, then
// flash_attn_bwd_short_sum: every key in one tile of NK keys, 16 up to
// kShortFewKeys and 80 above (the forward's cut and tiles: DepthFM's 77
// context keys and the UNet mid block's 64 tokens). Each choice below has
// an ablation in `tools/kernel_ablation.py`.
constexpr int kShortKeys = 80, kShortFewKeys = 16;
// dV^T = dO^T P and dK^T = Q^T dS: the head dim as the wgmma M (one to
// three m64 chunks, N = NK keys: 40 registers a chunk), not the keys (two
// m64 chunks for 80 keys, N = the head dim: 8 KSTEPS registers each)
constexpr bool kShortDRows = true;
constexpr int kShortQStages = 4;     // Q/dO tiles in flight, at most
constexpr int kShortPStages = 2;     // P/dS tiles in flight, at most
constexpr bool kShortNarrow = true;  // boxes of d columns at KSTEPS 3
// Score warpgroups a block, each on every other tile: two at KSTEPS 3 (d
// 33-48, the UNet's 40), one elsewhere. A tile's path through one
// warpgroup is a chain of waits (loads, products, hand-overs) whose parts
// taken out alone gain little (`tools/kernel_ablation.py`, bwd_short_no_*),
// so two chains interleave; ptxas compiles every thread of a block for
// 65536 / threads registers, and the 128 of four warpgroups hold the
// scores at KSTEPS 3 (128), not at 1 and 2 (134 and 137 a thread: a
// spill), nor above (162 at d = 80), nor the d = 160 sums' 120
// accumulators. No producer warpgroup, for the same reason: the dK
// warpgroup, the last to read a Q / dO stage, refills it.
constexpr bool kShortTwoScores = true;
template <int KSTEPS>
constexpr int kShortScores = KSTEPS == 3 && kShortTwoScores ? 2 : 1;

// The shared memory of flash_attn_bwd_bf16_short<KSTEPS, NK>: K and V (NK
// rows, resident), a ring of kQStages Q and dO tiles (64 rows), a ring of
// kPStages P and dS tiles ([64 query rows, NK keys] in 64-key boxes, bf16:
// the MN-major B of the sums), each score warpgroup's dQ tile for its TMA
// stores, then the barriers.
// Each Q, dO, K, V or dQ tile is kBoxes boxes of 64 head-dim columns, every
// box 1024-byte aligned. The rings take what K, V and the dQ tiles leave:
// two P stages where that keeps two Q stages, Q stages up to kShortQStages
// (4, 3 and 2 at d <= 64, 80 and 160 onto 80 keys). With two score
// warpgroups both rings hold a multiple of two stages, so that a stage
// serves one of them: a warpgroup then waits on a stage's barriers at
// most one phase ahead, where a parity wait cannot mistake an older phase
// for the one it waits for.
template <int KSTEPS, int NK>
struct ShortBwd {
  static constexpr int kScores = kShortScores<KSTEPS>;
  static constexpr int kWgs = kScores + 2;   // + the dV and dK warpgroups
  static constexpr int kThreads = 128 * kWgs;
  static constexpr int kBoxes = kHeadBoxes<KSTEPS>;
  static constexpr int kPBoxes = (NK + 63) / 64;
  static constexpr bool kNarrow = KSTEPS == 3 && kShortNarrow;
  static constexpr int kQBox = 64 * 64;      // elements of a 64-row box
  static constexpr int kKVBox = NK * 64;
  static constexpr int kQTile = kBoxes * kQBox;
  static constexpr int kKVTile = kBoxes * kKVBox;
  static constexpr int kPTile = kPBoxes * kQBox;
  static constexpr int kRows = 16 * KSTEPS;  // head-dim rows of a partial sum
  // a sum warpgroup's accumulators: kChunks m64 chunks of M (head dim or
  // keys), each m64nkN
  static constexpr int kChunks = kShortDRows ? kBoxes : kPBoxes;
  static constexpr int kN = kShortDRows ? NK : 16 * KSTEPS;
  static constexpr int kQStageBytes = 2 * 2 * kQTile;   // Q and dO
  static constexpr int kPStageBytes = 2 * 2 * kPTile;   // P and dS
  static constexpr int kFixed =   // K, V, a dQ tile a score warpgroup
      2 * 2 * kKVTile + kScores * 2 * kQTile + 256 + kSwizzleAtom;
  static constexpr int kRoom = kSmemMax - kFixed;
  static constexpr int kPFit =
      (kRoom - kShortPStages * kPStageBytes) / kQStageBytes >= 2
          ? kShortPStages : 1;
  static constexpr int kPStages = kPFit / kScores * kScores > 0
                                      ? kPFit / kScores * kScores : kScores;
  static constexpr int kQMax = (kRoom - kPStages * kPStageBytes) /
                               kQStageBytes;
  static constexpr int kQFit = kQMax < kShortQStages ? kQMax : kShortQStages;
  static constexpr int kQStages = kQFit / kScores * kScores > 0
                                      ? kQFit / kScores * kScores : kScores;
  static constexpr int kSmemBytes =
      kFixed + kQStages * kQStageBytes + kPStages * kPStageBytes;
  static_assert(kQStages >= 1 && kSmemBytes <= kSmemMax, "shared memory");
  static_assert(kQStages % kScores == 0 && kPStages % kScores == 0,
                "a stage serves one score warpgroup");
};

// the 128 threads of score warpgroup w meet (named barrier 8 + w; 4 or 5
// is consumers_sync's)
__device__ __forceinline__ void score_sync(int w) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(8 + w) : "memory");
}

// An m64nN accumulator (N / 2 values a thread), rounded to bf16, as the A
// fragments of N / 16 k16 steps: its column tiles 2kk and 2kk + 1 are one
// m64k16 A fragment (pack_a for any N)
template <int N>
__device__ __forceinline__ void pack_frags(uint32_t (&f)[N / 16][4],
                                           const float (&s)[N / 2]) {
  #pragma unroll
  for (int i = 0; i < N / 2; i += 2)
    f[i >> 3][(i >> 1) & 3] = pack_bf16(s[i], s[i + 1]);
}

// Those fragments into a [64 rows, N columns] tile of 64-column boxes in the
// 128-byte swizzle (the thread's rows rsub and rsub + 8, its columns col0
// and col0 + 1 of each 8-wide column tile), zeros for a row whose keep is
// false
template <int N>
__device__ __forceinline__ void store_frags(bf16* tile,
                                            const uint32_t (&f)[N / 16][4],
                                            int rsub, int col0,
                                            const bool (&keep)[2]) {
  uint8_t* base = reinterpret_cast<uint8_t*>(tile);
  #pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
    #pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int j = 2 * kk + (x >> 1);   // the 8-wide column tile
      const int row = rsub + 8 * (x & 1);
      *reinterpret_cast<uint32_t*>(
          base + (j / 8) * (64 * kSwizzleRow) + row * kSwizzleRow +
          (((j % 8) ^ (row & 7)) << 4) + 2 * col0) = keep[x & 1] ? f[kk][x]
                                                                 : 0u;
    }
}

template <int KSTEPS,   // k16 steps over the head dim, as the pair's
          int NK>       // keys of the one K/V tile: 16 or 80
__global__ void __launch_bounds__(ShortBwd<KSTEPS, NK>::kThreads, 1)
flash_attn_bwd_bf16_short(const __grid_constant__ CUtensorMap map_q,
                          const __grid_constant__ CUtensorMap map_k,
                          const __grid_constant__ CUtensorMap map_v,
                          const __grid_constant__ CUtensorMap map_do,
                          const __grid_constant__ CUtensorMap map_dq,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          float* __restrict__ ws, bf16* __restrict__ dk,
                          bf16* __restrict__ dv, int nq, int nk, int q_len,
                          int kv_len, int d, float sm_scale, int items,
                          Strides sdk, Strides sdv) {
  using T = ShortBwd<KSTEPS, NK>;
  constexpr int kS = NK / 2;   // score registers a thread
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((kSwizzleAtom - smem_addr(smem_raw)) &
                              (kSwizzleAtom - 1));
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + T::kKVTile;
  bf16* qs = vs + T::kKVTile;                   // [stage]
  bf16* dos = qs + T::kQStages * T::kQTile;     // [stage]
  bf16* ps = dos + T::kQStages * T::kQTile;     // [stage]
  bf16* dss = ps + T::kPStages * T::kPTile;     // [stage]
  bf16* os = dss + T::kPStages * T::kPTile;
  uint64_t* kv_full =   // past the score warpgroups' dQ tiles
      reinterpret_cast<uint64_t*>(os + T::kScores * T::kQTile);
  uint64_t* q_full = kv_full + 1;               // [stage]
  uint64_t* q_empty = q_full + T::kQStages;     // [stage]
  uint64_t* p_full = q_empty + T::kQStages;     // [stage]
  uint64_t* ds_full = p_full + T::kPStages;     // [stage]
  uint64_t* ps_empty = ds_full + T::kPStages;   // [stage]

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tile0 = blockIdx.x * items;   // the block's first 64-row tile
  const int tiles = min(items, (nq + 63) / 64 - tile0);
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < T::kQStages; ++s) {
      mbar_init(q_full + s, 1);    // the loading thread; TMA adds bytes
      mbar_init(q_empty + s, 3);   // one thread of each consumer warpgroup
    }
    for (int s = 0; s < T::kPStages; ++s) {
      mbar_init(p_full + s, 128);   // every score thread, after its fence
      mbar_init(ds_full + s, 128);
      mbar_init(ps_empty + s, 2);   // one thread of the dV and dK warpgroups
    }
    mbar_init_fence();
  }
  __syncthreads();

  // the loads, issued by one thread of the dK warpgroup: K and V once, Q
  // and dO tile n into stage n % kQStages once the stage's last tile is
  // read by all three warpgroups
  const uint32_t q_bytes = T::kNarrow ? 2 * 64 * d : 2 * T::kQTile;
  const auto load_q = [&](int n) {
    const int stage = n % T::kQStages;
    mbar_arrive_expect_tx(q_full + stage, 2 * q_bytes);
    const int row = (tile0 + n) * 64;
    tma_load_boxes<T::kBoxes>(qs + stage * T::kQTile, T::kQBox, &map_q,
                              q_full + stage, row, h, b);
    tma_load_boxes<T::kBoxes>(dos + stage * T::kQTile, T::kQBox, &map_do,
                              q_full + stage, row, h, b);
  };
  if (threadIdx.x == (T::kScores + 1) * 128) {   // the dK warpgroup's first
    const uint32_t kv_bytes = T::kNarrow ? 2 * NK * d : 2 * T::kKVTile;
    tma_prefetch_map(&map_q);
    tma_prefetch_map(&map_k);
    tma_prefetch_map(&map_v);
    tma_prefetch_map(&map_do);
    mbar_arrive_expect_tx(kv_full, 2 * kv_bytes);
    tma_load_boxes<T::kBoxes>(ks, T::kKVBox, &map_k, kv_full, 0, h, b);
    tma_load_boxes<T::kBoxes>(vs, T::kKVBox, &map_v, kv_full, 0, h, b);
    for (int n = 0; n < T::kQStages && n < tiles; ++n) load_q(n);
  }
  if (T::kNarrow) {
    // A narrow box brings d columns: the columns from d on are zeros
    // written here once, while the first loads are under way: in K and V
    // those the k16 steps read, in every Q and dO stage the whole box
    // (its columns are the M rows of the transposed products)
    zero_chunks(ks, 2 * NK, d / 8, 2 * KSTEPS, threadIdx.x, T::kThreads);
    zero_chunks(qs, 2 * T::kQStages * 64, d / 8, 8, threadIdx.x,
                T::kThreads);
    fence_proxy_async();
    consumers_sync<T::kWgs>();
  }
  const int lane = threadIdx.x & 31;
  // per thread: rows rsub and rsub + 8 of an m64 tile; in each 8-wide
  // column tile, columns col0 and col0 + 1 (the accumulator layout,
  // sm90.cuh)
  const int rsub = ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
  const int col0 = 2 * (lane & 3);
  const bool elected = (threadIdx.x & 127) == 0;

  if (wg < T::kScores) {
    // ----------- scores: S, dP, P, dS and dQ of tiles wg, wg + kScores..
    const float c = sm_scale * kLog2e;
    const long long stat0 = ((long long)b * gridDim.y + h) * nq;
    const uint64_t k_desc = wgmma_desc(ks, 16, kSwizzleAtom);
    const uint64_t v_desc = wgmma_desc(vs, 16, kSwizzleAtom);
    // K as the MN-major B of dS K, its 64-column boxes LBO apart
    const uint64_t kn_desc = wgmma_desc(ks, 2 * T::kKVBox, kSwizzleAtom);
    bf16* ow = os + wg * T::kQTile;   // this warpgroup's dQ tile
    if (elected) tma_prefetch_map(&map_dq);
    // a tile's rows' LSE in log2 units (+inf past nq: P = 0) and delta,
    // read a tile ahead, so that the loads run under the tile before
    float lse2[2], dl[2], next_lse2[2], next_dl[2];
    const auto stats = [&](int n, float (&l2)[2], float (&dd)[2]) {
      #pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = (tile0 + n) * 64 + rsub + 8 * r;
        const bool in = n < tiles && row < nq;
        l2[r] = in ? lse[stat0 + row] * kLog2e : INFINITY;
        dd[r] = in ? delta[stat0 + row] : 0.f;
      }
    };
    stats(wg, next_lse2, next_dl);
    if (tiles > wg) mbar_wait(kv_full, 0);
    for (int n = wg; n < tiles; n += T::kScores) {
      const int qst = n % T::kQStages, pst = n % T::kPStages;
      const int q0 = (tile0 + n) * 64;
      bool live[2];   // rows at or past q_len add nothing to dK and dV
      #pragma unroll
      for (int r = 0; r < 2; ++r) {
        lse2[r] = next_lse2[r];
        dl[r] = next_dl[r];
        live[r] = q0 + rsub + 8 * r < q_len;
      }
      // S = Q K^T and dP = dO V^T: KSTEPS wgmma m64nNKk16 each, both
      // operands K-major in shared memory
      float s[kS], dp[kS];
      mbar_wait(q_full + qst, (n / T::kQStages) & 1);
      const uint64_t q_desc =
          wgmma_desc(qs + qst * T::kQTile, 16, kSwizzleAtom);
      const uint64_t do_desc =
          wgmma_desc(dos + qst * T::kQTile, 16, kSwizzleAtom);
      wgmma_fence();
      #pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk)
        wgmma_ss<0>(s, kstep_desc(q_desc, kk, 2 * T::kQBox),
                    kstep_desc(k_desc, kk, 2 * T::kKVBox), kk != 0);
      wgmma_commit();
      #pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk)
        wgmma_ss<0>(dp, kstep_desc(do_desc, kk, 2 * T::kQBox),
                    kstep_desc(v_desc, kk, 2 * T::kKVBox), kk != 0);
      wgmma_commit();
      stats(n + T::kScores, next_lse2, next_dl);
      wgmma_wait<1>();   // S is complete, dP may still run
      wgmma_pin(s);
      // P = exp2(c S - LSE2) in place, keys at or past kv_len 0
      #pragma unroll
      for (int i = 0; i < kS; ++i) {
        const float p = ex2(fmaf(s[i], c, -lse2[(i >> 1) & 1]));
        s[i] = (i >> 2) * 8 + col0 + (i & 1) < kv_len ? p : 0.f;
      }
      wgmma_wait<0>();
      wgmma_pin(dp);
      if (elected) mbar_arrive(q_empty + qst);   // done with Q and dO
      // P, rounded to bf16, to the dV warpgroup; then dS = P (dP -
      // delta) in place of dP, rounded, to the dK warpgroup
      uint32_t f[NK / 16][4];
      pack_frags<NK>(f, s);
      mbar_wait(ps_empty + pst, ((n / T::kPStages) & 1) ^ 1);
      store_frags<NK>(ps + pst * T::kPTile, f, rsub, col0, live);
      fence_proxy_async();
      mbar_arrive(p_full + pst);
      #pragma unroll
      for (int i = 0; i < kS; ++i)
        dp[i] = s[i] * (dp[i] - dl[(i >> 1) & 1]);
      pack_frags<NK>(f, dp);
      store_frags<NK>(dss + pst * T::kPTile, f, rsub, col0, live);
      fence_proxy_async();
      mbar_arrive(ds_full + pst);
      // dQ = sm_scale dS K: NK / 16 wgmma m64nNk16, N = 16 KSTEPS, dS
      // from registers, K the MN-major B
      float acc[8 * KSTEPS];
      #pragma unroll
      for (int i = 0; i < 8 * KSTEPS; ++i) acc[i] = 0.f;
      wgmma_fence();   // acc and f were written by ordinary code
      #pragma unroll
      for (int kk = 0; kk < NK / 16; ++kk)
        wgmma_rs(acc, f[kk],
                 wgmma_desc_advance(kn_desc, kk * kWgKStepBytes));
      wgmma_commit();
      wgmma_wait<0>();
      wgmma_pin(acc);
      // dQ into the swizzled tile, then out by TMA (rows past nq and
      // columns past d are not written); the tile is free once the tile
      // before's store has read it
      if (elected) tma_store_wait_read();
      score_sync(wg);
      #pragma unroll
      for (int j = 0; j < 2 * KSTEPS; ++j) {
        uint8_t* box = reinterpret_cast<uint8_t*>(ow + (j / 8) * T::kQBox);
        #pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = rsub + r * 8;
          *reinterpret_cast<__nv_bfloat162*>(
              box + row * kSwizzleRow + (((j % 8) ^ (row & 7)) << 4) +
              2 * col0) = __floats2bfloat162_rn(
              acc[4 * j + 2 * r] * sm_scale,
              acc[4 * j + 2 * r + 1] * sm_scale);
        }
      }
      fence_proxy_async();
      score_sync(wg);
      if (elected) {
        #pragma unroll
        for (int x = 0; x < T::kBoxes; ++x)
          tma_store_4d(&map_dq, ow + x * T::kQBox, 64 * x, q0, h, b);
        tma_store_commit();
      }
    }
    if (elected) tma_store_wait_read();
  } else {
    // ---------- the sums: dV^T += dO^T P (the first), dK^T += Q^T dS
    const bool dv_wg = wg == T::kScores;
    const bf16* a_tiles = dv_wg ? dos : qs;   // [Q stage]
    const bf16* b_tiles = dv_wg ? ps : dss;   // [P stage]
    uint64_t* full = dv_wg ? p_full : ds_full;
    float acc[T::kChunks][T::kN / 2];
    #pragma unroll
    for (int m = 0; m < T::kChunks; ++m)
      #pragma unroll
      for (int i = 0; i < T::kN / 2; ++i) acc[m][i] = 0.f;
    for (int n = 0; n < tiles; ++n) {
      const int qst = n % T::kQStages, pst = n % T::kPStages;
      mbar_wait(full + pst, (n / T::kPStages) & 1);
      mbar_wait(q_full + qst, (n / T::kQStages) & 1);
      const bf16* qt = a_tiles + qst * T::kQTile;   // [64 queries, d]
      const bf16* pt = b_tiles + pst * T::kPTile;   // [64 queries, NK]
      wgmma_fence();
      // four k16 steps over the tile's 64 query rows, both operands
      // MN-major (16 rows a step); M chunk m is 64 columns of the head
      // dim (kShortDRows: A = the Q / dO box m, B = P / dS) or of the
      // keys (A = the P / dS box m, B = Q / dO)
      #pragma unroll
      for (int m = 0; m < T::kChunks; ++m) {
        const uint64_t da = kShortDRows
            ? wgmma_desc(qt + m * T::kQBox, 2 * T::kQBox, kSwizzleAtom)
            : wgmma_desc(pt + m * T::kQBox, 2 * T::kQBox, kSwizzleAtom);
        const uint64_t db = kShortDRows
            ? wgmma_desc(pt, 2 * T::kQBox, kSwizzleAtom)
            : wgmma_desc(qt, 2 * T::kQBox, kSwizzleAtom);
        #pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss<1, 1>(acc[m],
                         wgmma_desc_advance(da, kk * kWgKStepBytes),
                         wgmma_desc_advance(db, kk * kWgKStepBytes), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      #pragma unroll
      for (int m = 0; m < T::kChunks; ++m) wgmma_pin(acc[m]);
      if (elected) {
        mbar_arrive(ps_empty + pst);
        mbar_arrive(q_empty + qst);
        if (!dv_wg && n + T::kQStages < tiles) {   // refill the stage
          mbar_wait(q_empty + qst, (n / T::kQStages) & 1);
          load_q(n + T::kQStages);
        }
      }
    }
    // Where one block holds all of its head's query tiles it writes dK
    // (times sm_scale) and dV itself, bf16, zeros from kv_len on (its
    // sums there are 0); otherwise its partial sums go to its slab of the
    // workspace, [B, H, slabs][dV, dK][NK keys][kRows head-dim columns],
    // float32, for flash_attn_bwd_short_sum.
    const bool direct = gridDim.x == 1;
    const float mul = dv_wg ? 1.f : sm_scale;
    bf16* out = dv_wg ? dv + b * sdv.b + h * sdv.h
                      : dk + b * sdk.b + h * sdk.h;
    const long long out_n = dv_wg ? sdv.n : sdk.n;
    float* w = ws + ((((long long)b * gridDim.y + h) * gridDim.x +
                      blockIdx.x) * 2 + (dv_wg ? 0 : 1)) *
                        (T::kRows * NK);
    const int keys = nk < NK ? nk : NK;
    #pragma unroll
    for (int m = 0; m < T::kChunks; ++m)
      #pragma unroll
      for (int j = 0; j < T::kN / 8; ++j)
        #pragma unroll
        for (int e = 0; e < 4; ++e) {
          // (key, head-dim column) of accumulator value 4j + e
          const int row = m * 64 + rsub + 8 * (e >> 1);
          const int col = 8 * j + col0 + (e & 1);
          const int key = kShortDRows ? col : row;
          const int dd = kShortDRows ? row : col;
          const float x = acc[m][4 * j + e];
          if (direct) {
            if (key < keys && dd < d)
              out[(long long)key * out_n + dd] = __float2bfloat16(x * mul);
          } else if (key < NK && dd < T::kRows) {
            w[key * T::kRows + dd] = x;
          }
        }
    if (direct)   // rows NK .. nk, past every key of the tile
      for (int i = threadIdx.x & 127; i < (nk - keys) * d; i += 128)
        out[(long long)(keys + i / d) * out_n + i % d] =
            __float2bfloat16(0.f);
  }
}

// The second pass of the short-key backward, where a head's query tiles
// span several blocks: each (batch, head)'s dK and dV as the sum of its
// blocks' partial sums in slab order (dK times sm_scale), rounded to bf16;
// rows kv_len .. nk are written as zero. Thread i takes key i / (d / 2) and
// columns 2 (i % (d / 2)) and the next, so that a warp reads and writes
// neighbouring columns.
__global__ void __launch_bounds__(256)
flash_attn_bwd_short_sum(const float* __restrict__ ws, bf16* __restrict__ dk,
                         bf16* __restrict__ dv, int nk, int kv_len, int d,
                         int rows, int keys, int slabs, float sm_scale,
                         Strides sdk, Strides sdv) {
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int i = blockIdx.x * 256 + threadIdx.x;
  if (i >= nk * (d / 2)) return;
  const int key = i / (d / 2), col = 2 * (i % (d / 2));
  float v0 = 0.f, v1 = 0.f, k0 = 0.f, k1 = 0.f;
  if (key < kv_len) {
    const long long part = (long long)keys * rows;
    const float* w = ws + ((long long)b * gridDim.y + h) * slabs * 2 * part +
                     key * rows + col;
    for (int s = 0; s < slabs; ++s, w += 2 * part) {
      const float2 pv = *reinterpret_cast<const float2*>(w);
      const float2 pk = *reinterpret_cast<const float2*>(w + part);
      v0 += pv.x;
      v1 += pv.y;
      k0 += pk.x;
      k1 += pk.y;
    }
  }
  *reinterpret_cast<__nv_bfloat162*>(dv + b * sdv.b + h * sdv.h +
                                     (long long)key * sdv.n + col) =
      __floats2bfloat162_rn(v0, v1);
  *reinterpret_cast<__nv_bfloat162*>(dk + b * sdk.b + h * sdk.h +
                                     (long long)key * sdk.n + col) =
      __floats2bfloat162_rn(k0 * sm_scale, k1 * sm_scale);
}

// ---------------------------------------------------------------- launches

Strides strides_at(const long long* st, int i) {
  return Strides{st[3 * i], st[3 * i + 1], st[3 * i + 2]};
}

// above 48 KB of dynamic shared memory only after opting in (per device)
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *dq, *dk, *dv;
  int batch, heads, nq, nk, q_len, kv_len, d;
  float sm_scale;
  Strides sq, sk, sv, sdo, so0, so1;   // so0: dq or dk; so1: dv
};

template <int DPAD>
cudaError_t launch_dq_f32(const Args& a, cudaStream_t s) {
  const dim3 grid((a.nq + kBM - 1) / kBM, a.heads, a.batch);
  constexpr int smem = BwdF32<DPAD>::kDqSmemBytes;
  const cudaError_t err = allow_smem(flash_attn_bwd_dq_f32<DPAD>, smem);
  if (err != cudaSuccess) return err;
  flash_attn_bwd_dq_f32<DPAD><<<grid, kF32Threads, smem, s>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      a.lse, a.delta, static_cast<float*>(a.dq), a.nq, a.kv_len, a.d,
      a.sm_scale, a.sq, a.sk, a.sv, a.sdo, a.so0);
  return cudaGetLastError();
}

template <int DPAD>
cudaError_t launch_dkv_f32(const Args& a, cudaStream_t s) {
  const dim3 grid((a.nk + kBN - 1) / kBN, a.heads, a.batch);
  constexpr int smem = BwdF32<DPAD>::kDkvSmemBytes;
  const cudaError_t err = allow_smem(flash_attn_bwd_dkv_f32<DPAD>, smem);
  if (err != cudaSuccess) return err;
  flash_attn_bwd_dkv_f32<DPAD><<<grid, kF32Threads, smem, s>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      a.lse, a.delta, static_cast<float*>(a.dk), static_cast<float*>(a.dv),
      a.nq, a.nk, a.q_len, a.kv_len, a.d, a.sm_scale, a.sq, a.sk, a.sv,
      a.sdo, a.so0, a.so1);
  return cudaGetLastError();
}

// The four maps of a wgmma launch (the resident ones narrow as T::kNarrow,
// the streamed ones as str_narrow): resident boxes of T::kRes rows,
// streamed boxes of 64; dQ: Q, dO resident (ending at nq), K, V streamed
// (ending at kv_len); dK/dV: K, V resident (ending at kv_len), Q, dO
// streamed (ending at q_len).
template <typename T>
bool wgmma_maps(const Args& a, bool dq, bool str_narrow,
                CUtensorMap (&maps)[4]) {
  const int q_rows = dq ? T::kRes : kWgStream;
  const int kv_rows = dq ? kWgStream : T::kRes;
  const int q_end = dq ? a.nq : a.q_len;
  const bool qc = dq ? T::kNarrow : str_narrow;
  const bool kvc = dq ? str_narrow : T::kNarrow;
  return attention_map(&maps[0], a.q, a.d, q_end, a.heads, a.batch, a.sq,
                       q_rows, qc) &&
         attention_map(&maps[1], a.k, a.d, a.kv_len, a.heads, a.batch, a.sk,
                       kv_rows, kvc) &&
         attention_map(&maps[2], a.v, a.d, a.kv_len, a.heads, a.batch, a.sv,
                       kv_rows, kvc) &&
         attention_map(&maps[3], a.dout, a.d, q_end, a.heads, a.batch, a.sdo,
                       q_rows, qc);
}

template <int KSTEPS>
cudaError_t launch_dq_wgmma(const Args& a, cudaStream_t s) {
  using T = DqTiles<KSTEPS>;
  CUtensorMap m[4];
  if (!wgmma_maps<T>(a, true, dq_kv_narrow<T>(a.kv_len), m))
    return cudaErrorInvalidValue;
  const cudaError_t err =
      allow_smem(flash_attn_bwd_dq_bf16_wgmma<KSTEPS>, T::kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.nq + T::kRes - 1) / T::kRes, a.heads, a.batch);
  constexpr int threads = kWgsThreads<kDqWarpgroups<KSTEPS>>;
  flash_attn_bwd_dq_bf16_wgmma<KSTEPS><<<grid, threads, T::kSmemBytes, s>>>(
      m[0], m[1], m[2], m[3], a.lse, a.delta, static_cast<bf16*>(a.dq), a.nq,
      a.kv_len, a.d, a.sm_scale, a.so0);
  return cudaGetLastError();
}

template <int KSTEPS, int WGS>
cudaError_t launch_dkv_wgmma(const Args& a, cudaStream_t s) {
  using T = DkvTiles<KSTEPS, WGS>;
  CUtensorMap m[4];
  if (!wgmma_maps<T>(a, false, T::kNarrow, m)) return cudaErrorInvalidValue;
  const cudaError_t err =
      allow_smem(flash_attn_bwd_dkv_bf16_wgmma<KSTEPS, WGS>, T::kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.nk + T::kRes - 1) / T::kRes, a.heads, a.batch);
  constexpr int threads = kWgsThreads<WGS>;
  flash_attn_bwd_dkv_bf16_wgmma<KSTEPS, WGS><<<grid, threads, T::kSmemBytes,
                                               s>>>(
          m[0], m[1], m[2], m[3], a.lse, a.delta, static_cast<bf16*>(a.dk),
          static_cast<bf16*>(a.dv), a.nq, a.nk, a.q_len, a.kv_len, a.d,
          a.sm_scale, a.so0, a.so1);
  return cudaGetLastError();
}

// The fixed table of the header note
cudaError_t dispatch_dq(int dtype, const Args& a, cudaStream_t s) {
  const int d = a.d;
  if (dtype == 1) {
    if (d <= 16) return launch_dq_wgmma<1>(a, s);
    if (d <= 32) return launch_dq_wgmma<2>(a, s);
    if (d <= 48) return launch_dq_wgmma<3>(a, s);
    if (d <= 64) return launch_dq_wgmma<4>(a, s);
    if (d <= 80) return launch_dq_wgmma<5>(a, s);
    return launch_dq_wgmma<10>(a, s);
  }
  if (d <= 16) return launch_dq_f32<16>(a, s);
  if (d <= 32) return launch_dq_f32<32>(a, s);
  if (d <= 48) return launch_dq_f32<48>(a, s);
  if (d <= 64) return launch_dq_f32<64>(a, s);
  if (d <= 80) return launch_dq_f32<80>(a, s);
  return launch_dq_f32<160>(a, s);
}

cudaError_t dispatch_dkv(int dtype, const Args& a, cudaStream_t s) {
  const int d = a.d;
  if (dtype == 1) {
    if (d <= 16) return launch_dkv_wgmma<1, 2>(a, s);
    if (d <= 32) return launch_dkv_wgmma<2, 2>(a, s);
    if (d <= 48) return launch_dkv_wgmma<3, kDkvNarrowWarpgroups>(a, s);
    if (d <= 64) return launch_dkv_wgmma<4, 2>(a, s);
    if (d <= 80) return launch_dkv_wgmma<5, 2>(a, s);
    return launch_dkv_wgmma<10, 2>(a, s);
  }
  if (d <= 16) return launch_dkv_f32<16>(a, s);
  if (d <= 32) return launch_dkv_f32<32>(a, s);
  if (d <= 48) return launch_dkv_f32<48>(a, s);
  if (d <= 64) return launch_dkv_f32<64>(a, s);
  if (d <= 80) return launch_dkv_f32<80>(a, s);
  return launch_dkv_f32<160>(a, s);
}

bool valid(int dtype, int d) {
  return (dtype == 0 || dtype == 1) && d >= 1 && d <= 160 &&
         d % (dtype == 0 ? 4 : 8) == 0;
}

// The short-key backward's grid: `items` 64-row query tiles of one (batch,
// head) a block, as few as fill every block the card holds at once, so
// that K and V are loaded, and a partial sum written, once for as many
// tiles as the grid allows (the forward's rule); the blocks an SM holds
// are counted once per instantiation. slabs = ceil(tiles / items) blocks a
// (batch, head).
template <int KSTEPS, int NK>
cudaError_t short_items(int nq, int heads, int batch, int* items) {
  using T = ShortBwd<KSTEPS, NK>;
  const auto kernel = flash_attn_bwd_bf16_short<KSTEPS, NK>;
  static int slots = 0;   // blocks in flight on the card
  if (slots == 0) {
    cudaError_t err = allow_smem(kernel, T::kSmemBytes);
    int dev = 0, sms = 0, per_sm = 0;
    if (err != cudaSuccess || (err = cudaGetDevice(&dev)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, kernel, T::kThreads, T::kSmemBytes)) != cudaSuccess)
      return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    slots = sms * per_sm;
  }
  const int tiles = (nq + 63) / 64;
  const int per_block = (tiles * heads * batch + slots - 1) / slots;
  *items = tiles < per_block ? tiles : per_block;
  return cudaSuccess;
}

struct ShortArgs {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *dq, *dk, *dv;
  float* ws;
  int batch, heads, nq, nk, q_len, kv_len, d, slabs;
  long long ws_floats;
  float sm_scale;
  Strides sq, sk, sv, sdo, sdq, sdk, sdv;
};

template <int KSTEPS, int NK>
int short_slabs(int nq, int heads, int batch) {
  int items = 0;
  const cudaError_t err = short_items<KSTEPS, NK>(nq, heads, batch, &items);
  if (err != cudaSuccess) return -(int)err;
  return ((nq + 63) / 64 + items - 1) / items;
}

// The one-pass kernel, then the sum, on stream s; the caller's slabs and
// workspace must be those of short_slabs and ShortBwd.
template <int KSTEPS, int NK>
cudaError_t launch_short(const ShortArgs& a, cudaStream_t s) {
  using T = ShortBwd<KSTEPS, NK>;
  const auto kernel = flash_attn_bwd_bf16_short<KSTEPS, NK>;
  int items = 0;
  cudaError_t err = short_items<KSTEPS, NK>(a.nq, a.heads, a.batch, &items);
  if (err != cudaSuccess) return err;
  const int slabs = ((a.nq + 63) / 64 + items - 1) / items;
  if (slabs != a.slabs ||
      (slabs > 1 && (long long)a.batch * a.heads * slabs * 2 * T::kRows * NK >
                        a.ws_floats))
    return cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv, mdo, mdq;
  if (!attention_map(&mq, a.q, a.d, a.nq, a.heads, a.batch, a.sq, 64,
                     T::kNarrow) ||
      !attention_map(&mk, a.k, a.d, a.kv_len, a.heads, a.batch, a.sk, NK,
                     T::kNarrow) ||
      !attention_map(&mv, a.v, a.d, a.kv_len, a.heads, a.batch, a.sv, NK,
                     T::kNarrow) ||
      !attention_map(&mdo, a.dout, a.d, a.nq, a.heads, a.batch, a.sdo, 64,
                     T::kNarrow) ||
      !attention_map(&mdq, a.dq, a.d, a.nq, a.heads, a.batch, a.sdq, 64,
                     T::kNarrow))
    return cudaErrorInvalidValue;
  if ((err = allow_smem(kernel, T::kSmemBytes)) != cudaSuccess) return err;
  kernel<<<dim3(slabs, a.heads, a.batch), T::kThreads, T::kSmemBytes, s>>>(
      mq, mk, mv, mdo, mdq, a.lse, a.delta, a.ws, static_cast<bf16*>(a.dk),
      static_cast<bf16*>(a.dv), a.nq, a.nk, a.q_len, a.kv_len, a.d,
      a.sm_scale, items, a.sdk, a.sdv);
  if ((err = cudaGetLastError()) != cudaSuccess || slabs == 1) return err;
  const int pairs = a.nk * (a.d / 2);
  flash_attn_bwd_short_sum<<<dim3((pairs + 255) / 256, a.heads, a.batch), 256,
                             0, s>>>(
      a.ws, static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), a.nk,
      a.kv_len, a.d, T::kRows, NK, slabs, a.sm_scale, a.sdk, a.sdv);
  return cudaGetLastError();
}

// The fixed table of the header note, by head dim: KSTEPS as the pair's
template <int NK>
cudaError_t dispatch_short_d(const ShortArgs& a, cudaStream_t s) {
  if (a.d <= 16) return launch_short<1, NK>(a, s);
  if (a.d <= 32) return launch_short<2, NK>(a, s);
  if (a.d <= 48) return launch_short<3, NK>(a, s);
  if (a.d <= 64) return launch_short<4, NK>(a, s);
  if (a.d <= 80) return launch_short<5, NK>(a, s);
  return launch_short<10, NK>(a, s);
}

template <int NK>
int slabs_d(int d, int nq, int heads, int batch) {
  if (d <= 16) return short_slabs<1, NK>(nq, heads, batch);
  if (d <= 32) return short_slabs<2, NK>(nq, heads, batch);
  if (d <= 48) return short_slabs<3, NK>(nq, heads, batch);
  if (d <= 64) return short_slabs<4, NK>(nq, heads, batch);
  if (d <= 80) return short_slabs<5, NK>(nq, heads, batch);
  return short_slabs<10, NK>(nq, heads, batch);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q, dout, dq: [B, H, Nq, d]; k, v:
// [B, H, Nk, d]; d <= 160 and a multiple of 4 (float32) or 8 (bfloat16).
// strides: 15 values, (batch, head, token) for q, k, v, dout, dq in
// elements (the head dim is contiguous), multiples of the 16-byte vector.
// lse, delta: contiguous [B, H, Nq] float32. Returns the cudaError_t of the
// tensor-map encode or the launch (0 on success).
extern "C" int flash_attn_bwd_dq(int dtype, const void* q, const void* k,
                                 const void* v, const void* dout,
                                 const void* lse, const void* delta, void* dq,
                                 int batch, int heads, int nq, int kv_len,
                                 int d, float sm_scale, const long long* st,
                                 void* stream) {
  if (!valid(dtype, d)) return (int)cudaErrorInvalidValue;
  Args a{q, k, v, dout, static_cast<const float*>(lse),
         static_cast<const float*>(delta), dq, nullptr, nullptr,
         batch, heads, nq, kv_len, nq, kv_len, d, sm_scale,
         strides_at(st, 0), strides_at(st, 1), strides_at(st, 2),
         strides_at(st, 3), strides_at(st, 4), Strides{0, 0, 0}};
  return (int)dispatch_dq(dtype, a, static_cast<cudaStream_t>(stream));
}

// As flash_attn_bwd_dq, with dk, dv: [B, H, Nk, d] and 18 strides: q, k, v,
// dout, dk, dv. Rows of dk and dv in [kv_len, nk) are written as zero;
// query rows at or past q_len are left out of the sums.
extern "C" int flash_attn_bwd_dkv(int dtype, const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const void* lse, const void* delta,
                                  void* dk, void* dv, int batch, int heads,
                                  int nq, int nk, int q_len, int kv_len,
                                  int d, float sm_scale, const long long* st,
                                  void* stream) {
  if (!valid(dtype, d)) return (int)cudaErrorInvalidValue;
  Args a{q, k, v, dout, static_cast<const float*>(lse),
         static_cast<const float*>(delta), nullptr, dk, dv,
         batch, heads, nq, nk, q_len, kv_len, d, sm_scale,
         strides_at(st, 0), strides_at(st, 1), strides_at(st, 2),
         strides_at(st, 3), strides_at(st, 4), strides_at(st, 5)};
  return (int)dispatch_dkv(dtype, a, static_cast<cudaStream_t>(stream));
}

// The short-key backward's blocks a (batch, head), the slabs of its
// workspace, for bfloat16 at head dim d onto kv_len <= 80 keys under nq
// query rows; a negative cudaError_t if the runtime refuses the query.
extern "C" int flash_attn_bwd_short_slabs(int d, int kv_len, int nq,
                                          int heads, int batch) {
  if (!valid(1, d) || kv_len < 1 || kv_len > kShortKeys)
    return -(int)cudaErrorInvalidValue;
  return kv_len <= kShortFewKeys
             ? slabs_d<kShortFewKeys>(d, nq, heads, batch)
             : slabs_d<kShortKeys>(d, nq, heads, batch);
}

// dQ, dK and dV of the short-key backward (bfloat16 only, kv_len <= 80):
// dq [B, H, Nq, d], dk and dv [B, H, Nk, d]; slabs as
// flash_attn_bwd_short_slabs gives them; ws: float32 scratch of ws_floats
// >= B * H * slabs * 2 * (16 up to 16 keys, else 80) * 16 ceil(d / 16) (80
// and 160 above 64) where slabs > 1, unused at one slab; 21 strides: q, k,
// v, dout, dq, dk, dv. Rows of dk and dv in
// [kv_len, nk) are written as zero; query rows at or past q_len are left
// out of dK and dV.
extern "C" int flash_attn_bwd_short(int dtype, const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const void* lse, const void* delta,
                                    void* dq, void* dk, void* dv, void* ws,
                                    int batch, int heads, int nq, int nk,
                                    int q_len, int kv_len, int d, int slabs,
                                    long long ws_floats, float sm_scale,
                                    const long long* st, void* stream) {
  if (dtype != 1 || !valid(dtype, d) || kv_len < 1 || kv_len > kShortKeys)
    return (int)cudaErrorInvalidValue;
  const ShortArgs a{q, k, v, dout, static_cast<const float*>(lse),
                    static_cast<const float*>(delta), dq, dk, dv,
                    static_cast<float*>(ws), batch, heads, nq, nk, q_len,
                    kv_len, d, slabs, ws_floats, sm_scale,
                    strides_at(st, 0), strides_at(st, 1), strides_at(st, 2),
                    strides_at(st, 3), strides_at(st, 4), strides_at(st, 5),
                    strides_at(st, 6)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(kv_len <= kShortFewKeys ? dispatch_short_d<kShortFewKeys>(a, s)
                                       : dispatch_short_d<kShortKeys>(a, s));
}
