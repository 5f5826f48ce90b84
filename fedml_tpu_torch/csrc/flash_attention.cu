// Flash attention -- forward, dq and dk/dv -- for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of fedml_tpu/ops/pallas_attention.py:
//   B2  `_fwd_kernel` (pallas_call in `_fwd_one_head`, line 123): the
//       online-softmax forward, emitting O and the per-row logsumexp;
//   B3  `_dq_kernel`  (pallas_call in `_bwd_one_head`, line 241):
//       dq = scale * sum_k ds . k;
//   B4  `_dkv_kernel` (pallas_call in `_bwd_one_head`, line 255):
//       dv = sum_q p^T . dO and dk = scale * sum_q ds^T . q;
// with the Pallas `_mask` and `_probs_and_ds` as the shared device
// functions `score_valid` and `probs_and_ds` below (B3 and B4 re-form p and
// ds with the same code).
//
// Layout. q [B, Tq, H, D], k and v [B, Tk, H, D], dO like q: read through
// their batch, time and head strides (the head dim contiguous), so the
// q/k/v column slices of a fused qkv product need no copy. O, dq, dk, dv
// are written through theirs. lse and delta are fp32 [B, H, Tq],
// contiguous. Ragged Tq and Tk are masked here: no padded copies, no
// [B,T,H,D] <-> [B,H,T,D] transposes (the Pallas wrapper needed both for
// the TPU's block layout). Keys at or past k_len are masked and, causal,
// keys after their query (absolute positions, kpos <= qpos).
//
// Numerics. Inputs are bf16 or fp32. Products take values of the input
// type and sum in fp32, as the Pallas kernels' preferred_element_type=
// float32 (in fp32 through three TF32 products, to within about 2^-22
// of each term, below). p (B2, B4) and ds (B3, B4) are rounded to the
// input type before their second product, as the Pallas kernels cast
// them. The online-softmax state m, l, acc stays fp32, including the
// s <= NEG_INF/2 -> p = 0 guard and the m_keep rule. B2 takes the exact
// expf at D 64 and 128; in bf16 it rounds p against the running maximum
// of the keys its warp has taken, 16 at a time (above D 128, a key tile at
// a time; the Pallas kernel at block 16 against the row's running
// maximum, the plain version against the whole row's). In bf16, B3, B4
// and B2 above D 128 take exp from ex2.approx (`softmax_exp`), a few fp32
// ulps off, before p and ds are rounded to bf16: measured faster than
// expf on the card. Each output tile is owned by one block, the partial
// sums of a warp pair meet in a fixed order and there are no atomics, so
// a repeat call is bit-equal.
//
// What bounds them on the card. At the LM flagship's launch ([32, 80, 4,
// 128] bf16, causal) the functions move 10.5 MB (B2), 13.1 MB (B3) and
// 15.7 MB (B4): 3.1-4.7 us at 3.35 TB/s, against 0.2-0.4 GFLOP on the
// valid (query, key) pairs, 0.2-0.4 us on the tensor cores. So bytes set
// the bound. But with 128 (batch, head) problems of 80 rows each, what a
// kernel reaches is set by how soon each block has its tiles and how long
// the chain of dependent instructions between them and the result is.
//
// B2, B3 and B4 in bf16 (the LM path): tensor cores. Every product is a
// warp-level mma.m16n8k16 (bf16 operands, fp32 accumulators; hopper_mma.cuh)
// fed by ldmatrix from bf16 tiles in shared memory: S = Q.K^T, then O +=
// P.V (B2); S = Q.K^T, dP = dO.V^T, then dQ += dS.K (B3); S^T = K.Q^T,
// dP^T = V.dO^T, then dV += P^T.dO and dK += dS^T.Q (B4). The score
// accumulators are, once rounded to bf16 pairs, the A operand of the
// accumulating product, so p and ds never leave registers; the operands
// whose reduction axis is the tile's rows (V in B2, K in B3, dO and Q in
// B4) come through ldmatrix.trans, so nothing is transposed in memory. A
// block owns 64 rows (queries in B2 and B3, keys in B4) and loops over
// 64-row tiles of the opposite operand, double-buffered: the next tile's
// 16-byte cp.async copies are in flight while this tile's products run.
// Work is cut at 16 rows, and a warp skips the 16x16 sub-tiles that lie
// wholly past Tq, past k_len or (causal) above the diagonal; ragged edges
// inside a sub-tile are masked.
// At the flagship's launch the 256 blocks of each kernel fill the 132 SMs
// in one wave and all load at once. A trace probe that is not in the
// repository (per-warp clock stamps) read a backward block waiting longer
// for its first tiles than its products then took, with a warp's
// products running in turn. So:
// - B2: two warps share each 16 query rows and take every other 16-key
//   group, as in B3, each with its own online-softmax state (m, l and O
//   in fp32 registers) and one softmax step per 16 keys as soon as they
//   have landed; at the end the odd warp's state is merged into the even
//   one's through shared memory, in that order, and O leaves through
//   shared memory, 16 contiguous bytes a lane. A softmax step per 64-key
//   tile with one warp per 16 rows (p rounded against the tile's
//   running maximum) measured 1.7x slower, waiting for whole tiles and
//   running the five sub-tiles of rows 64-79 in one warp.
// - B3: two warps share each 16 query rows and take every other 16-key
//   group, which halves the longest chain of sub-tiles a warp runs (dQ
//   summed in registers, the odd warp's onto the even one's through
//   shared memory at the end, in that order). K and V arrive 16 keys at a
//   time, each chunk with an mbarrier, so a warp starts on the first keys
//   while the rest are in flight.
// - B4: one warp owns 16 keys and all of the head dim of dK and dV (2 x 64
//   fp32 registers at D = 128, no spills), so no score product is
//   computed twice, and writes them through shared memory, 16 contiguous
//   bytes a lane. Its query tiles arrive whole (commit groups and a block
//   barrier): waiting 16 queries at a time measured slower here.
// Tiles are bf16 rows of D + 8 elements (bank-conflict-free ldmatrix),
// about 103 KB a backward block and 87 KB a forward block at D = 128, so
// two blocks share an SM. Rows that do not start on 16 bytes are loaded
// element by element instead.
//
// B2, B3 and B4 in fp32 (which the fp32 models run, main_longcontext at
// its defaults among them): tensor cores at fp32 accuracy. At
// main_longcontext's launch ([32, 512, 4, 64] fp32, causal) the functions
// move 67 MB (B2), 84 MB (B3) and 101 MB (B4), 20-30 us at 3.35 TB/s,
// against 4.3, 6.5 and 8.6 GFLOP on the valid (query, key) pairs: 64-129
// us at the CUDA cores' 67 TFLOP/s, which the first design (four FMAs to
// a float4 shared load, bound by instruction issue) missed five to six
// times over. TF32 on the tensor cores (495 TFLOP/s) keeps 10 mantissa
// bits, about three decimal digits: short of the fp32 tolerance. So each
// operand is split in registers as its fragment is read, x = hi + lo with
// both tf32 (rounded as cvt.rna.tf32 rounds), and each product is lo.hi +
// hi.lo + hi.hi on the tensor cores (3xTF32, hopper_mma.cuh), within
// about 2^-22 of fp32's: 3 x the operations at 495 TFLOP/s, a bound of
// 26, 39 and 52 us. The tensor cores truncate the sums they accumulate,
// and ds = p (dP - delta) cancels dP against an fp32 delta, so dP's
// products start from zero every 8 columns of the head dim and are summed
// on the CUDA cores; S does not cancel so, and sums on the tensor cores.
// The kernels keep the bf16 kernels' layout above (B2 and B3: two warps
// per 16 query rows, K and V 16 keys at a time behind mbarriers; B4: one
// warp per 16 keys owning their dK and dV), with mma.m16n8k8 on fp32
// tiles of D + 4 floats. The operands whose reduction axis is the head
// dim come through ldmatrix (an 8x8 b16 matrix is 8 rows of 4 floats);
// those whose reduction axis is the tile's rows (V in B2, K in B3, dO and
// Q in B4) by plain loads, as ldmatrix.trans moves 16-bit elements and
// cannot transpose fp32 (and wgmma's tf32 path wants both operands
// K-major in shared memory). Each 8 of the reduction axis is read in the
// order 0, 4, 1, 5, ... (k t as row 2t, k t+4 as row 2t+1), which makes
// the score accumulators the A operand of the next product as they stand,
// with no shuffle, and keeps the plain loads free of bank conflicts. p
// and ds stay fp32 (the accurate expf) and are split like any other
// operand. A block holds 87 KB (B2) and 102-103 KB (B3, B4) of shared
// memory at D = 64 (two blocks an SM) and 198-199 KB (B3, B4: one) at D =
// 128, where B2's blocks own 32 query rows and loop over 32-key tiles
// (84 KB, two blocks an SM).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper_mma.cuh"

namespace {

constexpr float kNegInf = -1e30f;  // NEG_INF of the JAX package

struct Strides {
  long long b, t, h;
};

// `_mask`: a score is valid when its key exists and, causal, does not come
// after its query.
__device__ __forceinline__ bool score_valid(int qpos, int kpos, int k_len,
                                            bool causal) {
  return kpos < k_len && (!causal || kpos <= qpos);
}

// exp of the backward's re-formation and of B2 above D 128: for bf16
// inputs the fast one (ex2.approx, a few fp32 ulps), whose p and ds are
// rounded to bf16 (2^-8) before their products; for fp32 inputs the
// accurate one.
template <typename T>
__device__ __forceinline__ float softmax_exp(float x) {
  return expf(x);
}
template <>
__device__ __forceinline__ float softmax_exp<__nv_bfloat16>(float x) {
  return __expf(x);
}

// `_probs_and_ds`: from the raw q.k and dO.v products of one score,
// p = exp(s - lse) with the saved logsumexp (0 where s is masked) and
// ds = p * (dO.v - delta). The one re-formation B3 and B4 share.
template <typename T>
__device__ __forceinline__ void probs_and_ds(float qk, float dov, float lse,
                                             float delta, bool valid,
                                             float scale, float* p,
                                             float* ds) {
  const float s = valid ? qk * scale : kNegInf;
  *p = s <= kNegInf / 2 ? 0.f : softmax_exp<T>(s - lse);
  *ds = *p * (dov - delta);
}

// ---------------------------------------------------------------------------
// B3 and B4 in bf16, on tensor cores (B2's kernel below shares the helpers)
// ---------------------------------------------------------------------------
using bf16 = __nv_bfloat16;

constexpr int kBwdRows = 64;  // rows a block owns (queries B3, keys B4)
constexpr int kBwdStep = 64;  // rows of a loop tile

// A bf16 tile row in shared memory: D + 8 elements, so that every row
// starts on 16 bytes and the eight rows one ldmatrix matrix reads lie in
// distinct banks.
template <int D> __host__ __device__ constexpr int tile_ld() { return D + 8; }

// dq block: Q and dO tiles, then two buffers of a K and a V tile
template <int D> constexpr size_t dq_smem_bytes() {
  return (2 * kBwdRows + 4 * kBwdStep) * tile_ld<D>() * sizeof(bf16);
}
// dk/dv block: K and V tiles, two buffers of a Q and a dO tile, then two
// buffers of the Q tile's lse and delta rows
template <int D> constexpr size_t dkv_smem_bytes() {
  return (2 * kBwdRows + 4 * kBwdStep) * tile_ld<D>() * sizeof(bf16)
         + 4 * kBwdStep * sizeof(float);
}
constexpr int kDqThreads = kBwdRows * 4;   // two warps per 16 query rows
constexpr int kDkvThreads = kBwdRows * 2;  // one warp per 16 key rows

// Issues the copies of rows [row0, row0 + ROWS) of one (batch, head) of a
// [B, T, H, D] bf16 tensor into a shared tile; rows at or past `len` are
// zero. Rows that start on 16 bytes (the model's qkv views and contiguous
// tensors) go by cp.async, 16 bytes at a time; others by element loads.
template <int D, int ROWS, int THREADS>
__device__ __forceinline__ void stage_tile(bf16* dst,
                                           const bf16* __restrict__ src,
                                           Strides st, int b, int h,
                                           int row0, int len) {
  const bf16* base = src + b * st.b + h * st.h;
  const bool aligned =
      reinterpret_cast<uintptr_t>(base) % 16 == 0 && st.t % 8 == 0;
  constexpr int kChunks = D / 8;  // 16-byte chunks a row
  for (int e = threadIdx.x; e < ROWS * kChunks; e += THREADS) {
    const int r = e / kChunks, c = e % kChunks * 8, t = row0 + r;
    const bool ok = t < len;
    bf16* d = dst + r * tile_ld<D>() + c;
    const bf16* s = base + (long long)(ok ? t : 0) * st.t + c;
    if (aligned) {
      hopper::cp_async16(d, s, ok);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) d[i] = ok ? s[i] : __float2bfloat16(0.f);
    }
  }
}

// Issues the copies of entries [row0, row0 + ROWS) of one fp32 row vector
// (lse or delta) into shared memory; zero at or past `len`.
template <int ROWS, int THREADS>
__device__ __forceinline__ void stage_vec(float* dst,
                                          const float* __restrict__ src,
                                          int row0, int len) {
  for (int i = threadIdx.x; i < ROWS; i += THREADS) {
    const int t = row0 + i;
    hopper::cp_async4(dst + i, src + (t < len ? t : 0), t < len);
  }
}

// Lane's row address for an ldmatrix.x4 of the 16x16 A operand at
// (row r, col c) of a tile: matrices (rows 0-7, 8-15) x (cols 0-7, 8-15).
template <int D>
__device__ __forceinline__ const bf16* a_rows(const bf16* tile, int r, int c,
                                             int lane) {
  return tile + (r + (lane & 15)) * tile_ld<D>() + c + (lane >> 4) * 8;
}
// ... for the B operands of two side-by-side n8 products that read rows
// [r, r + 16) of a tile as their n axis and cols [c, c + 16) as k: r[0],
// r[1] feed the product of rows r..r+7, r[2], r[3] that of rows r+8..r+15.
template <int D>
__device__ __forceinline__ const bf16* bn_rows(const bf16* tile, int r, int c,
                                              int lane) {
  return tile + (r + (lane & 7) + (lane >> 4) * 8) * tile_ld<D>() + c
         + ((lane >> 3) & 1) * 8;
}
// ... and, with ldmatrix.trans, for those that read rows [r, r + 16) as
// their k axis and cols [c, c + 16) as n: r[0], r[1] feed the product of
// cols c..c+7, r[2], r[3] that of cols c+8..c+15.
template <int D>
__device__ __forceinline__ const bf16* bk_rows(const bf16* tile, int r, int c,
                                              int lane) {
  return tile + (r + (lane & 7) + ((lane >> 3) & 1) * 8) * tile_ld<D>() + c
         + (lane >> 4) * 8;
}

// Rounds a warp's 16 x D accumulators (acc[n]: columns 8n..8n+7 of rows g
// and g + 8), times `mul`, to bf16 rows of a shared tile.
template <int D>
__device__ __forceinline__ void stage_acc(bf16* tile,
                                          const float (&acc)[D / 8][4],
                                          float mul, int g, int t) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(tile + (g + 8 * i) * tile_ld<D>()
                                         + 8 * n + 2 * t) =
          __floats2bfloat162_rn(mul * acc[n][2 * i], mul * acc[n][2 * i + 1]);
}

// Writes 16 rows of a shared tile to rows [row0, row0 + 16) of one (batch,
// head) of a [B, T, H, D] bf16 tensor whose rows start on 16 bytes, 16
// bytes a lane; rows at or past `len` are not written.
template <int D>
__device__ __forceinline__ void store_rows16(bf16* __restrict__ dst,
                                             Strides st, int b, int h,
                                             int row0, int len,
                                             const bf16* tile, int lane) {
  constexpr int kChunks = D / 8;  // 16-byte chunks a row
#pragma unroll
  for (int e = lane; e < 16 * kChunks; e += 32) {
    const int r = e / kChunks, c = e % kChunks * 8;
    if (row0 + r < len)
      *reinterpret_cast<uint4*>(dst + b * st.b + (long long)(row0 + r) * st.t
                                + h * st.h + c) =
          *reinterpret_cast<const uint4*>(tile + r * tile_ld<D>() + c);
  }
}

// The 16x16 sub-tile of scores s = a . b^T and of dP = da . db^T from rows
// [ra, ra+16) of tiles a, da and rows [rb, rb+16) of tiles b, db, over the
// head dim: acc[j] holds columns 8j..8j+7.
template <int D>
__device__ __forceinline__ void score_pair(float (&s)[2][4], float (&dp)[2][4],
                                           const bf16* a, const bf16* da,
                                           int ra, const bf16* b,
                                           const bf16* db, int rb, int lane) {
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[j][i] = dp[j][i] = 0.f;
#pragma unroll
  for (int c = 0; c < D; c += 16) {
    uint32_t fa[4], fb[4];
    hopper::ldmatrix_x4(fa, a_rows<D>(a, ra, c, lane));
    hopper::ldmatrix_x4(fb, bn_rows<D>(b, rb, c, lane));
    hopper::mma_bf16(s[0], fa, fb[0], fb[1]);
    hopper::mma_bf16(s[1], fa, fb[2], fb[3]);
    hopper::ldmatrix_x4(fa, a_rows<D>(da, ra, c, lane));
    hopper::ldmatrix_x4(fb, bn_rows<D>(db, rb, c, lane));
    hopper::mma_bf16(dp[0], fa, fb[0], fb[1]);
    hopper::mma_bf16(dp[1], fa, fb[2], fb[3]);
  }
}

// B3: one block of kDqThreads per (batch*head, kBwdRows query rows); warps
// 2m and 2m+1 own query rows [16m, 16m + 16) of the tile and take its
// even and odd 16-key groups, each summing its own dQ in registers (D/8
// fragments of 16x8); at the end the odd warp's sum is added to the even
// one's through shared memory, in that order. Two blocks an SM, as shared
// memory allows: at most 128 registers a thread.
template <int D>
__global__ void __launch_bounds__(kDqThreads, 2)
    dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, bf16* __restrict__ dq,
                  Strides sq, Strides sk, Strides sv, Strides sdo,
                  Strides sdq, int H, int Tq, int Tk, int k_len, float scale,
                  bool causal) {
  constexpr int BQ = kBwdRows, BK = kBwdStep, LD = tile_ld<D>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sdO = sQ + BQ * LD;
  bf16* sKV = sdO + BQ * LD;  // [buffer][K, V][BK][LD]
  const int bh = blockIdx.x, b = bh / H, h = bh % H, q0 = blockIdx.y * BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rg = warp >> 1, par = warp & 1, r0 = q0 + 16 * rg;
  // keys the block, and this warp, need: before k_len and, causal, not
  // after the last query
  const int kend = causal ? min(k_len, min(q0 + BQ, Tq)) : k_len;
  const int kend_w = causal ? min(k_len, min(r0 + 16, Tq)) : k_len;
  const int nkt = (kend + BK - 1) / BK;

  // one barrier per 16 keys of each K and V buffer: a warp waits for just
  // the keys it takes next, while the rest of the tile is in flight
  __shared__ uint64_t bars[2][BK / 16];
  if (threadIdx.x == 0)
    for (int i = 0; i < 2 * (BK / 16); ++i)
      hopper::mbar_init(&bars[0][0] + i, kDqThreads);
  __syncthreads();
  auto stage_kv = [&](int kt) {
    bf16* dst = sKV + (kt & 1) * 2 * BK * LD;
    for (int c = 0; c < BK / 16; ++c) {
      const int row0 = kt * BK + 16 * c;
      stage_tile<D, 16, kDqThreads>(dst + 16 * c * LD, k, sk, b, h, row0, Tk);
      stage_tile<D, 16, kDqThreads>(dst + (BK + 16 * c) * LD, v, sv, b, h,
                                    row0, Tk);
      hopper::mbar_arrive_copies(&bars[kt & 1][c]);
    }
  };
  // Q and dO first: the first 16 keys' barrier covers them too
  stage_tile<D, BQ, kDqThreads>(sQ, q, sq, b, h, q0, Tq);
  stage_tile<D, BQ, kDqThreads>(sdO, dout, sdo, b, h, q0, Tq);
  if (nkt > 0) stage_kv(0);

  float lse_r[2], delta_r[2];  // of rows g and g + 8
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qpos = r0 + g + 8 * i;
    lse_r[i] = qpos < Tq ? lse[(long long)bh * Tq + qpos] : 0.f;
    delta_r[i] = qpos < Tq ? delta[(long long)bh * Tq + qpos] : 0.f;
  }
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;

  for (int kt = 0; kt < nkt; ++kt) {
    if (kt + 1 < nkt) stage_kv(kt + 1);
    const bf16* sK = sKV + (kt & 1) * 2 * BK * LD;
    const bf16* sV = sK + BK * LD;
    const int k0 = kt * BK;
    // the warp's 16-key groups of this tile (every other one): none past
    // its last key
    const int kn = r0 < Tq ? min(BK, kend_w - k0) : 0;
    for (int kk = 16 * par; kk < kn; kk += 32) {
      hopper::mbar_wait(&bars[kt & 1][kk / 16], (kt >> 1) & 1);
      float s[2][4], dp[2][4], ds[2][4];
      score_pair<D>(s, dp, sQ, sdO, 16 * rg, sK, sV, kk, lane);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int qpos = r0 + g + 8 * (i >> 1);
          const int kpos = k0 + kk + 8 * j + 2 * t + (i & 1);
          float p;
          probs_and_ds<bf16>(
              s[j][i], dp[j][i], lse_r[i >> 1], delta_r[i >> 1],
              qpos < Tq && score_valid(qpos, kpos, k_len, causal), scale,
              &p, &ds[j][i]);
        }
      uint32_t da[4];  // dS, rounded to bf16: the A operand of dS.K
      hopper::pack_a(da, ds[0], ds[1]);
#pragma unroll
      for (int c = 0; c < D; c += 16) {
        uint32_t fk[4];
        hopper::ldmatrix_x4_trans(fk, bk_rows<D>(sK, kk, c, lane));
        hopper::mma_bf16(acc[c / 8], da, fk[0], fk[1]);
        hopper::mma_bf16(acc[c / 8 + 1], da, fk[2], fk[3]);
      }
    }
    __syncthreads();  // this buffer is read before it is staged again
  }
  hopper::cp_async_wait_all();

  // the odd warp's dQ onto the even one's, through the K and V buffers
  __syncthreads();
  float4* red = reinterpret_cast<float4*>(sKV) + rg * (D / 8) * 32 + lane;
  if (par) {
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      red[n * 32] = make_float4(acc[n][0], acc[n][1], acc[n][2], acc[n][3]);
  }
  __syncthreads();
  if (par) return;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const float4 o = red[n * 32];
    acc[n][0] += o.x;
    acc[n][1] += o.y;
    acc[n][2] += o.z;
    acc[n][3] += o.w;
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qpos = r0 + g + 8 * i;
    if (qpos >= Tq) continue;
    bf16* row = dq + b * sdq.b + (long long)qpos * sdq.t + h * sdq.h;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * n + 2 * t) =
          __floats2bfloat162_rn(scale * acc[n][2 * i],
                                scale * acc[n][2 * i + 1]);
  }
}

// B4: one block of kDkvThreads per (batch*head, kBwdRows key rows); warp
// m owns key rows [16m, 16m + 16) of the tile and their dK and dV in
// registers (2 x D/8 fragments of 16x8). Two blocks an SM, as shared
// memory allows: up to 255 registers a thread. dk and dv rows start on 16
// bytes (the wrapper allocates them).
template <int D>
__global__ void __launch_bounds__(kDkvThreads, 2)
    dkv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, bf16* __restrict__ dk,
                   bf16* __restrict__ dv, Strides sq, Strides sk, Strides sv,
                   Strides sdo, Strides sdk, Strides sdv, int H, int Tq,
                   int Tk, int k_len, float scale, bool causal) {
  constexpr int BK = kBwdRows, BQ = kBwdStep, LD = tile_ld<D>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + BK * LD;
  bf16* sQdO = sV + BK * LD;  // [buffer][Q, dO][BQ][LD]
  // [buffer][lse, delta][BQ]
  float* sLD = reinterpret_cast<float*>(sQdO + 4 * BQ * LD);
  const int bh = blockIdx.x, b = bh / H, h = bh % H, k0 = blockIdx.y * BK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kr = 16 * warp, kw = k0 + kr;
  // query tiles the block needs: none when all its keys are masked; causal,
  // none wholly before its first key
  const int qt0 = causal ? k0 / BQ : 0;
  const int nqt = k0 < k_len ? (Tq + BQ - 1) / BQ : qt0;

  auto stage_q = [&](int qt) {
    const int buf = (qt - qt0) & 1;
    bf16* dst = sQdO + buf * 2 * BQ * LD;
    float* vec = sLD + buf * 2 * BQ;
    stage_tile<D, BQ, kDkvThreads>(dst, q, sq, b, h, qt * BQ, Tq);
    stage_tile<D, BQ, kDkvThreads>(dst + BQ * LD, dout, sdo, b, h, qt * BQ,
                                   Tq);
    stage_vec<BQ, kDkvThreads>(vec, lse + (long long)bh * Tq, qt * BQ, Tq);
    stage_vec<BQ, kDkvThreads>(vec + BQ, delta + (long long)bh * Tq, qt * BQ,
                               Tq);
  };
  stage_tile<D, BK, kDkvThreads>(sK, k, sk, b, h, k0, Tk);
  stage_tile<D, BK, kDkvThreads>(sV, v, sv, b, h, k0, Tk);
  if (qt0 < nqt) stage_q(qt0);
  hopper::cp_async_commit();

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk_acc[n][i] = dv_acc[n][i] = 0.f;

  for (int qt = qt0; qt < nqt; ++qt) {
    if (qt + 1 < nqt) stage_q(qt + 1);
    hopper::cp_async_commit();
    hopper::cp_async_wait<1>();
    __syncthreads();
    const int buf = (qt - qt0) & 1;
    const bf16* sQ = sQdO + buf * 2 * BQ * LD;
    const bf16* sdO = sQ + BQ * LD;
    const float* sL = sLD + buf * 2 * BQ;
    const float* sDl = sL + BQ;
    const int q0 = qt * BQ;
    // the warp's 16-query groups of this tile: none past Tq, none when all
    // its keys are masked
    const int qn = kw < k_len ? min(BQ, Tq - q0) : 0;
    for (int qq = 0; qq < qn; qq += 16) {
      if (causal && q0 + qq + 15 < kw) continue;  // wholly above the diagonal
      // a sub-tile wholly inside k_len, Tq and (causal) the diagonal needs
      // no mask
      const bool inner = kw + 16 <= k_len && q0 + qq + 16 <= Tq
                         && (!causal || kw + 15 <= q0 + qq);
      float s[2][4], dp[2][4], p[2][4], ds[2][4];  // keys x queries
      score_pair<D>(s, dp, sK, sV, kr, sQ, sdO, qq, lane);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int kpos = kw + g + 8 * (i >> 1);
          const int col = qq + 8 * j + 2 * t + (i & 1), qpos = q0 + col;
          probs_and_ds<bf16>(
              s[j][i], dp[j][i], sL[col], sDl[col],
              inner
                  || (qpos < Tq && score_valid(qpos, kpos, k_len, causal)),
              scale, &p[j][i], &ds[j][i]);
        }
      uint32_t pa[4], da[4];  // P^T and dS^T, rounded to bf16
      hopper::pack_a(pa, p[0], p[1]);
      hopper::pack_a(da, ds[0], ds[1]);
#pragma unroll
      for (int c = 0; c < D; c += 16) {
        uint32_t f[4];
        hopper::ldmatrix_x4_trans(f, bk_rows<D>(sdO, qq, c, lane));
        hopper::mma_bf16(dv_acc[c / 8], pa, f[0], f[1]);
        hopper::mma_bf16(dv_acc[c / 8 + 1], pa, f[2], f[3]);
        hopper::ldmatrix_x4_trans(f, bk_rows<D>(sQ, qq, c, lane));
        hopper::mma_bf16(dk_acc[c / 8], da, f[0], f[1]);
        hopper::mma_bf16(dk_acc[c / 8 + 1], da, f[2], f[3]);
      }
    }
    __syncthreads();  // this buffer is read before it is staged again
  }
  hopper::cp_async_wait<0>();

  // dK and dV leave through the Q and dO buffers, so that a lane writes 16
  // contiguous bytes of a row (fragment by fragment it would write 4)
  __syncthreads();
  bf16* stage = sQdO + warp * 32 * LD;
  stage_acc<D>(stage, dk_acc, scale, g, t);
  stage_acc<D>(stage + 16 * LD, dv_acc, 1.f, g, t);
  __syncwarp();
  store_rows16<D>(dk, sdk, b, h, kw, Tk, stage, lane);
  store_rows16<D>(dv, sdv, b, h, kw, Tk, stage + 16 * LD, lane);
}

// ---------------------------------------------------------------------------
// B2 in bf16, on tensor cores
// ---------------------------------------------------------------------------
constexpr int kFwdRows = 64;               // query rows a block owns
constexpr int kFwdStep = 64;               // keys of a loop tile
constexpr int kFwdThreads = kFwdRows * 4;  // two warps per 16 query rows

// forward block: the Q tile, then two buffers of a K and a V tile
template <int D> constexpr size_t fwd_smem_bytes() {
  return (kFwdRows + 4 * kFwdStep) * tile_ld<D>() * sizeof(bf16);
}

// B2: one block of kFwdThreads per (batch*head, kFwdRows query rows);
// warps 2m and 2m+1 own query rows [16m, 16m + 16) of the tile and take
// its even and odd 16-key groups. Each keeps its own m, l and O (D/8
// fragments of 16x8) in registers and takes one online-softmax step per
// 16-key sub-tile: S into registers, row max and sum over the row's four
// lanes, rescale of O, then p, rounded to bf16 in registers as the A
// operand, times V. K and V arrive double-buffered, 16 keys at a time
// behind an mbarrier each, as B3 stages them. At the end the odd warp's
// state is merged into the even one's through shared memory, in that
// order. A warp whose rows lie wholly past Tq only helps stage. Two
// blocks an SM, as shared memory allows: at most 128 registers a thread.
// o rows start on 16 bytes (the wrapper allocates it).
template <int D>
__global__ void __launch_bounds__(kFwdThreads, 2)
    fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, bf16* __restrict__ o,
                   float* __restrict__ lse, Strides sq, Strides sk,
                   Strides sv, Strides so, int H, int Tq, int Tk, int k_len,
                   float scale, bool causal) {
  constexpr int BQ = kFwdRows, BK = kFwdStep, LD = tile_ld<D>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sKV = sQ + BQ * LD;  // [buffer][K, V][BK][LD]
  const int bh = blockIdx.x, b = bh / H, h = bh % H, q0 = blockIdx.y * BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rg = warp >> 1, par = warp & 1, r0 = q0 + 16 * rg;
  // keys the block, and this warp, need: before k_len and, causal, not
  // after the last query; none for rows wholly past Tq
  const int kend = causal ? min(k_len, min(q0 + BQ, Tq)) : k_len;
  const int kend_w = r0 >= Tq ? 0
                     : causal ? min(k_len, min(r0 + 16, Tq))
                              : k_len;
  const int nkt = (kend + BK - 1) / BK;

  __shared__ uint64_t bars[2][BK / 16];
  if (threadIdx.x == 0)
    for (int i = 0; i < 2 * (BK / 16); ++i)
      hopper::mbar_init(&bars[0][0] + i, kFwdThreads);
  __syncthreads();
  auto stage_kv = [&](int kt) {
    bf16* dst = sKV + (kt & 1) * 2 * BK * LD;
    for (int c = 0; c < BK / 16; ++c) {
      const int row0 = kt * BK + 16 * c;
      stage_tile<D, 16, kFwdThreads>(dst + 16 * c * LD, k, sk, b, h, row0,
                                     Tk);
      stage_tile<D, 16, kFwdThreads>(dst + (BK + 16 * c) * LD, v, sv, b, h,
                                     row0, Tk);
      hopper::mbar_arrive_copies(&bars[kt & 1][c]);
    }
  };
  // Q first: the first 16 keys' barrier covers it too
  if (nkt > 0) {
    stage_tile<D, BQ, kFwdThreads>(sQ, q, sq, b, h, q0, Tq);
    stage_kv(0);
  }

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};  // rows g, g + 8

  for (int kt = 0; kt < nkt; ++kt) {
    if (kt + 1 < nkt) stage_kv(kt + 1);
    const bf16* sK = sKV + (kt & 1) * 2 * BK * LD;
    const bf16* sV = sK + BK * LD;
    const int k0 = kt * BK;
    const int kn = min(BK, kend_w - k0);  // keys of this tile the warp takes
    // one online-softmax step per 16-key sub-tile, as soon as its keys
    // have landed: S into registers, masked on the diagonal and edge
    // sub-tiles only; rows g and g + 8 reduced over their four lanes
    for (int kk = 16 * par; kk < kn; kk += 32) {
      hopper::mbar_wait(&bars[kt & 1][kk / 16], (kt >> 1) & 1);
      float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int c = 0; c < D; c += 16) {
        uint32_t fq[4], fk[4];
        hopper::ldmatrix_x4(fq, a_rows<D>(sQ, 16 * rg, c, lane));
        hopper::ldmatrix_x4(fk, bn_rows<D>(sK, kk, c, lane));
        hopper::mma_bf16(s[0], fq, fk[0], fk[1]);
        hopper::mma_bf16(s[1], fq, fk[2], fk[3]);
      }
      const int kb = k0 + kk;
      const bool inner = kb + 16 <= k_len && (!causal || kb + 15 <= r0);
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int qpos = r0 + g + 8 * (i >> 1);
          const int kpos = kb + 8 * jj + 2 * t + (i & 1);
          s[jj][i] = inner || score_valid(qpos, kpos, k_len, causal)
                         ? s[jj][i] * scale
                         : kNegInf;
          mx[i >> 1] = fmaxf(mx[i >> 1], s[jj][i]);
        }
      float m_new[2], psum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        m_new[r] = fmaxf(m[r], mx[r]);
      }
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float x = s[jj][i];
          const float p = x <= kNegInf / 2 ? 0.f : expf(x - m_new[i >> 1]);
          s[jj][i] = p;
          psum[i >> 1] += p;
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 1);
        psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 2);
        const float corr = expf(m[r] - m_new[r]);
        l[r] = l[r] * corr + psum[r];
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          acc[n][2 * r] *= corr;
          acc[n][2 * r + 1] *= corr;
        }
        m[r] = m_new[r] <= kNegInf / 2 ? m[r] : m_new[r];  // m_keep
      }
      // O += P.V, p rounded to bf16 (the Pallas `p.astype(v.dtype)`)
      uint32_t pa[4];
      hopper::pack_a(pa, s[0], s[1]);
#pragma unroll
      for (int c = 0; c < D; c += 16) {
        uint32_t fv[4];
        hopper::ldmatrix_x4_trans(fv, bk_rows<D>(sV, kk, c, lane));
        hopper::mma_bf16(acc[c / 8], pa, fv[0], fv[1]);
        hopper::mma_bf16(acc[c / 8 + 1], pa, fv[2], fv[3]);
      }
    }
    __syncthreads();  // this buffer is read before it is staged again
  }
  hopper::cp_async_wait_all();

  // the odd warp's m, l and O onto the even one's, through the K and V
  // buffers; O leaves through the warp pair's Q rows, 16 contiguous bytes
  // a lane; a fully masked row (l == 0) gets O = 0 and lse 0: the backward
  // re-masks it
  __syncthreads();  // every copy has landed
  float4* red =
      reinterpret_cast<float4*>(sKV) + rg * (D / 8 + 1) * 32 + lane;
  if (par) {
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      red[n * 32] = make_float4(acc[n][0], acc[n][1], acc[n][2], acc[n][3]);
    red[D / 8 * 32] = make_float4(m[0], m[1], l[0], l[1]);
  }
  __syncthreads();
  if (par) return;
  {
    const float4 ml = red[D / 8 * 32];
    const float mo[2] = {ml.x, ml.y}, lo[2] = {ml.z, ml.w};
    float ce[2], co[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mt = fmaxf(m[r], mo[r]);
      ce[r] = expf(m[r] - mt);
      co[r] = expf(mo[r] - mt);
      l[r] = l[r] * ce[r] + lo[r] * co[r];
      m[r] = mt;
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const float4 a = red[n * 32];
      acc[n][0] = acc[n][0] * ce[0] + a.x * co[0];
      acc[n][1] = acc[n][1] * ce[0] + a.y * co[0];
      acc[n][2] = acc[n][2] * ce[1] + a.z * co[1];
      acc[n][3] = acc[n][3] * ce[1] + a.w * co[1];
    }
  }
  float denom[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    denom[r] = fmaxf(l[r], 1e-30f);
    const float inv = 1.f / denom[r];
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][2 * r] *= inv;
      acc[n][2 * r + 1] *= inv;
    }
  }
  bf16* stage = sQ + 16 * rg * LD;
  stage_acc<D>(stage, acc, 1.f, g, t);
  __syncwarp();
  store_rows16<D>(o, so, b, h, r0, Tq, stage, lane);
  if (t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qpos = r0 + g + 8 * r;
      if (qpos < Tq)
        lse[(long long)bh * Tq + qpos] =
            l[r] > 0.f ? m[r] + logf(denom[r]) : 0.f;
    }
  }
}

// ---------------------------------------------------------------------------
// B2, B3 and B4 in fp32, on tensor cores at fp32 accuracy (3xTF32)
// ---------------------------------------------------------------------------

// An fp32 tile row in shared memory: D + 4 floats (4 more than a multiple
// of 32 at D = 64 and 128), so that every row starts on 16 bytes, the
// eight rows one ldmatrix matrix reads lie in distinct banks, and so do
// a warp's plain reads of rows 2t and 2t+1 of columns c + g (banks 8t + g
// and 8t + 4 + g, past a common offset).
template <int D> __host__ __device__ constexpr int f32_ld() { return D + 4; }

// dq block: Q and dO tiles, then two buffers of a K and a V tile
template <int D> constexpr size_t dq_tf32_smem_bytes() {
  return (2 * kBwdRows + 4 * kBwdStep) * f32_ld<D>() * sizeof(float);
}
// dk/dv block: K and V tiles, two buffers of a Q and a dO tile, then two
// buffers of the Q tile's lse and delta rows
template <int D> constexpr size_t dkv_tf32_smem_bytes() {
  return dq_tf32_smem_bytes<D>() + 4 * kBwdStep * sizeof(float);
}

// Issues the copies of rows [row0, row0 + ROWS) of one (batch, head) of a
// [B, T, H, D] fp32 tensor into a shared tile; rows at or past `len` are
// zero. Rows that start on 16 bytes (the model's qkv views and contiguous
// tensors) go by cp.async, 16 bytes at a time; others by element loads.
template <int D, int ROWS, int THREADS>
__device__ __forceinline__ void stage_tile_f32(float* dst,
                                               const float* __restrict__ src,
                                               Strides st, int b, int h,
                                               int row0, int len) {
  const float* base = src + b * st.b + h * st.h;
  const bool aligned =
      reinterpret_cast<uintptr_t>(base) % 16 == 0 && st.t % 4 == 0;
  constexpr int kChunks = D / 4;  // 16-byte chunks a row
  for (int e = threadIdx.x; e < ROWS * kChunks; e += THREADS) {
    const int r = e / kChunks, c = e % kChunks * 4, t = row0 + r;
    const bool ok = t < len;
    float* d = dst + r * f32_ld<D>() + c;
    const float* s = base + (long long)(ok ? t : 0) * st.t + c;
    if (aligned) {
      hopper::cp_async16(d, s, ok);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) d[i] = ok ? s[i] : 0.f;
    }
  }
}

// Lane's row address for an ldmatrix.x4 of the tf32 A operand (16 rows x
// 8 columns) at (row r, col c) of an fp32 tile: matrices (rows 0-7, 8-15)
// x (cols 0-3, 4-7).
template <int D>
__device__ __forceinline__ const float* a_rows_f32(const float* tile, int r,
                                                   int c, int lane) {
  return tile + (r + (lane & 15)) * f32_ld<D>() + c + (lane >> 4) * 4;
}
// ... for the B operands of two side-by-side n8 products that read rows
// [r, r + 16) of a tile as their n axis and cols [c, c + 8) as k: r[0],
// r[1] feed the product of rows r..r+7, r[2], r[3] that of rows r+8..r+15.
template <int D>
__device__ __forceinline__ const float* bn_rows_f32(const float* tile, int r,
                                                    int c, int lane) {
  return tile + (r + (lane & 7) + (lane >> 4) * 8) * f32_ld<D>() + c
         + ((lane >> 3) & 1) * 4;
}

// The 16x16 sub-tile s = a . b^T of rows [ra, ra+16) of tile a and rows
// [rb, rb+16) of tile b over the head dim, 3xTF32: s[j] holds columns
// 8j..8j+7. With FRESH false the tensor cores sum all of it. With FRESH
// true each 8 columns' three products start from zero and their sum is
// added on the CUDA cores, rounded to nearest: the tensor cores truncate
// what they accumulate, and along the head dim that bias grows with the
// sum, which dP cannot afford: ds = p (dP - delta) cancels it against
// delta, computed in fp32. The head dim is taken U k-steps of 8 at a time
// in a loop that is not unrolled, which bounds how far ahead the compiler
// hoists loads and splits, and so the registers they hold.
template <int D, bool FRESH, int U = D / 8>
__device__ __forceinline__ void score_tf32(float (&s)[2][4], const float* a,
                                           int ra, const float* b, int rb,
                                           int lane) {
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[j][i] = 0.f;
#pragma unroll 1
  for (int c0 = 0; c0 < D; c0 += 8 * U)
#pragma unroll
  for (int c = c0; c < c0 + 8 * U; c += 8) {
    uint32_t f[4], ahi[4], alo[4], bhi[4], blo[4];
    hopper::ldmatrix_x4(f, a_rows_f32<D>(a, ra, c, lane));
    hopper::split_tf32(f, ahi, alo);
    hopper::ldmatrix_x4(f, bn_rows_f32<D>(b, rb, c, lane));
    hopper::split_tf32(f, bhi, blo);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (FRESH) {
        float part[4] = {0.f, 0.f, 0.f, 0.f};
        hopper::mma_3xtf32(part, ahi, alo, bhi[2 * j], bhi[2 * j + 1],
                           blo[2 * j], blo[2 * j + 1]);
#pragma unroll
        for (int i = 0; i < 4; ++i) s[j][i] += part[i];
      } else {
        hopper::mma_3xtf32(s[j], ahi, alo, bhi[2 * j], bhi[2 * j + 1],
                           blo[2 * j], blo[2 * j + 1]);
      }
    }
  }
}

// acc (16 x D: acc[n] holds columns 8n..8n+7) += A . rows [r, r + 8) of
// a tile, 3xTF32, where A is the split 16x8 operand of one k8 half (ahi,
// alo from `split_a_tf32`: k t and t+4 are rows r + 2t and r + 2t + 1).
// Each lane reads its B values, rows 2t and 2t+1 of column 8n + g, by
// plain loads: ldmatrix.trans moves 16-bit elements and cannot transpose
// fp32.
template <int D>
__device__ __forceinline__ void acc_rows8_tf32(float (&acc)[D / 8][4],
                                               const uint32_t (&ahi)[4],
                                               const uint32_t (&alo)[4],
                                               const float* tile, int r,
                                               int g, int t) {
  constexpr int LD = f32_ld<D>();
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const float* col = tile + (r + 2 * t) * LD + 8 * n + g;
    uint32_t hi0, lo0, hi1, lo1;
    hopper::split_tf32(col[0], hi0, lo0);
    hopper::split_tf32(col[LD], hi1, lo1);
    hopper::mma_3xtf32(acc[n], ahi, alo, hi0, hi1, lo0, lo1);
  }
}

// acc (16 x D) += A . rows [r, r + 16) of a tile, 3xTF32, where A is the
// split 16x16 operand of two k8 halves (ahi[j], alo[j]: half j is rows
// r + 8j .. r + 8j + 7), one half after the other.
template <int D>
__device__ __forceinline__ void acc_rows_tf32(float (&acc)[D / 8][4],
                                              const uint32_t (&ahi)[2][4],
                                              const uint32_t (&alo)[2][4],
                                              const float* tile, int r, int g,
                                              int t) {
  acc_rows8_tf32<D>(acc, ahi[0], alo[0], tile, r, g, t);
  acc_rows8_tf32<D>(acc, ahi[1], alo[1], tile, r + 8, g, t);
}

// B3 in fp32: dq_mma_kernel's layout with 3xTF32 products. One block of
// kDqThreads per (batch*head, kBwdRows query rows); warps 2m and 2m+1 own
// query rows [16m, 16m + 16) of the tile and take its even and odd 16-key
// groups, each summing its own dQ in registers; K and V arrive 16 keys at
// a time behind an mbarrier each, double-buffered; at the end the odd
// warp's sum is added to the even one's through shared memory, in that
// order. The blocks take the query tiles from the last: causal, those
// have the most keys, so they start first. Two blocks an SM at D = 64 (at
// most 128 registers a thread), one at D = 128, as shared memory allows.
// dq rows start on 8 bytes (the wrapper allocates it).
template <int D>
__global__ void __launch_bounds__(kDqThreads, D == 64 ? 2 : 1)
    dq_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v,
                   const float* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, float* __restrict__ dq,
                   Strides sq, Strides sk, Strides sv, Strides sdo,
                   Strides sdq, int H, int Tq, int Tk, int k_len,
                   float scale, bool causal) {
  constexpr int BQ = kBwdRows, BK = kBwdStep, LD = f32_ld<D>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);
  float* sdO = sQ + BQ * LD;
  float* sKV = sdO + BQ * LD;  // [buffer][K, V][BK][LD]
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rg = warp >> 1, par = warp & 1, r0 = q0 + 16 * rg;
  // keys the block, and this warp, need: before k_len and, causal, not
  // after the last query
  const int kend = causal ? min(k_len, min(q0 + BQ, Tq)) : k_len;
  const int kend_w = causal ? min(k_len, min(r0 + 16, Tq)) : k_len;
  const int nkt = (kend + BK - 1) / BK;

  __shared__ uint64_t bars[2][BK / 16];
  if (threadIdx.x == 0)
    for (int i = 0; i < 2 * (BK / 16); ++i)
      hopper::mbar_init(&bars[0][0] + i, kDqThreads);
  __syncthreads();
  auto stage_kv = [&](int kt) {
    float* dst = sKV + (kt & 1) * 2 * BK * LD;
    for (int c = 0; c < BK / 16; ++c) {
      const int row0 = kt * BK + 16 * c;
      stage_tile_f32<D, 16, kDqThreads>(dst + 16 * c * LD, k, sk, b, h, row0,
                                        Tk);
      stage_tile_f32<D, 16, kDqThreads>(dst + (BK + 16 * c) * LD, v, sv, b,
                                        h, row0, Tk);
      hopper::mbar_arrive_copies(&bars[kt & 1][c]);
    }
  };
  // Q and dO first: the first 16 keys' barrier covers them too
  stage_tile_f32<D, BQ, kDqThreads>(sQ, q, sq, b, h, q0, Tq);
  stage_tile_f32<D, BQ, kDqThreads>(sdO, dout, sdo, b, h, q0, Tq);
  if (nkt > 0) stage_kv(0);

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;

  for (int kt = 0; kt < nkt; ++kt) {
    if (kt + 1 < nkt) stage_kv(kt + 1);
    const float* sK = sKV + (kt & 1) * 2 * BK * LD;
    const float* sV = sK + BK * LD;
    const int k0 = kt * BK;
    // the warp's 16-key groups of this tile (every other one): none past
    // its last key
    const int kn = r0 < Tq ? min(BK, kend_w - k0) : 0;
    for (int kk = 16 * par; kk < kn; kk += 32) {
      hopper::mbar_wait(&bars[kt & 1][kk / 16], (kt >> 1) & 1);
      // lse and delta of rows g and g + 8, read again for each sub-tile:
      // held across the loop, they would take registers the kernel lacks
      float lse_r[2], delta_r[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int qpos = r0 + g + 8 * i;
        lse_r[i] = qpos < Tq ? lse[(long long)bh * Tq + qpos] : 0.f;
        delta_r[i] = qpos < Tq ? delta[(long long)bh * Tq + qpos] : 0.f;
      }
      // dP's head dim 2 k-steps at a time: with S's unrolled whole, the
      // kernel keeps within its 128 registers
      float s[2][4], dp[2][4];
      score_tf32<D, false>(s, sQ, 16 * rg, sK, kk, lane);
      score_tf32<D, true, 2>(dp, sdO, 16 * rg, sV, kk, lane);
      uint32_t dhi[2][4], dlo[2][4];  // dS, split: the A operand of dS.K
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float ds[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int qpos = r0 + g + 8 * (i >> 1);
          const int kpos = k0 + kk + 8 * j + 2 * t + (i & 1);
          float p;
          probs_and_ds<float>(
              s[j][i], dp[j][i], lse_r[i >> 1], delta_r[i >> 1],
              qpos < Tq && score_valid(qpos, kpos, k_len, causal), scale, &p,
              &ds[i]);
        }
        hopper::split_a_tf32(ds, dhi[j], dlo[j]);
      }
      acc_rows_tf32<D>(acc, dhi, dlo, sK, kk, g, t);
    }
    __syncthreads();  // this buffer is read before it is staged again
  }
  hopper::cp_async_wait_all();

  // the odd warp's dQ onto the even one's, through the K and V buffers
  __syncthreads();
  float4* red = reinterpret_cast<float4*>(sKV) + rg * (D / 8) * 32 + lane;
  if (par) {
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      red[n * 32] = make_float4(acc[n][0], acc[n][1], acc[n][2], acc[n][3]);
  }
  __syncthreads();
  if (par) return;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const float4 o = red[n * 32];
    acc[n][0] += o.x;
    acc[n][1] += o.y;
    acc[n][2] += o.z;
    acc[n][3] += o.w;
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qpos = r0 + g + 8 * i;
    if (qpos >= Tq) continue;
    float* row = dq + b * sdq.b + (long long)qpos * sdq.t + h * sdq.h;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<float2*>(row + 8 * n + 2 * t) =
          make_float2(scale * acc[n][2 * i], scale * acc[n][2 * i + 1]);
  }
}

// B4 in fp32: dkv_mma_kernel's layout with 3xTF32 products. One block of
// kDkvThreads per (batch*head, kBwdRows key rows); warp m owns key rows
// [16m, 16m + 16) of the tile and all of the head dim of their dK and dV
// in registers; the query tiles arrive whole, double-buffered (commit
// groups and a block barrier). The blocks take the key tiles in order:
// causal, the first have the most queries, so they start first. Two
// blocks an SM at D = 64, one at D = 128, as shared memory allows: up to
// 255 registers a thread. dk and dv rows start on 8 bytes (the wrapper
// allocates them).
template <int D>
__global__ void __launch_bounds__(kDkvThreads, D == 64 ? 2 : 1)
    dkv_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dk,
                    float* __restrict__ dv, Strides sq, Strides sk,
                    Strides sv, Strides sdo, Strides sdk, Strides sdv, int H,
                    int Tq, int Tk, int k_len, float scale, bool causal) {
  constexpr int BK = kBwdRows, BQ = kBwdStep, LD = f32_ld<D>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sK = reinterpret_cast<float*>(smem_raw);
  float* sV = sK + BK * LD;
  float* sQdO = sV + BK * LD;         // [buffer][Q, dO][BQ][LD]
  float* sLD = sQdO + 4 * BQ * LD;    // [buffer][lse, delta][BQ]
  const int bh = blockIdx.x, b = bh / H, h = bh % H, k0 = blockIdx.y * BK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kr = 16 * warp, kw = k0 + kr;
  // query tiles the block needs: none when all its keys are masked; causal,
  // none wholly before its first key
  const int qt0 = causal ? k0 / BQ : 0;
  const int nqt = k0 < k_len ? (Tq + BQ - 1) / BQ : qt0;

  auto stage_q = [&](int qt) {
    const int buf = (qt - qt0) & 1;
    float* dst = sQdO + buf * 2 * BQ * LD;
    float* vec = sLD + buf * 2 * BQ;
    stage_tile_f32<D, BQ, kDkvThreads>(dst, q, sq, b, h, qt * BQ, Tq);
    stage_tile_f32<D, BQ, kDkvThreads>(dst + BQ * LD, dout, sdo, b, h,
                                       qt * BQ, Tq);
    stage_vec<BQ, kDkvThreads>(vec, lse + (long long)bh * Tq, qt * BQ, Tq);
    stage_vec<BQ, kDkvThreads>(vec + BQ, delta + (long long)bh * Tq, qt * BQ,
                               Tq);
  };
  stage_tile_f32<D, BK, kDkvThreads>(sK, k, sk, b, h, k0, Tk);
  stage_tile_f32<D, BK, kDkvThreads>(sV, v, sv, b, h, k0, Tk);
  if (qt0 < nqt) stage_q(qt0);
  hopper::cp_async_commit();

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk_acc[n][i] = dv_acc[n][i] = 0.f;

  for (int qt = qt0; qt < nqt; ++qt) {
    if (qt + 1 < nqt) stage_q(qt + 1);
    hopper::cp_async_commit();
    hopper::cp_async_wait<1>();
    __syncthreads();
    const int buf = (qt - qt0) & 1;
    const float* sQ = sQdO + buf * 2 * BQ * LD;
    const float* sdO = sQ + BQ * LD;
    const float* sL = sLD + buf * 2 * BQ;
    const float* sDl = sL + BQ;
    const int q0 = qt * BQ;
    // the warp's 16-query groups of this tile: none past Tq, none when all
    // its keys are masked
    const int qn = kw < k_len ? min(BQ, Tq - q0) : 0;
    for (int qq = 0; qq < qn; qq += 16) {
      if (causal && q0 + qq + 15 < kw) continue;  // wholly above the diagonal
      // a sub-tile wholly inside k_len, Tq and (causal) the diagonal needs
      // no mask
      const bool inner = kw + 16 <= k_len && q0 + qq + 16 <= Tq
                         && (!causal || kw + 15 <= q0 + qq);
      // keys x queries; at D = 128, 4 k-steps at a time, within 255
      // registers
      constexpr int U = D == 128 ? 4 : D / 8;
      float s[2][4], dp[2][4];
      score_tf32<D, false, U>(s, sK, kr, sQ, qq, lane);
      score_tf32<D, true, U>(dp, sV, kr, sdO, qq, lane);
      // P^T and dS^T, split: the A operands of P^T.dO and dS^T.Q
      uint32_t phi[2][4], plo[2][4], dhi[2][4], dlo[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float p[4], ds[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int kpos = kw + g + 8 * (i >> 1);
          const int col = qq + 8 * j + 2 * t + (i & 1), qpos = q0 + col;
          probs_and_ds<float>(
              s[j][i], dp[j][i], sL[col], sDl[col],
              inner
                  || (qpos < Tq && score_valid(qpos, kpos, k_len, causal)),
              scale, &p[i], &ds[i]);
        }
        hopper::split_a_tf32(p, phi[j], plo[j]);
        hopper::split_a_tf32(ds, dhi[j], dlo[j]);
      }
      acc_rows_tf32<D>(dv_acc, phi, plo, sdO, qq, g, t);
      acc_rows_tf32<D>(dk_acc, dhi, dlo, sQ, qq, g, t);
    }
    __syncthreads();  // this buffer is read before it is staged again
  }
  hopper::cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kpos = kw + g + 8 * i;
    if (kpos >= Tk) continue;
    float* krow = dk + b * sdk.b + (long long)kpos * sdk.t + h * sdk.h;
    float* vrow = dv + b * sdv.b + (long long)kpos * sdv.t + h * sdv.h;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<float2*>(krow + 8 * n + 2 * t) = make_float2(
          scale * dk_acc[n][2 * i], scale * dk_acc[n][2 * i + 1]);
      *reinterpret_cast<float2*>(vrow + 8 * n + 2 * t) =
          make_float2(dv_acc[n][2 * i], dv_acc[n][2 * i + 1]);
    }
  }
}

// Query rows a block owns, which is also the keys of a loop tile, and
// threads a block at head dim D. At D = 128, 32 rows and 32 keys, so that two blocks share an SM
// (84,480 bytes each): at the LM flagship's width ([32, 80, 4, 128]) its
// 384 blocks, two an SM, ran 10% faster than 256 blocks of 64 rows, one
// an SM.
template <int D> __host__ __device__ constexpr int fwd_tf32_tile() {
  return D == 128 ? 32 : 64;
}
template <int D> __host__ __device__ constexpr int fwd_tf32_threads() {
  return fwd_tf32_tile<D>() * 4;  // two warps per 16 query rows
}
// forward block: the Q tile, then two buffers of a K and a V tile (87 KB
// at D = 64, 84 KB at D = 128: two blocks an SM)
template <int D> constexpr size_t fwd_tf32_smem_bytes() {
  return 5 * fwd_tf32_tile<D>() * f32_ld<D>() * sizeof(float);
}

// B2 in fp32: fwd_mma_kernel's layout with 3xTF32 products. One block of
// fwd_tf32_threads<D>() per (batch*head, fwd_tf32_tile<D>() query rows);
// warps 2m and 2m+1 own query rows [16m, 16m + 16) of the tile and take
// its even and odd 16-key groups. Each keeps its own m, l and O (D/8
// fragments of 16x8) in registers and takes one online-softmax step per
// 16-key sub-tile: S = Q.K^T (Q and K through ldmatrix) into registers,
// row max and sum over the row's four lanes, rescale of O, then p, in
// fp32 and split as it stands (the A operand), times V by plain loads.
// K and V arrive double-buffered, 16 keys at a time behind an mbarrier
// each, as B3 stages them. At the end the odd warp's state is merged into
// the even one's through shared memory, in that order. A warp whose rows
// lie wholly past Tq only helps stage. The blocks take the query tiles
// from the last: causal, those have the most keys, so they start first.
// Two blocks an SM, as shared memory allows: at most 128 registers a
// thread at D = 64 (256 threads), 255 at D = 128 (128 threads). o rows
// start on 8 bytes (the wrapper allocates it).
template <int D>
__global__ void __launch_bounds__(fwd_tf32_threads<D>(), 2)
    fwd_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ o,
                    float* __restrict__ lse, Strides sq, Strides sk,
                    Strides sv, Strides so, int H, int Tq, int Tk, int k_len,
                    float scale, bool causal) {
  constexpr int BQ = fwd_tf32_tile<D>(), BK = BQ;
  constexpr int LD = f32_ld<D>(), THREADS = fwd_tf32_threads<D>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);
  float* sKV = sQ + BQ * LD;  // [buffer][K, V][BK][LD]
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rg = warp >> 1, par = warp & 1, r0 = q0 + 16 * rg;
  // keys the block, and this warp, need: before k_len and, causal, not
  // after the last query; none for rows wholly past Tq
  const int kend = causal ? min(k_len, min(q0 + BQ, Tq)) : k_len;
  const int kend_w = r0 >= Tq ? 0
                     : causal ? min(k_len, min(r0 + 16, Tq))
                              : k_len;
  const int nkt = (kend + BK - 1) / BK;

  __shared__ uint64_t bars[2][BK / 16];
  if (threadIdx.x == 0)
    for (int i = 0; i < 2 * (BK / 16); ++i)
      hopper::mbar_init(&bars[0][0] + i, THREADS);
  __syncthreads();
  auto stage_kv = [&](int kt) {
    float* dst = sKV + (kt & 1) * 2 * BK * LD;
    for (int c = 0; c < BK / 16; ++c) {
      const int row0 = kt * BK + 16 * c;
      stage_tile_f32<D, 16, THREADS>(dst + 16 * c * LD, k, sk, b, h, row0,
                                     Tk);
      stage_tile_f32<D, 16, THREADS>(dst + (BK + 16 * c) * LD, v, sv, b, h,
                                     row0, Tk);
      hopper::mbar_arrive_copies(&bars[kt & 1][c]);
    }
  };
  // Q first: the first 16 keys' barrier covers it too
  if (nkt > 0) {
    stage_tile_f32<D, BQ, THREADS>(sQ, q, sq, b, h, q0, Tq);
    stage_kv(0);
  }

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};  // rows g, g + 8

  for (int kt = 0; kt < nkt; ++kt) {
    if (kt + 1 < nkt) stage_kv(kt + 1);
    const float* sK = sKV + (kt & 1) * 2 * BK * LD;
    const float* sV = sK + BK * LD;
    const int k0 = kt * BK;
    const int kn = min(BK, kend_w - k0);  // keys of this tile the warp takes
    // one online-softmax step per 16-key sub-tile, as soon as its keys
    // have landed: S into registers, masked on the diagonal and edge
    // sub-tiles only; rows g and g + 8 reduced over their four lanes
    for (int kk = 16 * par; kk < kn; kk += 32) {
      hopper::mbar_wait(&bars[kt & 1][kk / 16], (kt >> 1) & 1);
      float s[2][4];
      score_tf32<D, false>(s, sQ, 16 * rg, sK, kk, lane);
      const int kb = k0 + kk;
      const bool inner = kb + 16 <= k_len && (!causal || kb + 15 <= r0);
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int qpos = r0 + g + 8 * (i >> 1);
          const int kpos = kb + 8 * jj + 2 * t + (i & 1);
          s[jj][i] = inner || score_valid(qpos, kpos, k_len, causal)
                         ? s[jj][i] * scale
                         : kNegInf;
          mx[i >> 1] = fmaxf(mx[i >> 1], s[jj][i]);
        }
      float m_new[2], psum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        m_new[r] = fmaxf(m[r], mx[r]);
      }
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float x = s[jj][i];
          const float p = x <= kNegInf / 2 ? 0.f : expf(x - m_new[i >> 1]);
          s[jj][i] = p;
          psum[i >> 1] += p;
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 1);
        psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 2);
        const float corr = expf(m[r] - m_new[r]);
        l[r] = l[r] * corr + psum[r];
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          acc[n][2 * r] *= corr;
          acc[n][2 * r + 1] *= corr;
        }
        m[r] = m_new[r] <= kNegInf / 2 ? m[r] : m_new[r];  // m_keep
      }
      // O += P.V with p in fp32 (the Pallas `p.astype(v.dtype)` keeps
      // it), split as the A operand as it stands, one 8-key half at a
      // time: with both halves split before either product (as B3 and B4
      // split them for acc_rows_tf32) the kernel spilled at D = 64
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        uint32_t phi[4], plo[4];
        hopper::split_a_tf32(s[j], phi, plo);
        acc_rows8_tf32<D>(acc, phi, plo, sV, kk + 8 * j, g, t);
      }
    }
    __syncthreads();  // this buffer is read before it is staged again
  }
  hopper::cp_async_wait_all();

  // the odd warp's m, l and O onto the even one's, through the K and V
  // buffers; a fully masked row (l == 0) gets O = 0 and lse 0: the
  // backward re-masks it
  __syncthreads();  // every copy has landed
  float4* red =
      reinterpret_cast<float4*>(sKV) + rg * (D / 8 + 1) * 32 + lane;
  if (par) {
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      red[n * 32] = make_float4(acc[n][0], acc[n][1], acc[n][2], acc[n][3]);
    red[D / 8 * 32] = make_float4(m[0], m[1], l[0], l[1]);
  }
  __syncthreads();
  if (par) return;
  {
    const float4 ml = red[D / 8 * 32];
    const float mo[2] = {ml.x, ml.y}, lo[2] = {ml.z, ml.w};
    float ce[2], co[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mt = fmaxf(m[r], mo[r]);
      ce[r] = expf(m[r] - mt);
      co[r] = expf(mo[r] - mt);
      l[r] = l[r] * ce[r] + lo[r] * co[r];
      m[r] = mt;
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const float4 a = red[n * 32];
      acc[n][0] = acc[n][0] * ce[0] + a.x * co[0];
      acc[n][1] = acc[n][1] * ce[0] + a.y * co[0];
      acc[n][2] = acc[n][2] * ce[1] + a.z * co[1];
      acc[n][3] = acc[n][3] * ce[1] + a.w * co[1];
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = r0 + g + 8 * r;
    if (qpos >= Tq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    float* row = o + b * so.b + (long long)qpos * so.t + h * so.h;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<float2*>(row + 8 * n + 2 * t) =
          make_float2(acc[n][2 * r] / denom, acc[n][2 * r + 1] / denom);
    if (t == 0)
      lse[(long long)bh * Tq + qpos] = l[r] > 0.f ? m[r] + logf(denom) : 0.f;
  }
}

// ---------------------------------------------------------------------------
// B2, B3 and B4 at head dims above 128 (any multiple of 128), bf16 and fp32
// ---------------------------------------------------------------------------
// The kernels above hold a block's tiles and a warp's accumulators over
// the whole head dim, sized per D by template; at D 256 the bf16 dk/dv
// kernel would need 256 accumulators a thread and the fp32 dq and dk/dv
// kernels about 400 KB of shared memory a block. So here the head dim is
// cut into chunks of kChunk = 128 columns, and a warp's accumulators cover
// one chunk (O, dQ: 64 fp32 registers a thread; dK and dV: 128), as at D
// 128. The forward (fwd_wide_kernel, below) gives each 16 query rows one
// warp per chunk and forms S once. B3 and B4 keep the budget the same at
// every D: a block owns rows x output columns [c0, c0 + 128) (grid axis z
// = chunk) and stages its operands through shared memory 128 columns at a
// time. Their score products S = Q.K^T and dP = dO.V^T sum over the whole
// head dim: every chunk block forms them again (D / 128 times the score
// work), one staged chunk after the other, each chunk's 16x16 sub-tile
// summed from zero and added in fp32 to its running sum, which waits in
// shared memory between chunks (so a warp's registers hold one sub-tile,
// as in the kernels above). The block's own chunk comes last: its tile of
// K (B3) or Q and dO (B4) is then in shared memory for the accumulating
// product. In fp32 the tensor cores' truncated sums thus restart every
// 128 columns of S (S at D 128's error) and every 8 of dP, as in
// dq_tf32_kernel. Tiles are single-buffered behind a block barrier a
// chunk step; two or three blocks an SM overlap one block's copies with
// another's products. One warp owns 16 rows, so no partial sums meet
// between warps; outputs are stored from registers. Each output element
// has one owner and a fixed order of sums: a repeat call is bit-equal.
constexpr int kChunk = 128;

// Rows a block owns and rows of a loop tile of B3 and B4 above D 128 by
// input type: fp32 tiles take twice the bytes, so its tiles are halved
// where a block would otherwise hold one block an SM
template <typename T> struct Wide;
template <> struct Wide<bf16> {
  static constexpr int LD = tile_ld<kChunk>();
  static constexpr int kDqRows = 64, kDqStep = 64;
  static constexpr int kDkvRows = 64, kDkvStep = 64;
};
template <> struct Wide<float> {
  static constexpr int LD = f32_ld<kChunk>();
  static constexpr int kDqRows = 32, kDqStep = 32;
  static constexpr int kDkvRows = 32, kDkvStep = 32;
};

// dq block: Q, dO, K and V chunk tiles, then the S and dP sums; 102,400
// bytes bf16, 75,776 fp32
template <typename T> constexpr size_t dq_wide_smem_bytes() {
  using W = Wide<T>;
  return 2 * (W::kDqRows + W::kDqStep) * W::LD * sizeof(T)
         + 2 * W::kDqRows * W::kDqStep * sizeof(float);
}
// dk/dv block: K, V, Q and dO chunk tiles, the Q tile's lse and delta
// rows, then the S and dP sums; 102,912 bytes bf16, 76,032 fp32
template <typename T> constexpr size_t dkv_wide_smem_bytes() {
  using W = Wide<T>;
  return 2 * (W::kDkvRows + W::kDkvStep) * W::LD * sizeof(T)
         + 2 * W::kDkvStep * sizeof(float)
         + 2 * W::kDkvRows * W::kDkvStep * sizeof(float);
}

// Issues the copies of columns [c0, c0 + 128) of rows [row0, row0 + ROWS)
// of one (batch, head) into a chunk tile; rows at or past `len` are zero
template <int ROWS, int THREADS>
__device__ __forceinline__ void stage_chunk(bf16* dst, const bf16* src,
                                            Strides st, int b, int h,
                                            int row0, int len, int c0) {
  stage_tile<kChunk, ROWS, THREADS>(dst, src + c0, st, b, h, row0, len);
}
template <int ROWS, int THREADS>
__device__ __forceinline__ void stage_chunk(float* dst, const float* src,
                                            Strides st, int b, int h,
                                            int row0, int len, int c0) {
  stage_tile_f32<kChunk, ROWS, THREADS>(dst, src + c0, st, b, h, row0, len);
}

// The 16x16 sub-tile s = a . b^T of rows [ra, ra+16) of chunk tile a and
// rows [rb, rb+16) of chunk tile b over the chunk's 128 columns, from
// zero: s[j] holds columns 8j..8j+7. bf16 on mma.m16n8k16; fp32 as
// score_tf32 (FRESH, U) takes it.
template <bool FRESH, int U>
__device__ __forceinline__ void chunk_score(float (&s)[2][4], const bf16* a,
                                            int ra, const bf16* b, int rb,
                                            int lane) {
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[j][i] = 0.f;
#pragma unroll
  for (int c = 0; c < kChunk; c += 16) {
    uint32_t fa[4], fb[4];
    hopper::ldmatrix_x4(fa, a_rows<kChunk>(a, ra, c, lane));
    hopper::ldmatrix_x4(fb, bn_rows<kChunk>(b, rb, c, lane));
    hopper::mma_bf16(s[0], fa, fb[0], fb[1]);
    hopper::mma_bf16(s[1], fa, fb[2], fb[3]);
  }
}
template <bool FRESH, int U>
__device__ __forceinline__ void chunk_score(float (&s)[2][4], const float* a,
                                            int ra, const float* b, int rb,
                                            int lane) {
  score_tf32<kChunk, FRESH, U>(s, a, ra, b, rb, lane);
}

// acc (16 x 128: acc[n] holds columns 8n..8n+7) += p . rows [r, r + 16) of
// a chunk tile, where p is a 16x16 sub-tile in the score accumulators'
// layout (its columns the reduction axis): bf16, p rounded to bf16 pairs
// and the tile through ldmatrix.trans; fp32, p split one 8-column half at
// a time and the tile by plain loads (3xTF32), the halves in a loop that
// is not unrolled, so that the second half's loads and splits are not
// hoisted beside the first's (dkv_wide_kernel<float> holds 128
// accumulators and spilled 8-20 bytes with it unrolled)
__device__ __forceinline__ void chunk_acc(float (&acc)[kChunk / 8][4],
                                          const float (&p)[2][4],
                                          const bf16* tile, int r, int lane) {
  uint32_t pa[4];
  hopper::pack_a(pa, p[0], p[1]);
#pragma unroll
  for (int c = 0; c < kChunk; c += 16) {
    uint32_t f[4];
    hopper::ldmatrix_x4_trans(f, bk_rows<kChunk>(tile, r, c, lane));
    hopper::mma_bf16(acc[c / 8], pa, f[0], f[1]);
    hopper::mma_bf16(acc[c / 8 + 1], pa, f[2], f[3]);
  }
}
__device__ __forceinline__ void chunk_acc(float (&acc)[kChunk / 8][4],
                                          const float (&p)[2][4],
                                          const float* tile, int r,
                                          int lane) {
#pragma unroll 1
  for (int j = 0; j < 2; ++j) {
    uint32_t hi[4], lo[4];
    hopper::split_a_tf32(p[j], hi, lo);
    acc_rows8_tf32<kChunk>(acc, hi, lo, tile, r + 8 * j, lane >> 2,
                           lane & 3);
  }
}

// A sub-tile's running sum over the chunks: this chunk's s plus what
// `slot` (256 floats, lane-major) holds from the earlier ones (none on
// the first); kept there for the next chunk unless this is the last
__device__ __forceinline__ void carry_sum(float (&s)[2][4], float* slot,
                                          int lane, bool first, bool last) {
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    float& x = s[e >> 2][e & 3];
    if (!first) x += slot[e * 32 + lane];
    if (!last) slot[e * 32 + lane] = x;
  }
}

// Two adjacent output elements from fp32
__device__ __forceinline__ void store_pair(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// Rows g and g + 8 of a warp's 16 x 128 accumulators, times `mul`, to
// columns [c0, c0 + 128) of rows [row0, row0 + 16) of one (batch, head);
// rows at or past `len` are not written
template <typename T>
__device__ __forceinline__ void store_chunk(T* __restrict__ dst, Strides st,
                                            int b, int h, int row0, int len,
                                            int c0,
                                            const float (&acc)[kChunk / 8][4],
                                            float mul, int g, int t) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + g + 8 * i;
    if (row >= len) continue;
    T* out = dst + b * st.b + (long long)row * st.t + h * st.h + c0;
#pragma unroll
    for (int n = 0; n < kChunk / 8; ++n)
      store_pair(out + 8 * n + 2 * t, mul * acc[n][2 * i],
                 mul * acc[n][2 * i + 1]);
  }
}

// B2 above D 128: fwd_wide_kernel replaces the Pallas `_fwd_kernel`
// (fedml_tpu/ops/pallas_attention.py, pallas_call in `_fwd_one_head`, line
// 123), which holds [block_q, D] blocks of Q, K and V and one [block_q, D]
// accumulator and forms S once a key tile. What bounds it on this card:
// bytes in bf16 (at [32, 512, 4, 256] causal 134 MB, 0.040 ms at 3.35
// TB/s, against 17 GFLOP on the valid pairs, 0.017 ms at 989 TFLOP/s) and
// the 3xTF32 operations in fp32 (three times 17 GFLOP at 495 TFLOP/s,
// 0.104 ms, against 0.080 ms of bytes). A warp's O accumulators cover 128
// columns (64 fp32 registers a thread, as at D 128), so each 16-row strip
// of a block's query tile has one warp per 128-column chunk of the head
// dim: warp (strip, chunk) owns O of those rows and columns. Against the
// four costs of the chunked forward it replaced (S formed D / 128 times,
// Q restaged every key tile and chunk, single-buffered staging, running
// sums parked in shared memory between chunk steps):
// - S is formed once. Each warp sums its chunk's partial S (16 rows x the
//   tile's keys) on the tensor cores from zero; the strip's partials meet
//   in shared memory behind a named barrier of the strip's warps
//   (bar.sync id, n: the other strips do not wait) and each warp adds them
//   in one fixed order, chunk 0 first, so every warp of a strip holds the
//   same S, bit for bit, forms the same m and l, and the chunk-0 warp
//   writes lse. In fp32 a partial is a fresh tensor-core sum over 128
//   columns (the tensor cores truncate what they accumulate), added to the
//   others in fp32: S at D 128's accuracy, as before.
// - Q is staged once, with the first key tile, and stays in shared memory
//   for the whole key loop.
// - K and V tiles, all of the block's head-dim columns, are
//   double-buffered with cp.async groups: tile kt + 1 is in flight while
//   tile kt is multiplied, one block barrier a tile.
// - m, l and O stay in registers; the only shared-memory traffic besides
//   the tiles is one exchange of partial S a key tile. One online-softmax
//   step a key tile: p rounded to bf16 in bf16 (the Pallas
//   `p.astype(v.dtype)`) against the running maximum of whole tiles, kept
//   fp32 and split in fp32; then O += P.V over the warp's 128 columns of V.
// Geometry (FwdWide; rows of D + 8 bf16 or D + 4 fp32 elements; shared
// bytes = Q + two K and V buffers + the warps' partials), chosen among
// 16-, 32- and 64-key tiles, 32- to 128-row blocks and one or two blocks
// an SM by time on the card:
//   D 256 bf16: 64 query rows, 16-key tiles,  8 warps,  75,776 bytes, 2
//   D 384 bf16: 64 query rows, 32-key tiles, 12 warps, 175,104 bytes, 1
//   D 512 bf16: 32 query rows, 16-key tiles,  8 warps, 108,032 bytes, 2
//   D 256 fp32: 64 query rows, 32-key tiles,  8 warps, 216,064 bytes, 1
//   D 384 fp32: 64 query rows, 16-key tiles, 12 warps, 210,944 bytes, 1
//   D 512 fp32: 32 query rows, 16-key tiles,  8 warps, 206,336 bytes, 1
// blocks an SM (two: at most 128 registers a thread). At [32, 512, 4, 256]
// causal the kernel takes 4x (bf16) and 5x (fp32) its bound: staging alone
// and compute alone each take about three quarters of the whole in bf16,
// and clock stamps read a third of a warp's time at the block barrier, a
// quarter in the softmax, while the tensor cores idle (PERF.md §6).
// Taking the next tile's partial S beside this tile's softmax, three or
// four buffers, two 16-row tiles a warp and a launch order keeping a
// group of heads' K and V in L2 each gained under 5%, or lost elsewhere.
// Above D 512 (PASSES) no block holds every chunk within 232,448 bytes:
// a block holds 4 (D 512's geometry), the head dim's chunks go on grid
// axis z in groups of 4, the last group ending at the head dim's end (it
// may overlap the one before, and both then write the same bits), and the
// chunks a block does not hold enter its partials from device memory,
// element by element: S is formed ceil(D / 512) times. Warp w sums the
// chunks of its class (chunk mod 4), each from zero, in order, so every
// group forms the same S. The blocks take the query tiles from the last:
// causal, those have the most keys. O is stored from registers; o rows
// start on 4 bytes (bf16) or 8 (fp32): the wrapper allocates it. A repeat
// call is bit-equal: fixed orders of sums and no atomics.
template <typename T, int D> struct FwdWide {
  static constexpr bool kBf16 = std::is_same<T, bf16>::value;
  static constexpr int kChunks = D / kChunk;  // warps a 16-row strip
  static constexpr int kRows = D == 512 ? 32 : 64;  // query rows a block
  static constexpr int kStep =                      // keys a tile
      kBf16 ? (D == 384 ? 32 : 16) : (D == 256 ? 32 : 16);
  static constexpr int kBlocks = kBf16 && D != 384 ? 2 : 1;  // an SM
  static constexpr int LD = kBf16 ? tile_ld<D>() : f32_ld<D>();
  static constexpr int kThreads = kRows / 16 * kChunks * 32;
  static constexpr size_t kSmem = (kRows + 4 * kStep) * LD * sizeof(T)
                                  + kThreads / 32 * 16 * kStep * sizeof(float);
};

// Issues the copies of rows [row0, row0 + ROWS) of one (batch, head),
// columns [0, D) from `src`, into a tile of FwdWide's rows; rows at or
// past `len` are zero
template <int D, int ROWS, int THREADS>
__device__ __forceinline__ void stage_wide(bf16* dst, const bf16* src,
                                           Strides st, int b, int h,
                                           int row0, int len) {
  stage_tile<D, ROWS, THREADS>(dst, src, st, b, h, row0, len);
}
template <int D, int ROWS, int THREADS>
__device__ __forceinline__ void stage_wide(float* dst, const float* src,
                                           Strides st, int b, int h,
                                           int row0, int len) {
  stage_tile_f32<D, ROWS, THREADS>(dst, src, st, b, h, row0, len);
}

// A warp's partial S from zero: rows [r, r + 16) of tile a times every
// key of tile b (16 at a time), over columns [c0, c0 + 128) of tiles D
// wide; s[j] holds keys 8j..8j+7. bf16 on mma.m16n8k16; fp32 3xTF32 on
// mma.m16n8k8, summed on the tensor cores. Each Q fragment serves every
// 16-key group. No branch: keys a strip does not take are masked after,
// and the loads of one step run ahead of the last one's products (with a
// branch a 16-key group, the products waited on their loads one group at
// a time: 24-29% slower in bf16).
template <int D, int BK>
__device__ __forceinline__ void partial_score(float (&s)[BK / 8][4],
                                              const bf16* a, int r,
                                              const bf16* b, int c0,
                                              int lane) {
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[j][i] = 0.f;
#pragma unroll
  for (int c = 0; c < kChunk; c += 16) {
    uint32_t fa[4];
    hopper::ldmatrix_x4(fa, a_rows<D>(a, r, c0 + c, lane));
#pragma unroll
    for (int u = 0; u < BK / 16; ++u) {
      uint32_t fb[4];
      hopper::ldmatrix_x4(fb, bn_rows<D>(b, 16 * u, c0 + c, lane));
      hopper::mma_bf16(s[2 * u], fa, fb[0], fb[1]);
      hopper::mma_bf16(s[2 * u + 1], fa, fb[2], fb[3]);
    }
  }
}
template <int D, int BK>
__device__ __forceinline__ void partial_score(float (&s)[BK / 8][4],
                                              const float* a, int r,
                                              const float* b, int c0,
                                              int lane) {
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[j][i] = 0.f;
#pragma unroll
  for (int c = 0; c < kChunk; c += 8) {
    uint32_t f[4], ahi[4], alo[4];
    hopper::ldmatrix_x4(f, a_rows_f32<D>(a, r, c0 + c, lane));
    hopper::split_tf32(f, ahi, alo);
#pragma unroll
    for (int u = 0; u < BK / 16; ++u) {
      uint32_t bhi[4], blo[4];
      hopper::ldmatrix_x4(f, bn_rows_f32<D>(b, 16 * u, c0 + c, lane));
      hopper::split_tf32(f, bhi, blo);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        hopper::mma_3xtf32(s[2 * u + j], ahi, alo, bhi[2 * j], bhi[2 * j + 1],
                           blo[2 * j], blo[2 * j + 1]);
    }
  }
}

// Two adjacent bf16 of a row as one b32 (the first in the low half), zero
// when `ok` is false
__device__ __forceinline__ uint32_t load_pair(const bf16* p, bool ok) {
  __nv_bfloat162 x = __floats2bfloat162_rn(0.f, 0.f);
  if (ok) {
    x.x = p[0];
    x.y = p[1];
  }
  return *reinterpret_cast<uint32_t*>(&x);
}

// partial_score of head-dim columns [col, col + 128) read from device
// memory, element by element, into the same fragments: rows r0.. of q
// (zero at or past Tq) times keys k0.. of k (zero at or past Tk). The
// products and their order are partial_score's, so a chunk's partial has
// the same bits from either memory. Only above D 512.
template <int BK>
__device__ __forceinline__ void global_partial(
    float (&s)[BK / 8][4], const bf16* __restrict__ q, Strides sq,
    const bf16* __restrict__ k, Strides sk, int b, int h, int r0, int Tq,
    int k0, int Tk, int col, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const bf16* qr[2];
  bool qok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + g + 8 * i;
    qok[i] = row < Tq;
    qr[i] = q + b * sq.b + h * sq.h + (long long)(qok[i] ? row : 0) * sq.t
            + col + 2 * t;
  }
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[j][i] = 0.f;
  for (int c = 0; c < kChunk; c += 16) {
    const uint32_t fa[4] = {load_pair(qr[0] + c, qok[0]),
                            load_pair(qr[1] + c, qok[1]),
                            load_pair(qr[0] + c + 8, qok[0]),
                            load_pair(qr[1] + c + 8, qok[1])};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const int key = k0 + 8 * j + g;
      const bool ok = key < Tk;
      const bf16* kr = k + b * sk.b + h * sk.h
                       + (long long)(ok ? key : 0) * sk.t + col + c + 2 * t;
      hopper::mma_bf16(s[j], fa, load_pair(kr, ok), load_pair(kr + 8, ok));
    }
  }
}
template <int BK>
__device__ __forceinline__ void global_partial(
    float (&s)[BK / 8][4], const float* __restrict__ q, Strides sq,
    const float* __restrict__ k, Strides sk, int b, int h, int r0, int Tq,
    int k0, int Tk, int col, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const float* qr[2];
  bool qok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + g + 8 * i;
    qok[i] = row < Tq;
    qr[i] = q + b * sq.b + h * sq.h + (long long)(qok[i] ? row : 0) * sq.t
            + col + t;
  }
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[j][i] = 0.f;
  for (int c = 0; c < kChunk; c += 8) {
    const uint32_t f[4] = {
        __float_as_uint(qok[0] ? qr[0][c] : 0.f),
        __float_as_uint(qok[1] ? qr[1][c] : 0.f),
        __float_as_uint(qok[0] ? qr[0][c + 4] : 0.f),
        __float_as_uint(qok[1] ? qr[1][c + 4] : 0.f)};
    uint32_t ahi[4], alo[4];
    hopper::split_tf32(f, ahi, alo);
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const int key = k0 + 8 * j + g;
      const bool ok = key < Tk;
      const float* kr = k + b * sk.b + h * sk.h
                        + (long long)(ok ? key : 0) * sk.t + col + c + t;
      uint32_t hi0, lo0, hi1, lo1;
      hopper::split_tf32(ok ? kr[0] : 0.f, hi0, lo0);
      hopper::split_tf32(ok ? kr[4] : 0.f, hi1, lo1);
      hopper::mma_3xtf32(s[j], ahi, alo, hi0, hi1, lo0, lo1);
    }
  }
}

// O (16 x 128: acc[n] holds columns 8n..8n+7) += P . V, where P holds the
// tile's keys in the score accumulators' layout (0 where masked) and V is
// columns [c0, c0 + 128) of the tile's V rows: bf16, p rounded to bf16
// pairs and V through ldmatrix.trans; fp32, p split 8 keys at a time and V
// by plain loads (3xTF32)
template <int D, int BK>
__device__ __forceinline__ void wide_pv(float (&acc)[kChunk / 8][4],
                                        const float (&p)[BK / 8][4],
                                        const bf16* sV, int c0, int lane) {
#pragma unroll
  for (int u = 0; u < BK / 16; ++u) {
    uint32_t pa[4];
    hopper::pack_a(pa, p[2 * u], p[2 * u + 1]);
#pragma unroll
    for (int c = 0; c < kChunk; c += 16) {
      uint32_t f[4];
      hopper::ldmatrix_x4_trans(f, bk_rows<D>(sV, 16 * u, c0 + c, lane));
      hopper::mma_bf16(acc[c / 8], pa, f[0], f[1]);
      hopper::mma_bf16(acc[c / 8 + 1], pa, f[2], f[3]);
    }
  }
}
template <int D, int BK>
__device__ __forceinline__ void wide_pv(float (&acc)[kChunk / 8][4],
                                        const float (&p)[BK / 8][4],
                                        const float* sV, int c0, int lane) {
  constexpr int LD = f32_ld<D>();
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    uint32_t hi[4], lo[4];
    hopper::split_a_tf32(p[j], hi, lo);
#pragma unroll
    for (int n = 0; n < kChunk / 8; ++n) {
      const float* col = sV + (8 * j + 2 * t) * LD + c0 + 8 * n + g;
      uint32_t hi0, lo0, hi1, lo1;
      hopper::split_tf32(col[0], hi0, lo0);
      hopper::split_tf32(col[LD], hi1, lo1);
      hopper::mma_3xtf32(acc[n], hi, lo, hi0, hi1, lo0, lo1);
    }
  }
}

// B2 above D 128 (the note above): one block of FwdWide<T, D>::kThreads
// per (batch*head, kRows query rows[, group of 4 chunks above D 512]);
// warp w owns query rows [16 (w / kChunks), + 16) and head-dim chunk
// w % kChunks of the block's columns.
template <typename T, int D, bool PASSES>
__global__ void __launch_bounds__(FwdWide<T, D>::kThreads,
                                  FwdWide<T, D>::kBlocks)
    fwd_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, T* __restrict__ o,
                    float* __restrict__ lse, Strides sq, Strides sk,
                    Strides sv, Strides so, int H, int Tq, int Tk, int k_len,
                    int nc, float scale, bool causal) {
  using W = FwdWide<T, D>;
  constexpr int BQ = W::kRows, BK = W::kStep, LD = W::LD, NC = W::kChunks;
  constexpr int THREADS = W::kThreads, NJ = BK / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);
  T* sKV = sQ + BQ * LD;  // [buffer][K, V][BK][LD]
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rg = warp / NC, cw = warp % NC, r0 = q0 + 16 * rg;
  const int c0 = cw * kChunk;  // the warp's columns in the tiles
  // the block's first chunk of the head dim (0 up to D 512) and the class
  // of the warp's chunk, its place in the order of S's sum
  const int base = PASSES ? min(NC * (int)blockIdx.z, nc - NC) : 0;
  const int col0 = base * kChunk, cls = (base + cw) % NC;
  // the strip's partial S: [class][n8 product][lane]
  float4* slots = reinterpret_cast<float4*>(sKV + 4 * BK * LD)
                  + rg * NC * NJ * 32;
  // keys the block, and this strip, need: before k_len and, causal, not
  // after the last query; none for rows wholly past Tq
  const int kend = causal ? min(k_len, min(q0 + BQ, Tq)) : k_len;
  const int kend_w = r0 >= Tq ? 0
                     : causal ? min(k_len, min(r0 + 16, Tq))
                              : k_len;
  const int nkt = (kend + BK - 1) / BK;

  auto stage_kv = [&](int kt) {
    T* dst = sKV + (kt & 1) * 2 * BK * LD;
    stage_wide<D, BK, THREADS>(dst, k + col0, sk, b, h, kt * BK, Tk);
    stage_wide<D, BK, THREADS>(dst + BK * LD, v + col0, sv, b, h, kt * BK,
                               Tk);
  };
  if (nkt > 0) {
    stage_wide<D, BQ, THREADS>(sQ, q + col0, sq, b, h, q0, Tq);
    stage_kv(0);
  }
  hopper::cp_async_commit();

  float acc[kChunk / 8][4];
#pragma unroll
  for (int n = 0; n < kChunk / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};  // rows g, g + 8

  for (int kt = 0; kt < nkt; ++kt) {
    hopper::cp_async_wait<0>();
    __syncthreads();  // tile kt has landed; every warp is done with kt - 1
    if (kt + 1 < nkt) stage_kv(kt + 1);
    hopper::cp_async_commit();
    const T* sK = sKV + (kt & 1) * 2 * BK * LD;
    const T* sV = sK + BK * LD;
    const int k0 = kt * BK;
    if (k0 >= kend_w) continue;  // no key of this tile for the strip
    float s[NJ][4];
    if constexpr (PASSES) {
      // the chunks of the warp's class in order, each from zero: the one
      // the block holds from shared memory, the others from device memory
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[j][i] = 0.f;
      for (int ch = cls; ch < nc; ch += NC) {
        float part[NJ][4];
        if (ch == base + cw)
          partial_score<D, BK>(part, sQ, 16 * rg, sK, c0, lane);
        else
          global_partial<BK>(part, q, sq, k, sk, b, h, r0, Tq, k0, Tk,
                             ch * kChunk, lane);
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) s[j][i] += part[j][i];
      }
    } else {
      partial_score<D, BK>(s, sQ, 16 * rg, sK, c0, lane);
    }
    // S of the strip: the partials of its warps added in class order
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      slots[(cls * NJ + j) * 32 + lane] =
          make_float4(s[j][0], s[j][1], s[j][2], s[j][3]);
    hopper::bar_sync(1 + rg, NC * 32);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float4 own = make_float4(s[j][0], s[j][1], s[j][2], s[j][3]);
      float4 x = cls == 0 ? own : slots[j * 32 + lane];
#pragma unroll
      for (int c = 1; c < NC; ++c) {
        const float4 y = c == cls ? own : slots[(c * NJ + j) * 32 + lane];
        x.x += y.x;
        x.y += y.y;
        x.z += y.z;
        x.w += y.w;
      }
      s[j][0] = x.x * scale;
      s[j][1] = x.y * scale;
      s[j][2] = x.z * scale;
      s[j][3] = x.w * scale;
    }
    // one online-softmax step on the tile's S; masked only on a tile that
    // reaches past k_len or (causal) a query of the strip; rows g and g + 8
    // reduced over their four lanes, each from two partial maxima and sums
    if (k0 + BK > k_len || (causal && k0 + BK - 1 > r0)) {
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int qpos = r0 + g + 8 * (i >> 1);
          const int kpos = k0 + 8 * j + 2 * t + (i & 1);
          if (!score_valid(qpos, kpos, k_len, causal)) s[j][i] = kNegInf;
        }
    }
    float mx[2][2] = {{kNegInf, kNegInf}, {kNegInf, kNegInf}};
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        mx[i >> 1][j & 1] = fmaxf(mx[i >> 1][j & 1], s[j][i]);
    float m_new[2], psum[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float x = fmaxf(mx[r][0], mx[r][1]);
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
      m_new[r] = fmaxf(m[r], x);
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float x = s[j][i];
        const float p =
            x <= kNegInf / 2 ? 0.f : softmax_exp<T>(x - m_new[i >> 1]);
        s[j][i] = p;
        psum[i >> 1][j & 1] += p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float x = psum[r][0] + psum[r][1];
      x += __shfl_xor_sync(0xffffffffu, x, 1);
      x += __shfl_xor_sync(0xffffffffu, x, 2);
      const float corr = softmax_exp<T>(m[r] - m_new[r]);
      l[r] = l[r] * corr + x;
#pragma unroll
      for (int n = 0; n < kChunk / 8; ++n) {
        acc[n][2 * r] *= corr;
        acc[n][2 * r + 1] *= corr;
      }
      m[r] = m_new[r] <= kNegInf / 2 ? m[r] : m_new[r];  // m_keep
    }
    wide_pv<D, BK>(acc, s, sV, c0, lane);
  }

  // a fully masked row (l == 0) gets O = 0 and lse 0: the backward
  // re-masks it
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float denom = fmaxf(l[r], 1e-30f);
    inv[r] = 1.f / denom;
    const int qpos = r0 + g + 8 * r;
    if (blockIdx.z == 0 && cw == 0 && t == 0 && qpos < Tq)
      lse[(long long)bh * Tq + qpos] = l[r] > 0.f ? m[r] + logf(denom) : 0.f;
  }
#pragma unroll
  for (int n = 0; n < kChunk / 8; ++n) {
    acc[n][0] *= inv[0];
    acc[n][1] *= inv[0];
    acc[n][2] *= inv[1];
    acc[n][3] *= inv[1];
  }
  store_chunk<T>(o, so, b, h, r0, Tq, col0 + c0, acc, 1.f, g, t);
}

// B3 above D 128: one block of 2 * kDqRows threads per (batch*head,
// kDqRows query rows, dQ chunk); warp w owns query rows [16w, 16w + 16)
// and takes every 16-key sub-tile. Per key tile, one step per head-dim
// chunk stages that chunk of Q, dO, K and V and sums each sub-tile's S and
// dP; on the last step (the block's own chunk) it re-forms p and ds and
// adds dS.K[:, c0:c0+128] to dQ. The blocks take the query tiles from the
// last, as dq_tf32_kernel. dq rows start on 4 or 8 bytes (the wrapper
// allocates it).
template <typename T>
__global__ void __launch_bounds__(2 * Wide<T>::kDqRows, 2)
    dq_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, T* __restrict__ dq,
                   Strides sq, Strides sk, Strides sv, Strides sdo,
                   Strides sdq, int H, int Tq, int Tk, int k_len, int D,
                   float scale, bool causal) {
  using W = Wide<T>;
  constexpr int BQ = W::kDqRows, BK = W::kDqStep, LD = W::LD;
  constexpr int THREADS = 2 * BQ;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);
  T* sdO = sQ + BQ * LD;
  T* sK = sdO + BQ * LD;
  T* sV = sK + BK * LD;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int nc = D / kChunk, c0 = blockIdx.z * kChunk;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, r0 = q0 + 16 * warp;
  float* s_sums = reinterpret_cast<float*>(sV + BK * LD) + warp * BK * 16;
  float* dp_sums = s_sums + BQ * BK;
  // keys the block, and this warp, need: before k_len and, causal, not
  // after the last query
  const int kend = causal ? min(k_len, min(q0 + BQ, Tq)) : k_len;
  const int kend_w = causal ? min(k_len, min(r0 + 16, Tq)) : k_len;
  const int nkt = (kend + BK - 1) / BK;

  float lse_r[2], delta_r[2];  // of rows g and g + 8
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qpos = r0 + g + 8 * i;
    lse_r[i] = qpos < Tq ? lse[(long long)bh * Tq + qpos] : 0.f;
    delta_r[i] = qpos < Tq ? delta[(long long)bh * Tq + qpos] : 0.f;
  }
  float acc[kChunk / 8][4];
#pragma unroll
  for (int n = 0; n < kChunk / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;

  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * BK;
    // the warp's keys of this tile: none past its last key
    const int kn = r0 < Tq ? min(BK, kend_w - k0) : 0;
    for (int j = 0; j < nc; ++j) {
      const int d0 = (c0 / kChunk + 1 + j) % nc * kChunk;
      const bool last = j == nc - 1;
      __syncthreads();  // the tiles are read before they are staged again
      stage_chunk<BQ, THREADS>(sQ, q, sq, b, h, q0, Tq, d0);
      stage_chunk<BQ, THREADS>(sdO, dout, sdo, b, h, q0, Tq, d0);
      stage_chunk<BK, THREADS>(sK, k, sk, b, h, k0, Tk, d0);
      stage_chunk<BK, THREADS>(sV, v, sv, b, h, k0, Tk, d0);
      hopper::cp_async_wait_all();
      __syncthreads();
      for (int kk = 0; kk < kn; kk += 16) {
        float s[2][4], dp[2][4];
        chunk_score<false, 4>(s, sQ, 16 * warp, sK, kk, lane);
        carry_sum(s, s_sums + kk * 16, lane, j == 0, last);
        chunk_score<true, 2>(dp, sdO, 16 * warp, sV, kk, lane);
        carry_sum(dp, dp_sums + kk * 16, lane, j == 0, last);
        if (!last) continue;
#pragma unroll
        for (int jj = 0; jj < 2; ++jj)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int qpos = r0 + g + 8 * (i >> 1);
            const int kpos = k0 + kk + 8 * jj + 2 * t + (i & 1);
            float p;
            probs_and_ds<T>(
                s[jj][i], dp[jj][i], lse_r[i >> 1], delta_r[i >> 1],
                qpos < Tq && score_valid(qpos, kpos, k_len, causal), scale,
                &p, &dp[jj][i]);
          }
        chunk_acc(acc, dp, sK, kk, lane);  // dQ += dS.K, K's chunk c0
      }
    }
  }
  store_chunk<T>(dq, sdq, b, h, r0, Tq, c0, acc, scale, g, t);
}

// B4 above D 128: one block of 2 * kDkvRows threads per (batch*head,
// kDkvRows key rows, dK/dV chunk); warp w owns key rows [16w, 16w + 16)
// and their dK and dV chunk (2 x 64 fp32 registers a thread, as
// dkv_mma_kernel at D 128). Per query tile, one step per head-dim chunk
// stages that chunk of K, V, Q and dO and sums each sub-tile's S^T and
// dP^T; on the last step (the block's own chunk, with the tile's lse and
// delta) it re-forms p and ds and adds P^T.dO and dS^T.Q of the chunk.
// The blocks take the key tiles in order: causal, the first have the most
// queries. dk and dv rows start on 4 or 8 bytes (the wrapper allocates
// them).
template <typename T>
__global__ void __launch_bounds__(2 * Wide<T>::kDkvRows, 2)
    dkv_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dk,
                    T* __restrict__ dv, Strides sq, Strides sk, Strides sv,
                    Strides sdo, Strides sdk, Strides sdv, int H, int Tq,
                    int Tk, int k_len, int D, float scale, bool causal) {
  using W = Wide<T>;
  constexpr int BK = W::kDkvRows, BQ = W::kDkvStep, LD = W::LD;
  constexpr int THREADS = 2 * BK;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sK = reinterpret_cast<T*>(smem_raw);
  T* sV = sK + BK * LD;
  T* sQ = sV + BK * LD;
  T* sdO = sQ + BQ * LD;
  float* sL = reinterpret_cast<float*>(sdO + BQ * LD);  // lse, then delta
  const float* sDl = sL + BQ;
  const int bh = blockIdx.x, b = bh / H, h = bh % H, k0 = blockIdx.y * BK;
  const int nc = D / kChunk, c0 = blockIdx.z * kChunk;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, kr = 16 * warp, kw = k0 + kr;
  float* s_sums = sL + 2 * BQ + warp * BQ * 16;
  float* dp_sums = s_sums + BK * BQ;
  // query tiles the block needs: none when all its keys are masked;
  // causal, none wholly before its first key
  const int qt0 = causal ? k0 / BQ : 0;
  const int nqt = k0 < k_len ? (Tq + BQ - 1) / BQ : qt0;

  float dk_acc[kChunk / 8][4], dv_acc[kChunk / 8][4];
#pragma unroll
  for (int n = 0; n < kChunk / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk_acc[n][i] = dv_acc[n][i] = 0.f;

  for (int qt = qt0; qt < nqt; ++qt) {
    const int q0 = qt * BQ;
    // the warp's queries of this tile: none past Tq, none when all its
    // keys are masked
    const int qn = kw < k_len ? min(BQ, Tq - q0) : 0;
    for (int j = 0; j < nc; ++j) {
      const int d0 = (c0 / kChunk + 1 + j) % nc * kChunk;
      const bool last = j == nc - 1;
      __syncthreads();  // the tiles are read before they are staged again
      stage_chunk<BK, THREADS>(sK, k, sk, b, h, k0, Tk, d0);
      stage_chunk<BK, THREADS>(sV, v, sv, b, h, k0, Tk, d0);
      stage_chunk<BQ, THREADS>(sQ, q, sq, b, h, q0, Tq, d0);
      stage_chunk<BQ, THREADS>(sdO, dout, sdo, b, h, q0, Tq, d0);
      if (last) {
        stage_vec<BQ, THREADS>(sL, lse + (long long)bh * Tq, q0, Tq);
        stage_vec<BQ, THREADS>(sL + BQ, delta + (long long)bh * Tq, q0, Tq);
      }
      hopper::cp_async_wait_all();
      __syncthreads();
      for (int qq = 0; qq < qn; qq += 16) {
        if (causal && q0 + qq + 15 < kw) continue;  // wholly above the diagonal
        // keys x queries; in fp32 the head dim 2 k-steps at a time, so
        // that 255 registers hold the 128 accumulators with no spill
        float s[2][4], dp[2][4];
        chunk_score<false, 2>(s, sK, kr, sQ, qq, lane);
        carry_sum(s, s_sums + qq * 16, lane, j == 0, last);
        chunk_score<true, 2>(dp, sV, kr, sdO, qq, lane);
        carry_sum(dp, dp_sums + qq * 16, lane, j == 0, last);
        if (!last) continue;
        // a sub-tile wholly inside k_len, Tq and (causal) the diagonal
        // needs no mask
        const bool inner = kw + 16 <= k_len && q0 + qq + 16 <= Tq
                           && (!causal || kw + 15 <= q0 + qq);
#pragma unroll
        for (int jj = 0; jj < 2; ++jj)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int kpos = kw + g + 8 * (i >> 1);
            const int col = qq + 8 * jj + 2 * t + (i & 1), qpos = q0 + col;
            probs_and_ds<T>(
                s[jj][i], dp[jj][i], sL[col], sDl[col],
                inner
                    || (qpos < Tq && score_valid(qpos, kpos, k_len, causal)),
                scale, &s[jj][i], &dp[jj][i]);
          }
        chunk_acc(dv_acc, s, sdO, qq, lane);  // dV += P^T.dO
        chunk_acc(dk_acc, dp, sQ, qq, lane);  // dK += dS^T.Q
      }
    }
  }
  store_chunk<T>(dk, sdk, b, h, kw, Tk, c0, dk_acc, scale, g, t);
  store_chunk<T>(dv, sdv, b, h, kw, Tk, c0, dv_acc, 1.f, g, t);
}

Strides strides_at(const long long* st, int i) {
  return Strides{st[3 * i], st[3 * i + 1], st[3 * i + 2]};
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, int D>
int fwd(const void* q, const void* k, const void* v, void* o, void* lse,
        int B, int H, int Tq, int Tk, int k_len, const long long* st,
        float scale, int causal, cudaStream_t stream) {
  if constexpr (std::is_same<T, bf16>::value) {
    const size_t smem = fwd_smem_bytes<D>();
    cudaError_t err = prepare(fwd_mma_kernel<D>, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(B * H, (Tq + kFwdRows - 1) / kFwdRows);
    fwd_mma_kernel<D><<<grid, kFwdThreads, smem, stream>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o,
        (float*)lse, strides_at(st, 0), strides_at(st, 1),
        strides_at(st, 2), strides_at(st, 3), H, Tq, Tk, k_len, scale,
        causal != 0);
  } else {  // fp32 (the fp32 models): 3xTF32 on the tensor cores
    const size_t smem = fwd_tf32_smem_bytes<D>();
    cudaError_t err = prepare(fwd_tf32_kernel<D>, smem);
    if (err != cudaSuccess) return err;
    constexpr int BQ = fwd_tf32_tile<D>();
    const dim3 grid(B * H, (Tq + BQ - 1) / BQ);
    fwd_tf32_kernel<D><<<grid, fwd_tf32_threads<D>(), smem, stream>>>(
        (const float*)q, (const float*)k, (const float*)v, (float*)o,
        (float*)lse, strides_at(st, 0), strides_at(st, 1), strides_at(st, 2),
        strides_at(st, 3), H, Tq, Tk, k_len, scale, causal != 0);
  }
  return cudaGetLastError();
}

template <typename T, int D>
int dq(const void* q, const void* k, const void* v, const void* dout,
       const void* lse, const void* delta, void* dq_out, int B, int H,
       int Tq, int Tk, int k_len, const long long* st, float scale,
       int causal, cudaStream_t stream) {
  if constexpr (std::is_same<T, bf16>::value) {
    const size_t smem = dq_smem_bytes<D>();
    cudaError_t err = prepare(dq_mma_kernel<D>, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(B * H, (Tq + kBwdRows - 1) / kBwdRows);
    dq_mma_kernel<D><<<grid, kDqThreads, smem, stream>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
        (const float*)lse, (const float*)delta, (bf16*)dq_out,
        strides_at(st, 0), strides_at(st, 1), strides_at(st, 2),
        strides_at(st, 3), strides_at(st, 4), H, Tq, Tk, k_len, scale,
        causal != 0);
  } else {  // fp32 (the fp32 models): 3xTF32 on the tensor cores
    const size_t smem = dq_tf32_smem_bytes<D>();
    cudaError_t err = prepare(dq_tf32_kernel<D>, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(B * H, (Tq + kBwdRows - 1) / kBwdRows);
    dq_tf32_kernel<D><<<grid, kDqThreads, smem, stream>>>(
        (const float*)q, (const float*)k, (const float*)v,
        (const float*)dout, (const float*)lse, (const float*)delta,
        (float*)dq_out, strides_at(st, 0), strides_at(st, 1),
        strides_at(st, 2), strides_at(st, 3), strides_at(st, 4), H, Tq, Tk,
        k_len, scale, causal != 0);
  }
  return cudaGetLastError();
}

template <typename T, int D>
int dkv(const void* q, const void* k, const void* v, const void* dout,
        const void* lse, const void* delta, void* dk, void* dv, int B,
        int H, int Tq, int Tk, int k_len, const long long* st, float scale,
        int causal, cudaStream_t stream) {
  if constexpr (std::is_same<T, bf16>::value) {
    const size_t smem = dkv_smem_bytes<D>();
    cudaError_t err = prepare(dkv_mma_kernel<D>, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(B * H, (Tk + kBwdRows - 1) / kBwdRows);
    dkv_mma_kernel<D><<<grid, kDkvThreads, smem, stream>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
        (const float*)lse, (const float*)delta, (bf16*)dk, (bf16*)dv,
        strides_at(st, 0), strides_at(st, 1), strides_at(st, 2),
        strides_at(st, 3), strides_at(st, 4), strides_at(st, 5), H, Tq, Tk,
        k_len, scale, causal != 0);
  } else {  // fp32 (the fp32 models): 3xTF32 on the tensor cores
    const size_t smem = dkv_tf32_smem_bytes<D>();
    cudaError_t err = prepare(dkv_tf32_kernel<D>, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(B * H, (Tk + kBwdRows - 1) / kBwdRows);
    dkv_tf32_kernel<D><<<grid, kDkvThreads, smem, stream>>>(
        (const float*)q, (const float*)k, (const float*)v,
        (const float*)dout, (const float*)lse, (const float*)delta,
        (float*)dk, (float*)dv, strides_at(st, 0), strides_at(st, 1),
        strides_at(st, 2), strides_at(st, 3), strides_at(st, 4),
        strides_at(st, 5), H, Tq, Tk, k_len, scale, causal != 0);
  }
  return cudaGetLastError();
}

// The forward above D 128: the kernel holding every chunk at D 256, 384
// and 512, above that 4 chunks a block on grid axis z
template <typename T, int D, bool PASSES>
int fwd_wide_launch(int nc, const void* q, const void* k, const void* v,
                    void* o, void* lse, int B, int H, int Tq, int Tk,
                    int k_len, const long long* st, float scale, int causal,
                    cudaStream_t stream) {
  using W = FwdWide<T, D>;
  cudaError_t err = prepare(fwd_wide_kernel<T, D, PASSES>, W::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (Tq + W::kRows - 1) / W::kRows,
                  PASSES ? (nc + W::kChunks - 1) / W::kChunks : 1);
  fwd_wide_kernel<T, D, PASSES><<<grid, W::kThreads, W::kSmem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, (float*)lse,
      strides_at(st, 0), strides_at(st, 1), strides_at(st, 2),
      strides_at(st, 3), H, Tq, Tk, k_len, nc, scale, causal != 0);
  return cudaGetLastError();
}

template <typename T>
int fwd_wide(int D, const void* q, const void* k, const void* v, void* o,
             void* lse, int B, int H, int Tq, int Tk, int k_len,
             const long long* st, float scale, int causal,
             cudaStream_t stream) {
  const int nc = D / kChunk;
  switch (nc) {
    case 2:
      return fwd_wide_launch<T, 256, false>(nc, q, k, v, o, lse, B, H, Tq,
                                            Tk, k_len, st, scale, causal,
                                            stream);
    case 3:
      return fwd_wide_launch<T, 384, false>(nc, q, k, v, o, lse, B, H, Tq,
                                            Tk, k_len, st, scale, causal,
                                            stream);
    case 4:
      return fwd_wide_launch<T, 512, false>(nc, q, k, v, o, lse, B, H, Tq,
                                            Tk, k_len, st, scale, causal,
                                            stream);
    default:
      return fwd_wide_launch<T, 512, true>(nc, q, k, v, o, lse, B, H, Tq,
                                           Tk, k_len, st, scale, causal,
                                           stream);
  }
}

template <typename T>
int dq_wide(int D, const void* q, const void* k, const void* v,
            const void* dout, const void* lse, const void* delta,
            void* dq_out, int B, int H, int Tq, int Tk, int k_len,
            const long long* st, float scale, int causal,
            cudaStream_t stream) {
  constexpr int BQ = Wide<T>::kDqRows;
  const size_t smem = dq_wide_smem_bytes<T>();
  cudaError_t err = prepare(dq_wide_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (Tq + BQ - 1) / BQ, D / kChunk);
  dq_wide_kernel<T><<<grid, 2 * BQ, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
      (const float*)lse, (const float*)delta, (T*)dq_out, strides_at(st, 0),
      strides_at(st, 1), strides_at(st, 2), strides_at(st, 3),
      strides_at(st, 4), H, Tq, Tk, k_len, D, scale, causal != 0);
  return cudaGetLastError();
}

template <typename T>
int dkv_wide(int D, const void* q, const void* k, const void* v,
             const void* dout, const void* lse, const void* delta, void* dk,
             void* dv, int B, int H, int Tq, int Tk, int k_len,
             const long long* st, float scale, int causal,
             cudaStream_t stream) {
  constexpr int BK = Wide<T>::kDkvRows;
  const size_t smem = dkv_wide_smem_bytes<T>();
  cudaError_t err = prepare(dkv_wide_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (Tk + BK - 1) / BK, D / kChunk);
  dkv_wide_kernel<T><<<grid, 2 * BK, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
      (const float*)lse, (const float*)delta, (T*)dk, (T*)dv,
      strides_at(st, 0), strides_at(st, 1), strides_at(st, 2),
      strides_at(st, 3), strides_at(st, 4), strides_at(st, 5), H, Tq, Tk,
      k_len, D, scale, causal != 0);
  return cudaGetLastError();
}

// A head dim of the chunked route: a multiple of 128 above 128
inline bool wide_head_dim(int D) { return D > kChunk && D % kChunk == 0; }

// Dispatch on the input type and the head dim; -1 for what the kernels
// do not take (the Python wrappers check first).
#define DISPATCH(FN, ...)                                                 \
  switch (D) {                                                            \
    case 64:                                                              \
      return is_bf16 ? FN<__nv_bfloat16, 64>(__VA_ARGS__)                 \
                     : FN<float, 64>(__VA_ARGS__);                        \
    case 128:                                                             \
      return is_bf16 ? FN<__nv_bfloat16, 128>(__VA_ARGS__)                \
                     : FN<float, 128>(__VA_ARGS__);                       \
    default:                                                              \
      if (!wide_head_dim(D)) return -1;                                   \
      return is_bf16 ? FN##_wide<__nv_bfloat16>(D, __VA_ARGS__)           \
                     : FN##_wide<float>(D, __VA_ARGS__);                  \
  }

}  // namespace

// Strides: `st` holds (batch, time, head) strides in elements, three per
// tensor, in argument order (fwd: q, k, v, o; dq: q, k, v, dout, dq;
// dkv: q, k, v, dout, dk, dv). Each returns 0 or a CUDA error code.
extern "C" int fedml_flash_fwd(const void* q, const void* k, const void* v,
                               void* o, void* lse, int is_bf16, int B, int H,
                               int Tq, int Tk, int k_len, int D,
                               const long long* st, float scale, int causal,
                               void* stream) {
  DISPATCH(fwd, q, k, v, o, lse, B, H, Tq, Tk, k_len, st, scale, causal,
           (cudaStream_t)stream)
}

extern "C" int fedml_flash_dq(const void* q, const void* k, const void* v,
                              const void* dout, const void* lse,
                              const void* delta, void* dq_out, int is_bf16,
                              int B, int H, int Tq, int Tk, int k_len, int D,
                              const long long* st, float scale, int causal,
                              void* stream) {
  DISPATCH(dq, q, k, v, dout, lse, delta, dq_out, B, H, Tq, Tk, k_len, st,
           scale, causal, (cudaStream_t)stream)
}

extern "C" int fedml_flash_dkv(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* delta, void* dk, void* dv,
                               int is_bf16, int B, int H, int Tq, int Tk,
                               int k_len, int D, const long long* st,
                               float scale, int causal, void* stream) {
  DISPATCH(dkv, q, k, v, dout, lse, delta, dk, dv, B, H, Tq, Tk, k_len, st,
           scale, causal, (cudaStream_t)stream)
}

namespace {

constexpr int kInfo = 5;  // ints a kernel in fedml_flash_mma_info

template <typename Kernel>
int occupancy(Kernel kernel, int threads, size_t smem, int rows, int chunks,
              int* out) {
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  out[0] = threads;
  out[1] = (int)smem;
  out[3] = rows;
  out[4] = chunks;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], kernel,
                                                       threads, smem);
}

template <int D>
int mma_info(int* out) {
  int err = occupancy(fwd_mma_kernel<D>, kFwdThreads, fwd_smem_bytes<D>(),
                      kFwdRows, 1, out);
  if (!err)
    err = occupancy(dq_mma_kernel<D>, kDqThreads, dq_smem_bytes<D>(),
                    kBwdRows, 1, out + kInfo);
  if (!err)
    err = occupancy(dkv_mma_kernel<D>, kDkvThreads, dkv_smem_bytes<D>(),
                    kBwdRows, 1, out + 2 * kInfo);
  if (!err)
    err = occupancy(dq_tf32_kernel<D>, kDqThreads, dq_tf32_smem_bytes<D>(),
                    kBwdRows, 1, out + 3 * kInfo);
  if (!err)
    err = occupancy(dkv_tf32_kernel<D>, kDkvThreads, dkv_tf32_smem_bytes<D>(),
                    kBwdRows, 1, out + 4 * kInfo);
  return err ? err
             : occupancy(fwd_tf32_kernel<D>, fwd_tf32_threads<D>(),
                         fwd_tf32_smem_bytes<D>(), fwd_tf32_tile<D>(), 1,
                         out + 5 * kInfo);
}

template <typename T, int D, bool PASSES>
int fwd_wide_info(int* out) {
  using W = FwdWide<T, D>;
  return occupancy(fwd_wide_kernel<T, D, PASSES>, W::kThreads, W::kSmem,
                   W::kRows, W::kChunks, out);
}

template <typename T>
int wide_info(int D, int* fwd_out, int* dq_out, int* dkv_out) {
  using W = Wide<T>;
  const int nc = D / kChunk;
  int err = nc == 2   ? fwd_wide_info<T, 256, false>(fwd_out)
            : nc == 3 ? fwd_wide_info<T, 384, false>(fwd_out)
            : nc == 4 ? fwd_wide_info<T, 512, false>(fwd_out)
                      : fwd_wide_info<T, 512, true>(fwd_out);
  if (!err)
    err = occupancy(dq_wide_kernel<T>, 2 * W::kDqRows,
                    dq_wide_smem_bytes<T>(), W::kDqRows, nc, dq_out);
  return err ? err
             : occupancy(dkv_wide_kernel<T>, 2 * W::kDkvRows,
                         dkv_wide_smem_bytes<T>(), W::kDkvRows, nc,
                         dkv_out);
}

}  // namespace

// The tensor-core kernels' launch shape at head dim D, kInfo = 5 ints a
// kernel: threads a block, shared bytes a block, blocks an SM can hold,
// rows a block owns (queries for the forward and dq, keys for dk/dv) and
// 128-column head-dim chunks: for the forward those one block holds (1 at
// D 64 and 128, D / 128 at D 256-512, 4 above), for dq and dk/dv those on
// grid axis z, one a block (1 at D 64 and 128, D / 128 above). out[0]
// is the bf16 forward's, out[5] the bf16 dq's, out[10] the bf16 dk/dv's,
// out[15] the fp32 dq's, out[20] the fp32 dk/dv's, out[25] the fp32
// forward's: the kernels of D 64 and 128, and above 128 those of the
// chunked route. Returns 0 or a CUDA error code (-1 for a head dim the
// kernels do not take).
extern "C" int fedml_flash_mma_info(int D, int* out) {
  switch (D) {
    case 64:
      return mma_info<64>(out);
    case 128:
      return mma_info<128>(out);
    default: {
      if (!wide_head_dim(D)) return -1;
      const int err = wide_info<__nv_bfloat16>(D, out, out + kInfo,
                                               out + 2 * kInfo);
      return err ? err
                 : wide_info<float>(D, out + 5 * kInfo, out + 3 * kInfo,
                                    out + 4 * kInfo);
    }
  }
}
