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
// Numerics. Inputs are bf16 or fp32. Every product is an fp32 FMA of
// values of the input type (exact for bf16), summed in fp32, as the Pallas
// kernels' preferred_element_type=float32. p (B2, B4) and ds (B3, B4) are
// rounded to the input type before their second product, as the Pallas
// kernels cast them. The online-softmax state m, l, acc stays fp32,
// including the s <= NEG_INF/2 -> p = 0 guard and the m_keep rule. Each
// output tile is owned by one block and there are no atomics, so a repeat
// call is bit-equal.
//
// Design. One block of 256 threads per (batch*head, 64-row tile): query
// tiles for B2 and B3, key tiles for B4, which loop over the opposite
// operand's tiles (skipping, causal, the tiles above the diagonal). The
// block stages its own tile and each opposite tile in shared memory as
// fp32, rows padded to D+4 floats: 16-byte aligned for float4 loads, and
// the four threads of a row and the eight rows of a warp hit distinct
// banks. Four threads share a tile row: each computes the scores of every
// fourth column (16 of 64) and owns four of every sixteen columns of the
// head dim of the row's accumulators; row maxima and sums reduce over the
// four lanes by shuffles. Every shared-memory read is a float4 (four FMAs
// per operand read, in the same summation order as one at a time).
// Tiles arrive by 16-byte loads, all of a thread's in flight at once, and
// the forward's p tile takes the K tile's place, so two forward blocks
// share an SM. Products run on the CUDA cores (fp32 FMA).
//
// What bounds it. At the LM flagship's shape ([32, 80, 4, 128] bf16,
// causal) the function moves 10.5 MB (B2), 13.1 MB (B3) and 15.7 MB (B4):
// about 3-5 us at 3.35 TB/s, against 0.2-0.4 GFLOP, well under a us on
// the tensor cores. So bytes bound it on the card. This first version is
// instead bound by shared-memory loads (about one per FMA) and by its
// CUDA-core FMAs; tensor cores (mma/wgmma) and TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;          // query rows and key rows per tile
constexpr int kThreads = 256;      // four threads per tile row
constexpr int kCols = kTile / 4;   // score columns per thread
constexpr int kLP = kTile + 4;     // padded row of a [64 x 64] tile
constexpr float kNegInf = -1e30f;  // NEG_INF of the JAX package

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
// v rounded to the input type and held as fp32 (the Pallas `.astype`)
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

struct Strides {
  long long b, t, h;
};

// `_mask`: a score is valid when its key exists and, causal, does not come
// after its query.
__device__ __forceinline__ bool score_valid(int qpos, int kpos, int k_len,
                                            bool causal) {
  return kpos < k_len && (!causal || kpos <= qpos);
}

// `_probs_and_ds`: from the raw q.k and dO.v products of one score,
// p = exp(s - lse) with the saved logsumexp (0 where s is masked) and
// ds = p * (dO.v - delta). The one re-formation B3 and B4 share.
__device__ __forceinline__ void probs_and_ds(float qk, float dov, float lse,
                                             float delta, bool valid,
                                             float scale, float* p,
                                             float* ds) {
  const float s = valid ? qk * scale : kNegInf;
  *p = s <= kNegInf / 2 ? 0.f : expf(s - lse);
  *ds = *p * (dov - delta);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// acc += a.x * b0 + a.y * b1 + a.z * b2 + a.w * b3, one FMA at a time
__device__ __forceinline__ float fma4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// acc[0..3] += w.x * r0 + w.y * r1 + w.z * r2 + w.w * r3 (four rows of a
// tile, four columns each), row by row
__device__ __forceinline__ void axpy4(float4 w, float4 r0, float4 r1,
                                      float4 r2, float4 r3, float* acc) {
  const float4 rows[4] = {r0, r1, r2, r3};
  const float ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    acc[0] = fmaf(ws[i], rows[i].x, acc[0]);
    acc[1] = fmaf(ws[i], rows[i].y, acc[1]);
    acc[2] = fmaf(ws[i], rows[i].z, acc[2]);
    acc[3] = fmaf(ws[i], rows[i].w, acc[3]);
  }
}

// Head-dim column of accumulator `a` of thread `t` of a row: four of every
// sixteen columns, so four lanes read 64 contiguous bytes.
__device__ __forceinline__ int acc_col(int a, int t) {
  return 16 * (a >> 2) + 4 * t + (a & 3);
}

// Writes 16 bytes of the input type to `dst` (16-byte aligned) as fp32.
__device__ __forceinline__ void put16(float* dst, uint4 raw, float) {
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(&raw);
}
__device__ __forceinline__ void put16(float* dst, uint4 raw, __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  const float2 c = __bfloat1622float2(h[2]), d = __bfloat1622float2(h[3]);
  reinterpret_cast<float4*>(dst)[0] = make_float4(a.x, a.y, b.x, b.y);
  reinterpret_cast<float4*>(dst)[1] = make_float4(c.x, c.y, d.x, d.y);
}

// Stages rows [row0, row0 + kTile) of one (batch, head) of a [B, T, H, D]
// tensor in shared memory as fp32, rows padded to D + 4; rows at or past
// `len` are zero. When the rows start on 16-byte boundaries (the model's
// qkv views and contiguous tensors do), every thread issues all its
// 16-byte loads before it converts and stores any, so a tile costs about
// one memory latency; otherwise it falls back to element loads.
template <typename T, int D>
__device__ void load_tile(float* dst, const T* __restrict__ src, Strides st,
                          int b, int h, int row0, int len) {
  const T* base = src + b * st.b + h * st.h;
  constexpr int kVec = 16 / sizeof(T), kPerRow = D / kVec;
  constexpr int kN = kTile * kPerRow / kThreads;
  if (reinterpret_cast<unsigned long long>(base) % 16 == 0
      && st.t % kVec == 0) {
    uint4 raw[kN];
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      const int e = threadIdx.x + i * kThreads, t = row0 + e / kPerRow;
      raw[i] = t < len ? *reinterpret_cast<const uint4*>(
                             base + (long long)t * st.t + e % kPerRow * kVec)
                       : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      const int e = threadIdx.x + i * kThreads;
      put16(dst + e / kPerRow * (D + 4) + e % kPerRow * kVec, raw[i], T());
    }
    return;
  }
  for (int e = threadIdx.x; e < kTile * D; e += kThreads) {
    const int r = e / D, d = e % D, t = row0 + r;
    dst[r * (D + 4) + d] =
        t < len ? to_f32(base[(long long)t * st.t + d]) : 0.f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, T* __restrict__ o,
               float* __restrict__ lse, Strides sq, Strides sk, Strides sv,
               Strides so, int H, int Tq, int Tk, int k_len, float scale,
               bool causal) {
  constexpr int LD = D + 4, NA = D / 4;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;
  float* sK = sQ + kTile * LD;
  float* sV = sK + kTile * LD;
  // p takes the K tile's place once the scores are done, so that two
  // blocks fit an SM's shared memory
  float* sP = sK;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = blockIdx.y * kTile;
  const int r = threadIdx.x >> 2, t = threadIdx.x & 3, qpos = q0 + r;

  load_tile<T, D>(sQ, q, sq, b, h, q0, Tq);
  float m = kNegInf, l = 0.f, acc[NA];
#pragma unroll
  for (int jj = 0; jj < NA; ++jj) acc[jj] = 0.f;

  for (int k0 = 0; k0 < Tk; k0 += kTile) {
    if (causal && k0 > q0 + kTile - 1) break;  // above the diagonal band
    __syncthreads();  // the previous tiles' readers are done
    load_tile<T, D>(sK, k, sk, b, h, k0, Tk);
    load_tile<T, D>(sV, v, sv, b, h, k0, Tk);
    __syncthreads();

    float s[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) s[j] = 0.f;
    for (int d = 0; d < D; d += 4) {
      const float4 qd = ld4(&sQ[r * LD + d]);
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        s[j] = fma4(qd, ld4(&sK[(t + 4 * j) * LD + d]), s[j]);
    }
    float blk = kNegInf;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      s[j] = score_valid(qpos, k0 + t + 4 * j, k_len, causal) ? s[j] * scale
                                                              : kNegInf;
      blk = fmaxf(blk, s[j]);
    }
    blk = fmaxf(blk, __shfl_xor_sync(0xffffffffu, blk, 1));
    blk = fmaxf(blk, __shfl_xor_sync(0xffffffffu, blk, 2));
    const float m_new = fmaxf(m, blk);
    __syncthreads();  // every row's scores are done with the K tile
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const float p = s[j] <= kNegInf / 2 ? 0.f : expf(s[j] - m_new);
      psum += p;
      sP[r * kLP + t + 4 * j] = round_to<T>(p);
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    const float corr = expf(m - m_new);
    l = l * corr + psum;
    __syncwarp();  // the row's p, written by its four lanes
#pragma unroll
    for (int jj = 0; jj < NA; ++jj) acc[jj] *= corr;
    for (int c = 0; c < kTile; c += 4) {
      const float4 pc = ld4(&sP[r * kLP + c]);
      const float* vc = sV + c * LD + 4 * t;
#pragma unroll
      for (int g = 0; g < NA / 4; ++g)
        axpy4(pc, ld4(vc + 16 * g), ld4(vc + LD + 16 * g),
              ld4(vc + 2 * LD + 16 * g), ld4(vc + 3 * LD + 16 * g),
              acc + 4 * g);
    }
    m = m_new <= kNegInf / 2 ? m : m_new;  // m_keep
  }

  if (qpos < Tq) {
    const float denom = fmaxf(l, 1e-30f);
    T* orow = o + b * so.b + (long long)qpos * so.t + h * so.h;
#pragma unroll
    for (int a = 0; a < NA; ++a)
      orow[acc_col(a, t)] = from_f32<T>(acc[a] / denom);
    // a fully masked row (l == 0) gets lse 0: the backward re-masks it
    if (t == 0)
      lse[(long long)bh * Tq + qpos] = l > 0.f ? m + logf(denom) : 0.f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              T* __restrict__ dq, Strides sq, Strides sk, Strides sv,
              Strides sdo, Strides sdq, int H, int Tq, int Tk, int k_len,
              float scale, bool causal) {
  constexpr int LD = D + 4, NA = D / 4;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;
  float* sdO = sQ + kTile * LD;
  float* sK = sdO + kTile * LD;
  float* sV = sK + kTile * LD;
  float* sDS = sV + kTile * LD;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = blockIdx.y * kTile;
  const int r = threadIdx.x >> 2, t = threadIdx.x & 3, qpos = q0 + r;
  const bool row_ok = qpos < Tq;
  const float lse_r = row_ok ? lse[(long long)bh * Tq + qpos] : 0.f;
  const float delta_r = row_ok ? delta[(long long)bh * Tq + qpos] : 0.f;

  load_tile<T, D>(sQ, q, sq, b, h, q0, Tq);
  load_tile<T, D>(sdO, dout, sdo, b, h, q0, Tq);
  float acc[NA];
#pragma unroll
  for (int jj = 0; jj < NA; ++jj) acc[jj] = 0.f;

  for (int k0 = 0; k0 < Tk; k0 += kTile) {
    if (causal && k0 > q0 + kTile - 1) break;
    __syncthreads();
    load_tile<T, D>(sK, k, sk, b, h, k0, Tk);
    load_tile<T, D>(sV, v, sv, b, h, k0, Tk);
    __syncthreads();

    float s[kCols], dov[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) s[j] = dov[j] = 0.f;
    for (int d = 0; d < D; d += 4) {
      const float4 qd = ld4(&sQ[r * LD + d]), gd = ld4(&sdO[r * LD + d]);
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int e = (t + 4 * j) * LD + d;
        s[j] = fma4(qd, ld4(&sK[e]), s[j]);
        dov[j] = fma4(gd, ld4(&sV[e]), dov[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      float p, ds;
      probs_and_ds(s[j], dov[j], lse_r, delta_r,
                   row_ok && score_valid(qpos, k0 + t + 4 * j, k_len, causal),
                   scale, &p, &ds);
      sDS[r * kLP + t + 4 * j] = round_to<T>(ds);
    }
    __syncwarp();
    for (int c = 0; c < kTile; c += 4) {
      const float4 dsc = ld4(&sDS[r * kLP + c]);
      const float* kc = sK + c * LD + 4 * t;
#pragma unroll
      for (int g = 0; g < NA / 4; ++g)
        axpy4(dsc, ld4(kc + 16 * g), ld4(kc + LD + 16 * g),
              ld4(kc + 2 * LD + 16 * g), ld4(kc + 3 * LD + 16 * g),
              acc + 4 * g);
    }
  }

  if (row_ok) {
    T* row = dq + b * sdq.b + (long long)qpos * sdq.t + h * sdq.h;
#pragma unroll
    for (int a = 0; a < NA; ++a)
      row[acc_col(a, t)] = from_f32<T>(scale * acc[a]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dout,
               const float* __restrict__ lse,
               const float* __restrict__ delta, T* __restrict__ dk,
               T* __restrict__ dv, Strides sq, Strides sk, Strides sv,
               Strides sdo, Strides sdk, Strides sdv, int H, int Tq, int Tk,
               int k_len, float scale, bool causal) {
  constexpr int LD = D + 4, NA = D / 4;
  extern __shared__ __align__(16) float smem[];
  float* sK = smem;
  float* sV = sK + kTile * LD;
  float* sQ = sV + kTile * LD;
  float* sdO = sQ + kTile * LD;
  float* sPT = sdO + kTile * LD;  // p^T of the tile pair: [key][query]
  float* sDST = sPT + kTile * kLP;
  float* sL = sDST + kTile * kLP;
  float* sDl = sL + kTile;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int k0 = blockIdx.y * kTile;
  const int c = threadIdx.x >> 2, t = threadIdx.x & 3, kpos = k0 + c;

  load_tile<T, D>(sK, k, sk, b, h, k0, Tk);
  load_tile<T, D>(sV, v, sv, b, h, k0, Tk);
  float dk_acc[NA], dv_acc[NA];
#pragma unroll
  for (int jj = 0; jj < NA; ++jj) dk_acc[jj] = dv_acc[jj] = 0.f;

  for (int q0 = 0; q0 < Tq; q0 += kTile) {
    if (causal && q0 + kTile - 1 < k0) continue;  // above the diagonal
    __syncthreads();
    load_tile<T, D>(sQ, q, sq, b, h, q0, Tq);
    load_tile<T, D>(sdO, dout, sdo, b, h, q0, Tq);
    if (threadIdx.x < kTile) {
      const int qp = q0 + threadIdx.x;
      sL[threadIdx.x] = qp < Tq ? lse[(long long)bh * Tq + qp] : 0.f;
      sDl[threadIdx.x] = qp < Tq ? delta[(long long)bh * Tq + qp] : 0.f;
    }
    __syncthreads();

    float s[kCols], dov[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) s[j] = dov[j] = 0.f;
    for (int d = 0; d < D; d += 4) {
      const float4 kd = ld4(&sK[c * LD + d]), vd = ld4(&sV[c * LD + d]);
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int e = (t + 4 * j) * LD + d;
        s[j] = fma4(ld4(&sQ[e]), kd, s[j]);
        dov[j] = fma4(ld4(&sdO[e]), vd, dov[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int rr = t + 4 * j, qpos = q0 + rr;
      float p, ds;
      probs_and_ds(s[j], dov[j], sL[rr], sDl[rr],
                   qpos < Tq && score_valid(qpos, kpos, k_len, causal), scale,
                   &p, &ds);
      sPT[c * kLP + rr] = round_to<T>(p);
      sDST[c * kLP + rr] = round_to<T>(ds);
    }
    __syncwarp();
    for (int rr = 0; rr < kTile; rr += 4) {
      const float4 pr = ld4(&sPT[c * kLP + rr]);
      const float4 dsr = ld4(&sDST[c * kLP + rr]);
      const float* gr = sdO + rr * LD + 4 * t;
      const float* qr = sQ + rr * LD + 4 * t;
#pragma unroll
      for (int g = 0; g < NA / 4; ++g) {
        axpy4(pr, ld4(gr + 16 * g), ld4(gr + LD + 16 * g),
              ld4(gr + 2 * LD + 16 * g), ld4(gr + 3 * LD + 16 * g),
              dv_acc + 4 * g);
        axpy4(dsr, ld4(qr + 16 * g), ld4(qr + LD + 16 * g),
              ld4(qr + 2 * LD + 16 * g), ld4(qr + 3 * LD + 16 * g),
              dk_acc + 4 * g);
      }
    }
  }

  if (kpos < Tk) {
    T* krow = dk + b * sdk.b + (long long)kpos * sdk.t + h * sdk.h;
    T* vrow = dv + b * sdv.b + (long long)kpos * sdv.t + h * sdv.h;
#pragma unroll
    for (int a = 0; a < NA; ++a) {
      krow[acc_col(a, t)] = from_f32<T>(scale * dk_acc[a]);
      vrow[acc_col(a, t)] = from_f32<T>(dv_acc[a]);
    }
  }
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
  const size_t smem = 3 * kTile * (D + 4) * sizeof(float);
  cudaError_t err = prepare(fwd_kernel<T, D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (Tq + kTile - 1) / kTile);
  fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, (float*)lse,
      strides_at(st, 0), strides_at(st, 1), strides_at(st, 2),
      strides_at(st, 3), H, Tq, Tk, k_len, scale, causal != 0);
  return cudaGetLastError();
}

template <typename T, int D>
int dq(const void* q, const void* k, const void* v, const void* dout,
       const void* lse, const void* delta, void* dq_out, int B, int H,
       int Tq, int Tk, int k_len, const long long* st, float scale,
       int causal, cudaStream_t stream) {
  const size_t smem = (4 * kTile * (D + 4) + kTile * kLP) * sizeof(float);
  cudaError_t err = prepare(dq_kernel<T, D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (Tq + kTile - 1) / kTile);
  dq_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
      (const float*)lse, (const float*)delta, (T*)dq_out, strides_at(st, 0),
      strides_at(st, 1), strides_at(st, 2), strides_at(st, 3),
      strides_at(st, 4), H, Tq, Tk, k_len, scale, causal != 0);
  return cudaGetLastError();
}

template <typename T, int D>
int dkv(const void* q, const void* k, const void* v, const void* dout,
        const void* lse, const void* delta, void* dk, void* dv, int B,
        int H, int Tq, int Tk, int k_len, const long long* st, float scale,
        int causal, cudaStream_t stream) {
  const size_t smem =
      (4 * kTile * (D + 4) + 2 * kTile * kLP + 2 * kTile) * sizeof(float);
  cudaError_t err = prepare(dkv_kernel<T, D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (Tk + kTile - 1) / kTile);
  dkv_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
      (const float*)lse, (const float*)delta, (T*)dk, (T*)dv,
      strides_at(st, 0), strides_at(st, 1), strides_at(st, 2),
      strides_at(st, 3), strides_at(st, 4), strides_at(st, 5), H, Tq, Tk,
      k_len, scale, causal != 0);
  return cudaGetLastError();
}

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
      return -1;                                                          \
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
