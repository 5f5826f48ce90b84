// Per-lane (grouped) conv weight gradient, stride 1, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_dw_tap_kernel` reached through
// `grouped_conv_dw` / `lane_conv_pallas` in fedml_tpu/ops/pallas_grouped_conv.py.
// It computes, for every lane l and filter tap (dh, dw),
//
//     dW[l*Co + o, i, dh, dw] = sum_{b,h,w} x[b, l*Ci + i, h+dh-pt, w+dw-pl]
//                                           * dy[b, l*Co + o, h, w]
//
// over lane-merged NCHW activations x [B, L*Ci, H, W] and output
// cotangents dy [B, L*Co, Ho, Wo]. The result is the fp32 weight gradient
// of the groups=L conv, [L*Co, Ci, kh, kw]. Each (lane, tap) pair is a
// tall-skinny [Ci x K] . [K x Co] product with K = B*Ho*Wo.
//
// What bounds it: memory. The function reads x and dy once each (about
// 33.5 MB per stage-1 conv of ResNet-56 at L=8, B=64, 32x32 in bf16) and
// does 2*Ci*Co*kh*kw*K operations, far below the card's compute/byte ratio.
//
// Design. At the main path's shapes there are only L*kh*kw = 72 (lane, tap)
// pairs for 132 SMs, and Ci, Co <= 64, so one block per pair would leave
// most of the card idle behind a 65,536-long serial reduction. The kernel
// therefore splits K across blocks (split-K) and sums the splits in a
// second pass, in a fixed order, so the result is deterministic (no
// atomics).
//
// K is walked in tiles of R output rows x CW output columns of one image.
// A block stages the tile's dy and the x window the tile's taps read (the
// tile plus a halo of kh-1 rows and kw-1 columns; outside the image the
// window is filled by masking, no padded copy exists) in shared memory as
// fp32, so x is read once for all the taps a block serves instead of once
// per tap. A block serves TPB taps (all nine of a 3x3 kernel when Ci, Co
// <= 16, one row of three when <= 32, one when <= 64); each thread owns a
// 4x4 register tile of the [Ci, Co] product of one tap. Tensor cores
// (wgmma, TMA) are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxCh = 64;        // largest Ci and Co the kernel takes
constexpr int kMaxThreads = 256;
constexpr int kBlocksPerSm = 4;   // split-K target
constexpr int kMaxRows = 8;       // output rows per tile
constexpr int kMaxSmem = 200 * 1024;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Walks e = t, t + n, t + 2n, ... over a [C][NH][NW] index space as
// (c, h, w) digits, carrying instead of dividing on every step.
struct Walk {
  int w, h, c, dw, dh, dc;
  __device__ Walk(int t, int n, int NH, int NW)
      : w(t % NW), h((t / NW) % NH), c(t / (NW * NH)),
        dw(n % NW), dh((n / NW) % NH), dc(n / (NW * NH)) {}
  __device__ void next(int NH, int NW) {
    w += dw;
    int carry = w >= NW;
    w -= carry * NW;
    h += dh + carry;
    carry = h >= NH;
    h -= carry * NH;
    c += dc + carry;
  }
};

struct Plan {
  int B, L, Ci, Co, H, W, Ho, Wo, kh, kw, pt, pl;
  int ch;        // Ci, Co rounded up to 16, 32 or 64
  int tpb;       // taps per block
  int tap_blocks;
  int R, CW;     // tile: output rows x output columns
  int nrb, ncb, ntiles, tps, nsplit;
  int smem;      // dynamic shared bytes
};

Plan make_plan(int B, int L, int Ci, int Co, int H, int W, int Ho, int Wo,
               int kh, int kw, int pt, int pl, int n_sm) {
  Plan p{B, L, Ci, Co, H, W, Ho, Wo, kh, kw, pt, pl};
  const int c = Ci > Co ? Ci : Co;
  p.ch = c <= 16 ? 16 : (c <= 32 ? 32 : 64);
  const int nt = (p.ch / 4) * (p.ch / 4);  // threads per tap
  const int taps = kh * kw;
  p.tpb = 1;
  for (int d = 1; d <= taps; ++d)
    if (taps % d == 0 && d * nt <= kMaxThreads) p.tpb = d;
  p.tap_blocks = taps / p.tpb;
  const int tk = 4096 / p.ch;  // output positions per tile
  p.CW = Wo < tk ? Wo : tk;
  p.R = tk / p.CW;
  if (p.R > kMaxRows) p.R = kMaxRows;
  if (p.R > Ho) p.R = Ho;
  p.nrb = (Ho + p.R - 1) / p.R;
  p.ncb = (Wo + p.CW - 1) / p.CW;
  p.ntiles = B * p.nrb * p.ncb;
  const int base = L * p.tap_blocks;
  int want = (kBlocksPerSm * n_sm + base - 1) / base;
  if (want < 1) want = 1;
  if (want > p.ntiles) want = p.ntiles;
  p.tps = (p.ntiles + want - 1) / want;
  p.nsplit = (p.ntiles + p.tps - 1) / p.tps;
  const int ld = p.ch + 4;
  const int halo = (p.R + kh - 1) * (p.CW + kw - 1);
  p.smem = (halo + p.R * p.CW) * ld * (int)sizeof(float);
  return p;
}

template <typename T, int CH>
__global__ void __launch_bounds__(kMaxThreads)
dw_partial_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                  float* __restrict__ work, Plan p) {
  constexpr int LD = CH + 4;              // shared row stride (floats)
  constexpr int NT = (CH / 4) * (CH / 4);
  extern __shared__ __align__(16) float smem[];
  const int HX = p.R + p.kh - 1, WX = p.CW + p.kw - 1;
  float* xs = smem;                // [HX * WX][LD]
  float* gs = smem + HX * WX * LD; // [R * CW][LD]

  const int l = blockIdx.x / p.tap_blocks;
  const int tap0 = (blockIdx.x % p.tap_blocks) * p.tpb;
  const int split = blockIdx.y;
  const int t = threadIdx.x, nthreads = blockDim.x;
  const int tap = tap0 + t / NT;
  const int dh = tap / p.kw, dw = tap % p.kw;
  const int ti = (t % NT) / (CH / 4), to = t % (CH / 4);

  const long long HW = (long long)p.H * p.W, HWo = (long long)p.Ho * p.Wo;
  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[a][c] = 0.f;

  const int tile_end = min(p.ntiles, (split + 1) * p.tps);
  for (int tile = split * p.tps; tile < tile_end; ++tile) {
    const int cb = tile % p.ncb;
    const int rb = (tile / p.ncb) % p.nrb;
    const int b = tile / (p.ncb * p.nrb);
    const int h0 = rb * p.R, w0 = cb * p.CW;
    const T* xb = x + ((long long)b * p.L + l) * p.Ci * HW;
    const T* gb = dy + ((long long)b * p.L + l) * p.Co * HWo;

    // x window: rows h0-pt .. h0-pt+HX-1, columns w0-pl .. w0-pl+WX-1
#pragma unroll 4
    for (Walk k(t, nthreads, HX, WX); k.c < CH; k.next(HX, WX)) {
      const int ih = h0 - p.pt + k.h, iw = w0 - p.pl + k.w;
      float v = 0.f;
      if (k.c < p.Ci && ih >= 0 && ih < p.H && iw >= 0 && iw < p.W)
        v = to_f32(xb[k.c * HW + (long long)ih * p.W + iw]);
      xs[(k.h * WX + k.w) * LD + k.c] = v;
    }
#pragma unroll 4
    for (Walk k(t, nthreads, p.R, p.CW); k.c < CH; k.next(p.R, p.CW)) {
      const int h = h0 + k.h, w = w0 + k.w;
      float v = 0.f;
      if (k.c < p.Co && h < p.Ho && w < p.Wo)
        v = to_f32(gb[k.c * HWo + (long long)h * p.Wo + w]);
      gs[(k.h * p.CW + k.w) * LD + k.c] = v;
    }
    __syncthreads();

    if (t < p.tpb * NT) {
      for (int rr = 0; rr < p.R; ++rr) {
        const float* xr = xs + ((rr + dh) * WX + dw) * LD + 4 * ti;
        const float* gr = gs + rr * p.CW * LD + 4 * to;
#pragma unroll 4
        for (int cc = 0; cc < p.CW; ++cc) {
          const float4 a = *reinterpret_cast<const float4*>(xr + cc * LD);
          const float4 g = *reinterpret_cast<const float4*>(gr + cc * LD);
          const float av[4] = {a.x, a.y, a.z, a.w};
          const float gv[4] = {g.x, g.y, g.z, g.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int o = 0; o < 4; ++o) acc[i][o] += av[i] * gv[o];
        }
      }
    }
    __syncthreads();
  }

  if (t < p.tpb * NT) {
    const int taps = p.kh * p.kw;
    float* dst = work + (((long long)l * taps + tap) * p.nsplit + split) *
                            p.Ci * p.Co;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int o = 0; o < 4; ++o) {
        const int ci = 4 * ti + i, co = 4 * to + o;
        if (ci < p.Ci && co < p.Co) dst[ci * p.Co + co] = acc[i][o];
      }
  }
}

// Second pass: out[(l*Co + o), i, dh, dw] = sum over splits, in split order.
__global__ void dw_reduce_kernel(const float* __restrict__ work,
                                 float* __restrict__ out, Plan p) {
  const long long total = (long long)p.L * p.Co * p.Ci * p.kh * p.kw;
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const int dw = (int)(e % p.kw);
  const int dh = (int)((e / p.kw) % p.kh);
  const int i = (int)((e / ((long long)p.kw * p.kh)) % p.Ci);
  const long long lo = e / ((long long)p.kw * p.kh * p.Ci);
  const int o = (int)(lo % p.Co), l = (int)(lo / p.Co);
  const int P = p.Ci * p.Co;
  const int pair = (l * p.kh + dh) * p.kw + dw;
  const float* src = work + (long long)pair * p.nsplit * P + i * p.Co + o;
  float v = 0.f;
  for (int q = 0; q < p.nsplit; ++q) v += src[(long long)q * P];
  out[e] = v;
}

template <typename T, int CH>
cudaError_t launch_ch(const void* x, const void* dy, void* work,
                      const Plan& p, cudaStream_t st) {
  auto kern = dw_partial_kernel<T, CH>;
  if (p.smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(p.L * p.tap_blocks, p.nsplit);
  const int threads = (p.tpb * (CH / 4) * (CH / 4) + 31) / 32 * 32;
  kern<<<grid, threads, p.smem, st>>>(static_cast<const T*>(x),
                                      static_cast<const T*>(dy),
                                      static_cast<float*>(work), p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_partial(const void* x, const void* dy, void* work,
                           const Plan& p, cudaStream_t st) {
  if (p.ch == 16) return launch_ch<T, 16>(x, dy, work, p, st);
  if (p.ch == 32) return launch_ch<T, 32>(x, dy, work, p, st);
  return launch_ch<T, 64>(x, dy, work, p, st);
}

bool plan_ok(const Plan& p) {
  return p.Ci >= 1 && p.Co >= 1 && p.Ci <= kMaxCh && p.Co <= kMaxCh &&
         p.kh >= 1 && p.kw >= 1 && p.Ho >= 1 && p.Wo >= 1 &&
         p.smem <= kMaxSmem;
}

}  // namespace

// Number of K splits the launch will use; the caller sizes the scratch
// `work` as [L*kh*kw, nsplit, Ci*Co] fp32. Returns -1 for shapes the
// kernel does not take.
extern "C" int fedml_grouped_conv_dw_nsplit(int B, int L, int Ci, int Co,
                                            int H, int W, int Ho, int Wo,
                                            int kh, int kw, int pt, int pl,
                                            int n_sm) {
  const Plan p = make_plan(B, L, Ci, Co, H, W, Ho, Wo, kh, kw, pt, pl, n_sm);
  return plan_ok(p) ? p.nsplit : -1;
}

extern "C" int fedml_grouped_conv_dw(const void* x, const void* dy, void* out,
                                     void* work, int is_bf16, int B, int L,
                                     int Ci, int Co, int H, int W, int Ho,
                                     int Wo, int kh, int kw, int pt, int pl,
                                     int n_sm, void* stream) {
  const Plan p = make_plan(B, L, Ci, Co, H, W, Ho, Wo, kh, kw, pt, pl, n_sm);
  if (!plan_ok(p)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = is_bf16
      ? launch_partial<__nv_bfloat16>(x, dy, work, p, st)
      : launch_partial<float>(x, dy, work, p, st);
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)L * Co * Ci * kh * kw;
  const int threads = 256;
  dw_reduce_kernel<<<(unsigned)((total + threads - 1) / threads), threads, 0,
                     st>>>(static_cast<const float*>(work),
                           static_cast<float*>(out), p);
  return (int)cudaGetLastError();
}
