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
// Two kernels compute it; the wrapper (ops/grouped_conv.py `_route`) picks
// one per call and each has its own C entry points.
//
// dw_mma_kernel (bf16, the main path): tensor cores, mma.sync m16n8k16
// with fp32 accumulators (csrc/hopper_mma.cuh). In lane-merged NCHW both
// operands of a (lane, tap) product already have the reduction axis
// contiguous: A = the tap-shifted x, [Ci x K], one channel plane a row,
// and B = dy stored as Co rows of K, the `.col` operand; so plain
// ldmatrix (no .trans) loads both. A K tile is R whole output rows of one
// image. The block copies the tile's dy rows and the x rows h0-pt ..
// h0-pt+R+kh-2 with 16-byte cp.async (rows outside the image zero-filled;
// no padded copy exists in device memory), up to four tiles at once, so
// that three tiles are in flight while one is multiplied. The one
// misalignment is the column shift dw-pl (+-2 bytes for a 3x3 kernel):
// from the staged rows the block builds one column-shifted copy per
// filter column in shared memory (funnel shifts of 16-byte chunks, zero
// outside the image), and copy dw serves all kh taps of that column at
// the 16-byte aligned row offset dh*Wo. So each byte of x and dy is read
// from device memory once for all the taps a block serves. M = Ci and
// N = Co are padded with zero rows to CH = 16, 32 or 64 (the stem's
// Ci = 3 runs here too). A warp owns up to TWM taps of one filter column
// x one m16 tile x up to four n8 tiles and reuses its dy fragments across
// its taps; where a block has fewer such units than 8 warps, its warps
// split the tile's k16 steps and merge through shared memory in a fixed
// order. It takes bf16, Ci and Co <= 64, W and Wo multiples of 8 (rows of
// whole 16-byte chunks), 16-byte aligned x and dy, W <= 64 and kernels up
// to 5x5, so that its tiles fit in shared memory.
//
// dw_partial_kernel (fp32, and the bf16 shapes the first does not take):
// CUDA cores. K is walked in tiles of R output rows x CW output columns
// of one image. A block stages the tile's dy and the x window the tile's
// taps read (the tile plus a halo of kh-1 rows and kw-1 columns; outside
// the image the window is filled by masking) in shared memory as fp32, so
// x is read once for all the taps a block serves instead of once per tap.
// A block serves TPB taps (all nine of a 3x3 kernel when Ci, Co <= 16,
// one row of three when <= 32, one when <= 64); each thread owns a 4x4
// register tile of the [Ci, Co] product of one tap.
//
// Both split K across blocks (split-K): at the main path's shapes there
// are only L*kh*kw = 72 (lane, tap) pairs for 132 SMs. Each block writes
// its partial sums to `work` [L*kh*kw, nsplit, Ci*Co] and a second pass
// (dw_reduce_kernel) adds the splits in split order, so the result is
// deterministic (no atomics).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_mma.cuh"

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
  // from a start and a step already split into digits
  __device__ Walk(const int* start, const int* step)
      : w(start[0]), h(start[1]), c(start[2]),
        dw(step[0]), dh(step[1]), dc(step[2]) {}
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

// ---------------------------------------------------------------------------
// Tensor-core route (bf16)
// ---------------------------------------------------------------------------
constexpr int kMmaMaxWarps = 8;
constexpr int kMmaMaxW = 64;         // widest x row
constexpr int kMmaMaxK = 5;          // largest kh, kw
// output positions per K tile, at least: 256 where CH is 16 (a tile's
// products are few, so fewer tiles), else 128
constexpr int kMmaKTarget16 = 256, kMmaKTarget = 128;
constexpr int kMmaMaxSmem = 227 * 1024;
constexpr int kMmaMaxStages = 4;     // K tiles staged at once, at most
constexpr int kMmaStageBudget = 113 * 1024;  // fewer stages above: 2 an SM

// Per channel count CH (Ci and Co rounded up to 16, 32 or 64): a warp's
// unit is TWM taps at most x one m16 tile x NTW n8 tiles.
template <int CH>
struct MmaCfg {
  static constexpr int MT = CH / 16;             // m16 tiles
  static constexpr int NT = CH / 8;              // n8 tiles
  static constexpr int NTW = NT < 4 ? NT : 4;    // n8 tiles a warp
  static constexpr int NG = NT / NTW;            // n groups
  static constexpr int TWM = CH == 16 ? 9 : 3;   // taps a warp at most
  static constexpr int ACC = TWM * NTW * 4;      // fp32 accumulators a lane
};

int mma_twm(int ch) {
  return ch == 16 ? MmaCfg<16>::TWM : ch == 32 ? MmaCfg<32>::TWM
                                               : MmaCfg<64>::TWM;
}
int mma_acc(int ch) {
  return ch == 16 ? MmaCfg<16>::ACC : ch == 32 ? MmaCfg<32>::ACC
                                               : MmaCfg<64>::ACC;
}
int mma_unit_tiles(int ch) {  // (m16, n group) units a tap group has
  return ch == 16 ? MmaCfg<16>::MT * MmaCfg<16>::NG
       : ch == 32 ? MmaCfg<32>::MT * MmaCfg<32>::NG
                  : MmaCfg<64>::MT * MmaCfg<64>::NG;
}

struct MmaPlan {
  int B, L, Ci, Co, H, W, Ho, Wo, kh, kw, pt, pl;
  int ch;          // Ci, Co rounded up to 16, 32 or 64
  int tw;          // taps a warp (consecutive in column-major tap order)
  int tpb;         // taps a block
  int tap_blocks;  // blocks a lane's taps take
  int kwb;         // filter columns (shifted copies) a block spans, at most
  int units;       // (taps, m16, n group) units a block
  int ks;          // warps that split each unit's k16 steps
  int threads;
  int R, HX;       // K tile: output rows; staged x rows (R + kh - 1)
  int SA, SB;      // row strides (elements) of the copies and of dy
  int nrb, ntiles, tps, nsplit;
  int nstage;      // K tiles staged at once (2..4)
  // the block's index walks, a step of `threads` as (w, h, c) digits: the
  // x rows [Ci][HX][W/8], the dy rows [Co][R][Wo/8], the copies
  // [Ci][HX][Wo/8] (16-byte chunks)
  int steps[9];
  int smem;
};

int round_stride(int n) {  // an odd number of 16-byte chunks: ldmatrix's
  return (n / 8) % 2 ? n : n + 8;  // eight rows fall in eight bank groups
}

MmaPlan make_mma_plan(int B, int L, int Ci, int Co, int H, int W, int Ho,
                      int Wo, int kh, int kw, int pt, int pl, int n_sm) {
  MmaPlan p{B, L, Ci, Co, H, W, Ho, Wo, kh, kw, pt, pl};
  const int c = Ci > Co ? Ci : Co;
  p.ch = c <= 16 ? 16 : (c <= 32 ? 32 : 64);
  const int taps = kh * kw, twm = mma_twm(p.ch);
  const int unit_tiles = mma_unit_tiles(p.ch);
  p.tw = 1;
  if (taps <= twm) {
    p.tw = taps;
  } else {
    for (int d = 1; d <= kh; ++d)
      if (kh % d == 0 && d <= twm) p.tw = d;
  }
  const int groups = taps / p.tw;
  int gpb = 1;
  for (int d = 1; d <= groups; ++d)
    if (groups % d == 0 && d * unit_tiles <= kMmaMaxWarps) gpb = d;
  p.tpb = gpb * p.tw;
  p.tap_blocks = groups / gpb;
  p.units = gpb * unit_tiles;
  p.ks = 1;
  while (p.units * p.ks * 2 <= kMmaMaxWarps) p.ks *= 2;
  p.threads = 32 * p.units * p.ks;
  p.kwb = 0;
  for (int tb = 0; tb < p.tap_blocks; ++tb) {
    const int q0 = tb * p.tpb, q1 = q0 + p.tpb - 1;
    const int span = q1 / kh - q0 / kh + 1;
    if (span > p.kwb) p.kwb = span;
  }
  // K tile: whole output rows, a multiple of 16 positions
  const int target = p.ch == 16 ? kMmaKTarget16 : kMmaKTarget;
  p.R = (target + Wo - 1) / Wo;
  if (p.R > Ho) p.R = Ho;
  if ((p.R * Wo) % 16) ++p.R;
  p.HX = p.R + kh - 1;
  p.SA = round_stride(p.HX * Wo);
  p.SB = round_stride(p.R * Wo);
  p.nrb = (Ho + p.R - 1) / p.R;
  p.ntiles = B * p.nrb;
  // about two blocks an SM, and no more than twice the input bytes in
  // partial sums
  const int base = L * p.tap_blocks;
  const long long in_bytes = 2LL * B * L * (Ci * (long long)H * W +
                                            Co * (long long)Ho * Wo);
  const long long part_bytes = 4LL * L * taps * Ci * Co;
  long long want = (2LL * n_sm + base - 1) / base;
  if (want > 2 * in_bytes / part_bytes) want = 2 * in_bytes / part_bytes;
  if (want > p.ntiles) want = p.ntiles;
  if (want < 1) want = 1;
  p.tps = (int)((p.ntiles + want - 1) / want);
  p.nsplit = (p.ntiles + p.tps - 1) / p.tps;
  // as many stages as fit: x rows and dy rows a stage, plus the copies
  const int stage = 2 * (Ci * p.HX * W + p.ch * p.SB);
  const int copies = 2 * p.kwb * p.ch * p.SA;
  const int starts = 4 * 9 * p.threads;
  p.nstage = kMmaMaxStages;
  while (p.nstage > 2 && p.nstage * stage + copies + starts > kMmaStageBudget)
    --p.nstage;
  const int dims[3][2] = {{W / 8, p.HX}, {Wo / 8, p.R}, {Wo / 8, p.HX}};
  for (int i = 0; i < 3; ++i) {
    const int nw = dims[i][0], nh = dims[i][1];
    p.steps[3 * i] = p.threads % nw;
    p.steps[3 * i + 1] = (p.threads / nw) % nh;
    p.steps[3 * i + 2] = p.threads / (nw * nh);
  }
  // each thread's walk starts, kept in shared memory: a Walk's divisions,
  // once a block instead of once a tile
  const int pipe = p.nstage * stage + copies + starts;
  const int merge = 4 * (p.ks - 1) * p.units * mma_acc(p.ch) * 32;
  p.smem = pipe > merge ? pipe : merge;
  return p;
}

bool mma_plan_ok(const MmaPlan& p) {
  return p.Ci >= 1 && p.Co >= 1 && p.Ci <= kMaxCh && p.Co <= kMaxCh &&
         p.kh >= 1 && p.kw >= 1 && p.kh <= kMmaMaxK && p.kw <= kMmaMaxK &&
         p.Ho >= 1 && p.Wo >= 8 && p.W >= 8 && p.W <= kMmaMaxW &&
         p.W % 8 == 0 && p.Wo % 8 == 0 && p.smem <= kMmaMaxSmem;
}

// 8 bf16 starting OFF (0..7) elements into the 16 elements a, b
template <int OFF>
__device__ __forceinline__ uint4 shift_chunk(uint4 a, uint4 b) {
  const uint32_t w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  constexpr int q = OFF >> 1;
  uint32_t o[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    o[i] = OFF & 1 ? __funnelshift_r(w[i + q], w[i + q + 1], 16) : w[i + q];
  return make_uint4(o[0], o[1], o[2], o[3]);
}

// One column-shifted copy: dst[ci][r*Wo + w] = x row r of channel ci at
// column w + s, s = 8*sc + OFF, zero outside the row; `rs` the staged
// rows [Ci][HX][W/8] in 16-byte chunks, `k` this thread's walk over
// [Ci][HX][Wo/8].
template <int OFF>
__device__ __forceinline__ void shift_rows(const uint4* rs,
                                           __nv_bfloat16* dst, Walk k,
                                           int Ci, int HX, int WC, int WoC,
                                           int Wo, int SA, int sc) {
  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (; k.c < Ci; k.next(HX, WoC)) {
    const int cb = k.w + sc;
    const uint4* row = rs + (k.c * HX + k.h) * WC;
    const uint4 a = cb >= 0 && cb < WC ? row[cb] : zero;
    uint4 b = zero;
    if (OFF != 0 && cb + 1 >= 0 && cb + 1 < WC) b = row[cb + 1];
    *reinterpret_cast<uint4*>(dst + k.c * SA + k.h * Wo + k.w * 8) =
        shift_chunk<OFF>(a, b);
  }
}

// floor division by 8
__device__ __forceinline__ int floor8(int v) {
  return v >= 0 ? v / 8 : -((7 - v) / 8);
}

template <int CH>
__global__ void __launch_bounds__(kMmaMaxWarps * 32, 2)
dw_mma_kernel(const __nv_bfloat16* __restrict__ x,
              const __nv_bfloat16* __restrict__ dy,
              float* __restrict__ work, MmaPlan p) {
  using Cfg = MmaCfg<CH>;
  constexpr int TWM = Cfg::TWM, NTW = Cfg::NTW, ACC = Cfg::ACC;
  extern __shared__ __align__(16) unsigned char smem_mma[];
  const int WC = p.W / 8, WoC = p.Wo / 8;
  const int raw_n = p.Ci * p.HX * p.W;             // one stage, elements
  const int S = p.nstage;
  __nv_bfloat16* raw = reinterpret_cast<__nv_bfloat16*>(smem_mma);
  __nv_bfloat16* cpy = raw + S * raw_n;            // [kwb][CH][SA]
  __nv_bfloat16* gs = cpy + p.kwb * CH * p.SA;     // [S][CH][SB]

  const int taps = p.kh * p.kw;
  const int l = blockIdx.x / p.tap_blocks;
  const int q0 = (blockIdx.x % p.tap_blocks) * p.tpb;  // column-major taps
  const int dw_lo = q0 / p.kh;
  const int dw_hi = min((q0 + p.tpb - 1) / p.kh, p.kw - 1);
  const int ncopy = dw_hi - dw_lo + 1;
  const int split = blockIdx.y;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int warp = tid / 32, lane = tid % 32;
  const int unit = warp % p.units, kslot = warp / p.units;
  const int ng = unit % Cfg::NG, mt = (unit / Cfg::NG) % Cfg::MT;
  const int grp = unit / (Cfg::NG * Cfg::MT);
  const int qw = q0 + grp * p.tw;                  // this warp's first tap

  // shared offsets (elements) of this warp's A rows for each of its taps
  int aoff[TWM];
#pragma unroll
  for (int j = 0; j < TWM; ++j) {
    const int q = qw + (j < p.tw ? j : 0);
    const int cdw = q / p.kh, cdh = q % p.kh;
    aoff[j] = ((cdw - dw_lo) * CH + mt * 16 + ((lane >> 3) & 1) * 8 +
               (lane & 7)) * p.SA + cdh * p.Wo + (lane >> 4) * 8;
  }
  const int boff = ((ng * NTW + (lane >> 4)) * 8 + (lane & 7)) * p.SB +
                   ((lane >> 3) & 1) * 8;

  float acc[TWM][NTW][4];
#pragma unroll
  for (int j = 0; j < TWM; ++j)
#pragma unroll
    for (int n = 0; n < NTW; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[j][n][c] = 0.f;

  // this thread's walk starts, as (w, h, c) digits of tid
  int* wst = reinterpret_cast<int*>(gs + S * CH * p.SB);  // [9][nthr]
  {
    const int dims[3][2] = {{WC, p.HX}, {WoC, p.R}, {WoC, p.HX}};
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const int nw = dims[i][0], nh = dims[i][1];
      wst[(3 * i) * nthr + tid] = tid % nw;
      wst[(3 * i + 1) * nthr + tid] = (tid / nw) % nh;
      wst[(3 * i + 2) * nthr + tid] = tid / (nw * nh);
    }
  }
  auto walk = [&](int i) {
    const int start[3] = {wst[(3 * i) * nthr + tid],
                          wst[(3 * i + 1) * nthr + tid],
                          wst[(3 * i + 2) * nthr + tid]};
    return Walk(start, p.steps + 3 * i);
  };

  // zero the copies and dy stages once: rows past Ci and Co stay zero
  {
    uint4* z = reinterpret_cast<uint4*>(cpy);
    const int n16 = (p.kwb * CH * p.SA + S * CH * p.SB) / 8;
    for (int e = tid; e < n16; e += nthr) z[e] = make_uint4(0, 0, 0, 0);
  }
  __syncthreads();

  const long long HW = (long long)p.H * p.W, HWo = (long long)p.Ho * p.Wo;
  const int t_begin = split * p.tps;
  const int t_end = min(p.ntiles, t_begin + p.tps);
  // tiles are issued in order: the next one's image and row block
  int nb = t_begin / p.nrb, nrow = t_begin - nb * p.nrb;
  auto issue = [&](int st) {
    const int b = nb, h0 = nrow * p.R;
    if (++nrow == p.nrb) {
      nrow = 0;
      ++nb;
    }
    const __nv_bfloat16* xb = x + ((long long)b * p.L + l) * p.Ci * HW;
    const __nv_bfloat16* gb = dy + ((long long)b * p.L + l) * p.Co * HWo;
    __nv_bfloat16* rs = raw + st * raw_n;
    for (Walk k = walk(0); k.c < p.Ci; k.next(p.HX, WC)) {
      const int ih = h0 - p.pt + k.h;
      const bool ok = ih >= 0 && ih < p.H;
      hopper::cp_async16(
          rs + (k.c * p.HX + k.h) * p.W + k.w * 8,
          ok ? xb + k.c * HW + (long long)ih * p.W + k.w * 8 : x, ok);
    }
    __nv_bfloat16* gd = gs + st * CH * p.SB;
    for (Walk k = walk(1); k.c < p.Co; k.next(p.R, WoC)) {
      const int h = h0 + k.h;
      const bool ok = h < p.Ho;
      hopper::cp_async16(
          gd + k.c * p.SB + k.h * p.Wo + k.w * 8,
          ok ? gb + k.c * HWo + (long long)h * p.Wo + k.w * 8 : dy, ok);
    }
  };

  const int k16 = p.R * p.Wo / 16;
  // S-1 tiles in flight ahead of the one multiplied, one commit group a
  // tile (empty past the end)
  for (int i = 0; i < S - 1; ++i) {
    if (t_begin + i < t_end) issue(i);
    hopper::cp_async_commit();
  }
  for (int t = t_begin, st = 0; t < t_end;
       ++t, st = st + 1 == S ? 0 : st + 1) {
    // tile t has landed once at most S-2 later groups are pending
    if (S == 4)
      hopper::cp_async_wait<2>();
    else if (S == 3)
      hopper::cp_async_wait<1>();
    else
      hopper::cp_async_wait<0>();
    // every thread's copies of tile t have landed, and every warp is done
    // with tile t-1: its stage may be refilled and the copies rebuilt
    __syncthreads();
    if (t + S - 1 < t_end) issue(st == 0 ? S - 1 : st - 1);
    hopper::cp_async_commit();
    // column-shifted copies: cpy[d][ci][r*Wo + w] = x row r, column
    // w + dw - pl (zero outside the image), for the block's columns
    {
      const uint4* rs = reinterpret_cast<const uint4*>(raw + st * raw_n);
      for (int d = 0; d < ncopy; ++d) {
        const int s = dw_lo + d - p.pl;
        const int sc = floor8(s);
        __nv_bfloat16* dst = cpy + d * CH * p.SA;
        const Walk k = walk(2);
        switch (s - 8 * sc) {
#define FEDML_SHIFT_CASE(OFF)                                              \
  case OFF:                                                                \
    shift_rows<OFF>(rs, dst, k, p.Ci, p.HX, WC, WoC, p.Wo, p.SA, sc);      \
    break;
          FEDML_SHIFT_CASE(0) FEDML_SHIFT_CASE(1) FEDML_SHIFT_CASE(2)
          FEDML_SHIFT_CASE(3) FEDML_SHIFT_CASE(4) FEDML_SHIFT_CASE(5)
          FEDML_SHIFT_CASE(6) FEDML_SHIFT_CASE(7)
#undef FEDML_SHIFT_CASE
        }
      }
    }
    __syncthreads();
    const __nv_bfloat16* gst = gs + st * CH * p.SB + boff;
    for (int kk = kslot; kk < k16; kk += p.ks) {
      uint32_t bf[NTW / 2][4];
#pragma unroll
      for (int q = 0; q < NTW / 2; ++q)
        hopper::ldmatrix_x4(bf[q], gst + q * 16 * p.SB + kk * 16);
#pragma unroll
      for (int j = 0; j < TWM; ++j) {
        if (j < p.tw) {
          uint32_t a[4];
          hopper::ldmatrix_x4(a, cpy + aoff[j] + kk * 16);
#pragma unroll
          for (int n = 0; n < NTW; ++n)
            hopper::mma_bf16(acc[j][n], a, bf[n / 2][(n % 2) * 2],
                             bf[n / 2][(n % 2) * 2 + 1]);
        }
      }
    }
  }
  __syncthreads();  // the products are done before `red` reuses the stages

  // warps that split a unit's k16 steps merge onto kslot 0, in kslot order
  if (p.ks > 1) {
    float* red = reinterpret_cast<float*>(smem_mma);
    if (kslot > 0) {
      float* dst = red + ((kslot - 1) * p.units + unit) * ACC * 32 + lane;
#pragma unroll
      for (int j = 0; j < TWM; ++j)
#pragma unroll
        for (int n = 0; n < NTW; ++n)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            dst[((j * NTW + n) * 4 + c) * 32] = acc[j][n][c];
    }
    __syncthreads();
    if (kslot == 0) {
      for (int k = 1; k < p.ks; ++k) {
        const float* src = red + ((k - 1) * p.units + unit) * ACC * 32 + lane;
#pragma unroll
        for (int j = 0; j < TWM; ++j)
#pragma unroll
          for (int n = 0; n < NTW; ++n)
#pragma unroll
            for (int c = 0; c < 4; ++c)
              acc[j][n][c] += src[((j * NTW + n) * 4 + c) * 32];
      }
    }
  }
  if (kslot > 0) return;
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int j = 0; j < TWM; ++j) {
    if (j >= p.tw) break;
    const int q = qw + j;
    const int tap = (q % p.kh) * p.kw + q / p.kh;
    float* dst = work + (((long long)l * taps + tap) * p.nsplit + split) *
                            p.Ci * p.Co;
#pragma unroll
    for (int n = 0; n < NTW; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int ci = mt * 16 + g + (c >> 1) * 8;
        const int co = (ng * NTW + n) * 8 + 2 * t4 + (c & 1);
        if (ci < p.Ci && co < p.Co) dst[ci * p.Co + co] = acc[j][n][c];
      }
  }
}

template <int CH>
cudaError_t prepare_mma(const MmaPlan& p) {
  return cudaFuncSetAttribute(dw_mma_kernel<CH>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              p.smem);
}

template <int CH>
cudaError_t launch_mma_ch(const void* x, const void* dy, void* work,
                          const MmaPlan& p, cudaStream_t st) {
  cudaError_t err = prepare_mma<CH>(p);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.L * p.tap_blocks, p.nsplit);
  dw_mma_kernel<CH><<<grid, p.threads, p.smem, st>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(dy), static_cast<float*>(work), p);
  return cudaGetLastError();
}

template <int CH>
int mma_occupancy(const MmaPlan& p, int* out) {
  cudaError_t err = prepare_mma<CH>(p);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, dw_mma_kernel<CH>, p.threads, p.smem);
  if (err != cudaSuccess) return (int)err;
  out[0] = p.threads;
  out[1] = p.smem;
  out[2] = blocks;
  out[3] = p.nsplit;
  out[4] = p.ch;
  return 0;
}

// Second pass of the tensor-core route: the sums of dw_reduce_kernel, over
// the splits in split order (so the same bits), with a thread for each
// element of `work`'s contiguous Ci*Co axis, so that its reads coalesce.
__global__ void dw_mma_reduce_kernel(const float* __restrict__ work,
                                     float* __restrict__ out, MmaPlan p) {
  const int P = p.Ci * p.Co, taps = p.kh * p.kw;
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (long long)p.L * taps * P) return;
  const int io = (int)(e % P);
  const long long pair = e / P;
  const int tap = (int)(pair % taps), l = (int)(pair / taps);
  const int i = io / p.Co, o = io % p.Co;
  const float* src = work + pair * p.nsplit * P + io;
  float v = 0.f;
  for (int q = 0; q < p.nsplit; ++q) v += src[(long long)q * P];
  out[(((long long)l * p.Co + o) * p.Ci + i) * taps + tap] = v;
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

// The tensor-core route (bf16 x and dy, 16-byte aligned): the number of K
// splits, to size `work` as [L*kh*kw, nsplit, Ci*Co] fp32, or -1 for
// shapes it does not take.
extern "C" int fedml_grouped_conv_dw_mma_nsplit(int B, int L, int Ci, int Co,
                                                int H, int W, int Ho, int Wo,
                                                int kh, int kw, int pt,
                                                int pl, int n_sm) {
  const MmaPlan p =
      make_mma_plan(B, L, Ci, Co, H, W, Ho, Wo, kh, kw, pt, pl, n_sm);
  return mma_plan_ok(p) ? p.nsplit : -1;
}

extern "C" int fedml_grouped_conv_dw_mma(const void* x, const void* dy,
                                         void* out, void* work, int B, int L,
                                         int Ci, int Co, int H, int W, int Ho,
                                         int Wo, int kh, int kw, int pt,
                                         int pl, int n_sm, void* stream) {
  const MmaPlan p =
      make_mma_plan(B, L, Ci, Co, H, W, Ho, Wo, kh, kw, pt, pl, n_sm);
  if (!mma_plan_ok(p)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (p.ch == 16)
    err = launch_mma_ch<16>(x, dy, work, p, st);
  else if (p.ch == 32)
    err = launch_mma_ch<32>(x, dy, work, p, st);
  else
    err = launch_mma_ch<64>(x, dy, work, p, st);
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)L * kh * kw * Ci * Co;
  dw_mma_reduce_kernel<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
      static_cast<const float*>(work), static_cast<float*>(out), p);
  return (int)cudaGetLastError();
}

// The tensor-core route's launch at a shape: out[0] threads a block,
// out[1] shared bytes a block, out[2] blocks an SM can hold, out[3] K
// splits, out[4] the channel count CH it is instantiated at. Returns 0,
// -1 for shapes it does not take, or a CUDA error code.
extern "C" int fedml_grouped_conv_dw_mma_info(int B, int L, int Ci, int Co,
                                              int H, int W, int Ho, int Wo,
                                              int kh, int kw, int pt, int pl,
                                              int n_sm, int* out) {
  const MmaPlan p =
      make_mma_plan(B, L, Ci, Co, H, W, Ho, Wo, kh, kw, pt, pl, n_sm);
  if (!mma_plan_ok(p)) return -1;
  if (p.ch == 16) return mma_occupancy<16>(p, out);
  if (p.ch == 32) return mma_occupancy<32>(p, out);
  return mma_occupancy<64>(p, out);
}
