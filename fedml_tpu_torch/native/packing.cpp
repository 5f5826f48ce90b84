// Native host runtime of the port's cohort packing
// (fedml_tpu_torch/parallel/packing.py; a copy of the JAX package's
// fedml_tpu/native/packing.cpp, so both build the same schedules).
//
// The host's work between rounds is staging: per-client shuffled batch
// schedules, the lane relayout of a schedule, and the gather of ragged
// client samples into dense [C, S, B, ...] arrays. This file does it with
// raw memcpy over a precomputed schedule, in parallel across clients.
//
// Exposed as a plain C ABI for ctypes.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// xoshiro256** -- small, fast, public-domain PRNG family; seeded per client.
struct Rng {
  uint64_t s[4];
  explicit Rng(uint64_t seed) {
    // splitmix64 seeding
    uint64_t z = seed;
    for (int i = 0; i < 4; i++) {
      z += 0x9e3779b97f4a7c15ULL;
      uint64_t t = z;
      t = (t ^ (t >> 30)) * 0xbf58476d1ce4e5b9ULL;
      t = (t ^ (t >> 27)) * 0x94d049bb133111ebULL;
      s[i] = t ^ (t >> 31);
    }
  }
  static uint64_t rotl(uint64_t x, int k) { return (x << k) | (x >> (64 - k)); }
  uint64_t next() {
    uint64_t r = rotl(s[1] * 5, 7) * 9;
    uint64_t t = s[1] << 17;
    s[2] ^= s[0]; s[3] ^= s[1]; s[1] ^= s[2]; s[0] ^= s[3];
    s[2] ^= t; s[3] = rotl(s[3], 45);
    return r;
  }
  // unbiased bounded draw (Lemire)
  uint64_t bounded(uint64_t n) {
    uint64_t x = next();
    __uint128_t m = (__uint128_t)x * n;
    uint64_t l = (uint64_t)m;
    if (l < n) {
      uint64_t t = (0 - n) % n;
      while (l < t) { x = next(); m = (__uint128_t)x * n; l = (uint64_t)m; }
    }
    return (uint64_t)(m >> 64);
  }
};

void shuffle_idx(std::vector<int64_t>& v, Rng& rng) {
  for (size_t i = v.size(); i > 1; i--) {
    size_t j = (size_t)rng.bounded(i);
    std::swap(v[i - 1], v[j]);
  }
}

// Strided thread-pool dispatch shared by every entry point: work(i) must
// write disjoint output rows per i.
template <typename F>
void parallel_for(int64_t n, F work) {
  int64_t nthreads =
      std::min<int64_t>(n, std::max(1u, std::thread::hardware_concurrency()));
  if (nthreads <= 1 || n == 1) {
    for (int64_t i = 0; i < n; i++) work(i);
    return;
  }
  std::vector<std::thread> pool;
  for (int64_t t = 0; t < nthreads; t++) {
    pool.emplace_back([&, t]() {
      for (int64_t i = t; i < n; i += nthreads) work(i);
    });
  }
  for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

// Build the per-client epoch/batch index schedule + mask.
//   n[c]      : client sample counts                    [C]
//   idx_out   : int64 slot -> local sample index        [C, S, B]
//   mask_out  : float32 slot validity                   [C, S, B]
// Semantics match packing.pack_cohort: per epoch a fresh permutation,
// ceil(n/B) batches per epoch (last ragged), tiny clients reuse the
// epoch's head, steps beyond the client's schedule fully masked.
void pack_schedule(const int64_t* n, int64_t C, int64_t S, int64_t B,
                   int64_t epochs, uint64_t seed, int64_t* idx_out,
                   float* mask_out) {
  auto work = [&](int64_t c) {
    Rng rng(seed * 0x9e3779b97f4a7c15ULL + (uint64_t)c + 1);
    int64_t nc = n[c];
    int64_t* idx = idx_out + c * S * B;
    float* mask = mask_out + c * S * B;
    std::memset(idx, 0, sizeof(int64_t) * S * B);
    std::memset(mask, 0, sizeof(float) * S * B);
    if (nc <= 0) return;
    std::vector<int64_t> order(nc);
    int64_t per_epoch = std::max<int64_t>(1, (nc + B - 1) / B);
    int64_t s = 0;
    for (int64_t e = 0; e < epochs; e++) {
      for (int64_t i = 0; i < nc; i++) order[i] = i;
      shuffle_idx(order, rng);
      for (int64_t b = 0; b < per_epoch && s < S; b++, s++) {
        int64_t lo = b * B;
        int64_t k = std::min(B, nc - lo);
        if (k <= 0) { lo = 0; k = std::min(B, nc); }  // tiny client reuse
        for (int64_t t = 0; t < k; t++) {
          idx[s * B + t] = order[lo + t];
          mask[s * B + t] = 1.0f;
        }
      }
    }
  };
  parallel_for(C, work);
}

// Gather client rows into the dense cohort tensor.
//   srcs[c]  : pointer to client c's contiguous [n_c, row_bytes] data
//   idx/mask : the schedule from pack_schedule                [C, S, B]
//   out      : [C, S, B, row_bytes]  (row_bytes = product of trailing dims
//              x element size; masked slots left zeroed by caller memset)
void pack_gather(const uint8_t* const* srcs, const int64_t* idx,
                 const float* mask, int64_t C, int64_t S, int64_t B,
                 int64_t row_bytes, uint8_t* out) {
  auto work = [&](int64_t c) {
    const uint8_t* src = srcs[c];
    for (int64_t s = 0; s < S; s++) {
      for (int64_t b = 0; b < B; b++) {
        int64_t slot = (c * S + s) * B + b;
        if (mask[slot] > 0.0f) {
          std::memcpy(out + slot * row_bytes, src + idx[slot] * row_bytes,
                      (size_t)row_bytes);
        }
      }
    }
  };
  parallel_for(C, work);
}

// Re-lay a cohort schedule into packed lanes (engine.LaneRunner layout).
// LPT lane membership is decided by the (cheap) caller; this fills the
// lane-major arrays -- the per-round O(C*S*B) relayout -- threaded per
// lane. Mirrors packing.pack_lanes exactly (tested byte-equal).
//   idx/mask            : cohort schedule            [C, S, B]
//   ns                  : client sample counts       [C] float32
//   steps_pc            : true step count per client [C]
//   members / offsets   : CSR lane membership (members[offsets[k] ..
//                         offsets[k+1]) = cohort ids of lane k, LPT order)
//   out_* (zeroed by caller): idx/mask [K, L, B]; slot, local_step int32
//   [K, L]; flush, flush_n, flush_steps float32 [K, L]
void pack_lanes_fill(const int32_t* idx, const float* mask, const float* ns,
                     const int64_t* steps_pc, const int64_t* members,
                     const int64_t* offsets, int64_t C, int64_t S, int64_t B,
                     int64_t K, int64_t L, int32_t* out_idx, float* out_mask,
                     int32_t* slot, int32_t* local_step, float* flush,
                     float* flush_n, float* flush_steps) {
  auto work = [&](int64_t k) {
    int64_t pos = 0;
    for (int64_t m = offsets[k]; m < offsets[k + 1]; m++) {
      int64_t c = members[m];
      if (c < 0 || c >= C) continue;  // malformed CSR: never memcpy OOB
      int64_t sc = steps_pc[c];
      if (sc <= 0) continue;
      std::memcpy(out_idx + (k * L + pos) * B, idx + c * S * B,
                  sizeof(int32_t) * sc * B);
      std::memcpy(out_mask + (k * L + pos) * B, mask + c * S * B,
                  sizeof(float) * sc * B);
      for (int64_t s = 0; s < sc; s++) {
        slot[k * L + pos + s] = (int32_t)c;
        local_step[k * L + pos + s] = (int32_t)s;
      }
      flush[k * L + pos + sc - 1] = 1.0f;
      flush_n[k * L + pos + sc - 1] = ns[c];
      flush_steps[k * L + pos + sc - 1] = (float)sc;
      pos += sc;
    }
  };
  parallel_for(K, work);
}

}  // extern "C"
