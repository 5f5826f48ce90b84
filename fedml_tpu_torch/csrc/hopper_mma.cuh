// Building blocks for hand-written Hopper (sm_90a) kernels on tensor
// cores: the warp-level bf16 MMA m16n8k16 with fp32 accumulation, its
// operand loads from shared memory (ldmatrix), 16- and 4-byte
// asynchronous copies from device memory into shared memory (cp.async,
// zero-filling rows that do not exist) with mbarriers that let a warp
// wait for just the rows it reads next, named barriers for a few warps,
// and packing fp32 accumulators into bf16 operands; for fp32 inputs, the
// tf32 MMA m16n8k8 and the split of each fp32 operand into two tf32
// parts that makes three of its products as accurate as one in fp32
// (3xTF32).
//
// Fragment layouts of mma.m16n8k16 (lane = 4 * g + t, g in 0..7, t in
// 0..3), as the PTX ISA defines them:
//   A 16x16 (row-major, four b32 of two bf16 each):
//     a0 = (row g,   cols 2t, 2t+1)    a1 = (row g+8, cols 2t, 2t+1)
//     a2 = (row g,   cols 2t+8, 2t+9)  a3 = (row g+8, cols 2t+8, 2t+9)
//   B 16x8 (k x n, two b32):  b0 = (k 2t, 2t+1; n g)  b1 = (k 2t+8, 2t+9; n g)
//   C/D 16x8 fp32:  c0, c1 = (row g, cols 2t, 2t+1)
//                   c2, c3 = (row g+8, cols 2t, 2t+1)
// So the accumulators of two n8 products side by side (columns 0-7 and
// 8-15), packed to bf16 pairs, are the A operand of the next product
// with those 16 columns as its reduction axis (`pack_a`): a result never
// has to leave registers to feed the next product.
//
// mma.m16n8k8 with tf32 operands (fp32 bit patterns; the fp32 kernels'
// 3xTF32 products) has other A and B fragments:
//   A 16x8 (four b32):  a0 = (row g, col t)    a1 = (row g+8, col t)
//                       a2 = (row g, col t+4)  a3 = (row g+8, col t+4)
//   B 8x8 (k x n, two b32):  b0 = (k t, n g)   b1 = (k t+4, n g)
//   C/D as above.
// ldmatrix moves 16-bit pairs, so on an fp32 tile each 8x8 b16 matrix
// is 8 rows of 4 floats and a lane receives (row g, col t) of it: the
// A and B fragments of an operand whose reduction axis is its rows'
// contiguous axis. The reduction axis may be permuted at will when A and
// B share the permutation: reading k t as column 2t and k t+4 as column
// 2t+1 of each 8, the accumulators of an n8 product are the A operand
// {c0, c2, c1, c3} of the next product with those 8 columns as its
// reduction axis (`split_a_tf32`), with no shuffle, and the B operand of
// that product reads rows 2t and 2t+1 of its tile.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// d += a . b: one 16x8x16 product, bf16 operands, fp32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 b16 matrices from shared memory; lanes 8i..8i+7 give the row
// addresses (16 bytes each) of matrix i, and r[i] receives lane's
// (row g, cols 2t, 2t+1) of matrix i.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(row)));
}

// The same, each matrix transposed: r[i] receives (rows 2t, 2t+1; col g)
// of matrix i as stored.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(row)));
}

// 16 bytes device -> shared without passing through registers; with
// `valid` false nothing is read and the 16 bytes are zero. Both addresses
// 16-byte aligned.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes device -> shared, zero when `valid` is false
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// Closes the group of this thread's copies issued since the last commit.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Waits until every cp.async copy this thread issued has landed.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Waits until `count` threads (whole warps) have arrived at named barrier
// `id` (1-15; 0 is __syncthreads'), and orders the shared-memory accesses
// of those threads across it as __syncthreads does for a block's.
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// An mbarrier (8 bytes of shared memory): a phase completes when `count`
// arrivals have been made, and the next phase begins.
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

// This thread's arrival at `bar` for the copies into shared memory it has
// issued so far: the phase cannot complete before its cp.async copies
// have landed (the asynchronous arrive, which adds one to the pending
// count and takes it back on landing), and its ordinary stores are
// released with the arrival itself.
__device__ __forceinline__ void mbar_arrive_copies(uint64_t* bar) {
  asm volatile(
      "cp.async.mbarrier.arrive.shared.b64 [%0];\n"
      "mbarrier.arrive.shared.b64 _, [%0];\n" ::"r"(smem_addr(bar))
      : "memory");
}

// Waits until the phase of `bar` with parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// two fp32 -> one b32 of bf16 (round to nearest even), `lo` in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The accumulators of two side-by-side 16x8 products, rounded to bf16, as
// the A operand (16x16) of the next product.
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// d += a . b: one 16x8x8 product, tf32 operands, fp32 accumulators
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x rounded to tf32 (10 mantissa bits, nearest, ties away from zero), as
// fp32 bits: half the dropped unit added to the magnitude's bits, then the
// 13 low bits cleared. This is cvt.rna.tf32.f32 for every finite x and
// for inf, in two integer instructions where ptxas lowers cvt.rna to four
// (a finite test and a select besides); only a NaN whose payload lies
// wholly in the 13 low bits turns into inf, and its lo (x - inf) is NaN,
// so a product it enters is NaN either way.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = hi + lo to about 2^-22 of x, both tf32: hi is x rounded, lo the
// rest rounded
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// The same for the four fp32 bit patterns of a fragment
__device__ __forceinline__ void split_tf32(const uint32_t (&x)[4],
                                           uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(__uint_as_float(x[i]), hi[i], lo[i]);
}

// The accumulators of an n8 product, split, as the tf32 A operand of the
// next product with those 8 columns as its reduction axis (k t -> column
// 2t, k t+4 -> column 2t+1)
__device__ __forceinline__ void split_a_tf32(const float (&c)[4],
                                             uint32_t (&hi)[4],
                                             uint32_t (&lo)[4]) {
  split_tf32(c[0], hi[0], lo[0]);
  split_tf32(c[2], hi[1], lo[1]);
  split_tf32(c[1], hi[2], lo[2]);
  split_tf32(c[3], hi[3], lo[3]);
}

// d += a . b at about fp32 accuracy (3xTF32) from the split operands: the
// small terms first, alo.bhi + ahi.blo, then ahi.bhi; alo.blo (about
// 2^-22 of a.b) is dropped
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const uint32_t (&ahi)[4],
                                           const uint32_t (&alo)[4],
                                           uint32_t bhi0, uint32_t bhi1,
                                           uint32_t blo0, uint32_t blo1) {
  mma_tf32(d, alo, bhi0, bhi1);
  mma_tf32(d, ahi, blo0, blo1);
  mma_tf32(d, ahi, bhi0, bhi1);
}

}  // namespace hopper
