// Building blocks for hand-written Hopper (sm_90a) kernels on tensor
// cores: the warp-level bf16 MMA m16n8k16 with fp32 accumulation, its
// operand loads from shared memory (ldmatrix), 16- and 4-byte
// asynchronous copies from device memory into shared memory (cp.async,
// zero-filling rows that do not exist) with mbarriers that let a warp
// wait for just the rows it reads next, and packing fp32 accumulators
// into bf16 operands.
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

}  // namespace hopper
