// Shared helpers for the port's hand-written Hopper kernels.
//
// The conv kernels take NHWC bf16 activations and bf16 weights packed
// into the shared-memory image of their wgmma B slabs (K1 and K2,
// kernels/conv3x3.py:pack_conv3x3_weights); K3 takes strided (batch,
// head, sequence, head dim) bf16 views. All accumulate in fp32 on the
// tensor cores with wgmma (helpers at the end), launch on the caller's
// stream and allocate nothing. Each C entry point returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.
//
// Fragment layouts of a warp's 16 rows (PTX ISA: wgmma's A from registers
// and its accumulator, as mma.m16n8k16's), with g = lane / 4, t = lane % 4:
//   A (16 x 16, row-major): a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 8+2t..),
//                           a3 (g+8, 8+2t..)
//   D (16 x N, fp32):       d[4j..4j+1] (g, 8j+2t..8j+2t+1),
//                           d[4j+2..4j+3] (g+8, 8j+2t..8j+2t+1)
// Shared-memory rows are padded by 8 bf16 (16 bytes) so the eight row
// addresses of one ldmatrix phase fall in distinct banks.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace nesr {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float lrelu(float v) {
  return v >= 0.f ? v : 0.2f * v;
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ void zero8(bf16* dst) {
  *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- Hopper: asynchronous copies, mbarriers, wgmma ----------------------

// cp.async of BYTES (4, 8 or 16) from global to shared; the bytes past
// `src_bytes` (0 or BYTES) are zero-filled, so a SAME-padding halo or a
// channel past Cin costs no branch. 16-byte copies bypass L1 (.cg).
template <int BYTES>
__device__ __forceinline__ void cp_async_zfill(void* dst, const void* src,
                                               int src_bytes) {
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                 :: "r"(smem_u32(dst)), "l"(src), "n"(BYTES), "r"(src_bytes)
                 : "memory");
  }
}

// Orders this thread's ordinary stores to shared memory before reads by
// the async proxy (wgmma operands), and its ordinary reads before writes
// by the async proxy (bulk copies into a stage it has read).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// The helpers below take shared-memory addresses (smem_u32) as 32-bit
// integers, so a kernel computes them once and adds constant offsets.
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// Blocks until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// Announces `bytes` of copies that will complete on `bar`, and arrives.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// One bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// from global to shared memory that completes a transaction on `bar`;
// the issuing thread arrives on `bar` and announces the bytes first.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  mbar_expect_tx(bar, bytes);
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// One TMA box of a 4-d tensor map (a __grid_constant__ kernel parameter)
// at coordinates (x0, x1, x2, x3), inner first, into shared memory; the
// box's bytes complete a transaction on `bar`.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const void* map,
                                            int x0, int x1, int x2, int x3,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(x0), "r"(x1),
         "r"(x2), "r"(x3), "r"(bar) : "memory");
}

// Prefetch `bytes` (a multiple of 16, 16-byte aligned) of global memory
// into L2.
__device__ __forceinline__ void prefetch_l2(const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n"
               :: "l"(src), "r"(bytes) : "memory");
}

// ldmatrix x4 (not transposed) with this lane's own row address.
__device__ __forceinline__ void ldsm_x4_at(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr) : "memory");
}

// wgmma matrix descriptor of a K-major operand with no swizzle: the
// operand is made of 8 x 16-byte core matrices (8 rows of 8 bf16 along
// K, 128 contiguous bytes); `lbo` is the byte distance between core
// matrices next to each other along K, `sbo` along the rows (M or N).
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Waits until at most `pending` of this warpgroup's committed groups are in
// flight.
template <int pending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(pending)
               : "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma that owns it.
__device__ __forceinline__ void reg_fence(float& r) {
  asm volatile("" : "+f"(r) :: "memory");
}

__device__ __forceinline__ void reg_fence(int& r) {
  asm volatile("" : "+r"(r) :: "memory");
}

}  // namespace nesr
