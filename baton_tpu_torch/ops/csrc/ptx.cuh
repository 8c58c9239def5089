// The few PTX instructions the tensor-core flash kernels are built from
// (flash_attention_mma.cu), each behind a small device function: 16- and
// 4-byte asynchronous copies into shared memory (cp.async, zero-filling
// when the source is out of range), ldmatrix of four 8 x 8 bf16 tiles
// (plain and transposed), and the warp-wide bf16 product
// mma.sync.m16n8k16 with fp32 accumulators.
//
// Fragment layouts of mma.m16n8k16 (g = lane / 4, t = lane % 4; each
// 32-bit register holds two bf16, the lower column or k index in the low
// half):
//   A 16 x 16: a0 (row g, k 2t..2t+1), a1 (row g+8, k 2t..), a2 (row g,
//              k 2t+8..), a3 (row g+8, k 2t+8..)
//   B 16 x 8:  b0 (k 2t..2t+1, col g), b1 (k 2t+8.., col g)
//   C 16 x 8:  c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8, same cols)

#pragma once

#include <cstdint>

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from src to shared memory, or 16 zero bytes when !ok
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}

// 4 bytes from src to shared memory, or 4 zero bytes when !ok
__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups of this thread are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8 x 8 bf16 tiles; lanes 8i..8i+7 give the row addresses of tile i,
// and register i gets tile i (lane holds row lane/4, columns 2(lane%4)..+1)
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// the same, each tile transposed (lane holds column lane/4, rows 2(lane%4)..+1)
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// c += a . b for a 16 x 16 bf16 A, a 16 x 8 bf16 B and a 16 x 8 fp32 C
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
