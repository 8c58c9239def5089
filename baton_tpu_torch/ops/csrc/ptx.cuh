// The few PTX instructions the tensor-core flash kernels are built from
// (flash_attention_mma.cu, flash_attention_tf32.cu; flash_attention_wgmma.cu
// takes the shared-memory address and the fragment helpers, and keeps its
// Hopper instructions to itself), each behind a small device function: the
// bf16 packing and quad reductions of the fragments, 16- and 4-byte
// asynchronous copies into shared memory
// (cp.async, zero-filling when the source is out of range), ldmatrix of
// four 8 x 8 bf16 tiles (plain and transposed), the warp-wide bf16 product
// mma.sync.m16n8k16 with fp32 accumulators, and fp32 products in 3xTF32
// (the TF32 split and mma.sync.m16n8k8).
//
// Fragment layouts of mma.m16n8k16 (g = lane / 4, t = lane % 4; each
// 32-bit register holds two bf16, the lower column or k index in the low
// half):
//   A 16 x 16: a0 (row g, k 2t..2t+1), a1 (row g+8, k 2t..), a2 (row g,
//              k 2t+8..), a3 (row g+8, k 2t+8..)
//   B 16 x 8:  b0 (k 2t..2t+1, col g), b1 (k 2t+8.., col g)
//   C 16 x 8:  c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8, same cols)

#pragma once

#include <cuda_bf16.h>

#include <cstdint>

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// two floats rounded to bf16 (round to nearest even) in one register, the
// first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// max / sum over the four lanes of a quad (the lanes that share a row of an
// accumulator fragment)
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
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

// ----------------------------------------------------------------------
// fp32 products on the TF32 tensor cores in three parts (3xTF32). Each fp32
// operand x splits into big = rna(x) and small = rna(x - big), both TF32
// values (10 explicit mantissa bits) in a 32-bit register: big + small is x
// to within 2^-22 of |x|. a.b is then as.bb + ab.bs + ab.bb, each product
// exact in the tensor cores and summed in fp32 accumulators; the dropped
// as.bs is below 2^-22 of |a||b|. The tensor cores' fp32 adds do not round
// to nearest, so a long sum takes its steps in fresh fragments and adds them
// in fp32 outside (flash_attention_tf32.cu, add_to).
//
// Fragment layouts of mma.m16n8k8 with .tf32 operands (g = lane / 4,
// t = lane % 4; one value a register):
//   A 16 x 8: a0 (row g, k t), a1 (row g+8, k t), a2 (row g, k t+4),
//             a3 (row g+8, k t+4)
//   B 8 x 8:  b0 (k t, col g), b1 (k t+4, col g)
//   C 16 x 8: as m16n8k16's

// x rounded to TF32, to nearest with ties away from zero: the value of
// cvt.rna.tf32.f32 for every finite x (and for +-inf), as two integer ops
// on the bits (add half a TF32 ulp, clear the 13 low bits). ptxas expands
// cvt.rna into four instructions, one of them an inf/NaN test that only a
// NaN with nothing but low mantissa bits set would need.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = big + small, each TF32
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));
}

// c += a . b for a 16 x 8 TF32 A, an 8 x 8 TF32 B and a 16 x 8 fp32 C
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a . b in 3xTF32 from the split fragments of a (ab + as) and b (bb + bs):
// the two small cross products first, then big . big
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const uint32_t (&ab)[4],
                                           const uint32_t (&as)[4], const uint32_t (&bb)[2],
                                           const uint32_t (&bs)[2]) {
  mma_tf32(c, as, bb[0], bb[1]);
  mma_tf32(c, ab, bs[0], bs[1]);
  mma_tf32(c, ab, bb[0], bb[1]);
}
