// Flash attention's bf16 forward and dkv passes on Hopper's warpgroup
// tensor-core products (wgmma), fed by the Tensor Memory Accelerator (TMA),
// each behind a plain C entry point (bound with ctypes from
// baton_tpu_torch/ops/flash_attention.py). dq stays on flash_attention_mma.cu's
// mma.sync kernel; fp32 goes to flash_attention_tf32.cu.
//
// Replaces two Pallas TPU kernels of baton_tpu/ops/flash_attention.py:
//   fwd_wgmma_kernel <- _fwd_kernel      (:65-131, launched by _fwd :151-189)
//   dkv_wgmma_kernel <- _bwd_dkv_kernel  (:203-250, pass 1 of _bwd_call :325-342)
//
// Layout and semantics are flash_attention_mma.cu's: q [B, Hq, Lq, D], k/v
// [B, Hkv, Lk, D] contiguous bf16 (16-byte aligned), bias [B, Lk] fp32
// (additive, per key), lse/delta [B, Hq, Lq] fp32, query head h reads kv head
// h / (Hq / Hkv), D is 64 or 128, any L. fp32 scores, softmax statistics and
// accumulators, the finite NEG_INF = -1e30 for causally masked scores, p
// rounded to bf16 before p.v and p^T.do, ds before ds^T.q, db the column sum
// of the unrounded ds. Causal skipping is decided per 64 queries by 64 keys,
// as in the mma and tf32x3 kernels, though the tiles here are larger: a
// 64-key half of a key tile that lies wholly in the future of a warpgroup's
// 64 query rows counts for nothing (p = 0, out of the max), while masked keys
// of a half that is kept score NEG_INF. So a causal row whose visible keys
// are all masked averages over the same keys in every bf16 and fp32 kernel.
//
// What bounds them on the H100: operations, on the shapes that turn
// compute-bound: Llama-3-8B's attention (B 8, 32/8 heads, L 1,024, D 128,
// causal) does 68.9 GFLOP in the forward and 137.7 in dkv, 0.070 and 0.139 ms
// at 989 TFLOP/s bf16; example 06's ring block (B 1, 8/4 heads, L 4,096,
// D 64) 34.4 and 68.7 GFLOP, 0.035 and 0.069 ms. The mma.sync kernels reach
// 17-19% of that: a warp's 16-row mma.sync products re-read their operands
// from shared memory through ldmatrix, and their loads are issued by the
// same warps that compute. At BERT-base's shape (L 128, D 64) the forward is
// bound by bytes (203 MB, 0.061 ms at 3.35 TB/s).
//
// The design (warp-specialised, as FlashAttention-3 on Hopper):
// - three warpgroups a block: one thread of the producer warpgroup issues
//   every TMA copy; two consumer warpgroups do the products and the
//   softmax. setmaxnreg moves registers from the producer (24 a thread) to
//   the consumers (240), one block an SM. The two roles' code never joins
//   (not even in a shared trap block), or ptxas holds the consumers to the
//   entry's register count and serializes the wgmma;
// - tiles land in shared memory by TMA in 128-byte swizzled panels of 64
//   columns (two panels a row at D 128), the layout wgmma reads without
//   bank conflicts; rows past L are zero-filled by the copy (the tensor maps
//   are [B*H, L, D], so a box past L never reads the next head). The fp32
//   vectors (the forward's bias, dkv's lse and delta) come by TMA too, in
//   boxes of the flat vector that start at the 16-byte boundary at or before
//   the tile's first entry (TMA reads only 16-byte aligned boxes; at a
//   ragged L the rows do not start on one), with the stage's tiles;
// - every product is wgmma (m64nNk16, bf16 in, fp32 accumulators in
//   registers): q.k^T (forward), k.q^T and v.do^T (dkv) with both operands
//   K-major in shared memory; p.v (forward), p^T.do and ds^T.q (dkv) with p
//   (ds) rounded to bf16 in registers as the A operand (a wgmma accumulator
//   holds exactly the A fragments of the next product) and v, do, q as
//   MN-major B operands (the transposed read is wgmma's, no copy);
// - a ring of mbarrier-guarded stages in shared memory: the producer waits
//   for a stage to be released, arms its "full" barrier with the bytes to
//   come and issues the copies; consumers wait for "full", compute, and one
//   thread of each warpgroup arrives on "empty";
// - the two consumer warpgroups issue their products in turn (a ping-pong
//   on two named barriers), so one's softmax runs while the other's products
//   occupy the tensor cores;
// - persistent (chosen over one block a work item): the grid is one block
//   an SM, each block walks a strided list of work items, so the producer
//   loads the next items' tiles while the consumers finish this one (at
//   BERT's shape an item is one kv tile; one block an item would run each
//   block's loads, products and stores one after another, and there is room
//   for one block an SM). Causal items go heaviest first.
// - forward: an item is (b, h, 128 query rows), each consumer warpgroup
//   owning 64 rows; q is loaded once an item (three buffers at D 64, two at
//   D 128), k (with its bias) and v stream in 128-key tiles (3 stages at
//   D 64, 2 at D 128) behind separate barriers. A warpgroup issues q.k^T of
//   tile n with p.v of tile n - 1 and runs tile n's online softmax (on the
//   fp32 accumulator, each row held by four lanes) while p.v runs; p.v of an
//   item's last tile goes with the next item's first q.k^T.
// - dkv: an item is (b, q head, 128 keys), each consumer warpgroup owning
//   64 keys whose dk and dv accumulate in its registers; k and v are loaded
//   once an item (two buffers), q and do (with lse and delta) stream in
//   64-query tiles. The products are transposed (s^T = k.q^T,
//   dp^T = v.do^T) so a warpgroup's accumulators are its own keys' rows;
//   p^T and ds^T then feed dv += p^T.do and dk += ds^T.q straight from the
//   registers. FlashAttention-3 writes P and dS to shared memory because its
//   kernel also computes dq, whose rows are queries; dq is a pass of its own
//   here, so nothing goes through shared memory.
//
// Tensor maps are encoded on the host for every launch and passed by value
// as __grid_constant__ parameters (cuTensorMapEncodeTiled lives in libcuda;
// the runtime's entry-point lookup reaches it, so nothing beyond the CUDA
// runtime is linked). Under CUDA graph capture (run_rounds_fused)
// the descriptors are captured by value with the launch: that is correct
// only because a graph's buffers are static, the same addresses on every
// replay. Encoding reads no device state and allocates nothing, so a launch
// may be captured. A failed encode returns an error; there is no fallback.
//
// Each entry point returns cudaGetLastError() after its launch.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "dispatch.cuh"
#include "ptx.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int NT = 384;            // three warpgroups: producer, two consumers
constexpr int PRODUCER_REGS = 24;  // setmaxnreg budgets: 128 x 24 + 256 x 240
constexpr int CONSUMER_REGS = 240; // <= 65,536 registers of an SM
constexpr int PANEL_COLS = 64;     // bf16 columns of a 128-byte swizzled panel
constexpr int FWD_ROWS = 128;      // forward: query rows an item (64 a consumer)
constexpr int FWD_KEYS = 128;      // forward: keys a k/v tile
constexpr int DKV_KEYS = 128;      // dkv: keys an item (64 a consumer)
constexpr int DKV_ROWS = 64;       // dkv: queries a q/do tile
constexpr float NEG_INF = -1e30f;

// ----------------------------------------------------------------------
// mbarriers (shared-memory barriers that count arrivals and TMA bytes)

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// one arrival that also arms the barrier for `bytes` of TMA copies
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// wait until the phase of parity `parity` has completed: the k-th completion
// (k = 1, 2, ...) of a barrier is waited for with parity (k - 1) & 1. No
// timeout: a trap here would be one block shared by the producer's and the
// consumers' code, and ptxas then holds the consumers to the producer's
// register count (spills, serialized wgmma; measured on the H100)
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

// a box of a rank-3 tensor map at (c0, c1, c2), innermost first, into shared
// memory; completion is reported to `bar` in bytes
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// a box of a rank-1 tensor map (an fp32 vector) at element c0
__device__ __forceinline__ void tma_load_1d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0)
      : "memory");
}

// ----------------------------------------------------------------------
// wgmma: descriptors, ordering, the products

// a shared-memory matrix descriptor for the 128-byte swizzled layout that
// TMA writes: `addr` the first row's address (a 1,024-byte aligned panel,
// plus 32 bytes a k16 step along a K-major row), SBO 1,024 bytes between
// groups of 8 rows, LBO (MN-major only) the bytes between 64-column panels
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo_bytes) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo_bytes >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed wgmma groups of this warpgroup are pending
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// ping-pong between the two consumer warpgroups (named barriers 1 and 2, 256
// threads each): warpgroup c issues its products only on its turn, then
// passes the turn, so one warpgroup's softmax runs while the other's
// products occupy the tensor cores. Each warpgroup takes as many turns as
// it passes, and warpgroup 0 takes one more (warpgroup 1's first pass).
__device__ __forceinline__ void turn_take(int c) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(1 + c) : "memory");
}
__device__ __forceinline__ void turn_pass(int c) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(1 + c) : "memory");
}

// registers an in-flight wgmma reads or writes stay untouched by the
// compiler until this point (after the wait)
template <int N>
__device__ __forceinline__ void hold(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void hold(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

template <int R>
__device__ __forceinline__ void regs_down() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void regs_up() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// the A fragments of k16 step kk from a wgmma accumulator (n8 blocks 2kk and
// 2kk+1 of each row pair), rounded to bf16
template <int N>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&d)[N], int kk) {
  a[0] = pack_bf16(d[8 * kk + 0], d[8 * kk + 1]);
  a[1] = pack_bf16(d[8 * kk + 2], d[8 * kk + 3]);
  a[2] = pack_bf16(d[8 * kk + 4], d[8 * kk + 5]);
  a[3] = pack_bf16(d[8 * kk + 6], d[8 * kk + 7]);
}

// d = A.B (accumulate 0) or d += A.B, m64n64k16: A and B K-major from
// shared memory, through their descriptors
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d = A.B (accumulate 0) or d += A.B, m64n128k16: A and B K-major from
// shared memory, through their descriptors
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a, uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d += A.B, m64n64k16: A from registers (an accumulator of the previous
// product rounded to bf16, acc_to_a), B MN-major from shared memory
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d += A.B, m64n128k16: A from registers (an accumulator of the previous
// product rounded to bf16, acc_to_a), B MN-major from shared memory
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// ----------------------------------------------------------------------
// forward: out = softmax(q.k^T * scale + bias [, causal]) . v, lse

template <int D>
struct FwdShape {
  static constexpr int BM = FWD_ROWS;
  static constexpr int BN = FWD_KEYS;
  static constexpr int NP = D / PANEL_COLS;      // 128-byte panels a row
  static constexpr int PANEL = BM * 128;         // bytes of a 128-row panel
  static constexpr int TILE = NP * PANEL;        // bytes of a q, k or v tile
  static constexpr int STAGES = D == 64 ? 3 : 2;  // k/v ring (4 or 5 measured no faster)
  // q buffers: at D 64 three, so the producer runs two items ahead where an
  // item is one kv tile (BERT's shape; measured faster than two)
  static constexpr int QBUF = D == 64 ? 3 : 2;
  static constexpr int Q0 = 0;
  static constexpr int K0 = QBUF * TILE;
  static constexpr int V0 = K0 + STAGES * TILE;
  // the k tile's bias: a box of VEC values from 16-byte aligned start a stage
  static constexpr int VEC = BN + 4;
  static constexpr int VEC_STRIDE = 640;  // bytes a stage, >= 4 * VEC, a multiple of 128
  static constexpr int BIAS0 = V0 + STAGES * TILE;
  static constexpr int BAR = BIAS0 + STAGES * VEC_STRIDE;
  // barriers: q_full[QBUF] q_empty[QBUF] k_full[S] v_full[S] kv_empty[S]; + alignment slack
  static constexpr int BYTES = BAR + 8 * (2 * QBUF + 3 * STAGES) + 1024;
};

// work item -> (bh, first query row, kv tiles); the last query tiles
// (causal: the most kv tiles) first
struct FwdItem {
  int bh, bhk, b, q0, n_kv;
};

__device__ __forceinline__ FwdItem fwd_item(int item, int BH, int Hq, int Hkv, int nq, int Lk,
                                            int causal) {
  FwdItem it;
  it.bh = item % BH;
  it.q0 = (nq - 1 - item / BH) * FWD_ROWS;
  const int h = it.bh % Hq;
  it.b = it.bh / Hq;
  it.bhk = it.b * Hkv + h / (Hq / Hkv);
  const int k_end = causal ? min(Lk, it.q0 + FWD_ROWS) : Lk;
  it.n_kv = (k_end + FWD_KEYS - 1) / FWD_KEYS;
  return it;
}

// out rows row0 and row0 + 8 of head bh (those below Lq), normalised by one
// reciprocal a row, and their lse; each quad writes 16 bytes of a row
template <int D>
__device__ __forceinline__ void fwd_epilogue(const float (&o)[D / 2], const float (&m)[2],
                                             const float (&l)[2], bf16* out, float* lse, int bh,
                                             int row0, int Lq, int t4) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= Lq) continue;
    const float ll = fmaxf(l[r], 1e-30f), inv = 1.f / ll;
    bf16* orow = out + ((size_t)bh * Lq + row) * D;
#pragma unroll
    for (int jb = 0; jb < D / 8; ++jb)
      *reinterpret_cast<uint32_t*>(orow + 8 * jb + 2 * t4) =
          pack_bf16(o[4 * jb + 2 * r] * inv, o[4 * jb + 2 * r + 1] * inv);
    if (t4 == 0) lse[(size_t)bh * Lq + row] = m[r] + logf(ll);
  }
}

template <int D>
__global__ void __launch_bounds__(NT, 1)
fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tb,
                 bf16* __restrict__ out, float* __restrict__ lse, int Hq, int Hkv, int Lq, int Lk,
                 int nq, int n_items, int causal, float scale) {
  using S = FwdShape<D>;
  constexpr int ON = D / 2;  // accumulator registers of a 64 x D product
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const unsigned char* gbase = smem_raw + (base - smem_addr(smem_raw));  // generic address of base
  const uint32_t bar = base + S::BAR;
  auto q_full = [&](int i) { return bar + 8 * i; };
  auto q_empty = [&](int i) { return bar + 8 * (S::QBUF + i); };
  auto k_full = [&](int s) { return bar + 8 * (2 * S::QBUF + s); };
  auto v_full = [&](int s) { return bar + 8 * (2 * S::QBUF + S::STAGES + s); };
  auto kv_empty = [&](int s) { return bar + 8 * (2 * S::QBUF + 2 * S::STAGES + s); };
  const int BH = n_items / nq;  // B * Hq

  if (threadIdx.x == 0) {
    for (int i = 0; i < S::QBUF; ++i) {
      mbar_init(q_full(i), 1);
      mbar_init(q_empty(i), 2);
    }
    for (int s = 0; s < S::STAGES; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(kv_empty(s), 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---------------- producer: one thread issues every copy
    regs_down<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      int n = 0;  // kv tiles issued
      int j = 0;  // items
      for (int item = blockIdx.x; item < n_items; item += gridDim.x, ++j) {
        const FwdItem it = fwd_item(item, BH, Hq, Hkv, nq, Lk, causal);
        const int qb = j % S::QBUF;
        if (j >= S::QBUF) mbar_wait(q_empty(qb), (j / S::QBUF - 1) & 1);
        mbar_expect_tx(q_full(qb), S::TILE);
#pragma unroll
        for (int p = 0; p < S::NP; ++p)
          tma_load(base + S::Q0 + qb * S::TILE + p * S::PANEL, &tq, q_full(qb), p * PANEL_COLS,
                   it.q0, it.bh);
        for (int t = 0; t < it.n_kv; ++t, ++n) {
          const int s = n % S::STAGES;
          if (n >= S::STAGES) mbar_wait(kv_empty(s), ((n / S::STAGES) - 1) & 1);
          // k with its keys' bias: a box of the flat [B * Lk] bias from the
          // 16-byte boundary at or before the tile's first key (TMA reads
          // 16-byte aligned boxes only); keys past Lk read the next row or
          // zeros, and are masked
          mbar_expect_tx(k_full(s), S::TILE + 4 * S::VEC);
#pragma unroll
          for (int p = 0; p < S::NP; ++p)
            tma_load(base + S::K0 + s * S::TILE + p * S::PANEL, &tk, k_full(s), p * PANEL_COLS,
                     t * S::BN, it.bhk);
          tma_load_1d(base + S::BIAS0 + s * S::VEC_STRIDE, &tb, k_full(s),
                      (it.b * Lk + t * S::BN) & ~3);
          mbar_expect_tx(v_full(s), S::TILE);
#pragma unroll
          for (int p = 0; p < S::NP; ++p)
            tma_load(base + S::V0 + s * S::TILE + p * S::PANEL, &tv, v_full(s), p * PANEL_COLS,
                     t * S::BN, it.bhk);
        }
      }
    }
  } else {
    // ---------------- consumers: warpgroup c owns query rows 64c..64c+63
    //
    // One stream of kv tiles across the block's items. On its turn (the
    // ping-pong below) a warpgroup issues q.k^T of tile n and p.v of tile
    // n - 1 together; the softmax of tile n then runs while p.v of n - 1
    // (and the other warpgroup's products) occupy the tensor cores. p.v of
    // an item's last tile is issued with the next item's first q.k^T, so
    // at BERT's shape (one kv tile an item) items overlap too.
    regs_up<CONSUMER_REGS>();
    const int c = wg - 1;
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t4 = lane % 4;
    if (c == 1) turn_pass(0);  // warpgroup 0 takes the first turn
    float o[ON], m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < ON; ++i) o[i] = 0.f;
    // bf16(p) of the tile whose p.v is still to issue, and that tile's
    // stage. Before the first tile it is p = 0 against the first tile's v
    // (o += 0): p.v is then issued unconditionally, which keeps the
    // compiler from copying o while the product is in flight (a copy there
    // would serialize every wgmma)
    uint32_t pa[8][4];
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) pa[kk][0] = pa[kk][1] = pa[kk][2] = pa[kk][3] = 0u;
    int pend_s = 0;
    uint32_t pend_ph = 0;
    bool first = true;
    FwdItem done_it{};  // the item whose o is in the accumulators
    int done_qb = 0;
    int n = 0, j = 0;
    for (int item = blockIdx.x; item < n_items; item += gridDim.x, ++j) {
      const FwdItem it = fwd_item(item, BH, Hq, Hkv, nq, Lk, causal);
      const int qw0 = it.q0 + 64 * c;  // the warpgroup's first row
      const int row[2] = {qw0 + 16 * warp + g, qw0 + 16 * warp + g + 8};
      const int qb = j % S::QBUF;
      // the warpgroup's 64 rows of q: row 64c of each panel
      const uint32_t qa = base + S::Q0 + qb * S::TILE + c * 64 * 128;
      mbar_wait(q_full(qb), (j / S::QBUF) & 1);

      for (int t = 0; t < it.n_kv; ++t, ++n) {
        const int s = n % S::STAGES;
        const uint32_t ph = (n / S::STAGES) & 1;
        const uint32_t ka = base + S::K0 + s * S::TILE;
        const int k0 = t * S::BN;

        // s = q.k^T (64 rows x 128 keys, D / 16 k16 steps), then o += bf16(p).v
        // of the pending tile (v's rows are the contraction: MN-major B)
        float sc[64];
        mbar_wait(k_full(s), ph);
        mbar_wait(v_full(pend_s), pend_ph);
        turn_take(c);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t off = (kk / 4) * S::PANEL + (kk % 4) * 32;
          wgmma_ss(sc, desc_sw128(qa + off, 16), desc_sw128(ka + off, 16), kk > 0);
        }
        wg_commit();
        const uint32_t va = base + S::V0 + pend_s * S::TILE;
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) wgmma_rs(o, pa[kk], desc_sw128(va + kk * 2048, S::PANEL));
        wg_commit();
        turn_pass(1 - c);
        // this tile's bias, landed with k: bs[i] is key k0 + i
        const float* bs = reinterpret_cast<const float*>(gbase + S::BIAS0 + s * S::VEC_STRIDE) +
                          ((it.b * Lk + k0) & 3);
        wg_wait<1>();  // q.k^T done; p.v may still run
        hold(sc);

        // scale, bias and masks; element e of n8 block jb is row row[e / 2],
        // key k0 + 8 jb + 2 t4 + e % 2. Keys past Lk and keys of a 64-key
        // half wholly in the future of the warpgroup's rows get -inf (p = 0,
        // out of the max); causally masked keys of a kept half NEG_INF. Only
        // edge tiles (ragged, or on the causal diagonal) test each key.
        float mx[2] = {NEG_INF, NEG_INF};
        if (k0 + S::BN > Lk || (causal && k0 + S::BN - 1 > qw0)) {
#pragma unroll
          for (int i = 0; i < 64; ++i) {
            const int jb = i / 4, e = i % 4;
            const int kj = k0 + 8 * jb + 2 * t4 + (e & 1);
            float x = fmaf(sc[i], scale, bs[8 * jb + 2 * t4 + (e & 1)]);
            if (causal) {
              const bool past_half = k0 + (jb >= 8 ? 64 : 0) > qw0 + 63;
              x = past_half ? -INFINITY : (row[e >> 1] < kj ? NEG_INF : x);
            }
            x = kj < Lk ? x : -INFINITY;
            sc[i] = x;
            mx[e >> 1] = fmaxf(mx[e >> 1], x);
          }
        } else {
#pragma unroll
          for (int i = 0; i < 64; ++i) {
            const float x = fmaf(sc[i], scale, bs[8 * (i / 4) + 2 * t4 + (i & 1)]);
            sc[i] = x;
            mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
          }
        }
        // online softmax on the accumulator (__expf: one ex2.approx, as the
        // mma kernels; l sums the unrounded p). An item's first tile starts
        // from m = NEG_INF, l = 0; the previous item's m and l stay for its
        // epilogue.
        float m_old[2] = {m[0], m[1]}, l_old[2] = {l[0], l[1]};
        if (t == 0) m_old[0] = m_old[1] = NEG_INF, l_old[0] = l_old[1] = 0.f;
        float alpha[2], rs[2] = {0.f, 0.f}, m_new[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          m_new[r] = fmaxf(m_old[r], quad_max(mx[r]));
          alpha[r] = __expf(m_old[r] - m_new[r]);
        }
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          const float p = __expf(sc[i] - m_new[(i >> 1) & 1]);
          rs[(i >> 1) & 1] += p;
          sc[i] = p;
        }

        wg_wait<0>();  // p.v of the pending tile has landed in o
        hold(o);
        hold(pa);
        if (tid == 0 && !first) mbar_arrive(kv_empty(pend_s));
        first = false;
        if (t == 0 && j > 0) {  // o holds the previous item's finished rows
          fwd_epilogue<D>(o, m, l, out, lse, done_it.bh, done_it.q0 + 64 * c + 16 * warp + g,
                          Lq, t4);
          if (tid == 0) mbar_arrive(q_empty(done_qb));
        }
        // a new item starts o at 0 (o is finite: a product of finite p and v)
        const float keep[2] = {t == 0 ? 0.f : alpha[0], t == 0 ? 0.f : alpha[1]};
#pragma unroll
        for (int i = 0; i < ON; ++i) o[i] *= keep[(i >> 1) & 1];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          l[r] = l_old[r] * alpha[r] + quad_sum(rs[r]);
          m[r] = m_new[r];
        }
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) acc_to_a(pa[kk], sc, kk);
        pend_s = s;
        pend_ph = ph;
      }
      done_it = it;
      done_qb = qb;
    }
    // p.v of the last tile, and the last item's epilogue
    mbar_wait(v_full(pend_s), pend_ph);
    turn_take(c);
    wg_fence();
    const uint32_t va = base + S::V0 + pend_s * S::TILE;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) wgmma_rs(o, pa[kk], desc_sw128(va + kk * 2048, S::PANEL));
    wg_commit();
    turn_pass(1 - c);
    wg_wait<0>();
    hold(o);
    hold(pa);
    if (tid == 0) {
      mbar_arrive(kv_empty(pend_s));
      mbar_arrive(q_empty(done_qb));
    }
    fwd_epilogue<D>(o, m, l, out, lse, done_it.bh, done_it.q0 + 64 * c + 16 * warp + g, Lq, t4);
    if (c == 0) turn_take(0);  // warpgroup 1's last hand-over
  }
}

// ----------------------------------------------------------------------
// backward pass 1: dk_h, dv_h [B, Hq, Lk, D] and db_h [B, Hq, Lk], fp32

template <int D>
struct DkvShape {
  static constexpr int BN = DKV_KEYS;
  static constexpr int BM = DKV_ROWS;
  static constexpr int NP = D / PANEL_COLS;
  static constexpr int KPANEL = BN * 128;         // bytes of a 128-row panel
  static constexpr int KTILE = NP * KPANEL;       // a k or v tile
  static constexpr int QPANEL = BM * 128;         // bytes of a 64-row panel
  static constexpr int QTILE = NP * QPANEL;       // a q or do tile
  static constexpr int STAGES = D == 64 ? 3 : 2;  // q/do ring
  static constexpr int KV0 = 0;                   // two (k, v) buffers
  static constexpr int Q0 = 4 * KTILE;            // stage s: q, then do
  // the q tile's lse and delta: boxes of VEC values from a 16-byte aligned
  // start, delta DELTA bytes after lse, VEC_STRIDE bytes a stage
  static constexpr int VEC = BM + 4;
  static constexpr int DELTA = 384;
  static constexpr int VEC_STRIDE = 768;
  static constexpr int LD0 = Q0 + STAGES * 2 * QTILE;
  static constexpr int BAR = LD0 + STAGES * VEC_STRIDE;  // kv_full[2] kv_empty[2] full[S] empty[S]
  static constexpr int BYTES = BAR + 8 * (4 + 2 * STAGES) + 1024;
};

// work item -> (bh, first key, first query tile, query tiles); the first
// key tiles (causal: the most query tiles) first
struct DkvItem {
  int bh, bhk, b, k0, qt0, n_q;
};

__device__ __forceinline__ DkvItem dkv_item(int item, int BH, int Hq, int Hkv, int Lq,
                                            int causal) {
  DkvItem it;
  it.bh = item % BH;
  it.k0 = (item / BH) * DKV_KEYS;
  const int h = it.bh % Hq;
  it.b = it.bh / Hq;
  it.bhk = it.b * Hkv + h / (Hq / Hkv);
  // causal: 64-query tiles that end before the item's first key see none of its keys
  it.qt0 = causal ? it.k0 / DKV_ROWS : 0;
  it.n_q = max(0, (Lq + DKV_ROWS - 1) / DKV_ROWS - it.qt0);
  return it;
}

template <int D>
__global__ void __launch_bounds__(NT, 1)
dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                 const __grid_constant__ CUtensorMap tl, const __grid_constant__ CUtensorMap td,
                 const float* __restrict__ bias, float* __restrict__ dk, float* __restrict__ dv,
                 float* __restrict__ db, int Hq, int Hkv, int Lq, int Lk, int BH, int n_items,
                 int causal, float scale) {
  using S = DkvShape<D>;
  constexpr int ON = D / 2;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const unsigned char* gbase = smem_raw + (base - smem_addr(smem_raw));
  const uint32_t bar = base + S::BAR;
  auto kv_full = [&](int i) { return bar + 8 * i; };
  auto kv_empty = [&](int i) { return bar + 8 * (2 + i); };
  auto full = [&](int s) { return bar + 8 * (4 + s); };
  auto empty = [&](int s) { return bar + 8 * (4 + S::STAGES + s); };

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(kv_full(i), 1);
      mbar_init(kv_empty(i), 2);
    }
    for (int s = 0; s < S::STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---------------- producer: one thread issues every copy
    regs_down<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      int n = 0, j = 0;
      for (int item = blockIdx.x; item < n_items; item += gridDim.x, ++j) {
        const DkvItem it = dkv_item(item, BH, Hq, Hkv, Lq, causal);
        const int kb = j & 1;
        if (j >= 2) mbar_wait(kv_empty(kb), ((j >> 1) - 1) & 1);
        mbar_expect_tx(kv_full(kb), 2 * S::KTILE);
        const uint32_t kva = base + S::KV0 + kb * 2 * S::KTILE;
#pragma unroll
        for (int p = 0; p < S::NP; ++p) {
          tma_load(kva + p * S::KPANEL, &tk, kv_full(kb), p * PANEL_COLS, it.k0, it.bhk);
          tma_load(kva + S::KTILE + p * S::KPANEL, &tv, kv_full(kb), p * PANEL_COLS, it.k0,
                   it.bhk);
        }
        for (int i = 0; i < it.n_q; ++i, ++n) {
          const int s = n % S::STAGES;
          if (n >= S::STAGES) mbar_wait(empty(s), ((n / S::STAGES) - 1) & 1);
          // q and do with their queries' lse and delta: boxes of the flat
          // [B * Hq * Lq] vectors from the 16-byte boundary at or before the
          // tile's first query; queries past Lq read the next head or zeros,
          // and are masked
          mbar_expect_tx(full(s), 2 * S::QTILE + 8 * S::VEC);
          const uint32_t qa = base + S::Q0 + s * 2 * S::QTILE;
          const int qs0 = (it.qt0 + i) * S::BM;
#pragma unroll
          for (int p = 0; p < S::NP; ++p) {
            tma_load(qa + p * S::QPANEL, &tq, full(s), p * PANEL_COLS, qs0, it.bh);
            tma_load(qa + S::QTILE + p * S::QPANEL, &tdo, full(s), p * PANEL_COLS, qs0, it.bh);
          }
          const uint32_t la = base + S::LD0 + s * S::VEC_STRIDE;
          tma_load_1d(la, &tl, full(s), (it.bh * Lq + qs0) & ~3);
          tma_load_1d(la + S::DELTA, &td, full(s), (it.bh * Lq + qs0) & ~3);
        }
      }
    }
  } else {
    // ---------------- consumers: warpgroup c owns keys 64c..64c+63 of the item
    regs_up<CONSUMER_REGS>();
    const int c = wg - 1;
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t4 = lane % 4;
    if (c == 1) turn_pass(0);  // warpgroup 0 takes the first turn
    int n = 0, j = 0;
    for (int item = blockIdx.x; item < n_items; item += gridDim.x, ++j) {
      const DkvItem it = dkv_item(item, BH, Hq, Hkv, Lq, causal);
      const int kw0 = it.k0 + 64 * c;  // the warpgroup's first key
      const int krow[2] = {kw0 + 16 * warp + g, kw0 + 16 * warp + g + 8};
      const float kbias[2] = {krow[0] < Lk ? bias[(size_t)it.b * Lk + krow[0]] : 0.f,
                              krow[1] < Lk ? bias[(size_t)it.b * Lk + krow[1]] : 0.f};
      const int kb = j & 1;
      // the warpgroup's 64 rows of k and v: row 64c of each panel
      const uint32_t ka = base + S::KV0 + kb * 2 * S::KTILE + c * 64 * 128;
      const uint32_t va = ka + S::KTILE;

      float dka[ON], dva[ON];
#pragma unroll
      for (int i = 0; i < ON; ++i) dka[i] = dva[i] = 0.f;
      float dba[2] = {0.f, 0.f};
      mbar_wait(kv_full(kb), (j >> 1) & 1);

      for (int u = 0; u < it.n_q; ++u, ++n) {
        const int s = n % S::STAGES;
        const int qs0 = (it.qt0 + u) * S::BM;
        mbar_wait(full(s), (n / S::STAGES) & 1);
        if (causal && qs0 < kw0) {  // wholly before the warpgroup's keys: its turns pass
          turn_take(c);
          turn_pass(1 - c);
          turn_take(c);
          turn_pass(1 - c);
          if (tid == 0) mbar_arrive(empty(s));
          continue;
        }
        const uint32_t qa = base + S::Q0 + s * 2 * S::QTILE;
        const uint32_t oa = qa + S::QTILE;

        // s^T = k.q^T and dp^T = v.do^T: 64 keys x 64 queries each
        float st[32], dpt[32];
        turn_take(c);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t koff = (kk / 4) * S::KPANEL + (kk % 4) * 32;
          const uint32_t qoff = (kk / 4) * S::QPANEL + (kk % 4) * 32;
          wgmma_ss(st, desc_sw128(ka + koff, 16), desc_sw128(qa + qoff, 16), kk > 0);
        }
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t koff = (kk / 4) * S::KPANEL + (kk % 4) * 32;
          const uint32_t qoff = (kk / 4) * S::QPANEL + (kk % 4) * 32;
          wgmma_ss(dpt, desc_sw128(va + koff, 16), desc_sw128(oa + qoff, 16), kk > 0);
        }
        wg_commit();
        turn_pass(1 - c);
        // the tile's lse and delta, landed with q: ls[i] and dls[i] are
        // query qs0 + i's
        const float* ls = reinterpret_cast<const float*>(gbase + S::LD0 + s * S::VEC_STRIDE) +
                          ((it.bh * Lq + qs0) & 3);
        const float* dls = ls + S::DELTA / 4;
        const bool q_edge = qs0 + S::BM > Lq;
        wg_wait<0>();
        hold(st);
        hold(dpt);

        // p^T and ds^T; element e of n8 block jb is key krow[e / 2], query
        // qs0 + 8 jb + 2 t4 + e % 2. Padded queries and keys get p = ds = 0;
        // only edge tiles (ragged, or on the causal diagonal) test each one.
        if (q_edge || it.k0 + S::BN > Lk || (causal && kw0 + 63 > qs0)) {
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            const int jb = i / 4, e = i % 4, r = e >> 1;
            const int qi = qs0 + 8 * jb + 2 * t4 + (e & 1);
            const int qv = 8 * jb + 2 * t4 + (e & 1);
            float x = fmaf(st[i], scale, kbias[r]);
            x = causal && qi < krow[r] ? NEG_INF : x;
            const float p = qi < Lq && krow[r] < Lk ? __expf(x - ls[qv]) : 0.f;
            const float ds = p * (dpt[i] - dls[qv]);
            dba[r] += ds;  // db sums the unrounded ds
            st[i] = p;
            dpt[i] = ds;
          }
        } else {
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            const int r = (i >> 1) & 1;
            const int qv = 8 * (i / 4) + 2 * t4 + (i & 1);
            const float p = __expf(fmaf(st[i], scale, kbias[r]) - ls[qv]);
            const float ds = p * (dpt[i] - dls[qv]);
            dba[r] += ds;
            st[i] = p;
            dpt[i] = ds;
          }
        }
        uint32_t pa[4][4], sa[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          acc_to_a(pa[kk], st, kk);
          acc_to_a(sa[kk], dpt, kk);
        }

        // dv += bf16(p^T).do, dk += bf16(ds^T).q: do's and q's rows are the
        // contraction (MN-major B), 16 queries a step
        turn_take(c);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs(dva, pa[kk], desc_sw128(oa + kk * 16 * 128, S::QPANEL));
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs(dka, sa[kk], desc_sw128(qa + kk * 16 * 128, S::QPANEL));
        wg_commit();
        turn_pass(1 - c);
        wg_wait<0>();
        hold(dva);
        hold(dka);
        hold(pa);
        hold(sa);
        if (tid == 0) mbar_arrive(empty(s));
      }
      if (tid == 0) mbar_arrive(kv_empty(kb));

      // each quad holds 32 contiguous bytes of a row: whole sectors
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float dbr = quad_sum(dba[r]);
        if (krow[r] >= Lk) continue;
        float* dkrow = dk + ((size_t)it.bh * Lk + krow[r]) * D;
        float* dvrow = dv + ((size_t)it.bh * Lk + krow[r]) * D;
#pragma unroll
        for (int jb = 0; jb < D / 8; ++jb) {
          *reinterpret_cast<float2*>(dkrow + 8 * jb + 2 * t4) =
              make_float2(scale * dka[4 * jb + 2 * r], scale * dka[4 * jb + 2 * r + 1]);
          *reinterpret_cast<float2*>(dvrow + 8 * jb + 2 * t4) =
              make_float2(dva[4 * jb + 2 * r], dva[4 * jb + 2 * r + 1]);
        }
        if (t4 == 0) db[(size_t)it.bh * Lk + krow[r]] = dbr;
      }
    }
    if (c == 0) turn_take(0);  // warpgroup 1's last hand-over
  }
}

// ----------------------------------------------------------------------
// host: tensor maps and launchers

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled through the runtime (no -lcuda), or null
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                            &found);
#endif
    if (e != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a rank-3 map over a contiguous bf16 [BH, L, D] tensor whose boxes are
// `rows` rows of one 64-column panel, 128-byte swizzled; a box past L is
// zero-filled (the map's L is the tensor's, so it never reads the next head)
cudaError_t rows_map(CUtensorMap* map, const void* ptr, int D, int L, int BH, int rows) {
  EncodeTiled encode = encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)L, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)D * sizeof(bf16), (cuuint64_t)L * D * sizeof(bf16)};
  const cuuint32_t box[3] = {(cuuint32_t)PANEL_COLS, (cuuint32_t)rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
                            strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// a rank-1 map over a contiguous fp32 vector of n values, boxes of `box`
// values; a box past n is zero-filled
cudaError_t vec_map(CUtensorMap* map, const void* ptr, long long n, int box) {
  EncodeTiled encode = encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[1] = {(cuuint64_t)n};
  const cuuint64_t strides[1] = {(cuuint64_t)n * sizeof(float)};  // unused at rank 1
  const cuuint32_t boxes[1] = {(cuuint32_t)box};
  const cuuint32_t unit[1] = {1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, const_cast<void*>(ptr), dims,
                            strides, boxes, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// one block an SM (the blocks are persistent), at most one a work item
int grid_size(int n_items) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return n_items < sms ? n_items : sms;
}

template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, int n_items, size_t smem_bytes, void* stream, Args... args) {
  if (n_items == 0) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem_bytes);
  if (e != cudaSuccess) return e;
  kernel<<<grid_size(n_items), NT, smem_bytes, (cudaStream_t)stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// out [B,Hq,Lq,D] bf16, lse [B,Hq,Lq] fp32
int flash_fwd_wgmma(int d, const void* q, const void* k, const void* v, const void* bias,
                    void* out, void* lse, int B, int Hq, int Hkv, int Lq, int Lk, int causal,
                    float scale, void* stream) {
  return dispatch_head_dim(d, [&](auto dim) {
    constexpr int D = decltype(dim)::value;
    using S = FwdShape<D>;
    CUtensorMap tq, tk, tv, tb;
    cudaError_t e = rows_map(&tq, q, D, Lq, B * Hq, S::BM);
    if (e == cudaSuccess) e = rows_map(&tk, k, D, Lk, B * Hkv, S::BN);
    if (e == cudaSuccess) e = rows_map(&tv, v, D, Lk, B * Hkv, S::BN);
    if (e == cudaSuccess) e = vec_map(&tb, bias, (long long)B * Lk, S::VEC);
    if (e != cudaSuccess) return e;
    const int nq = (Lq + S::BM - 1) / S::BM;
    const int n_items = B * Hq * nq;
    return launch(fwd_wgmma_kernel<D>, n_items, S::BYTES, stream, tq, tk, tv, tb, (bf16*)out,
                  (float*)lse, Hq, Hkv, Lq, Lk, nq, n_items, causal, scale);
  });
}

// dk, dv [B,Hq,Lk,D] fp32 and db [B,Hq,Lk] fp32, per query head
int flash_bwd_dkv_wgmma(int d, const void* q, const void* k, const void* v, const void* bias,
                        const void* dout, const void* lse, const void* delta, void* dk, void* dv,
                        void* db, int B, int Hq, int Hkv, int Lq, int Lk, int causal, float scale,
                        void* stream) {
  return dispatch_head_dim(d, [&](auto dim) {
    constexpr int D = decltype(dim)::value;
    using S = DkvShape<D>;
    CUtensorMap tq, tk, tv, tdo, tl, td;
    cudaError_t e = rows_map(&tq, q, D, Lq, B * Hq, S::BM);
    if (e == cudaSuccess) e = rows_map(&tdo, dout, D, Lq, B * Hq, S::BM);
    if (e == cudaSuccess) e = rows_map(&tk, k, D, Lk, B * Hkv, S::BN);
    if (e == cudaSuccess) e = rows_map(&tv, v, D, Lk, B * Hkv, S::BN);
    if (e == cudaSuccess) e = vec_map(&tl, lse, (long long)B * Hq * Lq, S::VEC);
    if (e == cudaSuccess) e = vec_map(&td, delta, (long long)B * Hq * Lq, S::VEC);
    if (e != cudaSuccess) return e;
    const int n_items = B * Hq * ((Lk + S::BN - 1) / S::BN);
    return launch(dkv_wgmma_kernel<D>, n_items, S::BYTES, stream, tq, tk, tv, tdo, tl, td,
                  (const float*)bias, (float*)dk, (float*)dv, (float*)db, Hq, Hkv, Lq, Lk,
                  B * Hq, n_items, causal, scale);
  });
}

}  // extern "C"
