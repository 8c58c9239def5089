// Flash attention's bf16 dq pass on Hopper's tensor cores (mma.sync), behind
// a plain C entry point (bound with ctypes from
// baton_tpu_torch/ops/flash_attention.py). The bf16 forward and dkv passes
// are flash_attention_wgmma.cu's; fp32 calls go to the 3xTF32 kernels of
// flash_attention_tf32.cu (one TF32 product alone would lose fp32's accuracy).
//
// Replaces the Pallas TPU kernel of baton_tpu/ops/flash_attention.py:
//   dq_mma_kernel   <- _bwd_dq_kernel   (:253-290, pass 2 of _bwd_call :344-358)
// This file also held fwd_mma_kernel and dkv_mma_kernel; fwd_wgmma_kernel
// and dkv_wgmma_kernel replaced them, faster at every shape timed (PERF.md).
//
// Layout and semantics (the same in flash_attention_wgmma.cu and
// flash_attention_tf32.cu): q [B, Hq, Lq, D], k/v [B, Hkv, Lk, D] contiguous
// bf16, bias [B, Lk] fp32 (additive, per key), lse/delta [B, Hq, Lq] fp32,
// query head h reads kv head h / (Hq / Hkv), D is 64 or 128, any L (rows past
// L are zero-filled by the copies and masked in the fragments, so no pad
// copies are made). The tiles are 64 queries by 64 keys, and causal tile
// skipping, with it the one edge where a causal row whose visible keys are
// all masked averages over the kv tiles that are not skipped, is decided per
// 64 x 64 in every design.
//
// What bounds it on the H100: at BERT-base's shape (L = 128, D = 64) dq does
// ~64 FLOPs per byte it must move, below the card's ~295 bf16 FLOPs per byte,
// so it is bound by device memory (305 MB: 91 us at 3.35 TB/s); at Llama's
// and the ring block's shapes by operations. The design:
// - tiles stay bf16 in shared memory, filled by cp.async (16 bytes a
//   thread); the kv tiles are double buffered, so tile j+1 is in flight
//   while tile j computes;
// - rows are padded by 16 bytes, so ldmatrix's eight row addresses fall in
//   eight different bank groups (no conflicts);
// - every product is mma.sync.m16n8k16 (bf16 in, fp32 accumulate) with
//   fragments from ldmatrix (ldmatrix.trans where the tile's rows are the
//   contraction), two ldmatrix.x4 per four mma;
// - a warp owns 16 rows: the p/ds recompute works on the accumulator
//   fragments in registers, with row reductions over the four lanes of a
//   quad (two __shfl_xor steps);
// - ds is rounded to bf16 and repacked in registers as the A fragment of the
//   next product (an accumulator's n8 blocks 2j and 2j+1 are exactly the A
//   fragment of k16 step j), with no shared-memory trip.
// mma.sync rather than wgmma: this pass is the next to move to the design of
// flash_attention_wgmma.cu (wgmma fed by TMA, a producer warpgroup and two
// consumer warpgroups), which replaced the forward and dkv here where the
// long sequences turn them compute-bound; until then dq keeps this one.
//
// Measured on an H100 80GB HBM3 at 700 W (chip_smoke.py phase 5; PERF.md):
// dq ~0.15 ms at BERT-base's shape, ~59% of its bytes bound. Registers cap
// occupancy: __launch_bounds__ holds it at D = 64 to 128 registers (4 blocks
// of 4 warps per SM); D = 128 runs 2 blocks per SM.
//
// Numerics: scores, softmax statistics and every accumulator in fp32; ds is
// rounded to bf16 before ds.k; masked scores are the finite -1e30. The fp32
// p differs from the plain version's by a few ulps (the score is one fmaf,
// __expf is one ex2.approx, the tensor cores sum in their own order). Where
// ds lies that close to a bf16 rounding boundary it rounds to the other
// neighbour, and dq moves by one bf16 step of ds times k (chip_smoke.py
// phase 2 bounds every such gap by those steps).
// The entry point returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "dispatch.cuh"
#include "ptx.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int TILE = 64;            // query rows and key rows per tile
constexpr int NT = 128;             // four warps, 16 tile rows each
constexpr int PAD = 8;              // bf16 padding per shared-memory row (16 bytes)
constexpr float NEG_INF = -1e30f;

// rows [row0, row0 + TILE) of a row-major [L, D] bf16 matrix into a shared
// tile of row stride D + PAD, 16 bytes a copy; rows past L are zero-filled
template <int D>
__device__ __forceinline__ void copy_tile(bf16* dst, const bf16* src, int row0, int L) {
  constexpr int CH = D / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < TILE * CH; i += NT) {
    const int r = i / CH, c = (i % CH) * 8;
    const bool ok = row0 + r < L;
    cp_async_16(smem_addr(dst + r * (D + PAD) + c), ok ? src + (size_t)(row0 + r) * D + c : src,
                ok);
  }
}

// entries [row0, row0 + TILE) of a length-L fp32 vector, zero past L (4 bytes
// a copy: rows of bias, lse and delta need not be 16-byte aligned)
__device__ __forceinline__ void copy_vec(float* dst, const float* src, int row0, int L) {
  if (threadIdx.x < TILE) {
    const bool ok = row0 + threadIdx.x < L;
    cp_async_4(smem_addr(dst + threadIdx.x), ok ? src + row0 + threadIdx.x : src, ok);
  }
}

// A fragment: rows r0..r0+15, columns c0..c0+15 of a shared tile
template <int D>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile, int r0, int c0) {
  const int lane = threadIdx.x & 31;
  const int r = r0 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int c = c0 + (lane >> 4) * 8;
  ldmatrix_x4(a, smem_addr(tile + r * (D + PAD) + c));
}

// B fragments of two n8 blocks (n0 and n0 + 8) for the k16 step at k0, where
// B[k][n] = tile[n][k]: the tile's rows are B's columns (k^T in q.k^T)
template <int D>
__device__ __forceinline__ void load_b(uint32_t (&b)[4], const bf16* tile, int n0, int k0) {
  const int lane = threadIdx.x & 31;
  const int r = n0 + (lane & 7) + (lane >> 4) * 8;
  const int c = k0 + ((lane >> 3) & 1) * 8;
  ldmatrix_x4(b, smem_addr(tile + r * (D + PAD) + c));
}

// the same where B[k][n] = tile[k][n]: the tile's rows are the contraction
// (v in p.v), read with ldmatrix.trans
template <int D>
__device__ __forceinline__ void load_b_trans(uint32_t (&b)[4], const bf16* tile, int k0, int n0) {
  const int lane = threadIdx.x & 31;
  const int r = k0 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int c = n0 + (lane >> 4) * 8;
  ldmatrix_x4_trans(b, smem_addr(tile + r * (D + PAD) + c));
}

// the A fragment of k16 step j from an accumulator's n8 blocks 2j and 2j+1,
// rounded to bf16
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&lo)[4],
                                         const float (&hi)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// ----------------------------------------------------------------------
// backward pass 2: dq [B, Hq, Lq, D], fp32
//
// One block per (b, h, 64-query tile); warp w owns query
// rows 16w..16w+15, so its accumulator holds its own rows of dq (no atomics,
// dq is deterministic). The q and do tiles are read once and their A
// fragments kept in registers, at D = 128 too: there the block's 105 KB of
// shared memory allow 2 blocks per SM anyway, and 255 registers a thread
// hold the 64 accumulators and 64 fragment registers. Each thread keeps lse
// and delta of its two rows in registers. The kv tiles and their bias are
// double-buffered. Per kv tile, 32 keys at a time: s = q.k^T and dp = do.v^T
// (k's and v's rows are B's columns), p = exp(s * scale + bias - lse),
// ds = p * (dp - delta), then dq += bf16(ds).k with ds straight from the
// registers and k's B fragments from ldmatrix.trans (k's rows are the
// contraction there).

template <int D>
__global__ void __launch_bounds__(NT, D == 64 ? 4 : 2)
dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const float* __restrict__ bias,
              const bf16* __restrict__ dout, const float* __restrict__ lse,
              const float* __restrict__ delta, float* __restrict__ dq, int Hq, int Hkv,
              int Lq, int Lk, int nq, int causal, float scale) {
  constexpr int S = D + PAD;
  constexpr int KS = D / 16;
  constexpr int ON = D / 8;
  constexpr int KC = 32;  // keys per inner step
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);             // [TILE][S]
  bf16* Os = Qs + TILE * S;                                 // [TILE][S] do
  bf16* Ks = Os + TILE * S;                                 // [2][TILE][S]
  bf16* Vs = Ks + 2 * TILE * S;                             // [2][TILE][S]
  float* Bs = reinterpret_cast<float*>(Vs + 2 * TILE * S);  // [2][TILE] bias of the kv tile

  const int tile = blockIdx.x % nq;
  const int bh = blockIdx.x / nq;
  const int h = bh % Hq, b = bh / Hq;
  const int hk = h / (Hq / Hkv);
  const int q0 = tile * TILE;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16;
  const int qrow[2] = {q0 + r0 + g, q0 + r0 + g + 8};
  float lr[2], dr[2];  // lse and delta of the thread's two rows
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool ok = qrow[r] < Lq;
    lr[r] = ok ? lse[(size_t)bh * Lq + qrow[r]] : 0.f;
    dr[r] = ok ? delta[(size_t)bh * Lq + qrow[r]] : 0.f;
  }
  const bf16* kb = k + (size_t)(b * Hkv + hk) * Lk * D;
  const bf16* vb = v + (size_t)(b * Hkv + hk) * Lk * D;
  const float* bb = bias + (size_t)b * Lk;

  // causal: kv tiles wholly in the future of every query of this tile add nothing
  const int k_end = causal ? min(Lk, q0 + TILE) : Lk;
  const int n_kv = (k_end + TILE - 1) / TILE;

  copy_tile<D>(Qs, q + (size_t)bh * Lq * D, q0, Lq);
  copy_tile<D>(Os, dout + (size_t)bh * Lq * D, q0, Lq);
  copy_tile<D>(Ks, kb, 0, Lk);
  copy_tile<D>(Vs, vb, 0, Lk);
  copy_vec(Bs, bb, 0, Lk);
  cp_async_commit();

  uint32_t qf[KS][4], of[KS][4];
  float acc[ON][4];
#pragma unroll
  for (int n = 0; n < ON; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int it = 0; it < n_kv; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_kv) {  // the next kv tile loads while this one computes
      const int k1 = (it + 1) * TILE;
      copy_tile<D>(Ks + (buf ^ 1) * TILE * S, kb, k1, Lk);
      copy_tile<D>(Vs + (buf ^ 1) * TILE * S, vb, k1, Lk);
      copy_vec(Bs + (buf ^ 1) * TILE, bb, k1, Lk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        load_a<D>(qf[kk], Qs, r0, kk * 16);
        load_a<D>(of[kk], Os, r0, kk * 16);
      }
    }
    const bf16* Kt = Ks + buf * TILE * S;
    const bf16* Vt = Vs + buf * TILE * S;
    const float* bt = Bs + buf * TILE;
    const int k0 = it * TILE;

#pragma unroll
    for (int c0 = 0; c0 < TILE; c0 += KC) {
      // s = q.k^T and dp = do.v^T: the warp's 16 rows x KC keys
      float s[KC / 8][4], dp[KC / 8][4];
#pragma unroll
      for (int j = 0; j < KC / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
        for (int nn = 0; nn < KC / 16; ++nn) {
          uint32_t kf[4], vf[4];
          load_b<D>(kf, Kt, c0 + nn * 16, kk * 16);
          mma_bf16(s[2 * nn], qf[kk], kf[0], kf[1]);
          mma_bf16(s[2 * nn + 1], qf[kk], kf[2], kf[3]);
          load_b<D>(vf, Vt, c0 + nn * 16, kk * 16);
          mma_bf16(dp[2 * nn], of[kk], vf[0], vf[1]);
          mma_bf16(dp[2 * nn + 1], of[kk], vf[2], vf[3]);
        }
      }

      // p and ds, ds overwriting s; element e of block j is row qrow[e / 2],
      // key k0 + c0 + 8j + 2t + e % 2. Keys past Lk (zero-filled, so s = 0
      // there) get p = ds = 0, causally masked ones the finite NEG_INF; only
      // edge chunks (ragged, or on the causal diagonal of the warp's rows)
      // test each key. Rows past Lq are computed and never stored.
      const bool edge = k0 + c0 + KC > Lk || (causal && k0 + c0 + KC - 1 > q0 + r0);
#pragma unroll
      for (int j = 0; j < KC / 8; ++j) {
        const float2 bj = *reinterpret_cast<const float2*>(bt + c0 + j * 8 + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = fmaf(s[j][e], scale, (e & 1) ? bj.y : bj.x);
          float p;
          if (edge) {
            const int kj = k0 + c0 + j * 8 + 2 * t + (e & 1);
            if (causal && qrow[e >> 1] < kj) x = NEG_INF;
            p = kj < Lk ? __expf(x - lr[e >> 1]) : 0.f;
          } else {
            p = __expf(x - lr[e >> 1]);
          }
          s[j][e] = p * (dp[j][e] - dr[e >> 1]);
        }
      }

      // dq += bf16(ds).k: contract the KC keys
#pragma unroll
      for (int kk = 0; kk < KC / 16; ++kk) {
        uint32_t sa[4];
        acc_to_a(sa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
        for (int nn = 0; nn < ON / 2; ++nn) {
          uint32_t kf[4];
          load_b_trans<D>(kf, Kt, c0 + kk * 16, nn * 16);
          mma_bf16(acc[2 * nn], sa, kf[0], kf[1]);
          mma_bf16(acc[2 * nn + 1], sa, kf[2], kf[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }

  // each quad holds 32 contiguous bytes of a row: whole sectors, no staging
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qrow[r] >= Lq) continue;
    float* row = dq + ((size_t)bh * Lq + qrow[r]) * D;
#pragma unroll
    for (int n = 0; n < ON; ++n)
      *reinterpret_cast<float2*>(row + n * 8 + 2 * t) =
          make_float2(scale * acc[n][2 * r], scale * acc[n][2 * r + 1]);
  }
}

// ----------------------------------------------------------------------
// launchers

template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, int blocks, size_t smem_bytes, void* stream, Args... args) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem_bytes);
  if (e != cudaSuccess) return e;
  kernel<<<blocks, NT, smem_bytes, (cudaStream_t)stream>>>(args...);
  return cudaGetLastError();
}

template <int D> constexpr size_t tile_bytes() { return (size_t)TILE * (D + PAD) * sizeof(bf16); }

}  // namespace

extern "C" {

// dq [B,Hq,Lq,D] fp32
int flash_bwd_dq_mma(int d, const void* q, const void* k, const void* v, const void* bias,
                     const void* dout, const void* lse, const void* delta, void* dq, int B,
                     int Hq, int Hkv, int Lq, int Lk, int causal, float scale, void* stream) {
  return dispatch_head_dim(d, [&](auto dim) {
    constexpr int D = decltype(dim)::value;
    const int nq = (Lq + TILE - 1) / TILE;
    return launch(dq_mma_kernel<D>, B * Hq * nq, 6 * tile_bytes<D>() + 2 * TILE * sizeof(float),
                  stream, (const bf16*)q, (const bf16*)k, (const bf16*)v, (const float*)bias,
                  (const bf16*)dout, (const float*)lse, (const float*)delta, (float*)dq, Hq, Hkv,
                  Lq, Lk, nq, causal, scale);
  });
}

}  // extern "C"
