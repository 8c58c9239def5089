// Flash attention on Hopper's tensor cores, bf16: the forward pass and
// both passes of the backward, each behind a plain C entry point (bound
// with ctypes from baton_tpu_torch/ops/flash_attention.py). Every bf16 call
// comes here; fp32 calls go to the 3xTF32 kernels of flash_attention_tf32.cu
// (one TF32 product alone would lose fp32's accuracy).
//
// Replaces the three Pallas TPU kernels of baton_tpu/ops/flash_attention.py:
//   fwd_mma_kernel  <- _fwd_kernel      (:65-131, launched by _fwd :151-189)
//   dkv_mma_kernel  <- _bwd_dkv_kernel  (:203-250, pass 1 of _bwd_call :325-342)
//   dq_mma_kernel   <- _bwd_dq_kernel   (:253-290, pass 2 of _bwd_call :344-358)
//
// Layout and semantics (the same in flash_attention_tf32.cu): q [B, Hq, Lq, D],
// k/v [B, Hkv, Lk, D] contiguous bf16, bias [B, Lk] fp32 (additive, per key),
// lse/delta [B, Hq, Lq] fp32, query head h reads kv head h / (Hq / Hkv), D
// is 64 or 128, any L (rows past L are zero-filled by the copies and masked
// in the fragments, so no pad copies are made). The tiles are 64 queries by
// 64 keys, as in the fp32 kernels, so causal tile skipping, and with it the
// one edge where a causal row whose visible keys are all masked averages
// over the kv tiles that are not skipped, is the same.
//
// What bounds them on the H100: at BERT-base's shape (L = 128, D = 64) each
// pass does ~64 FLOPs per byte it must move, below the card's ~295 bf16
// FLOPs per byte, so they are bound by device memory (fwd 203 MB, dkv
// 408 MB, dq 305 MB: 61, 122 and 91 us at 3.35 TB/s). The SIMT kernels
// were ~10x over that, bound by the rate of shared-memory loads feeding
// scalar fp32 FMAs. This design moves the products onto the tensor cores
// and keeps shared memory traffic low:
// - tiles stay bf16 in shared memory, filled by cp.async (16 bytes a
//   thread); the kv tiles (fwd, dq) and the q/do tiles (dkv) are double
//   buffered, so tile j+1 is in flight while tile j computes;
// - rows are padded by 16 bytes, so ldmatrix's eight row addresses fall in
//   eight different bank groups (no conflicts);
// - every product is mma.sync.m16n8k16 (bf16 in, fp32 accumulate) with
//   fragments from ldmatrix (ldmatrix.trans where the tile's rows are the
//   contraction), two ldmatrix.x4 per four mma;
// - a warp owns 16 rows: the online softmax (fwd) and the p/ds recompute
//   (dkv, dq) work on the accumulator fragments in registers, with row
//   reductions over the four lanes of a quad (two __shfl_xor steps);
// - p (and ds) are rounded to bf16 and repacked in registers as the A
//   fragment of the next product (an accumulator's n8 blocks 2j and 2j+1
//   are exactly the A fragment of k16 step j), with no shared-memory trip.
// mma.sync rather than wgmma: at this shape fwd's 12.9 GFLOP (dq's 19.3)
// take ~43 us (~65 us) even at 300 TFLOP/s, under their bytes bounds, so
// the bytes decide; wgmma with TMA is the design for long sequences, where
// the kernels turn compute-bound.
//
// Measured on an H100 80GB HBM3 at 700 W (chip_smoke.py phase 5; PERF.md):
// fwd ~0.096 ms and dkv ~0.20 ms at BERT-base's shape, ~2.1 and ~2.0 TB/s,
// 60-63% of their bytes bounds; dq's numbers are in PERF.md. Registers cap
// occupancy: __launch_bounds__ holds fwd and dq at D = 64 to 128 registers
// (4 blocks of 4 warps per SM) and dkv to 168 (3 blocks). D = 128 runs 2
// blocks per SM.
//
// Numerics follow the SIMT kernels: scores, softmax statistics and every
// accumulator in fp32; p is rounded to bf16 before p.v and p^T.do, ds before
// ds^T.q and ds.k; db sums the unrounded ds; masked scores are the finite
// -1e30. The fp32 p differs from the plain version's by a few ulps (the
// score is one fmaf, __expf is one ex2.approx, the tensor cores sum in their
// own order). Where p or ds lies that close to a bf16 rounding boundary it
// rounds to the other neighbour, and dv (dk, dq) moves by one bf16 step of
// p (ds) times do (q, k): at BERT-base's shape up to ~5e-3 (chip_smoke.py
// phase 2 bounds every such gap by those steps).
// Each entry point returns cudaGetLastError() after its launch.

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

// two floats rounded to bf16 (round to nearest even) in one register, the
// first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// max / sum over the four lanes of a quad (the lanes that share a row of
// an accumulator fragment)
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

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
// forward: out = softmax(q.k^T * scale + bias [, causal]) . v, lse
//
// One block per (b, h, 64-query tile); warp w owns query rows 16w..16w+15.
// Q's A fragments are read once into registers; the kv tiles and their bias
// are double-buffered.

template <int D>
__global__ void __launch_bounds__(NT, D == 64 ? 4 : 2)
fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const float* __restrict__ bias,
               bf16* __restrict__ out, float* __restrict__ lse, int Hq, int Hkv, int Lq, int Lk,
               int nq, int causal, float scale) {
  constexpr int S = D + PAD;  // shared row stride
  constexpr int KS = D / 16;  // k16 steps over the head dim
  constexpr int ON = D / 8;   // n8 blocks of a row of out
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);       // [TILE][S]
  bf16* Ks = Qs + TILE * S;                           // [2][TILE][S]
  bf16* Vs = Ks + 2 * TILE * S;                       // [2][TILE][S]
  float* Bs = reinterpret_cast<float*>(Vs + 2 * TILE * S);  // [2][TILE] bias of the kv tile

  const int tile = blockIdx.x % nq;
  const int bh = blockIdx.x / nq;
  const int h = bh % Hq, b = bh / Hq;
  const int hk = h / (Hq / Hkv);
  const int q0 = tile * TILE;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16;  // the warp's rows in the tile
  const int qrow[2] = {q0 + r0 + g, q0 + r0 + g + 8};
  const bf16* kb = k + (size_t)(b * Hkv + hk) * Lk * D;
  const bf16* vb = v + (size_t)(b * Hkv + hk) * Lk * D;
  const float* bb = bias + (size_t)b * Lk;

  // causal: kv tiles wholly in the future of every query of this tile add nothing
  const int k_end = causal ? min(Lk, q0 + TILE) : Lk;
  const int n_kv = (k_end + TILE - 1) / TILE;

  copy_tile<D>(Qs, q + (size_t)bh * Lq * D, q0, Lq);
  copy_tile<D>(Ks, kb, 0, Lk);
  copy_tile<D>(Vs, vb, 0, Lk);
  copy_vec(Bs, bb, 0, Lk);
  cp_async_commit();

  uint32_t qf[KS][4];
  float o[ON][4];
#pragma unroll
  for (int n = 0; n < ON; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

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
      for (int kk = 0; kk < KS; ++kk) load_a<D>(qf[kk], Qs, r0, kk * 16);
    }
    const bf16* Kt = Ks + buf * TILE * S;
    const bf16* Vt = Vs + buf * TILE * S;
    const float* bt = Bs + buf * TILE;
    const int k0 = it * TILE;

    // s = q.k^T: the warp's 16 rows x 64 keys, eight n8 blocks
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int nn = 0; nn < 4; ++nn) {
        uint32_t kf[4];
        load_b<D>(kf, Kt, nn * 16, kk * 16);
        mma_bf16(s[2 * nn], qf[kk], kf[0], kf[1]);
        mma_bf16(s[2 * nn + 1], qf[kk], kf[2], kf[3]);
      }
    }

    // scale, bias and masks; element e of block j is row qrow[e / 2], key
    // k0 + 8j + 2t + e % 2. Keys past Lk get -inf (p = 0, and they stay out
    // of the max); causally masked ones the finite NEG_INF. Only edge tiles
    // (ragged, or on the causal diagonal of the warp's rows) test each key.
    const bool edge = k0 + TILE > Lk || (causal && k0 + TILE - 1 > q0 + r0);
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 bj = *reinterpret_cast<const float2*>(bt + j * 8 + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = fmaf(s[j][e], scale, (e & 1) ? bj.y : bj.x);
        if (edge) {
          const int kj = k0 + j * 8 + 2 * t + (e & 1);
          if (causal && qrow[e >> 1] < kj) x = NEG_INF;
          if (kj >= Lk) x = -INFINITY;
        }
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    // online softmax on the fragments (__expf: one ex2.approx, a few ulps
    // from expf; see the note at the top on what that does after rounding)
    float m_new[2], alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m_new[r] = fmaxf(m[r], quad_max(mx[r]));
      alpha[r] = __expf(m[r] - m_new[r]);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = __expf(s[j][e] - m_new[e >> 1]);
        rs[e >> 1] += p;  // l sums the unrounded p
        s[j][e] = p;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] = l[r] * alpha[r] + quad_sum(rs[r]);
      m[r] = m_new[r];
    }
#pragma unroll
    for (int n = 0; n < ON; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // o += bf16(p) . v, p straight from the registers
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t pa[4];
      acc_to_a(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int nn = 0; nn < ON / 2; ++nn) {
        uint32_t vf[4];
        load_b_trans<D>(vf, Vt, kk * 16, nn * 16);
        mma_bf16(o[2 * nn], pa, vf[0], vf[1]);
        mma_bf16(o[2 * nn + 1], pa, vf[2], vf[3]);
      }
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }

  // epilogue: normalise by one reciprocal a row (not D / 2 divisions a
  // thread), stage the warp's 16 rows in its own rows of Qs (only this warp
  // read them), then 16-byte stores of rows
  const float ll[2] = {fmaxf(l[0], 1e-30f), fmaxf(l[1], 1e-30f)};
  const float inv[2] = {1.f / ll[0], 1.f / ll[1]};
  bf16* stage = Qs + r0 * S;
#pragma unroll
  for (int n = 0; n < ON; ++n) {
    *reinterpret_cast<uint32_t*>(stage + g * S + n * 8 + 2 * t) =
        pack_bf16(o[n][0] * inv[0], o[n][1] * inv[0]);
    *reinterpret_cast<uint32_t*>(stage + (g + 8) * S + n * 8 + 2 * t) =
        pack_bf16(o[n][2] * inv[1], o[n][3] * inv[1]);
  }
  __syncwarp();
  constexpr int CH = D / 8;
  for (int i = lane; i < 16 * CH; i += 32) {
    const int r = i / CH, c = (i % CH) * 8;
    const int qi = q0 + r0 + r;
    if (qi < Lq)
      *reinterpret_cast<uint4*>(out + ((size_t)bh * Lq + qi) * D + c) =
          *reinterpret_cast<const uint4*>(stage + r * S + c);
  }
  if (t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (qrow[r] < Lq) lse[(size_t)bh * Lq + qrow[r]] = m[r] + logf(ll[r]);
  }
}

// ----------------------------------------------------------------------
// backward pass 1: dk_h, dv_h [B, Hq, Lk, D] and db_h [B, Hq, Lk], fp32
//
// One block per (b, h, 64-key tile); warp w owns key rows 16w..16w+15 and
// works on transposed products, so its accumulators are its own rows:
// s^T = k.q^T and dp^T = v.do^T (32 queries at a time), p^T = exp(s^T *
// scale + bias - lse) with the bias constant along a key row, ds^T = p^T *
// (dp^T - delta), then dv += bf16(p^T).do and dk += bf16(ds^T).q with the
// A operands straight from the registers. K and V are read once; q, do,
// lse and delta tiles are double-buffered. At D = 64 the A fragments of k
// and v stay in registers; at D = 128 the dk/dv accumulators alone take 128
// registers a thread, so k's and v's fragments are read from shared memory
// at each use.

template <int D>
__global__ void __launch_bounds__(NT, D == 64 ? 3 : 2)
dkv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const float* __restrict__ bias,
               const bf16* __restrict__ dout, const float* __restrict__ lse,
               const float* __restrict__ delta, float* __restrict__ dk,
               float* __restrict__ dv, float* __restrict__ db, int Hq, int Hkv, int Lq,
               int Lk, int nk, int causal, float scale) {
  constexpr int S = D + PAD;
  constexpr int KS = D / 16;
  constexpr int ON = D / 8;
  constexpr int QC = 32;                 // queries per inner step
  constexpr bool KV_IN_REGS = D == 64;
  constexpr int KR = KV_IN_REGS ? KS : 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // [TILE][S]
  bf16* Vs = Ks + TILE * S;                      // [TILE][S]
  bf16* Qs = Vs + TILE * S;                      // [2][TILE][S]
  bf16* Os = Qs + 2 * TILE * S;                  // [2][TILE][S] do
  float* Ls = reinterpret_cast<float*>(Os + 2 * TILE * S);  // [2][TILE] lse
  float* Ds = Ls + 2 * TILE;                                 // [2][TILE] delta

  const int tile = blockIdx.x % nk;
  const int bh = blockIdx.x / nk;
  const int h = bh % Hq, b = bh / Hq;
  const int hk = h / (Hq / Hkv);
  const int k0 = tile * TILE;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16;
  const int krow[2] = {k0 + r0 + g, k0 + r0 + g + 8};
  const float kbias[2] = {krow[0] < Lk ? bias[(size_t)b * Lk + krow[0]] : 0.f,
                          krow[1] < Lk ? bias[(size_t)b * Lk + krow[1]] : 0.f};
  const bf16* qb = q + (size_t)bh * Lq * D;
  const bf16* ob = dout + (size_t)bh * Lq * D;
  const float* lb = lse + (size_t)bh * Lq;
  const float* deb = delta + (size_t)bh * Lq;

  // causal: query tiles that end before this key tile see none of its keys
  const int qt0 = causal ? tile : 0;
  const int n_q = (Lq + TILE - 1) / TILE - qt0;

  copy_tile<D>(Ks, k + (size_t)(b * Hkv + hk) * Lk * D, k0, Lk);
  copy_tile<D>(Vs, v + (size_t)(b * Hkv + hk) * Lk * D, k0, Lk);
  if (n_q > 0) {
    const int qs0 = qt0 * TILE;
    copy_tile<D>(Qs, qb, qs0, Lq);
    copy_tile<D>(Os, ob, qs0, Lq);
    copy_vec(Ls, lb, qs0, Lq);
    copy_vec(Ds, deb, qs0, Lq);
  }
  cp_async_commit();

  uint32_t kf[KR][4], vf[KR][4];
  float dka[ON][4], dva[ON][4];
#pragma unroll
  for (int n = 0; n < ON; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;
  float dba[2] = {0.f, 0.f};

  for (int it = 0; it < n_q; ++it) {
    const int buf = it & 1;
    const int qs0 = (qt0 + it) * TILE;
    if (it + 1 < n_q) {  // the next query tile loads while this one computes
      const int nb = buf ^ 1, q1 = qs0 + TILE;
      copy_tile<D>(Qs + nb * TILE * S, qb, q1, Lq);
      copy_tile<D>(Os + nb * TILE * S, ob, q1, Lq);
      copy_vec(Ls + nb * TILE, lb, q1, Lq);
      copy_vec(Ds + nb * TILE, deb, q1, Lq);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if constexpr (KV_IN_REGS) {
      if (it == 0) {
#pragma unroll
        for (int kk = 0; kk < KR; ++kk) {
          load_a<D>(kf[kk], Ks, r0, kk * 16);
          load_a<D>(vf[kk], Vs, r0, kk * 16);
        }
      }
    }
    const bf16* Qt = Qs + buf * TILE * S;
    const bf16* Ot = Os + buf * TILE * S;
    const float* lt = Ls + buf * TILE;
    const float* dt = Ds + buf * TILE;

#pragma unroll
    for (int c0 = 0; c0 < TILE; c0 += QC) {
      // s^T = k.q^T and dp^T = v.do^T: 16 key rows x QC queries
      float st[QC / 8][4], dpt[QC / 8][4];
#pragma unroll
      for (int j = 0; j < QC / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t ka[4], va[4];
        if constexpr (KV_IN_REGS) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            ka[i] = kf[kk][i];
            va[i] = vf[kk][i];
          }
        } else {
          load_a<D>(ka, Ks, r0, kk * 16);
          load_a<D>(va, Vs, r0, kk * 16);
        }
#pragma unroll
        for (int nn = 0; nn < QC / 16; ++nn) {
          uint32_t qf[4], of[4];
          load_b<D>(qf, Qt, c0 + nn * 16, kk * 16);
          mma_bf16(st[2 * nn], ka, qf[0], qf[1]);
          mma_bf16(st[2 * nn + 1], ka, qf[2], qf[3]);
          load_b<D>(of, Ot, c0 + nn * 16, kk * 16);
          mma_bf16(dpt[2 * nn], va, of[0], of[1]);
          mma_bf16(dpt[2 * nn + 1], va, of[2], of[3]);
        }
      }

      // p^T and ds^T; element e of block j is key krow[e / 2], query
      // qs0 + c0 + 8j + 2t + e % 2. Padded queries and keys get p = ds = 0;
      // only edge chunks (ragged, or on the causal diagonal) test each one.
      const bool edge = qs0 + c0 + QC > Lq || k0 + TILE > Lk ||
                        (causal && k0 + r0 + 15 > qs0 + c0);
#pragma unroll
      for (int j = 0; j < QC / 8; ++j) {
        const float2 lj = *reinterpret_cast<const float2*>(lt + c0 + j * 8 + 2 * t);
        const float2 dj = *reinterpret_cast<const float2*>(dt + c0 + j * 8 + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = fmaf(st[j][e], scale, kbias[e >> 1]);
          float p;
          if (edge) {
            const int qi = qs0 + c0 + j * 8 + 2 * t + (e & 1);
            const int kj = krow[e >> 1];
            if (causal && qi < kj) x = NEG_INF;
            p = qi < Lq && kj < Lk ? __expf(x - ((e & 1) ? lj.y : lj.x)) : 0.f;
          } else {
            p = __expf(x - ((e & 1) ? lj.y : lj.x));
          }
          const float ds = p * (dpt[j][e] - ((e & 1) ? dj.y : dj.x));
          dba[e >> 1] += ds;  // db sums the unrounded ds
          st[j][e] = p;
          dpt[j][e] = ds;
        }
      }

      // dv += bf16(p^T).do, dk += bf16(ds^T).q: contract the QC queries
#pragma unroll
      for (int kk = 0; kk < QC / 16; ++kk) {
        uint32_t pa[4], sa[4];
        acc_to_a(pa, st[2 * kk], st[2 * kk + 1]);
        acc_to_a(sa, dpt[2 * kk], dpt[2 * kk + 1]);
#pragma unroll
        for (int nn = 0; nn < ON / 2; ++nn) {
          uint32_t of[4], qf[4];
          load_b_trans<D>(of, Ot, c0 + kk * 16, nn * 16);
          mma_bf16(dva[2 * nn], pa, of[0], of[1]);
          mma_bf16(dva[2 * nn + 1], pa, of[2], of[3]);
          load_b_trans<D>(qf, Qt, c0 + kk * 16, nn * 16);
          mma_bf16(dka[2 * nn], sa, qf[0], qf[1]);
          mma_bf16(dka[2 * nn + 1], sa, qf[2], qf[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }
  cp_async_wait<0>();

  // each quad holds 32 contiguous bytes of a row: whole sectors, no staging
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (krow[r] >= Lk) continue;
    float* dkrow = dk + ((size_t)bh * Lk + krow[r]) * D;
    float* dvrow = dv + ((size_t)bh * Lk + krow[r]) * D;
#pragma unroll
    for (int n = 0; n < ON; ++n) {
      *reinterpret_cast<float2*>(dkrow + n * 8 + 2 * t) =
          make_float2(scale * dka[n][2 * r], scale * dka[n][2 * r + 1]);
      *reinterpret_cast<float2*>(dvrow + n * 8 + 2 * t) =
          make_float2(dva[n][2 * r], dva[n][2 * r + 1]);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float s = quad_sum(dba[r]);
    if (t == 0 && krow[r] < Lk) db[(size_t)bh * Lk + krow[r]] = s;
  }
}

// ----------------------------------------------------------------------
// backward pass 2: dq [B, Hq, Lq, D], fp32
//
// One block per (b, h, 64-query tile), as in the forward; warp w owns query
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

// out [B,Hq,Lq,D] bf16, lse [B,Hq,Lq] fp32
int flash_fwd_mma(int d, const void* q, const void* k, const void* v, const void* bias,
                  void* out, void* lse, int B, int Hq, int Hkv, int Lq, int Lk, int causal,
                  float scale, void* stream) {
  return dispatch_head_dim(d, [&](auto dim) {
    constexpr int D = decltype(dim)::value;
    const int nq = (Lq + TILE - 1) / TILE;
    return launch(fwd_mma_kernel<D>, B * Hq * nq, 5 * tile_bytes<D>() + 2 * TILE * sizeof(float),
                  stream, (const bf16*)q, (const bf16*)k, (const bf16*)v, (const float*)bias,
                  (bf16*)out, (float*)lse, Hq, Hkv, Lq, Lk, nq, causal, scale);
  });
}

// dk, dv [B,Hq,Lk,D] fp32 and db [B,Hq,Lk] fp32, per query head
int flash_bwd_dkv_mma(int d, const void* q, const void* k, const void* v, const void* bias,
                      const void* dout, const void* lse, const void* delta, void* dk, void* dv,
                      void* db, int B, int Hq, int Hkv, int Lq, int Lk, int causal, float scale,
                      void* stream) {
  return dispatch_head_dim(d, [&](auto dim) {
    constexpr int D = decltype(dim)::value;
    const int nk = (Lk + TILE - 1) / TILE;
    return launch(dkv_mma_kernel<D>, B * Hq * nk, 6 * tile_bytes<D>() + 4 * TILE * sizeof(float),
                  stream, (const bf16*)q, (const bf16*)k, (const bf16*)v, (const float*)bias,
                  (const bf16*)dout, (const float*)lse, (const float*)delta, (float*)dk,
                  (float*)dv, (float*)db, Hq, Hkv, Lq, Lk, nk, causal, scale);
  });
}

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
