// Flash attention's fp32 passes on Hopper's tensor cores in 3xTF32: the
// forward and the two passes of the backward, each behind a plain C entry
// point (bound with ctypes from baton_tpu_torch/ops/flash_attention.py).
// Every fp32 call comes here; every bf16 pass is flash_attention_mma.cu's.
//
// Replaces the three Pallas TPU kernels of baton_tpu/ops/flash_attention.py
// in fp32:
//   fwd_tf32x3_kernel <- _fwd_kernel      (:65-131, launched by _fwd :151-189)
//   dkv_tf32x3_kernel <- _bwd_dkv_kernel  (:203-250, pass 1 of _bwd_call :325-342)
//   dq_tf32x3_kernel  <- _bwd_dq_kernel   (:253-290, pass 2 of _bwd_call :344-358)
//
// Layout and semantics (the same in flash_attention_mma.cu): q [B, Hq, Lq, D],
// k/v [B, Hkv, Lk, D] contiguous fp32, bias [B, Lk] fp32 (additive, per key),
// lse/delta [B, Hq, Lq] fp32, query head h reads kv head h / (Hq / Hkv), D is
// 64 or 128, any L (rows past L are zero-filled by the copies and masked in
// the fragments). The tiles are 64 queries by 64 keys, as in the bf16
// design, so causal tile skipping is the same.
//
// What bounds them on the H100: operations. At the ring block of example 06
// (B 1, 8/4 heads, L 4,096, D 64) the forward does 34.4 GFLOP, dkv 68.7 and
// dq 51.5 GFLOP, on 8-25 MB. On the CUDA cores (67 TFLOP/s fp32) that is
// 0.51, 1.03 and 0.77 ms; the SIMT kernels these replace reached 34-39% of
// it, bound by the shared-memory loads that fed their scalar FMAs. TF32
// tensor cores run 495 TFLOP/s, but one TF32 product keeps only 11 bits of
// each operand (about 4e-4 off in these gradients, beyond the port's fp32
// tolerance of 1e-4). So every product here is 3xTF32 (csrc/ptx.cuh): each
// operand split into two TF32 parts, three mma.sync.m16n8k8 a product, fp32
// accumulators; as accurate as fp32 FMAs, at an effective 495 / 3 = 165
// TFLOP/s: 0.21 ms (forward), 0.42 ms (dkv) and 0.31 ms (dq) at that shape.
// The split is two integer ops a part (tf32_rna). What limits these kernels
// is that a block does its work for a tile one step after another (copies,
// fragment loads and splits, products, the forward's softmax), its warps
// kept in step by barriers, with two blocks an SM to overlap them (one at
// D = 128), and, for dkv, registers.
// The design:
// - tiles stay fp32 in shared memory, filled by cp.async (16 bytes a
//   thread); the kv tiles (forward, dq) and the q/do tiles (dkv) are double
//   buffered, so tile j+1 is in flight while tile j computes;
// - rows are padded by 4 floats (a stride of 4 mod 32 words), so every
//   fragment load below, a plain 32-bit shared load a value, hits 32
//   different banks;
// - a warp owns 16 rows and works on the accumulator fragments in
//   registers, as the bf16 kernels do: the forward on s = q.k^T, dkv on
//   transposed products (s^T = k.q^T, dp^T = v.do^T), so its dk and dv rows
//   are its own; dq on s = q.k^T and dp = do.v^T;
// - p (forward), p^T and ds^T (dkv), ds (dq) feed the next product straight
//   from the registers: an accumulator's n8 block holds columns 2t and 2t+1
//   of rows g and g+8, which is an A fragment of one k8 step once the step's
//   k index t is read as column 2t and t+4 as 2t+1. The B fragments of that
//   step are read in the same order (rows 2t and 2t+1 of the v, do, q or k
//   tile), which is also what makes those loads conflict-free. No P or dS
//   tile goes through shared memory;
// - at D = 64 the warp's own rows of q (forward), k and v (dkv), q and do
//   (dq) stay in registers: the forward's split once as they load (64
//   registers), the backward's raw and split at each use. In the backward
//   their tiles' shared memory then holds the small planes of the B tiles:
//   each k and v tile (dq), q and do tile (dkv) is split once as it lands,
//   big in place and small beside it, so the four warps that read each B
//   fragment load its two parts instead of splitting it again and again
//   (102.5 KB of shared memory a block, two blocks an SM). The forward
//   splits each B fragment of k and v as it loads it instead: measured
//   against split planes at the same occupancy, that was faster (the tile
//   split is a phase of its own between two barriers; the splits at load
//   interleave with the products), and its four tiles take 70 KB. Two
//   blocks an SM, as registers allow (the forward's q, s, p.v and out
//   fragments take 160 of them). At D = 128 the tiles leave no room for
//   small planes (and dkv's dk/dv accumulators alone take 128 registers a
//   thread), so the A fragments are read from shared memory and every
//   fragment is split as it is loaded; one block an SM;
// - registers bound the D = 64 dkv kernel (two blocks an SM leave 255 a
//   thread, and its k and v fragments and dk and dv accumulators take 128):
//   it forms s^T, then dp^T, then dv, then dk, one product at a time, so
//   only one operand's split fragments are live.
// mma.sync rather than wgmma: wgmma takes TF32 operands only K-major from
// shared memory, which p.v and the transposed products (p^T.do, ds^T.q,
// ds.k) are not without a copy; the forward with s and p.v as wgmma (v
// transposed as it was split) measured no faster, as the steps above stay
// in series. Times, bounds and what holds them back: PERF.md.
//
// Numerics are those of the TPU kernels in fp32: scores, softmax statistics
// and every accumulator in fp32, expf, the score one fmaf(s, scale, bias);
// the forward's l sums the unrounded p, db the unrounded ds; masked scores
// are the finite -1e30, so a fully masked row averages uniformly. The
// tensor cores' fp32 adds do not round to nearest, so the long sums (the
// forward's p.v and dq over the keys, dk and dv over the queries) take at
// most one kv tile's products (forward: eight k8 steps) or two k8 steps'
// (backward) in a fresh fragment and add it to the accumulator with an
// fp32 add, which does; only those and the short dot products over D (s,
// dp) stay in one mma chain. The summation order, the split's 2^-22 and
// those short chains are what differs from an fp32 FMA chain.
// Each entry point returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "dispatch.cuh"
#include "ptx.cuh"

namespace {

constexpr int TILE = 64;   // query rows and key rows per tile
constexpr int NT = 128;    // four warps, 16 tile rows each
constexpr int PAD = 4;     // fp32 padding per shared-memory row (16 bytes)
constexpr float NEG_INF = -1e30f;

// rows [row0, row0 + TILE) of a row-major [L, D] fp32 matrix into a shared
// tile of row stride D + PAD, 16 bytes a copy; rows past L are zero-filled
template <int D>
__device__ __forceinline__ void copy_tile(float* dst, const float* src, int row0, int L) {
  constexpr int CH = D / 4;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < TILE * CH; i += NT) {
    const int r = i / CH, c = (i % CH) * 4;
    const bool ok = row0 + r < L;
    cp_async_16(smem_addr(dst + r * (D + PAD) + c), ok ? src + (size_t)(row0 + r) * D + c : src,
                ok);
  }
}

// entries [row0, row0 + TILE) of a length-L fp32 vector, zero past L
__device__ __forceinline__ void copy_vec(float* dst, const float* src, int row0, int L) {
  if (threadIdx.x < TILE) {
    const bool ok = row0 + threadIdx.x < L;
    cp_async_4(smem_addr(dst + threadIdx.x), ok ? src + row0 + threadIdx.x : src, ok);
  }
}

// the raw fp32 A fragment of rows r0..r0+15, columns c0..c0+7 of a shared tile
template <int D>
__device__ __forceinline__ void load_a(float (&a)[4], const float* tile, int r0, int c0) {
  constexpr int S = D + PAD;
  const int lane = threadIdx.x & 31;
  const float* p = tile + (r0 + (lane >> 2)) * S + c0 + (lane & 3);
  a[0] = p[0];
  a[1] = p[8 * S];
  a[2] = p[4];
  a[3] = p[8 * S + 4];
}

__device__ __forceinline__ void split_a(const float (&x)[4], uint32_t (&big)[4],
                                        uint32_t (&small)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(x[i], big[i], small[i]);
}

// the A fragment of one k8 step from an accumulator's n8 block, split: k
// index t is the block's column 2t, t + 4 its column 2t + 1
__device__ __forceinline__ void acc_to_a(uint32_t (&big)[4], uint32_t (&small)[4],
                                         const float (&c)[4]) {
  split_tf32(c[0], big[0], small[0]);
  split_tf32(c[2], big[1], small[1]);
  split_tf32(c[1], big[2], small[2]);
  split_tf32(c[3], big[3], small[3]);
}

// c += t in fp32, rounded to nearest. The tensor cores' fp32 adds are not
// (they truncate), so a sum over thousands of k8 steps kept in one mma chain
// drifts toward zero: over example 06's 32,768 tokens in one call a norm
// scale's gradient moved by 3.8e-4 of its size. dk, dv and dq instead take
// the products of two k8 steps in a fresh fragment and add it here.
__device__ __forceinline__ void add_to(float (&c)[4], const float (&t)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] += t[e];
}

// a B tile's two parts at offset o: read from the big and small planes of
// a split tile (SPLIT), or split from the raw tile as they are loaded
template <bool SPLIT>
__device__ __forceinline__ void b_parts(uint32_t& big, uint32_t& small, const float* tile,
                                        const float* small_plane, int o) {
  if constexpr (SPLIT) {
    big = __float_as_uint(tile[o]);
    small = __float_as_uint(small_plane[o]);
  } else {
    split_tf32(tile[o], big, small);
  }
}

// the B fragment of the n8 block at n0 for the k8 step at k0, where
// B[k][n] = tile[n][k]: the tile's rows are B's columns (q^T in k.q^T)
template <int D, bool SPLIT>
__device__ __forceinline__ void load_b(uint32_t (&big)[2], uint32_t (&small)[2],
                                       const float* tile, const float* small_plane, int n0,
                                       int k0) {
  const int lane = threadIdx.x & 31;
  const int o = (n0 + (lane >> 2)) * (D + PAD) + k0 + (lane & 3);
  b_parts<SPLIT>(big[0], small[0], tile, small_plane, o);
  b_parts<SPLIT>(big[1], small[1], tile, small_plane, o + 4);
}

// the same where B[k][n] = tile[k][n] (the tile's rows are the contraction:
// do in p^T.do), in acc_to_a's k order: rows k0 + 2t and k0 + 2t + 1
template <int D, bool SPLIT>
__device__ __forceinline__ void load_b_trans(uint32_t (&big)[2], uint32_t (&small)[2],
                                             const float* tile, const float* small_plane,
                                             int k0, int n0) {
  const int lane = threadIdx.x & 31;
  const int o = (k0 + 2 * (lane & 3)) * (D + PAD) + n0 + (lane >> 2);
  b_parts<SPLIT>(big[0], small[0], tile, small_plane, o);
  b_parts<SPLIT>(big[1], small[1], tile, small_plane, o + D + PAD);
}

// a landed fp32 tile split once for every warp: big in place, small into
// small_plane (same layout), 16 bytes a thread at a time
template <int D>
__device__ __forceinline__ void split_tile(float* tile, float* small_plane) {
  constexpr int CH = D / 4;
  for (int i = threadIdx.x; i < TILE * CH; i += NT) {
    const int o = (i / CH) * (D + PAD) + (i % CH) * 4;
    const float4 x = *reinterpret_cast<const float4*>(tile + o);
    uint4 big, small;
    split_tf32(x.x, big.x, small.x);
    split_tf32(x.y, big.y, small.y);
    split_tf32(x.z, big.z, small.z);
    split_tf32(x.w, big.w, small.w);
    *reinterpret_cast<uint4*>(tile + o) = big;
    *reinterpret_cast<uint4*>(small_plane + o) = small;
  }
}

// ----------------------------------------------------------------------
// forward: out [B, Hq, Lq, D] = softmax(q.k^T * scale + bias [, causal]).v
// and the row lse [B, Hq, Lq], fp32
//
// One block per (b, h, 64-query tile); warp w owns query rows 16w..16w+15,
// and each thread keeps the softmax statistics m and l of its two rows in
// registers. The kv tiles and their bias are double-buffered. Per kv tile:
// s = q.k^T (k's rows are B's columns), x = s * scale + bias, the online
// softmax on the CUDA cores (row max and row sum over the quad), then
// acc = acc * alpha + p.v with p straight from the registers (v's rows are
// the contraction): the tile's p.v in a fresh fragment, added in fp32.

// At D = 64 the warp's q rows stay in registers for the whole key loop,
// split once as they are loaded (64 registers a thread), and every B
// fragment of k and v is split as it loads (four tiles of shared memory, q
// loaded through the second k buffer); two blocks an SM. At D = 128 q is
// read from shared memory and every fragment is split as it loads, one
// block an SM. The alternatives measured against these (PERF.md): q raw
// and split at each use (no different), and k and v split once into small
// planes as they land (as fast at the ring block, slower at BERT's shape).

// the forward's shared memory in tiles of [TILE][D + PAD] (plus the bias)
template <int D> constexpr int fwd_tiles() { return D == 64 ? 4 : 5; }

template <int D>
__global__ void __launch_bounds__(NT, D == 64 ? 2 : 1)
fwd_tf32x3_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ bias,
                  float* __restrict__ out, float* __restrict__ lse, int Hq, int Hkv, int Lq,
                  int Lk, int nq, int causal, float scale) {
  constexpr int S = D + PAD;
  constexpr int KS = D / 8;     // k8 steps of s over the head dim
  constexpr int ON = D / 8;     // n8 blocks of a row of out
  constexpr int SN = TILE / 8;  // n8 blocks of a row of s, k8 steps of p.v
  constexpr bool QREG = D == 64;  // q in registers for the key loop, split once
  constexpr int QP = QREG ? KS : 1;
  extern __shared__ __align__(16) float smem[];
  // D = 64: [K0 K1 | V0 V1 | bias], q lands in K1; D = 128: [Q | K0 K1 | V0 V1 | bias]
  float* Ks = smem + (QREG ? 0 : 1) * TILE * S;  // [2][TILE][S]
  float* Vs = Ks + 2 * TILE * S;                 // [2][TILE][S]
  float* Bs = Vs + 2 * TILE * S;                 // [2][TILE] bias of the kv tile
  float* Qs = QREG ? Ks + TILE * S : smem;       // [TILE][S]

  const int tile = blockIdx.x % nq;
  const int bh = blockIdx.x / nq;
  const int h = bh % Hq, b = bh / Hq;
  const int hk = h / (Hq / Hkv);
  const int q0 = tile * TILE;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16;
  const int qrow[2] = {q0 + r0 + g, q0 + r0 + g + 8};
  const float* kb = k + (size_t)(b * Hkv + hk) * Lk * D;
  const float* vb = v + (size_t)(b * Hkv + hk) * Lk * D;
  const float* bb = bias + (size_t)b * Lk;

  // causal: kv tiles wholly in the future of every query of this tile add nothing
  const int k_end = causal ? min(Lk, q0 + TILE) : Lk;
  const int n_kv = (k_end + TILE - 1) / TILE;

  copy_tile<D>(Qs, q + (size_t)bh * Lq * D, q0, Lq);
  copy_tile<D>(Ks, kb, 0, Lk);
  copy_tile<D>(Vs, vb, 0, Lk);
  copy_vec(Bs, bb, 0, Lk);
  cp_async_commit();

  uint32_t qbig[QP][4], qsmall[QP][4];  // the warp's q rows, split (QREG)
  if constexpr (QREG) {  // q into registers before its tile's memory is reused
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      float a[4];
      load_a<D>(a, Qs, r0, kk * 8);
      split_a(a, qbig[kk], qsmall[kk]);
    }
    __syncthreads();
  }
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
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
    const float* Kt = Ks + buf * TILE * S;
    const float* Vt = Vs + buf * TILE * S;
    const float* bt = Bs + buf * TILE;
    const int k0 = it * TILE;

    // s = q.k^T: the warp's 16 rows x 64 keys
    float s[SN][4];
#pragma unroll
    for (int j = 0; j < SN; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t ab[4], as[4];
      if constexpr (QREG) {
#pragma unroll
        for (int e = 0; e < 4; ++e) ab[e] = qbig[kk][e], as[e] = qsmall[kk][e];
      } else {
        float a[4];
        load_a<D>(a, Qs, r0, kk * 8);
        split_a(a, ab, as);
      }
#pragma unroll
      for (int nn = 0; nn < SN; ++nn) {
        uint32_t fb[2], fs[2];
        load_b<D, false>(fb, fs, Kt, nullptr, nn * 8, kk * 8);
        mma_3xtf32(s[nn], ab, as, fb, fs);
      }
    }

    // the online softmax; element e of block j is row qrow[e / 2], key
    // k0 + 8j + 2t + e % 2. Keys past Lk (zero-filled) are left out of the
    // max and get p = 0, causally masked ones the finite NEG_INF; only edge
    // tiles (ragged, or on the causal diagonal of the warp's rows) test each
    // key. Rows past Lq are computed and never stored.
    const bool edge = k0 + TILE > Lk || (causal && k0 + TILE - 1 > q0 + r0);
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < SN; ++j) {
      const float2 bj = *reinterpret_cast<const float2*>(bt + j * 8 + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = fmaf(s[j][e], scale, (e & 1) ? bj.y : bj.x);
        if (edge) {
          const int kj = k0 + j * 8 + 2 * t + (e & 1);
          if (causal && qrow[e >> 1] < kj) x = NEG_INF;
          if (kj < Lk) mx[e >> 1] = fmaxf(mx[e >> 1], x);
        } else {
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
        s[j][e] = x;
      }
    }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(mx[r]));
      alpha[r] = expf(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < SN; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = !edge || k0 + j * 8 + 2 * t + (e & 1) < Lk;
        const float p = ok ? expf(s[j][e] - m[e >> 1]) : 0.f;
        rs[e >> 1] += p;
        s[j][e] = p;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + quad_sum(rs[r]);

    // acc = acc * alpha + p.v: the tile's 64 keys (eight k8 steps) in a
    // fresh fragment for each n8 block of out, added in fp32
    float pv[ON][4];
#pragma unroll
    for (int n = 0; n < ON; ++n) pv[n][0] = pv[n][1] = pv[n][2] = pv[n][3] = 0.f;
#pragma unroll
    for (int j = 0; j < SN; ++j) {
      uint32_t pb[4], ps[4];
      acc_to_a(pb, ps, s[j]);
#pragma unroll
      for (int nn = 0; nn < ON; ++nn) {
        uint32_t fb[2], fs[2];
        load_b_trans<D, false>(fb, fs, Vt, nullptr, j * 8, nn * 8);
        mma_3xtf32(pv[nn], pb, ps, fb, fs);
      }
    }
#pragma unroll
    for (int nn = 0; nn < ON; ++nn) {
      acc[nn][0] *= alpha[0];
      acc[nn][1] *= alpha[0];
      acc[nn][2] *= alpha[1];
      acc[nn][3] *= alpha[1];
      add_to(acc[nn], pv[nn]);
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }

  // out = acc / max(l, 1e-30), lse = m + log(l): a fully masked row
  // (every x the finite NEG_INF) averages uniformly. Each quad holds 32
  // contiguous bytes of a row: whole sectors, no staging.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qrow[r] >= Lq) continue;
    const float ll = fmaxf(l[r], 1e-30f);
    float* row = out + ((size_t)bh * Lq + qrow[r]) * D;
#pragma unroll
    for (int n = 0; n < ON; ++n)
      *reinterpret_cast<float2*>(row + n * 8 + 2 * t) =
          make_float2(acc[n][2 * r] / ll, acc[n][2 * r + 1] / ll);
    if (t == 0) lse[(size_t)bh * Lq + qrow[r]] = m[r] + logf(ll);
  }
}

// ----------------------------------------------------------------------
// backward pass 1: dk_h, dv_h [B, Hq, Lk, D] and db_h [B, Hq, Lk], fp32
//
// One block per (b, h, 64-key tile); warp w owns key rows 16w..16w+15. Per
// query tile, 32 queries at a time: s^T = k.q^T and dp^T = v.do^T, p^T =
// exp(s^T * scale + bias - lse) with the bias constant along a key row,
// ds^T = p^T * (dp^T - delta), then dv += p^T.do and dk += ds^T.q with the
// A operands straight from the registers. K and V are read once; q, do,
// lse and delta tiles are double-buffered.

template <int D>
__global__ void __launch_bounds__(NT, D == 64 ? 2 : 1)
dkv_tf32x3_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ bias,
                  const float* __restrict__ dout, const float* __restrict__ lse,
                  const float* __restrict__ delta, float* __restrict__ dk,
                  float* __restrict__ dv, float* __restrict__ db, int Hq, int Hkv, int Lq,
                  int Lk, int nk, int causal, float scale) {
  constexpr int S = D + PAD;
  constexpr int KS = D / 8;              // k8 steps over the head dim
  constexpr int ON = D / 8;              // n8 blocks of a row of dk, dv
  constexpr int QC = 32;                 // queries per inner step
  // D = 64: k and v fragments in registers, q and do tiles split in shared
  // memory (their small planes where K and V were); D = 128: neither
  constexpr bool SPLIT = D == 64;
  constexpr int KR = SPLIT ? KS : 1;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;                 // [TILE][S]; SPLIT: then q's small plane
  float* Vs = Ks + TILE * S;        // [TILE][S]; SPLIT: then do's small plane
  float* Qs = Vs + TILE * S;        // [2][TILE][S] (SPLIT: raw, then q's big plane)
  float* Os = Qs + 2 * TILE * S;    // [2][TILE][S] do
  float* Ls = Os + 2 * TILE * S;    // [2][TILE] lse
  float* Ds = Ls + 2 * TILE;        // [2][TILE] delta

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
  const float* qb = q + (size_t)bh * Lq * D;
  const float* ob = dout + (size_t)bh * Lq * D;
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

  float kf[KR][4], vf[KR][4];  // raw fragments of the warp's k and v rows (SPLIT)
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
    float* Qt = Qs + buf * TILE * S;
    float* Ot = Os + buf * TILE * S;
    if constexpr (SPLIT) {
      if (it == 0) {
#pragma unroll
        for (int kk = 0; kk < KR; ++kk) {
          load_a<D>(kf[kk], Ks, r0, kk * 8);
          load_a<D>(vf[kk], Vs, r0, kk * 8);
        }
        __syncthreads();  // K and V are in registers: their tiles take the small planes
      }
      split_tile<D>(Qt, Ks);
      split_tile<D>(Ot, Vs);
      __syncthreads();
    }
    const float* lt = Ls + buf * TILE;
    const float* dt = Ds + buf * TILE;

#pragma unroll 1
    for (int c0 = 0; c0 < TILE; c0 += QC) {
      // s^T = k.q^T and dp^T = v.do^T: 16 key rows x QC queries
      float st[QC / 8][4], dpt[QC / 8][4];
#pragma unroll
      for (int j = 0; j < QC / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
      // one product after the other: only one operand's split fragments live
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t ab[4], as[4];
        if constexpr (SPLIT) {
          split_a(kf[kk], ab, as);
        } else {
          float a[4];
          load_a<D>(a, Ks, r0, kk * 8);
          split_a(a, ab, as);
        }
#pragma unroll
        for (int nn = 0; nn < QC / 8; ++nn) {
          uint32_t fb[2], fs[2];
          load_b<D, SPLIT>(fb, fs, Qt, Ks, c0 + nn * 8, kk * 8);
          mma_3xtf32(st[nn], ab, as, fb, fs);
        }
      }
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t ab[4], as[4];
        if constexpr (SPLIT) {
          split_a(vf[kk], ab, as);
        } else {
          float a[4];
          load_a<D>(a, Vs, r0, kk * 8);
          split_a(a, ab, as);
        }
#pragma unroll
        for (int nn = 0; nn < QC / 8; ++nn) {
          uint32_t fb[2], fs[2];
          load_b<D, SPLIT>(fb, fs, Ot, Vs, c0 + nn * 8, kk * 8);
          mma_3xtf32(dpt[nn], ab, as, fb, fs);
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
            p = qi < Lq && kj < Lk ? expf(x - ((e & 1) ? lj.y : lj.x)) : 0.f;
          } else {
            p = expf(x - ((e & 1) ? lj.y : lj.x));
          }
          const float ds = p * (dpt[j][e] - ((e & 1) ? dj.y : dj.x));
          dba[e >> 1] += ds;
          st[j][e] = p;
          dpt[j][e] = ds;
        }
      }

      // dv += p^T.do, dk += ds^T.q: contract the QC queries, 16 at a time
      // (two k8 steps a fresh fragment)
      // (two k8 steps a fresh fragment; dv first, then dk)
#pragma unroll
      for (int j0 = 0; j0 < QC / 8; j0 += 2) {
        uint32_t ab[2][4], as[2][4];
#pragma unroll
        for (int h = 0; h < 2; ++h) acc_to_a(ab[h], as[h], st[j0 + h]);
#pragma unroll
        for (int nn = 0; nn < ON; ++nn) {
          float t[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            uint32_t fb[2], fs[2];
            load_b_trans<D, SPLIT>(fb, fs, Ot, Vs, c0 + (j0 + h) * 8, nn * 8);
            mma_3xtf32(t, ab[h], as[h], fb, fs);
          }
          add_to(dva[nn], t);
        }
      }
#pragma unroll
      for (int j0 = 0; j0 < QC / 8; j0 += 2) {
        uint32_t ab[2][4], as[2][4];
#pragma unroll
        for (int h = 0; h < 2; ++h) acc_to_a(ab[h], as[h], dpt[j0 + h]);
#pragma unroll
        for (int nn = 0; nn < ON; ++nn) {
          float t[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            uint32_t fb[2], fs[2];
            load_b_trans<D, SPLIT>(fb, fs, Qt, Ks, c0 + (j0 + h) * 8, nn * 8);
            mma_3xtf32(t, ab[h], as[h], fb, fs);
          }
          add_to(dka[nn], t);
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
// One block per (b, h, 64-query tile); warp w owns query rows 16w..16w+15,
// so its accumulator holds its own rows of dq (no atomics, dq is
// deterministic). Each thread keeps lse and delta of its two rows in
// registers; the kv tiles and their bias are double-buffered. Per kv tile,
// 32 keys at a time: s = q.k^T and dp = do.v^T (k's and v's rows are B's
// columns), p = exp(s * scale + bias - lse), ds = p * (dp - delta), then
// dq += ds.k with ds straight from the registers (k's rows are the
// contraction there).

template <int D>
__global__ void __launch_bounds__(NT, D == 64 ? 2 : 1)
dq_tf32x3_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ bias,
                 const float* __restrict__ dout, const float* __restrict__ lse,
                 const float* __restrict__ delta, float* __restrict__ dq, int Hq, int Hkv,
                 int Lq, int Lk, int nq, int causal, float scale) {
  constexpr int S = D + PAD;
  constexpr int KS = D / 8;
  constexpr int ON = D / 8;
  constexpr int KC = 32;  // keys per inner step
  // D = 64: q and do fragments in registers, k and v tiles split in shared
  // memory (their small planes where Q and dO were); D = 128: neither
  constexpr bool SPLIT = D == 64;
  constexpr int QR = SPLIT ? KS : 1;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                 // [TILE][S]; SPLIT: then k's small plane
  float* Os = Qs + TILE * S;        // [TILE][S] do; SPLIT: then v's small plane
  float* Ks = Os + TILE * S;        // [2][TILE][S] (SPLIT: raw, then k's big plane)
  float* Vs = Ks + 2 * TILE * S;    // [2][TILE][S]
  float* Bs = Vs + 2 * TILE * S;    // [2][TILE] bias of the kv tile

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
  const float* kb = k + (size_t)(b * Hkv + hk) * Lk * D;
  const float* vb = v + (size_t)(b * Hkv + hk) * Lk * D;
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

  float qf[QR][4], of[QR][4];  // raw fragments of the warp's q and do rows (SPLIT)
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
    float* Kt = Ks + buf * TILE * S;
    float* Vt = Vs + buf * TILE * S;
    if constexpr (SPLIT) {
      if (it == 0) {
#pragma unroll
        for (int kk = 0; kk < QR; ++kk) {
          load_a<D>(qf[kk], Qs, r0, kk * 8);
          load_a<D>(of[kk], Os, r0, kk * 8);
        }
        __syncthreads();  // q and do are in registers: their tiles take the small planes
      }
      split_tile<D>(Kt, Qs);
      split_tile<D>(Vt, Os);
      __syncthreads();
    }
    const float* bt = Bs + buf * TILE;
    const int k0 = it * TILE;

#pragma unroll 1
    for (int c0 = 0; c0 < TILE; c0 += KC) {
      // s = q.k^T and dp = do.v^T: the warp's 16 rows x KC keys
      float s[KC / 8][4], dp[KC / 8][4];
#pragma unroll
      for (int j = 0; j < KC / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t qb[4], qs[4], ob[4], os[4];
        if constexpr (SPLIT) {
          split_a(qf[kk], qb, qs);
          split_a(of[kk], ob, os);
        } else {
          float qa[4], oa[4];
          load_a<D>(qa, Qs, r0, kk * 8);
          load_a<D>(oa, Os, r0, kk * 8);
          split_a(qa, qb, qs);
          split_a(oa, ob, os);
        }
#pragma unroll
        for (int nn = 0; nn < KC / 8; ++nn) {
          uint32_t fb[2], fs[2];
          load_b<D, SPLIT>(fb, fs, Kt, Qs, c0 + nn * 8, kk * 8);
          mma_3xtf32(s[nn], qb, qs, fb, fs);
          load_b<D, SPLIT>(fb, fs, Vt, Os, c0 + nn * 8, kk * 8);
          mma_3xtf32(dp[nn], ob, os, fb, fs);
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
            p = kj < Lk ? expf(x - lr[e >> 1]) : 0.f;
          } else {
            p = expf(x - lr[e >> 1]);
          }
          s[j][e] = p * (dp[j][e] - dr[e >> 1]);
        }
      }

      // dq += ds.k: contract the KC keys, 16 at a time (two k8 steps a
      // fresh fragment)
#pragma unroll
      for (int j0 = 0; j0 < KC / 8; j0 += 2) {
        uint32_t sb[2][4], ss[2][4];
#pragma unroll
        for (int h = 0; h < 2; ++h) acc_to_a(sb[h], ss[h], s[j0 + h]);
#pragma unroll
        for (int nn = 0; nn < ON; ++nn) {
          float t[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            uint32_t fb[2], fs[2];
            load_b_trans<D, SPLIT>(fb, fs, Kt, Qs, c0 + (j0 + h) * 8, nn * 8);
            mma_3xtf32(t, sb[h], ss[h], fb, fs);
          }
          add_to(acc[nn], t);
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
// launchers: raise the dynamic shared memory limit (every tile set is above
// the 48 KB default), launch on the caller's stream, report

template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, int blocks, size_t smem_bytes, void* stream, Args... args) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem_bytes);
  if (e != cudaSuccess) return e;
  kernel<<<blocks, NT, smem_bytes, (cudaStream_t)stream>>>(args...);
  return cudaGetLastError();
}

template <int D> constexpr size_t tile_bytes() { return (size_t)TILE * (D + PAD) * sizeof(float); }

}  // namespace

extern "C" {

// out [B,Hq,Lq,D] and lse [B,Hq,Lq] from fp32 inputs
int flash_fwd_tf32x3(int d, const void* q, const void* k, const void* v, const void* bias,
                     void* out, void* lse, int B, int Hq, int Hkv, int Lq, int Lk, int causal,
                     float scale, void* stream) {
  return dispatch_head_dim(d, [&](auto dim) {
    constexpr int D = decltype(dim)::value;
    const int nq = (Lq + TILE - 1) / TILE;
    return launch(fwd_tf32x3_kernel<D>, B * Hq * nq,
                  fwd_tiles<D>() * tile_bytes<D>() + 2 * TILE * sizeof(float), stream,
                  (const float*)q, (const float*)k, (const float*)v, (const float*)bias,
                  (float*)out, (float*)lse, Hq, Hkv, Lq, Lk, nq, causal, scale);
  });
}

// dk, dv [B,Hq,Lk,D] and db [B,Hq,Lk] per query head, from fp32 inputs
int flash_bwd_dkv_tf32x3(int d, const void* q, const void* k, const void* v, const void* bias,
                         const void* dout, const void* lse, const void* delta, void* dk,
                         void* dv, void* db, int B, int Hq, int Hkv, int Lq, int Lk, int causal,
                         float scale, void* stream) {
  return dispatch_head_dim(d, [&](auto dim) {
    constexpr int D = decltype(dim)::value;
    const int nk = (Lk + TILE - 1) / TILE;
    return launch(dkv_tf32x3_kernel<D>, B * Hq * nk,
                  6 * tile_bytes<D>() + 4 * TILE * sizeof(float), stream, (const float*)q,
                  (const float*)k, (const float*)v, (const float*)bias, (const float*)dout,
                  (const float*)lse, (const float*)delta, (float*)dk, (float*)dv, (float*)db, Hq,
                  Hkv, Lq, Lk, nk, causal, scale);
  });
}

// dq [B,Hq,Lq,D] from fp32 inputs
int flash_bwd_dq_tf32x3(int d, const void* q, const void* k, const void* v, const void* bias,
                        const void* dout, const void* lse, const void* delta, void* dq, int B,
                        int Hq, int Hkv, int Lq, int Lk, int causal, float scale, void* stream) {
  return dispatch_head_dim(d, [&](auto dim) {
    constexpr int D = decltype(dim)::value;
    const int nq = (Lq + TILE - 1) / TILE;
    return launch(dq_tf32x3_kernel<D>, B * Hq * nq,
                  6 * tile_bytes<D>() + 2 * TILE * sizeof(float), stream, (const float*)q,
                  (const float*)k, (const float*)v, (const float*)bias, (const float*)dout,
                  (const float*)lse, (const float*)delta, (float*)dq, Hq, Hkv, Lq, Lk, nq,
                  causal, scale);
  });
}

}  // extern "C"
