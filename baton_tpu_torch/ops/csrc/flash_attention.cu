// Flash attention for Hopper (sm_90a), SIMT design: the forward pass and
// the two passes of the backward on the CUDA cores, each behind a plain C
// entry point (bound with ctypes from baton_tpu_torch/ops/flash_attention.py).
// Since the tensor-core kernels of flash_attention_mma.cu took over every
// bf16 call, the three kernels here serve fp32 only (fp32 on the tensor
// cores would be TF32). They keep the element type as a template
// parameter, which marks the TPU kernels' rounding points (round_to<T>),
// and only their fp32 instances are built.
//
// Replaces the three Pallas TPU kernels of baton_tpu/ops/flash_attention.py:
//   fwd_kernel  <- _fwd_kernel      (:65-131, launched by _fwd :151-189), fp32
//   dkv_kernel  <- _bwd_dkv_kernel  (:203-250, pass 1 of _bwd_call :325-342), fp32
//   dq_kernel   <- _bwd_dq_kernel   (:253-290, pass 2 of _bwd_call :344-358), fp32
//
// Layout: q [B, Hq, Lq, D], k/v [B, Hkv, Lk, D] (contiguous),
// bias [B, Lk] fp32 (additive, per key), lse/delta [B, Hq, Lq] fp32.
// Query head h reads kv head h / (Hq / Hkv) (GQA). D is 64 or 128; any L
// (the ragged edge is masked in the kernel, padded keys get p = 0).
//
// What bounds them on the H100: in fp32 at BERT-base's shape (L = 128,
// D = 64) each pass does ~32 FLOPs per byte it must move, above the ~20 of
// the CUDA cores' 67 TFLOP/s over 3.35 TB/s, so a fast fp32 version is
// bound by the FMA rate. This version is the simple one: 64 x 64 tiles in
// shared memory (fp32, rows padded by one word so a warp's column reads hit
// 16 different banks), and scalar fp32 FMAs with a 4 x 4 (or 4 x D/16)
// register micro-tile per thread. Each pair of FMAs costs two shared-memory
// loads, so the kernels are bound by the rate of shared-memory loads
// (times in PERF.md).
//
// Numerics follow the TPU kernels: scores, softmax statistics and every
// accumulator in fp32; p is rounded to the input type before p.v and p^T.do
// and ds before ds^T.q and ds.k (round_to<T>: nothing to do in fp32, the
// only type built); scale is applied after the dot and before
// the bias; masked scores are the finite -1e30 (never -inf), so a row whose
// keys are all masked averages uniformly instead of producing NaN.
//
// Launch shape: the TPU's sequential innermost grid axis becomes a loop in
// the block. fwd and dq: one block per (b, h, 64-query tile), looping over
// kv tiles. dkv: one block per (b, h, 64-key tile), looping over q tiles,
// writing per-query-head dk/dv/db (the GQA fold is a torch sum outside), so
// no block shares an output and no atomics are needed. Each entry point
// returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>

#include <cstddef>

#include "dispatch.cuh"

namespace {

constexpr int TILE = 64;        // query rows and key rows per tile
constexpr int NT = 256;         // threads per block: a 16 x 16 grid
constexpr int SP = TILE + 1;    // padded row stride of the 64 x 64 tiles
constexpr float NEG_INF = -1e30f;

// conversions between the element type and fp32 (fp32 is the one type built)
__device__ __forceinline__ float to_f(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }

// x rounded to T's precision, kept as fp32 (the TPU kernels' astype before a dot)
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// max / sum over the 16 lanes that share a thread-grid row (half a warp)
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// rows [row0, row0 + TILE) of a row-major [L, D] matrix into shared memory
// (row stride D + 1), converted to fp32; rows past L read as zero
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0, int L) {
  for (int idx = threadIdx.x; idx < TILE * D; idx += NT) {
    const int r = idx / D, c = idx % D;
    const int row = row0 + r;
    dst[r * (D + 1) + c] = row < L ? to_f(src[(size_t)row * D + c]) : 0.f;
  }
}

// entries TILE of a length-L vector from row0 into shared memory, zero past L
__device__ __forceinline__ void load_vec(float* dst, const float* src, int row0, int L) {
  if (threadIdx.x < TILE) {
    const int row = row0 + threadIdx.x;
    dst[threadIdx.x] = row < L ? src[row] : 0.f;
  }
}

// Thread (ty, tx) of the 16 x 16 grid owns tile rows ty*4 + i (i < 4) and,
// in a 64-wide score tile, columns tx + 16*c (c < 4); in a D-wide output
// tile, columns tx + 16*c (c < D/16).
//
// a[i][c] += sum_d A[ty*4+i][d] * B[tx+16c][d] for two row-major tiles of
// width D in shared memory (q.k^T, do.v^T)
template <int D>
__device__ __forceinline__ void dot_rows(float (&acc)[4][4], const float* A, const float* Bm,
                                         int ty, int tx) {
  constexpr int P = D + 1;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float b[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) b[c] = Bm[(tx + 16 * c) * P + d];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = A[(ty * 4 + i) * P + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][c] = fmaf(a, b[c], acc[i][c]);
    }
  }
}

// ----------------------------------------------------------------------
// forward: out = softmax(q.k^T * scale + bias [, causal]) . v, lse

template <typename T, int D>
__global__ void __launch_bounds__(NT)
fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           const float* __restrict__ bias, T* __restrict__ out, float* __restrict__ lse,
           int Hq, int Hkv, int Lq, int Lk, int nq, int causal, float scale) {
  constexpr int P = D + 1;
  constexpr int OC = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;              // [TILE][P]
  float* Ks = Qs + TILE * P;     // [TILE][P]
  float* Vs = Ks + TILE * P;     // [TILE][P]
  float* Ps = Vs + TILE * P;     // [TILE][SP] p rounded to T

  const int tile = blockIdx.x % nq;
  const int bh = blockIdx.x / nq;
  const int h = bh % Hq, b = bh / Hq;
  const int hk = h / (Hq / Hkv);
  const int q0 = tile * TILE;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const T* kb = k + (size_t)(b * Hkv + hk) * Lk * D;
  const T* vb = v + (size_t)(b * Hkv + hk) * Lk * D;
  const float* bb = bias + (size_t)b * Lk;

  load_tile<T, D>(Qs, q + (size_t)bh * Lq * D, q0, Lq);

  float m[4], l[4], acc[4][OC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < OC; ++c) acc[i][c] = 0.f;
  }

  // causal: kv tiles wholly in the future of every query of this tile add nothing
  const int k_end = causal ? min(Lk, q0 + TILE) : Lk;
  for (int k0 = 0; k0 < k_end; k0 += TILE) {
    __syncthreads();  // the previous tile's reads of Ks/Vs/Ps are done
    load_tile<T, D>(Ks, kb, k0, Lk);
    load_tile<T, D>(Vs, vb, k0, Lk);
    __syncthreads();

    float s[4][4] = {};
    dot_rows<D>(s, Qs, Ks, ty, tx);

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty * 4 + i;
      bool valid[4];
      float mx = NEG_INF;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kj = k0 + tx + 16 * c;
        valid[c] = kj < Lk;
        float x = valid[c] ? s[i][c] * scale + bb[kj] : NEG_INF;
        if (causal && qi < kj) x = NEG_INF;
        s[i][c] = x;
        if (valid[c]) mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = valid[c] ? expf(s[i][c] - m_new) : 0.f;
        rs += p;
        Ps[(ty * 4 + i) * SP + tx + 16 * c] = round_to<T>(p);
      }
      l[i] = l[i] * alpha + row_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < OC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < TILE; ++j) {
      float vv[OC];
#pragma unroll
      for (int c = 0; c < OC; ++c) vv[c] = Vs[j * P + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = Ps[(ty * 4 + i) * SP + j];
#pragma unroll
        for (int c = 0; c < OC; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi >= Lq) continue;
    const float ll = fmaxf(l[i], 1e-30f);
    T* orow = out + ((size_t)bh * Lq + qi) * D;
#pragma unroll
    for (int c = 0; c < OC; ++c) orow[tx + 16 * c] = from_f<T>(acc[i][c] / ll);
    if (tx == 0) lse[(size_t)bh * Lq + qi] = m[i] + logf(ll);
  }
}

// Shared recompute of the two backward passes for one (query tile, key
// tile) pair: p = exp(s - lse) and ds = p * (do.v^T - delta), for the
// thread's 4 x 4 micro-tile. Padded queries and keys get p = ds = 0.
template <int D>
__device__ __forceinline__ void recompute_p_ds(float (&p)[4][4], float (&ds)[4][4],
                                               const float* Qs, const float* dOs,
                                               const float* Ks, const float* Vs,
                                               const float* lse_s, const float* delta_s,
                                               const float* bb, int q0, int k0, int Lq,
                                               int Lk, int causal, float scale, int ty,
                                               int tx) {
  float s[4][4] = {}, dp[4][4] = {};
  dot_rows<D>(s, Qs, Ks, ty, tx);
  dot_rows<D>(dp, dOs, Vs, ty, tx);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    const int qi = q0 + r;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int kj = k0 + tx + 16 * c;
      float pv = 0.f;
      if (qi < Lq && kj < Lk) {
        float x = s[i][c] * scale + bb[kj];
        if (causal && qi < kj) x = NEG_INF;
        pv = expf(x - lse_s[r]);
      }
      p[i][c] = pv;
      ds[i][c] = pv * (dp[i][c] - delta_s[r]);
    }
  }
}

// ----------------------------------------------------------------------
// backward pass 1: dk_h, dv_h [B, Hq, Lk, D] and db_h [B, Hq, Lk], fp32

template <typename T, int D>
__global__ void __launch_bounds__(NT)
dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           const float* __restrict__ bias, const T* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           float* __restrict__ dk, float* __restrict__ dv, float* __restrict__ db,
           int Hq, int Hkv, int Lq, int Lk, int nk, int causal, float scale) {
  constexpr int P = D + 1;
  constexpr int OC = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;                 // [TILE][P]
  float* Vs = Ks + TILE * P;        // [TILE][P]
  float* Qs = Vs + TILE * P;        // [TILE][P]
  float* dOs = Qs + TILE * P;       // [TILE][P]
  float* Ps = dOs + TILE * P;       // [TILE q][SP] p rounded to T
  float* dSs = Ps + TILE * SP;      // [TILE q][SP] ds rounded to T
  float* red = dSs + TILE * SP;     // [16][TILE] column partial sums of ds
  float* lse_s = red + 16 * TILE;   // [TILE]
  float* delta_s = lse_s + TILE;    // [TILE]

  const int tile = blockIdx.x % nk;
  const int bh = blockIdx.x / nk;
  const int h = bh % Hq, b = bh / Hq;
  const int hk = h / (Hq / Hkv);
  const int k0 = tile * TILE;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const T* qb = q + (size_t)bh * Lq * D;
  const T* dob = dout + (size_t)bh * Lq * D;
  const float* bb = bias + (size_t)b * Lk;

  load_tile<T, D>(Ks, k + (size_t)(b * Hkv + hk) * Lk * D, k0, Lk);
  load_tile<T, D>(Vs, v + (size_t)(b * Hkv + hk) * Lk * D, k0, Lk);

  // output micro-tile: key rows ty*4 + i, feature columns tx + 16c
  float dka[4][OC], dva[4][OC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < OC; ++c) dka[i][c] = dva[i][c] = 0.f;
  float dba = 0.f;  // thread tid < TILE owns key column tid

  // causal: query tiles that end before this key tile see none of its keys
  for (int q0 = causal ? k0 : 0; q0 < Lq; q0 += TILE) {
    __syncthreads();  // the previous tile's reads of Qs/dOs/Ps/dSs are done
    load_tile<T, D>(Qs, qb, q0, Lq);
    load_tile<T, D>(dOs, dob, q0, Lq);
    load_vec(lse_s, lse + (size_t)bh * Lq, q0, Lq);
    load_vec(delta_s, delta + (size_t)bh * Lq, q0, Lq);
    __syncthreads();

    float p[4][4], ds[4][4];
    recompute_p_ds<D>(p, ds, Qs, dOs, Ks, Vs, lse_s, delta_s, bb, q0, k0, Lq, Lk, causal,
                      scale, ty, tx);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float cs = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        Ps[(ty * 4 + i) * SP + tx + 16 * c] = round_to<T>(p[i][c]);
        dSs[(ty * 4 + i) * SP + tx + 16 * c] = round_to<T>(ds[i][c]);
        cs += ds[i][c];
      }
      red[ty * TILE + tx + 16 * c] = cs;  // db sums the unrounded ds
    }
    __syncthreads();

    if (tid < TILE) {
#pragma unroll
      for (int t = 0; t < 16; ++t) dba += red[t * TILE + tid];
    }
    // dv += p^T . do ; dk += ds^T . q   (contract the query rows)
#pragma unroll 4
    for (int r = 0; r < TILE; ++r) {
      float dov[OC], qv[OC];
#pragma unroll
      for (int c = 0; c < OC; ++c) {
        dov[c] = dOs[r * P + tx + 16 * c];
        qv[c] = Qs[r * P + tx + 16 * c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float pv = Ps[r * SP + ty * 4 + i];
        const float dsv = dSs[r * SP + ty * 4 + i];
#pragma unroll
        for (int c = 0; c < OC; ++c) {
          dva[i][c] = fmaf(pv, dov[c], dva[i][c]);
          dka[i][c] = fmaf(dsv, qv[c], dka[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kj = k0 + ty * 4 + i;
    if (kj >= Lk) continue;
    float* dkrow = dk + ((size_t)bh * Lk + kj) * D;
    float* dvrow = dv + ((size_t)bh * Lk + kj) * D;
#pragma unroll
    for (int c = 0; c < OC; ++c) {
      dkrow[tx + 16 * c] = scale * dka[i][c];
      dvrow[tx + 16 * c] = dva[i][c];
    }
  }
  if (tid < TILE && k0 + tid < Lk) db[(size_t)bh * Lk + k0 + tid] = dba;
}

// ----------------------------------------------------------------------
// backward pass 2: dq [B, Hq, Lq, D], fp32

template <typename T, int D>
__global__ void __launch_bounds__(NT)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const float* __restrict__ bias, const T* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          float* __restrict__ dq, int Hq, int Hkv, int Lq, int Lk, int nq, int causal,
          float scale) {
  constexpr int P = D + 1;
  constexpr int OC = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;                 // [TILE][P]
  float* dOs = Qs + TILE * P;       // [TILE][P]
  float* Ks = dOs + TILE * P;       // [TILE][P]
  float* Vs = Ks + TILE * P;        // [TILE][P]
  float* dSs = Vs + TILE * P;       // [TILE q][SP] ds rounded to T
  float* lse_s = dSs + TILE * SP;   // [TILE]
  float* delta_s = lse_s + TILE;    // [TILE]

  const int tile = blockIdx.x % nq;
  const int bh = blockIdx.x / nq;
  const int h = bh % Hq, b = bh / Hq;
  const int hk = h / (Hq / Hkv);
  const int q0 = tile * TILE;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const T* kb = k + (size_t)(b * Hkv + hk) * Lk * D;
  const T* vb = v + (size_t)(b * Hkv + hk) * Lk * D;
  const float* bb = bias + (size_t)b * Lk;

  load_tile<T, D>(Qs, q + (size_t)bh * Lq * D, q0, Lq);
  load_tile<T, D>(dOs, dout + (size_t)bh * Lq * D, q0, Lq);
  load_vec(lse_s, lse + (size_t)bh * Lq, q0, Lq);
  load_vec(delta_s, delta + (size_t)bh * Lq, q0, Lq);

  float dqa[4][OC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < OC; ++c) dqa[i][c] = 0.f;

  const int k_end = causal ? min(Lk, q0 + TILE) : Lk;
  for (int k0 = 0; k0 < k_end; k0 += TILE) {
    __syncthreads();  // the previous tile's reads of Ks/dSs are done
    load_tile<T, D>(Ks, kb, k0, Lk);
    load_tile<T, D>(Vs, vb, k0, Lk);
    __syncthreads();

    float p[4][4], ds[4][4];
    recompute_p_ds<D>(p, ds, Qs, dOs, Ks, Vs, lse_s, delta_s, bb, q0, k0, Lq, Lk, causal,
                      scale, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) dSs[(ty * 4 + i) * SP + tx + 16 * c] = round_to<T>(ds[i][c]);
    __syncthreads();

    // dq += ds . k   (contract the key rows)
#pragma unroll 4
    for (int j = 0; j < TILE; ++j) {
      float kv[OC];
#pragma unroll
      for (int c = 0; c < OC; ++c) kv[c] = Ks[j * P + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float dsv = dSs[(ty * 4 + i) * SP + j];
#pragma unroll
        for (int c = 0; c < OC; ++c) dqa[i][c] = fmaf(dsv, kv[c], dqa[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi >= Lq) continue;
    float* row = dq + ((size_t)bh * Lq + qi) * D;
#pragma unroll
    for (int c = 0; c < OC; ++c) row[tx + 16 * c] = scale * dqa[i][c];
  }
}

// ----------------------------------------------------------------------
// launchers: raise the dynamic shared memory limit (every tile set is above
// the 48 KB default), launch on the caller's stream, report

template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, int blocks, size_t smem_floats, void* stream, Args... args) {
  const int bytes = (int)(smem_floats * sizeof(float));
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  kernel<<<blocks, NT, bytes, (cudaStream_t)stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// out [B,Hq,Lq,D] and lse [B,Hq,Lq], fp32
int flash_fwd_simt(int d, const void* q, const void* k, const void* v, const void* bias,
                   void* out, void* lse, int B, int Hq, int Hkv, int Lq, int Lk, int causal,
                   float scale, void* stream) {
  return dispatch_head_dim(d, [&](auto dim) {
    constexpr int D = decltype(dim)::value;
    const int nq = (Lq + TILE - 1) / TILE;
    return launch(fwd_kernel<float, D>, B * Hq * nq, 3 * TILE * (D + 1) + TILE * SP, stream,
                  (const float*)q, (const float*)k, (const float*)v, (const float*)bias,
                  (float*)out, (float*)lse, Hq, Hkv, Lq, Lk, nq, causal, scale);
  });
}

// dk, dv [B,Hq,Lk,D] and db [B,Hq,Lk] per query head, from fp32 inputs
int flash_bwd_dkv_simt(int d, const void* q, const void* k, const void* v, const void* bias,
                       const void* dout, const void* lse, const void* delta, void* dk,
                       void* dv, void* db, int B, int Hq, int Hkv, int Lq, int Lk, int causal,
                       float scale, void* stream) {
  return dispatch_head_dim(d, [&](auto dim) {
    constexpr int D = decltype(dim)::value;
    const int nk = (Lk + TILE - 1) / TILE;
    return launch(dkv_kernel<float, D>, B * Hq * nk,
                  4 * TILE * (D + 1) + 2 * TILE * SP + 16 * TILE + 2 * TILE, stream,
                  (const float*)q, (const float*)k, (const float*)v, (const float*)bias,
                  (const float*)dout, (const float*)lse, (const float*)delta, (float*)dk,
                  (float*)dv, (float*)db, Hq, Hkv, Lq, Lk, nk, causal, scale);
  });
}

// dq [B,Hq,Lq,D] from fp32 inputs
int flash_bwd_dq_simt(int d, const void* q, const void* k, const void* v, const void* bias,
                      const void* dout, const void* lse, const void* delta, void* dq, int B,
                      int Hq, int Hkv, int Lq, int Lk, int causal, float scale, void* stream) {
  return dispatch_head_dim(d, [&](auto dim) {
    constexpr int D = decltype(dim)::value;
    const int nq = (Lq + TILE - 1) / TILE;
    return launch(dq_kernel<float, D>, B * Hq * nq, 4 * TILE * (D + 1) + TILE * SP + 2 * TILE,
                  stream, (const float*)q, (const float*)k, (const float*)v, (const float*)bias,
                  (const float*)dout, (const float*)lse, (const float*)delta, (float*)dq, Hq,
                  Hkv, Lq, Lk, nq, causal, scale);
  });
}

}  // extern "C"
