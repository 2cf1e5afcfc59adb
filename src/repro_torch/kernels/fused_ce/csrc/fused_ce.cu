// B4 fused linear cross-entropy for Hopper (sm_90a): per-token log-sum-exp,
// label logit and argmax of logits = H E^T, and its backward dH and dE,
// without ever writing the (T, V) logits to device memory.
//
// Replaces: src/repro/kernels/fused_ce/kernel.py `fused_ce_kernel`
// (pallas_call at :84) and the jnp backward of its custom VJP
// (src/repro/kernels/fused_ce/ops.py:72). The Pallas grid (T/BT, V/BV)
// carries the online (m, s, ll) across its sequential vocab axis in VMEM
// scratch, and the wrapper pads the vocab with zero rows and removes
// their exp(0) terms afterwards. Here blocks run in parallel and in no
// order, so the sequential axis becomes a loop inside one CUDA block, and
// the vocab tail is masked in the kernel (no padding, no correction):
//
// * fused_ce_fwd: one block per 16-token tile. The tile's hidden rows sit
//   in shared memory as f32; the block streams every 64-row vocab tile of
//   E, forms the 16 x 64 logit tile, and folds it into an online
//   (max, sum-exp) per token, picks up the label logit and tracks the
//   argmax (first index on ties, as jnp.argmax).
// * fused_ce_bwd_dh: one block per 16-token tile, streaming vocab tiles:
//   dlogits = g_lse exp(logit - lse) + g_ll [v == label] is formed tile by
//   tile in shared memory and folded into dH (16 x D, in registers).
// * fused_ce_bwd_de: one block per 16 vocab rows, streaming 64-token
//   tiles: the same dlogits, transposed, folded into dE (16 x D).
//   Each output row belongs to exactly one block: no atomics, dE and dH
//   are deterministic.
//
// Numerics: operands come in the compute dtype (bf16 at full width, f32
// in the reduced config) and every product accumulates in f32, as the
// reference's `unembed` (preferred_element_type=f32).
//
// Bound: 2 T V D operations forward and 4 T V D backward (logits again,
// then dH and dE); at T = 8192, V = 151,936, D = 1024 that is 2.55 and
// 5.1 TFLOP, far above the card's bytes-per-operation line, so the
// tensor-core rate bounds it. This first version runs on the SIMT cores
// in f32 (a warp reduces four streamed rows against the 16 resident rows
// per step, float4 shared-memory reads): right and simple, well below
// that bound. wgmma tiles are the later step.
#include <cuda_bf16.h>

#include <climits>
#include <cmath>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int RT = 16;                 // resident rows per block
constexpr int CT = 64;                 // streamed rows per tile
constexpr int LD = CT + 1;             // logit tile row stride (no bank conflicts)
constexpr int GROUP = 4;               // streamed rows a warp reduces at once
constexpr int MAX_D = 1024;
constexpr int COLS = MAX_D / THREADS;  // output columns a thread owns

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Four consecutive elements as f32 (16-byte / 8-byte aligned loads).
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  __nv_bfloat162 lo, hi;
  lo = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  hi = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  const float2 a = __bfloat1622float2(lo);
  const float2 b = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// dst[r][d] = src[row0 + r][d] as f32 for r < RT (zeros past nrows).
template <typename T>
__device__ void stage_rows(const T* __restrict__ src, int row0, int nrows,
                           int D, float* dst) {
  for (int e = threadIdx.x * 4; e < RT * D; e += THREADS * 4) {
    const int r = e / D, d = e % D;  // D % 4 == 0: the 4 stay in one row
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < nrows) v = load4(src + static_cast<long long>(row0 + r) * D + d);
    *reinterpret_cast<float4*>(dst + r * D + d) = v;
  }
}

// out[i][j] = <res[i], X[x0 + j]> for i < RT, j < CT, f32 accumulation.
// Rows of X past nx give 0; callers mask them. Each warp takes GROUP
// streamed rows at a time; lanes split D four elements each.
template <typename T>
__device__ void dot_tile(const float* __restrict__ res, const T* __restrict__ X,
                         int x0, int nx, int D, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int g = warp * GROUP; g < CT; g += WARPS * GROUP) {
    float part[GROUP][RT];
#pragma unroll
    for (int r = 0; r < GROUP; ++r)
#pragma unroll
      for (int i = 0; i < RT; ++i) part[r][i] = 0.f;
    for (int d = lane * 4; d < D; d += 128) {
      float4 x[GROUP];
#pragma unroll
      for (int r = 0; r < GROUP; ++r) {
        const int row = x0 + g + r;
        x[r] = row < nx ? load4(X + static_cast<long long>(row) * D + d)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        const float4 h = *reinterpret_cast<const float4*>(res + i * D + d);
#pragma unroll
        for (int r = 0; r < GROUP; ++r) {
          float p = part[r][i];
          p = fmaf(h.x, x[r].x, p);
          p = fmaf(h.y, x[r].y, p);
          p = fmaf(h.z, x[r].z, p);
          p = fmaf(h.w, x[r].w, p);
          part[r][i] = p;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < GROUP; ++r)
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        const float v = warp_sum(part[r][i]);
        if (lane == i) out[i * LD + g + r] = v;
      }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
fused_ce_fwd_kernel(const T* __restrict__ h, const T* __restrict__ E,
                    const int* __restrict__ labels, float* __restrict__ lse,
                    float* __restrict__ ll, long long* __restrict__ argmax,
                    int Tn, int V, int D) {
  extern __shared__ float smem[];
  float* hs = smem;           // [RT][D] resident hidden rows
  float* ls = smem + RT * D;  // [RT][LD] logit tile
  constexpr int RPW = RT / WARPS;  // token rows per warp
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int t0 = blockIdx.x * RT;
  stage_rows(h, t0, Tn, D, hs);

  float m[RPW], s[RPW], lab_logit[RPW];
  int arg[RPW], lab[RPW];
#pragma unroll
  for (int q = 0; q < RPW; ++q) {
    const int t = t0 + warp + q * WARPS;
    m[q] = -INFINITY;
    s[q] = 0.f;
    lab_logit[q] = 0.f;
    arg[q] = 0;
    lab[q] = t < Tn ? labels[t] : -1;
  }
  __syncthreads();

  for (int v0 = 0; v0 < V; v0 += CT) {
    dot_tile(hs, E, v0, V, D, ls);
    __syncthreads();
#pragma unroll
    for (int q = 0; q < RPW; ++q) {
      const float* row = ls + (warp + q * WARPS) * LD;
      float best = -INFINITY;
      int bi = INT_MAX;
      for (int j = lane; j < CT && v0 + j < V; j += 32) {
        const float x = row[j];
        if (x > best) {
          best = x;
          bi = v0 + j;
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ob = __shfl_xor_sync(0xffffffffu, best, off);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
        if (ob > best || (ob == best && oi < bi)) {
          best = ob;
          bi = oi;
        }
      }
      const float m_new = fmaxf(m[q], best);
      if (best > m[q]) arg[q] = bi;  // an earlier tile keeps a tie
      float se = 0.f;
      for (int j = lane; j < CT && v0 + j < V; j += 32) se += expf(row[j] - m_new);
      se = warp_sum(se);
      s[q] = s[q] * expf(m[q] - m_new) + se;
      m[q] = m_new;
      const int lj = lab[q] - v0;
      if (lj >= 0 && lj < CT && lab[q] < V) lab_logit[q] = row[lj];
    }
    __syncthreads();  // ls is rewritten by the next tile
  }

  if (lane == 0) {
#pragma unroll
    for (int q = 0; q < RPW; ++q) {
      const int t = t0 + warp + q * WARPS;
      if (t < Tn) {
        lse[t] = m[q] + logf(s[q]);
        ll[t] = lab_logit[q];
        argmax[t] = arg[q];
      }
    }
  }
}

// Backward. DE = false: resident rows are tokens (H), streamed rows are
// vocab rows (E), output dH. DE = true: resident rows are vocab rows,
// streamed rows are tokens, output dE.
template <typename T, bool DE>
__global__ void __launch_bounds__(THREADS)
fused_ce_bwd_kernel(const T* __restrict__ h, const T* __restrict__ E,
                    const int* __restrict__ labels, const float* __restrict__ lse,
                    const float* __restrict__ g_lse, const float* __restrict__ g_ll,
                    T* __restrict__ out, int Tn, int V, int D) {
  extern __shared__ float smem[];
  float* rs = smem;           // [RT][D] resident rows
  float* ps = smem + RT * D;  // [RT][LD] logit tile, then dlogits
  const T* res_src = DE ? E : h;
  const T* X = DE ? h : E;
  const int nres = DE ? V : Tn;
  const int nx = DE ? Tn : V;
  const int r0 = blockIdx.x * RT;
  stage_rows(res_src, r0, nres, D, rs);

  float acc[RT][COLS];
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int c = 0; c < COLS; ++c) acc[i][c] = 0.f;
  __syncthreads();

  for (int x0 = 0; x0 < nx; x0 += CT) {
    dot_tile(rs, X, x0, nx, D, ps);
    __syncthreads();
    for (int e = threadIdx.x; e < RT * CT; e += THREADS) {
      const int i = e / CT, j = e % CT;
      const int t = DE ? x0 + j : r0 + i;
      const int v = DE ? r0 + i : x0 + j;
      float p = 0.f;
      if (t < Tn && v < V) {
        p = g_lse[t] * expf(ps[i * LD + j] - lse[t]);
        if (labels[t] == v) p += g_ll[t];
      }
      ps[i * LD + j] = p;
    }
    __syncthreads();
    const int nj = min(CT, nx - x0);
    for (int j = 0; j < nj; ++j) {
      const T* xr = X + static_cast<long long>(x0 + j) * D;
      float xv[COLS];
#pragma unroll
      for (int c = 0; c < COLS; ++c) {
        const int d = threadIdx.x + c * THREADS;
        xv[c] = d < D ? to_f32(xr[d]) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        const float a = ps[i * LD + j];
#pragma unroll
        for (int c = 0; c < COLS; ++c) acc[i][c] = fmaf(a, xv[c], acc[i][c]);
      }
    }
    __syncthreads();  // ps is rewritten by the next tile
  }

#pragma unroll
  for (int i = 0; i < RT; ++i) {
    if (r0 + i >= nres) break;
#pragma unroll
    for (int c = 0; c < COLS; ++c) {
      const int d = threadIdx.x + c * THREADS;
      if (d < D) store(out + static_cast<long long>(r0 + i) * D + d, acc[i][c]);
    }
  }
}

size_t smem_bytes(int D) { return sizeof(float) * static_cast<size_t>(RT) * (D + LD); }

template <typename T>
int launch_fwd(const void* h, const void* E, const int* labels, float* lse,
               float* ll, long long* argmax, int Tn, int V, int D, int device,
               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = smem_bytes(D);
  err = cudaFuncSetAttribute(fused_ce_fwd_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_ce_fwd_kernel<T><<<(Tn + RT - 1) / RT, THREADS, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(h), static_cast<const T*>(E), labels, lse, ll,
      argmax, Tn, V, D);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool DE>
int launch_bwd(const void* h, const void* E, const int* labels,
               const float* lse, const float* g_lse, const float* g_ll,
               void* out, int Tn, int V, int D, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = smem_bytes(D);
  err = cudaFuncSetAttribute(fused_ce_bwd_kernel<T, DE>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = DE ? V : Tn;
  fused_ce_bwd_kernel<T, DE><<<(rows + RT - 1) / RT, THREADS, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(h), static_cast<const T*>(E), labels, lse, g_lse,
      g_ll, static_cast<T*>(out), Tn, V, D);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int repro_fused_ce_fwd_bf16(const void* h, const void* E,
                                       const int* labels, float* lse, float* ll,
                                       long long* argmax, int Tn, int V, int D,
                                       int device, void* stream) {
  return launch_fwd<__nv_bfloat16>(h, E, labels, lse, ll, argmax, Tn, V, D,
                                   device, stream);
}

extern "C" int repro_fused_ce_fwd_f32(const void* h, const void* E,
                                      const int* labels, float* lse, float* ll,
                                      long long* argmax, int Tn, int V, int D,
                                      int device, void* stream) {
  return launch_fwd<float>(h, E, labels, lse, ll, argmax, Tn, V, D, device,
                           stream);
}

extern "C" int repro_fused_ce_bwd_dh_bf16(const void* h, const void* E,
                                          const int* labels, const float* lse,
                                          const float* g_lse, const float* g_ll,
                                          void* dh, int Tn, int V, int D,
                                          int device, void* stream) {
  return launch_bwd<__nv_bfloat16, false>(h, E, labels, lse, g_lse, g_ll, dh,
                                          Tn, V, D, device, stream);
}

extern "C" int repro_fused_ce_bwd_dh_f32(const void* h, const void* E,
                                         const int* labels, const float* lse,
                                         const float* g_lse, const float* g_ll,
                                         void* dh, int Tn, int V, int D,
                                         int device, void* stream) {
  return launch_bwd<float, false>(h, E, labels, lse, g_lse, g_ll, dh, Tn, V, D,
                                  device, stream);
}

extern "C" int repro_fused_ce_bwd_de_bf16(const void* h, const void* E,
                                          const int* labels, const float* lse,
                                          const float* g_lse, const float* g_ll,
                                          void* de, int Tn, int V, int D,
                                          int device, void* stream) {
  return launch_bwd<__nv_bfloat16, true>(h, E, labels, lse, g_lse, g_ll, de,
                                         Tn, V, D, device, stream);
}

extern "C" int repro_fused_ce_bwd_de_f32(const void* h, const void* E,
                                         const int* labels, const float* lse,
                                         const float* g_lse, const float* g_ll,
                                         void* de, int Tn, int V, int D,
                                         int device, void* stream) {
  return launch_bwd<float, true>(h, E, labels, lse, g_lse, g_ll, de, Tn, V, D,
                                 device, stream);
}
