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
// order, so the sequential axis becomes a loop inside one CUDA block or
// a sequence of launches, and the vocab tail is masked in the kernel (no
// padding, no correction).
//
// * fused_ce_fwd, bf16 (the full-width training path): one persistent
//   GEMM launch on the tensor cores (wgmma_gemm.cuh: TMA loads, one
//   producer and two wgmma consumer warpgroups, 128 x 256 tiles), S =
//   H E^T with K = D, then a combine launch, both on the caller's stream.
//   The GEMM's epilogue works on the accumulators in registers: per token
//   row of its tile the max logit and its first index, then the sum of
//   exp(S - max) over the tile's vocab columns (columns past V masked),
//   reduced over the four threads that share the row; it writes one
//   partial (max, sum, argmax) per (token, vocab tile) to scratch, and
//   the thread whose column is the token's label writes the label logit.
//   Tiles are walked in bands of a few vocab tiles x every token band,
//   so the blocks running at one time share their E tiles and E is read
//   from device memory about once. The combine kernel (one warp per
//   token) folds the token's partials in a fixed order: lse = m + log s,
//   the argmax the first index that holds the max (as jnp.argmax).
// * fused_ce_fwd, f32 (the gradient check of the coded step): one block
//   per 16-token tile on the SIMT cores. The tile's hidden rows sit in
//   shared memory; the block streams every 64-row vocab tile of E, forms
//   the 16 x 64 logit tile, and folds it into an online (max, sum-exp)
//   per token, picks up the label logit and tracks the argmax.
// * fused_ce_bwd_dh / fused_ce_bwd_de, bf16 (the full-width training
//   path): chunked GEMMs on the tensor cores (wgmma_gemm.cuh: a
//   persistent grid, TMA loads, one producer and two wgmma consumer
//   warpgroups, 128 x 256 tiles).
//   The vocab is cut into chunks of Vc rows (the wrapper picks Vc so the
//   (T, Vc) bf16 scratch it allocates stays within 64 MiB); per chunk,
//   in a fixed order, two launches on the caller's stream:
//   1. dlogits: S = H E_c^T (K = D); the epilogue forms, in registers,
//      P = g_lse exp(S - lse) + g_ll [v == label] (0 past V; labels < 0
//      have no one-hot term), rounds it to bf16 and stores it into the
//      (T, Vc) scratch through shared memory and an asynchronous TMA
//      store. The (T, V) logits are never written.
//   2. bwd_dh: an f32 (T, D) scratch accumulates P_c E_c (K = Vc; E_c is
//      the MN-major B); the last chunk writes dH in bf16.
//      bwd_de: dE[c] = P_c^T H (K = T; both operands MN-major), written
//      in bf16; chunks own disjoint rows of dE.
//   Both kernels do 4 T V D operations (the logits again, then their
//   product), the work the bound counts. No atomics, no split K, a fixed
//   chunk order: dH and dE are the same bits on every launch.
//   The one numeric difference from the reference backward: P is rounded
//   to bf16 before the product (the reference keeps dlogits in f32), a
//   relative error of at most 2^-8 per element of P.
// * fused_ce_bwd_dh / fused_ce_bwd_de, f32 (the gradient check of the
//   coded step): one block per 16-token (dH) or 16-vocab-row (dE) tile
//   on the SIMT cores, streaming the other operand: the dlogits tile is
//   formed in shared memory and folded into the block's own output rows.
//
// Numerics: operands come in the compute dtype (bf16 at full width, f32
// in the reduced config) and every product accumulates in f32, as the
// reference's `unembed` (preferred_element_type=f32).
//
// Bound: 2 T V D operations forward and 4 T V D backward (logits again,
// then dH and dE); at T = 8192, V = 151,936, D = 1024 that is 2.55 and
// 5.1 TFLOP, far above the card's bytes-per-operation line, so the
// tensor-core rate bounds it. The bf16 forward and backward run on
// wgmma; the f32 entry points stay on the SIMT cores, far below it.
#include <cuda_bf16.h>

#include <climits>
#include <cmath>

#include "common.cuh"
#include "wgmma_gemm.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int RT = 16;                 // resident rows per block
constexpr int CT = 64;                 // streamed rows per tile
constexpr int LD = CT + 1;             // logit tile row stride (no bank conflicts)
constexpr int GROUP = 4;               // streamed rows a warp reduces at once
constexpr int MAX_D = 1024;
constexpr int COLS = MAX_D / THREADS;  // output columns a thread owns

// Four consecutive elements (a 16-byte aligned load).
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// dst[r][d] = src[row0 + r][d] for r < RT (zeros past nrows).
__device__ void stage_rows(const float* __restrict__ src, int row0, int nrows,
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
__device__ void dot_tile(const float* __restrict__ res, const float* __restrict__ X,
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

// SIMT forward (the f32 entry point).
__global__ void __launch_bounds__(THREADS)
fused_ce_fwd_kernel(const float* __restrict__ h, const float* __restrict__ E,
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

// SIMT backward (the f32 entry points). DE = false: resident rows are
// tokens (H), streamed rows are vocab rows (E), output dH. DE = true:
// resident rows are vocab rows, streamed rows are tokens, output dE.
template <bool DE>
__global__ void __launch_bounds__(THREADS)
fused_ce_bwd_kernel(const float* __restrict__ h, const float* __restrict__ E,
                    const int* __restrict__ labels, const float* __restrict__ lse,
                    const float* __restrict__ g_lse, const float* __restrict__ g_ll,
                    float* __restrict__ out, int Tn, int V, int D) {
  extern __shared__ float smem[];
  float* rs = smem;           // [RT][D] resident rows
  float* ps = smem + RT * D;  // [RT][LD] logit tile, then dlogits
  const float* res_src = DE ? E : h;
  const float* X = DE ? h : E;
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
      const float* xr = X + static_cast<long long>(x0 + j) * D;
      float xv[COLS];
#pragma unroll
      for (int c = 0; c < COLS; ++c) {
        const int d = threadIdx.x + c * THREADS;
        xv[c] = d < D ? xr[d] : 0.f;
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
      if (d < D) out[static_cast<long long>(r0 + i) * D + d] = acc[i][c];
    }
  }
}

size_t smem_bytes(int D) { return sizeof(float) * static_cast<size_t>(RT) * (D + LD); }

int launch_fwd(const void* h, const void* E, const int* labels, float* lse,
               float* ll, long long* argmax, int Tn, int V, int D, int device,
               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = smem_bytes(D);
  err = cudaFuncSetAttribute(fused_ce_fwd_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_ce_fwd_kernel<<<(Tn + RT - 1) / RT, THREADS, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(h), static_cast<const float*>(E), labels, lse, ll,
      argmax, Tn, V, D);
  return static_cast<int>(cudaGetLastError());
}

template <bool DE>
int launch_bwd(const void* h, const void* E, const int* labels,
               const float* lse, const float* g_lse, const float* g_ll,
               void* out, int Tn, int V, int D, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = smem_bytes(D);
  err = cudaFuncSetAttribute(fused_ce_bwd_kernel<DE>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = DE ? V : Tn;
  fused_ce_bwd_kernel<DE><<<(rows + RT - 1) / RT, THREADS, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(h), static_cast<const float*>(E), labels, lse,
      g_lse, g_ll, static_cast<float*>(out), Tn, V, D);
  return static_cast<int>(cudaGetLastError());
}

// ---- bf16 backward on the tensor cores (wgmma_gemm.cuh) ----

using bf16 = __nv_bfloat16;

// Stage 1 epilogue: the dlogits tile P of chunk [v0, v0 + Vc) into the
// (T, Vc) bf16 scratch (through shared memory and TMA; rows past T are
// dropped). Rows are tokens, columns vocab rows of the chunk.
struct DlogitsEpi {
  const int* labels;
  const float* lse;
  const float* g_lse;
  const float* g_ll;
  int T, V, v0;

  __device__ void operator()(float (&acc)[wg::ACC], int row0, int col0,
                             const wg::Out& out) const {
    constexpr float LOG2E = 1.4426950408889634f;
    const int r = row0 + 16 * (out.tid / 32) + (out.tid % 32) / 4;
    const int vq = v0 + col0 + 2 * (out.tid % 4);  // vocab row of this thread's column 0
    float l2[2], gs[2], gl[2];
    int lab[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = r + 8 * h;
      const bool ok = t < T;
      l2[h] = ok ? lse[t] * LOG2E : 0.f;
      gs[h] = ok ? g_lse[t] : 0.f;
      gl[h] = ok ? g_ll[t] : 0.f;
      lab[h] = ok ? labels[t] : -1;
    }
    wg::store_tile_bf16(out, row0, col0, [&](int j, int h, int c) {
      const int v = vq + 8 * j + c;
      float q = 0.f;
      if (v < V) {
        // exp(S - lse) as exp2(S log2 e - lse log2 e)
        q = gs[h] * exp2f(fmaf(acc[4 * j + 2 * h + c], LOG2E, -l2[h]));
        if (v == lab[h]) q += gl[h];
      }
      return q;
    });
  }
};

// Stage 2 epilogue of bwd_dh: rows tokens, columns hidden units. The f32
// scratch carries the sum over earlier chunks (all of this thread's loads
// are issued before its first store); the last chunk writes dH.
struct DhEpi {
  float* sum;
  bf16* dh;
  int T, D, first, last;

  __device__ void operator()(float (&acc)[wg::ACC], int row0, int col0,
                             const wg::Out& out) const {
    const int r = row0 + 16 * (out.tid / 32) + (out.tid % 32) / 4;
    const int cq = col0 + 2 * (out.tid % 4);
    if (!first) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = r + 8 * h;
        if (t >= T) continue;
        const float* row = sum + static_cast<long long>(t) * D;
#pragma unroll
        for (int j = 0; j < wg::ACC / 4; ++j) {
          const int d = cq + 8 * j;
          if (d >= D) continue;  // D even: d < D implies d + 1 < D
          const float2 o = *reinterpret_cast<const float2*>(row + d);
          acc[4 * j + 2 * h] = o.x + acc[4 * j + 2 * h];
          acc[4 * j + 2 * h + 1] = o.y + acc[4 * j + 2 * h + 1];
        }
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = r + 8 * h;
      if (t >= T) continue;
      const long long base = static_cast<long long>(t) * D;
#pragma unroll
      for (int j = 0; j < wg::ACC / 4; ++j) {
        const int d = cq + 8 * j;
        if (d >= D) continue;
        const float x = acc[4 * j + 2 * h], y = acc[4 * j + 2 * h + 1];
        if (last)
          *reinterpret_cast<__nv_bfloat162*>(dh + base + d) = __floats2bfloat162_rn(x, y);
        else
          *reinterpret_cast<float2*>(sum + base + d) = make_float2(x, y);
      }
    }
  }
};

// Stage 2 epilogue of bwd_de: rows vocab rows of the chunk, columns
// hidden units; rows past V are not stored.
struct DeEpi {
  bf16* de;
  int V, D, v0;

  __device__ void operator()(float (&acc)[wg::ACC], int row0, int col0,
                             const wg::Out& out) const {
    const int r = row0 + 16 * (out.tid / 32) + (out.tid % 32) / 4;
    const int cq = col0 + 2 * (out.tid % 4);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int v = v0 + r + 8 * h;
      if (v >= V) continue;
      bf16* row = de + static_cast<long long>(v) * D;
#pragma unroll
      for (int j = 0; j < wg::ACC / 4; ++j) {
        const int d = cq + 8 * j;
        if (d >= D) continue;
        *reinterpret_cast<__nv_bfloat162*>(row + d) =
            __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
  }
};

int cdiv(int a, int b) { return (a + b - 1) / b; }

// bwd_dh (DE = false) or bwd_de (DE = true) for bf16 operands: per chunk
// of Vc vocab rows, the dlogits launch and the product launch. `p` is the
// (T, Vc) bf16 scratch; `sum` the (T, D) f32 scratch of bwd_dh (unused
// when one chunk covers V, and by bwd_de).
template <bool DE>
int launch_bwd_tc(const void* h, const void* E, const int* labels,
                  const float* lse, const float* g_lse, const float* g_ll,
                  void* out, void* p, float* sum, int Tn, int V, int D, int Vc,
                  int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (D % 8 != 0 || Vc <= 0 || Vc % wg::BN != 0) return cudaErrorInvalidValue;
  const int chunks = cdiv(V, Vc);
  if (!DE && chunks > 1 && sum == nullptr) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  // stage 1 operands, both K-major: H (T, D) and E (V, D); its output P
  CUtensorMap h_k, e_k, p_out, a2, b2;
  bool ok = wg::bf16_map(&h_k, h, Tn, D, wg::BK, wg::BM) &&
            wg::bf16_map(&e_k, E, V, D, wg::BK, wg::BN) &&
            wg::bf16_map(&p_out, p, Tn, Vc, 64, 64);
  if (DE) {
    // P_c^T (A, MN-major over the scratch) and H (B, MN-major)
    ok = ok && wg::bf16_map(&a2, p, Tn, Vc, 64, wg::BK) &&
         wg::bf16_map(&b2, h, Tn, D, 64, wg::BK);
  } else {
    // P_c (A, K-major over the scratch) and E_c (B, MN-major)
    ok = ok && wg::bf16_map(&a2, p, Tn, Vc, wg::BK, wg::BM) &&
         wg::bf16_map(&b2, E, V, D, 64, wg::BK);
  }
  if (!ok) return cudaErrorInvalidValue;
  // (the product epilogues store directly: their output map is unused)
  for (int c = 0; c < chunks; ++c) {
    const int v0 = c * Vc;
    const int vlen = V - v0 < Vc ? V - v0 : Vc;
    const DlogitsEpi dl{labels, lse, g_lse, g_ll, Tn, V, v0};
    err = wg::launch_gemm<false, false>(h_k, e_k, p_out, 0, v0, 0, cdiv(D, wg::BK),
                                        cdiv(Tn, wg::BM), cdiv(vlen, wg::BN), dl, st);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (DE) {
      const DeEpi epi{static_cast<bf16*>(out), V, D, v0};
      err = wg::launch_gemm<true, true>(a2, b2, a2, 0, 0, 0, cdiv(Tn, wg::BK),
                                        cdiv(vlen, wg::BM), cdiv(D, wg::BN), epi, st);
    } else {
      const DhEpi epi{sum, static_cast<bf16*>(out), Tn, D, c == 0, c == chunks - 1};
      err = wg::launch_gemm<false, true>(a2, b2, a2, 0, 0, v0, cdiv(vlen, wg::BK),
                                         cdiv(Tn, wg::BM), cdiv(D, wg::BN), epi, st);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return cudaSuccess;
}

// ---- bf16 forward on the tensor cores (wgmma_gemm.cuh) ----

constexpr float LOG2E = 1.4426950408889634f;
constexpr int FWD_BAND = 4;       // vocab tiles per band of the GEMM's walk
constexpr int COMBINE_WARPS = 8;  // tokens per block of the combine kernel

// The forward's partials: per (token, vocab tile), the tile's max logit,
// its sum of exp(logit - max) and the first vocab index of the max, in
// three token-major (T, n_tiles) planes.
struct Partials {
  float* m;
  float* s;
  int* arg;
};

// Partials of one 128 x 256 logit tile (rows tokens, columns vocab rows).
// A thread holds 2 rows x 64 columns; the quad tid % 4 shares the rows.
// In the ragged last vocab tile, columns past V (zeros from TMA's fill)
// are set to -inf first. Per row, two passes over the thread's 64 values:
// the max, reduced over the quad; then (after the label logit, in a
// branch only the label's thread takes) the sum of exp(x - max) and the
// first column that holds the max. Each value dies at its last use, so
// the epilogue fits the consumers' registers.
struct FwdEpi {
  const int* labels;
  float* ll;
  Partials part;
  int T, V, n_tiles;

  __device__ __forceinline__ void row(const float (&acc)[wg::ACC], int h, int t,
                                      int vq, int col0, int q) const {
    float m = -INFINITY;
#pragma unroll
    for (int j = 0; j < wg::ACC / 4; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) m = fmaxf(m, acc[4 * j + 2 * h + c]);
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
    // column 0 of the tile is below V, so m is finite here
    const int lc = (t < T ? labels[t] : -1) - vq;  // the label's column here
    if (lc >= 0 && lc < 8 * (wg::ACC / 4) && lc % 8 < 2) {
      float lv = 0.f;
#pragma unroll
      for (int j = 0; j < wg::ACC / 4; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          if (8 * j + c == lc) lv = acc[4 * j + 2 * h + c];
      ll[t] = lv;  // one thread of the grid holds the label's column
    }
    float s = 0.f;
    int arg = INT_MAX;
#pragma unroll
    for (int j = wg::ACC / 4 - 1; j >= 0; --j)  // downwards: the last hit is the first column
#pragma unroll
      for (int c = 1; c >= 0; --c) {
        const float x = acc[4 * j + 2 * h + c];
        s += exp2f((x - m) * LOG2E);
        if (x == m) arg = vq + 8 * j + c;
      }
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    arg = min(arg, __shfl_xor_sync(0xffffffffu, arg, 1));
    arg = min(arg, __shfl_xor_sync(0xffffffffu, arg, 2));
    if (t < T && q == h) {
      const long long i = static_cast<long long>(t) * n_tiles + col0 / wg::BN;
      part.m[i] = m;
      part.s[i] = s;
      part.arg[i] = arg;
    }
  }

  __device__ void operator()(float (&acc)[wg::ACC], int row0, int col0,
                             const wg::Out& out) const {
    const int q = out.tid % 4;
    const int r = row0 + 16 * (out.tid / 32) + (out.tid % 32) / 4;
    const int vq = col0 + 2 * q;  // vocab row of this thread's column 0
    if (col0 + wg::BN > V) {
#pragma unroll
      for (int j = 0; j < wg::ACC / 4; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          if (vq + 8 * j + c >= V) acc[4 * j + c] = acc[4 * j + 2 + c] = -INFINITY;
    }
    row(acc, 0, r, vq, col0, q);
    row(acc, 1, r + 8, vq, col0, q);
  }
};

// (m, s, arg) <- the fold of two partials; the same bits either way round,
// so the lanes of an xor tree agree. Equal maxima keep the smaller index.
__device__ __forceinline__ void fold(float& m, float& s, int& arg, float om,
                                     float os, int oa) {
  const float mx = fmaxf(m, om);
  if (mx == -INFINITY) return;  // both empty
  s = s * expf(m - mx) + os * expf(om - mx);
  if (om > m || (om == m && oa < arg)) arg = oa;
  m = mx;
}

// One warp per token: lane l folds tiles l, l + 32, ... in order, then
// the lanes fold in a fixed xor tree. Labels < 0 (or >= V, which no
// GEMM thread holds) get ll = 0.
__global__ void __launch_bounds__(32 * COMBINE_WARPS)
fused_ce_combine_kernel(Partials part, const int* __restrict__ labels,
                        float* __restrict__ lse, float* __restrict__ ll,
                        long long* __restrict__ argmax, int Tn, int V,
                        int n_tiles) {
  const int t = blockIdx.x * COMBINE_WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (t >= Tn) return;  // the whole warp
  const long long base = static_cast<long long>(t) * n_tiles;
  float m = -INFINITY, s = 0.f;
  int arg = INT_MAX;
  for (int i = lane; i < n_tiles; i += 32)
    fold(m, s, arg, part.m[base + i], part.s[base + i], part.arg[base + i]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float om = __shfl_xor_sync(0xffffffffu, m, off);
    const float os = __shfl_xor_sync(0xffffffffu, s, off);
    const int oa = __shfl_xor_sync(0xffffffffu, arg, off);
    fold(m, s, arg, om, os, oa);
  }
  if (lane == 0) {
    lse[t] = m + logf(s);
    argmax[t] = arg;
    const int lab = labels[t];
    if (lab < 0 || lab >= V) ll[t] = 0.f;
  }
}

// The GEMM launch with FwdEpi, then the combine launch; `part` holds
// T x ceil(V / 256) partials.
int launch_fwd_tc(const void* h, const void* E, const int* labels, float* lse,
                  float* ll, long long* argmax, Partials part, int Tn, int V,
                  int D, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (D % 8 != 0) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  CUtensorMap h_k, e_k;  // both K-major: H (T, D) and E (V, D)
  if (!(wg::bf16_map(&h_k, h, Tn, D, wg::BK, wg::BM) &&
        wg::bf16_map(&e_k, E, V, D, wg::BK, wg::BN)))
    return cudaErrorInvalidValue;
  const int n_tiles = cdiv(V, wg::BN);
  const FwdEpi epi{labels, ll, part, Tn, V, n_tiles};
  // (the epilogue stores directly: the output map is unused)
  err = wg::launch_gemm<false, false>(h_k, e_k, h_k, 0, 0, 0, cdiv(D, wg::BK),
                                      cdiv(Tn, wg::BM), n_tiles, epi, st, FWD_BAND);
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_ce_combine_kernel<<<cdiv(Tn, COMBINE_WARPS), 32 * COMBINE_WARPS, 0, st>>>(
      part, labels, lse, ll, argmax, Tn, V, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bf16 forward: `pm`, `ps`, `parg` the (T, ceil(V / 256)) partial planes
// (f32 max, f32 sum, int32 argmax).
extern "C" int repro_fused_ce_fwd_bf16(const void* h, const void* E,
                                       const int* labels, float* lse, float* ll,
                                       long long* argmax, void* pm, void* ps,
                                       void* parg, int Tn, int V, int D,
                                       int device, void* stream) {
  const Partials part{static_cast<float*>(pm), static_cast<float*>(ps),
                      static_cast<int*>(parg)};
  return launch_fwd_tc(h, E, labels, lse, ll, argmax, part, Tn, V, D, device,
                       stream);
}

extern "C" int repro_fused_ce_fwd_f32(const void* h, const void* E,
                                      const int* labels, float* lse, float* ll,
                                      long long* argmax, int Tn, int V, int D,
                                      int device, void* stream) {
  return launch_fwd(h, E, labels, lse, ll, argmax, Tn, V, D, device, stream);
}

// bf16 backward: `p` the (T, Vc) bf16 scratch, `sum` the (T, D) f32
// scratch (dH with more than one chunk; null otherwise).
extern "C" int repro_fused_ce_bwd_dh_bf16(const void* h, const void* E,
                                          const int* labels, const float* lse,
                                          const float* g_lse, const float* g_ll,
                                          void* dh, void* p, void* sum, int Tn,
                                          int V, int D, int Vc, int device,
                                          void* stream) {
  return launch_bwd_tc<false>(h, E, labels, lse, g_lse, g_ll, dh, p,
                              static_cast<float*>(sum), Tn, V, D, Vc, device, stream);
}

extern "C" int repro_fused_ce_bwd_dh_f32(const void* h, const void* E,
                                         const int* labels, const float* lse,
                                         const float* g_lse, const float* g_ll,
                                         void* dh, int Tn, int V, int D,
                                         int device, void* stream) {
  return launch_bwd<false>(h, E, labels, lse, g_lse, g_ll, dh, Tn, V, D, device,
                           stream);
}

extern "C" int repro_fused_ce_bwd_de_bf16(const void* h, const void* E,
                                          const int* labels, const float* lse,
                                          const float* g_lse, const float* g_ll,
                                          void* de, void* p, void* sum, int Tn,
                                          int V, int D, int Vc, int device,
                                          void* stream) {
  return launch_bwd_tc<true>(h, E, labels, lse, g_lse, g_ll, de, p,
                             static_cast<float*>(sum), Tn, V, D, Vc, device, stream);
}

extern "C" int repro_fused_ce_bwd_de_f32(const void* h, const void* E,
                                         const int* labels, const float* lse,
                                         const float* g_lse, const float* g_ll,
                                         void* de, int Tn, int V, int D,
                                         int device, void* stream) {
  return launch_bwd<true>(h, E, labels, lse, g_lse, g_ll, de, Tn, V, D, device,
                          stream);
}
