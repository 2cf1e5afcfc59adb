// B2 paged decode attend for Hopper (sm_90a): single-query GQA attention
// over a KV block pool.
//
// Replaces: src/repro/kernels/paged_attention/kernel.py
// `paged_decode_kernel` (pallas_call at :66). The Pallas grid (S, MB)
// walks EVERY table entry and carries the online-softmax state (m, l, acc)
// across the sequential MB axis in VMEM; unallocated entries fetch the
// sink block and are masked. On Hopper the blocks of a grid run in
// parallel, so the MB axis becomes a loop inside one CUDA block:
//
// * one block per (slot, KV head) holds the G query rows of that head;
//   one thread per output column d (blockDim = hd);
// * the block reads its own table entries (no scalar prefetch) and stops
//   at logical block pos[s] / BL: the serve loop passes a table as wide as
//   the whole pool, and every later entry is masked anyway;
// * unallocated entries (table < 0) are SKIPPED, never read and never
//   multiplied by zero: frozen and inactive rows scatter into the sink
//   block, and a NaN there must not reach any slot. A slot with no valid
//   entry returns zeros (l = 0, out = acc / max(l, 1e-30));
// * scores: warp w takes tokens w, w + nwarps, ... of the block, lanes
//   split head_dim, warp-shuffle reduction; softmax and the P V product
//   accumulate in float32 registers from bf16 K/V; the scale 1/sqrt(hd)
//   comes in as a host float, like the reference.
//
// Bound: it reads S * L * KV * hd * 2 * 2 bytes of K and V (4 KiB per
// token at qwen3-0.6b widths) and does ~4 FLOP per byte, so it is bound by
// memory (3.35 TB/s). At the serve loop's S = 4 slots the grid is only
// S * KV = 32 blocks and each walks its blocks sequentially: latency, not
// bandwidth, sets its time. Splitting L across blocks is later work.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int MAX_G = 8;  // query rows per KV head (GQA group)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T>
__global__ void paged_decode_kernel(const T* __restrict__ q,       // (S, KV, G, hd)
                                    const T* __restrict__ k_pool,  // (NBp, BL, KV, hd)
                                    const T* __restrict__ v_pool,
                                    const int* __restrict__ table,  // (S, MB)
                                    const int* __restrict__ pos,    // (S,)
                                    T* __restrict__ out,            // (S, KV, G, hd)
                                    int KV, int G, int hd, int BL, int MB,
                                    int NBp, float scale) {
  extern __shared__ float smem[];
  float* q_s = smem;          // [G][hd]
  float* sc = smem + G * hd;  // [G][BL] scores of the current block

  const int s = blockIdx.x / KV;
  const int h = blockIdx.x % KV;
  const int d = threadIdx.x;
  const int lane = d & 31;
  const int warp = d >> 5;
  const int nwarps = blockDim.x >> 5;
  const long long qo = static_cast<long long>(s * KV + h) * G * hd;
  for (int g = 0; g < G; ++g) q_s[g * hd + d] = to_f32(q[qo + g * hd + d]);

  float m[MAX_G], l[MAX_G], acc[MAX_G];
#pragma unroll
  for (int g = 0; g < MAX_G; ++g) {
    m[g] = -1e30f;
    l[g] = 0.f;
    acc[g] = 0.f;
  }
  const int p = pos[s];
  const int nblk = p < 0 ? 0 : min(p / BL + 1, MB);
  const long long tok = static_cast<long long>(KV) * hd;  // token stride
  __syncthreads();

  for (int j = 0; j < nblk; ++j) {
    const int phys = table[static_cast<long long>(s) * MB + j];
    if (phys < 0 || phys >= NBp) continue;  // unallocated: skipped
    const long long base = static_cast<long long>(phys) * BL * tok + h * hd;
    const T* kb = k_pool + base;
    const T* vb = v_pool + base;
    const int valid = min(BL, p - j * BL + 1);  // tokens <= pos in block j

    for (int t = warp; t < valid; t += nwarps) {
      float part[MAX_G];
#pragma unroll
      for (int g = 0; g < MAX_G; ++g) part[g] = 0.f;
      for (int e = lane; e < hd; e += 32) {
        const float kv = to_f32(kb[t * tok + e]);
#pragma unroll
        for (int g = 0; g < MAX_G; ++g)
          if (g < G) part[g] = fmaf(q_s[g * hd + e], kv, part[g]);
      }
#pragma unroll
      for (int g = 0; g < MAX_G; ++g) {
        if (g >= G) break;
        float v = part[g];
        for (int off = 16; off > 0; off >>= 1)
          v += __shfl_xor_sync(0xffffffffu, v, off);
        if (lane == 0) sc[g * BL + t] = v * scale;
      }
    }
    __syncthreads();

    float mx[MAX_G], sum[MAX_G], pv[MAX_G];
#pragma unroll
    for (int g = 0; g < MAX_G; ++g) {
      mx[g] = m[g];
      sum[g] = 0.f;
      pv[g] = 0.f;
      if (g < G)
        for (int t = 0; t < valid; ++t) mx[g] = fmaxf(mx[g], sc[g * BL + t]);
    }
    for (int t = 0; t < valid; ++t) {
      const float vv = to_f32(vb[t * tok + d]);
#pragma unroll
      for (int g = 0; g < MAX_G; ++g) {
        if (g >= G) break;
        const float pr = expf(sc[g * BL + t] - mx[g]);
        sum[g] += pr;
        pv[g] = fmaf(pr, vv, pv[g]);
      }
    }
#pragma unroll
    for (int g = 0; g < MAX_G; ++g) {
      const float corr = expf(m[g] - mx[g]);
      l[g] = l[g] * corr + sum[g];
      acc[g] = acc[g] * corr + pv[g];
      m[g] = mx[g];
    }
    __syncthreads();  // sc is rewritten by the next block's scores
  }

  for (int g = 0; g < G; ++g)
    store(out + qo + g * hd + d, acc[g] / fmaxf(l[g], 1e-30f));
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* table,
           const int* pos, void* out, int S, int KV, int G, int hd, int BL,
           int MB, int NBp, float scale, int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const size_t smem = sizeof(float) * static_cast<size_t>(G) * (hd + BL);
  paged_decode_kernel<T><<<S * KV, hd, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), table, pos, static_cast<T*>(out), KV, G, hd,
      BL, MB, NBp, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int repro_paged_decode_bf16(const void* q, const void* k,
                                       const void* v, const int* table,
                                       const int* pos, void* out, int S,
                                       int KV, int G, int hd, int BL, int MB,
                                       int NBp, float scale, int device,
                                       void* stream) {
  return launch<__nv_bfloat16>(q, k, v, table, pos, out, S, KV, G, hd, BL, MB,
                               NBp, scale, device, stream);
}

extern "C" int repro_paged_decode_f32(const void* q, const void* k,
                                      const void* v, const int* table,
                                      const int* pos, void* out, int S,
                                      int KV, int G, int hd, int BL, int MB,
                                      int NBp, float scale, int device,
                                      void* stream) {
  return launch<float>(q, k, v, table, pos, out, S, KV, G, hd, BL, MB, NBp,
                       scale, device, stream);
}
