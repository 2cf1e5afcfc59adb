// B2 paged decode attend for Hopper (sm_90a): single-query GQA attention
// over a KV block pool, split along the KV length ("flash-decoding").
//
// Replaces: src/repro/kernels/paged_attention/kernel.py
// `paged_decode_kernel` (pallas_call at :66). The Pallas grid (S, MB)
// walks EVERY table entry and carries the online-softmax state (m, l, acc)
// across the sequential MB axis in VMEM; unallocated entries fetch the
// sink block and are masked. On Hopper the blocks of a grid run in
// parallel and nothing carries over between them, so the history is cut
// into splits of one table block each, a CUDA block per split, and a
// second launch folds their partials:
//
// * paged_decode_split_kernel, grid S * KV * nsplit: one block per
//   (slot, KV head, split) holds the G query rows of that head. The grid
//   is sized from MB on the host (nsplit = max(1, MB), never from pos,
//   which would cost a device sync per layer); a block whose split starts
//   past pos[s] exits at once, and one whose table entry is a hole writes
//   an empty partial without reading K or V. It walks its BL tokens in
//   rounds of rt = (128 / team) * R:
//   - every thread first issues all of its round's K and V loads, 16 bytes
//     each (a team of up to 32 lanes covers one head_dim row: 16 lanes at
//     hd = 128 in bf16; at hd = 120 the 16th lane is idle), then uses them;
//   - a team scores its tokens against all G query rows at once (shuffle
//     sum within the team), so each (g, t) score is computed once;
//   - one warp per query row takes the round's max, computes each exp
//     once per (g, t) into shared memory, and rescales (m, l);
//   - each thread owns head_dim columns and accumulates P V from the V
//     rows staged in shared memory; softmax and P V are float32.
//   Entries with table < 0 or >= NBp are never read (a NaN in the sink
//   reaches no slot); tokens past pos are masked. Each split
//   writes (m, l, acc[hd]) per query row to f32 scratch the wrapper
//   allocates.
// * paged_decode_combine_kernel, grid S * KV: folds the splits that hold
//   tokens <= pos (a warp per query row takes m = max m_i and the weights
//   e^(m_i - m) and l in one pass, then every thread sums its columns in
//   split order, the loads of 8 splits issued together) and writes
//   acc / max(l, 1e-30), so a slot with no valid entry returns zeros.
//   Fixed order: a relaunch gives the same bits.
//
// Bound: it reads S * L * KV * hd * 2 * 2 bytes of K and V (4 KiB per
// token at qwen3-0.6b widths) and does ~4 FLOP per byte, so it is bound by
// memory (3.35 TB/s). At the serve loop's S = 4 slots the old one-block-
// per-(slot, head) grid was 32 blocks walking up to 15 blocks each one
// after another; here each split's loads are in flight together, and at
// MB = 72, BL = 16 the grid is 32 x 72 blocks of which those below pos run.
#include <cuda_bf16.h>

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int MAX_G = 8;       // query rows per KV head (GQA group)
constexpr int THREADS = 128;
constexpr float NEG_INF = -1e30f;  // the running max's start, as the reference

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// 16 bytes as floats: 8 bf16 or 4 f32.
__device__ __forceinline__ void unpack(const uint4& u, float* f, __nv_bfloat16) {
  const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 x = __bfloat1622float2(b[j]);
    f[2 * j] = x.x;
    f[2 * j + 1] = x.y;
  }
}
__device__ __forceinline__ void unpack(const uint4& u, float* f, float) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}

// Shape facts shared by the kernel and its launcher. HDMAX bounds head_dim.
template <typename T, int HDMAX>
struct Cfg {
  static constexpr int VE = 16 / sizeof(T);  // elements in 16 bytes
  static constexpr int NV = HDMAX / (32 * VE) > 1 ? HDMAX / (32 * VE) : 1;  // vectors a lane holds per row
  static constexpr int R = NV >= 4 ? 1 : 4 / NV;  // tokens a team takes per round
  static constexpr int NC = HDMAX / THREADS;      // head_dim columns a thread owns in P V

  // lanes covering one row: the 16-byte vectors of a row, rounded up to a
  // power of two, at most a warp. Where hd / VE is not a power of two
  // (hd = 120 in bf16: 15 vectors, a team of 16) the lanes past the row's
  // last vector load nothing and add 0 to the team's score sum (v < nvec
  // below), and in P V and the combine a column past hd is never touched
  // (col < hd), so the tail is masked at every step.
  __host__ __device__ static int team(int hd) {
    const int nvec = hd / VE;
    int t = 1;
    while (t < nvec && t < 32) t <<= 1;
    return t;
  }
  __host__ __device__ static int round_tokens(int hd) { return THREADS / team(hd) * R; }
  static size_t smem_bytes(int G, int hd) {
    const int rt = round_tokens(hd);
    return sizeof(T) * static_cast<size_t>(G + rt) * hd +
           sizeof(float) * (static_cast<size_t>(MAX_G) * rt + 3 * MAX_G);
  }
};

template <typename T, int HDMAX>
__global__ void __launch_bounds__(THREADS)
paged_decode_split_kernel(const T* __restrict__ q,       // (S, KV, G, hd)
                          const T* __restrict__ k_pool,  // (NBp, BL, KV, hd)
                          const T* __restrict__ v_pool,
                          const int* __restrict__ table,  // (S, MB)
                          const int* __restrict__ pos,    // (S,)
                          float* __restrict__ part,       // (S, KV, G, nsplit, hd + 2)
                          int KV, int G, int hd, int BL, int MB, int NBp, int nsplit,
                          float scale) {
  using C = Cfg<T, HDMAX>;
  constexpr int VE = C::VE, NV = C::NV, R = C::R, NC = C::NC;
  const int sh = blockIdx.x / nsplit;  // s * KV + h
  const int split = blockIdx.x % nsplit;  // table entry `split`
  const int s = sh / KV, h = sh % KV;
  const int p = pos[s];
  const int t0 = split * BL;
  if (t0 > p) return;  // nothing of this split is <= pos (all of it when p < 0)
  int phys = split < MB ? table[static_cast<long long>(s) * MB + split] : -1;
  if (phys >= NBp) phys = -1;  // out of the pool: skipped like a hole
  const int t1 = phys < 0 ? t0 : min(t0 + BL, p + 1);  // tokens [t0, t1)

  const int nvec = hd / VE;
  const int team_size = C::team(hd);
  const int nteams = THREADS / team_size;
  const int rt = nteams * R;
  const int team = threadIdx.x / team_size, lane = threadIdx.x % team_size;
  const int warp = threadIdx.x / 32, wlane = threadIdx.x % 32;

  extern __shared__ uint4 smem[];
  T* q_s = reinterpret_cast<T*>(smem);                // [G][hd]
  T* v_s = q_s + G * hd;                              // [rt][hd] this round's V rows
  float* sc = reinterpret_cast<float*>(v_s + rt * hd);  // [MAX_G][rt] scores, then P
  float* m_s = sc + MAX_G * rt;                       // [MAX_G] running max
  float* l_s = m_s + MAX_G;                           // [MAX_G] running sum
  float* corr_s = l_s + MAX_G;                        // [MAX_G] this round's rescale

  float acc[MAX_G][NC];
#pragma unroll
  for (int g = 0; g < MAX_G; ++g)
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[g][j] = 0.f;
  const long long tok = static_cast<long long>(KV) * hd;  // token stride in the pool
  // this split's rows of head h (block 0 for a hole, never read)
  const long long blk = (static_cast<long long>(max(phys, 0)) * BL * KV + h) * hd;
  const T* k_blk = k_pool + blk;
  const T* v_blk = v_pool + blk;
  if (threadIdx.x < MAX_G) {  // thread g writes row g's (m, l) at the end
    m_s[threadIdx.x] = NEG_INF;
    l_s[threadIdx.x] = 0.f;
  }

  for (int r0 = t0; r0 < t1; r0 += rt) {
    // 1. issue every K and V load of this thread's tokens, then use them
    uint4 kr[R][NV], vr[R][NV];
    bool ok[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int t = r0 + team + r * nteams;
      ok[r] = t < t1;
      const long long base = (t - t0) * tok;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int v = lane + team_size * i;
        if (ok[r] && v < nvec) {
          kr[r][i] = __ldg(reinterpret_cast<const uint4*>(k_blk + base) + v);
          vr[r][i] = __ldg(reinterpret_cast<const uint4*>(v_blk + base) + v);
        } else {
          kr[r][i] = make_uint4(0, 0, 0, 0);
          vr[r][i] = make_uint4(0, 0, 0, 0);
        }
      }
    }
    if (r0 == t0) {  // q into shared memory while the loads are in flight
      const long long qo = static_cast<long long>(sh) * G * hd;
      for (int i = threadIdx.x; i < G * hd; i += THREADS) q_s[i] = q[qo + i];
      __syncthreads();
    }
    // 2. V rows into shared memory (zeros for masked tokens); scores of
    // each token against all G rows, once
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int tl = team + r * nteams;
      float part_g[MAX_G];
#pragma unroll
      for (int g = 0; g < MAX_G; ++g) part_g[g] = 0.f;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int v = lane + team_size * i;
        if (v >= nvec) continue;
        reinterpret_cast<uint4*>(v_s + tl * hd)[v] = vr[r][i];
        float kf[VE];
        unpack(kr[r][i], kf, T());
#pragma unroll
        for (int g = 0; g < MAX_G; ++g) {
          if (g >= G) break;
          float qf[VE];
          unpack(reinterpret_cast<const uint4*>(q_s + g * hd)[v], qf, T());
#pragma unroll
          for (int e = 0; e < VE; ++e) part_g[g] = fmaf(qf[e], kf[e], part_g[g]);
        }
      }
#pragma unroll
      for (int g = 0; g < MAX_G; ++g) {
        if (g >= G) break;
        float x = part_g[g];
        for (int off = team_size / 2; off > 0; off >>= 1)
          x += __shfl_xor_sync(0xffffffffu, x, off);
        if (lane == 0) sc[g * rt + tl] = ok[r] ? x * scale : -INFINITY;
      }
    }
    __syncthreads();
    // 3. one warp per query row: the round's max, each exp once, (m, l)
    const int n_in = min(rt, t1 - r0);
    for (int g = warp; g < G; g += THREADS / 32) {
      float* row = sc + g * rt;
      float mx = NEG_INF;
      for (int tl = wlane; tl < n_in; tl += 32) mx = fmaxf(mx, row[tl]);
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int tl = wlane; tl < n_in; tl += 32) {
        const float pr = expf(row[tl] - m_new);  // masked: exp(-inf) = 0
        row[tl] = pr;
        sum += pr;
      }
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (wlane == 0) {
        const float c = expf(m_old - m_new);
        corr_s[g] = c;
        l_s[g] = l_s[g] * c + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();
    // 4. P V: this thread's columns, over the round's tokens in order
#pragma unroll
    for (int g = 0; g < MAX_G; ++g) {
      if (g >= G) break;
      const float c = corr_s[g];
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[g][j] *= c;
    }
    for (int tl = 0; tl < n_in; ++tl) {
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int col = threadIdx.x + THREADS * j;
        if (col >= hd) break;
        const float vv = to_f32(v_s[tl * hd + col]);
#pragma unroll
        for (int g = 0; g < MAX_G; ++g) {
          if (g >= G) break;
          acc[g][j] = fmaf(sc[g * rt + tl], vv, acc[g][j]);
        }
      }
    }
    __syncthreads();  // v_s and sc are rewritten by the next round
  }

#pragma unroll  // (a runtime index into acc would put it in local memory)
  for (int g = 0; g < MAX_G; ++g) {
    if (g >= G) break;
    float* dst = part + ((static_cast<long long>(sh) * G + g) * nsplit + split) * (hd + 2);
    if (threadIdx.x == g) {  // (no token at all: its own initial values)
      dst[0] = m_s[g];
      dst[1] = l_s[g];
    }
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int col = threadIdx.x + THREADS * j;
      if (col < hd) dst[2 + col] = acc[g][j];
    }
  }
}

constexpr int FOLD_BATCH = 8;  // splits whose loads the combine issues together

// Folds the splits of one (slot, KV head). `part` is rewritten in place:
// each split's m becomes its weight e^(m_i - m).
template <typename T>
__global__ void __launch_bounds__(THREADS)
paged_decode_combine_kernel(float* __restrict__ part, const int* __restrict__ pos,
                            T* __restrict__ out, int KV, int G, int hd, int BL,
                            int nsplit) {
  __shared__ float inv_l[MAX_G];
  const int sh = blockIdx.x;
  const int p = pos[sh / KV];
  // the splits that ran: those starting at or below pos
  const int ns = p < 0 ? 0 : min(p / BL + 1, nsplit);
  const int stride = hd + 2;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // one warp per query row: m = max m_i, w_i = e^(m_i - m), l = sum l_i w_i
  for (int g = warp; g < G; g += THREADS / 32) {
    float* src = part + (static_cast<long long>(sh) * G + g) * nsplit * stride;
    float m = NEG_INF;
    for (int i = lane; i < ns; i += 32) m = fmaxf(m, src[i * stride]);
    for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float l = 0.f;
    for (int i = lane; i < ns; i += 32) {
      const float w = expf(src[i * stride] - m);
      l = fmaf(src[i * stride + 1], w, l);
      src[i * stride] = w;
    }
    for (int off = 16; off > 0; off >>= 1) l += __shfl_xor_sync(0xffffffffu, l, off);
    if (lane == 0) inv_l[g] = 1.f / fmaxf(l, 1e-30f);
  }
  __syncthreads();
  for (int g = 0; g < G; ++g) {
    const float* src = part + (static_cast<long long>(sh) * G + g) * nsplit * stride;
    for (int col = threadIdx.x; col < hd; col += THREADS) {
      float a = 0.f;
      for (int i0 = 0; i0 < ns; i0 += FOLD_BATCH) {
        float w[FOLD_BATCH], x[FOLD_BATCH];
#pragma unroll
        for (int b = 0; b < FOLD_BATCH; ++b) {
          const bool in = i0 + b < ns;
          w[b] = in ? src[(i0 + b) * stride] : 0.f;
          x[b] = in ? src[(i0 + b) * stride + 2 + col] : 0.f;
        }
#pragma unroll
        for (int b = 0; b < FOLD_BATCH; ++b)
          if (i0 + b < ns) a = fmaf(w[b], x[b], a);
      }
      store(out + (static_cast<long long>(sh) * G + g) * hd + col, a * inv_l[g]);
    }
  }
}

template <typename T, int HDMAX>
int launch_hd(const T* q, const T* k, const T* v, const int* table, const int* pos,
              float* part, T* out, int S, int KV, int G, int hd, int BL, int MB, int NBp,
              int nsplit, float scale, cudaStream_t st) {
  using C = Cfg<T, HDMAX>;
  const size_t smem = C::smem_bytes(G, hd);
  auto kernel = paged_decode_split_kernel<T, HDMAX>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<S * KV * nsplit, THREADS, smem, st>>>(q, k, v, table, pos, part, KV, G, hd, BL,
                                                  MB, NBp, nsplit, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  paged_decode_combine_kernel<T><<<S * KV, THREADS, 0, st>>>(part, pos, out, KV, G, hd, BL,
                                                              nsplit);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* table, const int* pos,
           float* part, void* out, int S, int KV, int G, int hd, int BL, int MB, int NBp,
           int nsplit, float scale, int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  // head_dim: whole 16-byte vectors (8 bf16 or 4 f32); a row that is not a
  // power-of-two number of vectors leaves the tail lanes of its team idle
  if (G < 1 || G > MAX_G || hd % (16 / static_cast<int>(sizeof(T))) || hd > 1024 ||
      S < 1 || KV < 1 ||
      reinterpret_cast<uintptr_t>(k) % 16 || reinterpret_cast<uintptr_t>(v) % 16)
    return cudaErrorInvalidValue;
  // one split per table entry, at least one (the wrapper's decode_splits)
  if (nsplit < 1 || nsplit < MB || static_cast<long long>(S) * KV * nsplit > 0x7fffffffll)
    return cudaErrorInvalidValue;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd <= 128)
    return launch_hd<T, 128>(qt, kt, vt, table, pos, part, ot, S, KV, G, hd, BL, MB, NBp,
                             nsplit, scale, st);
  if (hd <= 256)
    return launch_hd<T, 256>(qt, kt, vt, table, pos, part, ot, S, KV, G, hd, BL, MB, NBp,
                             nsplit, scale, st);
  if (hd <= 512)
    return launch_hd<T, 512>(qt, kt, vt, table, pos, part, ot, S, KV, G, hd, BL, MB, NBp,
                             nsplit, scale, st);
  return launch_hd<T, 1024>(qt, kt, vt, table, pos, part, ot, S, KV, G, hd, BL, MB, NBp,
                            nsplit, scale, st);
}

}  // namespace

extern "C" int repro_paged_decode_bf16(const void* q, const void* k, const void* v,
                                       const int* table, const int* pos, float* part,
                                       void* out, int S, int KV, int G, int hd, int BL,
                                       int MB, int NBp, int nsplit, float scale, int device,
                                       void* stream) {
  return launch<__nv_bfloat16>(q, k, v, table, pos, part, out, S, KV, G, hd, BL, MB, NBp,
                               nsplit, scale, device, stream);
}

extern "C" int repro_paged_decode_f32(const void* q, const void* k, const void* v,
                                      const int* table, const int* pos, float* part,
                                      void* out, int S, int KV, int G, int hd, int BL,
                                      int MB, int NBp, int nsplit, float scale, int device,
                                      void* stream) {
  return launch<float>(q, k, v, table, pos, part, out, S, KV, G, hd, BL, MB, NBp, nsplit,
                       scale, device, stream);
}
