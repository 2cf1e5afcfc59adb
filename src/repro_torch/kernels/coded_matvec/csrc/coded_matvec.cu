// B1 coded matvec for Hopper (sm_90a): Y = A X, with two entry points.
//
// Replaces: src/repro/kernels/coded_matvec/kernel.py `matvec_kernel`
// (pallas_call at :48), which computes one y = A x in (256, 1024) tiles,
// vmapped over the workers by ops.py:30 (`blocked_matvec_batch`) and over
// the B*R logit columns by the reference serve loop
// (src/repro/runtime/serve_loop.py:199-207).
//
// 1. repro_coded_matvec_f32 (N > 8): the coded head's block mix Y = G X.
//    Main-path shape: A = G (nb=738, kb=594) f32, X = logit blocks
//    (594, S*256) f32, S=4: 0.9 GFLOP against 7.2 MB, so it is bound by
//    float32 operations (67 TFLOP/s SIMT, 13.4 us), not by memory. No
//    TF32: Y feeds the f32 erasure solve. The mainloop is pipe_sgemm.cuh's
//    at B3's 128 x 256 tile (cp.async ring, float4 fragments, 8 x 16
//    outputs a lane). The output is small: 24 tiles for 132 SMs. So K is
//    split too: the Python wrapper (ops.py, gemm_plan) picks the split
//    count from (M, N, K) and the SM count, the partials go to scratch the
//    wrapper allocates, and a second launch sums them in split order
//    (bit-identical on every launch, no atomics).
//
// 2. repro_coded_matvec_narrow_f32 (N <= 8): the paper's own matvec, the
//    workers' packed coded rows times one vector (W*L, D) x (D,). At the
//    quickstart fleet's shape (200 workers x 203 rows, D = 4,096) A is
//    665 MB read once against 2 flops a float: bound by bytes (0.199 ms at
//    3.35 TB/s). The SGEMM tile would compute 256 output columns of which
//    N are live, so this branch streams A instead:
//    * a warp owns ROWS (1) row at a time and reads it with 16-byte loads
//      (when K % 4 == 0 and A is 16-byte aligned; 4-byte loads otherwise),
//      UNROLL (8) independent loads in flight a lane, so the card keeps
//      enough bytes in flight to cover the memory latency (the fastest of
//      the ROWS x UNROLL x warps layouts compared on the card);
//    * X is staged in shared memory once a block, transposed to [n][k] so
//      a lane's 4 k's of one column are one float4, and tiled along K when
//      N K floats exceed 32 KB (then restaged for each row group);
//    * blocks are persistent (as many as fit on the card), walking the row
//      groups in a grid-stride loop, so no partial last wave idles SMs;
//    * each lane sums its k's in a fixed order in f32 and the warp adds the
//      lanes with a fixed butterfly of shuffles: a row's result does not
//      depend on which block took it, so a relaunch gives the same bits.
#include "common.cuh"
#include "pipe_sgemm.cuh"

extern "C" int repro_coded_matvec_f32(const float* a, const float* x, float* y,
                                      float* scratch, int m, int n, int k, int per_split,
                                      int splits, long long stride, int device,
                                      void* stream) {
  return psg::launch_pipe_sgemm<psg::Tile<128, 256, 4, 1>>(
      a, x, y, scratch, m, n, k, per_split, splits, stride, device, stream);
}

namespace narrow {

constexpr int WARPS = 8;               // warps a block
constexpr int ROWS = 1;                // rows a warp owns at a time
constexpr int UNROLL = 8;              // loads in flight a row and lane
constexpr int SMEM_FLOATS = 8192;      // 32 KB of staged X a block, at most
constexpr int MAX_N = 8;

// X[k0:k0+len, :] (row-major, n columns) -> xs[c * ktile + (k - k0)].
template <int N>
__device__ __forceinline__ void stage_x(float* xs, const float* __restrict__ X, int k0,
                                        int len, int ktile) {
  for (int e = threadIdx.x; e < len * N; e += WARPS * 32) {
    const int kk = e / N, c = e % N;
    xs[c * ktile + kk] = X[static_cast<long long>(k0 + kk) * N + c];
  }
}

template <int N, bool VEC>
__global__ void __launch_bounds__(WARPS * 32)
narrow_matvec_kernel(const float* __restrict__ A, const float* __restrict__ X,
                     float* __restrict__ Y, int M, int K, int ktile) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);  // [N][ktile]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ktiles = (K + ktile - 1) / ktile;
  const long long groups = (static_cast<long long>(M) + WARPS * ROWS - 1) / (WARPS * ROWS);
  for (long long grp = blockIdx.x; grp < groups; grp += gridDim.x) {
    const long long row0 = grp * (WARPS * ROWS) + warp * ROWS;
    float acc[ROWS][N];
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
      for (int c = 0; c < N; ++c) acc[r][c] = 0.f;
    for (int t = 0; t < ktiles; ++t) {
      const int k0 = t * ktile, len = min(ktile, K - k0);
      if (ktiles > 1 || grp == blockIdx.x) {  // uniform across the block
        __syncthreads();                       // every warp is done with the last tile
        stage_x<N>(xs, X, k0, len, ktile);
        __syncthreads();
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const long long row = row0 + r;
        if (row >= M) continue;  // the whole warp skips together
        const float* arow = A + row * K + k0;
        if constexpr (VEC) {
          // len % 4 == 0: K % 4 == 0 and ktile % 128 == 0
          const float4* a4 = reinterpret_cast<const float4*>(arow);
          const int nv = len / 4;
          for (int v0 = lane; v0 < nv; v0 += 32 * UNROLL) {
            float4 av[UNROLL];
#pragma unroll
            for (int u = 0; u < UNROLL; ++u) {
              const int v = v0 + 32 * u;
              av[u] = v < nv ? __ldcs(a4 + v) : make_float4(0.f, 0.f, 0.f, 0.f);
            }
#pragma unroll
            for (int u = 0; u < UNROLL; ++u) {
              const int v = v0 + 32 * u;
              if (v < nv) {
#pragma unroll
                for (int c = 0; c < N; ++c) {
                  const float4 xv = *reinterpret_cast<const float4*>(xs + c * ktile + 4 * v);
                  float s = acc[r][c];
                  s = fmaf(av[u].x, xv.x, s);
                  s = fmaf(av[u].y, xv.y, s);
                  s = fmaf(av[u].z, xv.z, s);
                  s = fmaf(av[u].w, xv.w, s);
                  acc[r][c] = s;
                }
              }
            }
          }
        } else {
          for (int k1 = lane; k1 < len; k1 += 32 * UNROLL) {
            float av[UNROLL];
#pragma unroll
            for (int u = 0; u < UNROLL; ++u) {
              const int kk = k1 + 32 * u;
              av[u] = kk < len ? __ldcs(arow + kk) : 0.f;
            }
#pragma unroll
            for (int u = 0; u < UNROLL; ++u) {
              const int kk = k1 + 32 * u;
              if (kk < len) {
#pragma unroll
                for (int c = 0; c < N; ++c)
                  acc[r][c] = fmaf(av[u], xs[c * ktile + kk], acc[r][c]);
              }
            }
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const long long row = row0 + r;
#pragma unroll
      for (int c = 0; c < N; ++c) {
        float s = acc[r][c];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
        if (lane == c && row < M) Y[row * N + c] = s;
      }
    }
  }
}

// X columns of one K tile: the widest multiple of 128 k's whose N columns
// fit in SMEM_FLOATS, and no wider than K (rounded up to 4).
inline int tile_k(int n, int k) {
  const int cap = SMEM_FLOATS / n / 128 * 128;
  const int need = (k + 3) / 4 * 4;
  return need < cap ? need : cap;
}

template <int N, bool VEC>
int launch(const float* a, const float* x, float* y, int m, int k, cudaStream_t st) {
  auto kernel = narrow_matvec_kernel<N, VEC>;
  const int ktile = tile_k(N, k);
  const size_t smem = static_cast<size_t>(N) * ktile * sizeof(float);
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, WARPS * 32, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long groups = (static_cast<long long>(m) + WARPS * ROWS - 1) / (WARPS * ROWS);
  const long long resident = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  const unsigned grid = static_cast<unsigned>(groups < resident ? groups : resident);
  kernel<<<grid, WARPS * 32, smem, st>>>(a, x, y, m, k, ktile);
  return static_cast<int>(cudaGetLastError());
}

template <bool VEC>
int dispatch(const float* a, const float* x, float* y, int m, int n, int k,
             cudaStream_t st) {
  switch (n) {
    case 1: return launch<1, VEC>(a, x, y, m, k, st);
    case 2: return launch<2, VEC>(a, x, y, m, k, st);
    case 3: return launch<3, VEC>(a, x, y, m, k, st);
    case 4: return launch<4, VEC>(a, x, y, m, k, st);
    case 5: return launch<5, VEC>(a, x, y, m, k, st);
    case 6: return launch<6, VEC>(a, x, y, m, k, st);
    case 7: return launch<7, VEC>(a, x, y, m, k, st);
    case 8: return launch<8, VEC>(a, x, y, m, k, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace narrow

// Y (M, N) = A (M, K) X (K, N) for 1 <= N <= 8, all row-major f32.
extern "C" int repro_coded_matvec_narrow_f32(const float* a, const float* x, float* y,
                                             int m, int n, int k, int device,
                                             void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (m < 1 || k < 1 || n < 1 || n > narrow::MAX_N) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = k % 4 == 0 && psg::aligned16(a);
  return vec ? narrow::dispatch<true>(a, x, y, m, n, k, st)
             : narrow::dispatch<false>(a, x, y, m, n, k, st);
}
