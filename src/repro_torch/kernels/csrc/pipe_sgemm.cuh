// Pipelined float32 SGEMM for Hopper's SIMT cores: C[M,N] = A[M,K] B[K,N],
// all row-major. Full fp32 FMA, never TF32: the result feeds the float32
// erasure solve (DESIGN.md section 4), which amplifies input error by the
// condition number of the surviving generator rows.
//
// One block of 256 threads computes a BM x BN = 128 x 256 tile of C, one
// block per SM (128 accumulators a thread; 233-251 registers). Its eight
// warps sit 2 (M) x 4 (N), each on a 64 x 64 warp tile; a lane owns
// 8 x 16 outputs as 2 x 4 sub-tiles of 4 x 4 (rows 4 (lane / 4) + {0, 32},
// columns 4 (lane % 4) + {0, 16, 32, 48} of the warp tile), so each k step
// reads six float4 from shared memory for 128 FMAs. (128 x 128 tiles at
// two blocks an SM ran about 12% slower at the main-path shape.)
//
// K runs in slices of BK = 16 through a ring of STAGES shared-memory
// stages filled by cp.async: while slice k is multiplied, slices up to
// k + STAGES - 1 are in flight, with one __syncthreads per slice.
// * A (the small operand, which every block reads again from L2): 4-byte
//   copies, stored transposed as As[k][m] so a thread's 4 rows are one
//   float4 (rows padded by 4 floats against bank conflicts).
// * B: 16-byte copies when N % 4 == 0 and B and C are 16-byte aligned
//   (VEC), else 4-byte copies. Rows past K and columns past N copy zeros
//   (src-size 0), so any M, N, K works through the same kernel.
// Blocks walk the row bands of C fastest: the ceil(M / BM) blocks that
// read one BN-column slab of B run at the same time, and B, the large
// operand, comes from device memory once.
//
// Each output is one f32 FMA chain over k in order: no split K, no
// atomics, the same bits on every launch.
#pragma once
#include <cuda_runtime.h>

#include <cstdint>

namespace psg {

constexpr int BM = 128;
constexpr int BN = 256;
constexpr int BK = 16;
constexpr int STAGES = 4;
constexpr int THREADS = 256;
constexpr int MIN_BLOCKS = 1;  // blocks an SM holds
constexpr int NSUB = BN / 64;  // 4-column sub-tiles a lane owns, 16 apart
constexpr int LDA = BM + 4;  // As row stride (floats): 16-byte rows, 2-way conflicts
constexpr int A_STAGE = BK * LDA;
constexpr int B_STAGE = BK * BN;
constexpr int SMEM_BYTES = STAGES * (A_STAGE + B_STAGE) * 4;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copy `bytes` (0 or 4) of src to dst and zero-fill the rest of 4 bytes.
__device__ __forceinline__ void cp_async4(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

// Copy `bytes` (0 or 16) of src to dst and zero-fill the rest of 16 bytes.
__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Start the asynchronous copies of K slice `kt` into stage buffers As, Bs.
template <bool VEC>
__device__ __forceinline__ void load_slice(float* As, float* Bs,
                                           const float* __restrict__ A,
                                           const float* __restrict__ B, int M,
                                           int N, int K, int m0, int n0, int kt) {
  const int k0 = kt * BK;
#pragma unroll
  for (int i = 0; i < BM * BK / THREADS; ++i) {
    const int e = threadIdx.x + i * THREADS;
    const int m = e / BK, k = e % BK;  // a warp reads two rows' 16 k's
    const bool ok = m0 + m < M && k0 + k < K;
    cp_async4(As + k * LDA + m,
              ok ? A + static_cast<long long>(m0 + m) * K + k0 + k : A, ok ? 4 : 0);
  }
  if constexpr (VEC) {
#pragma unroll
    for (int i = 0; i < BK * BN / 4 / THREADS; ++i) {
      const int e = threadIdx.x + i * THREADS;
      const int k = e / (BN / 4), n = 4 * (e % (BN / 4));
      const bool ok = k0 + k < K && n0 + n < N;  // N % 4 == 0: all 4 or none
      cp_async16(Bs + k * BN + n,
                 ok ? B + static_cast<long long>(k0 + k) * N + n0 + n : B, ok ? 16 : 0);
    }
  } else {
#pragma unroll
    for (int i = 0; i < BK * BN / THREADS; ++i) {
      const int e = threadIdx.x + i * THREADS;
      const int k = e / BN, n = e % BN;
      const bool ok = k0 + k < K && n0 + n < N;
      cp_async4(Bs + k * BN + n,
                ok ? B + static_cast<long long>(k0 + k) * N + n0 + n : B, ok ? 4 : 0);
    }
  }
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
pipe_sgemm_kernel(const float* __restrict__ A, const float* __restrict__ B,
                  float* __restrict__ C, int M, int N, int K) {
  extern __shared__ float4 smem4[];
  float* As = reinterpret_cast<float*>(smem4);  // [STAGES][BK][LDA]
  float* Bs = As + STAGES * A_STAGE;            // [STAGES][BK][BN]
  const int m_tiles = (M + BM - 1) / BM;
  const int m0 = (blockIdx.x % m_tiles) * BM;   // row bands fastest
  const int n0 = (blockIdx.x / m_tiles) * BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wr = (warp / 4) * 64 + 4 * (lane / 4);  // first row in the tile
  const int wc = (warp % 4) * (BN / 4) + 4 * (lane % 4);  // first column in the tile

  float acc[8][4 * NSUB];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4 * NSUB; ++j) acc[i][j] = 0.f;

  const int ktiles = (K + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ktiles)
      load_slice<VEC>(As + s * A_STAGE, Bs + s * B_STAGE, A, B, M, N, K, m0, n0, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of slice kt landed
    __syncthreads();  // everyone's landed; everyone is done with slice kt - 1
    const int next = kt + STAGES - 1;
    if (next < ktiles) {
      const int s = next % STAGES;
      load_slice<VEC>(As + s * A_STAGE, Bs + s * B_STAGE, A, B, M, N, K, m0, n0, next);
    }
    cp_async_commit();  // (an empty group past the last slice keeps the count)
    const float* as = As + (kt % STAGES) * A_STAGE;
    const float* bs = Bs + (kt % STAGES) * B_STAGE;
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(as + k * LDA + wr);
      const float4 a1 = *reinterpret_cast<const float4*>(as + k * LDA + wr + 32);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      float b[4 * NSUB];
#pragma unroll
      for (int jh = 0; jh < NSUB; ++jh) {
        const float4 bj = *reinterpret_cast<const float4*>(bs + k * BN + wc + 16 * jh);
        b[4 * jh] = bj.x;
        b[4 * jh + 1] = bj.y;
        b[4 * jh + 2] = bj.z;
        b[4 * jh + 3] = bj.w;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4 * NSUB; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = m0 + wr + (i / 4) * 32 + i % 4;
    if (r >= M) continue;
    float* row = C + static_cast<long long>(r) * N;
#pragma unroll
    for (int jh = 0; jh < NSUB; ++jh) {
      const int c = n0 + wc + 16 * jh;
      if constexpr (VEC) {
        if (c < N)
          *reinterpret_cast<float4*>(row + c) =
              make_float4(acc[i][4 * jh], acc[i][4 * jh + 1], acc[i][4 * jh + 2],
                          acc[i][4 * jh + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c + j < N) row[c + j] = acc[i][4 * jh + j];
      }
    }
  }
}

// Launch on `stream` of `device`; returns the cudaError_t (0 = success).
inline int launch_pipe_sgemm(const float* A, const float* B, float* C, int M,
                             int N, int K, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec = N % 4 == 0 && reinterpret_cast<uintptr_t>(B) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(C) % 16 == 0;
  auto kernel = vec ? pipe_sgemm_kernel<true> : pipe_sgemm_kernel<false>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks =
      static_cast<long long>((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  if (blocks > 0x7fffffffll) return cudaErrorInvalidValue;
  kernel<<<static_cast<unsigned>(blocks), THREADS, SMEM_BYTES,
           static_cast<cudaStream_t>(stream)>>>(A, B, C, M, N, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace psg
