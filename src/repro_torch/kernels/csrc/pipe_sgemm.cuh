// Pipelined float32 SGEMM for Hopper's SIMT cores: C[M,N] = A[M,K] B[K,N],
// all row-major. Full fp32 FMA, never TF32: the results feed the float32
// erasure solve (DESIGN.md section 4), which amplifies input error by the
// condition number of the surviving generator rows.
//
// A block of Tile::THREADS threads computes a BM x BN tile of C. Its warps
// sit (BM / 64) x (BN / 64), each on a 64 x 64 warp tile; a lane owns
// 8 x 16 outputs as 2 x 4 sub-tiles of 4 x 4 (rows 4 (lane / 4) + {0, 32},
// columns 4 (lane % 4) + {0, 16, 32, 48} of the warp tile), so each k step
// reads six float4 from shared memory for 128 FMAs (128 accumulators a
// thread; 233-251 registers).
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
// read one BN-column slab of B run at the same time, and B comes from
// device memory once.
//
// Split K: blockIdx.y picks a run of `per_split` K slices and its block
// writes that run's partial sum to C + blockIdx.y * c_split (c_split = 0
// when there is one split). split_sum_kernel then adds the partials in split
// order. Each partial is one f32 FMA chain over its k's in order, so
// every launch gives the same bits: no atomics anywhere.
//
// Both users instantiate Tile<128, 256, 4, 1>, one block an SM (128 x 128
// tiles at two blocks an SM ran about 12% slower on B3's shape): B3
// (mds_encode) with one split, B1 (coded_matvec) with the split count
// that Python picks per shape (kernels/coded_matvec/ops.py, gemm_plan).
#pragma once
#include <cuda_runtime.h>

#include <cstdint>

namespace psg {

constexpr int BK = 16;

template <int BM_, int BN_, int STAGES_, int MIN_BLOCKS_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, STAGES = STAGES_;
  static constexpr int MIN_BLOCKS = MIN_BLOCKS_;  // blocks an SM holds
  static constexpr int WN = BN / 64;              // warps across N
  static constexpr int THREADS = (BM / 64) * WN * 32;
  static constexpr int NSUB = 4;                  // 4-column sub-tiles a lane owns, 16 apart
  static constexpr int LDA = BM + 4;  // As row stride (floats): 16-byte rows, 2-way conflicts
  static constexpr int A_STAGE = BK * LDA;
  static constexpr int B_STAGE = BK * BN;
  static constexpr int SMEM_BYTES = STAGES * (A_STAGE + B_STAGE) * 4;
  static_assert(BM % 64 == 0 && BN % 64 == 0, "64 x 64 warp tiles");
  static_assert(BM * BK % THREADS == 0 && BK * BN / 4 % THREADS == 0, "even copies");
};

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
template <class TL, bool VEC>
__device__ __forceinline__ void load_slice(float* As, float* Bs,
                                           const float* __restrict__ A,
                                           const float* __restrict__ B, int M,
                                           int N, int K, int m0, int n0, int kt) {
  constexpr int BM = TL::BM, BN = TL::BN, THREADS = TL::THREADS;
  const int k0 = kt * BK;
#pragma unroll
  for (int i = 0; i < BM * BK / THREADS; ++i) {
    const int e = threadIdx.x + i * THREADS;
    const int m = e / BK, k = e % BK;  // a warp reads two rows' 16 k's
    const bool ok = m0 + m < M && k0 + k < K;
    cp_async4(As + k * TL::LDA + m,
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

template <class TL, bool VEC>
__global__ void __launch_bounds__(TL::THREADS, TL::MIN_BLOCKS)
pipe_sgemm_kernel(const float* __restrict__ A, const float* __restrict__ B,
                  float* __restrict__ C, int M, int N, int K, int per_split,
                  long long c_split) {
  constexpr int BM = TL::BM, BN = TL::BN, STAGES = TL::STAGES, NSUB = TL::NSUB;
  extern __shared__ float4 smem4[];
  float* As = reinterpret_cast<float*>(smem4);  // [STAGES][BK][LDA]
  float* Bs = As + STAGES * TL::A_STAGE;        // [STAGES][BK][BN]
  const int m_tiles = (M + BM - 1) / BM;
  const int m0 = (blockIdx.x % m_tiles) * BM;   // row bands fastest
  const int n0 = (blockIdx.x / m_tiles) * BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wr = (warp / TL::WN) * 64 + 4 * (lane / 4);  // first row in the tile
  const int wc = (warp % TL::WN) * 64 + 4 * (lane % 4);  // first column in the tile
  C += blockIdx.y * c_split;

  float acc[8][4 * NSUB];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4 * NSUB; ++j) acc[i][j] = 0.f;

  const int kt0 = blockIdx.y * per_split;  // this split's K slices [kt0, kt1)
  const int kt1 = min(kt0 + per_split, (K + BK - 1) / BK);
  const int nk = kt1 - kt0;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk)
      load_slice<TL, VEC>(As + s * TL::A_STAGE, Bs + s * TL::B_STAGE, A, B, M, N, K,
                          m0, n0, kt0 + s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of slice kt landed
    __syncthreads();  // everyone's landed; everyone is done with slice kt - 1
    const int next = kt + STAGES - 1;
    if (next < nk) {
      const int s = next % STAGES;
      load_slice<TL, VEC>(As + s * TL::A_STAGE, Bs + s * TL::B_STAGE, A, B, M, N, K,
                          m0, n0, kt0 + next);
    }
    cp_async_commit();  // (an empty group past the last slice keeps the count)
    const float* as = As + (kt % STAGES) * TL::A_STAGE;
    const float* bs = Bs + (kt % STAGES) * TL::B_STAGE;
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(as + k * TL::LDA + wr);
      const float4 a1 = *reinterpret_cast<const float4*>(as + k * TL::LDA + wr + 32);
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

// C[i] = P[0][i] + P[1][i] + ... in split order (partials `stride` floats
// apart), four elements a thread: float4 when VEC4.
template <bool VEC4>
__global__ void __launch_bounds__(256)
split_sum_kernel(const float* __restrict__ P, float* __restrict__ C, long long count,
                 int splits, long long stride) {
  const long long i = 4 * (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x);
  if (i >= count) return;
  if constexpr (VEC4) {
    float4 s = *reinterpret_cast<const float4*>(P + i);
    for (int z = 1; z < splits; ++z) {
      const float4 p = *reinterpret_cast<const float4*>(P + z * stride + i);
      s.x += p.x;
      s.y += p.y;
      s.z += p.z;
      s.w += p.w;
    }
    *reinterpret_cast<float4*>(C + i) = s;
  } else {
    for (long long e = i; e < i + 4 && e < count; ++e) {
      float s = P[e];
      for (int z = 1; z < splits; ++z) s += P[z * stride + e];
      C[e] = s;
    }
  }
}

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// C = A B through `splits` runs of `per_split` K slices. With more than
// one split, the partials go to `scratch` (splits x `stride` floats,
// stride >= M N) and a second launch sums them into C. Launches on
// `stream` of `device`; returns the cudaError_t (0 = success).
template <class TL>
int launch_pipe_sgemm(const float* A, const float* B, float* C, float* scratch,
                      int M, int N, int K, int per_split, int splits, long long stride,
                      int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int ktiles = (K + BK - 1) / BK;
  // every slice in one split, and no split empty (its partial would stay unwritten)
  if (splits < 1 || per_split < 1 || static_cast<long long>(splits) * per_split < ktiles ||
      (splits - 1) * per_split >= (ktiles > 0 ? ktiles : 1))
    return cudaErrorInvalidValue;
  float* out = splits > 1 ? scratch : C;
  const long long c_split = splits > 1 ? stride : 0;
  const bool vec = N % 4 == 0 && aligned16(B) && aligned16(out) && c_split % 4 == 0;
  auto kernel = vec ? pipe_sgemm_kernel<TL, true> : pipe_sgemm_kernel<TL, false>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             TL::SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks =
      static_cast<long long>((M + TL::BM - 1) / TL::BM) * ((N + TL::BN - 1) / TL::BN);
  if (blocks > 0x7fffffffll || splits > 65535) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  kernel<<<dim3(static_cast<unsigned>(blocks), splits), TL::THREADS, TL::SMEM_BYTES, st>>>(
      A, B, out, M, N, K, per_split, c_split);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const long long count = static_cast<long long>(M) * N;
  const long long threads = (count + 3) / 4;
  const unsigned grid = static_cast<unsigned>((threads + 255) / 256);
  if (count % 4 == 0 && stride % 4 == 0 && aligned16(scratch) && aligned16(C))
    split_sum_kernel<true><<<grid, 256, 0, st>>>(scratch, C, count, splits, stride);
  else
    split_sum_kernel<false><<<grid, 256, 0, st>>>(scratch, C, count, splits, stride);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace psg
