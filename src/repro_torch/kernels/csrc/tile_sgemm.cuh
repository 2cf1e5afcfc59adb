// Register-blocked float32 tile GEMM shared by the coded-matvec (B1) and
// MDS-encode (B3) kernels: C[M,N] = A[M,K] @ B[K,N], all row-major.
//
// Full fp32 FMA on the SIMT cores, never TF32: both results feed the
// float32 erasure solve (DESIGN.md section 4), which amplifies input
// error by the condition number of the surviving generator rows.
//
// One block computes a BM x BN tile of C. Per BK-slice of K it stages the
// A tile (transposed, padded against bank conflicts) and the B tile in
// shared memory; each of the (BM/TM)*(BN/TN) threads then accumulates a
// TM x TN sub-tile in registers. A thread's rows and columns are strided
// by BM/TM and BN/TN so that a warp reads consecutive shared addresses and
// writes consecutive columns of C. Loads and stores are guarded, so any
// M, N, K works (ragged edges load zeros).
#pragma once
#include <cuda_runtime.h>

template <int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
tile_sgemm_kernel(const float* __restrict__ A, const float* __restrict__ B,
                  float* __restrict__ C, int M, int N, int K) {
  constexpr int THREADS = (BM / TM) * (BN / TN);
  constexpr int RS = BM / TM;  // row stride of a thread's sub-tile
  constexpr int CS = BN / TN;  // column stride
  __shared__ float As[BK][BM + 4];
  __shared__ float Bs[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % CS;
  const int ty = tid / CS;
  const long long row0 = static_cast<long long>(blockIdx.y) * BM;
  const long long col0 = static_cast<long long>(blockIdx.x) * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int e = tid; e < BM * BK; e += THREADS) {
      const int m = e / BK, kk = e % BK;
      const long long r = row0 + m;
      const int c = k0 + kk;
      As[kk][m] = (r < M && c < K) ? A[r * K + c] : 0.f;
    }
    for (int e = tid; e < BK * BN; e += THREADS) {
      const int kk = e / BN, n = e % BN;
      const long long c = col0 + n;
      const int r = k0 + kk;
      Bs[kk][n] = (r < K && c < N) ? B[static_cast<long long>(r) * N + c] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][ty + i * RS];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[kk][tx + j * CS];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long long r = row0 + ty + i * RS;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const long long c = col0 + tx + j * CS;
      if (c < N) C[r * N + c] = acc[i][j];
    }
  }
}

// Launch on `stream` of `device`; returns the cudaError_t (0 = success).
template <int BM, int BN, int BK, int TM, int TN>
int launch_tile_sgemm(const float* A, const float* B, float* C, int M, int N,
                      int K, int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  tile_sgemm_kernel<BM, BN, BK, TM, TN>
      <<<grid, (BM / TM) * (BN / TN), 0, static_cast<cudaStream_t>(stream)>>>(
          A, B, C, M, N, K);
  return static_cast<int>(cudaGetLastError());
}
