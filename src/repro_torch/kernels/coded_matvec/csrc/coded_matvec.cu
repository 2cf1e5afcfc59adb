// B1 coded matvec for Hopper (sm_90a): Y = A X with the column batch as a
// kernel dimension.
//
// Replaces: src/repro/kernels/coded_matvec/kernel.py `matvec_kernel`
// (pallas_call at :48), which computes one y = A x in (256, 1024) tiles
// and which the reference serve loop vmaps over the B*R logit columns
// (src/repro/runtime/serve_loop.py:199-207). Here the columns are one
// GEMM dimension: the whole block mix Y = G X is one GEMM launch (and one
// small launch that sums its split-K partials).
//
// Main-path shape: A = G (nb=738, kb=594) f32, X = logit blocks
// (594, S*256) f32, S=4: 0.9 GFLOP against 7.2 MB, so it is bound by
// float32 operations (67 TFLOP/s SIMT, 13.4 us), not by memory. No TF32:
// Y feeds the f32 erasure solve. The mainloop is pipe_sgemm.cuh's at
// B3's 128 x 256 tile (cp.async ring, float4 fragments, 8 x 16 outputs a
// lane). The output is small: 24 tiles for 132 SMs. So K is split too:
// the Python wrapper (ops.py, gemm_plan) picks the split count from
// (M, N, K) and the SM count, the partials go to scratch the wrapper
// allocates, and a second launch sums them in split order (bit-identical
// on every launch, no atomics).
#include "common.cuh"
#include "pipe_sgemm.cuh"

extern "C" int repro_coded_matvec_f32(const float* a, const float* x, float* y,
                                      float* scratch, int m, int n, int k, int per_split,
                                      int splits, long long stride, int device,
                                      void* stream) {
  return psg::launch_pipe_sgemm<psg::Tile<128, 256, 4, 1>>(
      a, x, y, scratch, m, n, k, per_split, splits, stride, device, stream);
}
