// B1 coded matvec for Hopper (sm_90a): Y = A X with the column batch as a
// kernel dimension.
//
// Replaces: src/repro/kernels/coded_matvec/kernel.py `matvec_kernel`
// (pallas_call at :48), which computes one y = A x in (256, 1024) tiles
// and which the reference serve loop vmaps over the B*R logit columns
// (src/repro/runtime/serve_loop.py:199-207). Here the columns are one
// GEMM dimension: the whole block mix Y = G X runs in ONE launch.
//
// Main-path shape: A = G (nb=738, kb=594) f32, X = logit blocks
// (594, S*256) f32, S=4: 0.9 GFLOP against 7.2 MB, so it is bound by
// float32 operations (67 TFLOP/s SIMT), not by memory. No TF32: Y feeds
// the f32 erasure solve. The small M*N needs many blocks to fill 132 SMs,
// so the tile is 64x64 (192 blocks at S=4), 4x4 per thread, BK=16.
#include "common.cuh"
#include "tile_sgemm.cuh"

extern "C" int repro_coded_matvec_f32(const float* a, const float* x,
                                      float* y, int m, int n, int k,
                                      int device, void* stream) {
  return launch_tile_sgemm<64, 64, 16, 4, 4>(a, x, y, m, n, k, device, stream);
}
