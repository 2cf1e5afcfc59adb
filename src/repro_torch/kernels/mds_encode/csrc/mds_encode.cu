// B3 MDS encode for Hopper (sm_90a): A~ = G A, once per plan.
//
// Replaces: src/repro/kernels/mds_encode/kernel.py `encode_kernel`
// (pallas_call at :54), a (256,256,256)-tiled GEMM with f32
// accumulation. The reference serve loop did this encode with np.einsum
// (src/repro/runtime/serve_loop.py:140-147); the port routes
// CodedLMHead.refresh and core/coding.encode through this kernel.
//
// Main-path shape: G (738, 594) f32 x vocab blocks (594, 256*1024) f32
// -> (738, 262144) f32: 230 GFLOP against 1.4 GB, bound by float32
// operations (67 TFLOP/s SIMT -> 3.4 ms at best). No TF32, so the coded
// table matches the CPU path to f32 rounding. The pipelined SIMT SGEMM of
// pipe_sgemm.cuh at 128 x 256 tiles, one split: K slices stream through a
// 4-stage cp.async ring while the previous slice is multiplied, a
// thread's 8 x 16 outputs are fed by float4 fragments, and the 6 row
// bands of each 256-column slab of the vocab blocks run side by side, so
// the 623 MB operand is read from device memory once. Every shape takes
// this one kernel (its edges copy zeros).
#include "common.cuh"
#include "pipe_sgemm.cuh"

extern "C" int repro_mds_encode_f32(const float* g, const float* a,
                                    float* out, int n, int d, int k,
                                    int device, void* stream) {
  const int slices = (k + psg::BK - 1) / psg::BK;
  return psg::launch_pipe_sgemm<psg::Tile<128, 256, 4, 1>>(
      g, a, out, nullptr, n, d, k, slices > 0 ? slices : 1, 1, 0, device, stream);
}
