// Warp-specialised bf16 GEMM mainloop for Hopper (sm_90a), shared by the
// kernels that run large products on the tensor cores.
//
// D = A B in BM x BN tiles (f32 accumulators) over K in BK-wide steps;
// each finished tile goes, in registers, to an epilogue functor. The grid
// is persistent: one block per SM walks its share of the tiles.
// Warpgroup 0 is the producer: one thread keeps a ring of STAGES
// shared-memory stages filled with TMA loads, each stage's completion
// signalled on a `full` mbarrier, and runs ahead into the next tile while
// the consumers finish this one. Warpgroups 1 and 2 are consumers: each
// owns 64 rows of the tile and runs `wgmma.m64n256k16` on a stage once it
// has arrived, then frees it on its `empty` mbarrier. `setmaxnreg` moves
// registers from the producer (40) to the consumers (232), which hold the
// 64 x 256 f32 accumulator (128 registers a thread).
//
// Operands are bf16 in device memory, addressed through 2-D TMA tensor
// maps with 128-byte swizzle. Either operand may be K-major (its K
// dimension contiguous, as a row-major (M, K) A or an (N, K) B) or
// MN-major (M or N contiguous, as a row-major (K, M) A or (K, N) B):
// * K-major: one box of BK (= 64 elements, 128 bytes) x rows per stage;
//   the wgmma descriptor steps 32 bytes along K per k16 step.
// * MN-major: boxes of 64 (MN, 128 bytes) x BK (K) rows, one per 64
//   columns of the tile, placed 8 KiB apart (the descriptor's leading
//   byte offset); a k16 step is 16 rows, 2 KiB.
// Rows and columns past the tensor's edge load as zeros (TMA's
// out-of-bounds fill); the epilogue masks what it stores.
//
// The accumulator fragment: consumer thread `tid` (0..127) of the
// warpgroup holds, for j < BN / 8, acc[4j + 2h + c] at row
// 16 (tid / 32) + (tid % 32) / 4 + 8h and column 8j + 2 (tid % 4) + c.
// Each consumer warpgroup has its own OUT_BYTES staging buffer in shared
// memory (`Out::smem`) and the output tensor map `Out::map` for
// asynchronous TMA stores (`store_tile_bf16`), which drain while the
// next tile's products run.
//
// Nothing is atomic and the K order is fixed: a tile's result is the
// same bits on every launch.
#pragma once
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace wg {

constexpr int BM = 128;
constexpr int BN = 256;
constexpr int BK = 64;
constexpr int STAGES = 3;
constexpr int CONSUMERS = 2;
constexpr int THREADS = 128 * (1 + CONSUMERS);
constexpr int ACC = BN / 2;                  // f32 accumulators per consumer thread
constexpr int A_BYTES = BM * BK * 2;         // one stage of A
constexpr int B_BYTES = BN * BK * 2;         // one stage of B
constexpr int BOX_BYTES = 64 * BK * 2;       // one 64-wide MN-major box
constexpr int OUT_BYTES = 64 * BN * 2;       // a warpgroup's bf16 staging tile
constexpr int SMEM_BYTES =
    STAGES * (A_BYTES + B_BYTES) + CONSUMERS * OUT_BYTES + 2 * STAGES * 8 + 1024;

// What an epilogue gets besides its accumulators.
struct Out {
  const CUtensorMap* map;  // output tensor map (param space) for TMA stores
  unsigned char* smem;     // this warpgroup's OUT_BYTES of shared memory
  int tid;                 // thread in the warpgroup, 0..127
  int group;               // consumer warpgroup, 0 or 1
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// Wait for the completion of the barrier's phase of the given parity. A
// wait that lasts ~10 s traps (a launch error) rather than hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  const long long start = clock64();
  while (true) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > (1ll << 34)) __trap();
  }
}

// 2-D TMA tile load: box at (c0 innermost, c1) of `map` into `dst`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// d (64 x 256, f32) += A (64 x 16) B (16 x 256), bf16 operands in shared
// memory; TA / TB = 1 for an MN-major A / B.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[ACC], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %130, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, %131, %132;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// Named barrier over `count` threads (id 0 is __syncthreads').
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// Store a warpgroup's 64 x BN tile as bf16 through shared memory and TMA:
// `val(j, h, c)` is the value of accumulator 4j + 2h + c. The tile goes to
// (column col0, row row0) of out.map, a bf16 map with 64 x 64 boxes and
// 128-byte swizzle; TMA drops rows and columns past the tensor's edge.
// The store is left in flight; the next call first waits until it has
// read the staging buffer.
template <class Val>
__device__ __forceinline__ void store_tile_bf16(const Out& out, int row0, int col0,
                                                Val val) {
  if (out.tid == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  bar_sync(2 + out.group, 128);
  const int lane = out.tid % 32;
  const int r = 16 * (out.tid / 32) + lane / 4;  // row in the tile; r % 8 == lane / 4
#pragma unroll
  for (int j = 0; j < ACC / 4; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // box j / 8 (64 columns), 16-byte chunk j % 8 swizzled by the row
      const int off = (j / 8) * BOX_BYTES + (r + 8 * h) * 128 +
                      (((j % 8) ^ (lane / 4)) * 16) + (lane % 4) * 4;
      *reinterpret_cast<__nv_bfloat162*>(out.smem + off) =
          __floats2bfloat162_rn(val(j, h, 0), val(j, h, 1));
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  bar_sync(2 + out.group, 128);
  if (out.tid == 0) {
#pragma unroll
    for (int b = 0; b < BN / 64; ++b)
      asm volatile(
          "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
              reinterpret_cast<uint64_t>(out.map)),
          "r"(smem_u32(out.smem + b * BOX_BYTES)), "r"(col0 + 64 * b), "r"(row0)
          : "memory");
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  }
}

// First row and column of tile `tile` in the walk order over the
// m_tiles x n_tiles grid: bands of n_group columns one after another,
// inside a band n fastest, then m. n_group = n_tiles is plain row-major
// order (n fastest); a narrow band keeps the B tiles that run at the same
// time few, so all M rows reuse each B tile from L2.
__device__ __forceinline__ void tile_origin(int tile, int m_tiles, int n_tiles,
                                            int n_group, int& m0, int& n0) {
  const int band = tile / (n_group * m_tiles);
  const int first = band * n_group;
  const int width = n_tiles - first < n_group ? n_tiles - first : n_group;
  const int idx = tile - band * n_group * m_tiles;
  m0 = (idx / width) * BM;
  n0 = (first + idx % width) * BN;
}

// D = A B tile by tile: the grid is persistent (at most one block per
// SM), block b takes tiles b, b + gridDim.x, ... of the m_tiles x n_tiles
// grid in `tile_origin`'s order, each over `ktiles` K steps of BK. The
// producer runs ahead across tiles, so the next tile's loads overlap this
// tile's epilogue. Tensor coordinates of a tile's operands: A rows (or
// columns, when MN-major) from m * BM, A's K from a_k0; B's N from
// b_n0 + n * BN, B's K from b_k0. The epilogue gets (acc, first row of
// this warpgroup's 64, first column, Out).
template <bool A_MN, bool B_MN, class Epi>
__global__ void __launch_bounds__(THREADS, 1)
gemm_kernel(const __grid_constant__ CUtensorMap ta,
            const __grid_constant__ CUtensorMap tb,
            const __grid_constant__ CUtensorMap tc, int a_k0, int b_n0, int b_k0,
            int ktiles, int m_tiles, int n_tiles, int n_group, Epi epi) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* sa = smem;                         // [STAGES][A_BYTES]
  unsigned char* sb = sa + STAGES * A_BYTES;        // [STAGES][B_BYTES]
  unsigned char* so = sb + STAGES * B_BYTES;        // [CONSUMERS][OUT_BYTES]
  uint64_t* full = reinterpret_cast<uint64_t*>(so + CONSUMERS * OUT_BYTES);
  uint64_t* empty = full + STAGES;
  const int group = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int tiles = m_tiles * n_tiles;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (group == 0) {
    // producer: one thread issues every load of every tile of this block
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 0) {
      int it = 0;  // k steps issued so far: ring slot it % STAGES
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        int m0, n0;
        tile_origin(tile, m_tiles, n_tiles, n_group, m0, n0);
        for (int kt = 0; kt < ktiles; ++kt, ++it) {
          const int s = it % STAGES;
          if (it >= STAGES) mbar_wait(&empty[s], ((it / STAGES) - 1) & 1);
          mbar_expect_tx(&full[s], A_BYTES + B_BYTES);
          unsigned char* a = sa + s * A_BYTES;
          unsigned char* b = sb + s * B_BYTES;
          const int k = kt * BK;
          if constexpr (A_MN) {
#pragma unroll
            for (int i = 0; i < BM / 64; ++i)
              tma_load(a + i * BOX_BYTES, &ta, &full[s], m0 + 64 * i, a_k0 + k);
          } else {
            tma_load(a, &ta, &full[s], a_k0 + k, m0);
          }
          if constexpr (B_MN) {
#pragma unroll
            for (int j = 0; j < BN / 64; ++j)
              tma_load(b + j * BOX_BYTES, &tb, &full[s], b_n0 + n0 + 64 * j, b_k0 + k);
          } else {
            tma_load(b, &tb, &full[s], b_k0 + k, b_n0 + n0);
          }
        }
      }
    }
  } else {
    // consumers: warpgroup c owns rows [64 c, 64 c + 64) of each tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int c = group - 1;
    const Out out{&tc, so + c * OUT_BYTES, tid, c};
    int it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      int m0, n0;
      tile_origin(tile, m_tiles, n_tiles, n_group, m0, n0);
      float acc[ACC];
#pragma unroll
      for (int i = 0; i < ACC; ++i) acc[i] = 0.f;
      for (int kt = 0; kt < ktiles; ++kt, ++it) {
        const int s = it % STAGES;
        mbar_wait(&full[s], (it / STAGES) & 1);
        // K-major: 64 rows of 128 bytes per warpgroup, 8-row groups 1 KiB
        // apart, k16 steps 32 bytes along the row. MN-major: this
        // warpgroup's 64-wide box (A) or four boxes 8 KiB apart (B),
        // 8-row K groups 1 KiB apart, k16 steps 2 KiB.
        const uint32_t a0 = smem_u32(sa + s * A_BYTES) + c * (64 * 128);
        const uint32_t b0 = smem_u32(sb + s * B_BYTES);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          const uint64_t da = A_MN ? smem_desc(a0 + kk * 2048, BOX_BYTES, 1024)
                                   : smem_desc(a0 + kk * 32, 16, 1024);
          const uint64_t db = B_MN ? smem_desc(b0 + kk * 2048, BOX_BYTES, 1024)
                                   : smem_desc(b0 + kk * 32, 16, 1024);
          wgmma_m64n256k16<A_MN ? 1 : 0, B_MN ? 1 : 0>(acc, da, db);
        }
        wgmma_commit();
        wgmma_wait_all();
        if (tid == 0) mbar_arrive(&empty[s]);
      }
      epi(acc, m0 + 64 * c, n0, out);
    }
    // the last tile's stores must have read the staging buffer before exit
    if (tid == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

// Host side: cuTensorMapEncodeTiled from the driver, fetched through the
// runtime (no link against libcuda).
using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                   void*, const cuuint64_t*, const cuuint64_t*,
                                   const cuuint32_t*, const cuuint32_t*,
                                   CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q{};
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p,
                                                       12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// Tensor map of a row-major bf16 (rows, cols) matrix, 128-byte swizzle,
// box of box_cols (<= 64) x box_rows (<= 256). False on failure.
inline bool bf16_map(CUtensorMap* map, const void* ptr, long long rows,
                     long long cols, int box_cols, int box_rows) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr),
                dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Launch one tile grid of gemm_kernel on `stream` (`tc`: the epilogue's
// output map; any map when the epilogue stores without TMA). `n_group`:
// the walk's band of columns (`tile_origin`); 0 walks n fastest.
template <bool A_MN, bool B_MN, class Epi>
cudaError_t launch_gemm(const CUtensorMap& ta, const CUtensorMap& tb,
                        const CUtensorMap& tc, int a_k0,
                        int b_n0, int b_k0, int ktiles, int m_tiles, int n_tiles,
                        const Epi& epi, cudaStream_t stream, int n_group = 0) {
  auto kernel = gemm_kernel<A_MN, B_MN, Epi>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int tiles = m_tiles * n_tiles;
  if (n_group <= 0 || n_group > n_tiles) n_group = n_tiles;
  kernel<<<tiles < sms ? tiles : sms, THREADS, SMEM_BYTES, stream>>>(
      ta, tb, tc, a_k0, b_n0, b_k0, ktiles, m_tiles, n_tiles, n_group, epi);
  return cudaGetLastError();
}

}  // namespace wg
