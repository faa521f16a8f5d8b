// bf16 GEMM with f32 accumulation and a fused epilogue:
//
//   v   = A[M,K] . W[N,K]^T  (+ bias[n])
//   pre[m, n]            = v                (bf16; optional: before the residual)
//   v   = v (+ res_scale * res[m / res_div, n])
//   v   = act(v)                            act: none | ReLU | exact-erf GELU
//   out[m, n]            = v                (bf16 or f32; optional)
//   gmax[m / group, n]   = max over the group's rows of v   (bf16; optional)
//
// With pre, one launch yields both a branch's rounded value and the f32 sum
// of that branch and the residual: the serial-adapter block needs bf16(y) as
// its adapter's input and f32(x + y) as the residual that the adapter's
// up-projection adds.
//
// It is the product engine of these TPU kernels, each as a short chain of
// launches of this one kernel:
//   - pointvit_tpu/ops/pallas_encoder.py::_encoder_pallas (kernel _enc_kernel)
//     and ::_p3_pallas (kernel _p3_kernel): the folded mini-PointNet
//     products. The group max over K rows gives g and the final (M*K, E)
//     product is reduced to (M, E) in the epilogue, so it never reaches
//     device memory; the per-group g.Wg'+c2 row enters the loc.Wl' epilogue
//     as a residual indexed by m / K.
//   - pointvit_tpu/ops/pallas_block.py::_apf_block_pallas (kernels
//     _attn_half_kernel, _mlp_half_kernel): qkv, proj + residual, fc1 + GELU,
//     adapter down + ReLU, up + 2*x1, fc2 + the rest of the sum.
//   - pointvit_tpu/ops/pallas_block.py::_vit_block_pallas: qkv, proj + x,
//     fc1 + GELU, fc2 + x1.
//   - pointvit_tpu/ops/pallas_block.py::_serial_block_pallas (kernels
//     _serial_attn_half_kernel, _serial_mlp_half_kernel): proj and fc2 each
//     write bf16(y) and f32(x + y) through pre; the adapters' up-projections
//     add that f32 residual, as the Pallas kernel's f32 sum (x + y) + a.
//   - the output projection of pallas_attention.py::_attn_block_pallas.
//
// What bounds it on the H100 (989 TFLOP/s bf16, 3.35 TB/s; each input read
// once, each output written once). The serial-adapter block, M = 1536 * 197
// = 302,592 token rows: qkv 768->2304 1.08 ms and fc1, fc2 1.44 ms each are
// bound by operations; proj (f32 sum + bf16 pre out) 0.69 ms, the adapters'
// down-projections (N = 64) 0.15 ms and up-projections (f32 residual in)
// 0.43 ms are bound by bytes: 5.8 ms a block. The APF block, M = 256 * 196
// = 50,176: qkv 0.18, proj 0.07 (bytes), fc1 0.24, down 0.03 (bytes), up
// 0.07 (bytes), fc2 0.24 ms: 0.82 ms. So both the tensor cores and the
// epilogue's bytes have to run near their rates.
//
// Design (Hopper). A producer warp streams 64-deep K steps of A (128 rows)
// and W (BN rows) by TMA (128-byte swizzle, zeros past M, N and K, so K = 8
// is one mostly zero box) into a ring of full and empty mbarriers; two
// consumer warpgroups of 64 rows each issue wgmma m64nBNk16 with both
// operands K-major from shared memory (A is (M, K), W is (N, K): what the
// bf16 instruction takes without its transpose bit), one wgmma group per K
// step kept in flight while the next stage is awaited; every consumer
// thread arrives on the stage's empty barrier. Tiles are ordered N fastest,
// so a row block of A is read from device memory once and from L2 by the
// other column tiles. The epilogue works on the accumulators in registers:
// bias and residual read as pairs of the accumulator layout, the residual's
// row m / res_div computed once per row (the producer warp prefetches the
// tile's residual rows into L2 while the products run); the group max
// reduced across a warp's 16 rows by shuffles (and across warps through
// shared memory for groups above 16). Two instances:
//   - 128 x 128 (128 x 64 for N <= 64): two blocks an SM (96 registers a
//     thread, a three-stage ring of 96 KB), one tile a block, so one
//     block's epilogue overlaps the other's main loop; outputs staged in
//     the drained ring and copied out in coalesced 16-byte stores. wgmma
//     reads each 64-row A slice and the whole W slice from shared memory,
//     and TMA writes both: about 160 bytes a clock at the bf16 peak against
//     the SM's 128, so this main loop tops out near 540 TFLOP/s.
//   - 128 x 256 persistent: one block an SM walks tiles (168 registers, a
//     three-stage ring of 144 KB); m64n256k16 reads a third less from
//     shared memory per FLOP, and its main loop runs near 690 TFLOP/s. The
//     producer fills the ring for the next tile while the consumers finish
//     this one; outputs go through a 64 KB staging area of 128-byte
//     swizzled boxes that TMA stores, so the consumers move on before the
//     bytes leave. But one block an SM cannot overlap the epilogue's own
//     work with wgmma, so it is taken only where the main loop outweighs
//     the epilogue and N fills its tiles.
// Two more bf16 instances follow below: a persistent ping-pong one (two
// consumer warpgroups taking 128 x 128 tiles in turn, so one's epilogue
// overlaps the other's wgmma) and the ViT block's proj + residual +
// LayerNorm over whole 384-wide rows; and an f32 instance on CUDA cores.
// The caller picks the instance (ops/gemm_kernel.py::gemm_instance).
// No split-K and no atomics: two runs give the same bits.
#include "common.cuh"
#include "sm90.cuh"

#include <algorithm>

namespace {

constexpr int BM = 128, BK = 64;  // BK: one 128-byte swizzled row of bf16
constexpr int kThreads = 288;     // warps 0-7: two consumer warpgroups of 64 rows; warp 8: the producer
constexpr int kConsumers = 256;

// The instances. BN = 64 and 128: two blocks an SM, one tile each, the
// epilogue staged in the drained ring (padded rows). BN = 256: one
// persistent block an SM walking tiles, the epilogue staged beside the ring
// in four 16 KB swizzled boxes, so the producer fills the ring for the next
// tile while the consumers finish this one.
template <int BN>
struct Tile {
  static constexpr bool kPersistent = BN == 256;
  static constexpr int kStages = BN == 64 ? 4 : 3;
  static constexpr int kStageBytes = (BM + BN) * BK * 2;
  static constexpr int kRingBytes = kStages * kStageBytes;
  // The staging area, then the group max's per-warp rows.
  static constexpr int kStageOff = kPersistent ? kRingBytes : 0;
  static constexpr int kRedOff = kStageOff + (kPersistent ? 4 * 16384 : BM * (512 + 32));
  static constexpr int kBarOff = kPersistent ? kRedOff + 8 * BN * 4 : kRingBytes;  // full, empty
  static constexpr int kSmem = kBarOff + 16 * kStages;
  static_assert(kPersistent || kRedOff + 8 * BN * 4 <= kRingBytes, "the staged tile fits the ring");
  static_assert(kStageBytes % 1024 == 0, "every stage starts on a 1024-byte boundary");
  static_assert((kPersistent ? 1 : 2) * (kSmem + 1024) <= 232448, "the blocks fit an SM");
};

struct GemmArgs {
  const bf16* bias;
  const void* res;
  void* out;
  bf16* pre;
  bf16* gmax;
  int M, N, K;
  int res_div, res_f32, out_f32, group, act;
  float res_scale;
};

#define PV_WGMMA_D128                                                                             \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                      \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "             \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "             \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "             \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "             \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "             \
  "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, " \
  "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}"
#define PV_F8(d, i)                                                                           \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x 256 f32, accumulator layout) += A (64 x 16, shared, K-major) . B
// (16 x 256, shared, K-major: 256 rows of W, 8-row groups 1024 bytes apart).
__device__ __forceinline__ void wgmma_ss_n256(float (&d)[128], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " PV_WGMMA_D128
      ", %128, %129, p, 1, 1, 0, 0;\n}\n"
      : PV_F8(d, 0), PV_F8(d, 8), PV_F8(d, 16), PV_F8(d, 24), PV_F8(d, 32), PV_F8(d, 40),
        PV_F8(d, 48), PV_F8(d, 56), PV_F8(d, 64), PV_F8(d, 72), PV_F8(d, 80), PV_F8(d, 88),
        PV_F8(d, 96), PV_F8(d, 104), PV_F8(d, 112), PV_F8(d, 120)
      : "l"(a), "l"(b), "r"(1));
}

// One k16 slice of the tile's product into the accumulators.
template <int BN>
__device__ __forceinline__ void wgmma_tile(float (&d)[BN / 2], uint64_t a, uint64_t b) {
  if constexpr (BN == 64) {
    wgmma_ss(d, a, b, 1);
  } else if constexpr (BN == 128) {
    wgmma_ss_n128(d, a, b, 1);
  } else {
    wgmma_ss_n256(d, a, b);
  }
}

// Exact-erf GELU.
__device__ __forceinline__ float gelu(float v) { return 0.5f * v * (1.f + erff(v * 0.7071067811865475f)); }

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

__device__ __forceinline__ void load_pair(const bf16* p, size_t i, bool two, float& a, float& b) {
  if (two) {
    const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(p + i);
    a = __low2float(v);
    b = __high2float(v);
  } else {
    a = bf2f(p[i]);
  }
}
__device__ __forceinline__ void load_pair(const float* p, size_t i, bool two, float& a, float& b) {
  if (two) {
    const float2 v = *reinterpret_cast<const float2*>(p + i);
    a = v.x;
    b = v.y;
  } else {
    a = p[i];
  }
}

// The accumulator layout of wgmma m64nNk16: acc[4 j + 2 h + e] is row
// 16 w + g + 8 h of the warpgroup's 64 and column 8 j + 2 t + e (warp w of
// the warpgroup, lane 4 g + t). Writes the tile (values cast to T; BN <=
// 128, so rows of at most 512 bytes) row-major into the staging area, rows
// padded so a warp's eight rows hit distinct banks, then all 256 consumer
// threads copy it out in 16-byte chunks along rows.
template <typename T, int BN>
__device__ __forceinline__ void store_tile(const float (&acc)[BN / 2], unsigned char* stage, T* dst,
                                           int m0, int n0, int M, int N, int r0, int t) {
  constexpr int kRow = BN * sizeof(T) + 16 * sizeof(T) / 2;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      unsigned char* p = stage + (r0 + 8 * h) * kRow + (8 * j + 2 * t) * sizeof(T);
      const float a = acc[4 * j + 2 * h], b = acc[4 * j + 2 * h + 1];
      if constexpr (sizeof(T) == 4) {
        *reinterpret_cast<float2*>(p) = make_float2(a, b);
      } else {
        *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
      }
    }
  }
  consumers_sync();
  constexpr int kPer = 16 / sizeof(T), kChunks = BN / kPer;
  const bool vec = N % kPer == 0;
  for (int i = threadIdx.x; i < BM * kChunks; i += kConsumers) {
    const int r = i / kChunks, c = (i % kChunks) * kPer;
    const int gr = m0 + r, gc = n0 + c;
    if (gr >= M || gc >= N) continue;
    const unsigned char* src = stage + r * kRow + c * sizeof(T);
    T* d = dst + (size_t)gr * N + gc;
    if (vec) {
      *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int e = 0; e < kPer && gc + e < N; ++e) d[e] = reinterpret_cast<const T*>(src)[e];
    }
  }
  consumers_sync();  // the staging area is free again
}

// ---- the persistent instance's epilogue: swizzled boxes stored by TMA ----
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, uint32_t src, int c0, int c1) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(src), "r"(c0), "r"(c1)
               : "memory");
}
__device__ __forceinline__ void bulk_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void bulk_wait_read() { asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory"); }
__device__ __forceinline__ void bulk_wait_all() { asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory"); }

// Waits until the TMA stores issued from the staging area have read it.
__device__ __forceinline__ void staging_free() {
  if (threadIdx.x == 0) bulk_wait_read();
  consumers_sync();
}

// Columns 8 J0 .. 8 (J0 + JN) of the tile (64 KB of T) into four 16 KB boxes
// of 128 rows x 128 bytes, 128-byte swizzled (chunk c of row r at c ^ r % 8:
// a warp's eight rows hit distinct banks), then stored by TMA.
template <typename T, int BN, int J0, int JN>
__device__ __forceinline__ void tma_store_cols(const float (&acc)[BN / 2], unsigned char* stage,
                                               const CUtensorMap* map, int m0, int n0, int r0, int t) {
  constexpr int kBoxCols = 128 / sizeof(T);  // 64 bf16 or 32 f32
  staging_free();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
#pragma unroll
    for (int j = 0; j < JN; ++j) {
      const int c = 8 * j + 2 * t;  // column within this pass
      const int off = (c % kBoxCols) * sizeof(T);
      unsigned char* p = stage + (c / kBoxCols) * 16384 + r * 128 + (((off >> 4) ^ (r & 7)) << 4) + (off & 15);
      const float a = acc[4 * (J0 + j) + 2 * h], b = acc[4 * (J0 + j) + 2 * h + 1];
      if constexpr (sizeof(T) == 4) {
        *reinterpret_cast<float2*>(p) = make_float2(a, b);
      } else {
        *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
      }
    }
  }
  fence_async_smem();
  consumers_sync();
  if (threadIdx.x == 0) {
    const uint32_t src = smem_addr(stage);
#pragma unroll
    for (int box = 0; box < JN * 8 / kBoxCols; ++box)
      tma_store_2d(map, src + box * 16384, n0 + 8 * J0 + box * kBoxCols, m0);
    bulk_commit();
  }
}

template <typename T, int BN>
__device__ __forceinline__ void tma_store_tile(const float (&acc)[BN / 2], unsigned char* stage,
                                               const CUtensorMap* map, int m0, int n0, int r0, int t) {
  constexpr int kPasses = BN * sizeof(T) / 512;  // 64 KB a pass
  tma_store_cols<T, BN, 0, BN / 8 / kPasses>(acc, stage, map, m0, n0, r0, t);
  if constexpr (kPasses == 2) tma_store_cols<T, BN, BN / 16, BN / 16>(acc, stage, map, m0, n0, r0, t);
}

// gmax[(m0 + row) / G, n] = max over the group's rows, G a power of two
// that divides BM (and M: a group lies wholly inside or outside M). Within
// a warp the 16 rows are lane bits 2-4 (g) and the two halves h; groups
// above 16 rows meet across warps in shared memory (red: [8 warps][BN]).
template <int BN>
__device__ __forceinline__ void group_max(float (&acc)[BN / 2], float* red, const GemmArgs& p, int m0,
                                          int n0, int r0, int g, int t) {
  const int G = p.group;
#pragma unroll
  for (int o = 4; o <= 16; o <<= 1) {
    if (o / 4 < G) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = fmaxf(acc[i], __shfl_xor_sync(0xffffffffu, acc[i], o));
    }
  }
  const bool pairs = (p.N & 1) == 0;
  auto write = [&](int gr, float a, float b, int c) {  // the pair at columns c, c + 1 of gr's group
    bf16* row = p.gmax + (size_t)(gr / G) * p.N;
    if (pairs) {
      *reinterpret_cast<uint32_t*>(row + c) = pack_bf16(a, b);
    } else {
      row[c] = f2bf(a);
      if (c + 1 < p.N) row[c + 1] = f2bf(b);
    }
  };
  if (G <= 8) {  // each half holds whole groups; lanes at a group's first row write
    if (g % G == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int gr = m0 + r0 + 8 * h;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int c = n0 + 8 * j + 2 * t;
          if (gr < p.M && c < p.N) write(gr, acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1], c);
        }
      }
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    acc[4 * j] = fmaxf(acc[4 * j], acc[4 * j + 2]);
    acc[4 * j + 1] = fmaxf(acc[4 * j + 1], acc[4 * j + 3]);
  }
  const int warp = threadIdx.x >> 5;  // rows 16 warp .. 16 warp + 15 of the tile
  if (G == 16) {
    const int gr = m0 + 16 * warp;
    if (g == 0 && gr < p.M) {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int c = n0 + 8 * j + 2 * t;
        if (c < p.N) write(gr, acc[4 * j], acc[4 * j + 1], c);
      }
    }
    return;
  }
  if (g == 0) {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      red[warp * BN + 8 * j + 2 * t] = acc[4 * j];
      red[warp * BN + 8 * j + 2 * t + 1] = acc[4 * j + 1];
    }
  }
  consumers_sync();
  const int per = G / 16;  // warps per group
  for (int i = threadIdx.x; i < (BM / G) * BN; i += kConsumers) {
    const int gi = i / BN, c = i % BN;
    const int gr = m0 + gi * G;
    if (gr >= p.M || n0 + c >= p.N) continue;
    float m = red[gi * per * BN + c];
    for (int w = 1; w < per; ++w) m = fmaxf(m, red[(gi * per + w) * BN + c]);
    p.gmax[(size_t)(gr / G) * p.N + n0 + c] = f2bf(m);
  }
  consumers_sync();  // red is free again
}

__device__ __forceinline__ void prefetch_l2(const void* p, uint32_t bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(p), "r"(bytes) : "memory");
}

template <int BN>
__global__ __launch_bounds__(kThreads, (Tile<BN>::kPersistent ? 1 : 2)) void gemm_kernel(
    const __grid_constant__ CUtensorMap amap, const __grid_constant__ CUtensorMap wmap,
    const __grid_constant__ CUtensorMap omap, const GemmArgs p) {
  using T = Tile<BN>;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = smem_addr(smem);
  if (base & 1023) __trap();  // the swizzled tiles need 1024-byte alignment
  const uint32_t full = base + T::kBarOff, empty = full + 8 * T::kStages;
  // Tiles in one linear order, N tiles fastest (a row block of A stays in
  // L2), so M may exceed 65535 row tiles; block b takes tiles b, b + grid, ...
  const int n_tiles = (p.N + BN - 1) / BN;
  const int tiles = n_tiles * ((p.M + BM - 1) / BM);
  const int KT = (p.K + BK - 1) / BK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < T::kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumers);  // every consumer thread arrives
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int role = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);  // warp-uniform
  if (role == 2) {  // the producer warp
    const int lane = threadIdx.x & 31;
    int it = 0;  // K steps issued, over all of this block's tiles
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int n0 = (tile % n_tiles) * BN, m0 = (tile / n_tiles) * BM;
      if (p.res) {  // warm L2 with the tile's residual rows while the products run
        const int es = p.res_f32 ? 4 : 2;
        if ((p.N * es) % 16 == 0) {
          const int r_lo = m0 / p.res_div, r_hi = (min(m0 + BM, p.M) - 1) / p.res_div;
          const uint32_t bytes = min(BN, p.N - n0) * es;
          for (int r = r_lo + lane; r <= r_hi; r += 32)
            prefetch_l2(static_cast<const char*>(p.res) + ((size_t)r * p.N + n0) * es, bytes);
        }
      }
      if (lane == 0) {
        for (int kt = 0; kt < KT; ++kt, ++it) {
          const int stage = it % T::kStages, round = it / T::kStages;
          if (round > 0) mbar_wait(empty + 8 * stage, (round - 1) & 1);
          const uint32_t slot = base + stage * T::kStageBytes, bar = full + 8 * stage;
          mbar_expect_tx(bar, T::kStageBytes);
          tma_load_2d(slot, &amap, bar, kt * BK, m0);
          tma_load_2d(slot + BM * BK * 2, &wmap, bar, kt * BK, n0);
        }
      }
      __syncwarp();
      if constexpr (!T::kPersistent) break;
    }
    return;
  }

  unsigned char* stage_area = smem + T::kStageOff;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = role * 64 + (threadIdx.x >> 5 & 3) * 16 + g;  // tile row of half 0; half 1 is r0 + 8
  const bool pairs = (p.N & 1) == 0;
  int it = 0;  // K steps consumed, over all of this block's tiles
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int n0 = (tile % n_tiles) * BN, m0 = (tile / n_tiles) * BM;
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    for (int kt = 0; kt < KT; ++kt, ++it) {
      const int stage = it % T::kStages;
      mbar_wait(full + 8 * stage, (it / T::kStages) & 1);
      const uint32_t a = base + stage * T::kStageBytes + role * 64 * BK * 2;
      const uint32_t b = base + stage * T::kStageBytes + BM * BK * 2;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) wgmma_tile<BN>(acc, desc_kmajor(a + 32 * kk), desc_kmajor(b + 32 * kk));
      wgmma_commit();
      wgmma_wait<1>();  // the previous K step's group is done: hand its stage back
      if (kt > 0) mbar_arrive(empty + 8 * ((it - 1) % T::kStages));
    }
    wgmma_wait<0>();
    reg_fence(acc);
    mbar_arrive(empty + 8 * ((it - 1) % T::kStages));  // the tile's last stage
    if constexpr (!T::kPersistent) consumers_sync();  // both warpgroups are done with the ring

    // The epilogue, on the accumulators in registers.
    if (p.bias) {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int c = n0 + 8 * j + 2 * t;
        float b0 = 0.f, b1 = 0.f;
        if (c < p.N) load_pair(p.bias, c, pairs, b0, b1);
        if (!pairs && c + 1 < p.N) b1 = bf2f(p.bias[c + 1]);
        acc[4 * j] += b0;
        acc[4 * j + 1] += b1;
        acc[4 * j + 2] += b0;
        acc[4 * j + 3] += b1;
      }
    }
    if constexpr (!T::kPersistent) {  // pv_gemm gives the persistent instance no pre
      if (p.pre) store_tile<bf16, BN>(acc, stage_area, p.pre, m0, n0, p.M, p.N, r0, t);
    }
    if (p.res) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int gr = m0 + r0 + 8 * h;
        if (gr >= p.M) continue;
        const size_t row = (size_t)(gr / p.res_div) * p.N;  // once per row
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int c = n0 + 8 * j + 2 * t;
          if (c >= p.N) continue;
          float r[2] = {0.f, 0.f};
          if (p.res_f32) {
            load_pair(static_cast<const float*>(p.res), row + c, pairs, r[0], r[1]);
            if (!pairs && c + 1 < p.N) r[1] = static_cast<const float*>(p.res)[row + c + 1];
          } else {
            load_pair(static_cast<const bf16*>(p.res), row + c, pairs, r[0], r[1]);
            if (!pairs && c + 1 < p.N) r[1] = bf2f(static_cast<const bf16*>(p.res)[row + c + 1]);
          }
          acc[4 * j + 2 * h] += p.res_scale * r[0];
          acc[4 * j + 2 * h + 1] += p.res_scale * r[1];
        }
      }
    }
    if (p.act == 1) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = fmaxf(acc[i], 0.f);
    } else if (p.act == 2) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = gelu(acc[i]);
    }
    if (p.out) {
      if constexpr (T::kPersistent) {
        if (p.out_f32) {
          tma_store_tile<float, BN>(acc, stage_area, &omap, m0, n0, r0, t);
        } else {
          tma_store_tile<bf16, BN>(acc, stage_area, &omap, m0, n0, r0, t);
        }
      } else if (p.out_f32) {
        store_tile<float, BN>(acc, stage_area, static_cast<float*>(p.out), m0, n0, p.M, p.N, r0, t);
      } else {
        store_tile<bf16, BN>(acc, stage_area, static_cast<bf16*>(p.out), m0, n0, p.M, p.N, r0, t);
      }
    }
    if (p.gmax) group_max<BN>(acc, reinterpret_cast<float*>(smem + T::kRedOff), p, m0, n0, r0, g, t);
    if constexpr (!T::kPersistent) break;  // one tile a block
  }
  if constexpr (T::kPersistent) {
    if (threadIdx.x == 0) bulk_wait_all();  // the staging area outlives the stores that read it
  }
}

int sm_count() {
  static int n = 0;
  if (!n) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

template <int BN>
int launch(const GemmArgs& p, const void* A, const void* W, cudaStream_t stream) {
  using T = Tile<BN>;
  // first: binds the context the tensor maps need
  cudaFuncSetAttribute(gemm_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  const uint64_t adims[2] = {(uint64_t)p.K, (uint64_t)p.M}, wdims[2] = {(uint64_t)p.K, (uint64_t)p.N};
  const uint64_t strides[1] = {(uint64_t)p.K * 2};
  CUtensorMap amap, wmap, omap = {};
  if (!pv_tensor_map(&amap, A, 2, adims, strides, BM) || !pv_tensor_map(&wmap, W, 2, wdims, strides, BN)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (T::kPersistent && p.out) {  // the output in boxes of 128 rows x 128 bytes
    const int es = p.out_f32 ? 4 : 2;
    const uint64_t odims[2] = {(uint64_t)p.N, (uint64_t)p.M}, ostr[1] = {(uint64_t)p.N * es};
    if (!pv_tensor_map_of(&omap, p.out_f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                          p.out, 2, odims, ostr, 128 / es, BM)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const int tiles = ((p.N + BN - 1) / BN) * ((p.M + BM - 1) / BM);
  const int grid = T::kPersistent ? std::min(tiles, sm_count()) : tiles;
  gemm_kernel<BN><<<grid, kThreads, T::kSmem, stream>>>(amap, wmap, omap, p);
  return static_cast<int>(cudaGetLastError());
}

// ---- the ping-pong instance ----
//
// Persistent and warp-specialised, for the products whose epilogue is heavy
// beside a short K (GELU, residuals, a pre output): warpgroup 0 is the
// producer (one warp issues TMA, setmaxnreg lowers its registers to 40);
// warpgroups 1 and 2 are consumers (raised to 232 registers) that take the
// block's output tiles in turn, each a whole 128 x 128 tile (two m64n128k16
// accumulators, 128 floats a thread). While one consumer runs its epilogue
// (bias, residual loads, GELU, the staging of its outputs for TMA stores),
// the other issues wgmma on the next tile; named barriers hand the tensor
// cores from one consumer to the other in tile order. The ring (five 32 KB
// stages) is filled in tile order and each stage is drained by the one
// consumer whose tile it holds. Outputs (and pre) leave through a 32 KB
// staging area per consumer: two 16 KB boxes of 128 rows x 128 bytes,
// 128-byte swizzled, stored by TMA; a consumer waits on its own stores'
// reads only before it writes its staging area again. No group max.
constexpr int kPPThreads = 384, kPPStages = 5;
constexpr int kPPStageBytes = (BM + 128) * BK * 2;
constexpr int kPPRing = kPPStages * kPPStageBytes;
constexpr int kPPStaging = 32768;
constexpr int kPPBarOff = kPPRing + 2 * kPPStaging;
constexpr int kPPSmem = kPPBarOff + 16 * kPPStages;
static_assert(kPPSmem + 1024 <= 232448, "the ping-pong block fits an SM");

// The 128 threads of consumer c (named barrier 2 + c), and the barriers that
// order the consumers' turns on the tensor cores (consumer c waits on 4 + c).
__device__ __forceinline__ void pp_sync(int c) { asm volatile("bar.sync %0, 128;\n" ::"r"(2 + c) : "memory"); }
__device__ __forceinline__ void pp_turn_wait(int c) { asm volatile("bar.sync %0, 256;\n" ::"r"(4 + c) : "memory"); }
__device__ __forceinline__ void pp_turn_give(int c) { asm volatile("bar.arrive %0, 256;\n" ::"r"(4 + c) : "memory"); }

// Columns 8 J0 .. 8 (J0 + JN) of consumer c's tile (32 KB of T) into its two
// swizzled boxes, then stored by TMA from its leader thread. Row of acc[q]
// half h: 64 q + wrow + 8 h.
template <typename T, int J0, int JN>
__device__ __forceinline__ void pp_store_cols(const float (&acc)[2][64], unsigned char* stage,
                                              const CUtensorMap* map, int m0, int n0, int wrow, int t,
                                              int c, bool leader) {
  constexpr int kBoxCols = 128 / sizeof(T);
  static_assert(JN * 8 * sizeof(T) == 256, "a pass fills the two boxes");
  if (leader) bulk_wait_read();  // this consumer's earlier stores have read the area
  pp_sync(c);
#pragma unroll
  for (int q = 0; q < 2; ++q) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 64 * q + wrow + 8 * h;
#pragma unroll
      for (int j = 0; j < JN; ++j) {
        const int col = 8 * j + 2 * t;
        const int off = (col % kBoxCols) * sizeof(T);
        unsigned char* ptr = stage + (col / kBoxCols) * 16384 + r * 128 + (((off >> 4) ^ (r & 7)) << 4) + (off & 15);
        const float a = acc[q][4 * (J0 + j) + 2 * h], b = acc[q][4 * (J0 + j) + 2 * h + 1];
        if constexpr (sizeof(T) == 4) {
          *reinterpret_cast<float2*>(ptr) = make_float2(a, b);
        } else {
          *reinterpret_cast<uint32_t*>(ptr) = pack_bf16(a, b);
        }
      }
    }
  }
  fence_async_smem();
  pp_sync(c);
  if (leader) {
    const uint32_t src = smem_addr(stage);
    tma_store_2d(map, src, n0 + 8 * J0, m0);
    tma_store_2d(map, src + 16384, n0 + 8 * J0 + kBoxCols, m0);
    bulk_commit();
  }
}

__global__ __launch_bounds__(kPPThreads, 1) void gemm_pp_kernel(
    const __grid_constant__ CUtensorMap amap, const __grid_constant__ CUtensorMap wmap,
    const __grid_constant__ CUtensorMap omap, const __grid_constant__ CUtensorMap premap,
    const GemmArgs p) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = smem_addr(smem);
  if (base & 1023) __trap();
  const uint32_t full = base + kPPBarOff, empty = full + 8 * kPPStages;
  const int n_tiles = (p.N + 127) / 128;
  const int tiles = n_tiles * ((p.M + BM - 1) / BM);
  const int KT = (p.K + BK - 1) / BK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kPPStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 128);  // the consumer whose tile the stage holds
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);  // warp-uniform
  if (wg == 0) {  // the producer warpgroup: one warp issues, three idle
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x >= 32) return;
    const int lane = threadIdx.x;
    int it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int n0 = (tile % n_tiles) * 128, m0 = (tile / n_tiles) * BM;
      if (p.res) {  // warm L2 with the tile's residual rows
        const int es = p.res_f32 ? 4 : 2;
        const int r_lo = m0 / p.res_div, r_hi = (min(m0 + BM, p.M) - 1) / p.res_div;
        const uint32_t bytes = min(128, p.N - n0) * es;
        for (int r = r_lo + lane; r <= r_hi; r += 32)
          prefetch_l2(static_cast<const char*>(p.res) + ((size_t)r * p.N + n0) * es, bytes);
      }
      if (lane == 0) {
        for (int kt = 0; kt < KT; ++kt, ++it) {
          const int stage = it % kPPStages, round = it / kPPStages;
          if (round > 0) mbar_wait(empty + 8 * stage, (round - 1) & 1);
          const uint32_t slot = base + stage * kPPStageBytes, bar = full + 8 * stage;
          mbar_expect_tx(bar, kPPStageBytes);
          tma_load_2d(slot, &amap, bar, kt * BK, m0);
          tma_load_2d(slot + BM * BK * 2, &wmap, bar, kt * BK, n0);
        }
      }
      __syncwarp();
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int c = wg - 1;  // consumer 0 or 1
  const int tid = threadIdx.x - 128 * wg;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int wrow = (tid >> 5) * 16 + g;  // tile row of acc[0] half 0
  const bool leader = tid == 0;
  unsigned char* stage_area = smem + kPPRing + c * kPPStaging;
  int j = c;  // the tile's index in this block's sequence
  for (int tile = blockIdx.x + c * gridDim.x; tile < tiles; tile += 2 * gridDim.x, j += 2) {
    const int n0 = (tile % n_tiles) * 128, m0 = (tile / n_tiles) * BM;
    float acc[2][64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[0][i] = acc[1][i] = 0.f;
    if (j > 0) pp_turn_wait(c);  // the other consumer has issued the previous tile's products
    int it = j * KT;  // the ring holds every tile's K steps in order
    for (int kt = 0; kt < KT; ++kt, ++it) {
      const int stage = it % kPPStages;
      mbar_wait(full + 8 * stage, (it / kPPStages) & 1);
      const uint32_t a = base + stage * kPPStageBytes;
      const uint32_t b = a + BM * BK * 2;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wgmma_ss_n128(acc[0], desc_kmajor(a + 32 * kk), desc_kmajor(b + 32 * kk), 1);
        wgmma_ss_n128(acc[1], desc_kmajor(a + 64 * 128 + 32 * kk), desc_kmajor(b + 32 * kk), 1);
      }
      wgmma_commit();
      wgmma_wait<1>();
      if (kt > 0) mbar_arrive(empty + 8 * ((it - 1) % kPPStages));
    }
    if (tile + gridDim.x < tiles) pp_turn_give(1 - c);  // the next tile is the other consumer's
    wgmma_wait<0>();
    reg_fence(acc[0]);
    reg_fence(acc[1]);
    mbar_arrive(empty + 8 * ((it - 1) % kPPStages));

    // The epilogue, on the accumulators in registers.
    if (p.bias) {
#pragma unroll
      for (int jj = 0; jj < 16; ++jj) {
        const int col = n0 + 8 * jj + 2 * t;
        float b0 = 0.f, b1 = 0.f;
        if (col < p.N) load_pair(p.bias, col, true, b0, b1);
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          acc[q][4 * jj] += b0;
          acc[q][4 * jj + 1] += b1;
          acc[q][4 * jj + 2] += b0;
          acc[q][4 * jj + 3] += b1;
        }
      }
    }
    if (p.pre) pp_store_cols<bf16, 0, 16>(acc, stage_area, &premap, m0, n0, wrow, t, c, leader);
    if (p.res) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int gr = m0 + 64 * q + wrow + 8 * h;
          if (gr >= p.M) continue;
          const size_t row = (size_t)(gr / p.res_div) * p.N;
#pragma unroll
          for (int jj = 0; jj < 16; ++jj) {
            const int col = n0 + 8 * jj + 2 * t;
            if (col >= p.N) continue;
            float r0 = 0.f, r1 = 0.f;
            if (p.res_f32) {
              load_pair(static_cast<const float*>(p.res), row + col, true, r0, r1);
            } else {
              load_pair(static_cast<const bf16*>(p.res), row + col, true, r0, r1);
            }
            acc[q][4 * jj + 2 * h] += p.res_scale * r0;
            acc[q][4 * jj + 2 * h + 1] += p.res_scale * r1;
          }
        }
      }
    }
    if (p.act == 1) {
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        acc[0][i] = fmaxf(acc[0][i], 0.f);
        acc[1][i] = fmaxf(acc[1][i], 0.f);
      }
    } else if (p.act == 2) {
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        acc[0][i] = gelu(acc[0][i]);
        acc[1][i] = gelu(acc[1][i]);
      }
    }
    if (p.out) {
      if (p.out_f32) {
        pp_store_cols<float, 0, 8>(acc, stage_area, &omap, m0, n0, wrow, t, c, leader);
        pp_store_cols<float, 8, 8>(acc, stage_area, &omap, m0, n0, wrow, t, c, leader);
      } else {
        pp_store_cols<bf16, 0, 16>(acc, stage_area, &omap, m0, n0, wrow, t, c, leader);
      }
    }
  }
  if (leader) bulk_wait_all();  // the staging area outlives the stores that read it
}

// ---- the proj + LayerNorm instance: whole rows of width 384 ----
//
// The ViT block's proj with its residual, x1 = bf16(att . Wp^T + bp + xp),
// and the LayerNorm after it, y = LN(x1), in one launch (the pos-LayerNorm
// of csrc/block.cu writes xp and LN1(xp) the same way): it drops the LN2
// launch and its read of x1. A tile is 64 rows x all 384 columns: one
// consumer warpgroup with a m64n256k16 and a m64n128k16 accumulator (192
// floats a thread), fed by TMA from a producer warp through a ring of
// three 56 KB stages; the tile's residual rows come by TMA into a 48 KB
// buffer of their own, and bias, gamma and beta sit in shared memory, so
// the epilogue waits on no device-memory load. Persistent over row tiles:
// the producer loads the next tile while the consumers run the epilogue.
// One block an SM of five warps: 192 accumulators need more registers than
// a block of 288 threads gets (an SM sub-partition holds 16 K registers,
// and a ninth warp puts three warps on one). A row lies in one quad of one
// warp (lanes 4 g .. 4 g + 3), so its mean and variance reduce by two
// shuffles, in f32, over the bf16-rounded x1, as csrc/block.cu's LayerNorm
// computes them. x1 and y leave straight from the registers.
constexpr int kLnN = 384, kLnM = 64, kLnThreads = 160, kLnStages = 3;
constexpr int kLnStageBytes = (kLnM + kLnN) * BK * 2;  // 56 KB: A 64 rows, W 384 rows
constexpr int kLnResOff = kLnStages * kLnStageBytes;   // the residual: six 8 KB boxes
constexpr int kLnParOff = kLnResOff + kLnM * kLnN * 2;  // bias, gamma, beta as f32
constexpr int kLnBarOff = kLnParOff + 3 * kLnN * 4;     // full, empty, res full, res empty
constexpr int kLnSmem = kLnBarOff + 16 * kLnStages + 16;
static_assert(kLnStageBytes % 1024 == 0 && kLnResOff % 1024 == 0, "swizzled tiles on 1024-byte boundaries");
static_assert(kLnSmem + 1024 <= 232448, "the proj + LayerNorm block fits an SM");

struct GemmLnArgs {
  const bf16 *bias, *gamma, *beta;
  bf16 *out, *y;
  int M, K;
  float eps;
};

__global__ __launch_bounds__(kLnThreads, 1) void gemm_ln_kernel(const __grid_constant__ CUtensorMap amap,
                                                                const __grid_constant__ CUtensorMap wmap,
                                                                const __grid_constant__ CUtensorMap rmap,
                                                                const GemmLnArgs p) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = smem_addr(smem);
  if (base & 1023) __trap();
  const uint32_t full = base + kLnBarOff, empty = full + 8 * kLnStages;
  const uint32_t rfull = empty + 8 * kLnStages, rempty = rfull + 8;
  float* par = reinterpret_cast<float*>(smem + kLnParOff);
  const int tiles = (p.M + kLnM - 1) / kLnM, KT = (p.K + BK - 1) / BK;
  for (int c = threadIdx.x; c < kLnN; c += kLnThreads) {
    par[c] = bf2f(p.bias[c]);
    par[kLnN + c] = bf2f(p.gamma[c]);
    par[2 * kLnN + c] = bf2f(p.beta[c]);
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < kLnStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 128);
    }
    mbar_init(rfull, 1);
    mbar_init(rempty, 128);
    mbar_fence_init();
  }
  __syncthreads();
  const int role = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);  // warp-uniform
  if (role == 1) {  // the producer warp
    if ((threadIdx.x & 31) == 0) {
      int it = 0, j = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++j) {
        for (int kt = 0; kt < KT; ++kt, ++it) {
          const int stage = it % kLnStages, round = it / kLnStages;
          if (round > 0) mbar_wait(empty + 8 * stage, (round - 1) & 1);
          const uint32_t slot = base + stage * kLnStageBytes, bar = full + 8 * stage;
          mbar_expect_tx(bar, kLnStageBytes);
          tma_load_2d(slot, &amap, bar, kt * BK, tile * kLnM);
          for (int part = 0; part < 3; ++part)  // W rows 128 at a time
            tma_load_2d(slot + kLnM * BK * 2 + part * 128 * BK * 2, &wmap, bar, kt * BK, 128 * part);
        }
        if (j > 0) mbar_wait(rempty, (j - 1) & 1);  // the last tile's epilogue has read its residual
        mbar_expect_tx(rfull, kLnM * kLnN * 2);
        for (int box = 0; box < kLnN / 64; ++box)
          tma_load_2d(base + kLnResOff + box * kLnM * 128, &rmap, rfull, 64 * box, tile * kLnM);
      }
    }
    return;
  }
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = (threadIdx.x >> 5) * 16 + g;  // tile row of half 0; half 1 is r0 + 8
  const unsigned char* rbuf = smem + kLnResOff;
  int it = 0, j = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++j) {
    const int m0 = tile * kLnM;
    float acc0[128], acc1[64];  // columns 0-255, 256-383
#pragma unroll
    for (int i = 0; i < 128; ++i) acc0[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 64; ++i) acc1[i] = 0.f;
    for (int kt = 0; kt < KT; ++kt, ++it) {
      const int stage = it % kLnStages;
      mbar_wait(full + 8 * stage, (it / kLnStages) & 1);
      const uint32_t a = base + stage * kLnStageBytes;
      const uint32_t b = a + kLnM * BK * 2;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wgmma_ss_n256(acc0, desc_kmajor(a + 32 * kk), desc_kmajor(b + 32 * kk));
        wgmma_ss_n128(acc1, desc_kmajor(a + 32 * kk), desc_kmajor(b + 256 * 128 + 32 * kk), 1);
      }
      wgmma_commit();
      wgmma_wait<1>();
      if (kt > 0) mbar_arrive(empty + 8 * ((it - 1) % kLnStages));
    }
    wgmma_wait<0>();
    reg_fence(acc0);
    reg_fence(acc1);
    mbar_arrive(empty + 8 * ((it - 1) % kLnStages));

    // x1 = bf16(acc + bias + res), kept as its f32 value for the LayerNorm.
    // acc0[4 j + 2 h + e] is column 8 j + 2 t + e (j < 32), acc1's column
    // 256 + 8 j + 2 t + e (j < 16); row r0 + 8 h.
    mbar_wait(rfull, j & 1);
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rr = r0 + 8 * h, gr = m0 + rr;
      const bool live = gr < p.M;
#pragma unroll
      for (int jj = 0; jj < 48; ++jj) {
        float& v0 = jj < 32 ? acc0[4 * jj + 2 * h] : acc1[4 * (jj - 32) + 2 * h];
        float& v1 = jj < 32 ? acc0[4 * jj + 2 * h + 1] : acc1[4 * (jj - 32) + 2 * h + 1];
        const int col = 8 * jj + 2 * t, cc = col % 64;  // the residual's box col / 64, 128-byte swizzled
        const __nv_bfloat162 res = *reinterpret_cast<const __nv_bfloat162*>(
            rbuf + (col / 64) * (kLnM * 128) + rr * 128 + (((cc >> 3) ^ (rr & 7)) << 4) + (cc & 7) * 2);
        const uint32_t packed = pack_bf16(v0 + par[col] + __low2float(res), v1 + par[col + 1] + __high2float(res));
        if (live) *reinterpret_cast<uint32_t*>(p.out + (size_t)gr * kLnN + col) = packed;
        const __nv_bfloat162 r = *reinterpret_cast<const __nv_bfloat162*>(&packed);
        v0 = __low2float(r);
        v1 = __high2float(r);
        sum[h] += v0 + v1;
      }
    }
    mbar_arrive(rempty);
    float mu[2], rstd[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // the row's four lanes hold all its columns
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
      mu[h] = sum[h] / kLnN;
      float q = 0.f;
#pragma unroll
      for (int jj = 0; jj < 48; ++jj) {
        const float d0 = (jj < 32 ? acc0[4 * jj + 2 * h] : acc1[4 * (jj - 32) + 2 * h]) - mu[h];
        const float d1 = (jj < 32 ? acc0[4 * jj + 2 * h + 1] : acc1[4 * (jj - 32) + 2 * h + 1]) - mu[h];
        q += d0 * d0 + d1 * d1;
      }
      q += __shfl_xor_sync(0xffffffffu, q, 1);
      q += __shfl_xor_sync(0xffffffffu, q, 2);
      rstd[h] = rsqrtf(q / kLnN + p.eps);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gr = m0 + r0 + 8 * h;
      if (gr >= p.M) continue;
      bf16* yr = p.y + (size_t)gr * kLnN;
#pragma unroll
      for (int jj = 0; jj < 48; ++jj) {
        const float v0 = jj < 32 ? acc0[4 * jj + 2 * h] : acc1[4 * (jj - 32) + 2 * h];
        const float v1 = jj < 32 ? acc0[4 * jj + 2 * h + 1] : acc1[4 * (jj - 32) + 2 * h + 1];
        const int col = 8 * jj + 2 * t;
        *reinterpret_cast<uint32_t*>(yr + col) =
            pack_bf16((v0 - mu[h]) * rstd[h] * par[kLnN + col] + par[2 * kLnN + col],
                      (v1 - mu[h]) * rstd[h] * par[kLnN + col + 1] + par[2 * kLnN + col + 1]);
      }
    }
  }
}

// ---- the f32 instance: CUDA cores ----
//
// For the f32 models (build_model(..., "bf16": False)): every operand and
// output f32, products in full f32 on the CUDA cores, as torch.matmul
// computes an f32 product by default. Bound by operations at 67 TFLOP/s,
// the H100's f32 rate outside the tensor cores. A 128 x 128 tile a block of
// 256 threads, each thread an 8 x 8 register tile (rows 4 ty .. 4 ty + 3
// and 64 + 4 ty .., columns 4 tx .. and 64 + 4 tx ..: float4 reads of
// shared memory); 16-deep K steps double-buffered in shared memory, the next
// step's loads held in registers while this one computes. The epilogue is
// the bf16 kernel's, on the thread's 64 values: bias, pre, residual
// (res_scale, res_div), ReLU or GELU, out, the group max (groups above a
// thread's 4 rows meet through shared memory). One rounding per output, no
// split-K: two runs give the same bits.
constexpr int FBM = 128, FBN = 128, FBK = 16, FPAD = 4, kF32Threads = 256;

struct GemmF32Args {
  const float* A;
  const float* W;
  const float* bias;
  const float* res;
  float* out;
  float* pre;
  float* gmax;
  int M, N, K, res_div, group, act;
  float res_scale;
};

// Rows [r0, r0 + 128) of X (rows, K), columns [k0, k0 + 16): thread tid
// loads rows tid / 4 and tid / 4 + 64, columns 4 (tid % 4) .. + 3; zeros
// outside the tensor (K % 4 == 0, so a float4 lies wholly inside or outside).
__device__ __forceinline__ void f32_load(const float* X, int rows, int K, int r0, int k0, float4 (&v)[2]) {
  const int c = k0 + 4 * (threadIdx.x & 3);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + (threadIdx.x >> 2) + 64 * h;
    v[h] = (r < rows && c < K) ? *reinterpret_cast<const float4*>(X + (size_t)r * K + c)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}
// ... stored transposed: s[k][row], rows padded by FPAD.
__device__ __forceinline__ void f32_store(float* s, const float4 (&v)[2]) {
  const int k = 4 * (threadIdx.x & 3);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = (threadIdx.x >> 2) + 64 * h;
    s[(k + 0) * (FBM + FPAD) + r] = v[h].x;
    s[(k + 1) * (FBM + FPAD) + r] = v[h].y;
    s[(k + 2) * (FBM + FPAD) + r] = v[h].z;
    s[(k + 3) * (FBM + FPAD) + r] = v[h].w;
  }
}

__global__ __launch_bounds__(kF32Threads) void gemm_f32_kernel(const GemmF32Args p) {
  __shared__ __align__(16) float As[2][FBK * (FBM + FPAD)];
  __shared__ __align__(16) float Ws[2][FBK * (FBN + FPAD)];
  const int n_tiles = (p.N + FBN - 1) / FBN;
  const int n0 = (blockIdx.x % n_tiles) * FBN, m0 = (blockIdx.x / n_tiles) * FBM;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  float4 av[2], wv[2];
  f32_load(p.A, p.M, p.K, m0, 0, av);
  f32_load(p.W, p.N, p.K, n0, 0, wv);
  f32_store(As[0], av);
  f32_store(Ws[0], wv);
  __syncthreads();
  const int KT = (p.K + FBK - 1) / FBK;
  for (int kt = 0; kt < KT; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < KT) {  // the next step's loads fly while this one computes
      f32_load(p.A, p.M, p.K, m0, (kt + 1) * FBK, av);
      f32_load(p.W, p.N, p.K, n0, (kt + 1) * FBK, wv);
    }
#pragma unroll
    for (int k = 0; k < FBK; ++k) {
      const float* ar = As[buf] + k * (FBM + FPAD);
      const float* wr = Ws[buf] + k * (FBN + FPAD);
      const float4 a0 = *reinterpret_cast<const float4*>(ar + 4 * ty);
      const float4 a1 = *reinterpret_cast<const float4*>(ar + 64 + 4 * ty);
      const float4 b0 = *reinterpret_cast<const float4*>(wr + 4 * tx);
      const float4 b1 = *reinterpret_cast<const float4*>(wr + 64 + 4 * tx);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (kt + 1 < KT) {
      f32_store(As[buf ^ 1], av);
      f32_store(Ws[buf ^ 1], wv);
    }
    __syncthreads();
  }

  // The epilogue. Row i of the thread: 4 ty + i (i < 4) or 64 + 4 ty + i - 4.
  auto row_of = [&](int i) { return m0 + (i < 4 ? 4 * ty + i : 60 + 4 * ty + i); };
  auto col_of = [&](int j) { return n0 + (j < 4 ? 4 * tx + j : 60 + 4 * tx + j); };
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = row_of(i);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = col_of(j);
      if (r >= p.M || c >= p.N) continue;
      float v = acc[i][j];
      if (p.bias) v += p.bias[c];
      if (p.pre) p.pre[(size_t)r * p.N + c] = v;
      if (p.res) v += p.res_scale * p.res[(size_t)(r / p.res_div) * p.N + c];
      if (p.act == 1) {
        v = fmaxf(v, 0.f);
      } else if (p.act == 2) {
        v = gelu(v);
      }
      if (p.out) p.out[(size_t)r * p.N + c] = v;
      acc[i][j] = v;
    }
  }
  if (!p.gmax) return;
  const int G = p.group;  // a power of two that divides 128 and M
  if (G <= 4) {  // whole groups within a thread's 4 consecutive rows
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = row_of(i);
      if (r % G || r >= p.M) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = col_of(j);
        if (c >= p.N) continue;
        float m = acc[i][j];
#pragma unroll
        for (int e = 1; e < 4; ++e) {  // fixed bounds: acc stays in registers
          if (e < G && i + e < 8) m = fmaxf(m, acc[i + e][j]);
        }
        p.gmax[(size_t)(r / G) * p.N + c] = m;
      }
    }
    return;
  }
  // Chunk q (rows 4 q .. 4 q + 3 of the tile): the thread's max over them.
  float* red = &As[0][0];  // 32 chunks x 128 columns = 16 KB of the 17 KB buffer
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int q = 16 * h + ty;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float m = acc[4 * h][j];
#pragma unroll
      for (int e = 1; e < 4; ++e) m = fmaxf(m, acc[4 * h + e][j]);
      red[q * FBN + (j < 4 ? 4 * tx + j : 60 + 4 * tx + j)] = m;
    }
  }
  __syncthreads();
  const int per = G / 4;  // chunks per group
  for (int i = threadIdx.x; i < (FBM / G) * FBN; i += kF32Threads) {
    const int gi = i / FBN, c = i % FBN;
    const int r = m0 + gi * G;
    if (r >= p.M || n0 + c >= p.N) continue;
    float m = red[gi * per * FBN + c];
    for (int q = 1; q < per; ++q) m = fmaxf(m, red[(gi * per + q) * FBN + c]);
    p.gmax[(size_t)(r / G) * p.N + n0 + c] = m;
  }
}

int launch_pp(const GemmArgs& p, const void* A, const void* W, cudaStream_t stream) {
  // first: binds the context the tensor maps need
  cudaFuncSetAttribute(gemm_pp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kPPSmem);
  const uint64_t adims[2] = {(uint64_t)p.K, (uint64_t)p.M}, wdims[2] = {(uint64_t)p.K, (uint64_t)p.N};
  const uint64_t strides[1] = {(uint64_t)p.K * 2};
  CUtensorMap amap, wmap, omap = {}, premap = {};
  if (!pv_tensor_map(&amap, A, 2, adims, strides, BM) || !pv_tensor_map(&wmap, W, 2, wdims, strides, 128)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const uint64_t odims[2] = {(uint64_t)p.N, (uint64_t)p.M};
  if (p.out) {  // boxes of 128 rows x 128 bytes
    const int es = p.out_f32 ? 4 : 2;
    const uint64_t ostr[1] = {(uint64_t)p.N * es};
    if (!pv_tensor_map_of(&omap, p.out_f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                          p.out, 2, odims, ostr, 128 / es, BM)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (p.pre) {
    const uint64_t pstr[1] = {(uint64_t)p.N * 2};
    if (!pv_tensor_map_of(&premap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, p.pre, 2, odims, pstr, 64, BM)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const int tiles = ((p.N + 127) / 128) * ((p.M + BM - 1) / BM);
  gemm_pp_kernel<<<std::min(tiles, sm_count()), kPPThreads, kPPSmem, stream>>>(amap, wmap, omap, premap, p);
  return static_cast<int>(cudaGetLastError());
}

int launch_ln(const GemmLnArgs& p, const void* A, const void* W, const void* res, cudaStream_t stream) {
  // first: binds the context the tensor maps need
  cudaFuncSetAttribute(gemm_ln_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kLnSmem);
  const uint64_t adims[2] = {(uint64_t)p.K, (uint64_t)p.M}, wdims[2] = {(uint64_t)p.K, (uint64_t)kLnN};
  const uint64_t rdims[2] = {(uint64_t)kLnN, (uint64_t)p.M};
  const uint64_t strides[1] = {(uint64_t)p.K * 2}, rstrides[1] = {(uint64_t)kLnN * 2};
  CUtensorMap amap, wmap, rmap;
  if (!pv_tensor_map(&amap, A, 2, adims, strides, kLnM) || !pv_tensor_map(&wmap, W, 2, wdims, strides, 128) ||
      !pv_tensor_map(&rmap, res, 2, rdims, rstrides, kLnM)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tiles = (p.M + kLnM - 1) / kLnM;
  gemm_ln_kernel<<<std::min(tiles, sm_count()), kLnThreads, kLnSmem, stream>>>(amap, wmap, rmap, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// A (M, K), W (N, K), bias (N,) bf16; res (M / res_div, N) bf16 or f32; out
// (M, N) bf16 or f32; pre (M, N) bf16; gmax (M / group, N) bf16; all
// contiguous, 16-byte aligned, K % 8 == 0 (TMA's 16-byte row stride), group
// a power of two that divides 128 and M. `instance` (the caller picks it,
// ops/gemm_kernel.py): 64 or 128 (two blocks an SM, that tile width), 256
// (persistent 128 x 256; N % 8 == 0), 1 (ping-pong; N % 8 == 0, no gmax).
extern "C" int pv_gemm(const void* A, const void* W, const void* bias, const void* res, int res_div,
                       int res_f32, float res_scale, void* out, int out_f32, void* pre, void* gmax,
                       int group, int M, int N, int K, int act, int instance, void* stream) {
  if (M < 1 || N < 1 || K < 1 || K % 8 || res_div < 1 || (gmax && (group < 1 || BM % group))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if ((instance == 256 || instance == 1) && N % 8) return static_cast<int>(cudaErrorInvalidValue);
  if ((instance == 256 && pre) || (instance == 1 && gmax)) return static_cast<int>(cudaErrorInvalidValue);
  GemmArgs p;
  p.bias = static_cast<const bf16*>(bias);
  p.res = res;
  p.out = out;
  p.pre = static_cast<bf16*>(pre);
  p.gmax = static_cast<bf16*>(gmax);
  p.M = M;
  p.N = N;
  p.K = K;
  p.res_div = res_div;
  p.res_f32 = res_f32;
  p.out_f32 = out_f32;
  p.group = group;
  p.act = act;
  p.res_scale = res_scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (instance) {
    case 64:
      return launch<64>(p, A, W, s);
    case 128:
      return launch<128>(p, A, W, s);
    case 256:
      return launch<256>(p, A, W, s);
    case 1:
      return launch_pp(p, A, W, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The f32 instance: A (M, K), W (N, K), bias (N,), res (M / res_div, N),
// out, pre (M, N), gmax (M / group, N), all f32, contiguous, 16-byte
// aligned; K % 4 == 0; group a power of two that divides 128 and M.
extern "C" int pv_gemm_f32(const void* A, const void* W, const void* bias, const void* res,
                           int res_div, float res_scale, void* out, void* pre, void* gmax, int group,
                           int M, int N, int K, int act, void* stream) {
  if (M < 1 || N < 1 || K < 1 || K % 4 || res_div < 1 || (gmax && (group < 1 || FBM % group))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  GemmF32Args p;
  p.A = static_cast<const float*>(A);
  p.W = static_cast<const float*>(W);
  p.bias = static_cast<const float*>(bias);
  p.res = static_cast<const float*>(res);
  p.out = static_cast<float*>(out);
  p.pre = static_cast<float*>(pre);
  p.gmax = static_cast<float*>(gmax);
  p.M = M;
  p.N = N;
  p.K = K;
  p.res_div = res_div;
  p.group = group;
  p.act = act;
  p.res_scale = res_scale;
  const long tiles = (long)((N + FBN - 1) / FBN) * ((M + FBM - 1) / FBM);
  gemm_f32_kernel<<<tiles, kF32Threads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The proj + LayerNorm instance: out = bf16(A . W^T + bias + res) and y =
// LN(out) with gamma, beta and eps; A (M, K), W (384, K), res, out, y (M,
// 384), bias, gamma, beta (384,), all bf16, contiguous, 16-byte aligned;
// K % 8 == 0.
extern "C" int pv_gemm_ln(const void* A, const void* W, const void* bias, const void* res,
                          const void* gamma, const void* beta, void* out, void* y, float eps, int M, int N,
                          int K, void* stream) {
  if (M < 1 || N != kLnN || K < 1 || K % 8) return static_cast<int>(cudaErrorInvalidValue);
  GemmLnArgs p;
  p.bias = static_cast<const bf16*>(bias);
  p.gamma = static_cast<const bf16*>(gamma);
  p.beta = static_cast<const bf16*>(beta);
  p.out = static_cast<bf16*>(out);
  p.y = static_cast<bf16*>(y);
  p.M = M;
  p.K = K;
  p.eps = eps;
  return launch_ln(p, A, W, res, static_cast<cudaStream_t>(stream));
}
