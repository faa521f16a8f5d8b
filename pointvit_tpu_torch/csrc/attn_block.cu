// Fused attention sublayer, launch 1 of 2: the qkv projection and the
// multi-head attention, with the (B, S, 3E) qkv activation kept on chip.
//
// Replaces pointvit_tpu/ops/pallas_attention.py::_attn_block_pallas (kernel
// _attn_block_kernel), together with launch 2, o . Wproj + bproj, which is
// one launch of gemm.cu. Per (batch, head) it computes, with the Pallas
// kernel's rounding points (pallas_attention.py:482-501):
//
//     q, k, v = bf16(x . Wqkv[:, head] + bqkv[head])   bf16 products, f32 sum, one rounding
//     P       = softmax(q k^T * D^-1/2)                 f32 logits; max and sum, then divide
//     o       = bf16(bf16(P) . v)                       f32 accumulation
//
// What bounds it on the H100: per (batch, head) 6*S*E*D FLOPs of projection
// and 4*S*S*D of attention on tensor cores, against reading x (S*E*2 bytes,
// once per head from L2) and the head's 3*D*E weights; at the main-path
// shapes (S = 196..513, E = 384..768) it is bound by operations (the whole
// sublayer at the APF shape: 2.7e11 FLOPs, 0.27 ms at 989 TFLOP/s).
//
// Design (Hopper): one block per (head, cloud), of one consumer warpgroup
// and one producer warp. The producer streams, by TMA through a ring of
// mbarrier-guarded stages, 64 x 64 tiles of x (a 3-D tensor map over (E, S,
// B): rows past S arrive as zeros) and of the head's rows of Wqkv (row n is
// output column n). Phase 1: for each 64-row tile of the head's keys the
// consumer runs x . [Wk | Wv] on wgmma m64n128k16 (both operands K-major
// from shared memory), biases and rounds them once, and stores K and V into
// shared memory in the 128-byte-swizzled layout the core's wgmma reads;
// they stay there, whole: 2 * ceil(S / 64) * 8 KB (192 KB at S = 736, the
// published limit, pv_attn_block_max_seq). Phase 2: for each 64-row query
// tile, x . Wq on wgmma; its accumulator, biased and rounded, is the A
// operand of Q.K^T in registers; then attention_core (the same device
// function as csrc/attention.cu) over the resident K and V. o (B, S, E)
// bf16 is the only output. The ring has up to four stages of 24 KB: two
// where that lets two blocks share an SM (S <= 256), one at S = 736.
// What holds it from the tensor cores' rate: each 64-deep projection step
// waits for its own wgmma group, with one or two consumer warpgroups per
// SM, so the tensor cores idle through every wgmma's latency.
#include "attn_core.cuh"

namespace {

constexpr int kThreads = 160;                // warps 0-3: the consumer warpgroup; warp 4: producer
constexpr int kStageBytes = 3 * kTileBytes;  // an x tile and two weight tiles
constexpr int kMaxSeq = 736;
constexpr int kSmemLimit = 227 * 1024;
constexpr int kTwoPerSm = 228 * 1024 / 2 - 1024;  // a block's share when two fit an SM
constexpr int kMaxStages = 4;

__host__ __device__ inline int resident_bytes(int tiles) { return 2 * tiles * kTileBytes; }
__host__ __device__ inline int smem_bytes(int tiles, int stages) {
  return resident_bytes(tiles) + stages * kStageBytes + 16 * stages;
}
// Two stages where two blocks then share an SM; else as many as fit. (More
// stages at one block per SM measured slower at S = 196 and no faster at
// S = 513: each k-step waits for its own wgmma group, so the ring is
// seldom empty.)
inline int ring_stages(int tiles) {
  if (smem_bytes(tiles, 2) <= kTwoPerSm) return 2;
  int st = kMaxStages;
  while (st > 1 && smem_bytes(tiles, st) > kSmemLimit) --st;
  return st;
}

// K and V resident in shared memory as attention_core's tile source.
struct ResidentTiles {
  uint32_t k_base, v_base;
  __device__ __forceinline__ uint32_t k(int t, int) const { return k_base + t * kTileBytes; }
  __device__ __forceinline__ uint32_t v(int t) const { return v_base + t * kTileBytes; }
  __device__ __forceinline__ void release(int, int) const {}
};

// acc (+)= the x tile . the weight tile at `w` (64 output columns).
__device__ __forceinline__ void project_step(float (&acc)[32], uint32_t x, uint32_t w,
                                             int accumulate) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_ss(acc, desc_kmajor(x + 32 * kk), desc_kmajor(w + 32 * kk), accumulate | (kk > 0));
}
// The same for 128 output columns: the two weight tiles from `w` on.
__device__ __forceinline__ void project_step(float (&acc)[64], uint32_t x, uint32_t w,
                                             int accumulate) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_ss_n128(acc, desc_kmajor(x + 32 * kk), desc_kmajor(w + 32 * kk), accumulate | (kk > 0));
}

// Columns [kOff / 2, kOff / 2 + 64) of acc plus bias, rounded once, into a
// swizzled tile; rows at or past `rows` zero.
template <int kOff, int N>
__device__ __forceinline__ void store_tile(const float (&acc)[N], const bf16* bias,
                                           unsigned char* tile, int rows) {
  const int lane = threadIdx.x & 31;
  const int r = (threadIdx.x >> 5 & 3) * 16 + (lane >> 2), c = (lane & 3) * 2;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float b0 = bf2f(bias[8 * j + c]), b1 = bf2f(bias[8 * j + c + 1]);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int rr = r + 8 * half;
      const bool in = rr < rows;
      const float v0 = acc[kOff + 4 * j + 2 * half], v1 = acc[kOff + 4 * j + 2 * half + 1];
      *reinterpret_cast<uint32_t*>(tile + swz128(rr, 8 * j + c)) =
          pack_bf16(in ? v0 + b0 : 0.f, in ? v1 + b1 : 0.f);
    }
  }
}

__global__ __launch_bounds__(kThreads) void attn_block_kernel(
    const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
    const bf16* __restrict__ bias, bf16* __restrict__ o, int S, int H, int stages, float scale) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = smem_addr(smem);
  if (base & 1023) __trap();  // the swizzled tiles need 1024-byte alignment
  const int h = blockIdx.x, b = blockIdx.y;
  const int E = H * kAttnTile, tiles = (S + kAttnTile - 1) / kAttnTile, ksteps = E / kAttnTile;
  const int items = tiles * ksteps;  // per phase: (row tile, 64-deep step)
  const uint32_t k_base = base, v_base = base + tiles * kTileBytes;
  const uint32_t ring = base + resident_bytes(tiles);
  const uint32_t full = ring + stages * kStageBytes, empty = full + 8 * stages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 128);  // every consumer thread arrives
    }
    mbar_fence_init();
  }
  __syncthreads();

  // The role, warp-uniform for the compiler: wgmma must not sit on a path it
  // takes for divergent (ptxas then serialises the wgmma instructions).
  if (__shfl_sync(0xffffffffu, threadIdx.x / 128, 0) == 1) {  // the producer warp
    if (threadIdx.x == 128) {
      for (int i = 0; i < 2 * items; ++i) {
        const int stage = i % stages, round = i / stages, phase = i >= items;
        const int j = i - phase * items, r0 = j / ksteps * kAttnTile, k0 = j % ksteps * kAttnTile;
        if (round > 0) mbar_wait(empty + 8 * stage, (round - 1) & 1);
        const uint32_t slot = ring + stage * kStageBytes, bar = full + 8 * stage;
        mbar_expect_tx(bar, (phase ? 2 : 3) * kTileBytes);
        tma_load_3d(slot, &xmap, bar, k0, r0, b);
        if (phase) {
          tma_load_2d(slot + kTileBytes, &wmap, bar, k0, h * kAttnTile);
        } else {
          tma_load_2d(slot + kTileBytes, &wmap, bar, k0, E + h * kAttnTile);
          tma_load_2d(slot + 2 * kTileBytes, &wmap, bar, k0, 2 * E + h * kAttnTile);
        }
      }
    }
    return;
  }

  // Ring item i: wait until it has landed, and hand its stage back.
  auto arrived = [&](int i) {
    const int stage = i % stages;
    mbar_wait(full + 8 * stage, (i / stages) & 1);
    return ring + stage * kStageBytes;
  };
  auto release = [&](int i) { mbar_arrive(empty + 8 * (i % stages)); };
  // The ksteps items from i on, one wgmma group each, waited for before
  // its stage goes back. (Keeping a group in flight across the next
  // step's barrier wait made ptxas serialise the wgmma instructions: slower.)
  auto project = [&](int i, auto&& step) {
    for (int ks = 0; ks < ksteps; ++ks) {
      const uint32_t slot = arrived(i + ks);
      wgmma_fence();
      step(slot, ks > 0);
      wgmma_commit();
      wgmma_wait<0>();
      release(i + ks);
    }
  };

  // Phase 1: K and V of the head, resident from here on.
  for (int t = 0; t < tiles; ++t) {
    float kv[64];  // K in columns 0-63, V in 64-127
#pragma unroll
    for (int j = 0; j < 64; ++j) kv[j] = 0.f;
    project(t * ksteps,
            [&](uint32_t slot, int acc) { project_step(kv, slot, slot + kTileBytes, acc); });
    reg_fence(kv);
    const int rows = S - t * kAttnTile;
    store_tile<0>(kv, bias + E + h * kAttnTile, smem + t * kTileBytes, rows);
    store_tile<32>(kv, bias + 2 * E + h * kAttnTile, smem + (tiles + t) * kTileBytes, rows);
  }
  // The threads' stores become visible to wgmma (the async proxy).
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync 1, 128;\n" ::: "memory");

  // Phase 2: per 64-row query tile, q . Wq, then the attention.
  const ResidentTiles src{k_base, v_base};
  for (int t = 0; t < tiles; ++t) {
    float aq[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) aq[j] = 0.f;
    project(items + t * ksteps,
            [&](uint32_t slot, int acc) { project_step(aq, slot, slot + kTileBytes, acc); });
    reg_fence(aq);
    uint32_t qa[4][4];
    acc_to_fragments(aq, bias + h * kAttnTile, qa);
    float out[32];
    attention_core(qa, src, S, tiles, scale, out);
    store_rows(out, o + (size_t)b * S * E + h * kAttnTile, t * kAttnTile, S, E);
  }
}

}  // namespace

// Largest sequence length launch 1 takes: 736 at head dim 64, where the
// head's K and V (192 KB) and one ring stage fill a block's shared memory.
extern "C" int pv_attn_block_max_seq(int head_dim) { return head_dim == kAttnTile ? kMaxSeq : 0; }

// x (B, S, E) bf16, w (3E, E) bf16 (wqkv transposed: row n is output column
// n, packed [q | k | v] with heads contiguous), bias (3E,) bf16 -> o (B, S, E)
// bf16, the heads' attention outputs before the output projection.
extern "C" int pv_attn_block(const void* x, const void* w, const void* bias, void* o, int B,
                             int S, int H, int head_dim, float scale, void* stream) {
  if (head_dim != kAttnTile || S < 1 || S > kMaxSeq || B < 1 || H < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tiles = (S + kAttnTile - 1) / kAttnTile, stages = ring_stages(tiles);
  const int smem = smem_bytes(tiles, stages);
  // first: binds the context the tensor maps need
  cudaFuncSetAttribute(attn_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const uint64_t E = (uint64_t)H * head_dim;
  const uint64_t xdims[3] = {E, (uint64_t)S, (uint64_t)B}, xstrides[2] = {E * 2, E * 2 * S};
  const uint64_t wdims[2] = {E, 3 * E}, wstrides[1] = {E * 2};
  CUtensorMap xmap, wmap;
  if (!pv_tensor_map(&xmap, x, 3, xdims, xstrides, kAttnTile) ||
      !pv_tensor_map(&wmap, w, 2, wdims, wstrides, kAttnTile)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  attn_block_kernel<<<dim3(H, B), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      xmap, wmap, static_cast<const bf16*>(bias), static_cast<bf16*>(o), S, H, stages, scale);
  return static_cast<int>(cudaGetLastError());
}
