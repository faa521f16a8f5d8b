// Packed-qkv multi-head attention forward at any sequence length, D = 64.
//
// Replaces pointvit_tpu/ops/pallas_attention.py::_mha_qkv_pallas, and the
// attention half of pallas_block.py::_apf_block_pallas, _vit_block_pallas
// and _serial_block_pallas (their _attn_two_pass): qkv (B, S, 3E) bf16,
// packed [q | k | v] with heads contiguous, -> out (B, S, E) bf16, scale
// D^-1/2, with the Pallas kernel's rounding points (attn_core.cuh).
//
// What bounds it on the H100: per (batch, head) 4 S^2 D useful FLOPs on
// tensor cores against 4 S D * 2 bytes of device memory. At S >= 513 it is
// bound by operations (chip_smoke.py's bound()); at the APF shape (S = 196)
// by bytes. The two-pass order computes the logits twice (6 S^2 D FLOPs
// issued), which the Pallas rounding point on normalised P requires.
//
// Design (Hopper): one block per (64-query tile, head, cloud), of one
// consumer warpgroup and one producer warp. The producer loads the Q tile
// once, then streams the head's K tiles (pass 1) and K and V tiles (pass 2)
// of 64 keys x 64 dims by TMA into a two-stage ring, with full and empty
// mbarriers. The tensor map is 3-D over (3E, S, B), so a box never crosses
// into the next cloud and rows past S arrive as zeros; the tiles land
// 128-byte swizzled, the layout wgmma's descriptors read. The consumer runs
// attention_core: Q.K^T and P.V on wgmma, the softmax statistics in
// registers, no logits in shared memory. Shared memory is 41 KB per block
// whatever S is, so several blocks share an SM and there is no S limit.
// (Measured slower on an H100 and dropped: two consumer warpgroups per
// block sharing the K/V stream; a second logits buffer so the next tile's
// Q.K^T runs during this tile's softmax, as ptxas then serialises the
// wgmma instructions around the buffer it cannot prove idle. Four ring
// stages instead of two changed nothing.)
#include "attn_core.cuh"

namespace {

constexpr int kStages = 2;
constexpr int kThreads = 160;  // warps 0-3: the consumer warpgroup; warp 4: the producer
constexpr int kRingOff = kTileBytes;                          // after the Q tile
constexpr int kBarOff = kRingOff + kStages * 2 * kTileBytes;  // K and V slot per stage
constexpr int kSmemBytes = kBarOff + 8 * (1 + 2 * kStages);

// The streamed ring as attention_core's tile source: load i (pass 0: K
// tile i; pass 1: K and V tile i - tiles) sits in stage i % kStages.
struct StreamedTiles {
  uint32_t ring, full, empty;
  int tiles;
  __device__ __forceinline__ int index(int t, int pass) const { return pass * tiles + t; }
  __device__ __forceinline__ uint32_t slot(int i) const {
    return ring + (i % kStages) * 2 * kTileBytes;
  }
  __device__ __forceinline__ uint32_t k(int t, int pass) const {
    const int i = index(t, pass);
    mbar_wait(full + 8 * (i % kStages), (i / kStages) & 1);
    return slot(i);
  }
  __device__ __forceinline__ uint32_t v(int t) const { return slot(index(t, 1)) + kTileBytes; }
  __device__ __forceinline__ void release(int t, int pass) const {
    mbar_arrive(empty + 8 * (index(t, pass) % kStages));
  }
};

__global__ __launch_bounds__(kThreads) void attention_fwd_kernel(
    const __grid_constant__ CUtensorMap qkv, bf16* __restrict__ out, int S, int H, float scale) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = smem_addr(smem);
  if (base & 1023) __trap();  // the swizzled tiles need 1024-byte alignment
  const uint32_t ring = base + kRingOff, qbar = base + kBarOff, full = qbar + 8,
                 empty = full + 8 * kStages;
  const int q0 = blockIdx.x * kAttnTile, h = blockIdx.y, b = blockIdx.z;
  const int E = H * kAttnTile, tiles = (S + kAttnTile - 1) / kAttnTile;
  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 128);  // every consumer thread arrives
    }
    mbar_fence_init();
  }
  __syncthreads();

  // The role, warp-uniform for the compiler: wgmma must not sit on a path it
  // takes for divergent (ptxas then serialises the wgmma instructions).
  if (__shfl_sync(0xffffffffu, threadIdx.x / 128, 0) == 1) {  // the producer warp
    if (threadIdx.x == 128) {  // one lane issues every load
      mbar_expect_tx(qbar, kTileBytes);
      tma_load_3d(base, &qkv, qbar, h * kAttnTile, q0, b);
      for (int i = 0; i < 2 * tiles; ++i) {
        const int stage = i % kStages, round = i / kStages, pass = i >= tiles;
        const int k0 = (i - pass * tiles) * kAttnTile;
        if (round > 0) mbar_wait(empty + 8 * stage, (round - 1) & 1);
        const uint32_t slot = ring + stage * 2 * kTileBytes, bar = full + 8 * stage;
        mbar_expect_tx(bar, (1 + pass) * kTileBytes);
        tma_load_3d(slot, &qkv, bar, E + h * kAttnTile, k0, b);
        if (pass) tma_load_3d(slot + kTileBytes, &qkv, bar, 2 * E + h * kAttnTile, k0, b);
      }
    }
    return;
  }

  mbar_wait(qbar, 0);
  uint32_t qa[4][4];
  load_q_fragments(smem, qa);
  StreamedTiles src{ring, full, empty, tiles};
  float o[32];
  attention_core(qa, src, S, tiles, scale, o);
  store_rows(o, out + (size_t)b * S * E + h * kAttnTile, q0, S, E);
}

}  // namespace

// qkv (B, S, 3E) bf16, packed [q | k | v], heads contiguous within each ->
// out (B, S, E) bf16. Any S >= 1; head_dim 64 only.
extern "C" int pv_attention(const void* qkv, void* out, int B, int S, int H, int head_dim,
                            float scale, void* stream) {
  if (head_dim != kAttnTile || S < 1 || B < 1 || H < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaFuncSetAttribute(attention_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       kSmemBytes);  // first: binds the context the tensor map needs
  const uint64_t E3 = 3ull * H * head_dim;
  const uint64_t dims[3] = {E3, (uint64_t)S, (uint64_t)B};
  const uint64_t strides[2] = {E3 * 2, E3 * 2 * S};
  CUtensorMap map;
  if (!pv_tensor_map(&map, qkv, 3, dims, strides, kAttnTile)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((S + kAttnTile - 1) / kAttnTile, H, B);
  attention_fwd_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      map, static_cast<bf16*>(out), S, H, scale);
  return static_cast<int>(cudaGetLastError());
}
