// Backward of packed-qkv multi-head attention at any sequence length, D = 64.
//
// Replaces pointvit_tpu/ops/pallas_attention.py::_mha_qkv_bwd_pallas (kernels
// _mha_qkv_bwd_kernel and _mha_qkv_bwd_kernel_chunked) and, above the JAX
// package's Pallas gate (S > 1024 at 12 heads, _bwd_pallas_ok), the
// recompute VJP of _reference_mha_qkv that it runs there. Given qkv (B, S,
// 3E) bf16 packed [q | k | v] and the output cotangent g (B, S, E) bf16, it
// writes dqkv (B, S, 3E) bf16 with the Pallas kernel's rounding points
// (pallas_attention.py:303-320):
//
//     P  = softmax(Q K^T * scale)            f32 logits and softmax
//     dP = g V^T                             f32
//     dS = P o (dP - rowsum(dP o P)) * scale f32
//     dQ = bf16(dS) K,  dK = bf16(dS)^T Q,  dV = bf16(P)^T g   (f32 accumulate)
//
// What bounds it on the H100: per (batch, head) 10 S^2 D useful FLOPs on
// tensor cores (the logits and dP in each launch, dQ, dK, dV) against 7 S D
// bf16 values of device memory, so it is bound by operations from S of a
// few hundred and by bytes below (chip_smoke.py's bound()). The logits and
// dP are computed twice (once per launch) and three times for the rows, 14
// S^2 D FLOPs issued in all, as the residual is qkv alone.
//
// Design (Hopper), two launches that each write their own outputs, so no
// atomics and bit-equal repeats:
//
// Launch A (rows): one block per (64 queries, head, cloud) of one consumer
// warpgroup and one producer warp. The producer loads the Q and g tiles
// once, then streams the head's K|V tiles of 64 keys x 64 dims twice by TMA
// (128-byte swizzle, 3-D maps over (3E, S, B) and (E, S, B), so rows past S
// arrive as zeros) into a three-stage ring. Q and g become register A
// fragments; s = Q K^T and dP = g V^T are one wgmma group per tile, K and V
// read K-major. Pass 1 keeps the row max m, sum = sum(exp(l - m)) and
// a = sum(exp(l - m) dP) online, both rescaled when a tile moves the max
// (attn_core.cuh's tile_stats, plus a), so delta = a / sum comes out of the
// same pass. Pass 2 forms P and dS in registers, packs dS to bf16 as the A
// fragment and runs dQ += dS K with K read MN-major (transpose bit). It
// writes dQ and each row's (m c, 1 / sum, delta) in f32; rows past S are
// finite (zero Q and g rows), so launch B needs no query mask.
//
// Launch B (keys): one block per (64 keys, head, cloud), the same roles. K
// and V stay in shared memory as wgmma A operands (K-major); the producer
// streams Q|g tiles and the three statistics of 64 query rows (plain bulk
// copies). S^T = K Q^T and dP^T = V g^T read Q and g K-major; P^T and dS^T
// become the register A fragments of dV += bf16(P^T) g and dK += bf16(dS^T) Q,
// with g and Q read MN-major, as the forward's P V reads V.
//
// P in both launches is 2^(s c - m c) times 1 / sum (s the unscaled f32
// logit, c = D^-1/2 log2 e: one FMA and the SFU's ex2), by the same
// instructions, so the two launches build the same P from the same logits.
// Shared memory is 64-67 KB per block whatever S is, so the launches take
// any S.
// (Measured slower on an H100 and dropped: issuing tile t + 1's logits and
// dP while tile t's dQ, or dK and dV, are in flight; ptxas then serialises
// the wgmma instructions, C7515, and the launches took 1.2-1.4x as long.)
#include "attn_core.cuh"

namespace {

constexpr int kStages = 3;  // two: up to 3 % slower at S >= 197, the same at 196
constexpr int kThreads = 160;  // warps 0-3: the consumer warpgroup; warp 4: the producer
constexpr int kStatBytes = kAttnTile * 4;  // one statistic of 64 query rows

// Launch A: the Q and g tiles, then the ring of K|V tiles.
constexpr int kRowsRing = 2 * kTileBytes;
constexpr int kRowsBar = kRowsRing + kStages * 2 * kTileBytes;
constexpr int kRowsSmem = kRowsBar + 8 * (1 + 2 * kStages);
// Launch B: the K and V tiles, the ring of Q|g tiles, the ring of statistics.
constexpr int kKeysRing = 2 * kTileBytes;
constexpr int kKeysStats = kKeysRing + kStages * 2 * kTileBytes;
constexpr int kKeysBar = kKeysStats + kStages * 3 * kStatBytes;
constexpr int kKeysSmem = kKeysBar + 8 * (1 + 2 * kStages);

// The ring's load i sits in stage i % kStages, in round i / kStages.
struct Ring {
  uint32_t slots, full, empty, slot_bytes;
  __device__ __forceinline__ uint32_t wait(int i) const {
    mbar_wait(full + 8 * (i % kStages), (i / kStages) & 1);
    return slots + (i % kStages) * slot_bytes;
  }
  __device__ __forceinline__ void release(int i) const { mbar_arrive(empty + 8 * (i % kStages)); }
};

__device__ __forceinline__ void init_barriers(uint32_t once, uint32_t full, uint32_t empty) {
  if (threadIdx.x == 0) {
    mbar_init(once, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 128);  // every consumer thread arrives
    }
    mbar_fence_init();
  }
  __syncthreads();
}

// s = A_s . B_s^T and dp = A_dp . B_dp^T for one 64 x 64 tile pair as one
// wgmma group (A from registers, B K-major at b_s, b_dp); zeroed first.
__device__ __forceinline__ void issue_pair(const uint32_t (&a_s)[4][4], uint32_t b_s,
                                           const uint32_t (&a_dp)[4][4], uint32_t b_dp,
                                           float (&s)[32], float (&dp)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs<0>(s, a_s[kk], desc_kmajor(b_s + 32 * kk), 1);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs<0>(dp, a_dp[kk], desc_kmajor(b_dp + 32 * kk), 1);
  wgmma_commit();
}

// The same with both A operands in shared memory (K-major at a_s, a_dp).
__device__ __forceinline__ void issue_pair_ss(uint32_t a_s, uint32_t b_s, uint32_t a_dp,
                                              uint32_t b_dp, float (&s)[32], float (&dp)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_ss(s, desc_kmajor(a_s + 32 * kk), desc_kmajor(b_s + 32 * kk), 1);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_ss(dp, desc_kmajor(a_dp + 32 * kk), desc_kmajor(b_dp + 32 * kk), 1);
  wgmma_commit();
}

// The A fragment of k-slice kk (16 columns) of a 64 x 64 f32 tile, rounded
// to bf16.
__device__ __forceinline__ void fragment(const float (&d)[32], int kk, uint32_t (&a)[4]) {
  a[0] = pack_bf16(d[8 * kk + 0], d[8 * kk + 1]);
  a[1] = pack_bf16(d[8 * kk + 2], d[8 * kk + 3]);
  a[2] = pack_bf16(d[8 * kk + 4], d[8 * kk + 5]);
  a[3] = pack_bf16(d[8 * kk + 6], d[8 * kk + 7]);
}

// ------------------------------------------------------------ launch A: rows

__global__ __launch_bounds__(kThreads) void attn_bwd_rows_kernel(
    const __grid_constant__ CUtensorMap qkv, const __grid_constant__ CUtensorMap gmap,
    bf16* __restrict__ dqkv, float* __restrict__ stats, int S, int H, int Sp, float scale) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = smem_addr(smem);
  if (base & 1023) __trap();  // the swizzled tiles need 1024-byte alignment
  const uint32_t qbar = base + kRowsBar, full = qbar + 8, empty = full + 8 * kStages;
  const int q0 = blockIdx.x * kAttnTile, h = blockIdx.y, b = blockIdx.z;
  const int E = H * kAttnTile, tiles = (S + kAttnTile - 1) / kAttnTile;
  init_barriers(qbar, full, empty);

  // The role, warp-uniform for the compiler: wgmma must not sit on a path it
  // takes for divergent (ptxas then serialises the wgmma instructions).
  if (__shfl_sync(0xffffffffu, threadIdx.x / 128, 0) == 1) {  // the producer warp
    if (threadIdx.x == 128) {  // one lane issues every load
      mbar_expect_tx(qbar, 2 * kTileBytes);
      tma_load_3d(base, &qkv, qbar, h * kAttnTile, q0, b);
      tma_load_3d(base + kTileBytes, &gmap, qbar, h * kAttnTile, q0, b);
      for (int i = 0; i < 2 * tiles; ++i) {  // K|V tile i % tiles, in pass i / tiles
        const int stage = i % kStages, round = i / kStages, k0 = (i % tiles) * kAttnTile;
        if (round > 0) mbar_wait(empty + 8 * stage, (round - 1) & 1);
        const uint32_t slot = base + kRowsRing + stage * 2 * kTileBytes, bar = full + 8 * stage;
        mbar_expect_tx(bar, 2 * kTileBytes);
        tma_load_3d(slot, &qkv, bar, E + h * kAttnTile, k0, b);
        tma_load_3d(slot + kTileBytes, &qkv, bar, 2 * E + h * kAttnTile, k0, b);
      }
    }
    return;
  }

  mbar_wait(qbar, 0);
  uint32_t qa[4][4], ga[4][4];
  load_q_fragments(smem, qa);
  load_q_fragments(smem + kTileBytes, ga);
  const Ring ring{base + kRowsRing, full, empty, 2 * kTileBytes};
  const float c = scale * 1.4426950408889634f;
  float s[32], dp[32];

  // Pass 1: m, sum and a = sum(exp(l - m) dP), online (rows g and g + 8 of
  // this thread; sum and a are this thread's partial sums, m the row's).
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, sum[2] = {0.f, 0.f}, a[2] = {0.f, 0.f};
  for (int t = 0; t < tiles; ++t) {
    const uint32_t slot = ring.wait(t);
    issue_pair(qa, slot, ga, slot + kTileBytes, s, dp);
    wgmma_wait<0>();
    reg_fence(s);
    reg_fence(dp);
    ring.release(t);
    if (t == tiles - 1) mask_keys(s, t * kAttnTile, S);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mt = m[r];
#pragma unroll
      for (int j = 0; j < 8; ++j) mt = fmaxf(mt, fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
      mt = row_max4(mt);  // finite: every tile holds at least one key below S
      const float mc = mt * c, alpha = ex2(m[r] * c - mc);
      float su = sum[r] * alpha, ac = a[r] * alpha;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * r + e;
          const float x = ex2(fmaf(s[i], c, -mc));
          su += x;
          ac = fmaf(x, dp[i], ac);
        }
      }
      sum[r] = su;
      a[r] = ac;
      m[r] = mt;
    }
  }
  float mc[2], inv[2], delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mc[r] = m[r] * c;
    inv[r] = __frcp_rn(row_sum4(sum[r]));
    delta[r] = row_sum4(a[r]) * inv[r];
  }
  const int lane = threadIdx.x & 31;
  if ((lane & 3) == 0) {
    const size_t bh = (size_t)b * H + h, BH = (size_t)gridDim.z * H;
    const int row = q0 + (threadIdx.x >> 5) * 16 + (lane >> 2);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      stats[bh * Sp + row + 8 * r] = mc[r];
      stats[(BH + bh) * Sp + row + 8 * r] = inv[r];
      stats[(2 * BH + bh) * Sp + row + 8 * r] = delta[r];
    }
  }

  // Pass 2: dS = P o (dP - delta) * scale, rounded to bf16 as the A
  // fragment, and dQ += dS . K with K read MN-major.
  float dq[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dq[i] = 0.f;
  for (int t = 0; t < tiles; ++t) {
    const uint32_t slot = ring.wait(tiles + t);
    issue_pair(qa, slot, ga, slot + kTileBytes, s, dp);
    wgmma_wait<0>();
    reg_fence(s);
    reg_fence(dp);
    if (t == tiles - 1) mask_keys(s, t * kAttnTile, S);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;
      const float p = ex2(fmaf(s[i], c, -mc[r])) * inv[r];
      s[i] = p * (dp[i] - delta[r]) * scale;
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t da[4];
      fragment(s, kk, da);
      wgmma_rs<1>(dq, da, desc_mnmajor(slot + 2048 * kk), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(dq);
    ring.release(tiles + t);
  }
  store_rows(dq, dqkv + (size_t)b * S * 3 * E + h * kAttnTile, q0, S, 3 * E);
}

// ------------------------------------------------------------ launch B: keys

__global__ __launch_bounds__(kThreads) void attn_bwd_keys_kernel(
    const __grid_constant__ CUtensorMap qkv, const __grid_constant__ CUtensorMap gmap,
    bf16* __restrict__ dqkv, const float* __restrict__ stats, int S, int H, int Sp, float scale) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = smem_addr(smem);
  if (base & 1023) __trap();
  const uint32_t kbar = base + kKeysBar, full = kbar + 8, empty = full + 8 * kStages;
  const int k0 = blockIdx.x * kAttnTile, h = blockIdx.y, b = blockIdx.z;
  const int E = H * kAttnTile, tiles = (S + kAttnTile - 1) / kAttnTile;
  init_barriers(kbar, full, empty);

  if (__shfl_sync(0xffffffffu, threadIdx.x / 128, 0) == 1) {  // the producer warp
    if (threadIdx.x == 128) {
      mbar_expect_tx(kbar, 2 * kTileBytes);
      tma_load_3d(base, &qkv, kbar, E + h * kAttnTile, k0, b);
      tma_load_3d(base + kTileBytes, &qkv, kbar, 2 * E + h * kAttnTile, k0, b);
      const size_t bh = (size_t)b * H + h, BH = (size_t)gridDim.z * H;
      for (int t = 0; t < tiles; ++t) {  // Q|g tile t and its rows' statistics
        const int stage = t % kStages, round = t / kStages;
        if (round > 0) mbar_wait(empty + 8 * stage, (round - 1) & 1);
        const uint32_t slot = base + kKeysRing + stage * 2 * kTileBytes, bar = full + 8 * stage;
        const uint32_t st = base + kKeysStats + stage * 3 * kStatBytes;
        mbar_expect_tx(bar, 2 * kTileBytes + 3 * kStatBytes);
        tma_load_3d(slot, &qkv, bar, h * kAttnTile, t * kAttnTile, b);
        tma_load_3d(slot + kTileBytes, &gmap, bar, h * kAttnTile, t * kAttnTile, b);
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          bulk_load(st + i * kStatBytes, stats + (i * BH + bh) * Sp + t * kAttnTile, kStatBytes, bar);
        }
      }
    }
    return;
  }

  mbar_wait(kbar, 0);
  const Ring ring{base + kKeysRing, full, empty, 2 * kTileBytes};
  const float c = scale * 1.4426950408889634f;
  const int col = (threadIdx.x & 3) * 2;  // this thread's first query column of each 8
  float st[32], dpt[32], dk[32], dv[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;
  for (int t = 0; t < tiles; ++t) {
    const uint32_t slot = ring.wait(t);
    issue_pair_ss(base, slot, base + kTileBytes, slot + kTileBytes, st, dpt);
    const float* stat = reinterpret_cast<const float*>(smem + kKeysStats + (t % kStages) * 3 * kStatBytes);
    wgmma_wait<0>();
    reg_fence(st);
    reg_fence(dpt);
    // Column q of S^T is query row q: its statistics are per column.
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int q = 8 * j + col;
      const float2 mq = *reinterpret_cast<const float2*>(stat + q);
      const float2 iq = *reinterpret_cast<const float2*>(stat + kAttnTile + q);
      const float2 dl = *reinterpret_cast<const float2*>(stat + 2 * kAttnTile + q);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * j + e;
        const float p = ex2(fmaf(st[i], c, -((e & 1) ? mq.y : mq.x))) * ((e & 1) ? iq.y : iq.x);
        dpt[i] = p * (dpt[i] - ((e & 1) ? dl.y : dl.x)) * scale;
        st[i] = p;
      }
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t pa[4], da[4];
      fragment(st, kk, pa);
      fragment(dpt, kk, da);
      wgmma_rs<1>(dv, pa, desc_mnmajor(slot + kTileBytes + 2048 * kk), 1);
      wgmma_rs<1>(dk, da, desc_mnmajor(slot + 2048 * kk), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(dv);
    reg_fence(dk);
    ring.release(t);
  }
  bf16* out = dqkv + (size_t)b * S * 3 * E + h * kAttnTile;
  store_rows(dk, out + E, k0, S, 3 * E);
  store_rows(dv, out + 2 * E, k0, S, 3 * E);
}

}  // namespace

// qkv (B, S, 3E) bf16 packed [q | k | v], g (B, S, E) bf16 -> dqkv (B, S, 3E)
// bf16; any S >= 1, head_dim 64 only. stats: (3, B, H, Sp) f32 scratch, Sp =
// S rounded up to 64 (m c, 1 / sum, delta per query row), written by launch
// A and read by launch B; its address must be 16-byte aligned.
extern "C" int pv_attention_bwd(const void* qkv, const void* g, void* dqkv, void* stats, int B,
                                int S, int H, int head_dim, float scale, void* stream) {
  if (head_dim != kAttnTile || S < 1 || B < 1 || H < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // first: binds the context the tensor maps need (the backward often runs
  // in an autograd thread whose first CUDA work this is)
  cudaFuncSetAttribute(attn_bwd_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kRowsSmem);
  cudaFuncSetAttribute(attn_bwd_keys_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kKeysSmem);
  const uint64_t E = (uint64_t)H * head_dim;
  const uint64_t qdims[3] = {3 * E, (uint64_t)S, (uint64_t)B}, gdims[3] = {E, (uint64_t)S, (uint64_t)B};
  const uint64_t qstrides[2] = {3 * E * 2, 3 * E * 2 * S}, gstrides[2] = {E * 2, E * 2 * S};
  CUtensorMap qmap, gmap;
  if (!pv_tensor_map(&qmap, qkv, 3, qdims, qstrides, kAttnTile) ||
      !pv_tensor_map(&gmap, g, 3, gdims, gstrides, kAttnTile)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles = (S + kAttnTile - 1) / kAttnTile, Sp = tiles * kAttnTile;
  const dim3 grid(tiles, H, B);
  attn_bwd_rows_kernel<<<grid, kThreads, kRowsSmem, st>>>(qmap, gmap, static_cast<bf16*>(dqkv),
                                                          static_cast<float*>(stats), S, H, Sp, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_bwd_keys_kernel<<<grid, kThreads, kKeysSmem, st>>>(
      qmap, gmap, static_cast<bf16*>(dqkv), static_cast<const float*>(stats), S, H, Sp, scale);
  return static_cast<int>(cudaGetLastError());
}
