// Backward of packed-qkv multi-head attention.
//
// Replaces pointvit_tpu/ops/pallas_attention.py::_mha_qkv_bwd_pallas (kernels
// _mha_qkv_bwd_kernel and _mha_qkv_bwd_kernel_chunked). Given qkv (B, S, 3E)
// bf16 packed [q | k | v] and the output cotangent g (B, S, E) bf16, it writes
// dqkv (B, S, 3E) bf16 with the Pallas kernel's rounding points
// (pallas_attention.py:303-320):
//
//     P  = softmax(Q K^T * scale)            f32 logits and softmax
//     dP = g V^T                             f32
//     dS = P o (dP - rowsum(dP o P)) * scale f32
//     dQ = bf16(dS) K,  dK = bf16(dS)^T Q,  dV = bf16(P)^T g   (f32 accumulate)
//
// What bounds it. Per (batch, head) the work is 10*S*S*D FLOPs on tensor cores
// (logits twice, dP twice, three products of the gradients) against
// (4*S*D + 3*S*D) * 2 bytes, so at S = 196, D = 64 it is bound by the latency
// of its small products and of the row reductions, not by device memory. The
// TPU kernel keeps two (H, S, S) f32 scratches of a whole item in VMEM; one
// head's P and dP at S = 196 alone take 307 KB, more than a block's 227 KB of
// shared memory, so the work is split by query rows and by keys:
//
// Launch A (rows): one block of 4 warps per (batch, head, 64-query tile), K
// and V of the head staged in shared memory as in block.cu's forward. Each
// warp recomputes the logits of its 16 rows over all keys, runs the f32
// softmax a row at a time and keeps P in f32 in shared memory; dP = g V^T is
// computed twice from registers (mma.sync), once for delta = rowsum(dP o P)
// and once for dS, whose accumulator fragments are repacked to bf16 operand
// fragments and multiplied by K at once: dS never leaves registers. It
// writes dQ and each row's (max, sum, delta) in f32.
//
// Launch B (keys): one block of 4 warps per (batch, head, 64-key tile), Q and
// g of the whole head in shared memory. Each warp owns 16 keys and loops over
// all queries 16 at a time: it rebuilds P^T from the saved row statistics and
// dS^T from delta, and accumulates dV += bf16(P)^T g and dK += bf16(dS)^T Q in
// registers. Every output tile is written once: no atomics, so two runs give
// bit-equal results.
//
// Launch B's P is rebuilt with the same operations as launch A's (a rounded
// product by scale, expf of the difference with the row max, an IEEE divide by
// the row sum); its logits come from the same bf16 products with the operands
// of the tensor-core step swapped. Where that changes a last f32 bit, a bf16
// rounding of P or dS can move by one step: the same size of difference that
// separates the kernel from its plain version.
//
// Past S = 416 launch A's K, V and P tile no longer fit shared memory (its
// softmax registers stop at 448), nor, further on, launch B's Q and g. The
// long variants take S up to 1024 (the JAX kernel's reach,
// pallas_attention.py:384-395) by tiling the other axis.
// Launch A' streams K and V in 64-key tiles and makes four passes over them,
// recomputing the logits each time: the row max, the row sum, delta, then dS
// and dQ. Launch B' streams Q, g and the row statistics in 64-query tiles.
// Same rounding points, still no atomics.
#include "common.cuh"

#include <math_constants.h>

namespace {

constexpr int kTile = 64;       // query rows (launch A) or keys (launch B) per block
constexpr int kThreads = 128;   // 4 warps x 16 rows
constexpr int kMaxPerLane = 14;  // softmax registers per lane: S <= 448

template <int D>
struct RowSmem {  // launch A: K, V, then the f32 P tile, which first holds Q and g
  static constexpr int KS = D + 8;
  __host__ __device__ static int ls(int spad) { return spad + 4; }
  static size_t bytes(int spad) {
    const size_t p = (size_t)kTile * ls(spad) * 4, qg = (size_t)2 * kTile * KS * 2;
    return (size_t)2 * spad * KS * 2 + (p > qg ? p : qg);
  }
};

template <int D>
struct KeySmem {  // launch B: Q and g of the head, the K and V tiles, row statistics
  static constexpr int KS = D + 8;
  static size_t bytes(int spad) {
    return (size_t)(2 * spad + 2 * kTile) * KS * 2 + (size_t)3 * spad * 4;
  }
};

// Stage rows [r0, r0 + rows) of one head's D columns at column offset `col`
// of a (S, stride) bf16 matrix into shared memory; rows past S are zeros.
template <int D>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src, int r0, int rows, int S,
                                           int stride) {
  constexpr int KS = D + 8, CH = D / 8;
  for (int c = threadIdx.x; c < rows * CH; c += kThreads) {
    const int r = c / CH, cc = (c % CH) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r0 + r < S) v = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * stride + cc);
    *reinterpret_cast<uint4*>(&dst[r * KS + cc]) = v;
  }
}

// Write a warp's 16 x D f32 accumulator tile as bf16 rows of a (S, stride) matrix.
template <int D>
__device__ __forceinline__ void store_rows(bf16* dst, const float (&acc)[D / 8][4], int row0,
                                           int S, int stride) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
    const int col = nt * 8 + (lane & 3) * 2;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = row0 + (lane >> 2) + half * 8;
      if (r < S) {
        __nv_bfloat162 pr;
        pr.x = f2bf(acc[nt][2 * half]);
        pr.y = f2bf(acc[nt][2 * half + 1]);
        *reinterpret_cast<__nv_bfloat162*>(&dst[(size_t)r * stride + col]) = pr;
      }
    }
  }
}

// ------------------------------------------------------------ launch A: rows

template <int D>
__global__ __launch_bounds__(kThreads) void attn_bwd_rows_kernel(
    const bf16* __restrict__ qkv, const bf16* __restrict__ g, bf16* __restrict__ dqkv,
    float* __restrict__ stats, int B, int S, int H, int spad, float scale) {
  constexpr int KS = RowSmem<D>::KS;
  const int LS = RowSmem<D>::ls(spad);
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + (size_t)spad * KS;
  float* P = reinterpret_cast<float*>(Vs + (size_t)spad * KS);  // [kTile][LS]
  bf16* Qs = reinterpret_cast<bf16*>(P);  // [kTile][KS], read before P is written
  bf16* Gs = Qs + (size_t)kTile * KS;

  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int E = H * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bf16* base = qkv + (size_t)b * S * 3 * E + h * D;
  stage_rows<D>(Ks, base + E, 0, spad, S, 3 * E);
  stage_rows<D>(Vs, base + 2 * E, 0, spad, S, 3 * E);
  stage_rows<D>(Qs, base, q0, kTile, S, 3 * E);
  stage_rows<D>(Gs, g + (size_t)b * S * E + h * D, q0, kTile, S, E);
  __syncthreads();

  const int arow = (lane & 7) + ((lane >> 3) & 1) * 8, acol = (lane >> 4) * 8;
  const int brow = (lane & 7) + (lane >> 4) * 8, bcol = ((lane >> 3) & 1) * 8;
  const int r0 = warp * 16;
  uint32_t qf[D / 16][4], gf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    ldmatrix_x4(qf[kk], &Qs[(r0 + arow) * KS + kk * 16 + acol]);
    ldmatrix_x4(gf[kk], &Gs[(r0 + arow) * KS + kk * 16 + acol]);
  }
  __syncthreads();  // the Q and g tiles are dead from here; their bytes become P

  // Logits of this warp's 16 rows over all keys, f32, scaled; padded keys -inf.
  for (int np = 0; np < spad / 16; ++np) {
    float s0[4] = {0.f, 0.f, 0.f, 0.f}, s1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t r[4];
      ldmatrix_x4(r, &Ks[(np * 16 + brow) * KS + kk * 16 + bcol]);
      mma_bf16(s0, qf[kk], r[0], r[1]);
      mma_bf16(s1, qf[kk], r[2], r[3]);
    }
    const int row = r0 + (lane >> 2), col = np * 16 + (lane & 3) * 2;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int rr = row + (e >> 1) * 8;
      const int c0 = col + (e & 1), c1 = c0 + 8;
      P[rr * LS + c0] = c0 < S ? __fmul_rn(s0[e], scale) : -CUDART_INF_F;
      P[rr * LS + c1] = c1 < S ? __fmul_rn(s1[e], scale) : -CUDART_INF_F;
    }
  }
  __syncwarp();

  // Softmax row by row, P kept in f32 over its own row; (max, sum) saved.
  const size_t bhs = (size_t)B * H * S, head_row = ((size_t)b * H + h) * S;
  for (int rr = r0; rr < r0 + 16; ++rr) {
    float v[kMaxPerLane];
    float m = -CUDART_INF_F;
#pragma unroll
    for (int i = 0; i < kMaxPerLane; ++i) {
      const int c = lane + 32 * i;
      v[i] = c < S ? P[rr * LS + c] : -CUDART_INF_F;
      m = fmaxf(m, v[i]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxPerLane; ++i) {
      const int c = lane + 32 * i;
      v[i] = c < S ? expf(v[i] - m) : 0.f;
      sum += v[i];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    __syncwarp();
#pragma unroll
    for (int i = 0; i < kMaxPerLane; ++i) {
      const int c = lane + 32 * i;
      if (c < spad) P[rr * LS + c] = v[i] / sum;
    }
    if (lane == 0 && q0 + rr < S) {
      stats[head_row + q0 + rr] = m;
      stats[bhs + head_row + q0 + rr] = sum;
    }
    __syncwarp();
  }

  // dP = g V^T for 16 keys at a time (accumulator layout of two n8 tiles).
  auto dp_chunk = [&](int np, float (&d0)[4], float (&d1)[4]) {
#pragma unroll
    for (int e = 0; e < 4; ++e) d0[e] = d1[e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t r[4];
      ldmatrix_x4(r, &Vs[(np * 16 + brow) * KS + kk * 16 + bcol]);
      mma_bf16(d0, gf[kk], r[0], r[1]);
      mma_bf16(d1, gf[kk], r[2], r[3]);
    }
  };

  // Pass 1: delta = rowsum(dP o P) for the lane's two rows.
  float delta[2] = {0.f, 0.f};
  for (int np = 0; np < spad / 16; ++np) {
    float d0[4], d1[4];
    dp_chunk(np, d0, d1);
    const int row = r0 + (lane >> 2), col = np * 16 + (lane & 3) * 2;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int rr = row + (e >> 1) * 8;
      const int c0 = col + (e & 1), c1 = c0 + 8;
      if (c0 < S) delta[e >> 1] += d0[e] * P[rr * LS + c0];
      if (c1 < S) delta[e >> 1] += d1[e] * P[rr * LS + c1];
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    delta[i] += __shfl_xor_sync(0xffffffffu, delta[i], 1);
    delta[i] += __shfl_xor_sync(0xffffffffu, delta[i], 2);
  }
  if ((lane & 3) == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int q = q0 + r0 + (lane >> 2) + i * 8;
      if (q < S) stats[2 * bhs + head_row + q] = delta[i];
    }
  }

  // Pass 2: dS = P o (dP - delta) * scale, rounded to bf16 as an operand
  // fragment, and dQ += dS K with K read through ldmatrix.trans.
  float dq[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[nt][e] = 0.f;
  const int vrow = (lane & 7) + ((lane >> 3) & 1) * 8, vcol = (lane >> 4) * 8;
  for (int np = 0; np < spad / 16; ++np) {
    float d0[4], d1[4];
    dp_chunk(np, d0, d1);
    const int row = r0 + (lane >> 2), col = np * 16 + (lane & 3) * 2;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int rr = row + (e >> 1) * 8;
      const int c0 = col + (e & 1), c1 = c0 + 8;
      d0[e] = c0 < S ? P[rr * LS + c0] * (d0[e] - delta[e >> 1]) * scale : 0.f;
      d1[e] = c1 < S ? P[rr * LS + c1] * (d1[e] - delta[e >> 1]) * scale : 0.f;
    }
    const uint32_t a[4] = {pack_bf16(d0[0], d0[1]), pack_bf16(d0[2], d0[3]),
                           pack_bf16(d1[0], d1[1]), pack_bf16(d1[2], d1[3])};
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t r[4];
      ldmatrix_x4_trans(r, &Ks[(np * 16 + vrow) * KS + dp * 16 + vcol]);
      mma_bf16(dq[2 * dp], a, r[0], r[1]);
      mma_bf16(dq[2 * dp + 1], a, r[2], r[3]);
    }
  }
  store_rows<D>(dqkv + (size_t)b * S * 3 * E + h * D, dq, q0 + r0, S, 3 * E);
}

// ------------------------------------------------------------ launch B: keys

template <int D>
__global__ __launch_bounds__(kThreads) void attn_bwd_keys_kernel(
    const bf16* __restrict__ qkv, const bf16* __restrict__ g, bf16* __restrict__ dqkv,
    const float* __restrict__ stats, int B, int S, int H, int spad, float scale) {
  constexpr int KS = KeySmem<D>::KS;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Gs = Qs + (size_t)spad * KS;
  bf16* Kt = Gs + (size_t)spad * KS;
  bf16* Vt = Kt + (size_t)kTile * KS;
  float* Ms = reinterpret_cast<float*>(Vt + (size_t)kTile * KS);
  float* Ls = Ms + spad;
  float* Ds = Ls + spad;

  const int k0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int E = H * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bf16* base = qkv + (size_t)b * S * 3 * E + h * D;
  stage_rows<D>(Qs, base, 0, spad, S, 3 * E);
  stage_rows<D>(Gs, g + (size_t)b * S * E + h * D, 0, spad, S, E);
  stage_rows<D>(Kt, base + E, k0, kTile, S, 3 * E);
  stage_rows<D>(Vt, base + 2 * E, k0, kTile, S, 3 * E);
  const size_t bhs = (size_t)B * H * S, head_row = ((size_t)b * H + h) * S;
  for (int q = threadIdx.x; q < spad; q += kThreads) {
    const bool in = q < S;
    Ms[q] = in ? stats[head_row + q] : 0.f;
    Ls[q] = in ? stats[bhs + head_row + q] : 1.f;
    Ds[q] = in ? stats[2 * bhs + head_row + q] : 0.f;
  }
  __syncthreads();

  const int arow = (lane & 7) + ((lane >> 3) & 1) * 8, acol = (lane >> 4) * 8;
  const int brow = (lane & 7) + (lane >> 4) * 8, bcol = ((lane >> 3) & 1) * 8;
  const int vrow = arow, vcol = acol;
  const int r0 = warp * 16;
  uint32_t kf[D / 16][4], vf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    ldmatrix_x4(kf[kk], &Kt[(r0 + arow) * KS + kk * 16 + acol]);
    ldmatrix_x4(vf[kk], &Vt[(r0 + arow) * KS + kk * 16 + acol]);
  }
  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[nt][e] = dv[nt][e] = 0.f;

  for (int qc = 0; qc < spad / 16; ++qc) {
    // S^T and dP^T for this warp's 16 keys x 16 queries.
    float s0[4] = {0.f, 0.f, 0.f, 0.f}, s1[4] = {0.f, 0.f, 0.f, 0.f};
    float d0[4] = {0.f, 0.f, 0.f, 0.f}, d1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t r[4];
      ldmatrix_x4(r, &Qs[(qc * 16 + brow) * KS + kk * 16 + bcol]);
      mma_bf16(s0, kf[kk], r[0], r[1]);
      mma_bf16(s1, kf[kk], r[2], r[3]);
      ldmatrix_x4(r, &Gs[(qc * 16 + brow) * KS + kk * 16 + bcol]);
      mma_bf16(d0, vf[kk], r[0], r[1]);
      mma_bf16(d1, vf[kk], r[2], r[3]);
    }
    const int col = qc * 16 + (lane & 3) * 2;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c0 = col + (e & 1), c1 = c0 + 8;
      const float p0 = c0 < S ? expf(__fmul_rn(s0[e], scale) - Ms[c0]) / Ls[c0] : 0.f;
      const float p1 = c1 < S ? expf(__fmul_rn(s1[e], scale) - Ms[c1]) / Ls[c1] : 0.f;
      d0[e] = c0 < S ? p0 * (d0[e] - Ds[c0]) * scale : 0.f;
      d1[e] = c1 < S ? p1 * (d1[e] - Ds[c1]) * scale : 0.f;
      s0[e] = p0;
      s1[e] = p1;
    }
    const uint32_t pa[4] = {pack_bf16(s0[0], s0[1]), pack_bf16(s0[2], s0[3]),
                            pack_bf16(s1[0], s1[1]), pack_bf16(s1[2], s1[3])};
    const uint32_t da[4] = {pack_bf16(d0[0], d0[1]), pack_bf16(d0[2], d0[3]),
                            pack_bf16(d1[0], d1[1]), pack_bf16(d1[2], d1[3])};
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t r[4];
      ldmatrix_x4_trans(r, &Gs[(qc * 16 + vrow) * KS + dp * 16 + vcol]);
      mma_bf16(dv[2 * dp], pa, r[0], r[1]);
      mma_bf16(dv[2 * dp + 1], pa, r[2], r[3]);
      ldmatrix_x4_trans(r, &Qs[(qc * 16 + vrow) * KS + dp * 16 + vcol]);
      mma_bf16(dk[2 * dp], da, r[0], r[1]);
      mma_bf16(dk[2 * dp + 1], da, r[2], r[3]);
    }
  }
  bf16* out = dqkv + (size_t)b * S * 3 * E + h * D;
  store_rows<D>(out + E, dk, k0 + r0, S, 3 * E);
  store_rows<D>(out + 2 * E, dv, k0 + r0, S, 3 * E);
}

// ------------------------------------------------- long sequences (S > 416)

constexpr int kLongMaxSeq = 1024;

// Longest S that launches A and B take: launch A's shared memory and the
// softmax's registers bound it (416 at head dim 64).
int short_max_seq() {
  int s = 32 * kMaxPerLane;
  while (s > 0 && RowSmem<64>::bytes((s + 15) / 16 * 16) > 227 * 1024) s -= 16;
  return s;
}

template <int D>
struct LongSmem {
  static constexpr int KS = D + 8;
  // launch A': the Q and g tiles, then two stages of a K tile and a V tile
  static constexpr size_t kRows = (size_t)6 * kTile * KS * 2;
  // launch B': the K and V tiles, then two stages of Q, g and row statistics
  static constexpr size_t kKeys = (size_t)6 * kTile * KS * 2 + (size_t)2 * 3 * kTile * 4;
};

template <int D>
__global__ __launch_bounds__(kThreads) void attn_bwd_rows_long_kernel(
    const bf16* __restrict__ qkv, const bf16* __restrict__ g, bf16* __restrict__ dqkv,
    float* __restrict__ stats, int B, int S, int H, float scale) {
  constexpr int KS = LongSmem<D>::KS;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Gs = Qs + (size_t)kTile * KS;
  bf16* Kt = Gs + (size_t)kTile * KS;      // [2][kTile][KS]
  bf16* Vt = Kt + (size_t)2 * kTile * KS;  // [2][kTile][KS]

  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int E = H * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bf16* base = qkv + (size_t)b * S * 3 * E + h * D;
  stage_rows_async<D, kThreads>(Qs, base, q0, kTile, S, 3 * E);
  stage_rows_async<D, kThreads>(Gs, g + (size_t)b * S * E + h * D, q0, kTile, S, E);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int arow = (lane & 7) + ((lane >> 3) & 1) * 8, acol = (lane >> 4) * 8;
  const int brow = (lane & 7) + (lane >> 4) * 8, bcol = ((lane >> 3) & 1) * 8;
  const int vrow = arow, vcol = acol;
  const int r0 = warp * 16, cq = (lane & 3) * 2;
  uint32_t qf[D / 16][4], gf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    ldmatrix_x4(qf[kk], &Qs[(r0 + arow) * KS + kk * 16 + acol]);
    ldmatrix_x4(gf[kk], &Gs[(r0 + arow) * KS + kk * 16 + acol]);
  }

  // a (16 rows) x B^T over 16 keys of a staged tile, two n8 accumulator tiles.
  auto product = [&](const uint32_t (&a)[D / 16][4], const bf16* T, int np, float (&d0)[4],
                     float (&d1)[4]) {
#pragma unroll
    for (int e = 0; e < 4; ++e) d0[e] = d1[e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t r[4];
      ldmatrix_x4(r, &T[(np * 16 + brow) * KS + kk * 16 + bcol]);
      mma_bf16(d0, a[kk], r[0], r[1]);
      mma_bf16(d1, a[kk], r[2], r[3]);
    }
  };
  const int tiles = (S + kTile - 1) / kTile;
  auto stage = [&](bf16* dst, int col, int st, int t) {
    stage_rows_async<D, kThreads>(dst + (size_t)st * kTile * KS, base + col, t * kTile, kTile, S,
                                  3 * E);
  };
  auto load_k = [&](int st, int t) {
    stage(Kt, E, st, t);
    cp_async_commit();
  };
  auto load_kv = [&](int st, int t) {
    stage(Kt, E, st, t);
    stage(Vt, 2 * E, st, t);
    cp_async_commit();
  };
  // Below, slot e of a lane's two n8 accumulator tiles s[e >> 2][e & 3] is
  // key cq + (e & 1) + 8 * (e >> 2) of the 16 and row half (e >> 1) & 1.
  // A row's statistics reduce over the four lanes that share it.
  auto quad_reduce = [&](float (&v)[2], bool is_max) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        const float o = __shfl_xor_sync(0xffffffffu, v[i], off);
        v[i] = is_max ? fmaxf(v[i], o) : v[i] + o;
      }
  };

  // Pass 1: row max of the scaled logits.
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
  pipeline(tiles, load_k, [&](int st, int t) {
    const bf16* K = Kt + (size_t)st * kTile * KS;
#pragma unroll
    for (int np = 0; np < kTile / 16; ++np) {
      float s[2][4];
      product(qf, K, np, s[0], s[1]);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int c = t * kTile + np * 16 + cq + (e & 1) + (e >> 2) * 8;
        if (c < S) m[(e >> 1) & 1] = fmaxf(m[(e >> 1) & 1], __fmul_rn(s[e >> 2][e & 3], scale));
      }
    }
  });
  quad_reduce(m, true);

  // Pass 2: row sum of exp(l - max).
  float sum[2] = {0.f, 0.f};
  pipeline(tiles, load_k, [&](int st, int t) {
    const bf16* K = Kt + (size_t)st * kTile * KS;
#pragma unroll
    for (int np = 0; np < kTile / 16; ++np) {
      float s[2][4];
      product(qf, K, np, s[0], s[1]);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int c = t * kTile + np * 16 + cq + (e & 1) + (e >> 2) * 8;
        const int i = (e >> 1) & 1;
        if (c < S) sum[i] += expf(__fmul_rn(s[e >> 2][e & 3], scale) - m[i]);
      }
    }
  });
  quad_reduce(sum, false);

  // Pass 3: delta = rowsum(dP o P), P in f32.
  float delta[2] = {0.f, 0.f};
  pipeline(tiles, load_kv, [&](int st, int t) {
    const bf16* K = Kt + (size_t)st * kTile * KS;
    const bf16* V = Vt + (size_t)st * kTile * KS;
#pragma unroll
    for (int np = 0; np < kTile / 16; ++np) {
      float s[2][4], d[2][4];
      product(qf, K, np, s[0], s[1]);
      product(gf, V, np, d[0], d[1]);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int c = t * kTile + np * 16 + cq + (e & 1) + (e >> 2) * 8;
        const int i = (e >> 1) & 1;
        if (c < S) {
          const float p = expf(__fmul_rn(s[e >> 2][e & 3], scale) - m[i]) / sum[i];
          delta[i] += d[e >> 2][e & 3] * p;
        }
      }
    }
  });
  quad_reduce(delta, false);
  const size_t bhs = (size_t)B * H * S, head_row = ((size_t)b * H + h) * S;
  if ((lane & 3) == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int q = q0 + r0 + (lane >> 2) + i * 8;
      if (q < S) {
        stats[head_row + q] = m[i];
        stats[bhs + head_row + q] = sum[i];
        stats[2 * bhs + head_row + q] = delta[i];
      }
    }
  }

  // Pass 4: dS = P o (dP - delta) * scale, rounded to bf16 as an operand
  // fragment, and dQ += dS K with K read through ldmatrix.trans.
  float dq[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[nt][e] = 0.f;
  pipeline(tiles, load_kv, [&](int st, int t) {
    const bf16* K = Kt + (size_t)st * kTile * KS;
    const bf16* V = Vt + (size_t)st * kTile * KS;
#pragma unroll
    for (int np = 0; np < kTile / 16; ++np) {
      float s[2][4], d[2][4];
      product(qf, K, np, s[0], s[1]);
      product(gf, V, np, d[0], d[1]);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int c = t * kTile + np * 16 + cq + (e & 1) + (e >> 2) * 8;
        const int i = (e >> 1) & 1;
        float ds = 0.f;
        if (c < S) {
          const float p = expf(__fmul_rn(s[e >> 2][e & 3], scale) - m[i]) / sum[i];
          ds = p * (d[e >> 2][e & 3] - delta[i]) * scale;
        }
        d[e >> 2][e & 3] = ds;
      }
      const uint32_t a[4] = {pack_bf16(d[0][0], d[0][1]), pack_bf16(d[0][2], d[0][3]),
                             pack_bf16(d[1][0], d[1][1]), pack_bf16(d[1][2], d[1][3])};
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, &K[(np * 16 + vrow) * KS + dp * 16 + vcol]);
        mma_bf16(dq[2 * dp], a, r[0], r[1]);
        mma_bf16(dq[2 * dp + 1], a, r[2], r[3]);
      }
    }
  });
  store_rows<D>(dqkv + (size_t)b * S * 3 * E + h * D, dq, q0 + r0, S, 3 * E);
}

template <int D>
__global__ __launch_bounds__(kThreads) void attn_bwd_keys_long_kernel(
    const bf16* __restrict__ qkv, const bf16* __restrict__ g, bf16* __restrict__ dqkv,
    const float* __restrict__ stats, int B, int S, int H, float scale) {
  constexpr int KS = LongSmem<D>::KS;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Kt = reinterpret_cast<bf16*>(smem);
  bf16* Vt = Kt + (size_t)kTile * KS;
  bf16* Qs = Vt + (size_t)kTile * KS;      // [2][kTile][KS]
  bf16* Gs = Qs + (size_t)2 * kTile * KS;  // [2][kTile][KS]
  float* St = reinterpret_cast<float*>(Gs + (size_t)2 * kTile * KS);  // [2][3][kTile]

  const int k0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int E = H * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bf16* base = qkv + (size_t)b * S * 3 * E + h * D;
  const bf16* gb = g + (size_t)b * S * E + h * D;
  stage_rows_async<D, kThreads>(Kt, base + E, k0, kTile, S, 3 * E);
  stage_rows_async<D, kThreads>(Vt, base + 2 * E, k0, kTile, S, 3 * E);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int arow = (lane & 7) + ((lane >> 3) & 1) * 8, acol = (lane >> 4) * 8;
  const int brow = (lane & 7) + (lane >> 4) * 8, bcol = ((lane >> 3) & 1) * 8;
  const int vrow = arow, vcol = acol;
  const int r0 = warp * 16;
  uint32_t kf[D / 16][4], vf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    ldmatrix_x4(kf[kk], &Kt[(r0 + arow) * KS + kk * 16 + acol]);
    ldmatrix_x4(vf[kk], &Vt[(r0 + arow) * KS + kk * 16 + acol]);
  }
  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[nt][e] = dv[nt][e] = 0.f;

  const size_t bhs = (size_t)B * H * S, head_row = ((size_t)b * H + h) * S;
  auto load = [&](int st, int t) {
    stage_rows_async<D, kThreads>(Qs + (size_t)st * kTile * KS, base, t * kTile, kTile, S, 3 * E);
    stage_rows_async<D, kThreads>(Gs + (size_t)st * kTile * KS, gb, t * kTile, kTile, S, E);
    cp_async_commit();
    float* ms = St + (size_t)st * 3 * kTile;
    for (int q = threadIdx.x; q < kTile; q += kThreads) {
      const int gq = t * kTile + q;
      const bool in = gq < S;
      ms[q] = in ? stats[head_row + gq] : 0.f;
      ms[kTile + q] = in ? stats[bhs + head_row + gq] : 1.f;
      ms[2 * kTile + q] = in ? stats[2 * bhs + head_row + gq] : 0.f;
    }
  };
  pipeline((S + kTile - 1) / kTile, load, [&](int st, int t) {
    const bf16* Q = Qs + (size_t)st * kTile * KS;
    const bf16* G = Gs + (size_t)st * kTile * KS;
    const float* Ms = St + (size_t)st * 3 * kTile;
    const float* Ls = Ms + kTile;
    const float* Ds = Ls + kTile;
#pragma unroll
    for (int qc = 0; qc < kTile / 16; ++qc) {
      // S^T and dP^T for this warp's 16 keys x 16 queries.
      float s0[4] = {0.f, 0.f, 0.f, 0.f}, s1[4] = {0.f, 0.f, 0.f, 0.f};
      float d0[4] = {0.f, 0.f, 0.f, 0.f}, d1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t r[4];
        ldmatrix_x4(r, &Q[(qc * 16 + brow) * KS + kk * 16 + bcol]);
        mma_bf16(s0, kf[kk], r[0], r[1]);
        mma_bf16(s1, kf[kk], r[2], r[3]);
        ldmatrix_x4(r, &G[(qc * 16 + brow) * KS + kk * 16 + bcol]);
        mma_bf16(d0, vf[kk], r[0], r[1]);
        mma_bf16(d1, vf[kk], r[2], r[3]);
      }
      const int col = qc * 16 + (lane & 3) * 2;  // query within the tile
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c0 = col + (e & 1), c1 = c0 + 8;
        const bool in0 = t * kTile + c0 < S, in1 = t * kTile + c1 < S;
        const float p0 = in0 ? expf(__fmul_rn(s0[e], scale) - Ms[c0]) / Ls[c0] : 0.f;
        const float p1 = in1 ? expf(__fmul_rn(s1[e], scale) - Ms[c1]) / Ls[c1] : 0.f;
        d0[e] = in0 ? p0 * (d0[e] - Ds[c0]) * scale : 0.f;
        d1[e] = in1 ? p1 * (d1[e] - Ds[c1]) * scale : 0.f;
        s0[e] = p0;
        s1[e] = p1;
      }
      const uint32_t pa[4] = {pack_bf16(s0[0], s0[1]), pack_bf16(s0[2], s0[3]),
                              pack_bf16(s1[0], s1[1]), pack_bf16(s1[2], s1[3])};
      const uint32_t da[4] = {pack_bf16(d0[0], d0[1]), pack_bf16(d0[2], d0[3]),
                              pack_bf16(d1[0], d1[1]), pack_bf16(d1[2], d1[3])};
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, &G[(qc * 16 + vrow) * KS + dp * 16 + vcol]);
        mma_bf16(dv[2 * dp], pa, r[0], r[1]);
        mma_bf16(dv[2 * dp + 1], pa, r[2], r[3]);
        ldmatrix_x4_trans(r, &Q[(qc * 16 + vrow) * KS + dp * 16 + vcol]);
        mma_bf16(dk[2 * dp], da, r[0], r[1]);
        mma_bf16(dk[2 * dp + 1], da, r[2], r[3]);
      }
    }
  });
  bf16* out = dqkv + (size_t)b * S * 3 * E + h * D;
  store_rows<D>(out + E, dk, k0 + r0, S, 3 * E);
  store_rows<D>(out + 2 * E, dv, k0 + r0, S, 3 * E);
}

}  // namespace

// Largest sequence length the backward takes: 1024 at head dim 64. Launches
// A and B serve S <= 416, the long variants the rest.
extern "C" int pv_attention_bwd_max_seq(int head_dim) { return head_dim == 64 ? kLongMaxSeq : 0; }

// qkv (B, S, 3E) bf16 packed [q | k | v], g (B, S, E) bf16 -> dqkv (B, S, 3E)
// bf16. stats: (3, B, H, S) f32 scratch (row max, row sum, delta), written by
// launch A and read by launch B.
extern "C" int pv_attention_bwd(const void* qkv, const void* g, void* dqkv, void* stats, int B,
                                int S, int H, int head_dim, float scale, void* stream) {
  if (head_dim != 64 || S < 1 || S > pv_attention_bwd_max_seq(head_dim)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((S + kTile - 1) / kTile, H, B);
  if (S > short_max_seq()) {
    const size_t smem_a = LongSmem<64>::kRows, smem_b = LongSmem<64>::kKeys;
    cudaFuncSetAttribute(attn_bwd_rows_long_kernel<64>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_a);
    cudaFuncSetAttribute(attn_bwd_keys_long_kernel<64>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_b);
    attn_bwd_rows_long_kernel<64><<<grid, kThreads, smem_a, st>>>(
        static_cast<const bf16*>(qkv), static_cast<const bf16*>(g), static_cast<bf16*>(dqkv),
        static_cast<float*>(stats), B, S, H, scale);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    attn_bwd_keys_long_kernel<64><<<grid, kThreads, smem_b, st>>>(
        static_cast<const bf16*>(qkv), static_cast<const bf16*>(g), static_cast<bf16*>(dqkv),
        static_cast<const float*>(stats), B, S, H, scale);
    return static_cast<int>(cudaGetLastError());
  }
  const int spad = (S + 15) / 16 * 16;
  const size_t smem_a = RowSmem<64>::bytes(spad), smem_b = KeySmem<64>::bytes(spad);
  cudaFuncSetAttribute(attn_bwd_rows_kernel<64>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem_a);
  cudaFuncSetAttribute(attn_bwd_keys_kernel<64>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem_b);
  attn_bwd_rows_kernel<64><<<grid, kThreads, smem_a, st>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(g), static_cast<bf16*>(dqkv),
      static_cast<float*>(stats), B, S, H, spad, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_bwd_keys_kernel<64><<<grid, kThreads, smem_b, st>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(g), static_cast<bf16*>(dqkv),
      static_cast<const float*>(stats), B, S, H, spad, scale);
  return static_cast<int>(cudaGetLastError());
}
