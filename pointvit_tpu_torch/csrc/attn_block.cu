// Fused attention sublayer, launch 1 of 2: the qkv projection and the
// multi-head attention, with the (B, S, 3E) qkv activation kept on chip.
//
// Replaces pointvit_tpu/ops/pallas_attention.py::_attn_block_pallas (kernel
// _attn_block_kernel), together with launch 2, o . Wproj + bproj, which is
// one launch of gemm.cu. Per (batch, head) it computes, with the Pallas
// kernel's rounding points (pallas_attention.py:482-501):
//
//     q, k, v = bf16(x . Wqkv[:, head] + bqkv[head])   bf16 products, f32 sum, one rounding
//     P       = softmax(q k^T * D^-1/2)                 f32 logits; max, then sum, then divide
//     o       = bf16(bf16(P) . v)                       f32 accumulation
//
// What bounds it on the H100: per (batch, head) 6*S*E*D FLOPs of projection
// and 4*S*S*D of attention on tensor cores, against reading x (S*E*2 bytes,
// once per head from L2) and the head's 3*D*E weights; at the main-path
// shapes (S = 196..513, E = 384..768) it is bound by operations (the whole
// sublayer at the APF shape: 2.7e11 FLOPs, 0.27 ms at 989 TFLOP/s) and, in
// this simple kernel, by the latency of mma.sync and of the softmax passes.
//
// Design: one block of 4 warps per (batch, head). The head's K and V are
// projected 64 rows at a time (x and the head's 64 columns of Wqkv stream
// through two cp.async stages of 32-deep K steps, as in gemm.cu), biased,
// rounded once and kept whole in shared memory: 2 * S * 72 * 2 bytes, 166 KB
// at S = 576, which bounds S (pv_attn_block_max_seq: 736 at head dim 64). Q
// is projected 64 rows at a time just before use and never leaves registers:
// its accumulator fragments, biased and rounded, are the A operands of Q.K^T.
// Each warp then makes three passes over the keys for its 16 rows (the row
// max of the f32 logits, the sum of exp(l - max), then P = exp(l - max) /
// sum rounded to bf16 and P.V), recomputing the logits each time from the
// same products; no online rescaling. o (B, S, E) bf16 is the only output.
// wgmma and TMA are for a later change.
#include "common.cuh"

#include <math_constants.h>

namespace {

constexpr int kThreads = 128;  // 4 warps x 16 rows
constexpr int kRowTile = 64;   // rows of x per projection tile, = head dim
constexpr int BK = 32, SK = BK + 8;
constexpr int kPipeBytes = 2 * 2 * kRowTile * SK * 2;  // x and W tiles, two stages

template <int D>
struct BlockSmem {  // K and V of the head, then the projection pipeline
  static constexpr int KS = D + 8;
  static size_t bytes(int spad) { return (size_t)2 * spad * KS * 2 + kPipeBytes; }
};

template <int D>
__global__ __launch_bounds__(kThreads) void attn_block_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ w, const bf16* __restrict__ bias,
    bf16* __restrict__ o, int S, int H, int spad, float scale) {
  static_assert(D == kRowTile, "one projection tile is one head's columns");
  constexpr int KS = BlockSmem<D>::KS;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);  // [spad][KS]
  bf16* Vs = Ks + (size_t)spad * KS;         // [spad][KS]
  bf16* Xs = Vs + (size_t)spad * KS;         // [2][kRowTile][SK]
  bf16* Ws = Xs + (size_t)2 * kRowTile * SK;  // [2][D][SK]

  const int h = blockIdx.x, b = blockIdx.y;
  const int E = H * D;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r0 = warp * 16, cq = (lane & 3) * 2;
  const bf16* xb = x + (size_t)b * S * E;
  const int arow = (lane & 7) + ((lane >> 3) & 1) * 8, acol = (lane >> 4) * 8;
  const int brow = (lane & 7) + (lane >> 4) * 8, bcol = ((lane >> 3) & 1) * 8;

  // acc = x[t0 + r0 .. +16) . Wqkv^T[n0 .. n0 + D) (f32, no bias) for this warp.
  auto project = [&](int t0, int n0, float (&acc)[D / 8][4]) {
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
    auto load = [&](int st, int kt) {
      for (int c = tid; c < kRowTile * (BK / 8); c += kThreads) {
        const int r = c >> 2, kc = (c & 3) * 8, gk = kt * BK + kc;
        const bool ok = t0 + r < S;
        cp_async16(&Xs[(st * kRowTile + r) * SK + kc], ok ? xb + (size_t)(t0 + r) * E + gk : xb,
                   ok);
        cp_async16(&Ws[(st * D + r) * SK + kc], w + (size_t)(n0 + r) * E + gk, true);
      }
      cp_async_commit();
    };
    pipeline(E / BK, load, [&](int st, int) {
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        uint32_t a[4];
        ldmatrix_x4(a, &Xs[(st * kRowTile + r0 + arow) * SK + kk + acol]);
#pragma unroll
        for (int nj = 0; nj < D / 16; ++nj) {
          uint32_t r[4];
          ldmatrix_x4(r, &Ws[(st * D + nj * 16 + brow) * SK + kk + bcol]);
          mma_bf16(acc[2 * nj], a, r[0], r[1]);
          mma_bf16(acc[2 * nj + 1], a, r[2], r[3]);
        }
      }
    });
  };

  // K and V of the head: biased, rounded once, rows past S zero.
  for (int t0 = 0; t0 < spad; t0 += kRowTile) {
    for (int part = 1; part <= 2; ++part) {
      float acc[D / 8][4];
      const int n0 = part * E + h * D;
      project(t0, n0, acc);
      bf16* dst = part == 1 ? Ks : Vs;
#pragma unroll
      for (int nt = 0; nt < D / 8; ++nt) {
        const int col = nt * 8 + cq;
        const float b0 = bf2f(bias[n0 + col]), b1 = bf2f(bias[n0 + col + 1]);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = t0 + r0 + (lane >> 2) + half * 8;
          if (row < spad) {
            const bool in = row < S;
            __nv_bfloat162 v;
            v.x = f2bf(in ? acc[nt][2 * half] + b0 : 0.f);
            v.y = f2bf(in ? acc[nt][2 * half + 1] + b1 : 0.f);
            *reinterpret_cast<__nv_bfloat162*>(&dst[row * KS + col]) = v;
          }
        }
      }
    }
  }
  __syncthreads();

  // Scaled f32 logits of this warp's 16 rows against keys [np*16, +16).
  auto logits = [&](const uint32_t (&qf)[D / 16][4], int np, float (&s)[2][4]) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[0][e] = s[1][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t r[4];
      ldmatrix_x4(r, &Ks[(np * 16 + brow) * KS + kk * 16 + bcol]);
      mma_bf16(s[0], qf[kk], r[0], r[1]);
      mma_bf16(s[1], qf[kk], r[2], r[3]);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[0][e] = __fmul_rn(s[0][e], scale);
      s[1][e] = __fmul_rn(s[1][e], scale);
    }
  };
  // Slot e of s[2][4] below is key np*16 + cq + (e & 1) + 8 * (e >> 2) and
  // row half (e >> 1) & 1; a row's statistics reduce over its four lanes.
  const int vrow = arow, vcol = acol;
  for (int q0 = 0; q0 < S; q0 += kRowTile) {
    uint32_t qf[D / 16][4];
    {
      float acc[D / 8][4];
      project(q0, h * D, acc);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int c0 = h * D + kk * 16 + cq, c1 = c0 + 8;
        const float b00 = bf2f(bias[c0]), b01 = bf2f(bias[c0 + 1]);
        const float b10 = bf2f(bias[c1]), b11 = bf2f(bias[c1 + 1]);
        const float(&lo)[4] = acc[2 * kk];
        const float(&hi)[4] = acc[2 * kk + 1];
        qf[kk][0] = pack_bf16(lo[0] + b00, lo[1] + b01);
        qf[kk][1] = pack_bf16(lo[2] + b00, lo[3] + b01);
        qf[kk][2] = pack_bf16(hi[0] + b10, hi[1] + b11);
        qf[kk][3] = pack_bf16(hi[2] + b10, hi[3] + b11);
      }
    }

    float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
    for (int np = 0; np < spad / 16; ++np) {
      float s[2][4];
      logits(qf, np, s);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int c = np * 16 + cq + (e & 1) + (e >> 2) * 8;
        if (c < S) m[(e >> 1) & 1] = fmaxf(m[(e >> 1) & 1], s[e >> 2][e & 3]);
      }
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], 1));
      m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], 2));
    }
    for (int np = 0; np < spad / 16; ++np) {
      float s[2][4];
      logits(qf, np, s);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int c = np * 16 + cq + (e & 1) + (e >> 2) * 8;
        const int i = (e >> 1) & 1;
        if (c < S) sum[i] += expf(s[e >> 2][e & 3] - m[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
    }

    float acc_o[D / 8][4];
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc_o[nt][e] = 0.f;
    for (int np = 0; np < spad / 16; ++np) {
      float s[2][4];
      logits(qf, np, s);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int c = np * 16 + cq + (e & 1) + (e >> 2) * 8;
        const int i = (e >> 1) & 1;
        s[e >> 2][e & 3] = c < S ? expf(s[e >> 2][e & 3] - m[i]) / sum[i] : 0.f;
      }
      const uint32_t pa[4] = {pack_bf16(s[0][0], s[0][1]), pack_bf16(s[0][2], s[0][3]),
                              pack_bf16(s[1][0], s[1][1]), pack_bf16(s[1][2], s[1][3])};
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, &Vs[(np * 16 + vrow) * KS + dp * 16 + vcol]);
        mma_bf16(acc_o[2 * dp], pa, r[0], r[1]);
        mma_bf16(acc_o[2 * dp + 1], pa, r[2], r[3]);
      }
    }
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
      const int col = h * D + nt * 8 + cq;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int q = q0 + r0 + (lane >> 2) + half * 8;
        if (q < S) {
          __nv_bfloat162 pr;
          pr.x = f2bf(acc_o[nt][2 * half]);
          pr.y = f2bf(acc_o[nt][2 * half + 1]);
          *reinterpret_cast<__nv_bfloat162*>(&o[((size_t)b * S + q) * E + col]) = pr;
        }
      }
    }
  }
}

}  // namespace

// Largest sequence length launch 1 takes: the head's K and V and the
// projection pipeline must fit a block's 227 KB of shared memory (736 at
// head dim 64).
extern "C" int pv_attn_block_max_seq(int head_dim) {
  if (head_dim != 64) return 0;
  int s = 1024;
  while (s > 0 && BlockSmem<64>::bytes((s + 15) / 16 * 16) > 227 * 1024) s -= 16;
  return s;
}

// x (B, S, E) bf16, w (3E, E) bf16 (wqkv transposed: row n is output column
// n, packed [q | k | v] with heads contiguous), bias (3E,) bf16 -> o (B, S, E)
// bf16, the heads' attention outputs before the output projection.
extern "C" int pv_attn_block(const void* x, const void* w, const void* bias, void* o, int B,
                             int S, int H, int head_dim, float scale, void* stream) {
  if (head_dim != 64 || S < 1 || S > pv_attn_block_max_seq(head_dim)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int spad = (S + 15) / 16 * 16;
  const size_t smem = BlockSmem<64>::bytes(spad);
  cudaFuncSetAttribute(attn_block_kernel<64>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  attn_block_kernel<64><<<dim3(H, B), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<const bf16*>(bias),
      static_cast<bf16*>(o), S, H, spad, scale);
  return static_cast<int>(cudaGetLastError());
}
