// The attention core shared by csrc/attention.cu (packed qkv, K and V
// streamed by TMA) and csrc/attn_block.cu (K and V projected into shared
// memory): one warpgroup's 64 query rows of one head, D = 64, against every
// key of the head, in two passes over 64-key tiles on wgmma.
//
// The rounding points are those of pallas_attention.py::_mha_qkv_pallas and
// pallas_block.py::_attn_two_pass:
//   pass 1  l = bf16(q) . bf16(k)^T in f32, times D^-1/2; keys past S are
//           -inf; the row max m and sum = sum(exp(l - m)) are kept in f32,
//           the sum rescaled by exp(m_old - m_new) whenever a tile moves
//           the max (it differs from the plain version's sum by a few ulps);
//   pass 2  the same logits again, P = exp(l - m) * (1 / sum) rounded to
//           bf16, and o = P . V accumulated in f32, rounded once by the
//           caller.
// exp(l - m) is evaluated as 2^(s c - m c) (s the unscaled f32 logit, c =
// D^-1/2 log2 e, one FMA and the SFU's ex2), and the quotient as a product
// with the reciprocal: before P is rounded to bf16 these lie within a few
// f32 ulps of the plain version's values. Both passes compute the logits
// by the same instructions from the same operands, so pass 2 sees exactly
// the values pass 1 reduced.
//
// Q arrives as the A operand in registers (the m16n8k16 A fragment of each
// warp's 16 rows), so the core is the same whether Q was loaded (kernel A)
// or projected into the accumulator (kernel B). Q.K^T is wgmma m64n64k16
// with K K-major from shared memory; the logits accumulator, exponentiated,
// normalised and packed to bf16, is already P's A fragment, and P.V is
// wgmma m64n64k16 with V MN-major from shared memory (transpose bit set).
//
// Accumulator layout of a 64 x 64 f32 tile (32 floats per thread): warp w,
// lane = 4 g + t; d[4 j + e] is row 16 w + g + 8 (e >> 1), column
// 8 j + 2 t + (e & 1).
#pragma once

#include "common.cuh"
#include "sm90.cuh"

#include <math_constants.h>

constexpr int kAttnTile = 64;  // query rows per warpgroup, keys per tile, and D


// The A fragments of Q rows [16 w, 16 w + 16) from a swizzled 64 x 64 tile.
__device__ __forceinline__ void load_q_fragments(const unsigned char* tile, uint32_t (&qa)[4][4]) {
  const int lane = threadIdx.x & 31, r = (threadIdx.x >> 5 & 3) * 16 + (lane >> 2);
  const int c = (lane & 3) * 2;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    qa[kk][0] = *reinterpret_cast<const uint32_t*>(tile + swz128(r, 16 * kk + c));
    qa[kk][1] = *reinterpret_cast<const uint32_t*>(tile + swz128(r + 8, 16 * kk + c));
    qa[kk][2] = *reinterpret_cast<const uint32_t*>(tile + swz128(r, 16 * kk + 8 + c));
    qa[kk][3] = *reinterpret_cast<const uint32_t*>(tile + swz128(r + 8, 16 * kk + 8 + c));
  }
}

// The A fragments of a projected 64 x 64 accumulator plus its bias (bias[c]
// for column c), rounded once to bf16.
__device__ __forceinline__ void acc_to_fragments(const float (&d)[32], const bf16* bias,
                                                 uint32_t (&qa)[4][4]) {
  const int c = (threadIdx.x & 3) * 2;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const float b0 = bf2f(bias[16 * kk + c]), b1 = bf2f(bias[16 * kk + c + 1]);
    const float b2 = bf2f(bias[16 * kk + 8 + c]), b3 = bf2f(bias[16 * kk + 9 + c]);
    qa[kk][0] = pack_bf16(d[8 * kk + 0] + b0, d[8 * kk + 1] + b1);
    qa[kk][1] = pack_bf16(d[8 * kk + 2] + b0, d[8 * kk + 3] + b1);
    qa[kk][2] = pack_bf16(d[8 * kk + 4] + b2, d[8 * kk + 5] + b3);
    qa[kk][3] = pack_bf16(d[8 * kk + 6] + b2, d[8 * kk + 7] + b3);
  }
}

// Issues s = Q . K^T for one 64-key tile at shared address k_tile
// (unscaled) as one wgmma group; the caller waits for it. s is zeroed
// first, by ordinary instructions outside the wgmma group.
__device__ __forceinline__ void issue_logits(const uint32_t (&qa)[4][4], uint32_t k_tile,
                                             float (&s)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs<0>(s, qa[kk], desc_kmajor(k_tile + 32 * kk), 1);
  wgmma_commit();
}

// Keys at or past S -> -inf (k0: the tile's first key); only the last
// tile has such keys.
__device__ __forceinline__ void mask_keys(float (&s)[32], int k0, int S) {
  const int c = k0 + (threadIdx.x & 3) * 2;
#pragma unroll
  for (int i = 0; i < 32; ++i)
    if (c + 8 * (i >> 2) + (i & 1) >= S) s[i] = -CUDART_INF_F;
}

// 2^x on the special function unit.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Rows g and g + 8 of this thread: reduce over the four lanes of a row.
__device__ __forceinline__ float row_max4(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float row_sum4(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Pass 1 on one tile's unscaled logits: fold the row max (unscaled: the
// scale is positive, so the max of the rounded scaled logits is the
// rounded scaled max) and the sum of exp into m, sum.
__device__ __forceinline__ void tile_stats(const float (&s)[32], float c, float (&m)[2],
                                           float (&sum)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mt = m[r];
#pragma unroll
    for (int j = 0; j < 8; ++j) mt = fmaxf(mt, fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
    mt = row_max4(mt);  // finite: every tile holds at least one key below S
    const float mc = mt * c;
    float acc = sum[r] * ex2(m[r] * c - mc);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      acc += ex2(fmaf(s[4 * j + 2 * r], c, -mc)) + ex2(fmaf(s[4 * j + 2 * r + 1], c, -mc));
    sum[r] = acc;
    m[r] = mt;
  }
}

// o (accumulator layout, f32, not yet rounded) = softmax(q k^T * scale) . v
// over `tiles` 64-key tiles. Tiles: src.k(t, pass) returns the shared
// address of key tile t once it may be read (pass 0, then pass 1),
// src.v(t) that of value tile t in pass 1, and src.release(t, pass) hands
// the tile back. Every thread of the warpgroup calls it.
//
// The softmax's element-wise work, not the tensor cores, bounds this core
// at D = 64, so each logit costs one FMA and one ex2 per pass:
// exp(l - m) = 2^(s c - m c) with s the unscaled logit and c = scale *
// log2(e); keys past S are masked in the last tile only. (Skipping the exp
// of the last tile's 8-key groups wholly past S measured slower: the
// branches cost every tile more than they save in the last.)
template <class Tiles>
__device__ __forceinline__ void attention_core(const uint32_t (&qa)[4][4], Tiles& src, int S,
                                               int tiles, float scale, float (&o)[32]) {
  const float c = scale * 1.4426950408889634f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, sum[2] = {0.f, 0.f};
  float s[32];
  for (int t = 0; t < tiles; ++t) {
    issue_logits(qa, src.k(t, 0), s);
    wgmma_wait<0>();
    reg_fence(s);
    src.release(t, 0);
    if (t == tiles - 1) mask_keys(s, t * kAttnTile, S);
    tile_stats(s, c, m, sum);
  }
  const float mc[2] = {m[0] * c, m[1] * c};
  const float inv[2] = {__frcp_rn(row_sum4(sum[0])), __frcp_rn(row_sum4(sum[1]))};

#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  for (int t = 0; t < tiles; ++t) {
    issue_logits(qa, src.k(t, 1), s);
    wgmma_wait<0>();
    reg_fence(s);
    if (t == tiles - 1) mask_keys(s, t * kAttnTile, S);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;
      s[i] = ex2(fmaf(s[i], c, -mc[r])) * inv[r];
    }
    const uint32_t v_tile = src.v(t);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[8 * kk + 0], s[8 * kk + 1]),
                              pack_bf16(s[8 * kk + 2], s[8 * kk + 3]),
                              pack_bf16(s[8 * kk + 4], s[8 * kk + 5]),
                              pack_bf16(s[8 * kk + 6], s[8 * kk + 7])};
      wgmma_rs<1>(o, pa, desc_mnmajor(v_tile + 2048 * kk), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(o);
    src.release(t, 1);
  }
}

// Rows q0 + [0, 64) of o, rounded to bf16, into out (row stride E) where
// the row is below S.
__device__ __forceinline__ void store_rows(const float (&o)[32], bf16* out, int q0, int S, int E) {
  const int lane = threadIdx.x & 31;
  const int r = q0 + (threadIdx.x >> 5 & 3) * 16 + (lane >> 2), c = (lane & 3) * 2;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      if (r + 8 * half < S) {
        *reinterpret_cast<uint32_t*>(out + (size_t)(r + 8 * half) * E + 8 * j + c) =
            pack_bf16(o[4 * j + 2 * half], o[4 * j + 2 * half + 1]);
      }
    }
  }
}
