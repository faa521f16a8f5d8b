// The non-GEMM kernels of the APF and ViT blocks: LayerNorm, LayerNorm with
// the positional re-add, and packed-qkv attention.
//
// Replaces, with the GEMM of gemm.cu:
//   - pointvit_tpu/ops/pallas_block.py::_apf_block_pallas (kernels
//     _attn_half_kernel and _mlp_half_kernel);
//   - pointvit_tpu/ops/pallas_block.py::_vit_block_pallas (kernels
//     _vit_attn_half_kernel and _vit_mlp_half_kernel), the Pix4Point block,
//     whose attention half adds the positional embedding before LN1.
// The attention kernel computes what _attn_two_pass does there and is written
// against the packed (B, S, 3E) layout of pallas_attention.py::_mha_qkv_pallas,
// whose forward it also is.
//
// LayerNorm. Bound by bytes: it reads a (rows, E) bf16 tensor and writes one
// of the same size, a few operations per element. One warp per row; the row
// is re-read from L1 for each of the three passes; statistics are f32 and
// eps is 1e-6, the flax default that the JAX package uses. The positional
// variant reads x and pos, writes xp = bf16(x + pos) (the attention half's
// residual) and LN(xp) in the same pass, so the sum is never re-read from
// device memory; a shared (1, S, E) pos is indexed by row % S.
//
// Attention. Per (batch, head) the work is 4*S*S*D FLOPs on tensor cores
// against (3*S*D + S*D) * 2 bytes, so at S = 196..513, D = 64 it is bound by
// the latency of its small products and of the softmax, not by device
// memory. One block of 4 warps per (batch, head, 64-query tile). Shared
// memory is what limits S: K (later V) of the head and a 64-row f32 logits
// tile. K and V are not held together: K is staged first, Q.K^T runs on
// mma.sync into the f32 logits tile (keys past S masked to -inf), then V is
// copied (cp.async) into K's slot while each warp runs the f32 softmax of
// its 16 rows, one row at a time with the warp. At S = 513 that is
// 528 * 72 * 2 + 64 * 532 * 4 = 212 KB, where K, V and the logits together
// (288 KB) would not fit a block's 227 KB. The normalised P is rounded to
// bf16 as pallas_block.py:134 does and written over the same row, and P.V
// runs on mma.sync with V read through ldmatrix.trans. The output is rounded
// to bf16. The exact two-pass order (max, then exp and sum, then divide) is
// the Pallas kernel's; no online rescaling. Staging V later changes no
// arithmetic: the output is bit-identical to the kernel that held K and V
// together. Past S = 576 neither the head's K nor the softmax registers fit,
// and attention_long_kernel takes S up to 1024 (the JAX package's fused
// gate): K and V stream through shared memory in 64-key tiles and the
// logits are recomputed for each of the three passes (max, sum, P.V), with
// the same rounding points.
#include "common.cuh"

#include <math_constants.h>

namespace {

// ---------------------------------------------------------------- LayerNorm

constexpr int kLnRows = 8;  // rows per block, one warp each

__global__ __launch_bounds__(kLnRows * 32) void layernorm_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ gamma, const bf16* __restrict__ beta,
    bf16* __restrict__ y, int rows, int E, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kLnRows + (threadIdx.x >> 5);
  if (row >= rows) return;
  const bf16* xr = x + (size_t)row * E;
  float s = 0.f;
  for (int c = lane; c < E; c += 32) s += bf2f(xr[c]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  const float mu = s / E;
  float q = 0.f;
  for (int c = lane; c < E; c += 32) {
    const float d = bf2f(xr[c]) - mu;
    q += d * d;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) q += __shfl_xor_sync(0xffffffffu, q, off);
  const float rstd = rsqrtf(q / E + eps);
  bf16* yr = y + (size_t)row * E;
  for (int c = lane; c < E; c += 32)
    yr[c] = f2bf((bf2f(xr[c]) - mu) * rstd * bf2f(gamma[c]) + bf2f(beta[c]));
}

// xp = bf16(x + pos) (an f32 add of two bf16 values rounds once, as a bf16
// add does), then y = LN(xp). pos row = row % pos_rows.
__global__ __launch_bounds__(kLnRows * 32) void pos_layernorm_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ pos, int pos_rows,
    const bf16* __restrict__ gamma, const bf16* __restrict__ beta, bf16* __restrict__ xp,
    bf16* __restrict__ y, int rows, int E, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kLnRows + (threadIdx.x >> 5);
  if (row >= rows) return;
  const bf16* xr = x + (size_t)row * E;
  const bf16* pr = pos + (size_t)(row % pos_rows) * E;
  bf16* xpr = xp + (size_t)row * E;
  float s = 0.f;
  for (int c = lane; c < E; c += 32) {
    const bf16 v = f2bf(bf2f(xr[c]) + bf2f(pr[c]));
    xpr[c] = v;
    s += bf2f(v);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  const float mu = s / E;
  float q = 0.f;
  for (int c = lane; c < E; c += 32) {  // each lane re-reads only what it wrote
    const float d = bf2f(xpr[c]) - mu;
    q += d * d;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) q += __shfl_xor_sync(0xffffffffu, q, off);
  const float rstd = rsqrtf(q / E + eps);
  bf16* yr = y + (size_t)row * E;
  for (int c = lane; c < E; c += 32)
    yr[c] = f2bf((bf2f(xpr[c]) - mu) * rstd * bf2f(gamma[c]) + bf2f(beta[c]));
}

// ---------------------------------------------------------------- attention

constexpr int kQTile = 64;        // query rows per block
constexpr int kAttnThreads = 128;  // 4 warps x 16 rows
constexpr int kMaxPerLane = 18;   // softmax registers per lane: S <= 576

template <int D>
struct AttnSmem {
  static constexpr int KS = D + 8;  // bf16 row stride of Q/K/V tiles (16-byte shifted rows)
  __host__ __device__ static int ls(int spad) { return spad + 4; }  // f32 logits row stride
  static size_t bytes(int spad) {  // K (then V), then the logits tile, which first holds Q
    const size_t logits = (size_t)kQTile * ls(spad) * 4, q = (size_t)kQTile * KS * 2;
    return (size_t)spad * KS * 2 + (logits > q ? logits : q);
  }
};

template <int D>
__global__ __launch_bounds__(kAttnThreads) void attention_kernel(const bf16* __restrict__ qkv,
                                                                 bf16* __restrict__ out, int S,
                                                                 int H, int spad, float scale) {
  constexpr int KS = AttnSmem<D>::KS;
  const int LS = AttnSmem<D>::ls(spad);
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);  // [spad][KS]: K, then V
  bf16* Vs = Ks;
  float* L = reinterpret_cast<float*>(Ks + (size_t)spad * KS);  // [kQTile][LS]
  bf16* Qs = reinterpret_cast<bf16*>(L);  // [kQTile][KS], read before L is written

  const int q0 = blockIdx.x * kQTile, h = blockIdx.y, b = blockIdx.z;
  const int E = H * D;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bf16* base = qkv + (size_t)b * S * 3 * E + h * D;

  constexpr int CH = D / 8;  // 16-byte chunks per head row
  for (int c = tid; c < spad * CH; c += kAttnThreads) {
    const int r = c / CH, cc = (c % CH) * 8;
    uint4 kv = make_uint4(0, 0, 0, 0);
    if (r < S) kv = *reinterpret_cast<const uint4*>(base + (size_t)r * 3 * E + E + cc);
    *reinterpret_cast<uint4*>(&Ks[r * KS + cc]) = kv;
  }
  for (int c = tid; c < kQTile * CH; c += kAttnThreads) {
    const int r = c / CH, cc = (c % CH) * 8;
    uint4 qv = make_uint4(0, 0, 0, 0);
    if (q0 + r < S) qv = *reinterpret_cast<const uint4*>(base + (size_t)(q0 + r) * 3 * E + cc);
    *reinterpret_cast<uint4*>(&Qs[r * KS + cc]) = qv;
  }
  __syncthreads();

  const int arow = (lane & 7) + ((lane >> 3) & 1) * 8, acol = (lane >> 4) * 8;
  const int brow = (lane & 7) + (lane >> 4) * 8, bcol = ((lane >> 3) & 1) * 8;
  const int r0 = warp * 16;
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) ldmatrix_x4(qf[kk], &Qs[(r0 + arow) * KS + kk * 16 + acol]);
  __syncthreads();  // Q tile is dead from here; its bytes become logits

  // Logits: this warp's 16 rows x all keys, f32, scaled, padded keys -> -inf.
  for (int np = 0; np < spad / 16; ++np) {
    float s0[4] = {0.f, 0.f, 0.f, 0.f}, s1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t r[4];
      ldmatrix_x4(r, &Ks[(np * 16 + brow) * KS + kk * 16 + bcol]);
      mma_bf16(s0, qf[kk], r[0], r[1]);
      mma_bf16(s1, qf[kk], r[2], r[3]);
    }
    const int row = r0 + (lane >> 2);
    const int col = np * 16 + (lane & 3) * 2;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int rr = row + (e >> 1) * 8;
      const int c0 = col + (e & 1), c1 = c0 + 8;
      L[rr * LS + c0] = c0 < S ? s0[e] * scale : -CUDART_INF_F;
      L[rr * LS + c1] = c1 < S ? s1[e] * scale : -CUDART_INF_F;
    }
  }
  __syncthreads();  // every warp is done with K: V takes its slot (rows past S zero-filled)
  for (int c = tid; c < spad * CH; c += kAttnThreads) {
    const int r = c / CH, cc = (c % CH) * 8;
    const bool ok = r < S;
    cp_async16(&Vs[r * KS + cc], ok ? base + (size_t)r * 3 * E + 2 * E + cc : base, ok);
  }
  cp_async_commit();

  // Softmax row by row; P (bf16) overwrites the head of its own f32 row.
  for (int rr = r0; rr < r0 + 16; ++rr) {
    float v[kMaxPerLane];
    float m = -CUDART_INF_F;
#pragma unroll
    for (int i = 0; i < kMaxPerLane; ++i) {
      const int c = lane + 32 * i;
      v[i] = c < S ? L[rr * LS + c] : -CUDART_INF_F;
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
    bf16* prow = reinterpret_cast<bf16*>(L + (size_t)rr * LS);
#pragma unroll
    for (int i = 0; i < kMaxPerLane; ++i) {
      const int c = lane + 32 * i;
      if (c < spad) prow[c] = f2bf(v[i] / sum);
    }
    __syncwarp();
  }
  cp_async_wait<0>();
  __syncthreads();  // V has landed for every thread's copies

  // O = P . V for this warp's 16 rows, all D columns.
  const bf16* P = reinterpret_cast<const bf16*>(L);
  const int PS = 2 * LS;  // bf16 row stride of P
  float o[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;
  const int vrow = (lane & 7) + ((lane >> 3) & 1) * 8, vcol = (lane >> 4) * 8;
  for (int ks = 0; ks < spad / 16; ++ks) {
    uint32_t pa[4];
    ldmatrix_x4(pa, &P[(r0 + arow) * PS + ks * 16 + acol]);
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t r[4];
      ldmatrix_x4_trans(r, &Vs[(ks * 16 + vrow) * KS + dp * 16 + vcol]);
      mma_bf16(o[2 * dp], pa, r[0], r[1]);
      mma_bf16(o[2 * dp + 1], pa, r[2], r[3]);
    }
  }
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
    const int col = h * D + nt * 8 + (lane & 3) * 2;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int q = q0 + r0 + (lane >> 2) + half * 8;
      if (q < S) {
        __nv_bfloat162 pr;
        pr.x = f2bf(o[nt][2 * half]);
        pr.y = f2bf(o[nt][2 * half + 1]);
        *reinterpret_cast<__nv_bfloat162*>(&out[((size_t)b * S + q) * E + col]) = pr;
      }
    }
  }
}

// ------------------------------------------------------ long attention (S > 576)

constexpr int kShortMaxSeq = 32 * kMaxPerLane;  // attention_kernel's reach
constexpr int kLongMaxSeq = 1024;  // the JAX package's fused gate (pallas_block.py:85)
constexpr int kKeyTile = 64;       // keys per streamed K or V tile

template <int D>
struct LongSmem {  // the Q tile, then two stages of a K tile and a V tile
  static constexpr int KS = D + 8;
  static constexpr size_t kBytes = (size_t)(kQTile + 2 * 2 * kKeyTile) * KS * 2;
};

// The long-sequence variant: K and V stream through shared memory in tiles of
// 64 keys, so shared memory no longer bounds S. The Pallas kernel's exact
// order stays: pass 1 takes the row max over all f32 logits, pass 2 the sum
// of exp(l - max), pass 3 forms P = exp(l - max) / sum, rounds it to bf16 and
// runs P.V. Each pass recomputes the logits from the same bf16 products in
// the same order, so all three see the same f32 values; no online rescaling.
// One block of 4 warps per (batch, head, 64-query tile); each warp keeps its
// 16 query rows as operand fragments and its logits in registers.
template <int D>
__global__ __launch_bounds__(kAttnThreads) void attention_long_kernel(
    const bf16* __restrict__ qkv, bf16* __restrict__ out, int S, int H, float scale) {
  constexpr int KS = LongSmem<D>::KS;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);       // [kQTile][KS]
  bf16* Kt = Qs + (size_t)kQTile * KS;             // [2][kKeyTile][KS]
  bf16* Vt = Kt + (size_t)2 * kKeyTile * KS;       // [2][kKeyTile][KS]

  const int q0 = blockIdx.x * kQTile, h = blockIdx.y, b = blockIdx.z;
  const int E = H * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bf16* base = qkv + (size_t)b * S * 3 * E + h * D;
  stage_rows_async<D, kAttnThreads>(Qs, base, q0, kQTile, S, 3 * E);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int arow = (lane & 7) + ((lane >> 3) & 1) * 8, acol = (lane >> 4) * 8;
  const int brow = (lane & 7) + (lane >> 4) * 8, bcol = ((lane >> 3) & 1) * 8;
  const int r0 = warp * 16;
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) ldmatrix_x4(qf[kk], &Qs[(r0 + arow) * KS + kk * 16 + acol]);

  const int tiles = (S + kKeyTile - 1) / kKeyTile;
  // Scaled logits of this warp's 16 rows against keys [k0 + np*16, +16) of
  // the staged tile, in the accumulator layout of two n8 tiles.
  auto logits = [&](const bf16* K, int np, float (&s0)[4], float (&s1)[4]) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s0[e] = s1[e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t r[4];
      ldmatrix_x4(r, &K[(np * 16 + brow) * KS + kk * 16 + bcol]);
      mma_bf16(s0, qf[kk], r[0], r[1]);
      mma_bf16(s1, qf[kk], r[2], r[3]);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s0[e] = __fmul_rn(s0[e], scale);
      s1[e] = __fmul_rn(s1[e], scale);
    }
  };
  auto stage = [&](bf16* dst, int col, int st, int t) {
    stage_rows_async<D, kAttnThreads>(dst + (size_t)st * kKeyTile * KS, base + col, t * kKeyTile,
                                      kKeyTile, S, 3 * E);
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
  const int cq = (lane & 3) * 2;  // this lane's first column within an n8 tile

  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};  // rows lane/4 and lane/4 + 8
  pipeline(tiles, load_k, [&](int st, int t) {
    const int k0 = t * kKeyTile;
    const bf16* K = Kt + (size_t)st * kKeyTile * KS;
#pragma unroll
    for (int np = 0; np < kKeyTile / 16; ++np) {
      float s0[4], s1[4];
      logits(K, np, s0, s1);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c0 = k0 + np * 16 + cq + (e & 1), c1 = c0 + 8;
        if (c0 < S) m[e >> 1] = fmaxf(m[e >> 1], s0[e]);
        if (c1 < S) m[e >> 1] = fmaxf(m[e >> 1], s1[e]);
      }
    }
  });
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], 1));
    m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], 2));
  }

  float sum[2] = {0.f, 0.f};
  pipeline(tiles, load_k, [&](int st, int t) {
    const int k0 = t * kKeyTile;
    const bf16* K = Kt + (size_t)st * kKeyTile * KS;
#pragma unroll
    for (int np = 0; np < kKeyTile / 16; ++np) {
      float s0[4], s1[4];
      logits(K, np, s0, s1);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c0 = k0 + np * 16 + cq + (e & 1), c1 = c0 + 8;
        if (c0 < S) sum[e >> 1] += expf(s0[e] - m[e >> 1]);
        if (c1 < S) sum[e >> 1] += expf(s1[e] - m[e >> 1]);
      }
    }
  });
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
    sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
  }

  float o[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;
  const int vrow = (lane & 7) + ((lane >> 3) & 1) * 8, vcol = (lane >> 4) * 8;
  pipeline(tiles, load_kv, [&](int st, int t) {
    const int k0 = t * kKeyTile;
    const bf16* K = Kt + (size_t)st * kKeyTile * KS;
    const bf16* V = Vt + (size_t)st * kKeyTile * KS;
#pragma unroll
    for (int np = 0; np < kKeyTile / 16; ++np) {
      float s0[4], s1[4];
      logits(K, np, s0, s1);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c0 = k0 + np * 16 + cq + (e & 1), c1 = c0 + 8;
        s0[e] = c0 < S ? expf(s0[e] - m[e >> 1]) / sum[e >> 1] : 0.f;
        s1[e] = c1 < S ? expf(s1[e] - m[e >> 1]) / sum[e >> 1] : 0.f;
      }
      const uint32_t pa[4] = {pack_bf16(s0[0], s0[1]), pack_bf16(s0[2], s0[3]),
                              pack_bf16(s1[0], s1[1]), pack_bf16(s1[2], s1[3])};
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, &V[(np * 16 + vrow) * KS + dp * 16 + vcol]);
        mma_bf16(o[2 * dp], pa, r[0], r[1]);
        mma_bf16(o[2 * dp + 1], pa, r[2], r[3]);
      }
    }
  });

#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
    const int col = h * D + nt * 8 + cq;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int q = q0 + r0 + (lane >> 2) + half * 8;
      if (q < S) {
        __nv_bfloat162 pr;
        pr.x = f2bf(o[nt][2 * half]);
        pr.y = f2bf(o[nt][2 * half + 1]);
        *reinterpret_cast<__nv_bfloat162*>(&out[((size_t)b * S + q) * E + col]) = pr;
      }
    }
  }
}

}  // namespace

// x (rows, E) bf16, gamma/beta (E,) bf16 -> y (rows, E) bf16.
extern "C" int pv_layernorm(const void* x, const void* gamma, const void* beta, void* y, int rows,
                            int E, float eps, void* stream) {
  const int blocks = (rows + kLnRows - 1) / kLnRows;
  layernorm_kernel<<<blocks, kLnRows * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(gamma),
      static_cast<const bf16*>(beta), static_cast<bf16*>(y), rows, E, eps);
  return static_cast<int>(cudaGetLastError());
}

// x (rows, E), pos (pos_rows, E) bf16, gamma/beta (E,) bf16 -> xp = x + pos
// (rows, E) and y = LN(xp) (rows, E), both bf16; pos row = row % pos_rows.
extern "C" int pv_pos_layernorm(const void* x, const void* pos, int pos_rows, const void* gamma,
                                const void* beta, void* xp, void* y, int rows, int E, float eps,
                                void* stream) {
  const int blocks = (rows + kLnRows - 1) / kLnRows;
  pos_layernorm_kernel<<<blocks, kLnRows * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(pos), pos_rows,
      static_cast<const bf16*>(gamma), static_cast<const bf16*>(beta), static_cast<bf16*>(xp),
      static_cast<bf16*>(y), rows, E, eps);
  return static_cast<int>(cudaGetLastError());
}

// Largest sequence length the attention kernels take: 1024 at head dim 64,
// the JAX package's fused gate. attention_kernel serves S <= 576 (its
// shared memory and the softmax's registers bound it), attention_long_kernel
// the rest.
extern "C" int pv_attention_max_seq(int head_dim) { return head_dim == 64 ? kLongMaxSeq : 0; }

// qkv (B, S, 3E) bf16, packed [q | k | v], heads contiguous within each ->
// out (B, S, E) bf16.
extern "C" int pv_attention(const void* qkv, void* out, int B, int S, int H, int head_dim,
                            float scale, void* stream) {
  if (head_dim != 64 || S < 1 || S > pv_attention_max_seq(head_dim)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((S + kQTile - 1) / kQTile, H, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S <= kShortMaxSeq) {
    const int spad = (S + 15) / 16 * 16;
    const size_t smem = AttnSmem<64>::bytes(spad);
    cudaFuncSetAttribute(attention_kernel<64>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    attention_kernel<64><<<grid, kAttnThreads, smem, st>>>(
        static_cast<const bf16*>(qkv), static_cast<bf16*>(out), S, H, spad, scale);
  } else {
    const size_t smem = LongSmem<64>::kBytes;
    cudaFuncSetAttribute(attention_long_kernel<64>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    attention_long_kernel<64><<<grid, kAttnThreads, smem, st>>>(
        static_cast<const bf16*>(qkv), static_cast<bf16*>(out), S, H, scale);
  }
  return static_cast<int>(cudaGetLastError());
}
