// Tiled bf16 GEMM with f32 accumulation and a fused epilogue:
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
// up-projection adds. Without pre, the arithmetic is the same as before.
//
// It is the product engine of these TPU kernels, each as a short chain of
// launches of this one kernel:
//   - pointvit_tpu/ops/pallas_encoder.py::_encoder_pallas (kernel _enc_kernel):
//     the five folded mini-PointNet products. The group max over K rows gives
//     g and the final (M*K, E) product is reduced to (M, E) in the epilogue,
//     so it never reaches device memory; the per-group g.Wg'+c2 row enters
//     the loc.Wl' epilogue as a residual indexed by m / K.
//   - pointvit_tpu/ops/pallas_block.py::_apf_block_pallas (kernels
//     _attn_half_kernel, _mlp_half_kernel): qkv, proj + residual, fc1 + GELU,
//     adapter down + ReLU, up + 2*x1, fc2 + the rest of the sum.
//   - pointvit_tpu/ops/pallas_block.py::_serial_block_pallas (kernels
//     _serial_attn_half_kernel, _serial_mlp_half_kernel): proj and fc2 each
//     write bf16(y) and f32(x + y) through pre; the adapters' up-projections
//     add that f32 residual, as the Pallas kernel's f32 sum (x + y) + a.
//
// What bounds it on the H100: at the main-path shapes (M = 50176 tokens or
// 802816 grouped points, K and N of 256..3072) the products are compute
// bound: 2*M*N*K FLOPs against (M*K + N*K + M*N) * 2 bytes. The epilogue
// adds bandwidth for the outputs it writes.
//
// Design: 128x128 output tiles, 32-deep K steps, 8 warps each owning a
// 64x32 sub-tile of mma.sync m16n8k16 bf16 products, two shared-memory
// stages filled by cp.async so the next tile loads during this one's
// products. Shared-memory rows are padded to 40 bf16 (80 bytes) so the
// ldmatrix row reads fall in distinct banks. K is zero-filled per 8-column
// chunk, so any K % 8 == 0 works: the encoder's first layer (C = 6 channels)
// arrives padded to 8 by the wrapper. The epilogue stages the f32 tile in
// shared memory, which makes the group max a plain column loop. This is a
// simple first kernel; Hopper's wgmma and TMA are for a later change.
#include "common.cuh"

#include <math_constants.h>

namespace {

constexpr int BM = 128, BN = 128, BK = 32, SK = BK + 8, CS = BN + 4;
constexpr int kThreads = 256;
constexpr int kPipeBytes = 2 * (BM + BN) * SK * 2;
constexpr int kEpiBytes = BM * CS * 4;
constexpr int kSmemBytes = kPipeBytes > kEpiBytes ? kPipeBytes : kEpiBytes;

struct GemmArgs {
  const bf16* A;
  const bf16* W;
  const bf16* bias;
  const void* res;
  void* out;
  bf16* pre;
  bf16* gmax;
  int lda, ldw, ldr, ldo, ldp, ldg;
  int M, N, K;
  int res_div, res_f32, out_f32, group, act;
  float res_scale;
};

__device__ __forceinline__ float add_bias(const GemmArgs& p, float v, int gc) {
  return p.bias ? v + bf2f(p.bias[gc]) : v;
}

// The residual and the activation, after the bias.
__device__ __forceinline__ float finish(const GemmArgs& p, float v, int gr, int gc) {
  if (p.res) {
    const size_t ri = (size_t)(gr / p.res_div) * p.ldr + gc;
    const float r = p.res_f32 ? static_cast<const float*>(p.res)[ri]
                              : bf2f(static_cast<const bf16*>(p.res)[ri]);
    v += p.res_scale * r;
  }
  if (p.act == 1) {
    v = fmaxf(v, 0.f);
  } else if (p.act == 2) {
    v = 0.5f * v * (1.f + erff(v * 0.7071067811865475f));
  }
  return v;
}

__device__ __forceinline__ float epilogue(const GemmArgs& p, float v, int gr, int gc) {
  return finish(p, add_bias(p, v, gc), gr, gc);
}

__global__ __launch_bounds__(kThreads) void gemm_kernel(const GemmArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);  // [2][BM][SK]
  bf16* Ws = As + 2 * BM * SK;               // [2][BN][SK]
  float* Cs = reinterpret_cast<float*>(smem);  // [BM][CS], after the main loop

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  auto load = [&](int stage, int kt) {
    const int k0 = kt * BK;
#pragma unroll
    for (int c = tid; c < BM * (BK / 8); c += kThreads) {
      const int r = c >> 2, kc = (c & 3) * 8;
      const int gk = k0 + kc;
      const int gm = m0 + r, gn = n0 + r;
      const bool okA = gm < p.M && gk < p.K;
      const bool okW = gn < p.N && gk < p.K;
      cp_async16(&As[(stage * BM + r) * SK + kc], okA ? p.A + (size_t)gm * p.lda + gk : p.A, okA);
      cp_async16(&Ws[(stage * BN + r) * SK + kc], okW ? p.W + (size_t)gn * p.ldw + gk : p.W, okW);
    }
    cp_async_commit();
  };

  const int KT = (p.K + BK - 1) / BK;
  load(0, 0);
  const int arow = (lane & 7) + ((lane >> 3) & 1) * 8, acol = (lane >> 4) * 8;
  const int brow = (lane & 7) + (lane >> 4) * 8, bcol = ((lane >> 3) & 1) * 8;
  for (int kt = 0; kt < KT; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < KT) {
      load(st ^ 1, kt + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldmatrix_x4(a[mi], &As[(st * BM + wm + mi * 16 + arow) * SK + kk + acol]);
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        uint32_t r[4];
        ldmatrix_x4(r, &Ws[(st * BN + wn + nj * 16 + brow) * SK + kk + bcol]);
        b[2 * nj][0] = r[0];
        b[2 * nj][1] = r[1];
        b[2 * nj + 1][0] = r[2];
        b[2 * nj + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], a[mi], b[ni][0], b[ni][1]);
    }
    __syncthreads();
  }

  // Stage the raw f32 tile in shared memory (the pipeline buffers are free).
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int r = wm + mi * 16 + (lane >> 2), c = wn + ni * 8 + (lane & 3) * 2;
      Cs[r * CS + c] = acc[mi][ni][0];
      Cs[r * CS + c + 1] = acc[mi][ni][1];
      Cs[(r + 8) * CS + c] = acc[mi][ni][2];
      Cs[(r + 8) * CS + c + 1] = acc[mi][ni][3];
    }
  __syncthreads();

  if (p.out) {
    for (int e = tid; e < BM * BN; e += kThreads) {
      const int r = e / BN, c = e % BN, gr = m0 + r, gc = n0 + c;
      if (gr >= p.M || gc >= p.N) continue;
      float v = add_bias(p, Cs[r * CS + c], gc);
      if (p.pre) p.pre[(size_t)gr * p.ldp + gc] = f2bf(v);
      v = finish(p, v, gr, gc);
      const size_t o = (size_t)gr * p.ldo + gc;
      if (p.out_f32) {
        static_cast<float*>(p.out)[o] = v;
      } else {
        static_cast<bf16*>(p.out)[o] = f2bf(v);
      }
    }
  }
  if (p.gmax) {
    const int groups = BM / p.group;
    for (int e = tid; e < groups * BN; e += kThreads) {
      const int g = e / BN, c = e % BN, gr0 = m0 + g * p.group, gc = n0 + c;
      if (gr0 >= p.M || gc >= p.N) continue;
      float m = -CUDART_INF_F;
      for (int r = g * p.group; r < (g + 1) * p.group; ++r)
        m = fmaxf(m, epilogue(p, Cs[r * CS + c], m0 + r, gc));
      p.gmax[(size_t)(gr0 / p.group) * p.ldg + gc] = f2bf(m);
    }
  }
}

}  // namespace

extern "C" int pv_gemm(const void* A, int lda, const void* W, int ldw, const void* bias,
                       const void* res, int ldr, int res_div, int res_f32, float res_scale,
                       void* out, int ldo, int out_f32, void* pre, int ldp, void* gmax,
                       int ldg, int group, int M, int N, int K, int act, void* stream) {
  GemmArgs p;
  p.A = static_cast<const bf16*>(A);
  p.W = static_cast<const bf16*>(W);
  p.bias = static_cast<const bf16*>(bias);
  p.res = res;
  p.out = out;
  p.pre = static_cast<bf16*>(pre);
  p.gmax = static_cast<bf16*>(gmax);
  p.lda = lda;
  p.ldw = ldw;
  p.ldr = ldr;
  p.ldo = ldo;
  p.ldp = ldp;
  p.ldg = ldg;
  p.M = M;
  p.N = N;
  p.K = K;
  p.res_div = res_div;
  p.res_f32 = res_f32;
  p.out_f32 = out_f32;
  p.group = group;
  p.act = act;
  p.res_scale = res_scale;
  cudaFuncSetAttribute(gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  gemm_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
