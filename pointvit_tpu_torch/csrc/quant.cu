// Dynamic w8a8 int8 dense in two launches:
//
//   1. quantize_rows_kernel:  sx[m] = max(amax_k |x[m,k]| / 127, 1e-8)
//                             xq[m,k] = round_half_even(x[m,k] / sx[m])      (int8)
//   2. quant_gemm_kernel:     acc = xq[M,K] . wq[N,K]^T                      (int32, exact)
//                             out[m,n] = fl(fl(float(acc) * fl(sx[m]*sw[n])) + bias[n])
//
// It replaces pointvit_tpu/ops/pallas_quant.py::_quant_dense_2d (kernel
// _quant_dense_kernel), the int8 dense of every quantized encoder, qkv, proj,
// fc1 and fc2 product of the APF model with quantized=True. The weight is
// quantized once per model in plain torch (ops/quant_kernel.py).
//
// Bit-equality with the plain version (and with the JAX formulation) rests on
// doing each rounding once and in that order:
//   - divisions are __fdiv_rn (IEEE; nvcc's default -prec-div=true as well:
//     these sources build without --use_fast_math);
//   - float -> int rounds half to even (__float2int_rn), as torch.round and
//     jnp.round do; roundf would round half away from zero;
//   - the epilogue is __fmul_rn / __fadd_rn, so nvcc cannot contract the
//     product and the bias into one FMA;
//   - int32 -> float is __int2float_rn (|acc| can exceed 2^24).
//
// What bounds it on the H100: at the main-path shapes (M = 50176 token rows
// for the blocks, 802816 grouped points for the encoder; K, N of 256..3072)
// the products are close to the line between the two bounds: 2*M*N*K int8
// operations at 1979 TOP/s against x (bf16) read once, W (int8) read once
// and the output (bf16) written once at 3.35 TB/s. Launch 1 adds a read of x
// and a write of xq and sx that the Pallas kernel keeps in VMEM.
//
// Design, a simple first kernel: the GEMM is csrc/gemm.cu's tiling in bytes.
// 128x128 output tiles, 64-byte (64 int8) K steps, 8 warps each owning a
// 64x32 sub-tile of mma.sync m16n8k32 s8 products with s32 accumulators, two
// shared-memory stages filled by cp.async. An int8 16x32 A fragment and a
// 32x8 B fragment have the byte layout of the bf16 16x16 and 16x8 ones, so
// the same ldmatrix addressing (in bytes) loads them; rows are padded to 80
// bytes so the eight rows of one ldmatrix fall in distinct banks. W is
// (N, K) row-major, which is the .col operand the MMA wants. K is zero-filled
// per 16-byte chunk (K % 16 == 0); ragged M and N tiles are masked. The
// epilogue reads sx, sw and the bias straight from device memory and writes
// from the accumulator registers. Fusing the row quantizer into the GEMM's
// prologue, wgmma and TMA are for a later change.
#include "common.cuh"

namespace {

constexpr float kEps = 1e-8f;

// ------------------------------------------------------------ launch 1

constexpr int kRowThreads = 256;  // one warp per row, 8 rows per block

__device__ __forceinline__ void load16(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}
__device__ __forceinline__ void load16(const bf16* p, float (&v)[8]) {
  const uint4 t = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&w[i]);
    v[2 * i] = __low2float(h);
    v[2 * i + 1] = __high2float(h);
  }
}
__device__ __forceinline__ void store_q(int8_t* p, const int8_t (&q)[4]) {
  *reinterpret_cast<char4*>(p) = make_char4(q[0], q[1], q[2], q[3]);
}
__device__ __forceinline__ void store_q(int8_t* p, const int8_t (&q)[8]) {
  uint2 t;
  t.x = (uint32_t)(uint8_t)q[0] | (uint32_t)(uint8_t)q[1] << 8 | (uint32_t)(uint8_t)q[2] << 16 |
        (uint32_t)(uint8_t)q[3] << 24;
  t.y = (uint32_t)(uint8_t)q[4] | (uint32_t)(uint8_t)q[5] << 8 | (uint32_t)(uint8_t)q[6] << 16 |
        (uint32_t)(uint8_t)q[7] << 24;
  *reinterpret_cast<uint2*>(p) = t;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return bf2f(v); }

// Rows of K values in, rows of Kp = K rounded up to 16 bytes out, the tail
// zero. Rows whose bytes are whole 16-byte chunks (K % V == 0) load 16 bytes
// at a time; others one value at a time. amax is a max, so both orders give
// the same scale.
template <typename T>
__global__ __launch_bounds__(kRowThreads) void quantize_rows_kernel(
    const T* __restrict__ x, int8_t* __restrict__ xq, float* __restrict__ sx, int M, int K,
    int Kp) {
  constexpr int V = 16 / sizeof(T);  // values per 16-byte load
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (kRowThreads / 32) + (threadIdx.x >> 5);
  if (row >= M) return;
  const bool vec = K % V == 0;
  const T* xr = x + (size_t)row * K;
  float amax = 0.f;
  if (vec) {
    for (int c = lane * V; c < K; c += 32 * V) {
      float v[V];
      load16(xr + c, v);
#pragma unroll
      for (int i = 0; i < V; ++i) amax = fmaxf(amax, fabsf(v[i]));
    }
  } else {
    for (int c = lane; c < K; c += 32) amax = fmaxf(amax, fabsf(to_f32(xr[c])));
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  const float s = fmaxf(__fdiv_rn(amax, 127.f), kEps);
  int8_t* qr = xq + (size_t)row * Kp;
  if (vec) {
    for (int c = lane * V; c < K; c += 32 * V) {
      float v[V];
      int8_t q[V];
      load16(xr + c, v);
#pragma unroll
      for (int i = 0; i < V; ++i) q[i] = static_cast<int8_t>(__float2int_rn(__fdiv_rn(v[i], s)));
      store_q(qr + c, q);
    }
  } else {
    for (int c = lane; c < K; c += 32)
      qr[c] = static_cast<int8_t>(__float2int_rn(__fdiv_rn(to_f32(xr[c]), s)));
  }
  for (int c = K + lane; c < Kp; c += 32) qr[c] = 0;
  if (lane == 0) sx[row] = s;
}

// ------------------------------------------------------------ launch 2

constexpr int BM = 128, BN = 128, BK = 64, SK = BK + 16;  // BK, SK in int8 (bytes)
constexpr int kThreads = 256;
constexpr int kSmemBytes = 2 * (BM + BN) * SK;

// d += a(16x32, row) * b(32x8, col), s8 inputs, s32 accumulators.
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

struct QuantGemmArgs {
  const int8_t* A;
  const int8_t* W;
  const float* sx;
  const float* sw;
  const float* bias;
  void* out;
  int out_f32, M, N, K;
};

__device__ __forceinline__ float dequant(const QuantGemmArgs& p, int acc, int gr, int gc) {
  const float y = __fmul_rn(__int2float_rn(acc), __fmul_rn(p.sx[gr], p.sw[gc]));
  return p.bias ? __fadd_rn(y, p.bias[gc]) : y;
}

__device__ __forceinline__ void store_out(const QuantGemmArgs& p, int gr, int gc, float v) {
  const size_t o = (size_t)gr * p.N + gc;
  if (p.out_f32) {
    static_cast<float*>(p.out)[o] = v;
  } else {
    static_cast<bf16*>(p.out)[o] = f2bf(v);
  }
}

__global__ __launch_bounds__(kThreads) void quant_gemm_kernel(const QuantGemmArgs p) {
  __shared__ __align__(16) int8_t smem[kSmemBytes];
  int8_t* As = smem;               // [2][BM][SK]
  int8_t* Ws = smem + 2 * BM * SK;  // [2][BN][SK]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  auto load = [&](int stage, int kt) {
    const int k0 = kt * BK;
#pragma unroll
    for (int c = tid; c < BM * (BK / 16); c += kThreads) {
      const int r = c >> 2, kc = (c & 3) * 16;
      const int gk = k0 + kc;
      const int gm = m0 + r, gn = n0 + r;
      const bool okA = gm < p.M && gk < p.K;
      const bool okW = gn < p.N && gk < p.K;
      cp_async16(&As[(stage * BM + r) * SK + kc], okA ? p.A + (size_t)gm * p.K + gk : p.A, okA);
      cp_async16(&Ws[(stage * BN + r) * SK + kc], okW ? p.W + (size_t)gn * p.K + gk : p.W, okW);
    }
    cp_async_commit();
  };

  const int KT = (p.K + BK - 1) / BK;
  load(0, 0);
  // ldmatrix lane addresses, in bytes: the bf16 addressing of gemm.cu x 2.
  const int arow = (lane & 7) + ((lane >> 3) & 1) * 8, acol = (lane >> 4) * 16;
  const int brow = (lane & 7) + (lane >> 4) * 8, bcol = ((lane >> 3) & 1) * 16;
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
    for (int kk = 0; kk < BK; kk += 32) {
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
        for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], a[mi], b[ni][0], b[ni][1]);
    }
    __syncthreads();
  }

  // Accumulator (mi, ni, e): row wm + mi*16 + lane/4 (+8 for e >= 2),
  // column wn + ni*8 + (lane%4)*2 (+1 for odd e).
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int gr = m0 + wm + mi * 16 + (lane >> 2) + (e >> 1) * 8;
        const int gc = n0 + wn + ni * 8 + (lane & 3) * 2 + (e & 1);
        if (gr < p.M && gc < p.N) store_out(p, gr, gc, dequant(p, acc[mi][ni][e], gr, gc));
      }
}

}  // namespace

// x (M, K) bf16 or f32 -> xq (M, Kp) int8 (columns K.. zero), sx (M,) f32;
// Kp is K rounded up to a multiple of 16.
extern "C" int pv_quantize_rows(const void* x, int x_f32, void* xq, void* sx, int M, int K,
                                int Kp, void* stream) {
  const dim3 grid((M + kRowThreads / 32 - 1) / (kRowThreads / 32));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_f32) {
    quantize_rows_kernel<float><<<grid, kRowThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<int8_t*>(xq), static_cast<float*>(sx), M, K, Kp);
  } else {
    quantize_rows_kernel<bf16><<<grid, kRowThreads, 0, s>>>(
        static_cast<const bf16*>(x), static_cast<int8_t*>(xq), static_cast<float*>(sx), M, K, Kp);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pv_quant_gemm(const void* xq, const void* wq, const void* sx, const void* sw,
                             const void* bias, void* out, int out_f32, int M, int N, int K,
                             void* stream) {
  QuantGemmArgs p;
  p.A = static_cast<const int8_t*>(xq);
  p.W = static_cast<const int8_t*>(wq);
  p.sx = static_cast<const float*>(sx);
  p.sw = static_cast<const float*>(sw);
  p.bias = static_cast<const float*>(bias);
  p.out = out;
  p.out_f32 = out_f32;
  p.M = M;
  p.N = N;
  p.K = K;
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  quant_gemm_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
