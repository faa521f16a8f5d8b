// Train-mode BatchNorm followed by ReLU over the last axis of a (rows, C)
// activation, forward and backward: four entry points, each one pass over
// the activation (the two reductions add a second, tiny launch).
//
// Replaces no TPU kernel: the JAX package leaves train-mode BatchNorm to
// XLA, which fuses it (pointvit_tpu/nn/pointnet.py's P3Embed and
// GroupFeatureEncoder, nn/heads.py, the renderer's view network). Op by op
// in PyTorch the P3 stage's three BatchNorm + ReLU chains of a Pix4Point
// training step (R = 524,288 rows at widths 256, 512, 256) moved ~30 GB
// forward and ~61 GB backward in f32 copies, casts and reductions.
//
// Bound by bytes: a handful of f32 operations per element. Per BatchNorm +
// ReLU of an (R, C) tensor of T (bf16 or f32):
//   pv_bn_stats          one read of h        -> Σh, Σh² per column (f64)
//   pv_bn_relu           one read of h, one write: y = relu((h - mean)·s + β)
//   pv_bn_relu_bwd_stats one read of dy and h -> Σg, Σg·x̂ per column (f64),
//                        g = dy·[(h - mean)·s + β > 0], x̂ = (h - mean)·rstd
//   pv_bn_relu_bwd       one read of dy and h, one write: dx = s·g - a - (h - mean)·b
// so 3·R·C·sizeof(T) bytes forward and 5·R·C·sizeof(T) backward. Each apply
// derives its columns' coefficients from the sums (after any all-reduce
// over ranks) in registers, with flax's conventions: mean = Σh/n, var =
// max(Σh²/n - mean², 0), rstd = 1/sqrt(var + eps), s = γ·rstd; a = s·Σg/n,
// b = s·rstd·Σg·x̂/n, or 0 where the clamp held var at 0. The forward's first
// block writes them (mean, s, β, rstd, var, live) as rows of one f32 (6, C)
// tensor, which the backward reads. So the host makes four calls a
// BatchNorm in place of a few dozen small PyTorch ops.
//
// Design. Every thread owns one 16-byte column vector of a row (8 bf16 or 4
// f32 columns) and walks the rows grid-stride, so its coefficients sit in
// registers, its loads and stores are 16 bytes with neighbouring threads on
// neighbouring addresses, and U rows are loaded before the first is used
// (bytes in flight). The grid is as many blocks as fit on the card at once.
// A reduction accumulates in f64 and writes one row of f64 partials per
// block (they stay in L2); the second launch sums them over the blocks in a
// fixed order into f64 sums: no atomics, so two runs are bit-equal. Those
// sums are all but exact (the products and sums of bf16 or f32 values fit
// f64), so once rounded to f32 they depend neither on the order nor on how
// the rows are spread over ranks: the kernels, the plain version and one
// process over the whole batch agree. (With f32 sums two summation orders
// alone moved the gradient of a weight before a BatchNorm, a sum that nearly
// cancels, by ~25 % in a bf16 training step.) All f32 arithmetic uses
// round-to-nearest intrinsics (no FMA contraction, IEEE division and square
// root): the backward recomputes exactly the forward's ReLU mask, and the
// applies give the bits of the plain PyTorch version (ops/batchnorm_kernel.py).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
template <typename T>
constexpr int kVec = 16 / sizeof(T);  // elements of T in 16 bytes

__device__ __forceinline__ uint4 ld16(const void* p) { return *reinterpret_cast<const uint4*>(p); }

template <typename T>
__device__ __forceinline__ void unpack(uint4 r, float (&v)[kVec<T>]);
template <>
__device__ __forceinline__ void unpack<bf16>(uint4 r, float (&v)[8]) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&w[i]);
    const float2 f = __bfloat1622float2(h);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
template <>
__device__ __forceinline__ void unpack<float>(uint4 r, float (&v)[4]) {
  v[0] = __uint_as_float(r.x);
  v[1] = __uint_as_float(r.y);
  v[2] = __uint_as_float(r.z);
  v[3] = __uint_as_float(r.w);
}

template <typename T>
__device__ __forceinline__ void store(T* p, const float (&v)[kVec<T>]);
template <>
__device__ __forceinline__ void store<bf16>(bf16* p, const float (&v)[8]) {
  *reinterpret_cast<uint4*>(p) = make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                                            pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
}
template <>
__device__ __forceinline__ void store<float>(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// Rows in flight a block: a row of C / N vectors takes min(C / N, kThreads)
// threads, so a block covers kThreads / that rows at a time, over
// ceil(C / N / kThreads) column tiles (blockIdx.y).
__host__ __device__ __forceinline__ int row_threads(int C, int N) {
  return C / N < kThreads ? C / N : kThreads;
}

// This thread's first column, first row and row step; false for a thread
// with no vector (past the row group, or past C in the last column tile).
template <int N>
__device__ __forceinline__ bool lane(int C, int& col, int& row, int& step) {
  const int vt = row_threads(C, N);
  const int rpi = kThreads / vt;
  const int r = threadIdx.x / vt;
  col = (blockIdx.y * vt + threadIdx.x % vt) * N;
  row = blockIdx.x * rpi + r;
  step = gridDim.x * rpi;
  return r < rpi && col < C;
}

template <int N>
__device__ __forceinline__ void coef_row(const float* __restrict__ coef, int k, int C, int col,
                                         float (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = coef[(size_t)k * C + col + i];
}

// (h - mean)·s + β, each step rounded as the plain version's separate ops.
__device__ __forceinline__ float pre_act(float h, float mean, float s, float beta) {
  return __fadd_rn(__fmul_rn(__fsub_rn(h, mean), s), beta);
}

// ------------------------------------------------------------ reductions

// kBwd false: Σh and Σh² of each column over this block's rows.
// kBwd true: Σg and Σg·x̂ (coef rows: mean, s, β, rstd; x̂ in f32).
// partial is (2, gridDim.x, C) f64: the block's two sums at row blockIdx.x.
template <typename T, bool kBwd, int U>
__global__ __launch_bounds__(kThreads) void bn_partial_kernel(
    const T* __restrict__ h, const T* __restrict__ dy, const float* __restrict__ coef,
    double* __restrict__ partial, int rows, int C) {
  constexpr int N = kVec<T>;
  __shared__ double red[kThreads][2 * N + 1];
  int col, row, step;
  const bool on = lane<N>(C, col, row, step);
  double sa[N], sb[N];
#pragma unroll
  for (int i = 0; i < N; ++i) sa[i] = sb[i] = 0.0;
  if (on) {
    float mean[N], s[N], beta[N], rstd[N];
    if constexpr (kBwd) {
      coef_row<N>(coef, 0, C, col, mean);
      coef_row<N>(coef, 1, C, col, s);
      coef_row<N>(coef, 2, C, col, beta);
      coef_row<N>(coef, 3, C, col, rstd);
    }
    auto add = [&](uint4 rh, uint4 rd) {
      float hv[N];
      unpack<T>(rh, hv);
      if constexpr (!kBwd) {
#pragma unroll
        for (int i = 0; i < N; ++i) {
          const double v = hv[i];
          sa[i] += v;
          sb[i] = fma(v, v, sb[i]);
        }
      } else {
        float dv[N];
        unpack<T>(rd, dv);
#pragma unroll
        for (int i = 0; i < N; ++i) {
          const double g = pre_act(hv[i], mean[i], s[i], beta[i]) > 0.f ? dv[i] : 0.f;
          sa[i] += g;
          sb[i] = fma(g, static_cast<double>(__fmul_rn(__fsub_rn(hv[i], mean[i]), rstd[i])), sb[i]);
        }
      }
    };
    for (; row + (U - 1) * step < rows; row += U * step) {
      uint4 rh[U], rd[U] = {};
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const size_t at = (size_t)(row + u * step) * C + col;
        rh[u] = ld16(h + at);
        if constexpr (kBwd) rd[u] = ld16(dy + at);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) add(rh[u], rd[u]);
    }
    for (; row < rows; row += step) {
      const size_t at = (size_t)row * C + col;
      uint4 rd = make_uint4(0, 0, 0, 0);
      if constexpr (kBwd) rd = ld16(dy + at);
      add(ld16(h + at), rd);
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    red[threadIdx.x][i] = sa[i];
    red[threadIdx.x][N + i] = sb[i];
  }
  __syncthreads();
  const int vt = row_threads(C, N);
  if (on && threadIdx.x < vt) {  // the block's first row group sums the others, in order
    const int rpi = kThreads / vt;
#pragma unroll
    for (int i = 0; i < 2 * N; ++i) {
      double t = 0.0;
      for (int r = 0; r < rpi; ++r) t += red[r * vt + threadIdx.x][i];
      const int k = i / N;
      partial[((size_t)k * gridDim.x + blockIdx.x) * C + col + i % N] = t;
    }
  }
}

// out (2, C) = the sums of partial (2, blocks, C) over the blocks, each
// column in a fixed order, all f64. Block (32 columns) x (8 block strides).
__global__ __launch_bounds__(256) void bn_sum_kernel(const double* __restrict__ partial,
                                                     double* __restrict__ out, int blocks, int C) {
  __shared__ double red[8][33];
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + tx, k = blockIdx.y;
  double acc = 0.0;
  if (c < C)
    for (int b = ty; b < blocks; b += 8) acc += partial[((size_t)k * blocks + b) * C + c];
  red[ty][tx] = acc;
  __syncthreads();
  if (ty == 0 && c < C) {
    double t = 0.0;
#pragma unroll
    for (int r = 0; r < 8; ++r) t += red[r][tx];
    out[(size_t)k * C + c] = t;
  }
}

// ---------------------------------------------------------------- applies

constexpr int kCoefRows = 6;  // mean, s, β, rstd, var, live (1 where var was not clamped)

// Column c's forward coefficients from the sums (Σh, Σh²) over n rows, each
// step rounded as the plain version's separate ops.
struct Forward {
  float mean, s, beta, rstd, var, live;
};
__device__ __forceinline__ Forward forward_coef(const double* __restrict__ sums, double n,
                                                const float* __restrict__ gamma,
                                                const float* __restrict__ beta, float eps, int C,
                                                int c) {
  Forward f;
  f.mean = __double2float_rn(__ddiv_rn(sums[c], n));
  const float msq = __double2float_rn(__ddiv_rn(sums[C + c], n));
  const float raw = __fsub_rn(msq, __fmul_rn(f.mean, f.mean));
  f.var = raw < 0.f ? 0.f : raw;  // NaN stays NaN, as torch.clamp
  f.live = raw >= 0.f ? 1.f : 0.f;
  f.rstd = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(f.var, eps)));
  f.s = __fmul_rn(f.rstd, gamma[c]);
  f.beta = beta[c];
  return f;
}

// y = relu((h - mean)·s + β) from the sums; the first block's first row
// group writes the coefficients to coef (6, C).
template <typename T, int U>
__global__ __launch_bounds__(kThreads) void bn_relu_kernel(
    const T* __restrict__ h, const double* __restrict__ sums, double n,
    const float* __restrict__ gamma, const float* __restrict__ beta_in, float eps,
    float* __restrict__ coef, T* __restrict__ y, int rows, int C) {
  constexpr int N = kVec<T>;
  int col, row, step;
  if (!lane<N>(C, col, row, step)) return;
  const bool writes = blockIdx.x == 0 && threadIdx.x < row_threads(C, N);
  float mean[N], s[N], beta[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const Forward f = forward_coef(sums, n, gamma, beta_in, eps, C, col + i);
    mean[i] = f.mean;
    s[i] = f.s;
    beta[i] = f.beta;
    if (writes) {
      const float out[kCoefRows] = {f.mean, f.s, f.beta, f.rstd, f.var, f.live};
#pragma unroll
      for (int k = 0; k < kCoefRows; ++k) coef[(size_t)k * C + col + i] = out[k];
    }
  }
  auto apply = [&](uint4 rh, size_t at) {
    float v[N];
    unpack<T>(rh, v);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float p = pre_act(v[i], mean[i], s[i], beta[i]);
      v[i] = p < 0.f ? 0.f : p;  // NaN stays NaN, as torch.relu
    }
    store<T>(y + at, v);
  };
  for (; row + (U - 1) * step < rows; row += U * step) {
    uint4 rh[U];
#pragma unroll
    for (int u = 0; u < U; ++u) rh[u] = ld16(h + (size_t)(row + u * step) * C + col);
#pragma unroll
    for (int u = 0; u < U; ++u) apply(rh[u], (size_t)(row + u * step) * C + col);
  }
  for (; row < rows; row += step) apply(ld16(h + (size_t)row * C + col), (size_t)row * C + col);
}

// dx = s·g - a - (h - mean)·b, g = dy·[(h - mean)·s + β > 0], with a =
// s·Σg/n and b = s·rstd·Σg·x̂/n (0 where live is 0) from the sums (Σg,
// Σg·x̂) over n rows and the forward's coef (6, C).
template <typename T, int U>
__global__ __launch_bounds__(kThreads) void bn_relu_bwd_kernel(
    const T* __restrict__ dy, const T* __restrict__ h, const float* __restrict__ coef,
    const double* __restrict__ sums, double n, T* __restrict__ dx, int rows, int C) {
  constexpr int N = kVec<T>;
  int col, row, step;
  if (!lane<N>(C, col, row, step)) return;
  float mean[N], s[N], beta[N], a[N], b[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int c = col + i;
    mean[i] = coef[c];
    s[i] = coef[(size_t)C + c];
    beta[i] = coef[(size_t)2 * C + c];
    const float rstd = coef[(size_t)3 * C + c];
    a[i] = __fmul_rn(s[i], __double2float_rn(__ddiv_rn(sums[c], n)));
    b[i] = coef[(size_t)5 * C + c] > 0.f
               ? __fmul_rn(__fmul_rn(s[i], rstd), __double2float_rn(__ddiv_rn(sums[C + c], n)))
               : 0.f;
  }
  auto apply = [&](uint4 rd, uint4 rh, size_t at) {
    float dv[N], hv[N];
    unpack<T>(rd, dv);
    unpack<T>(rh, hv);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float d = __fsub_rn(hv[i], mean[i]);
      const float g = __fadd_rn(__fmul_rn(d, s[i]), beta[i]) > 0.f ? dv[i] : 0.f;
      dv[i] = __fsub_rn(__fsub_rn(__fmul_rn(s[i], g), a[i]), __fmul_rn(d, b[i]));
    }
    store<T>(dx + at, dv);
  };
  for (; row + (U - 1) * step < rows; row += U * step) {
    uint4 rd[U], rh[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const size_t at = (size_t)(row + u * step) * C + col;
      rd[u] = ld16(dy + at);
      rh[u] = ld16(h + at);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) apply(rd[u], rh[u], (size_t)(row + u * step) * C + col);
  }
  for (; row < rows; row += step) {
    const size_t at = (size_t)row * C + col;
    apply(ld16(dy + at), ld16(h + at), at);
  }
}

// ------------------------------------------------------------ launches

int sm_count() {
  static int n = 0;
  if (!n) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

// The grid of a kernel over (rows, C): as many blocks as the card holds at
// once (occ, this kernel's blocks an SM, found once), split over the column
// tiles, no more than the row groups, and at most cap (the partials' rows).
template <typename T>
dim3 grid_for(int occ, int rows, int C, int cap) {
  constexpr int N = kVec<T>;
  const int vt = row_threads(C, N);
  const int tiles = (C / N + vt - 1) / vt;
  const int rpi = kThreads / vt;
  int blocks = occ * sm_count() / tiles;
  const int groups = (rows + rpi - 1) / rpi;
  if (blocks > groups) blocks = groups;
  if (cap > 0 && blocks > cap) blocks = cap;
  return dim3(blocks > 0 ? blocks : 1, tiles);
}

template <typename K>
int occupancy(K kernel, int& cached) {
  if (!cached) {
    int n = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads, 0);
    cached = n > 0 ? n : 1;
  }
  return cached;
}

template <typename T, bool kBwd>
int reduce(const void* h, const void* dy, const void* coef, void* partial, void* out, int rows,
           int C, int cap, cudaStream_t stream) {
  constexpr int U = kBwd ? 2 : 4;
  static int occ = 0;
  auto* k = bn_partial_kernel<T, kBwd, U>;
  const dim3 grid = grid_for<T>(occupancy(k, occ), rows, C, cap);
  k<<<grid, kThreads, 0, stream>>>(static_cast<const T*>(h), static_cast<const T*>(dy),
                                   static_cast<const float*>(coef), static_cast<double*>(partial),
                                   rows, C);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bn_sum_kernel<<<dim3((C + 31) / 32, 2), 256, 0, stream>>>(static_cast<const double*>(partial),
                                                          static_cast<double*>(out), grid.x, C);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int relu_apply(const void* h, const void* sums, double n, const void* gamma, const void* beta,
               float eps, void* coef, void* y, int rows, int C, cudaStream_t stream) {
  static int occ = 0;
  auto* k = bn_relu_kernel<T, 4>;
  k<<<grid_for<T>(occupancy(k, occ), rows, C, 0), kThreads, 0, stream>>>(
      static_cast<const T*>(h), static_cast<const double*>(sums), n,
      static_cast<const float*>(gamma), static_cast<const float*>(beta), eps,
      static_cast<float*>(coef), static_cast<T*>(y), rows, C);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int relu_bwd(const void* dy, const void* h, const void* coef, const void* sums, double n,
             void* dx, int rows, int C, cudaStream_t stream) {
  static int occ = 0;
  auto* k = bn_relu_bwd_kernel<T, 2>;
  k<<<grid_for<T>(occupancy(k, occ), rows, C, 0), kThreads, 0, stream>>>(
      static_cast<const T*>(dy), static_cast<const T*>(h), static_cast<const float*>(coef),
      static_cast<const double*>(sums), n, static_cast<T*>(dx), rows, C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The rows of partials a reduction on device `device` may write, or minus
// a CUDA error code: the most blocks of kThreads an SM holds, times its SMs
// (grid_for never takes more).
extern "C" int pv_bn_partial_rows(int device) {
  int sms = 0, threads = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&threads, cudaDevAttrMaxThreadsPerMultiProcessor, device);
  return err == cudaSuccess ? threads / kThreads * sms : -static_cast<int>(err);
}

// h (rows, C), bf16 (f32 = 0) or f32 (f32 = 1), C a multiple of 8 -> out
// (2, C) f64: Σh, Σh² per column. partial: (2, cap, C) f64 scratch, cap at
// least 1 (the grid takes at most cap blocks; pv_bn_partial_rows is enough).
extern "C" int pv_bn_stats(const void* h, void* partial, void* out, int rows, int C, int cap,
                           int f32, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f32 ? reduce<float, false>(h, nullptr, nullptr, partial, out, rows, C, cap, s)
             : reduce<bf16, false>(h, nullptr, nullptr, partial, out, rows, C, cap, s);
}

// y (rows, C) = relu((h - mean)·s + β) with the coefficients from sums (2,
// C) f64 (Σh, Σh² over n rows), gamma and beta (C,) f32 and eps; writes
// coef (6, C) f32: mean, s, β, rstd, var, live.
extern "C" int pv_bn_relu(const void* h, const void* sums, double n, const void* gamma,
                          const void* beta, float eps, void* coef, void* y, int rows, int C,
                          int f32, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f32 ? relu_apply<float>(h, sums, n, gamma, beta, eps, coef, y, rows, C, s)
             : relu_apply<bf16>(h, sums, n, gamma, beta, eps, coef, y, rows, C, s);
}

// dy, h (rows, C) -> out (2, C) f64: Σg, Σg·x̂; coef: pv_bn_relu's (its rows
// mean, s, β, rstd are read); partial as for pv_bn_stats.
extern "C" int pv_bn_relu_bwd_stats(const void* dy, const void* h, const void* coef, void* partial,
                                    void* out, int rows, int C, int cap, int f32, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f32 ? reduce<float, true>(h, dy, coef, partial, out, rows, C, cap, s)
             : reduce<bf16, true>(h, dy, coef, partial, out, rows, C, cap, s);
}

// dx (rows, C) = s·g - a - (h - mean)·b from coef (6, C) f32 (pv_bn_relu's)
// and sums (2, C) f64 (Σg, Σg·x̂ over n rows).
extern "C" int pv_bn_relu_bwd(const void* dy, const void* h, const void* coef, const void* sums,
                              double n, void* dx, int rows, int C, int f32, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f32 ? relu_bwd<float>(dy, h, coef, sums, n, dx, rows, C, s)
             : relu_bwd<bf16>(dy, h, coef, sums, n, dx, rows, C, s);
}
