// The non-GEMM kernels of the APF and ViT blocks: LayerNorm, and LayerNorm
// with the positional re-add. The blocks' attention is csrc/attention.cu.
//
// Replaces, with the GEMM of gemm.cu and the attention of attention.cu:
//   - pointvit_tpu/ops/pallas_block.py::_apf_block_pallas (kernels
//     _attn_half_kernel and _mlp_half_kernel);
//   - pointvit_tpu/ops/pallas_block.py::_vit_block_pallas (kernels
//     _vit_attn_half_kernel and _vit_mlp_half_kernel), the Pix4Point block,
//     whose attention half adds the positional embedding before LN1.
//
// LayerNorm. Bound by bytes: it reads a (rows, E) tensor and writes one of
// the same size, a few operations per element. Both kernels are templated on
// the element type: bf16, and f32 for the f32 models. One warp per row;
// the row is re-read from L1 for each of the three passes; statistics are
// f32 and eps is 1e-6, the flax default that the JAX package uses. The
// positional variant reads x and pos, writes xp = x + pos rounded to the
// element type (the attention half's residual) and LN(xp) in the same pass, so the sum is never re-read from
// device memory; a shared (1, S, E) pos is indexed by row % S.
#include "common.cuh"

namespace {

// ---------------------------------------------------------------- LayerNorm

constexpr int kLnRows = 8;  // rows per block, one warp each

template <typename T>
__global__ __launch_bounds__(kLnRows * 32) void layernorm_kernel(
    const T* __restrict__ x, const T* __restrict__ gamma, const T* __restrict__ beta,
    T* __restrict__ y, int rows, int E, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kLnRows + (threadIdx.x >> 5);
  if (row >= rows) return;
  const T* xr = x + (size_t)row * E;
  float s = 0.f;
  for (int c = lane; c < E; c += 32) s += ld(xr, c);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  const float mu = s / E;
  float q = 0.f;
  for (int c = lane; c < E; c += 32) {
    const float d = ld(xr, c) - mu;
    q += d * d;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) q += __shfl_xor_sync(0xffffffffu, q, off);
  const float rstd = rsqrtf(q / E + eps);
  T* yr = y + (size_t)row * E;
  for (int c = lane; c < E; c += 32)
    yr[c] = cvt<T>((ld(xr, c) - mu) * rstd * ld(gamma, c) + ld(beta, c));
}

// xp = x + pos rounded to T (an f32 add of two bf16 values rounds once, as a
// bf16 add does), then y = LN(xp). pos row = row % pos_rows.
template <typename T>
__global__ __launch_bounds__(kLnRows * 32) void pos_layernorm_kernel(
    const T* __restrict__ x, const T* __restrict__ pos, int pos_rows,
    const T* __restrict__ gamma, const T* __restrict__ beta, T* __restrict__ xp,
    T* __restrict__ y, int rows, int E, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kLnRows + (threadIdx.x >> 5);
  if (row >= rows) return;
  const T* xr = x + (size_t)row * E;
  const T* pr = pos + (size_t)(row % pos_rows) * E;
  T* xpr = xp + (size_t)row * E;
  float s = 0.f;
  for (int c = lane; c < E; c += 32) {
    const T v = cvt<T>(ld(xr, c) + ld(pr, c));
    xpr[c] = v;
    s += ld(&v, 0);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  const float mu = s / E;
  float q = 0.f;
  for (int c = lane; c < E; c += 32) {  // each lane re-reads only what it wrote
    const float d = ld(xpr, c) - mu;
    q += d * d;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) q += __shfl_xor_sync(0xffffffffu, q, off);
  const float rstd = rsqrtf(q / E + eps);
  T* yr = y + (size_t)row * E;
  for (int c = lane; c < E; c += 32)
    yr[c] = cvt<T>((ld(xpr, c) - mu) * rstd * ld(gamma, c) + ld(beta, c));
}

template <typename T>
int layernorm(const void* x, const void* gamma, const void* beta, void* y, int rows, int E,
              float eps, cudaStream_t stream) {
  const int blocks = (rows + kLnRows - 1) / kLnRows;
  layernorm_kernel<T><<<blocks, kLnRows * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(gamma), static_cast<const T*>(beta),
      static_cast<T*>(y), rows, E, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int pos_layernorm(const void* x, const void* pos, int pos_rows, const void* gamma,
                  const void* beta, void* xp, void* y, int rows, int E, float eps,
                  cudaStream_t stream) {
  const int blocks = (rows + kLnRows - 1) / kLnRows;
  pos_layernorm_kernel<T><<<blocks, kLnRows * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(pos), pos_rows,
      static_cast<const T*>(gamma), static_cast<const T*>(beta), static_cast<T*>(xp),
      static_cast<T*>(y), rows, E, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (rows, E), gamma/beta (E,) -> y (rows, E), all bf16 (f32 = 0) or all
// f32 (f32 = 1).
extern "C" int pv_layernorm(const void* x, const void* gamma, const void* beta, void* y, int rows,
                            int E, float eps, int f32, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f32 ? layernorm<float>(x, gamma, beta, y, rows, E, eps, s)
             : layernorm<bf16>(x, gamma, beta, y, rows, E, eps, s);
}

// x (rows, E), pos (pos_rows, E), gamma/beta (E,) -> xp = x + pos (rows, E)
// and y = LN(xp) (rows, E), all bf16 (f32 = 0) or all f32 (f32 = 1); pos
// row = row % pos_rows.
extern "C" int pv_pos_layernorm(const void* x, const void* pos, int pos_rows, const void* gamma,
                                const void* beta, void* xp, void* y, int rows, int E, float eps,
                                int f32, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f32 ? pos_layernorm<float>(x, pos, pos_rows, gamma, beta, xp, y, rows, E, eps, s)
             : pos_layernorm<bf16>(x, pos, pos_rows, gamma, beta, xp, y, rows, E, eps, s);
}
