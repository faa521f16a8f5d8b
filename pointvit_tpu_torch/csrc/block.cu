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
// LayerNorm. Bound by bytes: it reads a (rows, E) bf16 tensor and writes one
// of the same size, a few operations per element. One warp per row; the row
// is re-read from L1 for each of the three passes; statistics are f32 and
// eps is 1e-6, the flax default that the JAX package uses. The positional
// variant reads x and pos, writes xp = bf16(x + pos) (the attention half's
// residual) and LN(xp) in the same pass, so the sum is never re-read from
// device memory; a shared (1, S, E) pos is indexed by row % S.
#include "common.cuh"

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
