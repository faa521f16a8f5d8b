// Packed-qkv multi-head attention, forward and backward, for every head dim
// D from 1 to 256 in bf16 and in f32: the cases that the wgmma kernels
// (csrc/attention.cu, csrc/attention_bwd.cu: bf16 at D = 64) do not take.
//
// Replaces, for those cases:
//   - pointvit_tpu/ops/pallas_attention.py::_mha_qkv_pallas (any D; the
//     small benchmark configs run D = 8 and 16 in f32);
//   - its VJP: _mha_qkv_bwd_pallas for D % 8 == 0, the recompute VJP of
//     _reference_mha_qkv for ragged D (pallas_attention.py:454-461).
// Both compute what the Pallas kernels compute: f32 logits q.k * D^-1/2, an
// f32 softmax, P rounded to the input type before P.V; in the backward
// dP = g.V^T and dS = P o (dP - rowsum(dP o P)) * D^-1/2 in f32, dS and P
// rounded to the input type before dQ = dS.K, dK = dS^T.Q and dV = P^T.g,
// which accumulate in f32.
//
// What bounds it on the H100: the products, 4 B S^2 E FLOPs forward and 10
// B S^2 E backward (plus the recomputed logits), here on the CUDA cores at
// 67 TFLOP/s f32: wgmma has no f32 operands, and its tf32 form has no
// transpose bit, so V as it lies in memory cannot feed a tf32 P.V. The
// design is a simple right one; speed is a later step.
//
// Design. A block takes 16 rows of one (cloud, head): 4 warps, 4 rows each.
// Keys stream through shared memory in tiles of 32, converted to f32, rows
// padded by one float so that lane j reading key j's row is conflict-free.
//   - forward: pass 1 finds each row's max and sum (online, one key a lane);
//     pass 2 recomputes the logits, writes P (rounded) to shared memory and
//     accumulates P.V with one output column a lane (D / 32 a lane).
//   - backward, rows launch: the row statistics (pass 1), delta = rowsum(dP
//     o P) (pass 2), then dS and dQ (pass 3); it writes dQ and the
//     statistics (max, sum, delta) of every row.
//   - backward, keys launch: a block takes 16 keys; query tiles of 32 rows
//     stream through shared memory with their statistics; each lane
//     recomputes one query's P and dS against the warp's 4 keys, then dK and
//     dV accumulate with one column a lane.
// No atomics, no split: two runs give the same bits.
#include "common.cuh"

#include <math.h>

namespace {

constexpr int kRows = 16;   // query rows (keys in the keys launch) a block
constexpr int kTile = 32;   // keys (queries in the keys launch) a streamed tile
constexpr int kThreads = 128;
constexpr int kPerWarp = kRows / (kThreads / 32);

struct Shape {
  int S, H, D;
  float scale;
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// rows [r0, r0 + n) of column block `col` (D wide) of a (S, width) matrix
// into dst (n rows of `stride` floats); zeros past S.
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, int stride, const T* src, int width, int col,
                                          int r0, int n, const Shape& sh) {
  for (int i = threadIdx.x; i < n * sh.D; i += kThreads) {
    const int r = i / sh.D, d = i % sh.D;
    dst[r * stride + d] = r0 + r < sh.S ? ld(src, (size_t)(r0 + r) * width + col + d) : 0.f;
  }
}

__device__ __forceinline__ float dot(const float* a, const float* b, int D) {
  float s = 0.f;
  for (int d = 0; d < D; ++d) s = fmaf(a[d], b[d], s);
  return s;
}

// Pass 1 of a row block: each warp row's max m and sum l of exp(s - m) over
// all S keys (online). qs: the block's query rows (D floats each).
template <typename T>
__device__ void row_stats(const T* kbase, int width, int kcol, const float* qs, float* ks,
                          const Shape& sh, float (&m)[kPerWarp], float (&l)[kPerWarp]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int rr = 0; rr < kPerWarp; ++rr) {
    m[rr] = -INFINITY;
    l[rr] = 0.f;
  }
  for (int j0 = 0; j0 < sh.S; j0 += kTile) {
    __syncthreads();
    load_rows(ks, sh.D + 1, kbase, width, kcol, j0, kTile, sh);
    __syncthreads();
    const bool valid = j0 + lane < sh.S;
#pragma unroll
    for (int rr = 0; rr < kPerWarp; ++rr) {
      const int r = warp * kPerWarp + rr;
      const float s = valid ? dot(qs + r * sh.D, ks + lane * (sh.D + 1), sh.D) * sh.scale : -INFINITY;
      const float mn = fmaxf(m[rr], warp_max(s));  // finite: every tile holds a key
      l[rr] = l[rr] * expf(m[rr] - mn) + warp_sum(valid ? expf(s - mn) : 0.f);
      m[rr] = mn;
    }
  }
}

template <typename T, int NPL>
__global__ __launch_bounds__(kThreads) void attn_any_fwd_kernel(const T* __restrict__ qkv,
                                                                T* __restrict__ out, Shape sh) {
  extern __shared__ float sm[];
  const int D = sh.D, E = sh.H * D, width = 3 * E;
  float* qs = sm;                         // [kRows][D]
  float* ks = qs + kRows * D;             // [kTile][D + 1]
  float* vs = ks + kTile * (D + 1);       // [kTile][D]
  float* ps = vs + kTile * D;             // [kRows][kTile]
  const int b = blockIdx.z, h = blockIdx.y, i0 = blockIdx.x * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const T* base = qkv + (size_t)b * sh.S * width;
  load_rows(qs, D, base, width, h * D, i0, kRows, sh);
  float m[kPerWarp], l[kPerWarp];
  row_stats(base, width, E + h * D, qs, ks, sh, m, l);

  float acc[kPerWarp][NPL];
#pragma unroll
  for (int rr = 0; rr < kPerWarp; ++rr)
#pragma unroll
    for (int e = 0; e < NPL; ++e) acc[rr][e] = 0.f;
  for (int j0 = 0; j0 < sh.S; j0 += kTile) {
    __syncthreads();
    load_rows(ks, D + 1, base, width, E + h * D, j0, kTile, sh);
    load_rows(vs, D, base, width, 2 * E + h * D, j0, kTile, sh);
    __syncthreads();
    const bool valid = j0 + lane < sh.S;
#pragma unroll
    for (int rr = 0; rr < kPerWarp; ++rr) {
      const int r = warp * kPerWarp + rr;
      float p = 0.f;
      if (valid) p = expf(dot(qs + r * D, ks + lane * (D + 1), D) * sh.scale - m[rr]) / l[rr];
      ps[r * kTile + lane] = rounded<T>(p);  // P rounded to T before P.V
    }
    __syncwarp();
    const int n = min(kTile, sh.S - j0);
#pragma unroll
    for (int rr = 0; rr < kPerWarp; ++rr) {
      const float* pr = ps + (warp * kPerWarp + rr) * kTile;
      for (int j = 0; j < n; ++j) {
        const float pj = pr[j];
#pragma unroll
        for (int e = 0; e < NPL; ++e) {
          const int d = lane + 32 * e;
          if (d < D) acc[rr][e] = fmaf(pj, vs[j * D + d], acc[rr][e]);
        }
      }
    }
  }
#pragma unroll
  for (int rr = 0; rr < kPerWarp; ++rr) {
    const int i = i0 + warp * kPerWarp + rr;
    if (i >= sh.S) continue;
    T* o = out + ((size_t)b * sh.S + i) * E + h * D;
#pragma unroll
    for (int e = 0; e < NPL; ++e) {
      const int d = lane + 32 * e;
      if (d < D) o[d] = cvt<T>(acc[rr][e]);
    }
  }
}

// The rows launch of the backward: dQ, and the statistics (m, l, delta) of
// every query row into stats [3][B][H][S].
template <typename T, int NPL>
__global__ __launch_bounds__(kThreads) void attn_any_bwd_rows_kernel(
    const T* __restrict__ qkv, const T* __restrict__ g, T* __restrict__ dqkv,
    float* __restrict__ stats, int B, Shape sh) {
  extern __shared__ float sm[];
  const int D = sh.D, E = sh.H * D, width = 3 * E;
  float* qs = sm;                         // [kRows][D]
  float* gs = qs + kRows * D;             // [kRows][D]
  float* ks = gs + kRows * D;             // [kTile][D + 1]
  float* vs = ks + kTile * (D + 1);       // [kTile][D + 1]
  float* ds = vs + kTile * (D + 1);       // [kRows][kTile]
  const int b = blockIdx.z, h = blockIdx.y, i0 = blockIdx.x * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const T* base = qkv + (size_t)b * sh.S * width;
  load_rows(qs, D, base, width, h * D, i0, kRows, sh);
  load_rows(gs, D, g + (size_t)b * sh.S * E, E, h * D, i0, kRows, sh);
  float m[kPerWarp], l[kPerWarp], delta[kPerWarp];
  row_stats(base, width, E + h * D, qs, ks, sh, m, l);

  // Pass 2: delta = sum_j P_ij dP_ij, P and dP in f32.
#pragma unroll
  for (int rr = 0; rr < kPerWarp; ++rr) delta[rr] = 0.f;
  for (int j0 = 0; j0 < sh.S; j0 += kTile) {
    __syncthreads();
    load_rows(ks, D + 1, base, width, E + h * D, j0, kTile, sh);
    load_rows(vs, D + 1, base, width, 2 * E + h * D, j0, kTile, sh);
    __syncthreads();
    const bool valid = j0 + lane < sh.S;
#pragma unroll
    for (int rr = 0; rr < kPerWarp; ++rr) {
      const int r = warp * kPerWarp + rr;
      float t = 0.f;
      if (valid) {
        const float p = expf(dot(qs + r * D, ks + lane * (D + 1), D) * sh.scale - m[rr]) / l[rr];
        t = p * dot(gs + r * D, vs + lane * (D + 1), D);
      }
      delta[rr] += warp_sum(t);
    }
  }

  // Pass 3: dS (rounded to T) and dQ = dS.K.
  float acc[kPerWarp][NPL];
#pragma unroll
  for (int rr = 0; rr < kPerWarp; ++rr)
#pragma unroll
    for (int e = 0; e < NPL; ++e) acc[rr][e] = 0.f;
  for (int j0 = 0; j0 < sh.S; j0 += kTile) {
    __syncthreads();
    load_rows(ks, D + 1, base, width, E + h * D, j0, kTile, sh);
    load_rows(vs, D + 1, base, width, 2 * E + h * D, j0, kTile, sh);
    __syncthreads();
    const bool valid = j0 + lane < sh.S;
#pragma unroll
    for (int rr = 0; rr < kPerWarp; ++rr) {
      const int r = warp * kPerWarp + rr;
      float t = 0.f;
      if (valid) {
        const float p = expf(dot(qs + r * D, ks + lane * (D + 1), D) * sh.scale - m[rr]) / l[rr];
        t = p * (dot(gs + r * D, vs + lane * (D + 1), D) - delta[rr]) * sh.scale;
      }
      ds[r * kTile + lane] = rounded<T>(t);
    }
    __syncwarp();
    const int n = min(kTile, sh.S - j0);
#pragma unroll
    for (int rr = 0; rr < kPerWarp; ++rr) {
      const float* dr = ds + (warp * kPerWarp + rr) * kTile;
      for (int j = 0; j < n; ++j) {
        const float dj = dr[j];
#pragma unroll
        for (int e = 0; e < NPL; ++e) {
          const int d = lane + 32 * e;
          if (d < D) acc[rr][e] = fmaf(dj, ks[j * (D + 1) + d], acc[rr][e]);
        }
      }
    }
  }
  const size_t plane = (size_t)B * sh.H * sh.S;
#pragma unroll
  for (int rr = 0; rr < kPerWarp; ++rr) {
    const int i = i0 + warp * kPerWarp + rr;
    if (i >= sh.S) continue;
    T* o = dqkv + ((size_t)b * sh.S + i) * width + h * D;
#pragma unroll
    for (int e = 0; e < NPL; ++e) {
      const int d = lane + 32 * e;
      if (d < D) o[d] = cvt<T>(acc[rr][e]);
    }
    if (lane == 0) {
      const size_t at = ((size_t)b * sh.H + h) * sh.S + i;
      stats[at] = m[rr];
      stats[plane + at] = l[rr];
      stats[2 * plane + at] = delta[rr];
    }
  }
}

// The keys launch of the backward: dK = dS^T.Q and dV = P^T.g for 16 keys a
// block, from the rows launch's statistics.
template <typename T, int NPL>
__global__ __launch_bounds__(kThreads) void attn_any_bwd_keys_kernel(
    const T* __restrict__ qkv, const T* __restrict__ g, T* __restrict__ dqkv,
    const float* __restrict__ stats, int B, Shape sh) {
  extern __shared__ float sm[];
  const int D = sh.D, E = sh.H * D, width = 3 * E;
  float* kk = sm;                          // [kRows][D]: the block's keys
  float* vk = kk + kRows * D;              // [kRows][D]: their values
  float* qs = vk + kRows * D;              // [kTile][D + 1]: streamed queries
  float* gs = qs + kTile * (D + 1);        // [kTile][D + 1]: their cotangents
  float* st = gs + kTile * (D + 1);        // [3][kTile]: their m, l, delta
  float* ps = st + 3 * kTile;              // [kRows][kTile]: P (rounded)
  float* ds = ps + kRows * kTile;          // [kRows][kTile]: dS (rounded)
  const int b = blockIdx.z, h = blockIdx.y, j0 = blockIdx.x * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const T* base = qkv + (size_t)b * sh.S * width;
  const T* gb = g + (size_t)b * sh.S * E;
  load_rows(kk, D, base, width, E + h * D, j0, kRows, sh);
  load_rows(vk, D, base, width, 2 * E + h * D, j0, kRows, sh);
  const size_t plane = (size_t)B * sh.H * sh.S, srow = ((size_t)b * sh.H + h) * sh.S;

  float dk[kPerWarp][NPL], dv[kPerWarp][NPL];
#pragma unroll
  for (int rr = 0; rr < kPerWarp; ++rr)
#pragma unroll
    for (int e = 0; e < NPL; ++e) dk[rr][e] = dv[rr][e] = 0.f;
  for (int i0 = 0; i0 < sh.S; i0 += kTile) {
    __syncthreads();
    load_rows(qs, D + 1, base, width, h * D, i0, kTile, sh);
    load_rows(gs, D + 1, gb, E, h * D, i0, kTile, sh);
    if (threadIdx.x < kTile && i0 + threadIdx.x < sh.S) {
      for (int c = 0; c < 3; ++c) st[c * kTile + threadIdx.x] = stats[c * plane + srow + i0 + threadIdx.x];
    }
    __syncthreads();
    const bool valid = i0 + lane < sh.S;  // lane: query i0 + lane
#pragma unroll
    for (int rr = 0; rr < kPerWarp; ++rr) {
      const int r = warp * kPerWarp + rr;  // key j0 + r
      float p = 0.f, t = 0.f;
      if (valid) {
        const float* qi = qs + lane * (D + 1);
        p = expf(dot(qi, kk + r * D, D) * sh.scale - st[lane]) / st[kTile + lane];
        t = p * (dot(gs + lane * (D + 1), vk + r * D, D) - st[2 * kTile + lane]) * sh.scale;
      }
      ps[r * kTile + lane] = rounded<T>(p);
      ds[r * kTile + lane] = rounded<T>(t);
    }
    __syncwarp();
    const int n = min(kTile, sh.S - i0);
#pragma unroll
    for (int rr = 0; rr < kPerWarp; ++rr) {
      const int r = warp * kPerWarp + rr;
      for (int i = 0; i < n; ++i) {
        const float pi = ps[r * kTile + i], di = ds[r * kTile + i];
#pragma unroll
        for (int e = 0; e < NPL; ++e) {
          const int d = lane + 32 * e;
          if (d < D) {
            dk[rr][e] = fmaf(di, qs[i * (D + 1) + d], dk[rr][e]);
            dv[rr][e] = fmaf(pi, gs[i * (D + 1) + d], dv[rr][e]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int rr = 0; rr < kPerWarp; ++rr) {
    const int j = j0 + warp * kPerWarp + rr;
    if (j >= sh.S) continue;
    T* o = dqkv + ((size_t)b * sh.S + j) * width + h * D;
#pragma unroll
    for (int e = 0; e < NPL; ++e) {
      const int d = lane + 32 * e;
      if (d < D) {
        o[E + d] = cvt<T>(dk[rr][e]);
        o[2 * E + d] = cvt<T>(dv[rr][e]);
      }
    }
  }
}

// Shared memory of each kernel, in floats.
int fwd_smem(int D) { return 4 * (kRows * D + kTile * (D + 1) + kTile * D + kRows * kTile); }
int rows_smem(int D) { return 4 * (2 * kRows * D + 2 * kTile * (D + 1) + kRows * kTile); }
int keys_smem(int D) { return 4 * (2 * kRows * D + 2 * kTile * (D + 1) + 3 * kTile + 2 * kRows * kTile); }

template <typename Kernel, typename... Args>
int launch(Kernel kernel, int smem, const Shape& sh, int B, cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sh.S + kRows - 1) / kRows, sh.H, B);
  kernel<<<grid, kThreads, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int NPL>
int forward(const void* qkv, void* out, int B, const Shape& sh, cudaStream_t stream) {
  return launch(attn_any_fwd_kernel<T, NPL>, fwd_smem(sh.D), sh, B, stream, static_cast<const T*>(qkv),
                static_cast<T*>(out), sh);
}

template <typename T, int NPL>
int backward(const void* qkv, const void* g, void* dqkv, float* stats, int B, const Shape& sh,
             cudaStream_t stream) {
  const int err = launch(attn_any_bwd_rows_kernel<T, NPL>, rows_smem(sh.D), sh, B, stream,
                         static_cast<const T*>(qkv), static_cast<const T*>(g), static_cast<T*>(dqkv),
                         stats, B, sh);
  if (err) return err;
  return launch(attn_any_bwd_keys_kernel<T, NPL>, keys_smem(sh.D), sh, B, stream,
                static_cast<const T*>(qkv), static_cast<const T*>(g), static_cast<T*>(dqkv),
                static_cast<const float*>(stats), B, sh);
}

// The instance for D (values a lane: D / 32 rounded up to 1, 2, 4 or 8).
template <template <typename, int> class F, typename T, typename... Args>
int dispatch(int D, Args... args) {
  if (D <= 32) return F<T, 1>::run(args...);
  if (D <= 64) return F<T, 2>::run(args...);
  if (D <= 128) return F<T, 4>::run(args...);
  return F<T, 8>::run(args...);
}
template <typename T, int NPL>
struct Fwd {
  static int run(const void* qkv, void* out, int B, Shape sh, cudaStream_t s) {
    return forward<T, NPL>(qkv, out, B, sh, s);
  }
};
template <typename T, int NPL>
struct Bwd {
  static int run(const void* qkv, const void* g, void* dqkv, float* stats, int B, Shape sh,
                 cudaStream_t s) {
    return backward<T, NPL>(qkv, g, dqkv, stats, B, sh, s);
  }
};

bool shape_ok(int B, int S, int H, int D) {
  return B >= 1 && B <= 65535 && S >= 1 && H >= 1 && H <= 65535 && D >= 1 && D <= 256;
}

}  // namespace

// qkv (B, S, 3 H D) packed [q | k | v], heads contiguous -> out (B, S, H D);
// both bf16 (f32 = 0) or both f32 (f32 = 1); 1 <= D <= 256.
extern "C" int pv_attention_any(const void* qkv, void* out, int B, int S, int H, int D, float scale,
                                int f32, void* stream) {
  if (!shape_ok(B, S, H, D)) return static_cast<int>(cudaErrorInvalidValue);
  const Shape sh{S, H, D, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f32 ? dispatch<Fwd, float>(D, qkv, out, B, sh, s) : dispatch<Fwd, bf16>(D, qkv, out, B, sh, s);
}

// qkv (B, S, 3 H D), g (B, S, H D) -> dqkv (B, S, 3 H D), all bf16 (f32 =
// 0) or all f32 (f32 = 1); stats: 3 B H S floats of scratch. Two launches.
extern "C" int pv_attention_any_bwd(const void* qkv, const void* g, void* dqkv, void* stats, int B,
                                    int S, int H, int D, float scale, int f32, void* stream) {
  if (!shape_ok(B, S, H, D)) return static_cast<int>(cudaErrorInvalidValue);
  const Shape sh{S, H, D, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* st = static_cast<float*>(stats);
  return f32 ? dispatch<Bwd, float>(D, qkv, g, dqkv, st, B, sh, s)
             : dispatch<Bwd, bf16>(D, qkv, g, dqkv, st, B, sh, s);
}
