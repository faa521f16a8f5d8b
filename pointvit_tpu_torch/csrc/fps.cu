// Farthest-point sampling: one thread block per cloud.
//
// Replaces: pointvit_tpu/ops/pallas_fps.py::fps_pallas (kernel _fps_kernel).
//
// What bounds it on the H100: neither bytes nor FLOPs. A cloud is 12 KB of
// coordinates, and each of the S steps is a few operations per point, but
// the steps are strictly sequential: step i+1 needs the arg-max of step i.
// The kernel is bound by the latency of S block-wide arg-max reductions.
//
// Design: the cloud's coordinates and its running min-distance field sit in
// shared memory for all S steps, so no step touches device memory except to
// write one index. Above 14,528 points they do not fit: the coordinates are
// then read from the input and the field from a device-memory scratch (the
// cloud, 240 KB at N = 20,000, stays in the 50 MB L2). Each step updates the
// field, each thread keeps its local (value, index) best, a warp-shuffle
// reduction and one pass over the warp winners give the block's arg-max.
// Equal values go to the lower index, the rule of jnp.argmax and
// torch.argmax. The distance is written with
// __fmul_rn/__fadd_rn as ((dx*dx + dy*dy) + dz*dz): no FMA contraction, so
// the bits equal those of the plain version and near-ties resolve alike.
#include "common.cuh"

#include <math_constants.h>

namespace {

constexpr int kThreads = 512;

__device__ __forceinline__ void better(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

// kSmem: coordinates and distance field in shared memory (N <= 14,528);
// otherwise the coordinates are read from the (B, N, 3) input, which stays
// in L2, and the distance field lives in a (B, N) f32 scratch. A thread
// reads and writes only its own indices of the field, so the two modes run
// the same steps in the same order and select the same points.
template <bool kSmem>
__global__ __launch_bounds__(kThreads) void fps_kernel(const float* __restrict__ xyz,
                                                       const int* __restrict__ start,
                                                       int* __restrict__ out,
                                                       float* __restrict__ dist_g, int N, int S) {
  extern __shared__ float sm[];
  constexpr int st = kSmem ? 1 : 3;  // stride between one point's coordinate and the next's
  __shared__ float wv[kThreads / 32];
  __shared__ int wi[kThreads / 32];
  __shared__ int far_s;

  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* src = xyz + (size_t)b * N * 3;
  const float *px = src, *py = src + 1, *pz = src + 2;
  float* dist = kSmem ? nullptr : dist_g + (size_t)b * N;
  if (kSmem) {
    float* sx = sm;
    float* sy = sx + N;
    float* sz = sy + N;
    for (int i = tid; i < N; i += kThreads) {
      sx[i] = src[3 * i];
      sy[i] = src[3 * i + 1];
      sz[i] = src[3 * i + 2];
    }
    px = sx;
    py = sy;
    pz = sz;
    dist = sz + N;
  }
  for (int i = tid; i < N; i += kThreads) dist[i] = CUDART_INF_F;
  if (tid == 0) far_s = start[b];
  __syncthreads();

  for (int s = 0; s < S; ++s) {
    const int far = far_s;
    if (tid == 0) out[(size_t)b * S + s] = far;
    const float cx = px[far * st], cy = py[far * st], cz = pz[far * st];
    float bv = -CUDART_INF_F;
    int bi = N;
    for (int i = tid; i < N; i += kThreads) {
      const float dx = __fsub_rn(px[i * st], cx);
      const float dy = __fsub_rn(py[i * st], cy);
      const float dz = __fsub_rn(pz[i * st], cz);
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
      const float m = fminf(dist[i], d);
      dist[i] = m;
      if (m > bv) {  // i rises within a thread: strict '>' keeps the lowest index
        bv = m;
        bi = i;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      better(bv, bi, __shfl_xor_sync(0xffffffffu, bv, off), __shfl_xor_sync(0xffffffffu, bi, off));
    }
    if (lane == 0) {
      wv[warp] = bv;
      wi[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      bv = lane < kThreads / 32 ? wv[lane] : -CUDART_INF_F;
      bi = lane < kThreads / 32 ? wi[lane] : N;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        better(bv, bi, __shfl_xor_sync(0xffffffffu, bv, off),
               __shfl_xor_sync(0xffffffffu, bi, off));
      }
      if (lane == 0) far_s = bi;
    }
    __syncthreads();
  }
}

}  // namespace

// Largest N whose coordinates and distance field fit shared memory.
extern "C" int pv_fps_smem_max_points() { return 227 * 1024 / (4 * sizeof(float)); }

// xyz (B, N, 3) f32, start (B,) i32 -> out (B, S) i32. dist: a (B, N) f32
// scratch for N above pv_fps_smem_max_points(), else null.
extern "C" int pv_fps(const void* xyz, const void* start, void* out, void* dist, int B, int N,
                      int S, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N <= pv_fps_smem_max_points()) {
    const size_t smem = (size_t)4 * N * sizeof(float);
    cudaFuncSetAttribute(fps_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    fps_kernel<true><<<B, kThreads, smem, st>>>(static_cast<const float*>(xyz),
                                                static_cast<const int*>(start),
                                                static_cast<int*>(out), nullptr, N, S);
  } else {
    if (dist == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    fps_kernel<false><<<B, kThreads, 0, st>>>(static_cast<const float*>(xyz),
                                              static_cast<const int*>(start),
                                              static_cast<int*>(out), static_cast<float*>(dist), N,
                                              S);
  }
  return static_cast<int>(cudaGetLastError());
}
