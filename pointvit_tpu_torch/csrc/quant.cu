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
// and the output (bf16) written once at 3.35 TB/s. Launch 1 adds a write of
// xq and sx, and launch 2 a read of xq, that the Pallas kernel keeps in
// VMEM: a quarter of an encoder layer's bytes (chip_smoke.py times launch 1
// alone).
//
// Design (Hopper). Launch 1 is one warp per row, which it reads once into
// registers sized to the row (up to 3072 bf16 values; longer rows twice). Launch 2 is an int8 wgmma
// GEMM: one block per 128 x 128 output tile, blocks ordered N fastest so a
// row block's xq is read from device memory once and from L2 by the other
// column tiles. A producer warp streams 128-byte (128 int8) K steps of xq
// (128 rows) and wq (128 rows) by TMA (128-byte swizzle, zeros past M, N and
// K) into a three-stage ring with full and empty mbarriers; two consumer
// warpgroups of 64 rows each issue wgmma m64n128k32 .s32.s8.s8 with both
// operands K-major from shared memory (xq is (M, K) and wq is (N, K): what
// the int8 instruction wants), one wgmma group per K step kept in flight
// while the next stage is awaited. The epilogue stages sx, sw and the bias
// of the tile once in shared memory, dequantises in registers and writes the
// tile row-major into the drained ring, from where all 256 consumer threads
// copy it out in coalesced 16-byte chunks. K % 16 == 0 (TMA's row stride);
// the wrapper pads other K with zero columns.
#include "common.cuh"
#include "sm90.cuh"

namespace {

constexpr float kEps = 1e-8f;

// ------------------------------------------------------------ launch 1

constexpr int kRowThreads = 256;  // one warp per row, 8 rows per block

constexpr int kMaxCached = 12;  // 16-byte chunks a lane holds: rows up to 3072 bf16 or 1536 f32

__device__ __forceinline__ void unpack16(const uint4& t, float (&v)[4]) {
  v[0] = __uint_as_float(t.x);
  v[1] = __uint_as_float(t.y);
  v[2] = __uint_as_float(t.z);
  v[3] = __uint_as_float(t.w);
}
__device__ __forceinline__ void unpack16(const uint4& t, float (&v)[8]) {
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

// round_half_even(v / s) with an IEEE division, except that a zero (half of
// a ReLU's output) divides s instead: the division's check sends a zero
// numerator down its slow path, and 0 / s rounds to 0 all the same.
__device__ __forceinline__ int8_t quantize1(float v, float s) {
  const int q = __float2int_rn(__fdiv_rn(v == 0.f ? s : v, s));
  return static_cast<int8_t>(v == 0.f ? 0 : q);
}

// 16 bytes of x quantized by scale s into xq.
template <int V>
__device__ __forceinline__ void quantize16(const uint4& t, float s, int8_t* dst) {
  float v[V];
  int8_t q[V];
  unpack16(t, v);
#pragma unroll
  for (int i = 0; i < V; ++i) q[i] = quantize1(v[i], s);
  store_q(dst, q);
}

// The row's scale from this lane's partial amax (amax is a max, so every
// order of the values gives the same scale).
__device__ __forceinline__ float row_scale(float amax) {
#pragma unroll
  for (int o = 16; o; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  return fmaxf(__fdiv_rn(amax, 127.f), kEps);
}

// Rows of K values in, rows of Kp = K rounded up to 16 bytes out, the tail
// zero. kCached > 0: the row is whole 16-byte chunks (K % V == 0), at most
// kCached a lane, read once into registers with every load issued before
// the first is used (kCached is the least of 1, 2, 4, 12 that covers the
// row, so short rows keep the registers few and the warps many). kCached == 0: the row is read
// twice, 16 bytes at a time where K % V == 0, else one value at a time.
template <typename T, int kCached>
__global__ __launch_bounds__(kRowThreads) void quantize_rows_kernel(
    const T* __restrict__ x, int8_t* __restrict__ xq, float* __restrict__ sx, int M, int K,
    int Kp) {
  constexpr int V = 16 / sizeof(T);  // values per 16-byte load
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (kRowThreads / 32) + (threadIdx.x >> 5);
  if (row >= M) return;
  const T* xr = x + (size_t)row * K;
  int8_t* qr = xq + (size_t)row * Kp;
  float amax = 0.f, s;
  if constexpr (kCached > 0) {
    uint4 held[kCached];
#pragma unroll
    for (int i = 0; i < kCached; ++i) {
      const int c = (lane + 32 * i) * V;
      held[i] = c < K ? *reinterpret_cast<const uint4*>(xr + c) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int i = 0; i < kCached; ++i) {
      float v[V];
      unpack16(held[i], v);
#pragma unroll
      for (int e = 0; e < V; ++e) amax = fmaxf(amax, fabsf(v[e]));
    }
    s = row_scale(amax);
#pragma unroll
    for (int i = 0; i < kCached; ++i) {
      const int c = (lane + 32 * i) * V;
      if (c < K) quantize16<V>(held[i], s, qr + c);
    }
  } else if (K % V == 0) {
    for (int c = lane * V; c < K; c += 32 * V) {
      float v[V];
      unpack16(*reinterpret_cast<const uint4*>(xr + c), v);
#pragma unroll
      for (int e = 0; e < V; ++e) amax = fmaxf(amax, fabsf(v[e]));
    }
    s = row_scale(amax);
    for (int c = lane * V; c < K; c += 32 * V)
      quantize16<V>(*reinterpret_cast<const uint4*>(xr + c), s, qr + c);
  } else {
    for (int c = lane; c < K; c += 32) amax = fmaxf(amax, fabsf(to_f32(xr[c])));
    s = row_scale(amax);
    for (int c = lane; c < K; c += 32) qr[c] = quantize1(to_f32(xr[c]), s);
  }
  for (int c = K + lane; c < Kp; c += 32) qr[c] = 0;
  if (lane == 0) sx[row] = s;
}

template <typename T>
void launch_quantize_rows(const void* x, void* xq, void* sx, int M, int K, int Kp, cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  const dim3 grid((M + kRowThreads / 32 - 1) / (kRowThreads / 32));
  const T* xp = static_cast<const T*>(x);
  int8_t* q = static_cast<int8_t*>(xq);
  float* sp = static_cast<float*>(sx);
  const int per_lane = K % V ? -1 : (K / V + 31) / 32;  // 16-byte chunks a lane holds
  if (per_lane == 1) {
    quantize_rows_kernel<T, 1><<<grid, kRowThreads, 0, st>>>(xp, q, sp, M, K, Kp);
  } else if (per_lane == 2) {
    quantize_rows_kernel<T, 2><<<grid, kRowThreads, 0, st>>>(xp, q, sp, M, K, Kp);
  } else if (per_lane >= 3 && per_lane <= 4) {
    quantize_rows_kernel<T, 4><<<grid, kRowThreads, 0, st>>>(xp, q, sp, M, K, Kp);
  } else if (per_lane >= 5 && per_lane <= kMaxCached) {
    quantize_rows_kernel<T, kMaxCached><<<grid, kRowThreads, 0, st>>>(xp, q, sp, M, K, Kp);
  } else {
    quantize_rows_kernel<T, 0><<<grid, kRowThreads, 0, st>>>(xp, q, sp, M, K, Kp);
  }
}

// ------------------------------------------------------------ launch 2

constexpr int BM = 128, BN = 128, BK = 128;  // BK in int8 (bytes): one 128-byte swizzled row
constexpr int kStages = 3;
constexpr int kGemmThreads = 288;  // warps 0-7: two consumer warpgroups of 64 rows; warp 8: the producer
constexpr int kStageBytes = (BM + BN) * BK;
constexpr int kScaleOff = kStages * kStageBytes;  // sx[BM], sw[BN], bias[BN]
constexpr int kBarOff = kScaleOff + (BM + 2 * BN) * 4;
constexpr int kGemmSmem = kBarOff + 8 * 2 * kStages;
constexpr int kOutPad = 16;  // bytes after each staged output row: a warp's rows in distinct banks
static_assert(BM * (BN * 4 + kOutPad) <= kStages * kStageBytes, "the f32 output tile fits the ring");

#define PV_S32_D64_OPERANDS(d)                                                                  \
  "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),          \
      "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),   \
      "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),            \
      "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),            \
      "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),            \
      "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]),            \
      "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),            \
      "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),            \
      "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),            \
      "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]),            \
      "+r"(d[62]), "+r"(d[63])

// d (64 x 128 s32, accumulator layout) += A (64 x 32 int8, shared, K-major)
// . B (32 x 128 int8, shared, K-major: 128 rows of W). Exact.
__device__ __forceinline__ void wgmma_s8_n128(int (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " PV_WGMMA_D64 ", %64, %65, p;\n}\n"
      : PV_S32_D64_OPERANDS(d)
      : "l"(a), "l"(b), "r"(1));
}

struct QuantGemmArgs {
  const float* sx;
  const float* sw;
  const float* bias;
  void* out;
  int M, N, K;
};

// out[m0 .. m0 + BM, n0 .. n0 + BN] of one block. The epilogue stages the
// scales once, dequantises each accumulator in registers, writes the tile
// row-major into the (drained) ring and copies it out in 16-byte chunks.
template <typename Out>
__global__ __launch_bounds__(kGemmThreads) void quant_gemm_kernel(
    const __grid_constant__ CUtensorMap amap, const __grid_constant__ CUtensorMap bmap,
    const QuantGemmArgs p) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = smem_addr(smem);
  if (base & 1023) __trap();  // the swizzled tiles need 1024-byte alignment
  const uint32_t full = base + kBarOff, empty = full + 8 * kStages;
  // One linear grid, N tiles fastest (a row block's xq stays in L2), so
  // M may exceed 65535 row tiles.
  const int n_tiles = (p.N + BN - 1) / BN;
  const int n0 = (blockIdx.x % n_tiles) * BN, m0 = (blockIdx.x / n_tiles) * BM;
  const int KT = (p.K + BK - 1) / BK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 256);  // every consumer thread arrives
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int role = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);  // warp-uniform
  if (role == 2) {  // the producer warp
    if (threadIdx.x == 256) {
      for (int kt = 0; kt < KT; ++kt) {
        const int stage = kt % kStages, round = kt / kStages;
        if (round > 0) mbar_wait(empty + 8 * stage, (round - 1) & 1);
        const uint32_t slot = base + stage * kStageBytes, bar = full + 8 * stage;
        mbar_expect_tx(bar, kStageBytes);
        tma_load_2d(slot, &amap, bar, kt * BK, m0);
        tma_load_2d(slot + BM * BK, &bmap, bar, kt * BK, n0);
      }
    }
    return;
  }

  float* sxs = reinterpret_cast<float*>(smem + kScaleOff);
  float* sws = sxs + BM;
  float* bs = sws + BN;
  {
    const int i = threadIdx.x & 127;
    if (role == 0) {
      sxs[i] = m0 + i < p.M ? p.sx[m0 + i] : 0.f;
    } else {
      sws[i] = n0 + i < p.N ? p.sw[n0 + i] : 0.f;
      bs[i] = p.bias && n0 + i < p.N ? p.bias[n0 + i] : 0.f;
    }
  }

  int acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0;
  for (int kt = 0; kt < KT; ++kt) {
    const int stage = kt % kStages;
    mbar_wait(full + 8 * stage, (kt / kStages) & 1);
    const uint32_t a = base + stage * kStageBytes + role * 64 * BK, b = base + stage * kStageBytes + BM * BK;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk) wgmma_s8_n128(acc, desc_kmajor(a + 32 * kk), desc_kmajor(b + 32 * kk));
    wgmma_commit();
    wgmma_wait<1>();  // the previous k-step's group is done: hand its stage back
    if (kt > 0) mbar_arrive(empty + 8 * ((kt - 1) % kStages));
  }
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(acc[i])::"memory");
  asm volatile("bar.sync 1, 256;\n" ::: "memory");  // both warpgroups done with the ring; scales staged

  // Accumulator acc[4 j + e]: row 64 role + 16 w + g + 8 (e >> 1), column
  // 8 j + 2 t + (e & 1) (warp w of the warpgroup, lane 4 g + t).
  constexpr int kRow = BN * sizeof(Out) + kOutPad;
  const int lane = threadIdx.x & 31, t = lane & 3;
  const int r0 = role * 64 + (threadIdx.x >> 5 & 3) * 16 + (lane >> 2);
  const bool has_bias = p.bias != nullptr;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + 8 * half;
    const float sx = sxs[r];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = 8 * j + 2 * t;
      float y[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        y[e] = __fmul_rn(__int2float_rn(acc[4 * j + 2 * half + e]), __fmul_rn(sx, sws[c + e]));
        if (has_bias) y[e] = __fadd_rn(y[e], bs[c + e]);
      }
      unsigned char* dst = smem + r * kRow + c * sizeof(Out);
      if constexpr (sizeof(Out) == 4) {
        *reinterpret_cast<float2*>(dst) = make_float2(y[0], y[1]);
      } else {
        *reinterpret_cast<uint32_t*>(dst) = pack_bf16(y[0], y[1]);
      }
    }
  }
  asm volatile("bar.sync 1, 256;\n" ::: "memory");

  // Copy out: 16-byte chunks along rows; a chunk that leaves the tensor's
  // columns, or rows whose starts are not 16-byte aligned, go value by value.
  constexpr int kPer = 16 / sizeof(Out), kChunks = BN / kPer;
  Out* out = static_cast<Out*>(p.out);
  const bool vec = (p.N % kPer) == 0;
  for (int i = threadIdx.x; i < BM * kChunks; i += 256) {
    const int r = i / kChunks, c = (i % kChunks) * kPer;
    const int gr = m0 + r, gc = n0 + c;
    if (gr >= p.M || gc >= p.N) continue;
    const unsigned char* src = smem + r * kRow + c * sizeof(Out);
    Out* dst = out + (size_t)gr * p.N + gc;
    if (vec && gc + kPer <= p.N) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int e = 0; e < kPer && gc + e < p.N; ++e) dst[e] = reinterpret_cast<const Out*>(src)[e];
    }
  }
}

}  // namespace

// x (M, K) bf16 or f32 -> xq (M, Kp) int8 (columns K.. zero), sx (M,) f32;
// Kp is K rounded up to a multiple of 16.
extern "C" int pv_quantize_rows(const void* x, int x_f32, void* xq, void* sx, int M, int K,
                                int Kp, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_f32) {
    launch_quantize_rows<float>(x, xq, sx, M, K, Kp, s);
  } else {
    launch_quantize_rows<bf16>(x, xq, sx, M, K, Kp, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// xq (M, K) int8 (K a multiple of 16, the row stride TMA needs), wq (N, K)
// int8, sx (M,), sw (N,), bias (N,) or null, all f32 -> out (M, N) bf16 or f32.
extern "C" int pv_quant_gemm(const void* xq, const void* wq, const void* sx, const void* sw,
                             const void* bias, void* out, int out_f32, int M, int N, int K,
                             void* stream) {
  if (M < 1 || N < 1 || K < 1 || K % 16) return static_cast<int>(cudaErrorInvalidValue);
  // first: binds the context the tensor maps need
  cudaFuncSetAttribute(quant_gemm_kernel<float>, cudaFuncAttributeMaxDynamicSharedMemorySize, kGemmSmem);
  cudaFuncSetAttribute(quant_gemm_kernel<bf16>, cudaFuncAttributeMaxDynamicSharedMemorySize, kGemmSmem);
  const uint64_t adims[2] = {(uint64_t)K, (uint64_t)M}, bdims[2] = {(uint64_t)K, (uint64_t)N};
  const uint64_t strides[1] = {(uint64_t)K};
  CUtensorMap amap, bmap;
  if (!pv_tensor_map_of(&amap, CU_TENSOR_MAP_DATA_TYPE_UINT8, xq, 2, adims, strides, BK, BM) ||
      !pv_tensor_map_of(&bmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, wq, 2, bdims, strides, BK, BN)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  QuantGemmArgs p;
  p.sx = static_cast<const float*>(sx);
  p.sw = static_cast<const float*>(sw);
  p.bias = static_cast<const float*>(bias);
  p.out = out;
  p.M = M;
  p.N = N;
  p.K = K;
  const dim3 grid(((N + BN - 1) / BN) * ((M + BM - 1) / BM));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_f32) {
    quant_gemm_kernel<float><<<grid, kGemmThreads, kGemmSmem, s>>>(amap, bmap, p);
  } else {
    quant_gemm_kernel<bf16><<<grid, kGemmThreads, kGemmSmem, s>>>(amap, bmap, p);
  }
  return static_cast<int>(cudaGetLastError());
}
