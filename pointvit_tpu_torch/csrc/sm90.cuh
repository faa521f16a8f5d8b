// Hopper (sm_90a) primitives for the attention and int8 kernels: mbarriers,
// TMA tile loads through a tensor map and plain bulk copies, warpgroup MMA
// (wgmma) with shared-memory descriptors, and the host-side encoding of a
// tensor map.
//
// Layout convention. Every tile these kernels hand to wgmma is 64 bf16
// values (128 bytes) wide and a multiple of 8 rows deep, written by TMA with
// CU_TENSOR_MAP_SWIZZLE_128B (or by threads with the same swizzle: the
// 16-byte chunk c of row r lies at chunk c ^ (r % 8)), and starts on a
// 1024-byte boundary. Such a tile is read
//   - K-major (the 64 contiguous values are the product's depth): descriptor
//     with stride 1024 bytes between 8-row groups; a 16-deep slice k starts
//     32 * k bytes further;
//   - MN-major (the 64 contiguous values are the product's N): the same
//     8-row groups of 1024 bytes, now along the depth; a 16-deep slice starts
//     2048 * k bytes further, and the instruction's transpose bit is set.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

// ------------------------------------------------------------------ mbarrier

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
// Makes the initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// One arrival that also announces `bytes` of TMA traffic to the barrier.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
// Waits until the barrier's phase of parity `parity` has completed. A phase
// that never completes is a fault: the kernel traps (the launch then
// reports an error) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done, tries = 0;
  do {
    if (++tries == (1u << 26)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// ----------------------------------------------------------------------- TMA

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// A plain bulk copy of `bytes` (a multiple of 16, from a 16-byte aligned
// address) into shared memory, announced to `bar` like a tile.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Byte offset of element (r, c) in a 64-wide swizzled bf16 tile.
__device__ __forceinline__ uint32_t swz128(int r, int c) {
  return r * 128 + ((((c >> 3) ^ (r & 7)) & 7) << 4) + (c & 7) * 2;
}

// ---------------------------------------------------------------------- wgmma

constexpr int kTileBytes = 64 * 128;  // one 64 x 64 bf16 tile

// Descriptor of a 128-byte-swizzled tile at shared address `saddr`; lbo and
// sbo in bytes.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t saddr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}
// K-major: 8-row groups 1024 bytes apart (the leading offset is unused).
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t saddr) { return wgmma_desc(saddr, 16, 1024); }
// MN-major: 8-deep groups 1024 bytes apart along the depth; N is one 64-wide
// swizzle atom, so the leading offset (the stride between atoms along N) is
// never taken and is given the same 1024.
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t saddr) { return wgmma_desc(saddr, 1024, 1024); }

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving accumulator reads or writes across a wgmma.
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define PV_WGMMA_D32                                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define PV_WGMMA_D32_OPERANDS(d)                                                              \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),        \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),          \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),          \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

// d (64 x 64 f32, accumulator layout) (+)= A (64 x 16, shared, K-major) . B
// (16 x 64, shared, K-major); accumulate = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " PV_WGMMA_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : PV_WGMMA_D32_OPERANDS(d)
      : "l"(a), "l"(b), "r"(accumulate));
}
#define PV_WGMMA_D64                                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "         \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "         \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// The same with N = 128: d is 64 floats, columns 0-63 in d[0, 32) and
// 64-127 in d[32, 64) (each half in the 64-column layout); B is two 64-row
// K-major tiles, the second 8 KB after the first.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " PV_WGMMA_D64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : PV_WGMMA_D32_OPERANDS(d), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}
// d (+)= A (64 x 16 bf16 from registers, the m16n8k16 A fragment of each
// warp's 16 rows) . B (16 x 64, shared; kTransB = 1: MN-major).
template <int kTransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " PV_WGMMA_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : PV_WGMMA_D32_OPERANDS(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate), "n"(kTransB));
}

// ------------------------------------------------------------ host: tensor map

typedef CUresult (*PvEncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver through the runtime, so the library
// needs no -lcuda.
static PvEncodeTiled pv_encode_tiled() {
  static PvEncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<PvEncodeTiled>(p);
  }
  return fn;
}

// A tensor of `rank` (2 or 3) dimensions, innermost first: dims[i]
// elements, strides[i] bytes between steps of dimension i + 1; boxes of
// box_inner x box_rows (x 1) elements, 128-byte swizzled (box_inner times
// the element size is at most 128 bytes), zeros outside the tensor.
// Returns false if the driver refused it. The driver encodes against the
// calling thread's current context, which a runtime call binds (an autograd
// thread may not have made one yet): callers make theirs, such as
// cudaFuncSetAttribute, first.
static bool pv_tensor_map_of(CUtensorMap* map, CUtensorMapDataType type, const void* base,
                             int rank, const uint64_t* dims, const uint64_t* strides,
                             uint32_t box_inner, uint32_t box_rows) {
  PvEncodeTiled encode = pv_encode_tiled();
  if (!encode) return false;
  const cuuint32_t box[3] = {box_inner, box_rows, 1}, ones[3] = {1, 1, 1};
  return encode(map, type, rank, const_cast<void*>(base),
                reinterpret_cast<const cuuint64_t*>(dims),
                reinterpret_cast<const cuuint64_t*>(strides), box, ones,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A bf16 tensor in boxes of 64 x box_rows (x 1) elements: the tiles of the
// layout convention above.
static bool pv_tensor_map(CUtensorMap* map, const void* base, int rank, const uint64_t* dims,
                          const uint64_t* strides, uint32_t box_rows) {
  return pv_tensor_map_of(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, base, rank, dims, strides, 64,
                          box_rows);
}
