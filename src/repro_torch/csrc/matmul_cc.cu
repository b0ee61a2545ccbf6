// Cache-conscious blocked matmul for NVIDIA Hopper (sm_90a), hand-written
// CUDA C++.
//
// Replaces repro/kernels/matmul_cc.py::_mm_kernel (the Pallas TPU kernel
// behind repro.kernels.matmul_cc.matmul_cc).
//
// What it computes (the same function as the Pallas kernel): C = A @ B for
// A (M, K) and B (K, N), row-major, summed in float32 over the whole K
// stream and rounded to the inputs' dtype once.  The block extents
// (bm, bk, bn) are the planner's tile (repro_torch.core.autotile): one
// thread block per (bm x bn) output tile, a loop over K in bk steps.
//
// Order.  On the TPU the grid runs in order on one core, and the order
// decides which operand blocks are reused.  Here blocks run concurrently
// on 132 SMs, so the order becomes the mapping from block id to output
// tile, and decides which tiles are in flight together (and so which A
// rows and B columns share the 50 MB L2): `cc` is row-major over the
// (M, N) tile grid; `srrc` walks N backwards on odd M rows (serpentine),
// so the tiles at the turn share B columns.  Each output element is summed
// in the same order whatever the mapping, so both give bit-identical C.
//
// What bounds it on an H100: operations.  At the MLP shapes it serves
// (4096 x 2048 x 8192) it does about 1,170 flops per byte it must read,
// far above the ~295 where the card stops being memory-bound.
//
// What this simple design does about that: each tile of A and B is staged
// once into shared memory and reused by every thread of the block; each
// thread keeps an 8 x 8 micro-tile of float32 sums in registers, so a
// k-step costs 16 shared-memory values for 64 FMAs.  Ragged edges are
// masked in the kernel (zeros staged past M, N and K), not padded in
// memory.  Left for later work: the products run on the CUDA cores in
// float32 (67 TFLOP/s), not the tensor cores (989 TFLOP/s bf16 with
// wgmma); loads are not pipelined (no cp.async or TMA), so each K step
// waits on one HBM round trip.
//
// Interface: a plain C function (no PyTorch headers), loaded with ctypes.
// It launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMicro = 8;          // each thread's 8 x 8 output micro-tile
constexpr int kMaxThreads = 512;   // 128 registers a thread

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

// Eight consecutive values from 16-byte-aligned shared memory.
__device__ __forceinline__ void load8(const float* p, float (&o)[kMicro]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p,
                                      float (&o)[kMicro]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(h[e]);
    o[2 * e] = f.x;
    o[2 * e + 1] = f.y;
  }
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
matmul_cc_kernel(const T* __restrict__ A,   // (M, K)
                 const T* __restrict__ B,   // (K, N)
                 T* __restrict__ C,         // (M, N)
                 int M, int K, int N, int bm, int bk, int bn, int gn,
                 int serpentine) {
  // Block id -> output tile (the traversal order).
  const int ti = blockIdx.x / gn;
  int tj = blockIdx.x - ti * gn;
  if (serpentine && (ti & 1)) tj = gn - 1 - tj;
  const int row0 = ti * bm;
  const int col0 = tj * bn;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sA = reinterpret_cast<T*>(smem_raw);   // bm x bk, row-major
  T* sB = sA + (size_t)bm * bk;             // bk x bn, row-major

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int tcols = bn / kMicro;
  const int ty = tid / tcols;
  const int tx = tid - ty * tcols;
  const int r0 = ty * kMicro;
  const int c0 = tx * kMicro;

  float acc[kMicro][kMicro];
#pragma unroll
  for (int i = 0; i < kMicro; ++i)
#pragma unroll
    for (int j = 0; j < kMicro; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += bk) {
    // Stage the A and B tiles, zeros past the ragged edges.  Consecutive
    // threads take consecutive elements of a row: coalesced reads.
    for (int i = tid; i < bm * bk; i += nthreads) {
      const int r = i / bk;
      const int kk = i - r * bk;
      const int gr = row0 + r;
      const int gk = k0 + kk;
      sA[i] = (gr < M && gk < K) ? A[(size_t)gr * K + gk] : zero<T>();
    }
    for (int i = tid; i < bk * bn; i += nthreads) {
      const int kk = i / bn;
      const int c = i - kk * bn;
      const int gk = k0 + kk;
      const int gc = col0 + c;
      sB[i] = (gk < K && gc < N) ? B[(size_t)gk * N + gc] : zero<T>();
    }
    __syncthreads();

    const int kn = min(bk, K - k0);
    for (int kk = 0; kk < kn; ++kk) {
      float a[kMicro], b[kMicro];
      // A's column: threads of one row group read the same address
      // (a broadcast); B's row: eight values in one 16-byte (bf16) or
      // two (float32) vector loads.
#pragma unroll
      for (int i = 0; i < kMicro; ++i)
        a[i] = to_f32(sA[(size_t)(r0 + i) * bk + kk]);
      load8(sB + (size_t)kk * bn + c0, b);
#pragma unroll
      for (int i = 0; i < kMicro; ++i)
#pragma unroll
        for (int j = 0; j < kMicro; ++j)
          acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kMicro; ++i) {
    const int gr = row0 + r0 + i;
    if (gr >= M) break;
#pragma unroll
    for (int j = 0; j < kMicro; ++j) {
      const int gc = col0 + c0 + j;
      if (gc < N) store_f32(&C[(size_t)gr * N + gc], acc[i][j]);
    }
  }
}

size_t smem_bytes_of(int bm, int bk, int bn, int dtype) {
  return ((size_t)bm * bk + (size_t)bk * bn) * (dtype == 1 ? 2 : 4);
}

template <typename T>
int launch(const void* a, const void* b, void* c, int M, int K, int N,
           int bm, int bk, int bn, int serpentine, int dtype,
           cudaStream_t stream) {
  const size_t smem = smem_bytes_of(bm, bk, bn, dtype);
  cudaError_t err = cudaFuncSetAttribute(
      matmul_cc_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int gm = (M + bm - 1) / bm;
  const int gn = (N + bn - 1) / bn;
  const int threads = (bm / kMicro) * (bn / kMicro);
  matmul_cc_kernel<T><<<gm * gn, threads, smem, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(c),
      M, K, N, bm, bk, bn, gn, serpentine);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of shared memory one block needs for tile (bm, bk, bn); dtype:
// 0 = float32, 1 = bfloat16.
size_t matmul_cc_smem_bytes(int bm, int bk, int bn, int dtype) {
  return smem_bytes_of(bm, bk, bn, dtype);
}

// C = A @ B.  bm and bn are multiples of 8 with (bm/8)*(bn/8) <= 512
// threads; the wrapper checks.  serpentine: 0 = cc, 1 = srrc.
int matmul_cc_fwd(const void* a, const void* b, void* c, int M, int K,
                  int N, int bm, int bk, int bn, int serpentine, int dtype,
                  int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(a, b, c, M, K, N, bm, bk, bn, serpentine,
                                 dtype, st);
  return launch<float>(a, b, c, M, K, N, bm, bk, bn, serpentine, dtype, st);
}

}  // extern "C"
