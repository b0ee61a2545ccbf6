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
// Two bodies, chosen by the caller (kernels/matmul_cc.py::matmul_path):
//
// * wgmma (bf16 operands whose rows TMA can describe: K and N multiples
//   of 8).  The products run on the tensor cores.  A block has one
//   producer warpgroup and bm/64 consumer warpgroups (bm 64 or 128).  One
//   thread of the producer issues TMA loads of A (bm x 64 boxes, K-major)
//   and B (64 x bk boxes of the (K, N) rows, N-major) into a ring of
//   kStages shared-memory stages with 128-byte swizzle; a stage's "full"
//   mbarrier counts the bytes in, its "empty" mbarrier the consumers'
//   release.  Each consumer warpgroup runs wgmma m64n{bn}k16 over its 64
//   rows of the stage (A K-major; B MN-major through the transpose bit, so
//   B is never transposed in memory), keeping the f32 sums in registers
//   (bn/2 a thread), while the producer fills the next stages.  setmaxnreg
//   moves registers from the producer to the consumers.  TMA zero-fills
//   boxes past M, N and K, so ragged edges need no masking in the loads;
//   the epilogue stores only row < M, col < N, from the accumulator
//   fragment's (row, col) map.  The K stream is summed in one fixed order
//   per output element (k steps in order, wgmma's own order inside one),
//   whatever the block's tile, so cc and srrc stay bit-identical.
// * simt (float32 operands -- wgmma has no full-f32 product and TF32 would
//   miss the 1e-4 tolerance -- and bf16 shapes TMA cannot describe).
//   Each tile of A and B is staged once into shared memory and reused by
//   every thread of the block; each thread keeps an 8 x 8 micro-tile of
//   float32 sums in registers and runs float32 FMAs on the CUDA cores.
//   Ragged edges are masked in the loads.
//
// Left for later work on the wgmma body: persistent blocks (one per SM,
// the epilogue of one tile overlapping the loads of the next), clusters
// with TMA multicast of the shared operand, two consumer warpgroups in
// ping-pong, a TMA store of C.
//
// Interface: a plain C function (no PyTorch headers), loaded with ctypes.
// It launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError() (0 on success), or an error of hopper.cuh's
// make_map_bf16 when a TMA descriptor cannot be built.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {


// ---------------------------------------------------------------------------
// wgmma body (bf16)
// ---------------------------------------------------------------------------

constexpr int kAtom = 64;          // bf16 values in one 128-byte swizzled row
constexpr int kStages = 4;         // TMA ring depth
// Dynamic shared memory beyond the stages: slack to align the tiles to
// 1,024 bytes (128-byte swizzle), and the mbarriers.
constexpr int kAlignSlack = 1024;
constexpr int kBarrierBytes = 128;

// BN: the tile's N extent (64..256, one wgmma's N); NC: consumer
// warpgroups, bm = 64 * NC.  bk (a multiple of 64, at most 256) is a
// run-time value.
template <int BN, int NC>
__global__ void __launch_bounds__(128 * (NC + 1), 1)
matmul_cc_wgmma_kernel(const __grid_constant__ CUtensorMap tm_a,  // (M, K)
                       const __grid_constant__ CUtensorMap tm_b,  // (K, N)
                       __nv_bfloat16* __restrict__ C,             // (M, N)
                       int M, int K, int N, int bk, int gn,
                       int serpentine) {
  constexpr int BM = 64 * NC;
  // Block id -> output tile (the traversal order).
  const int ti = blockIdx.x / gn;
  int tj = blockIdx.x - ti * gn;
  if (serpentine && (ti & 1)) tj = gn - 1 - tj;
  const int row0 = ti * BM;
  const int col0 = tj * BN;

  extern __shared__ __align__(16) unsigned char smem_wg[];
  unsigned char* base = hopper::align_1024(smem_wg);
  const uint32_t a_bytes = (uint32_t)BM * bk * 2;   // one stage of A
  const uint32_t b_bytes = (uint32_t)bk * BN * 2;   // one stage of B
  // Stage s: A as bk/64 boxes of (BM rows x 64), B as BN/64 boxes of
  // (bk rows x 64 columns); each box is 128-byte rows, 1,024-aligned.
  unsigned char* s_a = base;
  unsigned char* s_b = base + kStages * a_bytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(s_b + kStages * b_bytes);
  uint64_t* empty = full + kStages;
  const int nk = (K + bk - 1) / bk;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], NC * 128);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // Producer: one thread keeps up to kStages K steps in flight.
    hopper::setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % kStages;
        if (kt >= kStages)
          hopper::mbar_wait(&empty[s], ((kt / kStages) - 1) & 1);
        hopper::mbar_arrive_expect_tx(&full[s], a_bytes + b_bytes);
        const int k0 = kt * bk;
        for (int j = 0; j < bk / kAtom; ++j)
          hopper::tma_load_2d(s_a + s * a_bytes + j * (BM * 128), &tm_a,
                              &full[s], k0 + j * kAtom, row0);
        for (int j = 0; j < BN / kAtom; ++j)
          hopper::tma_load_2d(s_b + s * b_bytes + j * (bk * 128), &tm_b,
                              &full[s], col0 + j * kAtom, k0);
      }
    }
  } else {
    // Consumer warpgroup c: rows 64c .. 64c + 63 of the tile.
    hopper::setmaxnreg_inc<NC == 2 ? 232 : 240>();
    const int c = wg - 1;
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % kStages;
      hopper::mbar_wait(&full[s], (kt / kStages) & 1);
      const unsigned char* a_st = s_a + s * a_bytes + c * (64 * 128);
      const unsigned char* b_st = s_b + s * b_bytes;
      hopper::fence_regs(acc);
      hopper::wgmma_fence();
      for (int j = 0; j < bk / kAtom; ++j) {
#pragma unroll
        for (int kk = 0; kk < kAtom / 16; ++kk) {
          // A: K-major, 32 bytes per k step inside the 128-byte row.
          const uint64_t da = hopper::desc_sw128(
              a_st + j * (BM * 128) + kk * 32, 16, 1024);
          // B: N-major, 16 rows of 128 bytes per k step; LBO steps over
          // the 64-column boxes.
          const uint64_t db = hopper::desc_sw128(
              b_st + (j * kAtom + kk * 16) * 128, bk * 128, 1024);
          hopper::wgmma_ss<BN, 1>(acc, da, db, 1);
        }
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      hopper::mbar_arrive(&empty[s]);
    }

    // Epilogue: the m64nN accumulator fragment holds, for n8 group g,
    // acc[4g + {0,1}] at (row, 8g + 2q + {0,1}) and acc[4g + {2,3}] at
    // (row + 8, same columns), row = 16 * warp + lane / 4, q = lane % 4.
    const int lane = threadIdx.x & 31;
    const int warp = (threadIdx.x & 127) >> 5;
    const int r0 = row0 + c * 64 + warp * 16 + (lane >> 2);
    const int cq = col0 + (lane & 3) * 2;
#pragma unroll
    for (int g = 0; g < BN / 8; ++g) {
      const int col = cq + g * 8;
      if (col >= N) continue;        // N is even: col + 1 < N too
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r0 + 8 * h;
        if (row < M)
          *reinterpret_cast<__nv_bfloat162*>(&C[(size_t)row * N + col]) =
              __floats2bfloat162_rn(acc[4 * g + 2 * h],
                                    acc[4 * g + 2 * h + 1]);
      }
    }
  }
}

size_t wgmma_smem_bytes(int bm, int bk, int bn) {
  return (size_t)kStages * ((size_t)bm * bk + (size_t)bk * bn) * 2 +
         kAlignSlack + kBarrierBytes;
}

template <int BN, int NC>
int launch_wgmma_bn(const CUtensorMap& ta, const CUtensorMap& tb, void* c,
                    int M, int K, int N, int bk, int serpentine,
                    cudaStream_t stream) {
  constexpr int BM = 64 * NC;
  const size_t smem = wgmma_smem_bytes(BM, bk, BN);
  cudaError_t err = cudaFuncSetAttribute(
      matmul_cc_wgmma_kernel<BN, NC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int gm = (M + BM - 1) / BM;
  const int gn = (N + BN - 1) / BN;
  matmul_cc_wgmma_kernel<BN, NC><<<gm * gn, 128 * (NC + 1), smem, stream>>>(
      ta, tb, static_cast<__nv_bfloat16*>(c), M, K, N, bk, gn, serpentine);
  return (int)cudaGetLastError();
}

template <int NC>
int launch_wgmma_nc(const CUtensorMap& ta, const CUtensorMap& tb, void* c,
                    int M, int K, int N, int bk, int bn, int serpentine,
                    cudaStream_t stream) {
  switch (bn) {
    case 64:
      return launch_wgmma_bn<64, NC>(ta, tb, c, M, K, N, bk, serpentine,
                                     stream);
    case 128:
      return launch_wgmma_bn<128, NC>(ta, tb, c, M, K, N, bk, serpentine,
                                      stream);
    case 192:
      return launch_wgmma_bn<192, NC>(ta, tb, c, M, K, N, bk, serpentine,
                                      stream);
    case 256:
      return launch_wgmma_bn<256, NC>(ta, tb, c, M, K, N, bk, serpentine,
                                      stream);
  }
  return (int)cudaErrorInvalidValue;
}

int launch_wgmma(const void* a, const void* b, void* c, int M, int K, int N,
                 int bm, int bk, int bn, int serpentine,
                 cudaStream_t stream) {
  if (bm % 64 || bm > 128 || bk % kAtom || bk > 256 || bn % kAtom ||
      bn > 256 || K % 8 || N % 8)
    return (int)cudaErrorInvalidValue;
  CUtensorMap ta, tb;
  const uint64_t a_dims[2] = {(uint64_t)K, (uint64_t)M};
  const uint64_t a_strides[1] = {(uint64_t)K * 2};
  const uint32_t a_box[2] = {(uint32_t)kAtom, (uint32_t)bm};
  int rc = hopper::make_map_bf16(&ta, a, 2, a_dims, a_strides, a_box);
  if (rc) return rc;
  const uint64_t b_dims[2] = {(uint64_t)N, (uint64_t)K};
  const uint64_t b_strides[1] = {(uint64_t)N * 2};
  const uint32_t b_box[2] = {(uint32_t)kAtom, (uint32_t)bk};
  rc = hopper::make_map_bf16(&tb, b, 2, b_dims, b_strides, b_box);
  if (rc) return rc;
  if (bm == 64)
    return launch_wgmma_nc<1>(ta, tb, c, M, K, N, bk, bn, serpentine, stream);
  return launch_wgmma_nc<2>(ta, tb, c, M, K, N, bk, bn, serpentine, stream);
}

// ---------------------------------------------------------------------------
// simt body (float32, and bf16 shapes TMA cannot describe)
// ---------------------------------------------------------------------------

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
matmul_cc_simt_kernel(const T* __restrict__ A,   // (M, K)
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

size_t simt_smem_bytes(int bm, int bk, int bn, int dtype) {
  return ((size_t)bm * bk + (size_t)bk * bn) * (dtype == 1 ? 2 : 4);
}

template <typename T>
int launch_simt(const void* a, const void* b, void* c, int M, int K, int N,
                int bm, int bk, int bn, int serpentine, int dtype,
                cudaStream_t stream) {
  const size_t smem = simt_smem_bytes(bm, bk, bn, dtype);
  cudaError_t err = cudaFuncSetAttribute(
      matmul_cc_simt_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int gm = (M + bm - 1) / bm;
  const int gn = (N + bn - 1) / bn;
  const int threads = (bm / kMicro) * (bn / kMicro);
  matmul_cc_simt_kernel<T><<<gm * gn, threads, smem, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(c),
      M, K, N, bm, bk, bn, gn, serpentine);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of shared memory one block needs for tile (bm, bk, bn).  dtype:
// 0 = float32, 1 = bfloat16; path: 0 = simt, 1 = wgmma (bf16 only).
size_t matmul_cc_smem_bytes(int bm, int bk, int bn, int dtype, int path) {
  if (path == 1) return wgmma_smem_bytes(bm, bk, bn);
  return simt_smem_bytes(bm, bk, bn, dtype);
}

// C = A @ B.  serpentine: 0 = cc, 1 = srrc.  path 1 (wgmma): bf16, bm 64
// or 128, bk a multiple of 64 up to 256, bn one of 64/128/192/256, K and
// N multiples of 8.  path 0 (simt): bm and bn multiples of 8 with
// (bm/8)*(bn/8) <= 512 threads.  The wrapper checks both.
int matmul_cc_fwd(const void* a, const void* b, void* c, int M, int K,
                  int N, int bm, int bk, int bn, int serpentine, int dtype,
                  int path, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (path == 1) {
    if (dtype != 1) return (int)cudaErrorInvalidValue;
    return launch_wgmma(a, b, c, M, K, N, bm, bk, bn, serpentine, st);
  }
  if (dtype == 1)
    return launch_simt<__nv_bfloat16>(a, b, c, M, K, N, bm, bk, bn,
                                      serpentine, dtype, st);
  return launch_simt<float>(a, b, c, M, K, N, bm, bk, bn, serpentine, dtype,
                            st);
}

}  // extern "C"
