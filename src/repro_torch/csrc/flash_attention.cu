// Flash attention for NVIDIA Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces repro/kernels/flash_attention.py::_fa_kernel (the Pallas TPU
// kernel behind repro.kernels.flash_attention.flash_attention).
//
// What it computes (the same function as the Pallas kernel): for q
// (B, H, Sq, D) and k, v (B, H, Sk, D), softmax(q k^T / sqrt(D)) v per
// (batch, head), with an online softmax over block_kv partitions of the
// keys (float32 running max m, sum l and accumulator).  Keys at or past Sk
// are masked; with `causal`, query i sees keys <= i + (Sk - Sq) (the
// sequence ends aligned, q_offset = Sk - Sq).  A row that sees no key
// (causal with Sq > Sk) is undefined, as in the Pallas kernel.  The
// probabilities are rounded to V's dtype before the product with V, as
// the Pallas kernel does.
//
// What bounds it on an H100: operations.  Over 4096 tokens at D = 64 it
// does 4 * Sq * Sk * D flops (halved by the causal mask) for 4 * S * D
// elements moved per head: hundreds of flops per byte.
//
// What this simple design does about that: one thread block per
// (batch*head, block_q rows).  The block stages one block_kv tile of K and
// one of V in shared memory (16-byte loads: rows are contiguous, so a tile
// is one contiguous run) and every query row of the block reuses it.  A
// query row belongs to D/32 neighbouring threads (one thread for D <= 32),
// each holding 32 of its dims of q and of the accumulator in registers;
// the partial dot products are summed with warp shuffles.  Scores are
// taken 16 keys at a time, so the running max and the rescale of the
// accumulator happen once per 16 keys.  Under the causal mask the block
// stops at the last key its last row sees, which halves the work.  Left
// for later work: the products run on the CUDA cores in float32, not on
// the tensor cores with wgmma; K/V tiles are not double-buffered (no
// cp.async or TMA), so each tile waits on HBM.
//
// Interface: a plain C function (no PyTorch headers), loaded with ctypes.
// It launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 512;   // 128 registers a thread
constexpr int kSlice = 32;         // head dims one thread holds (at most)
constexpr int kKeyStep = 16;       // scores taken per online-softmax step
constexpr float kNegInf = -1e30f;  // the masked logit, as in the reference

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
// x rounded to T's precision (the probability cast of the reference).
__device__ __forceinline__ float round_as(float x, const float*) {
  return x;
}
__device__ __forceinline__ float round_as(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}

// Eight consecutive values from 16-byte-aligned shared memory.
__device__ __forceinline__ void load8(const float* p, float (&o)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&o)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(h[e]);
    o[2 * e] = f.x;
    o[2 * e + 1] = f.y;
  }
}

// DT: head dims one thread holds (16 or 32); a row has D / DT threads.
template <typename T, int DT>
__global__ void __launch_bounds__(kMaxThreads)
flash_attention_kernel(const T* __restrict__ q,    // (B*H, Sq, D)
                       const T* __restrict__ k,    // (B*H, Sk, D)
                       const T* __restrict__ v,    // (B*H, Sk, D)
                       T* __restrict__ out,        // (B*H, Sq, D)
                       int Sq, int Sk, int D, int block_q, int block_kv,
                       int causal, float scale) {
  const int g = D / DT;                 // threads per query row
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * block_q;
  const int tid = threadIdx.x;
  const int r = tid / g;
  const int part = tid - r * g;
  const int qi = q0 + r;
  const bool row_ok = r < block_q && qi < Sq;
  const int q_offset = Sk - Sq;
  const int qpos = qi + q_offset;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sK = reinterpret_cast<T*>(smem_raw);     // block_kv x D
  T* sV = sK + (size_t)block_kv * D;          // block_kv x D

  float qr[DT], acc[DT];
  const size_t qoff = ((size_t)bh * Sq + (row_ok ? qi : 0)) * D + part * DT;
#pragma unroll
  for (int c = 0; c < DT; c += 8) {
    float t[8];
    if (row_ok) {
#pragma unroll
      for (int e = 0; e < 8; ++e) t[e] = to_f32(q[qoff + c + e]);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) t[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      qr[c + e] = t[e];
      acc[c + e] = 0.f;
    }
  }
  float m = kNegInf, l = 0.f;

  // Keys the block needs: all of them, or under the causal mask those up
  // to the one its last row sees.
  int kv_end = Sk;
  if (causal) {
    const int last = min(q0 + block_q, Sq) - 1 + q_offset;
    kv_end = max(0, min(Sk, last + 1));
  }
  const size_t kv_base = (size_t)bh * Sk * D;
  constexpr int kVec = 16 / sizeof(T);        // elements per 16-byte load

  for (int k0 = 0; k0 < kv_end; k0 += block_kv) {
    const int n = min(block_kv, Sk - k0);
    __syncthreads();                          // the last tile is consumed
    // Stage the tile: n rows of D contiguous elements of K and of V.
    const int nvec = n * D / kVec;
    const uint4* gk = reinterpret_cast<const uint4*>(k + kv_base + (size_t)k0 * D);
    const uint4* gv = reinterpret_cast<const uint4*>(v + kv_base + (size_t)k0 * D);
    uint4* skv = reinterpret_cast<uint4*>(sK);
    uint4* svv = reinterpret_cast<uint4*>(sV);
    for (int i = tid; i < nvec; i += blockDim.x) {
      skv[i] = gk[i];
      svv[i] = gv[i];
    }
    __syncthreads();

    for (int j0 = 0; j0 < n; j0 += kKeyStep) {
      float s[kKeyStep];
      float m_cur = kNegInf;
#pragma unroll
      for (int i = 0; i < kKeyStep; ++i) {
        const int j = j0 + i;
        float d0 = 0.f, d1 = 0.f;
        if (j < n) {
          const T* kr = sK + (size_t)j * D + part * DT;
#pragma unroll
          for (int c = 0; c < DT; c += 8) {
            float kx[8];
            load8(kr + c, kx);
#pragma unroll
            for (int e = 0; e < 8; e += 2) {
              d0 = fmaf(qr[c + e], kx[e], d0);
              d1 = fmaf(qr[c + e + 1], kx[e + 1], d1);
            }
          }
        }
        float dot = d0 + d1;
        for (int o = 1; o < g; o <<= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, o);
        const int kpos = k0 + j;
        const bool live = j < n && (!causal || kpos <= qpos);
        s[i] = live ? dot * scale : kNegInf;
        m_cur = fmaxf(m_cur, s[i]);
      }
      const float m_new = fmaxf(m, m_cur);
      const float corr = expf(m - m_new);
      float psum = 0.f;
#pragma unroll
      for (int d = 0; d < DT; ++d) acc[d] *= corr;
#pragma unroll
      for (int i = 0; i < kKeyStep; ++i) {
        const int j = j0 + i;
        if (j >= n) break;
        const float p = expf(s[i] - m_new);
        psum += p;
        const float pv = round_as(p, sV);
        const T* vr = sV + (size_t)j * D + part * DT;
#pragma unroll
        for (int c = 0; c < DT; c += 8) {
          float vx[8];
          load8(vr + c, vx);
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[c + e] = fmaf(pv, vx[e], acc[c + e]);
        }
      }
      l = l * corr + psum;
      m = m_new;
    }
  }

  if (row_ok) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int d = 0; d < DT; ++d) store_f32(&out[qoff + d], acc[d] * inv);
  }
}

size_t smem_bytes_of(int block_kv, int D, int dtype) {
  return 2 * (size_t)block_kv * D * (dtype == 1 ? 2 : 4);
}

template <typename T, int DT>
int launch_dt(const void* q, const void* k, const void* v, void* out,
              int BH, int Sq, int Sk, int D, int block_q, int block_kv,
              int causal, float scale, int dtype, cudaStream_t stream) {
  const size_t smem = smem_bytes_of(block_kv, D, dtype);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, DT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int g = D / DT;
  const int threads = ((block_q * g + 31) / 32) * 32;
  dim3 grid((Sq + block_q - 1) / block_q, BH);
  flash_attention_kernel<T, DT><<<grid, threads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Sq, Sk, D, block_q,
      block_kv, causal, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int BH,
           int Sq, int Sk, int D, int block_q, int block_kv, int causal,
           float scale, int dtype, cudaStream_t stream) {
  if (D == 16)
    return launch_dt<T, 16>(q, k, v, out, BH, Sq, Sk, D, block_q, block_kv,
                            causal, scale, dtype, stream);
  return launch_dt<T, kSlice>(q, k, v, out, BH, Sq, Sk, D, block_q,
                              block_kv, causal, scale, dtype, stream);
}

}  // namespace

extern "C" {

// Bytes of shared memory one block needs: the K and V tiles.
size_t flash_attention_smem_bytes(int block_kv, int D, int dtype) {
  return smem_bytes_of(block_kv, D, dtype);
}

// D is 16, 32, 64, 128 or 256; the threads of a block (block_q * D/32,
// rounded up to a warp) are at most 512; the wrapper checks both.
// dtype: 0 = float32, 1 = bfloat16.
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        void* out, int BH, int Sq, int Sk, int D,
                        int block_q, int block_kv, int causal, float scale,
                        int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, out, BH, Sq, Sk, D, block_q,
                                 block_kv, causal, scale, dtype, st);
  return launch<float>(q, k, v, out, BH, Sq, Sk, D, block_q, block_kv,
                       causal, scale, dtype, st);
}

}  // extern "C"
