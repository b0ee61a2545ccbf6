// Paged decode attention for NVIDIA Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces repro/kernels/paged_attention.py::_pa_kernel (the Pallas TPU
// kernel behind repro.kernels.paged_attention.paged_attention).
//
// What it computes (the same function as the Pallas kernel): each row s
// holds one query token with H heads.  It attends, with grouped GQA (G =
// H / KV query heads per KV head, never repeated), over the KV stream its
// page-table row names: logical token t of row s lives in physical page
// table[s, t / T] at offset t % T.  A key is kept when kpos <= len-1 and,
// with a window, kpos > len-1-window.  Softmax runs online across pages
// with float32 running (max, sum, acc); the row writes acc / max(sum,
// 1e-30), so a row with len == 0 comes out all zeros.
//
// What bounds it on an H100: HBM bytes.  Decode reads every live K/V byte
// of every row once and does 4 flops per K/V element per query head of the
// group -- 4*G flops per 2-byte bf16 element, far below the ~295 flops per
// byte where the card stops being memory-bound.
//
// What this simple design does about that:
//   * one thread block per (row, KV head): the block's G query heads share
//     every K/V element it stages, so each live K/V byte is read from HBM
//     once per row, never once per query head;
//   * the block reads table[s, p] itself (Hopper has no scalar prefetch)
//     and visits only the pages that hold live keys: pages past len-1, and
//     with a window pages wholly before it, are never read;
//   * the page is staged through shared memory kTileTokens tokens at a
//     time, with coalesced 16-byte loads (one head's D elements are
//     contiguous, so D must be a multiple of 16 bytes' worth of elements
//     and the pools 16-byte aligned; the wrapper checks both);
//     the logits, the online softmax and the accumulator stay on chip.
// Left for later work: each tile still waits on one HBM round trip (and
// each page on its table entry first) before any math, since nothing is
// prefetched; a multi-stage pipeline (cp.async or TMA) so that loads overlap
// math, splitting long rows across blocks when S x KV blocks cannot fill
// the 132 SMs (8 decode rows x 8 KV heads = 64 blocks), and wgmma for the
// two products.
//
// Interface: a plain C function (no PyTorch headers), loaded with ctypes.
// It launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileTokens = 64;     // tokens of one page staged at a time
constexpr float kNegInf = -1e30f;   // the masked logit, as in the reference

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Shared-memory floats one block needs (the layout in the kernel below).
__host__ __device__ inline size_t smem_floats(int G, int D) {
  return 2 * (size_t)G * D                         // q, acc
         + (size_t)kTileTokens * (D + 1)           // K tile (padded rows)
         + (size_t)kTileTokens * D                 // V tile
         + (size_t)G * kTileTokens                 // logits / probabilities
         + 3 * (size_t)G;                          // m, l, corr
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q,        // (S, H, D)
                       const T* __restrict__ k_pages,  // (P, T, KV, D)
                       const T* __restrict__ v_pages,  // (P, T, KV, D)
                       const int* __restrict__ table,  // (S, NP)
                       const int* __restrict__ lengths,  // (S,)
                       T* __restrict__ out,            // (S, H, D)
                       int H, int KV, int D, int page_tokens, int NP,
                       int window, float scale) {
  constexpr int kVec = 16 / sizeof(T);         // elements per 16-byte load
  const int row = blockIdx.x;
  const int kvh = blockIdx.y;
  const int G = H / KV;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  extern __shared__ float smem[];
  float* s_q = smem;                           // G x D
  float* s_acc = s_q + G * D;                  // G x D
  float* s_k = s_acc + G * D;                  // kTileTokens x (D + 1)
  float* s_v = s_k + kTileTokens * (D + 1);    // kTileTokens x D
  float* s_p = s_v + kTileTokens * D;          // G x kTileTokens
  float* s_m = s_p + G * kTileTokens;          // G
  float* s_l = s_m + G;                        // G
  float* s_corr = s_l + G;                     // G

  // The G query heads of KV head kvh are heads kvh*G .. kvh*G+G-1: one
  // contiguous run of G*D elements of row `row`.
  const size_t q_base = ((size_t)row * H + (size_t)kvh * G) * D;
  for (int i = tid; i < G * D; i += kThreads) {
    s_q[i] = to_f32(q[q_base + i]);
    s_acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    s_m[g] = kNegInf;
    s_l[g] = 0.f;
  }
  __syncthreads();

  const int len = lengths[row];
  const int qpos = len - 1;                          // -1 on empty rows
  const int lo = window > 0 ? max(0, qpos - window + 1) : 0;
  const int hi = min(qpos, NP * page_tokens - 1);    // last readable key
  const int* row_table = table + (size_t)row * NP;
  const size_t tok_stride = (size_t)KV * D;
  const int vecs_per_row = D / kVec;

  if (len > 0) {
    for (int p = lo / page_tokens; p <= hi / page_tokens; ++p) {
      const size_t page_base =
          (size_t)row_table[p] * page_tokens * tok_stride + (size_t)kvh * D;
      for (int t0 = 0; t0 < page_tokens; t0 += kTileTokens) {
        const int k0 = p * page_tokens + t0;       // first key of the tile
        const int n = min(kTileTokens, page_tokens - t0);
        if (k0 > hi || k0 + n - 1 < lo) continue;  // no live key: skip
        // Every tile processed below holds at least one live key, so its
        // max is finite and masked keys get probability exp(-1e30 - m) = 0.

        // Stage this head's K and V rows of the tile (float32 on chip), 16
        // bytes per load: a thread has few loads in flight, and HBM latency,
        // not bandwidth, sets the time of this step.
        for (int i = tid; i < n * vecs_per_row; i += kThreads) {
          const int j = i / vecs_per_row;
          const int col = (i - j * vecs_per_row) * kVec;
          const size_t src = page_base + (size_t)(t0 + j) * tok_stride + col;
          const uint4 kraw = *reinterpret_cast<const uint4*>(k_pages + src);
          const uint4 vraw = *reinterpret_cast<const uint4*>(v_pages + src);
          const T* kx = reinterpret_cast<const T*>(&kraw);
          const T* vx = reinterpret_cast<const T*>(&vraw);
#pragma unroll
          for (int e = 0; e < kVec; ++e) {
            s_k[j * (D + 1) + col + e] = to_f32(kx[e]);
            s_v[j * D + col + e] = to_f32(vx[e]);
          }
        }
        __syncthreads();

        // Logits of the G heads against the tile's keys, masked.
        for (int i = tid; i < G * n; i += kThreads) {
          const int g = i / n;
          const int j = i - g * n;
          const float* qr = s_q + g * D;
          const float* kr = s_k + j * (D + 1);
          // Four independent sums (D is a multiple of 4): a chain of D
          // dependent FMAs would wait on each shared-memory load in turn.
          float d0 = 0.f, d1 = 0.f, d2 = 0.f, d3 = 0.f;
          for (int d = 0; d < D; d += 4) {
            d0 = fmaf(qr[d], kr[d], d0);
            d1 = fmaf(qr[d + 1], kr[d + 1], d1);
            d2 = fmaf(qr[d + 2], kr[d + 2], d2);
            d3 = fmaf(qr[d + 3], kr[d + 3], d3);
          }
          const float dot = (d0 + d1) + (d2 + d3);
          const int kpos = k0 + j;
          const bool live =
              kpos <= qpos && (window <= 0 || kpos > qpos - window);
          s_p[g * kTileTokens + j] = live ? dot * scale : kNegInf;
        }
        __syncthreads();

        // Online softmax: one warp per head.
        for (int g = warp; g < G; g += kWarps) {
          float* pr = s_p + g * kTileTokens;
          float m_cur = kNegInf;
          for (int j = lane; j < n; j += 32) m_cur = fmaxf(m_cur, pr[j]);
          for (int o = 16; o > 0; o >>= 1)
            m_cur = fmaxf(m_cur, __shfl_xor_sync(0xffffffffu, m_cur, o));
          const float m_prev = s_m[g];
          const float m_new = fmaxf(m_prev, m_cur);
          float sum = 0.f;
          for (int j = lane; j < n; j += 32) {
            const float e = expf(pr[j] - m_new);
            pr[j] = e;
            sum += e;
          }
          for (int o = 16; o > 0; o >>= 1)
            sum += __shfl_xor_sync(0xffffffffu, sum, o);
          if (lane == 0) {
            const float corr = expf(m_prev - m_new);
            s_corr[g] = corr;
            s_l[g] = s_l[g] * corr + sum;
            s_m[g] = m_new;
          }
        }
        __syncthreads();

        // acc = acc * corr + P V
        for (int i = tid; i < G * D; i += kThreads) {
          const int g = i / D;
          const int d = i - g * D;
          const float* pr = s_p + g * kTileTokens;
          const float* vc = s_v + d;
          float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
          int j = 0;
          for (; j + 3 < n; j += 4) {
            a0 = fmaf(pr[j], vc[j * D], a0);
            a1 = fmaf(pr[j + 1], vc[(j + 1) * D], a1);
            a2 = fmaf(pr[j + 2], vc[(j + 2) * D], a2);
            a3 = fmaf(pr[j + 3], vc[(j + 3) * D], a3);
          }
          for (; j < n; ++j) a0 = fmaf(pr[j], vc[j * D], a0);
          s_acc[i] = s_acc[i] * s_corr[g] + ((a0 + a1) + (a2 + a3));
        }
        __syncthreads();
      }
    }
  }

  for (int i = tid; i < G * D; i += kThreads) {
    store_f32(&out[q_base + i], s_acc[i] / fmaxf(s_l[i / D], 1e-30f));
  }
}

template <typename T>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* table, const void* lengths, void* out, int S, int H,
           int KV, int D, int page_tokens, int NP, int window, float scale,
           cudaStream_t stream) {
  const size_t smem = smem_floats(H / KV, D) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        paged_attention_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid(S, KV);
  paged_attention_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), static_cast<const int*>(table),
      static_cast<const int*>(lengths), static_cast<T*>(out), H, KV, D,
      page_tokens, NP, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of shared memory one block needs; the wrapper refuses shapes above
// the 232,448 B a block may use.
size_t paged_attention_smem_bytes(int G, int D) {
  return smem_floats(G, D) * sizeof(float);
}

// dtype: 0 = float32, 1 = bfloat16.  All pointers are device pointers on
// `device`; `stream` is a cudaStream_t.
int paged_attention_fwd(const void* q, const void* k_pages,
                        const void* v_pages, const void* table,
                        const void* lengths, void* out, int S, int H, int KV,
                        int D, int page_tokens, int NP, int window,
                        float scale, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_pages, v_pages, table, lengths, out, S,
                                 H, KV, D, page_tokens, NP, window, scale, st);
  return launch<float>(q, k_pages, v_pages, table, lengths, out, S, H, KV, D,
                       page_tokens, NP, window, scale, st);
}

}  // extern "C"
