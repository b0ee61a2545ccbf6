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
// byte where the card stops being memory-bound.  So the design's job is to
// keep enough bytes in flight to fill HBM's bandwidth, and to spend no
// more than the page's own load time on the math.
//
// Two bodies:
//
// `split` (bf16, D 64 or 128, T a multiple of 8 up to 256, G <= 16):
//   * flash-decoding: the grid is (KV head, row, split), each split a fixed
//     run of `split_pages` whole logical pages of the row's table, and the
//     split the slowest index, so the first splits of every row, where its
//     live keys begin, are dispatched first and the empty splits of short
//     rows after them.  The host picks the split from shapes alone (rows,
//     KV heads, table width, page size), never from `lengths`, so a launch
//     needs no host sync.  At the
//     decode shape (8 rows x 8 KV heads) one block per (row, head) gave 64
//     blocks for 132 SMs; splitting gives every live page run a block of
//     its own.  A split without a live key writes an empty partial (m =
//     -inf, l = 0) and returns;
//   * the block reads its split's table entries once, then one thread
//     issues a TMA load per page for K and for V (a 3-D map over the pool
//     viewed as (D, KV, P*T), box (64, 1, T), 128-byte swizzle) into a ring
//     of kStages (= the plan's PAGE_BUFFERING, 2) page stages, completed on
//     an mbarrier: page i+1 is in flight while page i is computed, and no
//     thread spends a register or an instruction on the copy.  Pages stay
//     in bf16 as TMA wrote them, so the block's shared memory follows the
//     page: two pages of one KV head, the block's 1/KV share of the two
//     buffered pages of all KV heads that the plan's page level prices;
//   * both products on the tensor cores with mma.sync.m16n8k16 (bf16 in,
//     f32 accumulate): the G query heads padded to 16 rows are the A
//     fragment of q.K^T (kept in registers for the whole block), K is read
//     with ldmatrix as B, and the exponentiated scores stay in registers as
//     the A fragment of P.V (V read with ldmatrix.trans).  wgmma would need
//     64 rows and a decode block has G = 4;
//   * each of the 4 warps takes 16-token slabs of the page with its own
//     online softmax (log2 domain), so no barrier sits between a page's
//     arrival and its math; the warps' states merge in shared memory at the
//     end, in warp order, and the block writes its float32 partial
//     (m, l, unnormalised acc) to a workspace the wrapper allocates;
//   * a second small kernel merges each (row, KV head)'s partials in split
//     order and writes acc / l; it reads only the live splits' partials,
//     which it finds from `lengths` on the card.  Nothing is summed with
//     atomics, so two launches on the same inputs are bit-identical.
//
// `simt` (float32, and shapes the split body does not take): one thread
// block per (row, KV head) that walks its live pages in 64-token tiles,
// widened to float32 in shared memory, on the CUDA cores (the first
// slice's kernel, kept as it was).
//
// Interface: plain C functions (no PyTorch headers), loaded with ctypes.
// They launch on the caller's stream, allocate nothing, and return
// cudaGetLastError() (0 on success), or an error of hopper::make_map_bf16
// when a TMA descriptor cannot be built.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace simt {


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
int launch_simt(const void* q, const void* k_pages, const void* v_pages,
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


}  // namespace simt

namespace split {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 2;          // the plan's PAGE_BUFFERING
constexpr int kMaxSplitPages = 16;  // table entries one block holds
constexpr int kCombineThreads = 256;
constexpr int kCombineBatch = 8;    // splits whose partials load at once

// Bytes of one KV head's slice of one page, K or V, as TMA stages it:
// T rows of 128 bytes per 64 dims (D = 128 is two such halves).
__host__ __device__ inline size_t page_bytes(int T, int D) {
  return (size_t)T * D * 2;
}

// The ring of kStages (K page, V page) stages; after the last page the
// same bytes hold the warps' softmax states for the merge.
__host__ __device__ inline size_t region_bytes(int G, int D, int T) {
  const size_t ring = (size_t)kStages * 2 * page_bytes(T, D);
  const size_t merge = (size_t)kWarps * ((size_t)G * D + 2 * (size_t)G) * 4;
  return ring > merge ? ring : merge;
}

// Shared memory of one block: 1,024 B of slack to align the swizzled ring,
// the region, one mbarrier per stage and the split's table entries.
__host__ __device__ inline size_t smem_bytes(int G, int D, int T) {
  return 1024 + region_bytes(G, D, T) + kStages * 8 + kMaxSplitPages * 4;
}

// Byte offset of (token j, dim d), d a multiple of 8, in a page slice that
// TMA wrote with 128-byte swizzle: 16-byte chunk c of row j sits at chunk
// c ^ (j % 8), so the 8 rows one ldmatrix reads hit 8 different banks.
__device__ __forceinline__ uint32_t sw_off(int j, int d, int T) {
  return (uint32_t)((d >> 6) * T * 128 + j * 128 +
                    ((((d & 63) >> 3) ^ (j & 7)) << 4));
}

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// One thread loads page i of a split (K and V of one KV head) into stage
// i % kStages; the bytes complete that stage's barrier.
template <int D>
__device__ __forceinline__ void issue_page(unsigned char* ring, uint64_t* bars,
                                           const int* s_page, int i,
                                           const CUtensorMap* tm_k,
                                           const CUtensorMap* tm_v, int kvh,
                                           int T) {
  const size_t pb = page_bytes(T, D);
  const int s = i % kStages;
  unsigned char* kd = ring + (size_t)s * 2 * pb;
  unsigned char* vd = kd + pb;
  hopper::mbar_arrive_expect_tx(&bars[s], (uint32_t)(2 * pb));
  const int tok0 = s_page[i] * T;
#pragma unroll
  for (int h = 0; h < D / 64; ++h) {
    hopper::tma_load_3d(kd + h * T * 128, tm_k, &bars[s], h * 64, kvh, tok0);
    hopper::tma_load_3d(vd + h * T * 128, tm_v, &bars[s], h * 64, kvh, tok0);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
paged_split_kernel(const __grid_constant__ CUtensorMap tm_k,  // (D, KV, P*T)
                   const __grid_constant__ CUtensorMap tm_v,
                   const __nv_bfloat16* __restrict__ q,   // (S, H, D)
                   const int* __restrict__ table,         // (S, NP)
                   const int* __restrict__ lengths,       // (S,)
                   float* __restrict__ ws_acc,  // (S, KV, splits, G, D)
                   float* __restrict__ ws_ml,   // (S, KV, splits, G, 2)
                   int H, int KV, int T, int NP, int split_pages, int window,
                   float scale_log2) {
  constexpr int kSteps = D / 16;     // k16 steps of q.K^T, n16 pairs of P.V
  const int kvh = blockIdx.x;
  const int row = blockIdx.y;
  const int split = blockIdx.z;
  const int G = H / KV;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const size_t base = ((size_t)row * KV + kvh) * gridDim.z + split;

  const int len = lengths[row];
  const int qpos = len - 1;
  const int lo = window > 0 ? max(0, qpos - window + 1) : 0;
  const int hi = min(qpos, NP * T - 1);
  const int p_first = max(split * split_pages, lo / T);
  const int p_last = min(split * split_pages + split_pages - 1,
                         hi >= 0 ? hi / T : -1);
  if (len <= 0 || hi < lo || p_first > p_last) {
    for (int i = tid; i < G; i += kThreads) {
      ws_ml[(base * G + i) * 2] = -INFINITY;
      ws_ml[(base * G + i) * 2 + 1] = 0.f;
    }
    return;
  }
  const int npages = p_last - p_first + 1;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = hopper::align_1024(smem_raw);
  const size_t pb = page_bytes(T, D);
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + region_bytes(G, D, T));
  int* s_page = reinterpret_cast<int*>(bars + kStages);

  for (int i = tid; i < npages; i += kThreads)
    s_page[i] = table[(size_t)row * NP + p_first + i];
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) hopper::mbar_init(&bars[s], 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (tid == 0)
    for (int i = 0; i < min(npages, kStages); ++i)
      issue_page<D>(ring, bars, s_page, i, &tm_k, &tm_v, kvh, T);

  // q's G heads of this KV head, padded to 16 rows, as A fragments.
  uint32_t qa[kSteps][4];
  {
    const __nv_bfloat16* qr = q + ((size_t)row * H + (size_t)kvh * G) * D;
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {
      const int c = ks * 16 + 2 * t;
      qa[ks][0] = g < G ? ld_pair(qr + g * D + c) : 0u;
      qa[ks][1] = g + 8 < G ? ld_pair(qr + (g + 8) * D + c) : 0u;
      qa[ks][2] = g < G ? ld_pair(qr + g * D + c + 8) : 0u;
      qa[ks][3] = g + 8 < G ? ld_pair(qr + (g + 8) * D + c + 8) : 0u;
    }
  }

  // This warp's online softmax for rows g and g + 8 (log2 domain).
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  const int slabs = (T + 15) / 16;
  const int mi = lane >> 3;          // the ldmatrix matrix this lane names
  for (int i = 0; i < npages; ++i) {
    const int s = i % kStages;
    hopper::mbar_wait(&bars[s], (uint32_t)((i / kStages) & 1));
    const unsigned char* kp = ring + (size_t)s * 2 * pb;
    const unsigned char* vp = kp + pb;
    const int kbase = (p_first + i) * T;   // logical position of token 0
    for (int sl = warp; sl < slabs; sl += kWarps) {
      const int j0 = sl * 16;
      const bool second = j0 + 8 < T;      // warp-uniform
      float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int ks = 0; ks < kSteps; ++ks) {
        // Matrices: tokens j0..+7 at dims lo/hi, then tokens j0+8..+15.
        // Rows past the page read its last token (finite, masked below).
        const int j = min(j0 + (lane & 7) + ((mi >> 1) << 3), T - 1);
        uint32_t kb[4];
        hopper::ldmatrix_x4(kb, kp + sw_off(j, ks * 16 + ((mi & 1) << 3), T));
        hopper::mma_bf16_16816(sc[0], qa[ks], kb[0], kb[1]);
        if (second) hopper::mma_bf16_16816(sc[1], qa[ks], kb[2], kb[3]);
      }
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = j0 + nt * 8 + 2 * t + (c & 1);
          const int kpos = kbase + j;
          const bool live = j < T && kpos >= lo && kpos <= hi;
          const float v = live ? sc[nt][c] * scale_log2 : -INFINITY;
          sc[nt][c] = v;
          mx[c >> 1] = fmaxf(mx[c >> 1], v);
        }
      float m_use[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        m_use[r] = m_new == -INFINITY ? 0.f : m_new;
        const float corr = exp2f(m[r] - m_use[r]);
        m[r] = m_new;
        l[r] *= corr;
#pragma unroll
        for (int dn = 0; dn < D / 8; ++dn) {
          acc[dn][2 * r] *= corr;
          acc[dn][2 * r + 1] *= corr;
        }
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float p = exp2f(sc[nt][c] - m_use[c >> 1]);
          sc[nt][c] = p;
          l[c >> 1] += p;
        }
      // The score fragment is P's A fragment as it stands.
      const uint32_t pa[4] = {hopper::pack_bf16(sc[0][0], sc[0][1]),
                              hopper::pack_bf16(sc[0][2], sc[0][3]),
                              hopper::pack_bf16(sc[1][0], sc[1][1]),
                              hopper::pack_bf16(sc[1][2], sc[1][3])};
#pragma unroll
      for (int dp = 0; dp < kSteps; ++dp) {
        // Matrices: tokens j0..+7 and j0+8..+15 at dims dp*16, then at +8.
        const int j = min(j0 + (lane & 7) + ((mi & 1) << 3), T - 1);
        uint32_t vb[4];
        hopper::ldmatrix_x4_trans(vb,
                                  vp + sw_off(j, dp * 16 + ((mi >> 1) << 3), T));
        hopper::mma_bf16_16816(acc[2 * dp], pa, vb[0], vb[1]);
        hopper::mma_bf16_16816(acc[2 * dp + 1], pa, vb[2], vb[3]);
      }
    }
    if (i + kStages < npages) {        // the stage is free once all warps
      __syncthreads();                 // are done with it
      if (tid == 0)
        issue_page<D>(ring, bars, s_page, i + kStages, &tm_k, &tm_v, kvh, T);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }

  // Merge the warps' states, in warp order, into the block's partial.
  __syncthreads();                     // every page consumed: reuse the ring
  float* sm_m = reinterpret_cast<float*>(ring);   // kWarps x G
  float* sm_l = sm_m + kWarps * G;                // kWarps x G
  float* sm_a = sm_l + kWarps * G;                // kWarps x G x D
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int gr = g + 8 * r;
    if (gr < G) {
      if (t == 0) {
        sm_m[warp * G + gr] = m[r];
        sm_l[warp * G + gr] = l[r];
      }
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        float* dst = sm_a + ((size_t)warp * G + gr) * D + dn * 8 + 2 * t;
        dst[0] = acc[dn][2 * r];
        dst[1] = acc[dn][2 * r + 1];
      }
    }
  }
  __syncthreads();
  for (int idx = tid; idx < G * D; idx += kThreads) {
    const int gr = idx / D;
    const int d = idx - gr * D;
    float mx = -INFINITY;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w * G + gr]);
    // The split holds a live key, so mx is finite; a warp that saw none
    // has m = -inf and weighs 0.
    float lsum = 0.f, a = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float e = exp2f(sm_m[w * G + gr] - mx);
      lsum += sm_l[w * G + gr] * e;
      a += sm_a[((size_t)w * G + gr) * D + d] * e;
    }
    ws_acc[(base * G + gr) * D + d] = a;
    if (d == 0) {
      ws_ml[(base * G + gr) * 2] = mx;
      ws_ml[(base * G + gr) * 2 + 1] = lsum;
    }
  }
}

// Merges the splits' partials of one (row, KV head), in split order.  The
// live splits are the run (lo / T) / split_pages .. (hi / T) / split_pages,
// found from lengths[row] exactly as the split kernel finds them, so only
// their partials are read; the loads of several splits are in flight at
// once (they do not depend on the running max).
__global__ void __launch_bounds__(kCombineThreads)
paged_combine_kernel(const float* __restrict__ ws_acc,
                     const float* __restrict__ ws_ml,
                     const int* __restrict__ lengths,
                     __nv_bfloat16* __restrict__ out,   // (S, H, D)
                     int H, int KV, int D, int T, int NP, int splits,
                     int split_pages, int window) {
  const int kvh = blockIdx.x;
  const int row = blockIdx.y;
  const int G = H / KV;
  const size_t base = ((size_t)row * KV + kvh) * splits;
  const int len = lengths[row];
  const int qpos = len - 1;
  const int lo = window > 0 ? max(0, qpos - window + 1) : 0;
  const int hi = min(qpos, NP * T - 1);
  const bool any = len > 0 && hi >= lo;
  const int s_lo = any ? (lo / T) / split_pages : 0;
  const int s_hi = any ? (hi / T) / split_pages : -1;
  for (int idx = threadIdx.x; idx < G * D; idx += kCombineThreads) {
    const int gr = idx / D;
    const int d = idx - gr * D;
    float mx = -INFINITY, lsum = 0.f, a = 0.f;
    for (int s0 = s_lo; s0 <= s_hi; s0 += kCombineBatch) {
      float ms[kCombineBatch], ls[kCombineBatch], as[kCombineBatch];
#pragma unroll
      for (int k = 0; k < kCombineBatch; ++k) {   // all loads first
        const bool in = s0 + k <= s_hi;
        const size_t at = (base + s0 + (in ? k : 0)) * G + gr;
        ms[k] = in ? ws_ml[at * 2] : -INFINITY;
        ls[k] = in ? ws_ml[at * 2 + 1] : 0.f;
        as[k] = in ? ws_acc[at * D + d] : 0.f;
      }
#pragma unroll
      for (int k = 0; k < kCombineBatch; ++k) {
        if (s0 + k > s_hi) break;
        const float m_new = fmaxf(mx, ms[k]);   // every split here is live
        const float keep = exp2f(mx - m_new);   // 0 on the first split
        const float e = exp2f(ms[k] - m_new);
        lsum = lsum * keep + ls[k] * e;
        a = a * keep + as[k] * e;
        mx = m_new;
      }
    }
    out[((size_t)row * H + (size_t)kvh * G + gr) * D + d] =
        __float2bfloat16(a / fmaxf(lsum, 1e-30f));
  }
}

template <int D>
int launch_split_d(const CUtensorMap& tk, const CUtensorMap& tv,
                   const void* q, const void* table, const void* lengths,
                   void* out, float* ws_acc, float* ws_ml, int S, int H,
                   int KV, int T, int NP, int window, float scale,
                   int splits, int split_pages, cudaStream_t stream) {
  const size_t smem = smem_bytes(H / KV, D, T);
  cudaError_t err = cudaFuncSetAttribute(
      paged_split_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  paged_split_kernel<D><<<dim3(KV, S, splits), kThreads, smem, stream>>>(
      tk, tv, static_cast<const __nv_bfloat16*>(q),
      static_cast<const int*>(table), static_cast<const int*>(lengths),
      ws_acc, ws_ml, H, KV, T, NP, split_pages, window,
      scale * 1.4426950408889634f);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  paged_combine_kernel<<<dim3(KV, S), kCombineThreads, 0, stream>>>(
      ws_acc, ws_ml, static_cast<const int*>(lengths),
      static_cast<__nv_bfloat16*>(out), H, KV, D, T, NP, splits, split_pages,
      window);
  return (int)cudaGetLastError();
}

int launch_split(const void* q, const void* k_pages, const void* v_pages,
                 const void* table, const void* lengths, void* out,
                 void* ws_acc, void* ws_ml, int S, int H, int KV, int D,
                 int T, int NP, int P, int window, float scale, int splits,
                 int split_pages, cudaStream_t stream) {
  // The pool (P, T, KV, D) as a 3-D tensor (D, KV, P*T): a page of one KV
  // head is the box (64, 1, T) at (64h, kvh, page*T).
  const uint64_t dims[3] = {(uint64_t)D, (uint64_t)KV, (uint64_t)P * T};
  const uint64_t strides[2] = {(uint64_t)D * 2, (uint64_t)KV * D * 2};
  const uint32_t box[3] = {64, 1, (uint32_t)T};
  CUtensorMap tk, tv;
  int rc = hopper::make_map_bf16(&tk, k_pages, 3, dims, strides, box);
  if (rc == 0) rc = hopper::make_map_bf16(&tv, v_pages, 3, dims, strides, box);
  if (rc) return rc;
  float* wa = static_cast<float*>(ws_acc);
  float* wm = static_cast<float*>(ws_ml);
  if (D == 64)
    return launch_split_d<64>(tk, tv, q, table, lengths, out, wa, wm, S, H,
                              KV, T, NP, window, scale, splits, split_pages,
                              stream);
  return launch_split_d<128>(tk, tv, q, table, lengths, out, wa, wm, S, H,
                             KV, T, NP, window, scale, splits, split_pages,
                             stream);
}

}  // namespace split

extern "C" {

// Bytes of shared memory one block of body `path` (0 = simt, 1 = split)
// needs; the simt body's does not depend on the page.  The wrapper refuses
// shapes above the 232,448 B a block may use.
size_t paged_attention_smem_bytes(int G, int D, int T, int path) {
  if (path == 1) return split::smem_bytes(G, D, T);
  return simt::smem_floats(G, D) * sizeof(float);
}

// dtype: 0 = float32, 1 = bfloat16; path: 0 = simt, 1 = split (bf16 only;
// ws_acc/ws_ml are the float32 partials, (S, KV, splits, G, D) and
// (S, KV, splits, G, 2), and P the pool's page count).  All pointers are
// device pointers on `device`; `stream` is a cudaStream_t.
int paged_attention_fwd(const void* q, const void* k_pages,
                        const void* v_pages, const void* table,
                        const void* lengths, void* out, void* ws_acc,
                        void* ws_ml, int S, int H, int KV, int D,
                        int page_tokens, int NP, int P, int window,
                        float scale, int splits, int split_pages, int dtype,
                        int path, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (path == 1)
    return split::launch_split(q, k_pages, v_pages, table, lengths, out,
                               ws_acc, ws_ml, S, H, KV, D, page_tokens, NP, P,
                               window, scale, splits, split_pages, st);
  if (dtype == 1)
    return simt::launch_simt<__nv_bfloat16>(q, k_pages, v_pages, table,
                                            lengths, out, S, H, KV, D,
                                            page_tokens, NP, window, scale,
                                            st);
  return simt::launch_simt<float>(q, k_pages, v_pages, table, lengths, out,
                                  S, H, KV, D, page_tokens, NP, window, scale,
                                  st);
}

}  // extern "C"
