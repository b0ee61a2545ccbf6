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
// Three bodies:
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
// `mla` (bf16, D 576, up to 128 query heads per KV head): DeepSeek-V2's
// absorbed MLA decode, where the "KV head" is the one 576-wide latent row
// (kv_lora 512 + rope 64) and K = V = the latent pool.  Decode (8 rows,
// ~3,200 live tokens: 3.7 MB and 0.94 GFLOP) is bytes-bound by a hair;
// a 96-row prefill chunk over ~1,000 keys (29 GFLOP) is bound by the
// tensor cores.  A G = 128 group is eight m16 tiles, so 16-head tiles go
// in the grid; a warp cannot own 576 float32 output columns of 16 heads
// (288 accumulators a thread), so the columns are split over the 4 warps
// and the tile's probabilities meet in shared memory; a 96-token page of
// the latent is 110.6 KB, so 32-token tiles are staged (cp.async, a
// two-stage ring of padded rows, once when K and V are one tensor) rather
// than whole pages.  The stream is split only where the (row, head tile)
// blocks do not fill the card (decode); a prefill chunk's 768 blocks
// write their rows directly, with no workspace.  See the kernel below.
//
// `simt` (float32, and shapes the other bodies do not take): one thread
// block per (row, KV head, run of query heads) that walks its live pages
// in 64-token tiles, widened to float32 in shared memory, on the CUDA
// cores (the first slice's kernel); where a whole group and 64-token tile
// do not fit a block (the MLA latent), 16 heads and 16-token tiles.
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
constexpr int kWideTileTokens = 16; // ... where a 64-token tile does not fit
constexpr int kWideHeads = 16;      // query heads of a block there
constexpr float kNegInf = -1e30f;   // the masked logit, as in the reference
constexpr size_t kMaxSmem = 232448; // shared memory a block may use

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Shared-memory floats one block of `gb` query heads needs with a tile of
// `tile` tokens (the layout in the kernel below).
__host__ __device__ inline size_t smem_floats(int gb, int D,
                                              int tile = kTileTokens) {
  return 2 * (size_t)gb * D                        // q, acc
         + (size_t)tile * (D + 1)                  // K tile (padded rows)
         + (size_t)tile * D                        // V tile
         + (size_t)gb * tile                       // logits / probabilities
         + 3 * (size_t)gb;                         // m, l, corr
}

// A block's query heads and token tile: the whole group and 64-token
// tiles where they fit a block's shared memory (every shape before the
// MLA latent); else 16 heads and 16-token tiles (the 576-wide latent at
// 128 heads: 148,736 B instead of 919,296 B).
__host__ __device__ inline void plan(int G, int D, int* gb, int* tile) {
  if (smem_floats(G, D) * sizeof(float) <= kMaxSmem) {
    *gb = G;
    *tile = kTileTokens;
  } else {
    *gb = G < kWideHeads ? G : kWideHeads;
    *tile = kWideTileTokens;
  }
}

__host__ __device__ inline size_t smem_bytes(int G, int D) {
  int gb, tile;
  plan(G, D, &gb, &tile);
  return smem_floats(gb, D, tile) * sizeof(float);
}

// One block per (row, KV head, run of `heads_per_block` query heads of
// its group).
template <typename T, int kTile>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q,        // (S, H, D)
                       const T* __restrict__ k_pages,  // (P, T, KV, D)
                       const T* __restrict__ v_pages,  // (P, T, KV, D)
                       const int* __restrict__ table,  // (S, NP)
                       const int* __restrict__ lengths,  // (S,)
                       T* __restrict__ out,            // (S, H, D)
                       int H, int KV, int D, int page_tokens, int NP,
                       int window, float scale, int heads_per_block) {
  constexpr int kVec = 16 / sizeof(T);         // elements per 16-byte load
  const int row = blockIdx.x;
  const int kvh = blockIdx.y;
  const int G = H / KV;
  const int g0 = blockIdx.z * heads_per_block;  // first head of the block
  const int GB = min(heads_per_block, G - g0);  // heads of this block
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  extern __shared__ float smem[];
  float* s_q = smem;                           // GB x D
  float* s_acc = s_q + GB * D;                 // GB x D
  float* s_k = s_acc + GB * D;                 // kTile x (D + 1)
  float* s_v = s_k + kTile * (D + 1);          // kTile x D
  float* s_p = s_v + kTile * D;                // GB x kTile
  float* s_m = s_p + GB * kTile;               // GB
  float* s_l = s_m + GB;                       // GB
  float* s_corr = s_l + GB;                    // GB

  // The block's heads of KV head kvh are heads kvh*G+g0 .. +GB-1: one
  // contiguous run of GB*D elements of row `row`.
  const size_t q_base = ((size_t)row * H + (size_t)kvh * G + g0) * D;
  for (int i = tid; i < GB * D; i += kThreads) {
    s_q[i] = to_f32(q[q_base + i]);
    s_acc[i] = 0.f;
  }
  for (int g = tid; g < GB; g += kThreads) {
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
      for (int t0 = 0; t0 < page_tokens; t0 += kTile) {
        const int k0 = p * page_tokens + t0;       // first key of the tile
        const int n = min(kTile, page_tokens - t0);
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

        // Logits of the block's heads against the tile's keys, masked.
        for (int i = tid; i < GB * n; i += kThreads) {
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
          s_p[g * kTile + j] = live ? dot * scale : kNegInf;
        }
        __syncthreads();

        // Online softmax: one warp per head.
        for (int g = warp; g < GB; g += kWarps) {
          float* pr = s_p + g * kTile;
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
        for (int i = tid; i < GB * D; i += kThreads) {
          const int g = i / D;
          const int d = i - g * D;
          const float* pr = s_p + g * kTile;
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

  for (int i = tid; i < GB * D; i += kThreads) {
    store_f32(&out[q_base + i], s_acc[i] / fmaxf(s_l[i / D], 1e-30f));
  }
}

template <typename T, int kTile>
int launch_tile(const void* q, const void* k_pages, const void* v_pages,
                const void* table, const void* lengths, void* out, int S,
                int H, int KV, int D, int page_tokens, int NP, int window,
                float scale, int gb, cudaStream_t stream) {
  const size_t smem = smem_floats(gb, D, kTile) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        paged_attention_kernel<T, kTile>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int G = H / KV;
  dim3 grid(S, KV, (G + gb - 1) / gb);
  paged_attention_kernel<T, kTile><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), static_cast<const int*>(table),
      static_cast<const int*>(lengths), static_cast<T*>(out), H, KV, D,
      page_tokens, NP, window, scale, gb);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_simt(const void* q, const void* k_pages, const void* v_pages,
           const void* table, const void* lengths, void* out, int S, int H,
           int KV, int D, int page_tokens, int NP, int window, float scale,
           cudaStream_t stream) {
  int gb, tile;
  plan(H / KV, D, &gb, &tile);
  if (tile == kTileTokens)
    return launch_tile<T, kTileTokens>(q, k_pages, v_pages, table, lengths,
                                       out, S, H, KV, D, page_tokens, NP,
                                       window, scale, gb, stream);
  return launch_tile<T, kWideTileTokens>(q, k_pages, v_pages, table, lengths,
                                         out, S, H, KV, D, page_tokens, NP,
                                         window, scale, gb, stream);
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

// Merges the splits' partials of one (row, KV head), in split order (a
// block merges the part of its G x D outputs that blockIdx.z names).  The
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
  // Block z of gridDim.z merges elements [z * chunk, (z + 1) * chunk) of
  // the G x D output (one z: all of it, as the split body launches it).
  const int chunk = (G * D + gridDim.z - 1) / gridDim.z;
  const int end = min(G * D, ((int)blockIdx.z + 1) * chunk);
  for (int idx = blockIdx.z * chunk + threadIdx.x; idx < end;
       idx += kCombineThreads) {
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
  paged_combine_kernel<<<dim3(KV, S, 1), kCombineThreads, 0, stream>>>(
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

namespace mla {

constexpr int kD = 576;              // the latent row: kv_lora 512 + rope 64
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kHeads = 16;           // query heads of a block: one m16 tile
constexpr int kTile = 32;            // tokens staged at a time: 8 a warp
constexpr int kStages = 2;
constexpr int kRow = kD + 8;         // staged row, padded to 1,168 B so the
                                     // 8 rows one ldmatrix reads hit 8 banks
constexpr int kChunks = kD / 8;      // 16-byte chunks of a row
constexpr int kCols = kD / kWarps;   // output columns a warp owns: 144
constexpr int kColTiles = kCols / 8;  // its n8 accumulator tiles: 18
constexpr int kScoreLd = kTile + 8;  // floats of a staged score row

// Shared memory of one block: the q tile, the ring of token tiles (one
// ring when K and V are one tensor, as the MLA latent pool is; two
// otherwise) and the tile's scores.
__host__ __device__ inline size_t smem_bytes(bool shared_kv) {
  return (size_t)kHeads * kRow * 2
         + (shared_kv ? 1 : 2) * (size_t)kStages * kTile * kRow * 2
         + (size_t)kHeads * kScoreLd * 4;
}

// One block per (KV head x 16-head tile of its group, row, split).  The
// block walks the split's live tokens in 32-token tiles, copied with
// cp.async into a two-stage ring of padded rows (each token's address
// from the row's table: a tile may cross pages).  Per tile: q.K^T on the
// tensor cores, each warp 8 tokens against all 16 heads over the 576-wide
// depth; the masked scores meet in shared memory; every warp runs the
// same online softmax over the tile (so all hold the same max, sum and
// correction) and keeps P as its A fragment; P.V on the tensor cores, each
// warp 144 of the 576 output columns.  With one split the block writes its
// normalised rows; with more, its float32 partial (m, l, unnormalised acc)
// in the split body's workspace layout, merged by paged_combine_kernel.
__global__ void __launch_bounds__(kThreads)
paged_mla_kernel(const __nv_bfloat16* __restrict__ q,        // (S, H, D)
                 const __nv_bfloat16* __restrict__ k_pages,  // (P, T, KV, D)
                 const __nv_bfloat16* __restrict__ v_pages,  // (P, T, KV, D)
                 const int* __restrict__ table,              // (S, NP)
                 const int* __restrict__ lengths,            // (S,)
                 __nv_bfloat16* __restrict__ out,            // (S, H, D)
                 float* __restrict__ ws_acc,  // (S, KV, splits, G, D)
                 float* __restrict__ ws_ml,   // (S, KV, splits, G, 2)
                 int H, int KV, int T, int NP, int split_pages, int window,
                 float scale_log2) {
  const int G = H / KV;
  const int tiles = (G + kHeads - 1) / kHeads;
  const int kvh = blockIdx.x / tiles;
  const int h0 = (blockIdx.x - kvh * tiles) * kHeads;  // in the group
  const int nh = min(kHeads, G - h0);                  // heads of the block
  const int row = blockIdx.y;
  const int split = blockIdx.z;
  const int splits = gridDim.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const bool shared_kv = k_pages == v_pages;
  const size_t base = ((size_t)row * KV + kvh) * splits + split;
  const size_t head0 = (size_t)row * H + (size_t)kvh * G + h0;

  const int len = lengths[row];
  const int qpos = len - 1;
  const int lo = window > 0 ? max(0, qpos - window + 1) : 0;
  const int hi = min(qpos, NP * T - 1);
  const int span = split_pages * T;
  const int k_first = max(lo, split * span);
  const int k_last = min(hi, split * span + span - 1);
  if (len <= 0 || k_first > k_last) {
    if (splits > 1) {                  // an empty partial (never merged)
      for (int i = tid; i < nh; i += kThreads) {
        ws_ml[(base * G + h0 + i) * 2] = -INFINITY;
        ws_ml[(base * G + h0 + i) * 2 + 1] = 0.f;
      }
    } else {                           // a row without keys is zeros
      for (int i = tid; i < nh * kD; i += kThreads)
        out[head0 * kD + i] = __float2bfloat16(0.f);
    }
    return;
  }
  const int n_tiles = (k_last - k_first) / kTile + 1;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* s_q = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* s_k = s_q + kHeads * kRow;
  __nv_bfloat16* s_v = shared_kv ? s_k : s_k + kStages * kTile * kRow;
  float* s_sc = reinterpret_cast<float*>(
      s_k + (shared_kv ? 1 : 2) * kStages * kTile * kRow);

  // The q tile: the block's heads, zero rows past the group.
  for (int i = tid; i < kHeads * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = i - r * kChunks;
    __nv_bfloat16* d = s_q + r * kRow + c * 8;
    if (r < nh)
      hopper::cp_async_16(d, q + (head0 + r) * kD + c * 8);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
  }

  // Token tile i into stage i % kStages: four threads a token, each every
  // fourth 16-byte chunk of its row.  Tokens past the split's last live
  // key copy that key (finite; masked below).
  const size_t tok_stride = (size_t)KV * kD;
  auto stage_tile = [&](int i) {
    const int st = i % kStages;
    const int j = tid >> 2;
    const int kp = min(k_first + i * kTile + j, k_last);
    const int page = table[(size_t)row * NP + kp / T];
    const size_t src = ((size_t)page * T + kp % T) * tok_stride +
                       (size_t)kvh * kD;
    __nv_bfloat16* dk = s_k + (st * kTile + j) * kRow;
    __nv_bfloat16* dv = s_v + (st * kTile + j) * kRow;
    for (int c = tid & 3; c < kChunks; c += 4) {
      hopper::cp_async_16(dk + c * 8, k_pages + src + c * 8);
      if (!shared_kv) hopper::cp_async_16(dv + c * 8, v_pages + src + c * 8);
    }
  };
  stage_tile(0);
  hopper::cp_async_commit();           // group 0: q and tile 0
  if (n_tiles > 1) stage_tile(1);
  hopper::cp_async_commit();           // group 1: tile 1 (or nothing)

  // Rows g and g + 8 of the tile: online softmax (log2 domain) and this
  // warp's 144 output columns.
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float acc[kColTiles][4];
#pragma unroll
  for (int i = 0; i < kColTiles; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  const int mi = lane >> 3;            // the ldmatrix matrix this lane names
  const int n0 = warp * 8;             // this warp's tokens in q.K^T
  const int c_base = warp * kCols;     // ... and its columns in P.V

  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % kStages;
    hopper::cp_async_wait<1>();        // groups 0..i are in
    __syncthreads();
    const __nv_bfloat16* kt = s_k + st * kTile * kRow;
    const __nv_bfloat16* vt = s_v + st * kTile * kRow;
    const int k0 = k_first + i * kTile;

    // Scores of the 16 heads against tokens n0..n0+7, two k16 steps a
    // K load: matrices mi = dims kk + 8 mi of the 8 tokens.
    float sc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 6
    for (int kk = 0; kk < kD; kk += 32) {
      uint32_t kb[4], qa[4];
      hopper::ldmatrix_x4(kb, kt + (n0 + (lane & 7)) * kRow + kk + mi * 8);
      const __nv_bfloat16* qr =
          s_q + ((lane & 7) + ((mi & 1) << 3)) * kRow + kk + ((mi >> 1) << 3);
      hopper::ldmatrix_x4(qa, qr);
      hopper::mma_bf16_16816(sc, qa, kb[0], kb[1]);
      hopper::ldmatrix_x4(qa, qr + 16);
      hopper::mma_bf16_16816(sc, qa, kb[2], kb[3]);
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = n0 + 2 * t + (c & 1);
      s_sc[(g + 8 * (c >> 1)) * kScoreLd + j] =
          k0 + j <= k_last ? sc[c] * scale_log2 : -INFINITY;
    }
    __syncthreads();

    // Every warp: rows g, g + 8 at tokens 2t + {0, 1, 8, 9, 16, 17, 24,
    // 25} -- the A fragments of P for the tile's two k16 steps.
    float p[2][8];
    uint32_t pa[2][4];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        p[r][e] = s_sc[(g + 8 * r) * kScoreLd + 2 * t + (e & 1) +
                       8 * (e >> 1)];
        mx = fmaxf(mx, p[r][e]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float corr = exp2f(m[r] - m_use);
      m[r] = m_new;
      l[r] *= corr;
#pragma unroll
      for (int n = 0; n < kColTiles; ++n) {
        acc[n][2 * r] *= corr;
        acc[n][2 * r + 1] *= corr;
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        p[r][e] = exp2f(p[r][e] - m_use);
        l[r] += p[r][e];
      }
    }
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      pa[ks][0] = hopper::pack_bf16(p[0][4 * ks], p[0][4 * ks + 1]);
      pa[ks][1] = hopper::pack_bf16(p[1][4 * ks], p[1][4 * ks + 1]);
      pa[ks][2] = hopper::pack_bf16(p[0][4 * ks + 2], p[0][4 * ks + 3]);
      pa[ks][3] = hopper::pack_bf16(p[1][4 * ks + 2], p[1][4 * ks + 3]);
    }

    // P.V over this warp's columns: matrices are tokens 16ks..+7 and
    // +8..+15 at columns c0, then at c0 + 8.
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      const int j = 16 * ks + (lane & 7) + ((mi & 1) << 3);
#pragma unroll
      for (int np = 0; np < kColTiles / 2; ++np) {
        uint32_t vb[4];
        hopper::ldmatrix_x4_trans(
            vb, vt + j * kRow + c_base + np * 16 + ((mi >> 1) << 3));
        hopper::mma_bf16_16816(acc[2 * np], pa[ks], vb[0], vb[1]);
        hopper::mma_bf16_16816(acc[2 * np + 1], pa[ks], vb[2], vb[3]);
      }
    }
    __syncthreads();                   // the stage and the scores are free
    if (i + kStages < n_tiles) stage_tile(i + kStages);
    hopper::cp_async_commit();
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int hr = g + 8 * r;
    if (hr >= nh) continue;
    if (splits == 1) {
      const float inv = 1.f / fmaxf(l[r], 1e-30f);
      __nv_bfloat16* o = out + (head0 + hr) * kD + c_base + 2 * t;
#pragma unroll
      for (int n = 0; n < kColTiles; ++n)
        *reinterpret_cast<uint32_t*>(o + n * 8) = hopper::pack_bf16(
            acc[n][2 * r] * inv, acc[n][2 * r + 1] * inv);
    } else {
      const size_t at = base * G + h0 + hr;
      float* a = ws_acc + at * kD + c_base + 2 * t;
#pragma unroll
      for (int n = 0; n < kColTiles; ++n)
        *reinterpret_cast<float2*>(a + n * 8) =
            make_float2(acc[n][2 * r], acc[n][2 * r + 1]);
      if (warp == 0 && t == 0) {
        ws_ml[at * 2] = m[r];
        ws_ml[at * 2 + 1] = l[r];
      }
    }
  }
}

int launch_mla(const void* q, const void* k_pages, const void* v_pages,
               const void* table, const void* lengths, void* out,
               void* ws_acc, void* ws_ml, int S, int H, int KV, int T,
               int NP, int window, float scale, int splits, int split_pages,
               cudaStream_t stream) {
  const size_t smem = smem_bytes(k_pages == v_pages);
  cudaError_t err = cudaFuncSetAttribute(
      paged_mla_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int G = H / KV;
  const int tiles = (G + kHeads - 1) / kHeads;
  float* wa = static_cast<float*>(ws_acc);
  float* wm = static_cast<float*>(ws_ml);
  paged_mla_kernel<<<dim3(KV * tiles, S, splits), kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k_pages),
      static_cast<const __nv_bfloat16*>(v_pages),
      static_cast<const int*>(table), static_cast<const int*>(lengths),
      static_cast<__nv_bfloat16*>(out), wa, wm, H, KV, T, NP, split_pages,
      window, scale * 1.4426950408889634f);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  // One merge block per (KV head, row, query head).
  split::paged_combine_kernel<<<dim3(KV, S, G), split::kCombineThreads, 0,
                                stream>>>(
      wa, wm, static_cast<const int*>(lengths),
      static_cast<__nv_bfloat16*>(out), H, KV, kD, T, NP, splits,
      split_pages, window);
  return (int)cudaGetLastError();
}

}  // namespace mla

extern "C" {

// Bytes of shared memory one block of body `path` (0 = simt, 1 = split,
// 2 = mla) needs; the simt and mla bodies' do not depend on the page, and
// the mla body's depends on whether K and V are one tensor (`shared_kv`).
// The wrapper refuses shapes above the 232,448 B a block may use.
size_t paged_attention_smem_bytes(int G, int D, int T, int path,
                                  int shared_kv) {
  if (path == 1) return split::smem_bytes(G, D, T);
  if (path == 2) return mla::smem_bytes(shared_kv != 0);
  return simt::smem_bytes(G, D);
}

// dtype: 0 = float32, 1 = bfloat16; path: 0 = simt, 1 = split, 2 = mla
// (both bf16 only; ws_acc/ws_ml are the float32 partials, (S, KV, splits,
// G, D) and (S, KV, splits, G, 2), unused by mla at one split, and P the
// pool's page count).  All pointers are device pointers on `device`;
// `stream` is a cudaStream_t.
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
  if (path == 2)
    return mla::launch_mla(q, k_pages, v_pages, table, lengths, out, ws_acc,
                           ws_ml, S, H, KV, page_tokens, NP, window, scale,
                           splits, split_pages, st);
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
