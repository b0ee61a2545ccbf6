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
// tensor cores.  So the body is built for wgmma: a block is one 64-head
// tile (G <= 64 padded to it), a producer warpgroup streams the latent by
// TMA into a ring of token tiles (48 tokens at 96-token pages), one
// consumer warpgroup computes the tile's scores (m64 x tile x 576) and
// softmax once, and the two consumers split the 576 output columns (a
// 64 x 576 float32 accumulator is 288 registers a thread: too many for
// one).  At G = 128 the two head tiles of a (row, split) are a cluster
// that TMA multicast feeds, so each latent tile leaves L2 once per
// (row, split); at decode the splits of a row are one cluster too, and
// merge through distributed shared memory, with no workspace and no second
// launch.  See the kernel below.
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

namespace mla {

constexpr int kD = 576;            // the latent row: kv_lora 512 + rope 64
constexpr int kAtoms = kD / 64;    // 128-byte swizzle atoms of a row: 9
constexpr int kHeads = 64;         // query heads of a block: one wgmma m64 tile
constexpr int kThreads = 384;      // a producer and two consumer warpgroups
constexpr int kLoAtoms = 4;        // output atoms of consumer 0 (columns
                                   // 0..255); consumer 1 has 256..575
constexpr int kQBytes = kHeads * kD * 2;   // 73,728
constexpr int kPBytes = kHeads * 128;      // P: 64 rows x 64 tokens, bf16
constexpr int kTailBytes = 1024;   // mbarriers, corrections, (m, l) rows
constexpr int kFixedBytes = 1024 + kQBytes + kPBytes + kTailBytes;
constexpr int kMaxStages = 8;
constexpr int kMergeLd = kD + 8;   // floats of a row of the merge buffer
constexpr int kOutLd = kD + 8;     // bf16 of a row of the staged output
// (both padded so that the 8 rows of a fragment store hit distinct banks)
constexpr int kMaxCluster = 16;    // blocks of a cluster (8 is portable)
constexpr int kMaxSmem = 232448;   // shared memory a block may use

// The token tile for pages of T tokens: of 64, 48, 32 and 16 (32 and 16
// when K and V are two tensors: two rings of larger tiles do not fit), the
// one that pads a page least, the larger on a tie.  A tile never crosses a
// page: a page is walked in tiles, the last one cut at the page's end
// (96-token pages: two tiles of 48).
__host__ __device__ inline int tile_tokens(int T, bool shared_kv) {
  int best = 16, best_pad = 1 << 30;
  for (int bt = shared_kv ? 64 : 32; bt >= 16; bt -= 16) {
    const int pad = (T + bt - 1) / bt * bt;
    if (pad < best_pad) {
      best = bt;
      best_pad = pad;
    }
  }
  return best;
}

// Bytes of one ring stage: a tile's 9 atoms of K, then of V when V is a
// tensor of its own.
__host__ __device__ inline int stage_bytes(int bt, bool shared_kv) {
  return kAtoms * bt * 128 * (shared_kv ? 1 : 2);
}

// As many stages as fit beside Q, P and the tail, at most kMaxStages: 2 at
// 64 and 48 tokens, 4 at 32, 8 at 16 (K != V: 2 at 32, 4 at 16).  Q and the
// ring together always hold the float32 merge buffer (64 x kMergeLd).
__host__ __device__ inline int num_stages(int bt, bool shared_kv) {
  const int n = (kMaxSmem - kFixedBytes) / stage_bytes(bt, shared_kv);
  return n < kMaxStages ? n : kMaxStages;
}

__host__ __device__ inline size_t smem_bytes(int T, bool shared_kv) {
  const int bt = tile_tokens(T, shared_kv);
  return (size_t)kFixedBytes +
         (size_t)num_stages(bt, shared_kv) * stage_bytes(bt, shared_kv);
}

// Output rows r0 and r0 + 8 of an m64nN accumulator slice at columns
// cb..cb+N-1, into shared memory over Q and the ring: normalised bf16 rows
// (one split; copied out whole afterwards), or the block's unnormalised
// float32 partial (several).  Register i of a thread holds row
// r0 + 8 * ((i >> 1) & 1), column cb + 8 * (i >> 2) + cg + (i & 1).
template <int N>
__device__ __forceinline__ void finish(const float (&d)[N / 2], int cb,
                                       int r0, int cg, bool merge,
                                       const float* s_l, float* s_merge,
                                       __nv_bfloat16* s_out) {
  if (merge) {
#pragma unroll
    for (int g = 0; g < N / 8; ++g)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(
            &s_merge[(r0 + 8 * h) * kMergeLd + cb + 8 * g + cg]) =
            make_float2(d[4 * g + 2 * h], d[4 * g + 2 * h + 1]);
    return;
  }
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) inv[h] = 1.f / fmaxf(s_l[r0 + 8 * h], 1e-30f);
#pragma unroll
  for (int g = 0; g < N / 8; ++g)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<uint32_t*>(
          &s_out[(r0 + 8 * h) * kOutLd + cb + 8 * g + cg]) =
          hopper::pack_bf16(d[4 * g + 2 * h] * inv[h],
                            d[4 * g + 2 * h + 1] * inv[h]);
}

// One block per (KV head x 64-head tile of its group, split, row); the
// cluster is the row's (head tiles x splits).  Warpgroup 0 is the
// producer (one warp of it works; it gives registers up so that the
// consumers get 232 a thread): one thread loads the Q tile by TMA before
// the cluster barrier, then streams the split's latent tiles (box (64, 1,
// BT, 1) of the pool viewed as (D, KV, T, P), 128-byte swizzle) into a
// ring of `stages` stages, the page of each tile read from the table by
// the producer warp 32 tiles at a time.  With two
// head tiles each block loads half of every tile's atoms, multicast into
// both, so a tile leaves L2 once per (row, split); a stage is refilled
// only once the 8 consumer warps of both blocks have released it.
// Consumer 0 (warpgroup 1): S = Q K^T by wgmma m64nBTk16 over the
// 576-deep row (Q and K both K-major in shared memory), masked and scaled
// into the log2 domain, the online softmax; P goes to shared memory (bf16,
// 128-byte swizzled) with each row's correction, and to its own
// O[:, 0:256] += P V by wgmma with P in registers.  Consumer 1 (warpgroup
// 2) rescales its O[:, 256:576] by the corrections and adds P V with P
// read from shared memory: the scores are computed once a tile.  With one
// split the block stages its normalised bf16 rows in shared memory and
// copies them out as one contiguous run; with several, each block leaves
// its float32 partial in its own shared memory, and after a cluster
// barrier block z of a head tile merges rows z, z + splits, ... of all the
// splits' partials, read through distributed shared memory in split order:
// no workspace, no second launch, no atomics.
//
// Measured on the card, neither of two other schedules was faster: the
// two consumers taking the tiles' scores in turn, and consumer 0 issuing
// the next tile's scores before this tile's P V (both slower: with two
// stages a stage is refilled only once consumer 1's P V is done, and more
// stages of smaller tiles cost more per token than they hide).
template <int BT>
__global__ void __launch_bounds__(kThreads, 1)
paged_mla_kernel(const __grid_constant__ CUtensorMap tm_q,  // (D, H, S)
                 const __grid_constant__ CUtensorMap tm_k,  // (D, KV, T, P)
                 const __grid_constant__ CUtensorMap tm_v,
                 const int* __restrict__ table,             // (S, NP)
                 const int* __restrict__ lengths,           // (S,)
                 __nv_bfloat16* __restrict__ out,           // (S, H, D)
                 int H, int KV, int T, int NP, int window, float scale_log2,
                 int shared_kv, int stages, int q_rows, int box_t) {
  constexpr int kSteps = kD / 16;          // k16 steps of q.K^T: 36
  constexpr int kPSteps = BT / 16;         // k16 steps of P.V
  constexpr int kAtomBytes = BT * 128;     // one 64-column atom of a tile
  const int G = H / KV;
  const int mc = (G + kHeads - 1) / kHeads;  // head tiles: the cluster's x
  const int kvh = blockIdx.x / mc;
  const int ht = blockIdx.x - kvh * mc;
  const int h0 = ht * kHeads;
  const int nh = min(kHeads, G - h0);        // the block's live heads
  const int split = blockIdx.y;
  const int splits = gridDim.y;              // the cluster's y
  const int row = blockIdx.z;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int lane = tid & 31;
  const bool kv_one = shared_kv != 0;
  const uint32_t rank0 = (uint32_t)(mc * split);  // this split's first rank

  // The split's tiles.  The row's live keys [lo, hi] are walked page by
  // page in tiles of BT tokens, tpp a page: tile j holds the tokens from
  // (j / tpp) * T + (j % tpp) * BT to the tile's or the page's end.  Split
  // z takes the z-th of `splits` equal runs of the row's live tiles (the
  // last shorter): the runs come from lengths on the card, so the host
  // never reads lengths, and every split of a long row has work.
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* s_q = hopper::align_1024(smem_raw);
  unsigned char* ring = s_q + kQBytes;
  const int sb = stage_bytes(BT, kv_one);
  unsigned char* s_p = ring + stages * sb;
  unsigned char* tail = s_p + kPBytes;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(tail);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kMaxStages;
  float* s_corr = reinterpret_cast<float*>(tail + 256);   // 64 rows
  float* s_m = reinterpret_cast<float*>(tail + 512);      // 64 rows
  float* s_l = reinterpret_cast<float*>(tail + 768);      // 64 rows
  // After the last tile, over Q and the ring: the block's float32 partial
  // (several splits) or its bf16 rows (one); over P, the merge's weights.
  float* s_merge = reinterpret_cast<float*>(s_q);         // 64 x kMergeLd
  __nv_bfloat16* s_out = reinterpret_cast<__nv_bfloat16*>(s_q);  // 64 x kOutLd
  float* s_w = reinterpret_cast<float*>(s_p);             // 64 x kMaxCluster
  float* s_inv = s_w + kHeads * kMaxCluster;              // 64 rows

  if (tid == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < stages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 8 * mc);   // 8 consumer warps a block
    }
    hopper::fence_barrier_init();
    // Q involves no other block: its load starts before the cluster
    // barrier and the reads of lengths and the table.
    hopper::mbar_arrive_expect_tx(q_full, (uint32_t)(kAtoms * q_rows * 128));
    for (int a = 0; a < kAtoms; ++a)
      hopper::tma_load_3d(s_q + a * kHeads * 128, &tm_q, q_full, a * 64,
                          kvh * G + h0, row);
  }

  const int len = lengths[row];
  const int qpos = len - 1;
  const int lo = window > 0 ? max(0, qpos - window + 1) : 0;
  const int hi = min(qpos, NP * T - 1);
  const int tpp = (T + BT - 1) / BT;
  int j0 = 0, n_tiles = 0;
  if (len > 0 && hi >= lo) {
    const int jf = (lo / T) * tpp + (lo % T) / BT;
    const int jl = (hi / T) * tpp + (hi % T) / BT;
    const int per = (jl - jf + splits) / splits;
    j0 = jf + split * per;
    n_tiles = max(0, min(jl, j0 + per - 1) - j0 + 1);
  }

  const int* trow = table + (size_t)row * NP;
  // The producer warp's first 32 tiles' pages, read before the barrier.
  int page_l = 0;
  if (tid < 32 && lane < n_tiles) page_l = trow[(j0 + lane) / tpp];

  if (box_t < BT) {
    // Pages shorter than the tile: the rows past the page are never
    // written by TMA, and a masked key's V row still meets P = 0.
    for (int i = tid; i < stages * sb / 16; i += kThreads)
      reinterpret_cast<uint4*>(ring)[i] = make_uint4(0u, 0u, 0u, 0u);
    hopper::fence_proxy_async();
  }
  hopper::cluster_sync();     // barriers and zeros in place, cluster-wide

  if (wg == 0) {
    hopper::setmaxnreg_dec<40>();
    if (tid < 32 && n_tiles > 0) {
      const uint16_t mask = (uint16_t)(((1u << mc) - 1u) << rank0);
      const uint32_t tx =
          (uint32_t)(kAtoms * box_t * 128 * (kv_one ? 1 : 2));
      for (int i0 = 0; i0 < n_tiles; i0 += 32) {
        const int mine = i0 + lane;
        if (i0 > 0) page_l = mine < n_tiles ? trow[(j0 + mine) / tpp] : 0;
        const int nb = min(32, n_tiles - i0);
        for (int k = 0; k < nb; ++k) {
          const int i = i0 + k;
          const int page = __shfl_sync(0xffffffffu, page_l, k);
          const int s = i % stages;
          if (i >= stages)
            hopper::mbar_wait(&empty[s], (uint32_t)(((i / stages) - 1) & 1));
          if (lane == 0) {
            unsigned char* kd = ring + s * sb;
            unsigned char* vd = kd + kAtoms * kAtomBytes;
            const int t0 = ((j0 + i) % tpp) * BT;
            hopper::mbar_arrive_expect_tx(&full[s], tx);
            for (int a = ht; a < kAtoms; a += mc) {
              if (mc == 1) {
                hopper::tma_load_4d(kd + a * kAtomBytes, &tm_k, &full[s],
                                    a * 64, kvh, t0, page);
                if (!kv_one)
                  hopper::tma_load_4d(vd + a * kAtomBytes, &tm_v, &full[s],
                                      a * 64, kvh, t0, page);
              } else {
                hopper::tma_load_4d_multicast(kd + a * kAtomBytes, &tm_k,
                                              &full[s], a * 64, kvh, t0,
                                              page, mask);
                if (!kv_one)
                  hopper::tma_load_4d_multicast(vd + a * kAtomBytes, &tm_v,
                                                &full[s], a * 64, kvh, t0,
                                                page, mask);
              }
            }
          }
          __syncwarp();
        }
      }
    }
    hopper::cluster_sync();   // the consumers' partials are in place
    if (splits > 1) hopper::cluster_sync();   // ... and merged
    return;
  }

  hopper::setmaxnreg_inc<232>();
  const int r0 = 16 * ((tid >> 5) & 3) + (lane >> 2);  // rows r0, r0 + 8
  const int cg = 2 * (lane & 3);           // columns cg, cg + 1 of each 8
  const bool merge = splits > 1;
  __nv_bfloat16* out_rows =
      out + ((size_t)row * H + (size_t)kvh * G + h0) * kD;

  if (wg == 1) {
    float o[128];                           // O[:, 0:256]
#pragma unroll
    for (int e = 0; e < 128; ++e) o[e] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.f, 0.f};               // this thread's share of l
    hopper::mbar_wait(q_full, 0);          // (in flight even without tiles)
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % stages;
      hopper::mbar_wait(&full[s], (uint32_t)((i / stages) & 1));
      const unsigned char* kt = ring + s * sb;
      const unsigned char* vt = kv_one ? kt : kt + kAtoms * kAtomBytes;

      // S = Q K^T over the 576-deep row.
      float sc[BT / 2];
#pragma unroll
      for (int e = 0; e < BT / 2; ++e) sc[e] = 0.f;
      hopper::fence_regs(sc);
      __syncwarp();                        // wgmma wants the warp converged
      hopper::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kSteps; ++ks) {
        const int a = ks >> 2, kk = (ks & 3) * 32;
        hopper::wgmma_ss<BT, 0>(
            sc, hopper::desc_sw128(s_q + a * kHeads * 128 + kk, 16, 1024),
            hopper::desc_sw128(kt + a * kAtomBytes + kk, 16, 1024), 1);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(sc);

      // Mask to the row's live keys and the tile's page, scale into the
      // log2 domain, and the online softmax (the row's 4 threads by
      // shuffles).  Every tile holds a live key, so m is finite after it.
      const int jt = j0 + i;
      const int sub = jt % tpp;
      const int kb = (jt / tpp) * T + sub * BT;  // logical key of token 0
      const int n = min(BT, T - sub * BT);
      float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int e = 0; e < BT / 2; ++e) {
        const int col = 8 * (e >> 2) + cg + (e & 1);
        const int kp = kb + col;
        const float x = col < n && kp >= lo && kp <= hi ? sc[e] * scale_log2
                                                        : -INFINITY;
        sc[e] = x;
        mt[(e >> 1) & 1] = fmaxf(mt[(e >> 1) & 1], x);
      }
      float corr[2], m_use[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mt[h] = fmaxf(mt[h], __shfl_xor_sync(0xffffffffu, mt[h], 1));
        mt[h] = fmaxf(mt[h], __shfl_xor_sync(0xffffffffu, mt[h], 2));
        const float m_new = fmaxf(m[h], mt[h]);
        m_use[h] = m_new == -INFINITY ? 0.f : m_new;
        corr[h] = exp2f(m[h] - m_use[h]);
        m[h] = m_new;
        l[h] *= corr[h];
      }
#pragma unroll
      for (int e = 0; e < BT / 2; ++e) {
        const int h = (e >> 1) & 1;
        sc[e] = exp2f(sc[e] - m_use[h]);
        l[h] += sc[e];
      }
      // P as bf16 A fragments: k step j takes score registers 8j .. 8j+7.
      uint32_t pa[kPSteps][4];
#pragma unroll
      for (int j = 0; j < kPSteps; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pa[j][r] = hopper::pack_bf16(sc[8 * j + 2 * r], sc[8 * j + 2 * r + 1]);

      // P and the corrections to consumer 1, once it is done with the
      // last tile's.  pa[j][r] is row r0 + 8 (r & 1), columns 16 j +
      // 8 (r >> 1) + cg, +1; stored as TMA would store it (128-byte rows,
      // 16-byte chunk c of row y at c ^ (y % 8)).
      if (i > 0) hopper::bar_sync(2, 256);
#pragma unroll
      for (int j = 0; j < kPSteps; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int y = r0 + 8 * (r & 1);
          const int c = 16 * j + 8 * (r >> 1) + cg;
          *reinterpret_cast<uint32_t*>(
              s_p + y * 128 + (((c >> 3) ^ (y & 7)) << 4) + ((c & 7) << 1)) =
              pa[j][r];
        }
      if ((lane & 3) == 0) {
        s_corr[r0] = corr[0];
        s_corr[r0 + 8] = corr[1];
      }
      hopper::fence_proxy_async();
      hopper::bar_arrive(1, 256);

      // O[:, 0:256] = O * corr + P V, V read MN-major (transpose bit).
#pragma unroll
      for (int e = 0; e < 128; ++e) o[e] *= corr[(e >> 1) & 1];
      hopper::fence_regs(o);
      __syncwarp();
      hopper::wgmma_fence();
#pragma unroll
      for (int j = 0; j < kPSteps; ++j)
        hopper::wgmma_rs<256, 1>(
            o, pa[j], hopper::desc_sw128(vt + j * 2048, kAtomBytes, 1024), 1);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(o);
      __syncwarp();
      if (lane == 0)
        for (int c = 0; c < mc; ++c)
          hopper::mbar_arrive_cluster(&empty[s], rank0 + c);
    }
    if (n_tiles > 0) hopper::bar_sync(2, 256);   // consumer 1's last release
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    }
    if ((lane & 3) == 0) {
      s_m[r0] = m[0];
      s_m[r0 + 8] = m[1];
      s_l[r0] = l[0];
      s_l[r0 + 8] = l[1];
    }
    hopper::bar_sync(3, 256);    // (m, l) written; Q and the ring free
    hopper::fence_proxy_async();
    finish<256>(o, 0, r0, cg, merge, s_l, s_merge, s_out);
  } else {
    float oa[128];                          // O[:, 256:512]
    float ob[32];                           // O[:, 512:576]
#pragma unroll
    for (int e = 0; e < 128; ++e) oa[e] = 0.f;
#pragma unroll
    for (int e = 0; e < 32; ++e) ob[e] = 0.f;
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % stages;
      hopper::mbar_wait(&full[s], (uint32_t)((i / stages) & 1));
      const unsigned char* vt =
          ring + s * sb + (kv_one ? 0 : kAtoms * kAtomBytes);
      hopper::bar_sync(1, 256);            // P and corrections of tile i
      const float c0 = s_corr[r0], c1 = s_corr[r0 + 8];
#pragma unroll
      for (int e = 0; e < 128; ++e) oa[e] *= (e >> 1) & 1 ? c1 : c0;
#pragma unroll
      for (int e = 0; e < 32; ++e) ob[e] *= (e >> 1) & 1 ? c1 : c0;
      hopper::fence_regs(oa);
      hopper::fence_regs(ob);
      __syncwarp();
      hopper::wgmma_fence();
#pragma unroll
      for (int j = 0; j < kPSteps; ++j) {
        const uint64_t dp = hopper::desc_sw128(s_p + j * 32, 16, 1024);
        hopper::wgmma_ss<256, 1>(
            oa, dp,
            hopper::desc_sw128(vt + kLoAtoms * kAtomBytes + j * 2048,
                               kAtomBytes, 1024),
            1);
        hopper::wgmma_ss<64, 1>(
            ob, dp,
            hopper::desc_sw128(vt + (kAtoms - 1) * kAtomBytes + j * 2048,
                               kAtomBytes, 1024),
            1);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(oa);
      hopper::fence_regs(ob);
      hopper::bar_arrive(2, 256);          // P is free
      __syncwarp();
      if (lane == 0)
        for (int c = 0; c < mc; ++c)
          hopper::mbar_arrive_cluster(&empty[s], rank0 + c);
    }
    hopper::bar_sync(3, 256);
    hopper::fence_proxy_async();
    finish<256>(oa, 256, r0, cg, merge, s_l, s_merge, s_out);
    finish<64>(ob, 512, r0, cg, merge, s_l, s_merge, s_out);
  }
  const int ctid = tid - 128;
  constexpr int kChunks = kD * 2 / 16;     // 16-byte chunks of a row: 72
  if (!merge) {
    // The block's rows are one contiguous run of the output: copied whole,
    // 16 bytes a thread.
    hopper::bar_sync(3, 256);
    for (int i = ctid; i < nh * kChunks; i += 256) {
      const int r = i / kChunks;
      const int c = i - r * kChunks;
      reinterpret_cast<uint4*>(out_rows + (size_t)r * kD)[c] =
          reinterpret_cast<const uint4*>(s_out + r * kOutLd)[c];
    }
  }

  hopper::cluster_sync();   // every split's partial, m and l in place
  if (!merge) return;

  // Rows split, split + splits, ... of this head tile: the weight of each
  // split's partial, exp2(m_z - M) (0 for a split without keys), and
  // 1 / L, L = sum_z l_z w_z, in split order; then the rows, four columns
  // an item, summed over the splits in split order.  Every split's loads
  // of an item, and of two items a thread, are in flight together.
  const int rows = split < nh ? (nh - split + splits - 1) / splits : 0;
  for (int k = ctid; k < rows; k += 256) {
    const int r = split + k * splits;
    float mz[kMaxCluster], lz[kMaxCluster];
#pragma unroll
    for (int z = 0; z < kMaxCluster; ++z) {
      const uint32_t rk = (uint32_t)(ht + mc * z);
      mz[z] = z < splits ? hopper::dsmem_ld(hopper::dsmem_addr(s_m + r, rk))
                         : -INFINITY;
      lz[z] = z < splits ? hopper::dsmem_ld(hopper::dsmem_addr(s_l + r, rk))
                         : 0.f;
    }
    float M = -INFINITY;
#pragma unroll
    for (int z = 0; z < kMaxCluster; ++z) M = fmaxf(M, mz[z]);
    float L = 0.f;
#pragma unroll
    for (int z = 0; z < kMaxCluster; ++z) {
      const float w = mz[z] == -INFINITY ? 0.f : exp2f(mz[z] - M);
      s_w[r * kMaxCluster + z] = w;
      L += w * lz[z];
    }
    s_inv[r] = 1.f / fmaxf(L, 1e-30f);
  }
  hopper::bar_sync(3, 256);
  constexpr int kQuads = kD / 4;
  const int items = rows * kQuads;
  for (int it0 = ctid; it0 < items; it0 += 2 * 256) {
    float4 v[2][kMaxCluster];
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const int it = it0 + b * 256;
      const int k = it / kQuads;
      const float* src =
          s_merge + (split + k * splits) * kMergeLd + 4 * (it - k * kQuads);
#pragma unroll
      for (int z = 0; z < kMaxCluster; ++z)
        if (z < splits && it < items)
          v[b][z] = hopper::dsmem_ld4(hopper::dsmem_addr(src, ht + mc * z));
    }
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const int it = it0 + b * 256;
      if (it >= items) break;
      const int k = it / kQuads;
      const int c4 = 4 * (it - k * kQuads);
      const int r = split + k * splits;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int z = 0; z < kMaxCluster; ++z) {
        if (z >= splits) break;
        const float w = s_w[r * kMaxCluster + z];
        acc.x = fmaf(w, v[b][z].x, acc.x);
        acc.y = fmaf(w, v[b][z].y, acc.y);
        acc.z = fmaf(w, v[b][z].z, acc.z);
        acc.w = fmaf(w, v[b][z].w, acc.w);
      }
      const float inv = s_inv[r];
      uint2 pk;
      pk.x = hopper::pack_bf16(acc.x * inv, acc.y * inv);
      pk.y = hopper::pack_bf16(acc.z * inv, acc.w * inv);
      *reinterpret_cast<uint2*>(&out_rows[(size_t)r * kD + c4]) = pk;
    }
  }
  hopper::cluster_sync();   // no block leaves while its partial is read
}

template <int BT>
int launch_bt(const CUtensorMap& tq, const CUtensorMap& tk,
              const CUtensorMap& tv, const void* table, const void* lengths,
              void* out, int S, int H, int KV, int T, int NP, int window,
              float scale, int splits, bool shared_kv, int q_rows,
              cudaStream_t stream) {
  const int stages = num_stages(BT, shared_kv);
  const size_t smem = (size_t)kFixedBytes +
                      (size_t)stages * stage_bytes(BT, shared_kv);
  auto kernel = paged_mla_kernel<BT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int mc = (H / KV + kHeads - 1) / kHeads;
  if (mc * splits > 8) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(KV * mc, splits, S);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = mc;
  attr[0].val.clusterDim.y = splits;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, tq, tk, tv,
                           static_cast<const int*>(table),
                           static_cast<const int*>(lengths),
                           static_cast<__nv_bfloat16*>(out), H, KV, T, NP,
                           window, scale * 1.4426950408889634f,
                           (int)shared_kv, stages, q_rows, T < BT ? T : BT);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

int launch_mla(const void* q, const void* k_pages, const void* v_pages,
               const void* table, const void* lengths, void* out, int S,
               int H, int KV, int T, int NP, int P, int window, float scale,
               int splits, cudaStream_t stream) {
  const bool shared_kv = k_pages == v_pages;
  const int G = KV > 0 ? H / KV : 0;
  const int mc = (G + kHeads - 1) / kHeads;
  if (G < 1 || G * KV != H || mc > 2 || splits < 1 ||
      mc * splits > kMaxCluster || T < 1 || NP < 1 || P < 1)
    return (int)cudaErrorInvalidValue;
  const int bt = tile_tokens(T, shared_kv);
  const int q_rows = H < kHeads ? H : kHeads;
  // q (S, H, D) as (D, H, S): the block's heads are the box (64, q_rows,
  // 1) at (64a, first head, row); heads past H read as zeros.  The pool
  // (P, T, KV, D) as (D, KV, T, P): a tile of one KV head is the box
  // (64, 1, BT, 1) at (64a, kvh, first token, page), tokens past the
  // page's end zeros.
  const uint64_t q_dims[3] = {(uint64_t)kD, (uint64_t)H, (uint64_t)S};
  const uint64_t q_strides[2] = {(uint64_t)kD * 2, (uint64_t)H * kD * 2};
  const uint32_t q_box[3] = {64, (uint32_t)q_rows, 1};
  const uint64_t kv_dims[4] = {(uint64_t)kD, (uint64_t)KV, (uint64_t)T,
                               (uint64_t)P};
  const uint64_t kv_strides[3] = {(uint64_t)kD * 2, (uint64_t)KV * kD * 2,
                                  (uint64_t)T * KV * kD * 2};
  const uint32_t kv_box[4] = {64, 1, (uint32_t)(T < bt ? T : bt), 1};
  CUtensorMap tq, tk, tv;
  int rc = hopper::make_map_bf16(&tq, q, 3, q_dims, q_strides, q_box);
  if (rc == 0)
    rc = hopper::make_map_bf16(&tk, k_pages, 4, kv_dims, kv_strides, kv_box);
  if (rc == 0)
    rc = hopper::make_map_bf16(&tv, v_pages, 4, kv_dims, kv_strides, kv_box);
  if (rc) return rc;
  switch (bt) {
    case 64:
      return launch_bt<64>(tq, tk, tv, table, lengths, out, S, H, KV, T, NP,
                           window, scale, splits, shared_kv, q_rows, stream);
    case 48:
      return launch_bt<48>(tq, tk, tv, table, lengths, out, S, H, KV, T, NP,
                           window, scale, splits, shared_kv, q_rows, stream);
    case 32:
      return launch_bt<32>(tq, tk, tv, table, lengths, out, S, H, KV, T, NP,
                           window, scale, splits, shared_kv, q_rows, stream);
    default:
      return launch_bt<16>(tq, tk, tv, table, lengths, out, S, H, KV, T, NP,
                           window, scale, splits, shared_kv, q_rows, stream);
  }
}

}  // namespace mla

extern "C" {

// Bytes of shared memory one block of body `path` (0 = simt, 1 = split,
// 2 = mla) needs; the simt body's does not depend on the page, and the mla
// body's depends on the page (its token tile) and on whether K and V are
// one tensor (`shared_kv`), not on the group.  The wrapper refuses shapes
// above the 232,448 B a block may use.
size_t paged_attention_smem_bytes(int G, int D, int T, int path,
                                  int shared_kv) {
  if (path == 1) return split::smem_bytes(G, D, T);
  if (path == 2) return mla::smem_bytes(T, shared_kv != 0);
  return simt::smem_bytes(G, D);
}

// dtype: 0 = float32, 1 = bfloat16; path: 0 = simt, 1 = split, 2 = mla
// (both bf16 only; ws_acc/ws_ml are the split body's float32 partials,
// (S, KV, splits, G, D) and (S, KV, splits, G, 2); the mla body takes
// none and ignores split_pages: its `splits` blocks of a (row, head tile)
// share its live tiles and merge in their cluster; P is the pool's page
// count).  All pointers are device pointers on `device`;
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
    return mla::launch_mla(q, k_pages, v_pages, table, lengths, out, S, H,
                           KV, page_tokens, NP, P, window, scale, splits,
                           st);
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
