// Flash attention for NVIDIA Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces repro/kernels/flash_attention.py::_fa_kernel (the Pallas TPU
// kernel behind repro.kernels.flash_attention.flash_attention).
//
// What it computes (the same function as the Pallas kernel): for q
// (B, H, Sq, D) and k, v (B, H, Sk, D), softmax(q k^T / sqrt(D)) v per
// (batch, head), with an online softmax over block_kv partitions of the
// keys (float32 running max m, sum l and accumulator).  Keys at or past Sk
// are masked to -1e30; with `causal`, query i sees keys <= i + (Sk - Sq)
// (the sequence ends aligned, q_offset = Sk - Sq).  A row that sees no key
// (causal with Sq > Sk) is undefined, as in the Pallas kernel.  The
// probabilities are rounded to V's dtype before the product with V, and l
// sums the unrounded float32 ones, as the Pallas kernel does.
//
// What bounds it on an H100: operations.  Over 4096 tokens at D = 64 it
// does 4 * Sq * Sk * D flops (halved by the causal mask) for 4 * S * D
// elements moved per head: hundreds of flops per byte.
//
// Two bodies, chosen by the caller (kernels/flash_attention.py::
// attention_path):
//
// * wgmma (bf16, D = 64 or 128).  Both products run on the tensor cores.
//   One block per (batch*head, block_q rows), block_q = 64 per consumer
//   warpgroup (one or two), launched longest q-block first so that the
//   causal tail does not run alone.  A producer warpgroup (one thread)
//   loads the Q tile once by TMA, then streams K and V tiles of block_kv
//   rows through kStages shared-memory stages guarded by "full" and
//   "empty" mbarriers.  The tensor maps are 3-D over (D, S, B*H), so rows
//   past S read as zeros and never as the next head's.  Each consumer
//   warpgroup, per K/V tile: S = Q K^T by wgmma m64n{block_kv}k16 (Q and
//   K both K-major in shared memory); scale, mask (keys >= Sk on the last
//   tile, the causal diagonal on the tiles that cross it), the row max and
//   sum over the 4 threads of a quad by shuffles, the rescale of the
//   accumulator; then O += P V by wgmma m64n{D}k16 with P in registers
//   (the f32 score fragment, exponentiated and packed to bf16 pairs, maps
//   onto the m64k16 A fragment as it stands) and V read MN-major through
//   the transpose bit.  The key loop stops at the last tile the block's
//   last row sees.  Rows past Sq are not stored.
// * simt (float32, and head dims 16, 32, 256).  One thread block per
//   (batch*head, block_q rows); the block stages one block_kv tile of K
//   and one of V in shared memory (16-byte loads) and every query row of
//   the block reuses it.  A query row belongs to D/32 neighbouring threads
//   (one thread for D <= 32), each holding 32 of its dims of q and of the
//   accumulator in registers; the partial dot products are summed with
//   warp shuffles.  Scores are taken 16 keys at a time.  The products run
//   on the CUDA cores in float32.
//
// Left for later work on the wgmma body: two consumer warpgroups in
// ping-pong (one's softmax under the other's products), the next tile's
// Q K^T issued before this tile's softmax, persistent blocks, a TMA store.
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

constexpr float kNegInf = -1e30f;  // the masked logit, as in the reference

// ---------------------------------------------------------------------------
// wgmma body (bf16, D = 64 or 128)
// ---------------------------------------------------------------------------

constexpr int kAtom = 64;          // bf16 values in one 128-byte swizzled row
constexpr int kStages = 2;         // K/V ring depth
// Dynamic shared memory beyond the tiles: slack to align them to 1,024
// bytes (128-byte swizzle), and the mbarriers.
constexpr int kAlignSlack = 1024;
constexpr int kBarrierBytes = 128;
constexpr float kLog2e = 1.4426950408889634f;

// D: head dim; BKV: keys per tile; NC: consumer warpgroups (block_q =
// 64 * NC).
template <int D, int BKV, int NC>
__global__ void __launch_bounds__(128 * (NC + 1), 1)
flash_attention_wgmma_kernel(
    const __grid_constant__ CUtensorMap tm_q,   // (B*H, Sq, D)
    const __grid_constant__ CUtensorMap tm_k,   // (B*H, Sk, D)
    const __grid_constant__ CUtensorMap tm_v,   // (B*H, Sk, D)
    __nv_bfloat16* __restrict__ out,            // (B*H, Sq, D)
    int Sq, int Sk, int causal, float scale_log2) {
  constexpr int BQ = 64 * NC;
  constexpr int DA = D / kAtom;              // 128-byte atoms across D
  constexpr int Q_BYTES = BQ * D * 2;
  constexpr int KV_BYTES = BKV * D * 2;      // one tile of K (or V)
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // longest first
  const int q_offset = Sk - Sq;
  // Keys the block needs: all of them, or under the causal mask those up
  // to the one its last row sees.
  int kv_end = Sk;
  if (causal) kv_end = max(0, min(Sk, min(q0 + BQ, Sq) + q_offset));
  const int ntiles = (kv_end + BKV - 1) / BKV;

  extern __shared__ __align__(16) unsigned char smem_wg[];
  unsigned char* base = hopper::align_1024(smem_wg);
  // Q: DA boxes of (BQ rows x 64); each K and V stage: DA boxes of
  // (BKV rows x 64); 128-byte rows, 1,024-aligned.
  unsigned char* s_q = base;
  unsigned char* s_k = s_q + Q_BYTES;
  unsigned char* s_v = s_k + kStages * KV_BYTES;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(s_v + kStages * KV_BYTES);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], NC * 128);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // Producer: one thread loads Q, then keeps kStages K/V tiles in flight.
    hopper::setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      hopper::mbar_arrive_expect_tx(q_full, Q_BYTES);
      for (int a = 0; a < DA; ++a)
        hopper::tma_load_3d(s_q + a * (BQ * 128), &tm_q, q_full, a * kAtom,
                            q0, bh);
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % kStages;
        if (t >= kStages)
          hopper::mbar_wait(&empty[s], ((t / kStages) - 1) & 1);
        hopper::mbar_arrive_expect_tx(&full[s], 2 * KV_BYTES);
        for (int a = 0; a < DA; ++a) {
          hopper::tma_load_3d(s_k + s * KV_BYTES + a * (BKV * 128), &tm_k,
                              &full[s], a * kAtom, t * BKV, bh);
          hopper::tma_load_3d(s_v + s * KV_BYTES + a * (BKV * 128), &tm_v,
                              &full[s], a * kAtom, t * BKV, bh);
        }
      }
    }
  } else {
    hopper::setmaxnreg_inc<NC == 2 ? 232 : 240>();
    const int c = wg - 1;                    // rows 64c .. 64c + 63
    const int lane = threadIdx.x & 31;
    const int warp = (threadIdx.x & 127) >> 5;
    // Fragment map of an m64nN f32 accumulator: register i of a thread
    // holds row 16 * warp + lane / 4 + 8 * ((i >> 1) & 1) and column
    // 8 * (i >> 2) + 2 * (lane % 4) + (i & 1).
    const int row_lo = q0 + c * 64 + warp * 16 + (lane >> 2);
    const int first_row = q0 + c * 64;
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m[2] = {kNegInf, kNegInf};
    float l[2] = {0.f, 0.f};                 // this thread's share of l
    hopper::mbar_wait(q_full, 0);

    for (int t = 0; t < ntiles; ++t) {
      const int s = t % kStages;
      hopper::mbar_wait(&full[s], (t / kStages) & 1);
      const unsigned char* k_st = s_k + s * KV_BYTES;
      const unsigned char* v_st = s_v + s * KV_BYTES;

      // S = Q K^T over D in 16-wide steps.
      float sc[BKV / 2];
#pragma unroll
      for (int i = 0; i < BKV / 2; ++i) sc[i] = 0.f;
      hopper::fence_regs(sc);
      hopper::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        const int a = ks / 4, kk = ks % 4;
        const uint64_t dq = hopper::desc_sw128(
            s_q + a * (BQ * 128) + c * (64 * 128) + kk * 32, 16, 1024);
        const uint64_t dk = hopper::desc_sw128(
            k_st + a * (BKV * 128) + kk * 32, 16, 1024);
        hopper::wgmma_ss<BKV, 0>(sc, dq, dk, 1);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(sc);

      // Scale into the log2 domain, mask, and the online softmax.
      const int k0 = t * BKV;
      const bool edge = k0 + BKV > Sk ||
                        (causal && k0 + BKV - 1 > first_row + q_offset);
      float mt[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int i = 0; i < BKV / 2; ++i) {
        float x = sc[i] * scale_log2;
        if (edge) {
          const int col = k0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
          const int row = row_lo + 8 * ((i >> 1) & 1);
          if (col >= Sk || (causal && col > row + q_offset)) x = kNegInf;
        }
        sc[i] = x;
        mt[(i >> 1) & 1] = fmaxf(mt[(i >> 1) & 1], x);
      }
      float corr[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mt[h] = fmaxf(mt[h], __shfl_xor_sync(0xffffffffu, mt[h], 1));
        mt[h] = fmaxf(mt[h], __shfl_xor_sync(0xffffffffu, mt[h], 2));
        const float m_new = fmaxf(m[h], mt[h]);
        corr[h] = exp2f(m[h] - m_new);
        m[h] = m_new;
        l[h] *= corr[h];
      }
#pragma unroll
      for (int i = 0; i < BKV / 2; ++i) {
        const int h = (i >> 1) & 1;
        sc[i] = exp2f(sc[i] - m[h]);
        l[h] += sc[i];
      }
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= corr[(i >> 1) & 1];

      // P as bf16 A fragments: k step j takes score registers 8j .. 8j+7.
      uint32_t p[BKV / 16][4];
#pragma unroll
      for (int j = 0; j < BKV / 16; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          p[j][r] = hopper::pack_bf16(sc[8 * j + 2 * r], sc[8 * j + 2 * r + 1]);

      // O += P V over the tile's keys in 16-wide steps; V is MN-major.
      hopper::fence_regs(o);
      hopper::wgmma_fence();
#pragma unroll
      for (int j = 0; j < BKV / 16; ++j) {
        const uint64_t dv = hopper::desc_sw128(v_st + j * (16 * 128),
                                               BKV * 128, 1024);
        hopper::wgmma_rs<D, 1>(o, p[j], dv, 1);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(o);
      hopper::mbar_arrive(&empty[s]);
    }

    float inv[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
      inv[h] = 1.f / fmaxf(l[h], 1e-30f);
    }
#pragma unroll
    for (int g = 0; g < D / 8; ++g) {
      const int col = 8 * g + 2 * (lane & 3);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row_lo + 8 * h;
        if (row < Sq)
          *reinterpret_cast<__nv_bfloat162*>(
              &out[((size_t)bh * Sq + row) * D + col]) =
              __floats2bfloat162_rn(o[4 * g + 2 * h] * inv[h],
                                    o[4 * g + 2 * h + 1] * inv[h]);
      }
    }
  }
}

size_t wgmma_smem_bytes(int block_q, int block_kv, int D) {
  return (size_t)block_q * D * 2 + (size_t)kStages * 2 * block_kv * D * 2 +
         kAlignSlack + kBarrierBytes;
}

template <int D, int BKV, int NC>
int launch_wgmma_t(const CUtensorMap& tq, const CUtensorMap& tk,
                   const CUtensorMap& tv, void* out, int BH, int Sq, int Sk,
                   int causal, float scale, cudaStream_t stream) {
  constexpr int BQ = 64 * NC;
  const size_t smem = wgmma_smem_bytes(BQ, BKV, D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_wgmma_kernel<D, BKV, NC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(BH, (Sq + BQ - 1) / BQ);
  flash_attention_wgmma_kernel<D, BKV, NC>
      <<<grid, 128 * (NC + 1), smem, stream>>>(
          tq, tk, tv, static_cast<__nv_bfloat16*>(out), Sq, Sk, causal,
          scale * kLog2e);
  return (int)cudaGetLastError();
}

template <int D>
int launch_wgmma_d(const CUtensorMap& tq, const CUtensorMap& tk,
                   const CUtensorMap& tv, void* out, int BH, int Sq, int Sk,
                   int block_q, int block_kv, int causal, float scale,
                   cudaStream_t stream) {
  if (block_kv == 64 && block_q == 64)
    return launch_wgmma_t<D, 64, 1>(tq, tk, tv, out, BH, Sq, Sk, causal,
                                    scale, stream);
  if (block_kv == 64)
    return launch_wgmma_t<D, 64, 2>(tq, tk, tv, out, BH, Sq, Sk, causal,
                                    scale, stream);
  if (block_q == 64)
    return launch_wgmma_t<D, 128, 1>(tq, tk, tv, out, BH, Sq, Sk, causal,
                                     scale, stream);
  return launch_wgmma_t<D, 128, 2>(tq, tk, tv, out, BH, Sq, Sk, causal,
                                   scale, stream);
}

int launch_wgmma(const void* q, const void* k, const void* v, void* out,
                 int BH, int Sq, int Sk, int D, int block_q, int block_kv,
                 int causal, float scale, cudaStream_t stream) {
  if ((D != 64 && D != 128) || (block_q != 64 && block_q != 128) ||
      (block_kv != 64 && block_kv != 128) || Sq < 1 || Sk < 1)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  const uint32_t q_box[3] = {(uint32_t)kAtom, (uint32_t)block_q, 1};
  const uint32_t kv_box[3] = {(uint32_t)kAtom, (uint32_t)block_kv, 1};
  const uint64_t q_dims[3] = {(uint64_t)D, (uint64_t)Sq, (uint64_t)BH};
  const uint64_t q_strides[2] = {(uint64_t)D * 2, (uint64_t)Sq * D * 2};
  const uint64_t kv_dims[3] = {(uint64_t)D, (uint64_t)Sk, (uint64_t)BH};
  const uint64_t kv_strides[2] = {(uint64_t)D * 2, (uint64_t)Sk * D * 2};
  int rc = hopper::make_map_bf16(&tq, q, 3, q_dims, q_strides, q_box);
  if (rc == 0) rc = hopper::make_map_bf16(&tk, k, 3, kv_dims, kv_strides,
                                          kv_box);
  if (rc == 0) rc = hopper::make_map_bf16(&tv, v, 3, kv_dims, kv_strides,
                                          kv_box);
  if (rc) return rc;
  if (D == 64)
    return launch_wgmma_d<64>(tq, tk, tv, out, BH, Sq, Sk, block_q, block_kv,
                              causal, scale, stream);
  return launch_wgmma_d<128>(tq, tk, tv, out, BH, Sq, Sk, block_q, block_kv,
                             causal, scale, stream);
}

// ---------------------------------------------------------------------------
// simt body (float32, and head dims the wgmma body does not take)
// ---------------------------------------------------------------------------

constexpr int kMaxThreads = 512;   // 128 registers a thread
constexpr int kSlice = 32;         // head dims one thread holds (at most)
constexpr int kKeyStep = 16;       // scores taken per online-softmax step

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
flash_attention_simt_kernel(const T* __restrict__ q,    // (B*H, Sq, D)
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

size_t simt_smem_bytes(int block_kv, int D, int dtype) {
  return 2 * (size_t)block_kv * D * (dtype == 1 ? 2 : 4);
}

template <typename T, int DT>
int launch_simt_dt(const void* q, const void* k, const void* v, void* out,
                   int BH, int Sq, int Sk, int D, int block_q, int block_kv,
                   int causal, float scale, int dtype, cudaStream_t stream) {
  const size_t smem = simt_smem_bytes(block_kv, D, dtype);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_simt_kernel<T, DT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int g = D / DT;
  const int threads = ((block_q * g + 31) / 32) * 32;
  dim3 grid((Sq + block_q - 1) / block_q, BH);
  flash_attention_simt_kernel<T, DT><<<grid, threads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Sq, Sk, D, block_q,
      block_kv, causal, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_simt(const void* q, const void* k, const void* v, void* out,
                int BH, int Sq, int Sk, int D, int block_q, int block_kv,
                int causal, float scale, int dtype, cudaStream_t stream) {
  if (D == 16)
    return launch_simt_dt<T, 16>(q, k, v, out, BH, Sq, Sk, D, block_q,
                                 block_kv, causal, scale, dtype, stream);
  return launch_simt_dt<T, kSlice>(q, k, v, out, BH, Sq, Sk, D, block_q,
                                   block_kv, causal, scale, dtype, stream);
}

}  // namespace

extern "C" {

// Bytes of shared memory one block needs.  path 1 (wgmma): the Q tile and
// kStages K and V tiles in bf16, plus alignment slack and barriers; path 0
// (simt): one K and one V tile in the inputs' dtype (0 = float32,
// 1 = bfloat16).
size_t flash_attention_smem_bytes(int block_q, int block_kv, int D,
                                  int dtype, int path) {
  if (path == 1) return wgmma_smem_bytes(block_q, block_kv, D);
  return simt_smem_bytes(block_kv, D, dtype);
}

// path 1 (wgmma): bf16, D 64 or 128, block_q and block_kv 64 or 128.
// path 0 (simt): D is 16, 32, 64, 128 or 256; the threads of a block
// (block_q * D/32, rounded up to a warp) are at most 512.  The wrapper
// checks both.  dtype: 0 = float32, 1 = bfloat16.
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        void* out, int BH, int Sq, int Sk, int D,
                        int block_q, int block_kv, int causal, float scale,
                        int dtype, int path, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (path == 1) {
    if (dtype != 1) return (int)cudaErrorInvalidValue;
    return launch_wgmma(q, k, v, out, BH, Sq, Sk, D, block_q, block_kv,
                        causal, scale, st);
  }
  if (dtype == 1)
    return launch_simt<__nv_bfloat16>(q, k, v, out, BH, Sq, Sk, D, block_q,
                                      block_kv, causal, scale, dtype, st);
  return launch_simt<float>(q, k, v, out, BH, Sq, Sk, D, block_q, block_kv,
                            causal, scale, dtype, st);
}

}  // extern "C"
