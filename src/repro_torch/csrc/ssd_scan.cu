// Mamba2 / SSD chunked scan for NVIDIA Hopper (sm_90a), hand-written
// CUDA C++.
//
// Replaces repro/kernels/ssd_scan.py::_ssd_kernel (the Pallas TPU kernel
// behind repro.kernels.ssd_scan.ssd_scan).
//
// What it computes (the same function as the Pallas kernel): for x
// (B, S, H, P), dt (B, S, H), A (H,) and B, C (B, S, N) shared over heads,
// y (B, S, H, P) of the selective state-space recurrence, chunk by chunk.
// Within a chunk of Q steps, with cum the cumulative sum of dt*A:
//   y_i  = sum_{j<=i} exp(cum_i - cum_j) (C_i . B_j) dt_j x_j     (intra)
//        + exp(cum_i) C_i . S_prev                               (inter)
//   S    = exp(cum_Q) S_prev + sum_j exp(cum_Q - cum_j) dt_j B_j x_j^T
// with the float32 state S (N x P) carried from chunk to chunk.  Beside
// y, which is all the Pallas kernel returns, both bodies take an initial
// state and give the final one (`init`, `final`, each null or (B, H, P, N)
// float32: the layout of the reference's cache, repro.models.model's
// init_cache, so a cache holds the same numbers in both packages; the
// kernels read and write it transposed to their own N x P order), which
// the hybrid_ssm serving path carries from one prefill chunk to the next.
// A ragged final chunk is masked: steps past the sequence read as zeros
// (dt = 0), so they neither decay nor add to the state, as with the TPU's
// padding.  That is also how a call shorter than 16 steps (an 8-token
// prefill chunk) runs on the tensor cores: the wrapper rounds its chunk up
// to 16 and the tail rows are masked, so the final state is the one after
// the call's last real step.
//
// What bounds it on an H100: bytes.  Each element of x, y, dt, B and C
// crosses HBM once, against O(Q) flops per element at the planned chunk --
// on the tensor cores the products of a chunk take less time than its
// bytes.
//
// Two bodies:
//
// `tc` (bf16; P in {16, 32, 64, 128}; N a multiple of 16 up to 128; Q a
// multiple of 16 up to 256).  The TPU grid's sequential chunk axis becomes
// three launches, so chunks run in parallel and only an elementwise
// recurrence runs in order:
//   1. chunk states, one block per (chunk, group of heads, batch): per head,
//      S_c = (B o exp(cum_Q - cum) o dt)^T x (N x Q times Q x P) and the
//      chunk's total log decay cum_Q, both float32 into a workspace the
//      wrapper allocates (B, nc, H, N, P) and (B, nc, H);
//   2. state passing, one thread per (batch, head, state element), in chunk
//      order: S_prev[c] = exp(cum_Q[c-1]) S_prev[c-1] + S_c[c-1], written
//      over S_c in place, from `init` (or zeros), leaving the state after
//      the last chunk in `final`;
//   3. outputs, one block per (chunk -- or 128-row panel of a longer
//      chunk --, group of heads, batch), one 16-row tile per warp: C.B^T
//      (the panel's rows x the chunk's columns up to its last row) once
//      for the block's heads, since B and C are shared over heads; then per
//      head
//      y = exp(cum) o (C S_prev) + ((C.B^T) o L_h o dt) x.
// All products run on the tensor cores with mma.sync.m16n8k16 (bf16
// operands, f32 accumulate; wgmma would need 64-row tiles per head and
// pass 3's causal panels are ragged).  The inputs are bf16 and enter as
// they are; the f32 intermediates (B o decay o dt, the decay-weighted
// scores, S_prev) enter as two bf16 terms, hi + lo, and two products, so
// they keep 16 bits of mantissa: rounded once to bf16 they missed the
// tolerance where terms cancel (N = P = 128).  The kernel is bound by
// bytes, so the doubled products stay under the loads.  B and C are
// staged once per block with cp.async into padded rows (conflict-free
// ldmatrix); the next head's x (and, in pass 3, its S_prev) is in flight
// while this head's products run.  A pass-3 block covers the whole chunk,
// so x and S_prev cross HBM once per head and chunk (with 64-row panels
// they crossed 1.5 and 2 times).  Each block holds up to 8 heads, as
// many as leave a block for every SM (`heads_per_block`), so the grid has
// hundreds of blocks at batch 1 where one block per (batch, head) gave 64
// and a short call still spreads its heads over the card; the price is
// the state workspace: 4 B per (chunk, head, N, P) element, written by
// pass 1, read and rewritten by pass 2, read by pass 3.
//
// `simt` (float32, and shapes the tc body does not take): one thread block
// per (batch, head) walks the chunks in order with the state in shared
// memory, all float32 on the CUDA cores (the second slice's kernel, kept
// as it was).
//
// Interface: plain C functions (no PyTorch headers), loaded with ctypes.
// They launch on the caller's stream, allocate nothing, and return
// cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace simt {


constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Shared-memory floats of one block (the layout in the kernel below).
__host__ __device__ inline size_t smem_floats(int Q, int P, int N) {
  return (size_t)Q * P          // x chunk
         + (size_t)Q * (N + 1)  // B chunk, rows padded by one float
         + (size_t)Q * N        // C chunk
         + 2 * (size_t)Q        // dt (later the state's decay), cum
         + (size_t)Q * Q        // decay-weighted scores
         + (size_t)N * P;       // state
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ x,       // (B, S, H, P)
                const float* __restrict__ dt,  // (B, S, H)
                const float* __restrict__ A,   // (H,)
                const T* __restrict__ Bm,      // (B, S, N)
                const T* __restrict__ Cm,      // (B, S, N)
                T* __restrict__ y,             // (B, S, H, P)
                const float* __restrict__ init,  // (B, H, P, N) or null
                float* __restrict__ final_state,  // (B, H, P, N) or null
                int S, int H, int P, int N, int Q) {
  const int b = blockIdx.x / H;
  const int h = blockIdx.x - b * H;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int NB = N + 1;               // padded row of the B chunk

  extern __shared__ float smem[];
  float* sx = smem;                   // Q x P
  float* sB = sx + Q * P;             // Q x (N + 1)
  float* sC = sB + Q * NB;            // Q x N
  float* sdt = sC + Q * N;            // Q
  float* scum = sdt + Q;              // Q
  float* sW = scum + Q;               // Q x Q
  float* sS = sW + Q * Q;             // N x P

  // The state is N x P here, P x N in `init` and `final`.
  const size_t ref0 = ((size_t)b * H + h) * P * N;
  for (int i = tid; i < N * P; i += kThreads) {
    const int n = i / P;
    sS[i] = init != nullptr ? init[ref0 + (size_t)(i - n * P) * N + n] : 0.f;
  }
  const float a = A[h];

  for (int c0 = 0; c0 < S; c0 += Q) {
    const int nq = min(Q, S - c0);
    // Stage the chunk, zeros past its end: dt = 0 there, so the padded
    // steps neither decay nor add to the state, as with the TPU's padding.
    for (int i = tid; i < Q * P; i += kThreads) {
      const int j = i / P;
      const int p = i - j * P;
      sx[i] = j < nq ? to_f32(x[(((size_t)b * S + c0 + j) * H + h) * P + p])
                     : 0.f;
    }
    for (int i = tid; i < Q * N; i += kThreads) {
      const int j = i / N;
      const int n = i - j * N;
      const size_t src = ((size_t)b * S + c0 + j) * N + n;
      sB[j * NB + n] = j < nq ? to_f32(Bm[src]) : 0.f;
      sC[i] = j < nq ? to_f32(Cm[src]) : 0.f;
    }
    for (int j = tid; j < Q; j += kThreads)
      sdt[j] = j < nq ? dt[((size_t)b * S + c0 + j) * H + h] : 0.f;
    __syncthreads();

    // cum = cumsum(dt * a): one warp, 32 steps at a time.
    if (warp == 0) {
      float carry = 0.f;
      for (int base = 0; base < Q; base += 32) {
        const int j = base + lane;
        float s = j < Q ? sdt[j] * a : 0.f;
        for (int o = 1; o < 32; o <<= 1) {
          const float t = __shfl_up_sync(0xffffffffu, s, o);
          if (lane >= o) s += t;
        }
        s += carry;
        if (j < Q) scum[j] = s;
        carry = __shfl_sync(0xffffffffu, s, 31);
      }
    }
    __syncthreads();

    // W[i][j] = exp(cum_i - cum_j) (C_i . B_j) dt_j for j <= i, else 0.
    for (int idx = tid; idx < Q * Q; idx += kThreads) {
      const int i = idx / Q;
      const int j = idx - i * Q;
      float w = 0.f;
      if (j <= i) {
        const float* cr = sC + i * N;
        const float* br = sB + j * NB;
        float d0 = 0.f, d1 = 0.f;
        int n = 0;
        for (; n + 1 < N; n += 2) {
          d0 = fmaf(cr[n], br[n], d0);
          d1 = fmaf(cr[n + 1], br[n + 1], d1);
        }
        if (n < N) d0 = fmaf(cr[n], br[n], d0);
        w = (d0 + d1) * expf(scum[i] - scum[j]) * sdt[j];
      }
      sW[idx] = w;
    }
    __syncthreads();

    // y_i = sum_j W[i][j] x_j + exp(cum_i) C_i . S_prev
    for (int idx = tid; idx < nq * P; idx += kThreads) {
      const int i = idx / P;
      const int p = idx - i * P;
      const float* wr = sW + i * Q;
      float intra = 0.f;
      for (int j = 0; j <= i; ++j) intra = fmaf(wr[j], sx[j * P + p], intra);
      const float* cr = sC + i * N;
      float inter = 0.f;
      for (int n = 0; n < N; ++n) inter = fmaf(cr[n], sS[n * P + p], inter);
      store_f32(&y[(((size_t)b * S + c0 + i) * H + h) * P + p],
                intra + expf(scum[i]) * inter);
    }
    __syncthreads();

    // S = exp(cum_last) S + sum_j exp(cum_last - cum_j) dt_j B_j x_j^T
    const float total = scum[Q - 1];
    for (int j = tid; j < Q; j += kThreads)
      sdt[j] *= expf(total - scum[j]);
    __syncthreads();
    const float keep = expf(total);
    for (int idx = tid; idx < N * P; idx += kThreads) {
      const int n = idx / P;
      const int p = idx - n * P;
      float s = sS[idx] * keep;
      for (int j = 0; j < Q; ++j)
        s = fmaf(sB[j * NB + n] * sdt[j], sx[j * P + p], s);
      sS[idx] = s;
    }
    __syncthreads();
  }
  if (final_state != nullptr)
    for (int i = tid; i < N * P; i += kThreads) {
      const int n = i / P;
      final_state[ref0 + (size_t)(i - n * P) * N + n] = sS[i];
    }
}

template <typename T>
int launch_simt(const void* x, const void* dt, const void* A, const void* Bm,
                const void* Cm, void* y, const float* init, float* final_state,
                int Bsz, int S, int H, int P, int N, int Q,
                cudaStream_t stream) {
  const size_t smem = smem_floats(Q, P, N) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  ssd_scan_kernel<T><<<Bsz * H, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<T*>(y), init, final_state, S,
      H, P, N, Q);
  return (int)cudaGetLastError();
}


}  // namespace simt

namespace tc {

constexpr int kThreads = 256;        // 8 warps: passes 1 and 3
constexpr int kWarps = kThreads / 32;
constexpr int kPanel = 128;          // output rows of a pass-3 block
constexpr int kPassThreads = 256;    // pass 2
constexpr int kPassBatch = 8;        // pass 2: chunks read at once
constexpr int kMaxHeadsPerBlock = 8;
constexpr int kPad = 8;              // bf16 elements added to each staged row
constexpr int kPrefetch = 4;         // pass 3: vectors a thread prefetches

// Heads one block of passes 1 and 3 holds: the largest divisor of H up to
// kMaxHeadsPerBlock that still gives the grid (`chunks` = batch x chunks
// blocks per head group) a block for each of the card's `sms` SMs, so
// C.B^T and B are staged once for that many heads; one head a block if
// none does.  A short call (an 8-token prefill chunk: one chunk) runs one
// head a block -- at 8 a block its 64 heads were 8 blocks on 132 SMs.
__host__ __device__ inline int heads_per_block(int H, long chunks, int sms) {
  for (int d = kMaxHeadsPerBlock; d > 1; --d)
    if (H % d == 0 && chunks * (H / d) >= sms) return d;
  return 1;
}

__host__ __device__ inline int panel_rows(int Q) {
  return Q < kPanel ? Q : kPanel;
}

// dt and cum of every head a block holds (up to kMaxHeadsPerBlock), Q
// floats each: loaded and summed once, before the block's head loop.
__host__ __device__ inline size_t head_scalars_bytes(int Q) {
  return 4 * 2 * (size_t)kMaxHeadsPerBlock * Q;
}

// Pass 1: B (Q x (N+8)) and two x buffers (Q x (P+8)) in bf16, and the
// heads' dt and cum.
__host__ __device__ inline size_t pass1_bytes(int Q, int P, int N) {
  return 2 * ((size_t)Q * (N + kPad) + 2 * (size_t)Q * (P + kPad)) +
         head_scalars_bytes(Q);
}

// Pass 3: B (Q x (N+8)), the panel's C (R x (N+8)), one x buffer
// (Q x (P+8)) and S_prev as two bf16 terms (2 x N x (P+8)) in bf16; the
// panel's C.B^T (R x (Q+4)) in f32; the heads' dt and cum.
// R = min(Q, 128).  At Q = 128, P = N = 64 that is 149,504 B, one block
// of 8 warps per SM.
__host__ __device__ inline size_t pass3_bytes(int Q, int P, int N) {
  const size_t R = panel_rows(Q);
  return 2 * ((size_t)Q * (N + kPad) + R * (N + kPad) +
              (size_t)Q * (P + kPad) + 2 * (size_t)N * (P + kPad)) +
         4 * R * (Q + 4) + head_scalars_bytes(Q);
}

// The largest block of the three passes (pass 2 uses none).
__host__ __device__ inline size_t smem_bytes(int Q, int P, int N) {
  const size_t a = pass1_bytes(Q, P, N), b = pass3_bytes(Q, P, N);
  return a > b ? a : b;
}

// Stages `rows` rows of `cols` bf16 (cols a multiple of 8) into shared
// rows of `ld` elements with cp.async; rows at or past `live` are zeros.
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst, int ld,
                                           const __nv_bfloat16* src,
                                           size_t src_stride, int rows,
                                           int live, int cols) {
  const int vecs = cols / 8;
  for (int i = threadIdx.x; i < rows * vecs; i += blockDim.x) {
    const int r = i / vecs;
    const int v = i - r * vecs;
    __nv_bfloat16* d = dst + (size_t)r * ld + v * 8;
    if (r < live)
      hopper::cp_async_16(d, src + (size_t)r * src_stride + v * 8);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// Loads dt[j] of heads h0 .. h0+HG-1 for chunk rows j < n (zeros at and
// past `live`) into sdt[hh * Q + j]: the heads of one row are adjacent.
__device__ __forceinline__ void load_head_dt(float* sdt, const float* dt,
                                             size_t row0, int H, int h0,
                                             int HG, int Q, int n, int live) {
  for (int i = threadIdx.x; i < n * HG; i += blockDim.x) {
    const int j = i / HG;
    const int hh = i - j * HG;
    sdt[hh * Q + j] = j < live ? dt[(row0 + j) * H + h0 + hh] : 0.f;
  }
}

// cum[j] = sum_{r<=j} dt[r] * a for j < n, by one warp (32 steps at a
// time).
__device__ __forceinline__ void chunk_cumsum(const float* dt, float* cum,
                                             int n, float a) {
  const int lane = threadIdx.x & 31;
  float carry = 0.f;
  for (int base = 0; base < n; base += 32) {
    const int j = base + lane;
    float s = j < n ? dt[j] * a : 0.f;
    for (int o = 1; o < 32; o <<= 1) {
      const float t = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += t;
    }
    s += carry;
    if (j < n) cum[j] = s;
    carry = __shfl_sync(0xffffffffu, s, 31);
  }
}

// Two f32 values as the sum of two bf16 pairs, hi + lo: an operand split
// this way carries 16 bits of mantissa through a bf16 mma, where one
// rounding to bf16 would leave 8 (2^-9 of the largest term: with sums of
// N = 64 products it exceeded the tolerance where terms cancel).
__device__ __forceinline__ void split_pair(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  hi = hopper::pack_bf16(a, b);
  const float2 h = hopper::unpack_bf16(hi);
  lo = hopper::pack_bf16(a - h.x, b - h.y);
}

// ---------------------------------------------------------------------------
// Pass 1: chunk states
// ---------------------------------------------------------------------------

// Pass 1: a warp computes 16 rows and P / kSplit columns of a chunk
// state: two warps share each 16-row tile where P allows it, so a block
// of 8 warps covers N = 64 with every warp busy.
template <int P>
struct Cols {
  static constexpr int kSplit = P >= 32 ? 2 : 1;
  static constexpr int kWidth = P / kSplit;
};

template <int P>
__global__ void __launch_bounds__(kThreads, 2)
ssd_states_kernel(const __nv_bfloat16* __restrict__ x,   // (B, S, H, P)
                  const float* __restrict__ dt,          // (B, S, H)
                  const float* __restrict__ A,           // (H,)
                  const __nv_bfloat16* __restrict__ Bm,  // (B, S, N)
                  float* __restrict__ states,   // (B, nc, H, N, P)
                  float* __restrict__ totals,   // (B, nc, H)
                  int S, int H, int N, int Q, int HG) {
  constexpr int PP = P + kPad;
  const int c = blockIdx.x;
  const int nc = gridDim.x;
  const int h0 = blockIdx.y * HG;
  const int b = blockIdx.z;
  const int c0 = c * Q;
  const int nq = min(Q, S - c0);
  const int NN = N + kPad;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int mi = lane >> 3;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sB = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sx = sB + (size_t)Q * NN;                 // 2 x Q x PP
  float* sdt = reinterpret_cast<float*>(sx + 2 * (size_t)Q * PP);  // HG x Q
  float* scum = sdt + kMaxHeadsPerBlock * Q;                       // HG x Q

  const size_t row0 = (size_t)b * S + c0;
  stage_rows(sB, NN, Bm + row0 * N, N, Q, nq, N);
  stage_rows(sx, PP, x + (row0 * H + h0) * P, (size_t)H * P, Q, nq, P);
  hopper::cp_async_commit();
  load_head_dt(sdt, dt, row0, H, h0, HG, Q, Q, nq);
  __syncthreads();
  for (int hh = warp; hh < HG; hh += kWarps)
    chunk_cumsum(sdt + hh * Q, scum + hh * Q, Q, A[h0 + hh]);

  for (int hi = 0; hi < HG; ++hi) {
    const int h = h0 + hi;
    const __nv_bfloat16* xs = sx + (size_t)(hi & 1) * Q * PP;
    if (hi + 1 < HG) {       // the next head's x, in flight meanwhile
      stage_rows(sx + (size_t)((hi + 1) & 1) * Q * PP, PP,
                 x + (row0 * H + h + 1) * P, (size_t)H * P, Q, nq, P);
      hopper::cp_async_commit();
      hopper::cp_async_wait<1>();
    } else {
      hopper::cp_async_wait<0>();
    }
    __syncthreads();
    const float* hdt = sdt + hi * Q;
    const float* hcum = scum + hi * Q;
    const float total = hcum[Q - 1];

    // S_c (N x P) = (B o w)^T x: 16 rows n and PC columns per warp, k =
    // the chunk.
    constexpr int PC = Cols<P>::kWidth;
    float* out = states + (((size_t)b * nc + c) * H + h) * N * P;
    for (int item = warp; item < (N / 16) * Cols<P>::kSplit;
         item += kWarps) {
      const int mt = item / Cols<P>::kSplit;
      const int c_lo = (item - mt * Cols<P>::kSplit) * PC;
      float acc[PC / 8][4];
#pragma unroll
      for (int i = 0; i < PC / 8; ++i)
        acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
      for (int ks = 0; ks < Q / 16; ++ks) {
        // A[n][j] = B[j][n] w_j: B is stored [j][n], so .trans reads it.
        uint32_t af[4];
        hopper::ldmatrix_x4_trans(
            af, sB + (size_t)(ks * 16 + ((mi >> 1) << 3) + (lane & 7)) * NN +
                    mt * 16 + ((mi & 1) << 3));
        // w_j = exp(cum_Q - cum_j) dt_j for this thread's four columns.
        const int j = ks * 16 + 2 * t;
        float w[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int je = j + (e & 1) + ((e >> 1) << 3);
          w[e] = __expf(total - hcum[je]) * hdt[je];
        }
        uint32_t ah[4], al[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float2 f = hopper::unpack_bf16(af[r]);
          const int e = (r >> 1) << 1;
          split_pair(f.x * w[e], f.y * w[e + 1], ah[r], al[r]);
        }
#pragma unroll
        for (int np = 0; np < PC / 16; ++np) {
          uint32_t xb[4];
          hopper::ldmatrix_x4_trans(
              xb, xs + (size_t)(ks * 16 + ((mi & 1) << 3) + (lane & 7)) * PP +
                      c_lo + np * 16 + ((mi >> 1) << 3));
          hopper::mma_bf16_16816(acc[2 * np], ah, xb[0], xb[1]);
          hopper::mma_bf16_16816(acc[2 * np], al, xb[0], xb[1]);
          hopper::mma_bf16_16816(acc[2 * np + 1], ah, xb[2], xb[3]);
          hopper::mma_bf16_16816(acc[2 * np + 1], al, xb[2], xb[3]);
        }
      }
#pragma unroll
      for (int nt = 0; nt < PC / 8; ++nt) {
        const int p = c_lo + nt * 8 + 2 * t;
        const int n = mt * 16 + g;
        *reinterpret_cast<float2*>(out + (size_t)n * P + p) =
            make_float2(acc[nt][0], acc[nt][1]);
        *reinterpret_cast<float2*>(out + (size_t)(n + 8) * P + p) =
            make_float2(acc[nt][2], acc[nt][3]);
      }
    }
    if (threadIdx.x == 0) totals[((size_t)b * nc + c) * H + h] = total;
    __syncthreads();         // this x buffer is reused next
  }
}

// ---------------------------------------------------------------------------
// Pass 2: state passing (in place: S_c in, S_prev out)
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kPassThreads)
ssd_pass_kernel(float* __restrict__ states,        // (B, nc, H, N*P)
                const float* __restrict__ totals,  // (B, nc, H)
                const float* __restrict__ init,    // (B, H, P, N) or null
                float* __restrict__ final_state,   // (B, H, P, N) or null
                int nc, int H, int P, int N) {
  const int NPe = N * P;
  const int e = blockIdx.x * kPassThreads + threadIdx.x;
  if (e >= NPe) return;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t bh = (size_t)b * H + h;
  // Element e = n * P + p of the workspace's N x P state is element
  // p * N + n of the reference's P x N one.
  const int n = e / P;
  const size_t ref = bh * NPe + (size_t)(e - n * P) * N + n;
  float run = init != nullptr ? init[ref] : 0.f;
  const size_t step = (size_t)H * NPe;
  size_t idx = ((size_t)b * nc * H + h) * NPe + e;
  const float* tot = totals + (size_t)b * nc * H + h;
  // kPassBatch chunks' states are read (all in flight at once) before
  // any of them is written over.
  for (int c0 = 0; c0 < nc; c0 += kPassBatch) {
    float v[kPassBatch], d[kPassBatch];
#pragma unroll
    for (int k = 0; k < kPassBatch; ++k) {
      const bool in = c0 + k < nc;
      v[k] = in ? states[idx + k * step] : 0.f;
      d[k] = in ? __expf(tot[(size_t)(c0 + k) * H]) : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kPassBatch; ++k) {
      if (c0 + k < nc) {
        states[idx + k * step] = run;
        run = d[k] * run + v[k];
      }
    }
    idx += kPassBatch * step;
  }
  if (final_state != nullptr) final_state[ref] = run;
}

// ---------------------------------------------------------------------------
// Pass 3: outputs
// ---------------------------------------------------------------------------

template <int P>
__global__ void __launch_bounds__(kThreads, 1)
ssd_out_kernel(const __nv_bfloat16* __restrict__ x,   // (B, S, H, P)
               const float* __restrict__ dt,          // (B, S, H)
               const float* __restrict__ A,           // (H,)
               const __nv_bfloat16* __restrict__ Bm,  // (B, S, N)
               const __nv_bfloat16* __restrict__ Cm,  // (B, S, N)
               const float* __restrict__ prev,        // (B, nc, H, N, P)
               __nv_bfloat16* __restrict__ y,         // (B, S, H, P)
               int S, int H, int N, int Q, int HG) {
  constexpr int PP = P + kPad;
  const int panels = (Q + kPanel - 1) / kPanel;
  const int c = blockIdx.x / panels;
  const int rp = blockIdx.x - c * panels;
  const int nc = gridDim.x / panels;
  const int h0 = blockIdx.y * HG;
  const int b = blockIdx.z;
  const int c0 = c * Q;
  const int nq = min(Q, S - c0);
  const int R = panel_rows(Q);
  const int r0 = rp * kPanel;
  const int nr = min(kPanel, Q - r0);     // rows of this panel
  const int kc = r0 + nr;                 // columns it needs (causal)
  const int NN = N + kPad;
  const int QC = Q + 4;                   // row of the C.B^T panel
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int mi = lane >> 3;
  // The warp's 16-row tile.  Tile r has r + 1 column tiles of causal
  // work, and warps w and w + 4 share a scheduler: pairing tiles w and
  // 7 - w on it gives each scheduler the same work.
  const int rt = warp < 4 ? warp : 11 - warp;
  const bool rows_here = rt * 16 < nr;
  if (r0 >= nq) return;                   // the panel lies past the end

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sB = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // Q x NN
  __nv_bfloat16* sC = sB + (size_t)Q * NN;                         // R x NN
  __nv_bfloat16* sx = sC + (size_t)R * NN;                        // Q x PP
  __nv_bfloat16* sS = sx + (size_t)Q * PP;                  // 2 x N x PP
  __nv_bfloat16* sSlo = sS + (size_t)N * PP;
  float* sCB = reinterpret_cast<float*>(sS + 2 * (size_t)N * PP);  // R x QC
  float* sdt = sCB + (size_t)R * QC;                               // HG x Q
  float* scum = sdt + kMaxHeadsPerBlock * Q;                       // HG x Q

  const size_t row0 = (size_t)b * S + c0;
  stage_rows(sB, NN, Bm + row0 * N, N, kc, nq, N);
  stage_rows(sC, NN, Cm + (row0 + r0) * N, N, nr, nq - r0, N);
  hopper::cp_async_commit();
  load_head_dt(sdt, dt, row0, H, h0, HG, Q, kc, nq);
  hopper::cp_async_wait<0>();     // B and C are in
  __syncthreads();
  for (int hh = warp; hh < HG; hh += kWarps)
    chunk_cumsum(sdt + hh * Q, scum + hh * Q, kc, A[h0 + hh]);

  // C.B^T for this warp's 16 rows and the columns up to their diagonal,
  // once for all the block's heads (warp-private rows of sCB).
  const int i_lo = r0 + rt * 16;          // first chunk row of this warp
  if (rows_here) {
    for (int jn = 0; jn <= i_lo / 16; jn += 2) {
      const bool pair = jn + 1 <= i_lo / 16;   // warp-uniform
      float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      float sc2[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      for (int ks = 0; ks < N / 16; ++ks) {
        uint32_t af[4];
        hopper::ldmatrix_x4(
            af, sC + (size_t)(rt * 16 + ((mi & 1) << 3) + (lane & 7)) * NN +
                    ks * 16 + ((mi >> 1) << 3));
        uint32_t bb[4];
        hopper::ldmatrix_x4(
            bb, sB + (size_t)(jn * 16 + ((mi >> 1) << 3) + (lane & 7)) * NN +
                    ks * 16 + ((mi & 1) << 3));
        hopper::mma_bf16_16816(sc[0], af, bb[0], bb[1]);
        hopper::mma_bf16_16816(sc[1], af, bb[2], bb[3]);
        if (pair) {
          hopper::ldmatrix_x4(
              bb, sB + (size_t)((jn + 1) * 16 + ((mi >> 1) << 3) +
                                (lane & 7)) * NN +
                      ks * 16 + ((mi & 1) << 3));
          hopper::mma_bf16_16816(sc2[0], af, bb[0], bb[1]);
          hopper::mma_bf16_16816(sc2[1], af, bb[2], bb[3]);
        }
      }
      float* r_lo = sCB + (size_t)(rt * 16 + g) * QC;
      float* r_hi = r_lo + 8 * QC;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int j = jn * 16 + nt * 8 + 2 * t;
        *reinterpret_cast<float2*>(r_lo + j) =
            make_float2(sc[nt][0], sc[nt][1]);
        *reinterpret_cast<float2*>(r_hi + j) =
            make_float2(sc[nt][2], sc[nt][3]);
        if (pair) {
          *reinterpret_cast<float2*>(r_lo + j + 16) =
              make_float2(sc2[nt][0], sc2[nt][1]);
          *reinterpret_cast<float2*>(r_hi + j + 16) =
              make_float2(sc2[nt][2], sc2[nt][3]);
        }
      }
    }
  }

  const int i0 = i_lo + g;          // this thread's two chunk rows
  const int i1 = i0 + 8;
  // The next head's x rows and S_prev are loaded into registers (the first
  // kPrefetch 16-byte vectors of each a thread owns) while this head's
  // products run, and land in shared memory after them; any rest is
  // copied when the head starts.
  constexpr int kVecRow = P / 8;    // 16-byte vectors of one x row
  const int x_vecs = kc * kVecRow;
  const int s_vecs = N * P / 4;     // float4 of S_prev
  uint4 xpre[kPrefetch];
  float4 spre[kPrefetch];
  auto prefetch = [&](int h) {
    const __nv_bfloat16* xh = x + (row0 * H + h) * P;
    const float* sp = prev + (((size_t)b * nc + c) * H + h) * N * P;
#pragma unroll
    for (int k = 0; k < kPrefetch; ++k) {
      const int v = threadIdx.x + k * kThreads;
      const int r = v / kVecRow;
      xpre[k] = v < x_vecs && r < nq
                    ? *reinterpret_cast<const uint4*>(
                          xh + (size_t)r * H * P + (v - r * kVecRow) * 8)
                    : make_uint4(0u, 0u, 0u, 0u);
      spre[k] = v < s_vecs ? *reinterpret_cast<const float4*>(sp + 4 * v)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  auto put_s = [&](int i, const float4& v) {   // S_prev as hi + lo bf16
    const int n = (4 * i) / P;
    const int p = 4 * i - n * P;
    uint2 ph, pl;
    split_pair(v.x, v.y, ph.x, pl.x);
    split_pair(v.z, v.w, ph.y, pl.y);
    *reinterpret_cast<uint2*>(sS + (size_t)n * PP + p) = ph;
    *reinterpret_cast<uint2*>(sSlo + (size_t)n * PP + p) = pl;
  };
  prefetch(h0);
  for (int hi = 0; hi < HG; ++hi) {
    const int h = h0 + hi;
    const __nv_bfloat16* xs = sx;
#pragma unroll
    for (int k = 0; k < kPrefetch; ++k) {
      const int v = threadIdx.x + k * kThreads;
      if (v < x_vecs) {
        const int r = v / kVecRow;
        *reinterpret_cast<uint4*>(sx + (size_t)r * PP +
                                  (v - r * kVecRow) * 8) = xpre[k];
      }
      if (v < s_vecs) put_s(v, spre[k]);
    }
    const __nv_bfloat16* xh = x + (row0 * H + h) * P;
    for (int v = threadIdx.x + kPrefetch * kThreads; v < x_vecs;
         v += kThreads) {
      const int r = v / kVecRow;
      __nv_bfloat16* d = sx + (size_t)r * PP + (v - r * kVecRow) * 8;
      if (r < nq)
        hopper::cp_async_16(d, xh + (size_t)r * H * P + (v - r * kVecRow) * 8);
      else
        *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    }
    hopper::cp_async_commit();
    const float* sp = prev + (((size_t)b * nc + c) * H + h) * N * P;
    for (int i = threadIdx.x + kPrefetch * kThreads; i < s_vecs;
         i += kThreads)
      put_s(i, *reinterpret_cast<const float4*>(sp + 4 * (size_t)i));
    const float* hdt = sdt + hi * Q;
    const float* hcum = scum + hi * Q;
    hopper::cp_async_wait<0>();
    __syncthreads();
    if (hi + 1 < HG) prefetch(h + 1);   // in flight during the products

    if (rows_here) {
      float acc[P / 8][4];
#pragma unroll
      for (int i = 0; i < P / 8; ++i)
        acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
      // Inter-chunk: C S_prev, then each row scaled by exp(cum_i).
      for (int ks = 0; ks < N / 16; ++ks) {
        uint32_t af[4];
        hopper::ldmatrix_x4(
            af, sC + (size_t)(rt * 16 + ((mi & 1) << 3) + (lane & 7)) * NN +
                    ks * 16 + ((mi >> 1) << 3));
#pragma unroll
        for (int np = 0; np < P / 16; ++np) {
          const size_t off =
              (size_t)(ks * 16 + ((mi & 1) << 3) + (lane & 7)) * PP +
              np * 16 + ((mi >> 1) << 3);
          uint32_t sb[4], sl[4];
          hopper::ldmatrix_x4_trans(sb, sS + off);
          hopper::ldmatrix_x4_trans(sl, sSlo + off);
          hopper::mma_bf16_16816(acc[2 * np], af, sb[0], sb[1]);
          hopper::mma_bf16_16816(acc[2 * np], af, sl[0], sl[1]);
          hopper::mma_bf16_16816(acc[2 * np + 1], af, sb[2], sb[3]);
          hopper::mma_bf16_16816(acc[2 * np + 1], af, sl[2], sl[3]);
        }
      }
      const float cum0 = hcum[i0], cum1 = hcum[i1];
      const float e0 = __expf(cum0), e1 = __expf(cum1);
#pragma unroll
      for (int i = 0; i < P / 8; ++i) {
        acc[i][0] *= e0;
        acc[i][1] *= e0;
        acc[i][2] *= e1;
        acc[i][3] *= e1;
      }
      // Intra-chunk: W x with W[i][j] = CB[i][j] exp(cum_i - cum_j) dt_j
      // for j <= i, over the column tiles up to the diagonal.
      const float* cb0 = sCB + (size_t)(rt * 16 + g) * QC;
      const float* cb1 = cb0 + 8 * QC;
      for (int jn = 0; jn <= i_lo / 16; ++jn) {
        float w[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int j = jn * 16 + 2 * t + (e & 1) + ((e >> 2) << 3);
          const int i = (e & 2) ? i1 : i0;
          const float cb = (e & 2) ? cb1[j] : cb0[j];
          const float ci = (e & 2) ? cum1 : cum0;
          w[e] = j <= i ? cb * __expf(ci - hcum[j]) * hdt[j] : 0.f;
        }
        uint32_t ah[4], al[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) split_pair(w[2 * r], w[2 * r + 1], ah[r], al[r]);
#pragma unroll
        for (int np = 0; np < P / 16; ++np) {
          uint32_t xb[4];
          hopper::ldmatrix_x4_trans(
              xb, xs + (size_t)(jn * 16 + ((mi & 1) << 3) + (lane & 7)) * PP +
                      np * 16 + ((mi >> 1) << 3));
          hopper::mma_bf16_16816(acc[2 * np], ah, xb[0], xb[1]);
          hopper::mma_bf16_16816(acc[2 * np], al, xb[0], xb[1]);
          hopper::mma_bf16_16816(acc[2 * np + 1], ah, xb[2], xb[3]);
          hopper::mma_bf16_16816(acc[2 * np + 1], al, xb[2], xb[3]);
        }
      }
#pragma unroll
      for (int nt = 0; nt < P / 8; ++nt) {
        const int p = nt * 8 + 2 * t;
        if (i0 < nq)
          *reinterpret_cast<uint32_t*>(y + ((row0 + i0) * H + h) * P + p) =
              hopper::pack_bf16(acc[nt][0], acc[nt][1]);
        if (i1 < nq)
          *reinterpret_cast<uint32_t*>(y + ((row0 + i1) * H + h) * P + p) =
              hopper::pack_bf16(acc[nt][2], acc[nt][3]);
      }
    }
    __syncthreads();         // S_prev and x are reused
  }
}

template <int P>
int launch_p(const void* x, const float* dt, const float* A, const void* Bm,
             const void* Cm, void* y, float* states, float* totals,
             const float* init, float* final_state, int Bsz, int S, int H,
             int N, int Q, int HG, cudaStream_t stream) {
  const int nc = (S + Q - 1) / Q;
  const int panels = (Q + kPanel - 1) / kPanel;
  const size_t smem1 = pass1_bytes(Q, P, N);
  const size_t smem3 = pass3_bytes(Q, P, N);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_states_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem1);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_out_kernel<P>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem3);
  if (err != cudaSuccess) return (int)err;
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* bb = static_cast<const __nv_bfloat16*>(Bm);
  ssd_states_kernel<P><<<dim3(nc, H / HG, Bsz), kThreads, smem1, stream>>>(
      xb, dt, A, bb, states, totals, S, H, N, Q, HG);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int npe = N * P;
  ssd_pass_kernel<<<dim3((npe + kPassThreads - 1) / kPassThreads, H, Bsz),
                    kPassThreads, 0, stream>>>(states, totals, init,
                                               final_state, nc, H, P, N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ssd_out_kernel<P><<<dim3(nc * panels, H / HG, Bsz), kThreads, smem3,
                      stream>>>(xb, dt, A, bb,
                                static_cast<const __nv_bfloat16*>(Cm), states,
                                static_cast<__nv_bfloat16*>(y), S, H, N, Q,
                                HG);
  return (int)cudaGetLastError();
}

int launch_tc(const void* x, const void* dt, const void* A, const void* Bm,
              const void* Cm, void* y, void* states, void* totals,
              const float* init, float* final_state, int Bsz, int S, int H,
              int P, int N, int Q, int sms, cudaStream_t stream) {
  const int HG = heads_per_block(H, (long)Bsz * ((S + Q - 1) / Q), sms);
  const float* d = static_cast<const float*>(dt);
  const float* a = static_cast<const float*>(A);
  float* st = static_cast<float*>(states);
  float* tot = static_cast<float*>(totals);
  switch (P) {
    case 16:
      return launch_p<16>(x, d, a, Bm, Cm, y, st, tot, init, final_state,
                          Bsz, S, H, N, Q, HG, stream);
    case 32:
      return launch_p<32>(x, d, a, Bm, Cm, y, st, tot, init, final_state,
                          Bsz, S, H, N, Q, HG, stream);
    case 64:
      return launch_p<64>(x, d, a, Bm, Cm, y, st, tot, init, final_state,
                          Bsz, S, H, N, Q, HG, stream);
    case 128:
      return launch_p<128>(x, d, a, Bm, Cm, y, st, tot, init, final_state,
                           Bsz, S, H, N, Q, HG, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace tc

extern "C" {

// Bytes of shared memory one block needs at chunk Q: the simt body's one
// block (path 0), or the largest block of the tc body's passes (path 1).
size_t ssd_scan_smem_bytes(int Q, int P, int N, int path) {
  if (path == 1) return tc::smem_bytes(Q, P, N);
  return simt::smem_floats(Q, P, N) * sizeof(float);
}

// dtype (of x, B, C and y): 0 = float32, 1 = bfloat16; dt and A are
// float32.  path: 0 = simt, 1 = tc (bf16 only; states (B, nc, H, N, P)
// and totals (B, nc, H) are its float32 workspace).  init and final are
// null or (B, H, P, N) float32: the state before the first step, and the
// state after the last one.  All pointers are device pointers on
// `device`.
int ssd_scan_fwd(const void* x, const void* dt, const void* A,
                 const void* Bm, const void* Cm, void* y, void* states,
                 void* totals, const void* init, void* final_state, int Bsz,
                 int S, int H, int P, int N, int Q, int dtype, int path,
                 int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* in = static_cast<const float*>(init);
  float* out = static_cast<float*>(final_state);
  if (path == 1) {
    int sms = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
    if (err != cudaSuccess) return (int)err;
    return tc::launch_tc(x, dt, A, Bm, Cm, y, states, totals, in, out, Bsz,
                         S, H, P, N, Q, sms, st);
  }
  if (dtype == 1)
    return simt::launch_simt<__nv_bfloat16>(x, dt, A, Bm, Cm, y, in, out, Bsz,
                                            S, H, P, N, Q, st);
  return simt::launch_simt<float>(x, dt, A, Bm, Cm, y, in, out, Bsz, S, H, P,
                                  N, Q, st);
}

}  // extern "C"
