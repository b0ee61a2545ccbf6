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
// with the float32 state S (N x P) carried from chunk to chunk.  It
// returns y only, as the Pallas kernel does.
//
// What bounds it on an H100: bytes.  Each element of x, y, dt, B and C
// crosses HBM once, against O(Q) flops per element at the planned chunk.
//
// What this simple design does about that: one thread block per
// (batch, head).  The TPU's sequential chunk dimension becomes a loop
// inside the block, and the state stays in shared memory for the whole
// sequence, so nothing but x, dt, B, C and y touches HBM.  Each chunk is
// staged once (float32 in shared memory; zeros past a ragged final chunk,
// which is masked, not padded in memory) and the decay-weighted score
// tile (Q x Q) is formed in shared memory once and used for all P columns
// of y.  Occupancy is the known limit: at zamba2-1.2b's width with batch 1
// that is 64 blocks for 132 SMs; splitting the sequence across blocks (a
// second pass over the chunk states) is left to a later PR, as are tensor
// cores for the three products.
//
// Interface: a plain C function (no PyTorch headers), loaded with ctypes.
// It launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

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

  for (int i = tid; i < N * P; i += kThreads) sS[i] = 0.f;
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
}

template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, void* y, int Bsz, int S, int H, int P, int N,
           int Q, cudaStream_t stream) {
  const size_t smem = smem_floats(Q, P, N) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  ssd_scan_kernel<T><<<Bsz * H, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<T*>(y), S, H, P, N, Q);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of shared memory one block needs at chunk Q.
size_t ssd_scan_smem_bytes(int Q, int P, int N) {
  return smem_floats(Q, P, N) * sizeof(float);
}

// dtype (of x, B, C and y): 0 = float32, 1 = bfloat16; dt and A are
// float32.  All pointers are device pointers on `device`.
int ssd_scan_fwd(const void* x, const void* dt, const void* A,
                 const void* Bm, const void* Cm, void* y, int Bsz, int S,
                 int H, int P, int N, int Q, int dtype, int device,
                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dt, A, Bm, Cm, y, Bsz, S, H, P, N, Q,
                                 st);
  return launch<float>(x, dt, A, Bm, Cm, y, Bsz, S, H, P, N, Q, st);
}

}  // extern "C"
