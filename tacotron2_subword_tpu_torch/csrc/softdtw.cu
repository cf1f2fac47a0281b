// K2 and K3: batched soft-DTW on a distance matrix D [B, N, M] (f32).
//
//   R[i,j] = D[i,j] + softmin_gamma(R[i-1,j], R[i,j-1], R[i-1,j-1]),
//   R[-1,-1] = 0, every other edge +INF, value = R[N-1, M-1];
//   softmin_gamma(a,b,c) = -gamma * logsumexp(-a/gamma, -b/gamma, -c/gamma).
//
// Cells outside the Sakoe-Chiba band (|i-j| > bandwidth, bandwidth > 0) are
// dead: R = +INF.  INF is the finite sentinel 1e30, as in the JAX package,
// so only f32 is taken.
//
// K2 t2s_softdtw_grad: value [B] and E = d value / d D [B, N, M] in one
//   launch.  Replaces the Pallas TPU kernel softdtw_pallas_grad
//   (tacotron2_subword_tpu/ops/softdtw.py:357).  The forward wavefront keeps
//   all of R in a bordered [N+2, M+2] array whose borders are +INF (row 0,
//   column 0; R(0,0) = 0 seeds the origin) and -INF (row N+1, column M+1:
//   the backward's off-grid successors).  The reverse wavefront then gives
//   E[i,j] = sum over the successors s of (i,j) of
//   E[s] * exp((R[s] - R[i,j] - D[s]) / gamma), seeded with E[N-1,M-1] = 1;
//   dead R read as -INF, and a dead cell gets E = 0 after the sum, so no
//   exp(-INF - -INF) leaks a NaN.  Two variants, one body:
//    - shared (D, R and E fit in a block's 227 KB, e.g. 128 x 128: 194 KB):
//      D[b] is copied into shared memory once, coalesced; R and E live
//      there for both wavefronts, and E goes to device memory once at the
//      end, coalesced.  Cell (i, p-i) of a diagonal sits at i*(S-1) + p for
//      a row stride S, so every stride is even (S-1 odd): the threads of a
//      diagonal hit 32 distinct banks.
//    - global (larger shapes, e.g. the 256 x 256 CLI bucket): R in a
//      caller-given workspace [B, N+2, M+2], D and E read in place.
//   The host (ops/softdtw.py k2_plan) picks the variant.  In both, the
//   successor weights w = exp((R[s] - R[i,j] - D[s]) / gamma) of the
//   reverse wavefront need R and D only: spare warps compute them for the
//   next `chunk` diagonals into a double buffer [2][chunk][3][N] while the
//   wavefront warps run the current chunk, so the serial chain that carries
//   E is three products and two sums per diagonal.
// K3 t2s_softdtw_fwd: the value only.  Replaces softdtw_pallas
//   (tacotron2_subword_tpu/ops/softdtw.py:507).  Three rotating diagonals of
//   R live in shared memory (3 * (N+1) floats); nothing but the value goes
//   to device memory.
//
// gamma a power of two (the training default is 1): x / gamma and
// x * (1 / gamma) are the same correctly rounded number, so the kernels
// multiply (template POW2) and stay bit-equal to the plain version.
//
// Design: one block per batch row, as in the reference numba kernel; the
// threads of the block take the rows of an anti-diagonal (looping when a
// diagonal is longer than the block) and meet at one barrier per
// diagonal.  K2's block has up to 384 threads more than a diagonal has
// cells: the extra warps copy and compute the weights, and sit out the
// wavefronts (named barrier 1 holds only the wavefront warps).  The TPU kernels' skewed layout, lane padding and batch blocks
// served the TPU's vector unit only and are not carried over.
//
// Bound on an H100 SXM: each cell costs 4 transcendentals forward (3 exp,
// 1 log) and 3 exp backward; reading D and writing E once is 8 bytes a cell.
// At B=8, N=M=128 both come to well under a microsecond of the card's
// throughput; what rules is the serial chain of N+M-1 diagonals (twice that
// for K2), each a barrier plus a memory round trip (shared memory in the
// shared variant, L1/L2 in the global one), on only B of the 132 SMs.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

extern __shared__ float k2_smem[];  // K2's dynamic shared memory

namespace {

constexpr float kInf = 1e30f;

// x / gamma; with POW2, x * inv (== x / gamma exactly for gamma = 2^k)
template <bool POW2>
__device__ __forceinline__ float div_gamma(float x, float gamma, float inv) {
  return POW2 ? x * inv : x / gamma;
}

template <bool POW2>
__device__ __forceinline__ float softmin3(float a, float b, float c,
                                          float gamma, float inv) {
  const float r0 = div_gamma<POW2>(-a, gamma, inv);
  const float r1 = div_gamma<POW2>(-b, gamma, inv);
  const float r2 = div_gamma<POW2>(-c, gamma, inv);
  const float rmax = fmaxf(fmaxf(r0, r1), r2);
  const float rsum = __fadd_rn(__fadd_rn(expf(r0 - rmax), expf(r1 - rmax)),
                               expf(r2 - rmax));
  return -gamma * (logf(rsum) + rmax);
}

__device__ __forceinline__ bool banned(int i, int j, float bandwidth) {
  return bandwidth > 0.f && fabsf((float)(i - j)) > bandwidth;
}

// Weight of one successor in the backward sum: exp((r_s - r - d_s) /
// gamma), with r_s already -INF where the successor is dead or off the grid.
template <bool POW2>
__device__ __forceinline__ float succ_weight(float r_s, float d_s, float r,
                                             float gamma, float inv) {
  return expf(div_gamma<POW2>(r_s - r - d_s, gamma, inv));
}

__device__ __forceinline__ float live_or_neg_inf(float r) {
  return r >= 0.5f * kInf ? -kInf : r;
}

__device__ __forceinline__ float dead_to_zero(float d) {
  return d >= 0.5f * kInf ? 0.f : d;
}

// Row strides of the shared variant: even, so that stride - 1 is odd.
__host__ __device__ __forceinline__ int even_stride(int n) { return n + (n & 1); }

// Copy a rows x cols block of floats from src (row stride ls) to dst (row
// stride ld), with many loads in flight: as float4 where both are one
// dense, 16-byte aligned block.
__device__ __forceinline__ void copy_rows(float* dst, int ld, const float* src,
                                          int ls, int rows, int cols) {
  const int n = rows * cols;
  if (ld == cols && ls == cols && n % 4 == 0 &&
      (uintptr_t)src % 16 == 0 && (uintptr_t)dst % 16 == 0) {
    float4* d4 = reinterpret_cast<float4*>(dst);
    const float4* s4 = reinterpret_cast<const float4*>(src);
#pragma unroll 8
    for (int k = threadIdx.x; k < n / 4; k += blockDim.x) d4[k] = s4[k];
    return;
  }
  for (int i = 0; i < rows; ++i)
    for (int j = threadIdx.x; j < cols; j += blockDim.x)
      dst[(size_t)i * ld + j] = src[(size_t)i * ls + j];
}

// The first `work` threads (whole warps) run the wavefronts and meet at
// named barrier 1; the whole block copies and computes the weights.
__device__ __forceinline__ void sync_work(int work) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(work) : "memory");
}

// smem: the shared variant's D, R, E (see t2s_softdtw_grad_smem_bytes),
// then the weight buffer [2][chunk][3][N]; the global variant's smem is
// that buffer alone.
template <bool kShared, bool POW2>
__global__ void softdtw_grad_kernel(const float* __restrict__ D,
                                    float* __restrict__ R_ws,
                                    float* __restrict__ E,
                                    float* __restrict__ value, int N, int M,
                                    float gamma, float bandwidth, int work,
                                    int chunk) {
  using idx = typename std::conditional<kShared, int, size_t>::type;
  const float inv = 1.f / gamma;
  const int tid = threadIdx.x;
  const int b = blockIdx.x;
  const int P = N + M - 1;
  const float* Dg = D + (size_t)b * N * M;
  float* Eg = E + (size_t)b * N * M;
  // views: D and E with row stride sd, R (bordered) with row stride W, and
  // the weight buffer, always in shared memory
  const float* Db;
  float* Rb;
  float* Eb;
  float* wbuf;
  int sd, W;
  if constexpr (kShared) {
    sd = even_stride(M);
    W = even_stride(M + 2);
    Rb = k2_smem + N * sd;
    Eb = Rb + (N + 2) * W;
    wbuf = Eb + N * sd;
    copy_rows(k2_smem, sd, Dg, M, N, M);
    Db = k2_smem;
  } else {
    sd = M;
    W = M + 2;
    Db = Dg;
    Rb = R_ws + (size_t)b * (N + 2) * W;
    Eb = Eg;
    wbuf = k2_smem;
  }

  // borders; cell (i, j) lives at R (i+1, j+1)
  for (int c = tid; c < M + 2; c += blockDim.x) {
    Rb[c] = c == 0 ? 0.f : kInf;
    Rb[(idx)(N + 1) * W + c] = -kInf;
  }
  for (int r = tid + 1; r <= N; r += blockDim.x) {
    Rb[(idx)r * W] = kInf;
    Rb[(idx)r * W + M + 1] = -kInf;
  }
  __syncthreads();

  // forward wavefront: diagonal p holds the cells with i + j = p
  if (tid < work) {
    for (int p = 0; p < P; ++p) {
      const int i_lo = max(0, p - M + 1), i_hi = min(N - 1, p);
      for (int i = i_lo + tid; i <= i_hi; i += work) {
        const int j = p - i;
        float r = kInf;
        const float d = Db[(idx)i * sd + j];
        if (!banned(i, j, bandwidth) && d < 0.5f * kInf) {
          const float up = Rb[(idx)i * W + j + 1];    // (i-1, j)
          const float left = Rb[(idx)(i + 1) * W + j];  // (i, j-1)
          const float diag = Rb[(idx)i * W + j];      // (i-1, j-1)
          r = d + softmin3<POW2>(up, left, diag, gamma, inv);
        }
        Rb[(idx)(i + 1) * W + j + 1] = r;
      }
      sync_work(work);
    }
  }
  __syncthreads();
  if (tid == 0) value[b] = Rb[(idx)N * W + M];

  // Reverse wavefront, `chunk` diagonals at a time.  The weights of a
  // cell's successors a = (i+1, j), b = (i, j+1), c = (i+1, j+1) need R and
  // D only.  While the wavefront warps run the chain of E over chunk q
  // (three products and two sums per cell and diagonal), the other warps
  // make the weights of chunk q+1 into the other half of a double buffer,
  // wbuf[((q % 2) chunk + d) 3N + k N + i] for diagonal P-1 - q chunk - d.
  // With no spare warps, the whole block makes them between chunks.
  const int nchunk = (P + chunk - 1) / chunk;
  auto make_weights = [&](int q, int t, int stride) {
    const int p_hi = P - 1 - q * chunk, p_lo = max(0, p_hi - chunk + 1);
    float* w0 = wbuf + (q & 1) * chunk * 3 * N;
    for (int c = t; c < (p_hi - p_lo + 1) * N; c += stride) {
      const int dd = c / N, i = c - dd * N, j = p_hi - dd - i;
      if (j < 0 || j >= M) continue;
      const float r = Rb[(idx)(i + 1) * W + j + 1];
      const bool down = i + 1 < N, right = j + 1 < M;
      const float ra = live_or_neg_inf(Rb[(idx)(i + 2) * W + j + 1]);
      const float rb = live_or_neg_inf(Rb[(idx)(i + 1) * W + j + 2]);
      const float rc = live_or_neg_inf(Rb[(idx)(i + 2) * W + j + 2]);
      const float da = down && !banned(i + 1, j, bandwidth)
                           ? dead_to_zero(Db[(idx)(i + 1) * sd + j]) : 0.f;
      const float db = right && !banned(i, j + 1, bandwidth)
                           ? dead_to_zero(Db[(idx)i * sd + j + 1]) : 0.f;
      const float dc = down && right && !banned(i + 1, j + 1, bandwidth)
                           ? dead_to_zero(Db[(idx)(i + 1) * sd + j + 1]) : 0.f;
      float* w = w0 + dd * 3 * N + i;
      w[0] = succ_weight<POW2>(ra, da, r, gamma, inv);
      w[N] = succ_weight<POW2>(rb, db, r, gamma, inv);
      w[2 * N] = succ_weight<POW2>(rc, dc, r, gamma, inv);
    }
  };
  const int helpers = blockDim.x - work;
  make_weights(0, tid, blockDim.x);
  __syncthreads();
  for (int q = 0; q < nchunk; ++q) {
    const int p_hi = P - 1 - q * chunk, p_lo = max(0, p_hi - chunk + 1);
    if (tid < work) {
      for (int p = p_hi; p >= p_lo; --p) {
        const float* wp = wbuf + ((q & 1) * chunk + p_hi - p) * 3 * N;
        const int i_lo = max(0, p - M + 1), i_hi = min(N - 1, p);
        for (int i = i_lo + tid; i <= i_hi; i += work) {
          const int j = p - i;
          const float r = Rb[(idx)(i + 1) * W + j + 1];
          float e = 0.f;
          if (r < 0.5f * kInf) {
            const bool down = i + 1 < N, right = j + 1 < M;
            const float ea = down ? Eb[(idx)(i + 1) * sd + j] : 0.f;
            const float eb = right ? Eb[(idx)i * sd + j + 1] : 0.f;
            const float ec = down && right ? Eb[(idx)(i + 1) * sd + j + 1]
                                           : 0.f;
            e = __fadd_rn(__fadd_rn(__fmul_rn(ea, wp[i]),
                                    __fmul_rn(eb, wp[N + i])),
                          __fmul_rn(ec, wp[2 * N + i]));
            if (i == N - 1 && j == M - 1) e = 1.f;
          }
          Eb[(idx)i * sd + j] = e;
        }
        sync_work(work);
      }
    } else if (q + 1 < nchunk) {
      make_weights(q + 1, tid - work, helpers);
    }
    __syncthreads();  // chunk q's E is written, chunk q+1's weights made
    if (helpers == 0 && q + 1 < nchunk) {
      make_weights(q + 1, tid, blockDim.x);
      __syncthreads();
    }
  }

  if constexpr (kShared)  // E to device memory once, coalesced
    copy_rows(Eg, M, Eb, sd, N, M);
}

template <bool POW2>
__global__ void softdtw_fwd_kernel(const float* __restrict__ D,
                                   float* __restrict__ value, int N, int M,
                                   float gamma, float bandwidth) {
  extern __shared__ float diag[];  // 3 rotating diagonals of N+1 slots
  // slot s of a diagonal holds row s-1; slot 0 is the +INF row above the grid
  const int b = blockIdx.x;
  const int P = N + M - 1;
  const int S = N + 1;
  const float* Db = D + (size_t)b * N * M;
  const float inv = 1.f / gamma;
  for (int k = threadIdx.x; k < 3 * S; k += blockDim.x) diag[k] = kInf;
  __syncthreads();

  for (int p = 0; p < P; ++p) {
    float* cur = diag + (p % 3) * S;
    const float* prev1 = diag + ((p + 2) % 3) * S;  // diagonal p-1
    const float* prev2 = diag + ((p + 1) % 3) * S;  // diagonal p-2
    // every row is written, the off-grid ones with +INF, so the next two
    // diagonals read +INF there
    for (int i = threadIdx.x; i < N; i += blockDim.x) {
      const int j = p - i;
      float r = kInf;
      if (j >= 0 && j < M) {
        const float d = Db[(size_t)i * M + j];
        if (!banned(i, j, bandwidth) && d < 0.5f * kInf) {
          const float up = prev1[i];        // (i-1, j)
          const float left = prev1[i + 1];  // (i, j-1)
          const float dg = (p == 0 && i == 0) ? 0.f : prev2[i];  // (i-1, j-1)
          r = d + softmin3<POW2>(up, left, dg, gamma, inv);
        }
      }
      cur[i + 1] = r;
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) value[b] = diag[((P - 1) % 3) * S + N];
}

int block_threads(int rows) {
  const int t = ((rows + 31) / 32) * 32;
  return t < 32 ? 32 : (t > 1024 ? 1024 : t);
}

bool is_pow2(float g) {
  int e;
  return g > 0.f && isfinite(g) && frexpf(g, &e) == 0.5f;
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, int B, size_t smem, cudaStream_t st,
                   const float* D, float* R_ws, float* E, float* value, int N,
                   int M, float gamma, float bandwidth, int chunk) {
  // the wavefront warps, and 384 helper threads beside them where the
  // block has room for them (512 threads at least)
  const int work = block_threads(N < M ? N : M);
  const int threads = work + 384 > 1024 ? work
                      : work + 384 < 512 ? 512 : work + 384;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<B, threads, smem, st>>>(D, R_ws, E, value, N, M, gamma, bandwidth,
                                   work, chunk);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of shared memory K2 needs for an N x M problem with the weights of
// `chunk` diagonals at a time, double-buffered ([2, chunk, 3, N] f32): the
// shared variant adds D and E [N, even(M)] and the bordered R
// [N+2, even(M+2)].
long long t2s_softdtw_grad_smem_bytes(int N, int M, int chunk, int shared) {
  const long long w = 24LL * N * chunk;
  if (!shared) return w;
  return w + 4LL * (2LL * N * even_stride(M) +
                    (long long)(N + 2) * even_stride(M + 2));
}

// K2.  D [B,N,M], E [B,N,M] and value [B]: all f32 and contiguous on the
// current device.  shared != 0 picks the shared variant (R_ws is not used
// and may be null), 0 the global one with R_ws [B, N+2, M+2] scratch;
// smem_bytes must equal t2s_softdtw_grad_smem_bytes(N, M, chunk, shared).
// Launches on `stream`, returns a CUDA error code.
int t2s_softdtw_grad(const float* D, float* R_ws, float* E, float* value,
                     int B, int N, int M, float gamma, float bandwidth,
                     int shared, int chunk, long long smem_bytes,
                     void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (chunk < 1 || smem_bytes != t2s_softdtw_grad_smem_bytes(N, M, chunk, shared) ||
      (!shared && R_ws == nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)smem_bytes;
  cudaError_t err;
  if (is_pow2(gamma))
    err = shared ? launch(softdtw_grad_kernel<true, true>, B, smem, st, D,
                          nullptr, E, value, N, M, gamma, bandwidth, chunk)
                 : launch(softdtw_grad_kernel<false, true>, B, smem, st, D,
                          R_ws, E, value, N, M, gamma, bandwidth, chunk);
  else
    err = shared ? launch(softdtw_grad_kernel<true, false>, B, smem, st, D,
                          nullptr, E, value, N, M, gamma, bandwidth, chunk)
                 : launch(softdtw_grad_kernel<false, false>, B, smem, st, D,
                          R_ws, E, value, N, M, gamma, bandwidth, chunk);
  return (int)err;
}

// K3.  D [B,N,M] -> value [B], f32, contiguous.  N is bounded by shared
// memory: 3 * (N+1) floats must fit in a block's 227 KB (N <= 19369).
int t2s_softdtw_fwd(const float* D, float* value, int B, int N, int M,
                    float gamma, float bandwidth, void* stream) {
  const size_t smem = 3 * (size_t)(N + 1) * sizeof(float);
  auto kernel = is_pow2(gamma) ? softdtw_fwd_kernel<true>
                               : softdtw_fwd_kernel<false>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<B, block_threads(N), smem, (cudaStream_t)stream>>>(
      D, value, N, M, gamma, bandwidth);
  return (int)cudaGetLastError();
}

const char* t2s_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
