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
//   (tacotron2_subword_tpu/ops/softdtw.py:357).  The forward wavefront writes
//   all of R to a caller-given workspace [B, N+2, M+2] whose borders are
//   +INF (row 0, column 0; R(0,0) = 0 seeds the origin) and -INF (row N+1,
//   column M+1: the backward's off-grid successors).  The reverse wavefront
//   then gives E[i,j] = sum over the successors s of (i,j) of
//   E[s] * exp((R[s] - R[i,j] - D[s]) / gamma), seeded with E[N-1,M-1] = 1;
//   dead R read as -INF, and a dead cell gets E = 0 after the sum, so no
//   exp(-INF - -INF) leaks a NaN.
// K3 t2s_softdtw_fwd: the value only.  Replaces softdtw_pallas
//   (tacotron2_subword_tpu/ops/softdtw.py:507).  Three rotating diagonals of
//   R live in shared memory (3 * (N+1) floats); nothing but the value goes
//   to device memory.
//
// Design: one block per batch row, as in the reference numba kernel; the
// threads of the block take the rows of an anti-diagonal (looping when a
// diagonal is longer than the block) and meet at one __syncthreads() per
// diagonal.  The TPU kernels' skewed layout, lane padding and batch blocks
// served the TPU's vector unit only and are not carried over.
//
// Bound on an H100 SXM: each cell costs 4 transcendentals forward (3 exp,
// 1 log) and 3 exp backward; reading D and writing E once is 8 bytes a cell.
// At B=8, N=M=128 both come to well under a microsecond of the card's
// throughput; what rules is the serial chain of N+M-1 diagonals (twice that
// for K2), each a barrier plus an L1/L2 round trip, on only B of the 132 SMs.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kInf = 1e30f;

__device__ __forceinline__ float softmin3(float a, float b, float c,
                                          float gamma) {
  const float r0 = -a / gamma, r1 = -b / gamma, r2 = -c / gamma;
  const float rmax = fmaxf(fmaxf(r0, r1), r2);
  const float rsum = __fadd_rn(__fadd_rn(expf(r0 - rmax), expf(r1 - rmax)),
                               expf(r2 - rmax));
  return -gamma * (logf(rsum) + rmax);
}

__device__ __forceinline__ bool banned(int i, int j, float bandwidth) {
  return bandwidth > 0.f && fabsf((float)(i - j)) > bandwidth;
}

// One term of the backward sum: e_s * exp((r_s - r - d_s) / gamma), with r_s
// already -INF where the successor is dead or off the grid.
__device__ __forceinline__ float succ_term(float e_s, float r_s, float d_s,
                                           float r, float gamma) {
  return __fmul_rn(e_s, expf((r_s - r - d_s) / gamma));
}

__device__ __forceinline__ float live_or_neg_inf(float r) {
  return r >= 0.5f * kInf ? -kInf : r;
}

__device__ __forceinline__ float dead_to_zero(float d) {
  return d >= 0.5f * kInf ? 0.f : d;
}

__global__ void softdtw_grad_kernel(const float* __restrict__ D,
                                    float* __restrict__ R,
                                    float* __restrict__ E,
                                    float* __restrict__ value, int N, int M,
                                    float gamma, float bandwidth) {
  const int b = blockIdx.x;
  const int P = N + M - 1;
  const int W = M + 2;  // row stride of the workspace
  const float* Db = D + (size_t)b * N * M;
  float* Rb = R + (size_t)b * (N + 2) * W;
  float* Eb = E + (size_t)b * N * M;

  // borders; cell (i, j) lives at workspace (i+1, j+1)
  for (int c = threadIdx.x; c < W; c += blockDim.x) {
    Rb[c] = c == 0 ? 0.f : kInf;
    Rb[(size_t)(N + 1) * W + c] = -kInf;
  }
  for (int r = threadIdx.x + 1; r <= N; r += blockDim.x) {
    Rb[(size_t)r * W] = kInf;
    Rb[(size_t)r * W + M + 1] = -kInf;
  }
  __syncthreads();

  // forward wavefront: diagonal p holds the cells with i + j = p
  for (int p = 0; p < P; ++p) {
    const int i_lo = max(0, p - M + 1), i_hi = min(N - 1, p);
    for (int i = i_lo + threadIdx.x; i <= i_hi; i += blockDim.x) {
      const int j = p - i;
      float r = kInf;
      const float d = Db[(size_t)i * M + j];
      if (!banned(i, j, bandwidth) && d < 0.5f * kInf) {
        const float up = Rb[(size_t)i * W + j + 1];    // (i-1, j)
        const float left = Rb[(size_t)(i + 1) * W + j];  // (i, j-1)
        const float diag = Rb[(size_t)i * W + j];      // (i-1, j-1)
        r = d + softmin3(up, left, diag, gamma);
      }
      Rb[(size_t)(i + 1) * W + j + 1] = r;
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) value[b] = Rb[(size_t)N * W + M];

  // reverse wavefront
  for (int p = P - 1; p >= 0; --p) {
    const int i_lo = max(0, p - M + 1), i_hi = min(N - 1, p);
    for (int i = i_lo + threadIdx.x; i <= i_hi; i += blockDim.x) {
      const int j = p - i;
      const float r = Rb[(size_t)(i + 1) * W + j + 1];
      float e = 0.f;
      if (r < 0.5f * kInf) {
        const bool down = i + 1 < N, right = j + 1 < M;
        // successors a = (i+1, j), b = (i, j+1), c = (i+1, j+1)
        const float ra = live_or_neg_inf(Rb[(size_t)(i + 2) * W + j + 1]);
        const float rb = live_or_neg_inf(Rb[(size_t)(i + 1) * W + j + 2]);
        const float rc = live_or_neg_inf(Rb[(size_t)(i + 2) * W + j + 2]);
        const float da = down && !banned(i + 1, j, bandwidth)
                             ? dead_to_zero(Db[(size_t)(i + 1) * M + j]) : 0.f;
        const float db = right && !banned(i, j + 1, bandwidth)
                             ? dead_to_zero(Db[(size_t)i * M + j + 1]) : 0.f;
        const float dc = down && right && !banned(i + 1, j + 1, bandwidth)
                             ? dead_to_zero(Db[(size_t)(i + 1) * M + j + 1])
                             : 0.f;
        const float ea = down ? Eb[(size_t)(i + 1) * M + j] : 0.f;
        const float eb = right ? Eb[(size_t)i * M + j + 1] : 0.f;
        const float ec = down && right ? Eb[(size_t)(i + 1) * M + j + 1] : 0.f;
        e = __fadd_rn(__fadd_rn(succ_term(ea, ra, da, r, gamma),
                                succ_term(eb, rb, db, r, gamma)),
                      succ_term(ec, rc, dc, r, gamma));
        if (i == N - 1 && j == M - 1) e = 1.f;
      }
      Eb[(size_t)i * M + j] = e;
    }
    __syncthreads();
  }
}

__global__ void softdtw_fwd_kernel(const float* __restrict__ D,
                                   float* __restrict__ value, int N, int M,
                                   float gamma, float bandwidth) {
  extern __shared__ float diag[];  // 3 rotating diagonals of N+1 slots
  // slot s of a diagonal holds row s-1; slot 0 is the +INF row above the grid
  const int b = blockIdx.x;
  const int P = N + M - 1;
  const int S = N + 1;
  const float* Db = D + (size_t)b * N * M;
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
          r = d + softmin3(up, left, dg, gamma);
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

}  // namespace

extern "C" {

// K2.  D [B,N,M], R_ws [B, N+2, M+2] scratch, E [B,N,M] and value [B]: all
// f32 and contiguous on the current device.  Launches on `stream`, returns
// cudaGetLastError().
int t2s_softdtw_grad(const float* D, float* R_ws, float* E, float* value,
                     int B, int N, int M, float gamma, float bandwidth,
                     void* stream) {
  softdtw_grad_kernel<<<B, block_threads(N < M ? N : M), 0,
                        (cudaStream_t)stream>>>(D, R_ws, E, value, N, M,
                                                gamma, bandwidth);
  return (int)cudaGetLastError();
}

// K3.  D [B,N,M] -> value [B], f32, contiguous.  N is bounded by shared
// memory: 3 * (N+1) floats must fit in a block's 227 KB (N <= 19369).
int t2s_softdtw_fwd(const float* D, float* value, int B, int N, int M,
                    float gamma, float bandwidth, void* stream) {
  const size_t smem = 3 * (size_t)(N + 1) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        softdtw_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  softdtw_fwd_kernel<<<B, block_threads(N), smem, (cudaStream_t)stream>>>(
      D, value, N, M, gamma, bandwidth);
  return (int)cudaGetLastError();
}

const char* t2s_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
