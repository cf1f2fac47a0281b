// K1: stacked weight-only int8 dequantizing matmul for the decode-loop LSTMs.
//
//   y[s,b,n] = (sum_k x[s,b,k] * float(w_q[s,k,n])) * scale[s,n]
//
// x [S,B,K] bf16 or f32, w_q [S,K,N] int8, scale [S,N] f32 -> y [S,B,N] f32.
// Accumulation is f32; the per-output-channel scale is applied once, after
// the sum.  Every S, B, K and N is taken: the edges are masked.
//
// Replaces the Pallas TPU kernel tacotron2_subword_tpu/ops/quant.py
// `_kernel` (reached through `matmul_dequant_int8`).  The Pallas version
// streams [K, 512] int8 tiles into VMEM and runs one MXU dot per tile; on
// Hopper the grid runs in parallel over 132 SMs, so the work is cut finer.
//
// Bound on an H100 SXM: the decode step's int8 weights are
// 2*1792*4096 + 4096*4096 bytes = 31.5 MB, i.e. ~9.4 us per decoder step at
// 3.35 TB/s of HBM; at B=128 the step's 8.05 GFLOP take ~8.1 us at the bf16
// tensor-core peak.  The 50 MB L2 can hold all three weight sets across
// steps, so the HBM figure is the bound stated for the cold case.
//
// Design (simple and right first; tensor cores come later):
//  - one block of 8 warps per (tile of 128 columns of N, tile of BT rows of
//    B, s, split of K).  Lane l owns 4 adjacent columns, so a warp reads one
//    128-byte int8 row segment per k: coalesced along N.
//  - x rows of the tile are staged in shared memory (as f32), 256 k at a
//    time; the 8 warps take interleaved k of each chunk and keep BT x 4 f32
//    accumulators each.  The warps' partial sums meet in shared memory and
//    are added in a fixed order, so the result is deterministic.
//  - small B and N leave too few blocks for the card, so K is split across
//    blocks until there are about two blocks per SM; the splits' partial
//    sums go to a workspace (given by the caller) and a second kernel adds
//    them in a fixed order and applies the scale.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kTileN = 128;   // 32 lanes x 4 columns
constexpr int kChunkK = 256;  // k values of x staged per pass

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <int BT, bool VEC, typename XT>
__global__ void __launch_bounds__(kThreads)
dequant_int8_matmul_kernel(const XT* __restrict__ x,
                           const int8_t* __restrict__ w,
                           const float* __restrict__ scale,
                           float* __restrict__ y, float* __restrict__ ws,
                           int S, int B, int K, int N, int splits,
                           int k_per_split) {
  __shared__ float xs[BT][kChunkK];
  __shared__ __align__(16) float red[kWarps][BT][kTileN];

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int n0 = blockIdx.x * kTileN;
  const int b0 = blockIdx.y * BT;
  const int s = blockIdx.z / splits;
  const int split = blockIdx.z % splits;
  const int kbeg = split * k_per_split;
  const int kend = min(K, kbeg + k_per_split);
  const int n = n0 + 4 * lane;

  const XT* xsb = x + (size_t)s * B * K;
  const int8_t* wsb = w + (size_t)s * K * N;

  float acc[BT][4];
#pragma unroll
  for (int b = 0; b < BT; ++b)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[b][j] = 0.f;

  for (int k0 = kbeg; k0 < kend; k0 += kChunkK) {
    const int kc = min(kChunkK, kend - k0);
    __syncthreads();  // the previous chunk has been read by every warp
    for (int i = threadIdx.x; i < BT * kChunkK; i += kThreads) {
      const int bb = i / kChunkK;
      const int kk = i % kChunkK;
      float v = 0.f;
      if (b0 + bb < B && kk < kc)
        v = to_f32(xsb[(size_t)(b0 + bb) * K + k0 + kk]);
      xs[bb][kk] = v;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = warp; kk < kc; kk += kWarps) {
      const int8_t* wrow = wsb + (size_t)(k0 + kk) * N;
      float wf[4];
      if (VEC) {
        // N % 4 == 0 here, so the 4 columns are all in range or all out
        char4 c = make_char4(0, 0, 0, 0);
        if (n < N) c = *reinterpret_cast<const char4*>(wrow + n);
        wf[0] = (float)c.x;
        wf[1] = (float)c.y;
        wf[2] = (float)c.z;
        wf[3] = (float)c.w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wf[j] = (n + j < N) ? (float)wrow[n + j] : 0.f;
      }
#pragma unroll
      for (int b = 0; b < BT; ++b) {
        const float xv = xs[b][kk];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[b][j] = fmaf(xv, wf[j], acc[b][j]);
      }
    }
  }

#pragma unroll
  for (int b = 0; b < BT; ++b)
    *reinterpret_cast<float4*>(&red[warp][b][4 * lane]) =
        make_float4(acc[b][0], acc[b][1], acc[b][2], acc[b][3]);
  __syncthreads();

  for (int i = threadIdx.x; i < BT * kTileN; i += kThreads) {
    const int bb = i / kTileN;
    const int c = i % kTileN;
    const int row = b0 + bb;
    const int col = n0 + c;
    if (row >= B || col >= N) continue;
    float sum = 0.f;
#pragma unroll
    for (int wp = 0; wp < kWarps; ++wp) sum += red[wp][bb][c];
    const size_t o = ((size_t)s * B + row) * N + col;
    if (splits == 1)
      y[o] = sum * scale[(size_t)s * N + col];
    else
      ws[(size_t)split * S * B * N + o] = sum;
  }
}

// y[i] = (sum over splits of ws[split, i]) * scale, added in split order.
__global__ void splitk_reduce_kernel(const float* __restrict__ ws,
                                     const float* __restrict__ scale,
                                     float* __restrict__ y, int S, int B,
                                     int N, int splits) {
  const size_t total = (size_t)S * B * N;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    float sum = 0.f;
    for (int sp = 0; sp < splits; ++sp) sum += ws[(size_t)sp * total + i];
    const size_t s = i / ((size_t)B * N);
    const size_t col = i % N;
    y[i] = sum * scale[s * N + col];
  }
}

int rows_per_block(int B) { return B >= 8 ? 8 : B >= 4 ? 4 : B >= 2 ? 2 : 1; }

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess || sms <= 0)
    return 132;
  return sms;
}

// Number of K splits and k per split: about two blocks per SM, whole chunks
// per split, and no empty split.
void plan_splits(int S, int B, int K, int N, int* splits, int* k_per_split) {
  const int bt = rows_per_block(B);
  const long long blocks = (long long)((N + kTileN - 1) / kTileN) *
                           ((B + bt - 1) / bt) * S;
  const int chunks = (K + kChunkK - 1) / kChunkK;
  long long sp = (2LL * sm_count() + blocks - 1) / (blocks > 0 ? blocks : 1);
  if (sp > chunks) sp = chunks;
  if (sp < 1) sp = 1;
  const int chunks_per = (int)((chunks + sp - 1) / sp);
  *k_per_split = chunks_per * kChunkK;
  *splits = chunks > 0 ? (chunks + chunks_per - 1) / chunks_per : 1;
}

template <int BT, typename XT>
void launch(const XT* x, const int8_t* w, const float* scale, float* y,
            float* ws, int S, int B, int K, int N, bool vec, int splits,
            int k_per_split, cudaStream_t stream) {
  dim3 grid((N + kTileN - 1) / kTileN, (B + BT - 1) / BT, S * splits);
  if (vec)
    dequant_int8_matmul_kernel<BT, true, XT><<<grid, kThreads, 0, stream>>>(
        x, w, scale, y, ws, S, B, K, N, splits, k_per_split);
  else
    dequant_int8_matmul_kernel<BT, false, XT><<<grid, kThreads, 0, stream>>>(
        x, w, scale, y, ws, S, B, K, N, splits, k_per_split);
}

template <typename XT>
void launch_rows(const XT* x, const int8_t* w, const float* scale, float* y,
                 float* ws, int S, int B, int K, int N, bool vec, int splits,
                 int k_per_split, cudaStream_t stream) {
  switch (rows_per_block(B)) {
    case 8: launch<8>(x, w, scale, y, ws, S, B, K, N, vec, splits, k_per_split, stream); break;
    case 4: launch<4>(x, w, scale, y, ws, S, B, K, N, vec, splits, k_per_split, stream); break;
    case 2: launch<2>(x, w, scale, y, ws, S, B, K, N, vec, splits, k_per_split, stream); break;
    default: launch<1>(x, w, scale, y, ws, S, B, K, N, vec, splits, k_per_split, stream); break;
  }
}

}  // namespace

extern "C" {

// Floats of workspace that t2s_dequant_int8_matmul needs for this shape on
// the current device (0 when K is not split).
long long t2s_dequant_int8_matmul_workspace(int S, int B, int K, int N) {
  int splits, k_per_split;
  plan_splits(S, B, K, N, &splits, &k_per_split);
  return splits > 1 ? (long long)splits * S * B * N : 0;
}

// Launches K1 on `stream`; allocates nothing.  x is bf16 when x_bf16 != 0,
// else f32; all tensors contiguous.  Returns cudaGetLastError().
int t2s_dequant_int8_matmul(const void* x, const void* w_q, const void* scale,
                            void* y, void* ws, int S, int B, int K, int N,
                            int x_bf16, void* stream) {
  if (S <= 0 || B <= 0 || N <= 0) return (int)cudaGetLastError();
  int splits, k_per_split;
  plan_splits(S, B, K, N, &splits, &k_per_split);
  const cudaStream_t st = (cudaStream_t)stream;
  const bool vec = (N % 4 == 0) && ((uintptr_t)w_q % 4 == 0);
  const int8_t* w = (const int8_t*)w_q;
  const float* sc = (const float*)scale;
  float* out = (float*)y;
  float* wsp = (float*)ws;
  if (x_bf16)
    launch_rows((const __nv_bfloat16*)x, w, sc, out, wsp, S, B, K, N, vec,
                splits, k_per_split, st);
  else
    launch_rows((const float*)x, w, sc, out, wsp, S, B, K, N, vec, splits,
                k_per_split, st);
  if (splits > 1) {
    const size_t total = (size_t)S * B * N;
    int blocks = (int)((total + 255) / 256);
    if (blocks > 4 * sm_count()) blocks = 4 * sm_count();
    splitk_reduce_kernel<<<blocks, 256, 0, st>>>(wsp, sc, out, S, B, N,
                                                 splits);
  }
  return (int)cudaGetLastError();
}

const char* t2s_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
