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
//   (tacotron2_subword_tpu/ops/softdtw.py:507).  See below.
//
// gamma a power of two (the training default is 1): x / gamma and
// x * (1 / gamma) are the same correctly rounded number, so the kernels
// multiply (template POW2) and stay bit-equal to the plain version.
//
// K2's design: one block per batch row, as in the reference numba kernel;
// the threads of the block take the rows of an anti-diagonal (looping when
// a diagonal is longer than the block) and meet at one barrier per
// diagonal.  K2's block has up to 384 threads more than a diagonal has
// cells: the extra warps copy and compute the weights, and sit out the
// wavefronts (named barrier 1 holds only the wavefront warps).  The TPU kernels' skewed layout, lane padding and batch blocks
// served the TPU's vector unit only and are not carried over.
//
// Bound on an H100 SXM: each cell costs 4 transcendentals forward (3 exp,
// 1 log) and 3 exp backward; reading D and writing E once is 8 bytes a cell.
// At B=8, N=M=128 both come to well under a microsecond of the card's
// throughput; what rules is the serial chain of N+M-1 diagonals (twice that
// for K2) on only B of the 132 SMs: in K2 each link is a barrier plus a
// memory round trip (shared memory in the shared variant, L1/L2 in the
// global one).
//
// K3's design: the chain's links are made as short as a cell's arithmetic
// allows, with no block barrier and no device-memory access on them.
//  - Rows on lanes, columns on time: warp w takes rows [32k, 32k+32) of
//    warp-row k = w, w + W, ... (W warps; a second "strip" of warp-rows
//    where N > 32 W).  Lane l does column j = t - l at its step t: R(i, j-1)
//    is its own register, R(i-1, j) comes from lane l-1 by __shfl_up_sync,
//    R(i-1, j-1) is what came the step before.  A step is a shuffle and
//    softmin3.
//  - Warp to warp: lane 31 keeps its row (the next warp-row's top
//    boundary) in registers for kChunk steps, then stores it into a row
//    buffer [W][M] (shared memory where it fits, else a scratch the
//    wrapper allocates), fences, and publishes the count of columns
//    written; the consumer polls the count once per kChunk columns,
//    fences, and takes the next kChunk boundary values into registers
//    (lane e holds column t0 + e; lane 0 reads them by __shfl_sync).  Every
//    wait is for a value that precedes the waiter in the recursion, and a
//    row's buffer is rewritten only after its reader has computed those
//    columns, so there is no deadlock and no overwrite.
//  - D off the chain: each warp streams its 32 rows of D into a ring of
//    kRing columns in shared memory by 4-byte cp.async (any M), kChunk
//    columns at a time, two chunks ahead of the wavefront.  Cell (l, j)
//    sits at l * kStride + j % kRing with kStride - 1 odd, so the 32 lanes
//    of a step (one diagonal) hit 32 distinct banks.
//  - No branch inside a step: every lane computes every step and selects.
//    A divergent branch per cell cost more than the cell (reconvergence).
//  - The same operations as the plain version in the same order
//    (softmin3(up, left, diag), exp terms summed (e0 + e1) + e2), so the
//    value is bit-equal to it at gamma = 1.
//  What is left is the chain: N+M-1 dependent cells, ~200 cycles each on
//  an H100 SXM (three expf and a logf in full precision, a shuffle, a few
//  adds; chip_smoke.py measures it), a lag of kChunk + 32 steps per warp
//  boundary, and the handoff and D staging once per chunk of kChunk steps.

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

// K3's constants (ops/softdtw.py K3_CHUNK, K3_STRIDE): the steps
// between two warp-to-warp handoffs and D chunks; the D ring's columns
// (the 32 columns a warp spans plus three chunks in flight must fit); its
// row stride (kRing + 2: even, so kStride - 1 is odd).
constexpr int kChunk = 8;
constexpr int kRing = 64;
constexpr int kStride = kRing + 2;
static_assert(31 + 3 * kChunk <= kRing, "D ring too small for its chunks");

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Bytes of K3's dynamic shared memory: the handoff counters [W] (padded to
// 16 bytes), the D rings [W][32][kStride], and the boundary rows [W][M]
// where they live in shared memory.
__host__ __device__ __forceinline__ long long fwd_smem_bytes(int M, int warps,
                                                             bool bnd_shared) {
  return 4LL * (((warps + 3) / 4) * 4 + (long long)warps * 32 * kStride +
                (bnd_shared ? (long long)warps * M : 0LL));
}

// One block per batch row, W = blockDim.x / 32 warps; bnd_ws is the
// boundary rows [B][W][M] in device memory, or null for shared memory.
template <bool POW2>
__global__ void softdtw_fwd_kernel(const float* __restrict__ D,
                                   float* bnd_ws,
                                   float* __restrict__ value, int N, int M,
                                   float gamma, float bandwidth) {
  extern __shared__ __align__(16) float k3_smem[];
  constexpr unsigned kFull = 0xffffffffu;
  const int W = blockDim.x >> 5, w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x;
  const float inv = 1.f / gamma;
  const float* Dg = D + (size_t)b * N * M;
  // cnt[s]: columns published into boundary row s, counted over the rows
  // that pass through it (a sequence number, never reset)
  int* cnt = reinterpret_cast<int*>(k3_smem);
  float* ring = k3_smem + ((W + 3) / 4) * 4 + w * 32 * kStride;
  float* bnd = bnd_ws != nullptr ? bnd_ws + (size_t)b * W * M
                                 : k3_smem + ((W + 3) / 4) * 4 + W * 32 * kStride;
  if (threadIdx.x < W) cnt[threadIdx.x] = 0;
  __syncthreads();  // once, before any warp polls a counter

  const int nk = (N + 31) / 32;   // warp-rows
  const int nch = (M + 31 + kChunk - 1) / kChunk;  // chunks of steps a row
  // warp w's g-th row reads boundary row w (g-th use) and writes boundary
  // row (w+1) % W, which warp (w+1) % W reads in its g-th (w+1 < W) or
  // (g+1)-th row
  const float* top = bnd + (size_t)w * M;
  float* bottom = bnd + (size_t)((w + 1) % W) * M;
  volatile int* top_cnt = cnt + w;
  int* bottom_cnt = cnt + (w + 1) % W;

  for (int g = 0, k = w; k < nk; ++g, k += W) {
    const int row0 = 32 * k, i = row0 + lane;
    const bool live = i < N, has_top = k > 0, has_bottom = k + 1 < nk;
    const int top_base = g * M, bottom_base = (w + 1 < W ? g : g + 1) * M;
    // D columns [c kChunk, (c+1) kChunk) of the warp's rows into the ring
    auto stage = [&](int c) {
      const int c0 = c * kChunk;
#pragma unroll
      for (int q = 0; q < kChunk; ++q) {
        const int e = q * 32 + lane;
        const int r = e / kChunk, col = c0 + e % kChunk;
        if (row0 + r < N && col < M)
          cp_async4(ring + r * kStride + (col & (kRing - 1)),
                    Dg + (size_t)(row0 + r) * M + col);
      }
      cp_async_commit();
    };
    stage(0);
    stage(1);

    // lane 31 stores its chunk of the boundary row after the chunk's
    // steps, and the value is written once after the row
    float r = kInf;                                  // R(i, j-1)
    float up_prev = (k == 0 && lane == 0) ? 0.f : kInf;  // R(i-1, j-1)
    float bval = kInf;  // lane e: boundary column t0 + e (+INF above row 0)
    float last = kInf;  // R(i, M-1)
    for (int c = 0; c < nch; ++c) {
      const int t0 = c * kChunk;
      cp_async_wait<1>();  // chunk c has landed
      __syncwarp();        // ... for every lane; chunk c-2's slots are free
      stage(c + 2);
      if (has_top && t0 < M) {
        const int need = top_base + min(M, t0 + kChunk);
        while (*top_cnt < need) {
        }
        __threadfence_block();
        bval = (lane < kChunk && t0 + lane < M) ? top[t0 + lane] : kInf;
      }
      float out[kChunk];  // this chunk's R(i, t0 + e - lane)
#pragma unroll
      for (int e = 0; e < kChunk; ++e) {
        const int j = t0 + e - lane;
        const float from_left_lane = __shfl_up_sync(kFull, r, 1);
        const float from_top = __shfl_sync(kFull, bval, e);
        const float up = lane == 0 ? from_top : from_left_lane;  // R(i-1, j)
        const float dg = up_prev;
        up_prev = up;
        // off the grid the slot holds another column (or nothing): the
        // result is computed and thrown away
        const float d = ring[lane * kStride + (j & (kRing - 1))];
        const float cell = d + softmin3<POW2>(up, r, dg, gamma, inv);
        const bool on = live && j >= 0 && j < M && !banned(i, j, bandwidth) &&
                        d < 0.5f * kInf;
        r = on ? cell : kInf;
        out[e] = r;
        last = j == M - 1 ? r : last;
      }
      if (has_bottom && lane == 31) {
#pragma unroll
        for (int e = 0; e < kChunk; ++e) {
          const int j = t0 + e - 31;
          if (j >= 0 && j < M) bottom[j] = out[e];
        }
        __threadfence_block();  // columns < t0 + kChunk - 31 are written
        *(volatile int*)bottom_cnt =
            bottom_base + min(max(t0 + kChunk - 31, 0), M);
      }
    }
    if (i == N - 1) value[b] = last;
    cp_async_wait<0>();
    __syncwarp();  // the next row's chunks overwrite the ring
  }
}

// The serial floor's unit: one warp runs `iters` dependent cells, each a
// shuffle, softmin3 (gamma 1) and an add, as on K3's chain; cycles[0] gets
// the clock64 cycles they took.  A measurement, on no path of the port.
__global__ void chain_cycles_kernel(long long* cycles, float* out, int iters) {
  const int lane = threadIdx.x & 31;
  float r = lane * 1e-3f, dg = 0.5f * r;
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
    const float up = __shfl_up_sync(0xffffffffu, r, 1);
    const float cell = 1e-3f + softmin3<true>(up, r, dg, 1.f, 1.f);
    dg = up;
    r = cell;
  }
  const long long t1 = clock64();
  out[lane] = r;
  if (lane == 0) cycles[0] = t1 - t0;
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

// Bytes of shared memory K3 needs with `warps` warps, the boundary rows in
// shared memory (bnd_shared != 0) or in a scratch.
long long t2s_softdtw_fwd_smem_bytes(int M, int warps, int bnd_shared) {
  return fwd_smem_bytes(M, warps, bnd_shared != 0);
}

// K3.  D [B,N,M] -> value [B], f32, contiguous, with `warps` warps (1-32)
// and handoffs every `chunk` (== kChunk) columns.  bnd_ws is null (the
// boundary rows in shared memory) or a scratch of B * warps * M floats;
// smem_bytes must equal t2s_softdtw_fwd_smem_bytes(M, warps, !bnd_ws).
// Launches on `stream`, returns a CUDA error code.
int t2s_softdtw_fwd(const float* D, float* bnd_ws, float* value, int B,
                    int N, int M, float gamma, float bandwidth, int warps,
                    int chunk, long long smem_bytes, void* stream) {
  if (B < 1 || N < 1 || M < 1 || warps < 1 || warps > 32 ||
      chunk != kChunk ||
      smem_bytes != fwd_smem_bytes(M, warps, bnd_ws == nullptr))
    return (int)cudaErrorInvalidValue;
  auto kernel = is_pow2(gamma) ? softdtw_fwd_kernel<true>
                               : softdtw_fwd_kernel<false>;
  if (smem_bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<B, 32 * warps, (size_t)smem_bytes, (cudaStream_t)stream>>>(
      D, bnd_ws, value, N, M, gamma, bandwidth);
  return (int)cudaGetLastError();
}

// Cycles of `iters` dependent K3 cells on one warp (chain_cycles_kernel);
// cycles and out (32 floats) on the current device.
int t2s_softdtw_chain_cycles(long long* cycles, float* out, int iters,
                             void* stream) {
  chain_cycles_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(cycles, out, iters);
  return (int)cudaGetLastError();
}

const char* t2s_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
