// K1: stacked weight-only int8 dequantizing matmul for the decode-loop LSTMs.
//
//   y[s,b,n] = (sum_k x[s,b,k] * float(w_q[s,k,n])) * scale[s,n]
//
// x [S,B,K] bf16 or f32, w_q [S,K,N] int8 (N contiguous, read as it is),
// scale [S,N] f32 -> y [S,B,N] f32.  Accumulation is f32; the per-output-
// channel scale is applied once, after the sum.  Every S, B, K and N is
// taken: the edges are zero-filled or masked.  One launch per call, no
// workspace, no float atomics: the result is deterministic.
//
// Replaces the Pallas TPU kernel tacotron2_subword_tpu/ops/quant.py
// `_kernel` (reached through `matmul_dequant_int8`).  The Pallas version
// streams [K, 512] int8 tiles into VMEM and runs one MXU dot per tile; on
// Hopper the grid runs in parallel over 132 SMs, so the work is cut finer.
//
// Bound on an H100 SXM: the decode step's int8 weights are
// 2*1792*4096 + 4096*4096 bytes = 31.5 MB, ~9.4 us per decoder step at
// 3.35 TB/s of HBM; at B=128 the step's 8.05 GFLOP take ~8.1 us at the bf16
// tensor-core peak, so every shape of the decode (B <= 128) is bound by the
// weight bytes.
//
// bf16 x (serving): tensor cores, weights streamed at HBM rate.
//  - The roles are swapped, y^T = W^T x^T: the weight's N is the M of
//    mma.sync.m16n8k16 (bf16 -> f32) and the batch is its n, so B=4 pads to
//    an n of 8, not to 64 rows.
//  - A block owns 128 columns of N, a tile of BT rows of B and a range of
//    K.  A ring of 3-4 stages in shared memory holds [SK k x 128 n] int8 of
//    W (SK = 256 at B <= 32: 32 KB) and [BT x SK] bf16 of x per stage.  W
//    comes by one TMA copy per stage (2-D tensor map, 128-byte swizzle,
//    completion on an mbarrier), x by 16-byte cp.async; 2-3 stages are in
//    flight, 24-64 KB per block.  The swizzle and the x rows' padding (8
//    values) make the fragment reads below hit 32 distinct banks.  Ragged
//    shapes (N % 128 or K % 64 not 0) fill the stages element by element.
//  - 8 warps: 2 along N, and along K (small B) or B (large B).  At B <= 32
//    each warp takes its own 64 rows of a stage, four independent k16
//    steps, so one barrier covers 8 KB of W per warp pair.
//  - No ldmatrix: a lane builds its A fragments by hand.  Lane (g, t) reads
//    8 bytes (8 columns of N) from each of its k rows 2t, 2t+1, 2t+8, 2t+9;
//    one byte-permute puts the two k values of one column side by side, and
//    MMA tile j takes columns 2j and 2j+1 of those 8 as its rows g and g+8
//    (a fixed permutation of the output rows, undone in the epilogue).
//  - int8 -> bf16 without I2F: the low 7 bits and the sign bit, or-ed into
//    the bf16 128.0, give 128 + low7 and 128 or 256; one bf16x2 subtraction
//    is q, exactly: 2 instructions per weight with the byte-permute.
//  - Split K without a second launch: the blocks of one output tile form a
//    thread-block cluster (up to 8, one per K range).  Each block leaves its
//    partial sums in its shared memory; after a cluster barrier, block r
//    adds the r-th slice of the tile over every block's partials through
//    distributed shared memory, always in rank order, applies the scale and
//    writes y.
// f32 x (parity path): CUDA cores, as the first version of this kernel
// (tensor cores would cost it its 1e-4 tolerance); its split-K partials
// meet the same way, in a cluster, so it also needs no workspace.
// The host (ops/quant.py k1_plan) picks BT and the number of K splits.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;  // 8 warps: the f32 kernel, and the default
constexpr int kMaxCluster = 8;  // portable cluster size

// Split-K epilogue of both kernels.  Every block of a cluster holds PARTS
// partial tiles [ROWS][COLS] (row stride ld floats, 16-byte aligned) at
// `part` in its shared memory.  A block first adds its own parts, in
// order, into part 0; after a cluster barrier, rank r takes the r-th slice
// of the tile, adds part 0 of every rank in rank order, applies the scale
// and writes y[row0 + i, col0 + j] inside B x N.  The order of the sums is
// fixed, so the result is deterministic.
template <int ROWS, int COLS, int PARTS>
__device__ __forceinline__ void cluster_reduce_store(
    float* part, int ld, int rank, int ranks, float* __restrict__ y,
    const float* __restrict__ scale, int row0, int B, int col0, int N) {
  constexpr int kQuads = ROWS * COLS / 4;
  if (PARTS > 1) {
    __syncthreads();
    for (int e = threadIdx.x; e < kQuads; e += blockDim.x) {
      const int r = e / (COLS / 4), c = (e % (COLS / 4)) * 4;
      float4 acc = *reinterpret_cast<const float4*>(part + r * ld + c);
#pragma unroll
      for (int q = 1; q < PARTS; ++q) {
        const float4 v =
            *reinterpret_cast<const float4*>(part + (q * ROWS + r) * ld + c);
        acc.x += v.x; acc.y += v.y; acc.z += v.z; acc.w += v.w;
      }
      *reinterpret_cast<float4*>(part + r * ld + c) = acc;
    }
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int per = (kQuads + ranks - 1) / ranks;
  const int end = min(kQuads, (rank + 1) * per);
  for (int e = rank * per + threadIdx.x; e < end; e += blockDim.x) {
    const int r = e / (COLS / 4), c = (e % (COLS / 4)) * 4;
    if (row0 + r >= B || col0 + c >= N) continue;
    float4 v[kMaxCluster];
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q)  // all loads in flight at once
      if (q < ranks)
        v[q] = *reinterpret_cast<const float4*>(
            cluster.map_shared_rank(part, q) + r * ld + c);
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q)
      if (q < ranks) {
        sum.x += v[q].x; sum.y += v[q].y; sum.z += v[q].z; sum.w += v[q].w;
      }
    const float vals[4] = {sum.x, sum.y, sum.z, sum.w};
    float* yr = y + (size_t)(row0 + r) * N;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int col = col0 + c + i;
      if (col < N) yr[col] = vals[i] * scale[col];
    }
  }
  cluster.sync();  // no block leaves while another still reads its partials
}

// ---------------------------------------------------------------------------
// f32 x: CUDA cores.
//  - one block of 8 warps per (tile of 128 columns of N, tile of BT rows of
//    B, s, split of K).  Lane l owns 4 adjacent columns, so a warp reads one
//    128-byte int8 row segment per k: coalesced along N.
//  - x rows of the tile are staged in shared memory, 256 k at a time; the
//    8 warps take interleaved k of each chunk and keep BT x 4 f32
//    accumulators each.  The warps' partial sums meet in shared memory and
//    are added in a fixed order, then the splits' sums in split order.
// ---------------------------------------------------------------------------

constexpr int kWarps = 8;
constexpr int kTileN = 128;   // 32 lanes x 4 columns
constexpr int kChunkK = 256;  // k values of x staged per pass

template <int BT, bool VEC>
__global__ void __launch_bounds__(kThreads)
dequant_int8_matmul_f32_kernel(const float* __restrict__ x,
                               const int8_t* __restrict__ w,
                               const float* __restrict__ scale,
                               float* __restrict__ y, int B, int K, int N,
                               int splits, int k_per_split) {
  __shared__ float xs[BT][kChunkK];
  __shared__ __align__(16) float red[kWarps][BT][kTileN];

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int n0 = blockIdx.x * kTileN;
  const int b0 = blockIdx.y * BT;
  const int s = blockIdx.z / splits;
  const int split = blockIdx.z % splits;  // == the block's rank in its cluster
  const int kbeg = split * k_per_split;
  const int kend = min(K, kbeg + k_per_split);
  const int n = n0 + 4 * lane;

  const float* xsb = x + (size_t)s * B * K;
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
      if (b0 + bb < B && kk < kc) v = xsb[(size_t)(b0 + bb) * K + k0 + kk];
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

  // the splits of one tile form a cluster
  cluster_reduce_store<BT, kTileN, kWarps>(
      &red[0][0][0], kTileN, split, splits, y + (size_t)s * B * N,
      scale + (size_t)s * N, b0, B, n0, N);
}

// ---------------------------------------------------------------------------
// bf16 x: tensor cores (mma.sync.m16n8k16, bf16 in, f32 accumulate).
// ---------------------------------------------------------------------------

constexpr int kTN = 128;        // columns of N per block: 2 warps x 64
constexpr int kTK = 64;         // k per warp and stage; the unit of K splits
constexpr int kPRow = kTN + 4;  // floats per row of the partial sums

// Warps of a block: 2 along N (64 columns each) x WB along B x WK along K.
// A stage holds SK = 64 WK rows of K; warp (wn, wb, wk) takes its rows
// 64 wk .. 64 wk + 63, four k16 steps, with 4 (N) x NT (B) MMA tiles: the
// four steps of a warp are independent but for their sums, and one
// barrier per stage covers 8 KB of W per warp pair.  The W ring comes
// first, 1024-byte aligned, then the x ring, whose rows are padded by 8
// values (a row stride of 4 words mod 32: conflict-free fragment reads).
template <int BT>
struct TcShape {
  static constexpr int WN = 2;
  static constexpr int MT = 4;  // MMA tiles along N per warp
  static constexpr int WB = BT >= 128 ? 4 : BT >= 64 ? 2 : 1;
  static constexpr int WK = 4 / WB;
  static constexpr int NT = BT / WB / 8;
  static constexpr int kThreads = 32 * WN * WB * WK;
  static constexpr int SK = kTK * WK;
  static constexpr int kStages = WK == 1 ? 4 : 3;
  static constexpr int kXRow = SK + 8;
  static constexpr int kWStage = SK * kTN;
  static constexpr int kXStage = BT * kXRow * 2;
  static constexpr int kPipeBytes = kStages * (kWStage + kXStage);
  static constexpr int kPartBytes = WK * BT * kPRow * 4;
  static constexpr int kSmem =
      1024 + (kPipeBytes > kPartBytes ? kPipeBytes : kPartBytes);
};

// W tiles are [SK k][128 n] int8 in the TMA's 128-byte swizzle: 16-byte
// chunk c of row r sits at chunk c ^ (r % 8).  The fragment reads of a warp
// (rows 2t and 2t+1 (+8), 8 bytes at column 8g) then hit 32 distinct banks.
__device__ __forceinline__ int swz(int r, int col) {
  return r * kTN + ((((col >> 4) ^ r) & 7) << 4) + (col & 15);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(smem)), "l"(gmem), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)), "r"(parity) : "memory");
}
// One [64 x 128] tile of W by the TMA unit, counted on `bar`.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_addr(bar)) : "memory");
}

// Two int8 -> bf16x2, exactly: the low byte of each 16-bit half of t holds
// q (the high bytes are ignored).  With q = low7 - 128 sign, the bf16
// 0x4300 | low7 is 128 + low7, and 0x4300 | sign << 7 is 128 or 256: one
// bf16x2 subtraction of the two gives q, exact (|q| <= 128).  Two logic
// ops and a subtraction per pair, no I2F.
__device__ __forceinline__ uint32_t i8x2_to_bf16x2(uint32_t t) {
  const uint32_t a = (t & 0x007F007Fu) | 0x43004300u;
  const uint32_t m = (t & 0x00800080u) | 0x43004300u;
  uint32_t d;
  asm("sub.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(m));
  return d;
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// How a stage is filled.  TMA (N % 128 == 0, K % 64 == 0, x and w_q
// 16-byte aligned: every tile is whole, as on the decode's shapes): one TMA
// copy of W per stage, counted on the stage's mbarrier, and x by 16-byte
// cp.async with zero fill past B and the K range.  Otherwise (ragged
// shapes) element by element, zero past the edges.
//
// Grid (splits, ceil(N/128), S * ceil(B/BT)), cluster (splits, 1, 1).
// `wmap` (TMA only) views w_q as a 2-D [S*K, N] uint8 tensor with an
// [SK, 128] box and the 128-byte swizzle.
template <int BT, bool TMA>
__global__ void __launch_bounds__(TcShape<BT>::kThreads, 2)
dequant_int8_matmul_tc_kernel(const __grid_constant__ CUtensorMap wmap,
                              const __nv_bfloat16* __restrict__ x,
                              const int8_t* __restrict__ w,
                              const float* __restrict__ scale,
                              float* __restrict__ y, int B, int K, int N,
                              int k_per_split) {
  using Sh = TcShape<BT>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[Sh::kStages];  // TMA: W landed
  // offset from smem_raw (not an integer cast), so that the compiler keeps
  // the shared address space and issues LDS
  unsigned char* smem =
      smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  unsigned char* wring = smem;
  __nv_bfloat16* xring =
      reinterpret_cast<__nv_bfloat16*>(smem + Sh::kStages * Sh::kWStage);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wn = warp % Sh::WN;
  const int wb = (warp / Sh::WN) % Sh::WB;
  const int wk = warp / (Sh::WN * Sh::WB);

  const int split = blockIdx.x;  // == the block's rank in its cluster
  const int splits = gridDim.x;
  const int n0 = blockIdx.y * kTN;
  const int btiles = (B + BT - 1) / BT;
  const int s = blockIdx.z / btiles;
  const int b0 = (blockIdx.z % btiles) * BT;
  const int kbeg = split * k_per_split;
  const int kend = min(K, kbeg + k_per_split);
  const int ntiles = kend > kbeg ? (kend - kbeg + Sh::SK - 1) / Sh::SK : 0;

  const int8_t* ws = w + (size_t)s * K * N;
  const __nv_bfloat16* xs = x + (size_t)s * B * K;

  auto load_stage = [&](int slot, int kt) {
    unsigned char* sw = wring + slot * Sh::kWStage;
    __nv_bfloat16* sx = xring + slot * (BT * Sh::kXRow);
    const int k0 = kbeg + kt * Sh::SK;
    if (TMA) {
      // the box may run past kend: those rows meet x's zero fill and the
      // warps that would read them skip their steps
      if (tid == 0) {
        mbar_expect_tx(&full[slot], Sh::kWStage);
        tma_load_2d(sw, &wmap, n0, s * K + k0, &full[slot]);
      }
      for (int c = tid; c < BT * (Sh::SK / 8); c += Sh::kThreads) {
        const int r = c / (Sh::SK / 8), cc = c % (Sh::SK / 8);
        const int b = b0 + r, k = k0 + cc * 8;
        const bool ok = b < B && k < kend;
        cp_async16(sx + r * Sh::kXRow + cc * 8,
                   ok ? xs + (size_t)b * K + k : xs, ok);
      }
    } else {
      for (int e = tid; e < Sh::SK * kTN; e += Sh::kThreads) {
        const int r = e / kTN, c = e % kTN;
        const int k = k0 + r, n = n0 + c;
        sw[swz(r, c)] = (k < kend && n < N)
                            ? (unsigned char)ws[(size_t)k * N + n] : 0;
      }
      for (int e = tid; e < BT * Sh::SK; e += Sh::kThreads) {
        const int r = e / Sh::SK, c = e % Sh::SK;
        const int b = b0 + r, k = k0 + c;
        sx[r * Sh::kXRow + c] = (b < B && k < kend) ? xs[(size_t)b * K + k]
                                                : __float2bfloat16(0.f);
      }
    }
  };

  if (TMA) {
    if (tid == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(&wmap)) : "memory");
      for (int st = 0; st < Sh::kStages; ++st) mbar_init(&full[st], 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }

  float acc[Sh::MT][Sh::NT][4];
#pragma unroll
  for (int j = 0; j < Sh::MT; ++j)
#pragma unroll
    for (int nt = 0; nt < Sh::NT; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[j][nt][q] = 0.f;

#pragma unroll
  for (int st = 0; st < Sh::kStages - 1; ++st) {
    if (st < ntiles) load_stage(st, st);
    cp_async_commit();
  }

  // lane (g, t) reads k rows 2t, 2t+1, 2t+8, 2t+9 of each k16 step of the
  // warp's 64 rows: 8 bytes from column col0 = 64 wn + 8 g.  Rows 2t and
  // 2t+8 share their swizzle (the row mod 8), as do 2t+1 and 2t+9.
  const int col0 = wn * 64 + 8 * g;
  const int chunk = col0 >> 4, half = col0 & 15;
  const int sw_even = (((chunk ^ (2 * t)) & 7) << 4) + half;
  const int sw_odd = (((chunk ^ (2 * t + 1)) & 7) << 4) + half;
  for (int kt = 0; kt < ntiles; ++kt) {
    const int slot = kt % Sh::kStages;
    cp_async_wait<Sh::kStages - 2>();  // this thread's copies of tile kt landed
    if (TMA)  // the n-th use of a slot completes its phase n
      mbar_wait(&full[slot], (kt / Sh::kStages) & 1);
    __syncthreads();  // everyone's; and the slot of tile kt-1 is free again
    const int next = kt + Sh::kStages - 1;
    if (next < ntiles) load_stage(next % Sh::kStages, next);
    cp_async_commit();

    const unsigned char* sw = wring + slot * Sh::kWStage;
    const __nv_bfloat16* sx = xring + slot * (BT * Sh::kXRow);
    if (kbeg + kt * Sh::SK + wk * kTK >= kend) continue;  // past the range
#pragma unroll
    for (int ks = 0; ks < kTK / 16; ++ks) {
      const int r0 = wk * kTK + ks * 16 + 2 * t;
      const unsigned char* q = sw + r0 * kTN;
      const uint2 w0 = *reinterpret_cast<const uint2*>(q + sw_even);
      const uint2 w1 = *reinterpret_cast<const uint2*>(q + kTN + sw_odd);
      const uint2 w8 = *reinterpret_cast<const uint2*>(q + 8 * kTN + sw_even);
      const uint2 w9 = *reinterpret_cast<const uint2*>(q + 9 * kTN + sw_odd);
      uint32_t bf[Sh::NT][2];
#pragma unroll
      for (int nt = 0; nt < Sh::NT; ++nt) {
        const __nv_bfloat16* xp =
            sx + (wb * Sh::NT * 8 + nt * 8 + g) * Sh::kXRow + r0;
        bf[nt][0] = *reinterpret_cast<const uint32_t*>(xp);
        bf[nt][1] = *reinterpret_cast<const uint32_t*>(xp + 8);
      }
#pragma unroll
      for (int j = 0; j < Sh::MT; ++j) {
        // columns 2j, 2j+1 of the lane's 8 are bytes 2(j%2), +1 of word
        // j/2; one byte-permute puts rows k, k+1 of a column in the low
        // bytes of the two halves: a0a1 = (k, k+1) of column 2j, a2a3 of
        // column 2j+1, a4..a7 the same for rows k+8, k+9
        const uint32_t sel0 = (j & 1) ? 0x6622u : 0x4400u;
        const uint32_t sel1 = (j & 1) ? 0x7733u : 0x5511u;
        const uint32_t x0 = j < 2 ? w0.x : w0.y, x1 = j < 2 ? w1.x : w1.y;
        const uint32_t x8 = j < 2 ? w8.x : w8.y, x9 = j < 2 ? w9.x : w9.y;
        uint32_t a[4];
        a[0] = i8x2_to_bf16x2(__byte_perm(x0, x1, sel0));
        a[1] = i8x2_to_bf16x2(__byte_perm(x0, x1, sel1));
        a[2] = i8x2_to_bf16x2(__byte_perm(x8, x9, sel0));
        a[3] = i8x2_to_bf16x2(__byte_perm(x8, x9, sel1));
#pragma unroll
        for (int nt = 0; nt < Sh::NT; ++nt) mma_bf16(acc[j][nt], a, bf[nt]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the rings are free: they now hold the partial sums

  // part[wk][b][n]: MMA tile j's row g is column col0 + 2j, row g+8 the
  // column after it
  float* part = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int j = 0; j < Sh::MT; ++j)
#pragma unroll
    for (int nt = 0; nt < Sh::NT; ++nt) {
      const int nl = col0 + 2 * j;
      const int bl = wb * Sh::NT * 8 + nt * 8 + 2 * t;
      float* p = part + (wk * BT + bl) * kPRow + nl;
      *reinterpret_cast<float2*>(p) = make_float2(acc[j][nt][0], acc[j][nt][2]);
      *reinterpret_cast<float2*>(p + kPRow) =
          make_float2(acc[j][nt][1], acc[j][nt][3]);
    }

  cluster_reduce_store<BT, kTN, Sh::WK>(part, kPRow, split, splits,
                                        y + (size_t)s * B * N,
                                        scale + (size_t)s * N, b0, B, n0, N);
}

template <typename Kernel, typename... Args>
cudaError_t launch_cluster(Kernel kernel, dim3 grid, dim3 cluster,
                           int threads, int smem, cudaStream_t stream,
                           Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster.x;
  attr[0].val.clusterDim.y = cluster.y;
  attr[0].val.clusterDim.z = cluster.z;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// w_q as a 2-D [S*K, N] uint8 tensor for the TMA: [64, 128] boxes, 128-byte
// swizzle.  The encoder, cuTensorMapEncodeTiled, is looked up through the
// runtime's entry-point query, so the library links no libcuda.
cudaError_t encode_wmap(CUtensorMap* map, const int8_t* w, int S, int K,
                        int N, int box_rows) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult q;
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                              cudaEnableDefault, &q);
    if (err != cudaSuccess) return err;
    if (q != cudaDriverEntryPointSuccess || fn == nullptr)
      return cudaErrorNotSupported;
    encode = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
  }
  const cuuint64_t dims[2] = {(cuuint64_t)N, (cuuint64_t)S * K};
  const cuuint64_t strides[1] = {(cuuint64_t)N};
  const cuuint32_t box[2] = {kTN, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<int8_t*>(w), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The decode passes the same few weight tensors every step: their maps
// are kept (8 slots, replaced in turn), keyed by address, shape and box.
cudaError_t cached_wmap(CUtensorMap* map, const int8_t* w, int S, int K,
                        int N, int box_rows) {
  struct Slot {
    const int8_t* w;
    int S, K, N, box_rows;
    CUtensorMap map;
  };
  static Slot slots[8] = {};
  static int next = 0;
  for (const Slot& sl : slots)
    if (sl.w == w && sl.S == S && sl.K == K && sl.N == N &&
        sl.box_rows == box_rows) {
      *map = sl.map;
      return cudaSuccess;
    }
  cudaError_t err = encode_wmap(map, w, S, K, N, box_rows);
  if (err != cudaSuccess) return err;
  slots[next] = Slot{w, S, K, N, box_rows, *map};
  next = (next + 1) % 8;
  return cudaSuccess;
}

template <int BT, bool TMA>
cudaError_t launch_tc(const __nv_bfloat16* x, const int8_t* w,
                      const float* scale, float* y, int S, int B, int K, int N,
                      int splits, int k_per_split, cudaStream_t st) {
  auto kernel = dequant_int8_matmul_tc_kernel<BT, TMA>;
  constexpr int smem = TcShape<BT>::kSmem;
  static bool attr_set = false;  // per instantiation; setting it is idempotent
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  CUtensorMap wmap = {};
  if (TMA) {
    cudaError_t err = cached_wmap(&wmap, w, S, K, N, TcShape<BT>::SK);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(splits, (N + kTN - 1) / kTN, S * ((B + BT - 1) / BT));
  return launch_cluster(kernel, grid, dim3(splits, 1, 1),
                        TcShape<BT>::kThreads, smem, st, wmap, x,
                        w, scale, y, B, K, N, k_per_split);
}

template <bool TMA>
cudaError_t launch_tc_rows(int bt, const __nv_bfloat16* x, const int8_t* w,
                           const float* scale, float* y, int S, int B, int K,
                           int N, int splits, int k_per_split,
                           cudaStream_t st) {
  switch (bt) {
    case 8: return launch_tc<8, TMA>(x, w, scale, y, S, B, K, N, splits, k_per_split, st);
    case 16: return launch_tc<16, TMA>(x, w, scale, y, S, B, K, N, splits, k_per_split, st);
    case 32: return launch_tc<32, TMA>(x, w, scale, y, S, B, K, N, splits, k_per_split, st);
    case 64: return launch_tc<64, TMA>(x, w, scale, y, S, B, K, N, splits, k_per_split, st);
    case 128: return launch_tc<128, TMA>(x, w, scale, y, S, B, K, N, splits, k_per_split, st);
    default: return cudaErrorInvalidValue;
  }
}

template <int BT, bool VEC>
cudaError_t launch_f32(const float* x, const int8_t* w, const float* scale,
                       float* y, int S, int B, int K, int N, int splits,
                       int k_per_split, cudaStream_t st) {
  const dim3 grid((N + kTileN - 1) / kTileN, (B + BT - 1) / BT, S * splits);
  return launch_cluster(dequant_int8_matmul_f32_kernel<BT, VEC>, grid,
                        dim3(1, 1, splits), kThreads, 0, st, x, w, scale, y,
                        B, K, N,
                        splits, k_per_split);
}

template <bool VEC>
cudaError_t launch_f32_rows(int bt, const float* x, const int8_t* w,
                            const float* scale, float* y, int S, int B, int K,
                            int N, int splits, int k_per_split,
                            cudaStream_t st) {
  switch (bt) {
    case 8: return launch_f32<8, VEC>(x, w, scale, y, S, B, K, N, splits, k_per_split, st);
    case 4: return launch_f32<4, VEC>(x, w, scale, y, S, B, K, N, splits, k_per_split, st);
    case 2: return launch_f32<2, VEC>(x, w, scale, y, S, B, K, N, splits, k_per_split, st);
    case 1: return launch_f32<1, VEC>(x, w, scale, y, S, B, K, N, splits, k_per_split, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Clusters of `splits` blocks of the bf16 kernel at row tile `bt` that the
// card can hold at once (cudaOccupancyMaxActiveClusters); -1 on error.
int t2s_k1_max_active_clusters(int bt, int splits) {
  const void* fn;
  int smem, threads;
  switch (bt) {
#define K1_CASE(T)                                                  \
  case T:                                                           \
    fn = (const void*)dequant_int8_matmul_tc_kernel<T, true>;       \
    smem = TcShape<T>::kSmem;                                       \
    threads = TcShape<T>::kThreads;                                 \
    break;
    K1_CASE(8) K1_CASE(16) K1_CASE(32) K1_CASE(64) K1_CASE(128)
#undef K1_CASE
    default: return -1;
  }
  if (cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) != cudaSuccess)
    return -1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = -1;
  if (cudaOccupancyMaxActiveClusters(&n, fn, &cfg) != cudaSuccess) return -1;
  return n;
}

// Launches K1 on `stream` with the host's plan: rows of B per block `bt`
// (bf16 x: 8, 16, 32, 64 or 128; f32 x: 1, 2, 4 or 8) and K cut into
// `splits` ranges of `k_per_split` (a multiple of 64 for bf16 x, of 256 for
// f32 x), none empty, at most 8.  x is bf16 when x_bf16 != 0, else f32; all
// tensors contiguous.  Allocates nothing.  Returns a CUDA error code.
int t2s_dequant_int8_matmul(const void* x, const void* w_q, const void* scale,
                            void* y, int S, int B, int K, int N, int x_bf16,
                            int bt, int splits, int k_per_split,
                            void* stream) {
  if (S <= 0 || B <= 0 || N <= 0) return (int)cudaGetLastError();
  const int unit = x_bf16 ? kTK : kChunkK;
  if (splits < 1 || splits > kMaxCluster || k_per_split <= 0 ||
      k_per_split % unit != 0 || (long long)splits * k_per_split < K ||
      (splits > 1 && (long long)(splits - 1) * k_per_split >= K))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int8_t* w = (const int8_t*)w_q;
  const float* sc = (const float*)scale;
  float* out = (float*)y;
  cudaError_t err;
  if (x_bf16) {
    const bool tma = (uintptr_t)w_q % 16 == 0 && (uintptr_t)x % 16 == 0 &&
                     N % kTN == 0 && K % kTK == 0;
    const __nv_bfloat16* xb = (const __nv_bfloat16*)x;
    err = tma ? launch_tc_rows<true>(bt, xb, w, sc, out, S, B, K, N, splits,
                                     k_per_split, st)
              : launch_tc_rows<false>(bt, xb, w, sc, out, S, B, K, N, splits,
                                      k_per_split, st);
  } else {
    const bool vec = (N % 4 == 0) && ((uintptr_t)w_q % 4 == 0);
    const float* xf = (const float*)x;
    err = vec ? launch_f32_rows<true>(bt, xf, w, sc, out, S, B, K, N, splits,
                                      k_per_split, st)
              : launch_f32_rows<false>(bt, xf, w, sc, out, S, B, K, N, splits,
                                       k_per_split, st);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

const char* t2s_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
