// K4: the epilogue of HiFi-GAN's channels-last convolutions (serving).
//
//   v = y + bias[c]
//   v = v + res             (optional: a resblock's residual)
//   v = acc + v             (optional: the multi-receptive-field sum)
//   v = v * (1 / div)       (optional: the MRF average, div = nk)
//   pre = v                 (optional)
//   act = leaky_relu(v, slope) or tanh(v)   (optional)
//
// y, res, acc, pre and act are [rows, C], C contiguous (a channels-last
// [B, C, 1, T] activation seen as its B*T rows); bias is [C]; all f32,
// bf16 or f16.  pre may be y or acc, act may be y: each element is read
// before it is written, by the same thread, and by no other.
//
// Replaces no TPU kernel.  The JAX package leaves the generator to XLA,
// which fuses the bias, residual, MRF average and activation into its
// convolutions' fusions; under PyTorch each of them was a pass of its own
// over device memory, and cuDNN transposed every NCHW activation into and
// out of its NHWC kernels.  With the activations held channels-last
// (models/hifigan.py `_generator_apply_channels_last`), this one pass after
// each cuDNN convolution does all of that work.
//
// Every operation is the f32 operation PyTorch's own kernels make, in the
// same order, with no contraction into FMAs (__fadd_rn / __fmul_rn): the
// bias add after cuDNN (`output.add_(bias)`), `+ x`, `xs + r`, `xs / nk`
// (a product with the f32 reciprocal, as PyTorch's CUDA division by a
// Python number computes it), leaky_relu's `v > 0 ? v : v * slope` and
// tanhf; in bf16 or f16 each op's f32 result is rounded to the dtype, as
// PyTorch stores each op's output.  So it is bit-equal to its plain version
// (ops/conv_epilogue.py).
//
// Bound on an H100 SXM: HBM bytes.  Each element costs 4 bytes per tensor
// read or written (2 to 5 tensors) in f32; the bias stays in L1.  The pass
// is a grid-stride loop of 4-channel loads and stores (16 bytes in f32)
// where C is a multiple of 4 and every [rows, C] pointer aligned to them,
// else of one channel.  The bias is read a value at a time: a served
// generator's leaves may be views at any offset of one buffer.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 8 * 4;   // four waves of 8 blocks an SM

enum Act { kActNone = 0, kActLeakyRelu = 1, kActTanh = 2 };
enum Dtype { kF32 = 0, kBF16 = 1, kF16 = 2 };

template <typename T>
struct Epilogue {
  const T* y;
  const T* bias;
  const T* res;   // may be null
  const T* acc;   // may be null
  T* pre;         // may be null
  T* act;         // may be null
  long long n;    // rows * C
  int C;
  int divide;     // 0: no average
  float inv_div;  // 1.0f / div, rounded in f32
  int act_kind;
  float slope;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half_rn(x);
}

// One PyTorch elementwise op's result: computed in f32 (its "opmath"
// type), stored in T.
template <typename T>
__device__ __forceinline__ float op(float x) {
  return to_f(from_f<T>(x));
}

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

template <typename T, int VEC>
__device__ __forceinline__ void load(const T* p, float (&v)[VEC]) {
  const Pack<T, VEC> t = *reinterpret_cast<const Pack<T, VEC>*>(p);
#pragma unroll
  for (int k = 0; k < VEC; ++k) v[k] = to_f(t.v[k]);
}

template <typename T, int VEC>
__device__ __forceinline__ void store(T* p, const float (&v)[VEC]) {
  Pack<T, VEC> t;
#pragma unroll
  for (int k = 0; k < VEC; ++k) t.v[k] = from_f<T>(v[k]);
  *reinterpret_cast<Pack<T, VEC>*>(p) = t;
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
conv_epilogue_kernel(const Epilogue<T> e) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = ((long long)blockIdx.x * kThreads + threadIdx.x) * VEC;
       i < e.n; i += stride * VEC) {
    float v[VEC], t[VEC];
    load<T, VEC>(e.y + i, v);
    const T* b = e.bias + (int)(i % e.C);  // may be unaligned; in L1
#pragma unroll
    for (int k = 0; k < VEC; ++k) v[k] = op<T>(__fadd_rn(v[k], to_f(b[k])));
    if (e.res != nullptr) {
      load<T, VEC>(e.res + i, t);
#pragma unroll
      for (int k = 0; k < VEC; ++k) v[k] = op<T>(__fadd_rn(v[k], t[k]));
    }
    if (e.acc != nullptr) {
      load<T, VEC>(e.acc + i, t);
#pragma unroll
      for (int k = 0; k < VEC; ++k) v[k] = op<T>(__fadd_rn(t[k], v[k]));
    }
    if (e.divide) {
#pragma unroll
      for (int k = 0; k < VEC; ++k) v[k] = op<T>(__fmul_rn(v[k], e.inv_div));
    }
    if (e.pre != nullptr) store<T, VEC>(e.pre + i, v);
    if (e.act != nullptr) {
#pragma unroll
      for (int k = 0; k < VEC; ++k)
        v[k] = e.act_kind == kActTanh
                   ? tanhf(v[k])
                   : (v[k] > 0.0f ? v[k] : __fmul_rn(v[k], e.slope));
      store<T, VEC>(e.act + i, v);
    }
  }
}

bool aligned(const void* p, unsigned bytes) {
  return p == nullptr || ((uintptr_t)p & (bytes - 1)) == 0;
}

template <typename T>
int launch(const void* y, const void* bias, const void* res,
           const void* acc, void* pre, void* act, long long rows, int C,
           int div, int act_kind, float slope, int vec, cudaStream_t st) {
  const unsigned bytes = 4 * sizeof(T);
  if (vec == 4 && (C % 4 != 0 || !aligned(y, bytes) || !aligned(res, bytes) ||
                   !aligned(acc, bytes) || !aligned(pre, bytes) ||
                   !aligned(act, bytes)))
    return (int)cudaErrorInvalidValue;
  const Epilogue<T> e{(const T*)y, (const T*)bias, (const T*)res,
                      (const T*)acc, (T*)pre, (T*)act, rows * (long long)C,
                      C, div, div > 0 ? 1.0f / (float)div : 1.0f, act_kind,
                      slope};
  if (e.n == 0) return (int)cudaSuccess;
  const long long groups = (e.n / vec + kThreads - 1) / kThreads;
  const int blocks = (int)(groups < kMaxBlocks ? groups : kMaxBlocks);
  if (vec == 4)
    conv_epilogue_kernel<T, 4><<<blocks, kThreads, 0, st>>>(e);
  else
    conv_epilogue_kernel<T, 1><<<blocks, kThreads, 0, st>>>(e);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K4.  y [rows, C], bias [C] and the optional res, acc (in), pre, act (out),
// all of one dtype (0 f32, 1 bf16, 2 f16) and contiguous on the current
// device; null for an absent operand.  div > 0 averages over div,
// act_kind 1 is leaky_relu(slope), 2 tanh; act must be given exactly when
// act_kind is not 0, and pre or act must be given.  vec 4 takes 4
// elements an access (C % 4 == 0 and every pointer but bias aligned to 4
// elements), 1 one.  Launches on `stream`, returns a CUDA error code.
int t2s_conv_epilogue(const void* y, const void* bias, const void* res,
                      const void* acc, void* pre, void* act,
                      long long rows, int C, int div, int act_kind,
                      float slope, int vec, int dtype, void* stream) {
  if (y == nullptr || bias == nullptr || rows < 0 || C < 1 || div < 0 ||
      act_kind < kActNone || act_kind > kActTanh ||
      (act_kind != kActNone) != (act != nullptr) ||
      (pre == nullptr && act == nullptr) || (vec != 1 && vec != 4))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case kF32:
      return launch<float>(y, bias, res, acc, pre, act, rows, C, div,
                           act_kind, slope, vec, st);
    case kBF16:
      return launch<__nv_bfloat16>(y, bias, res, acc, pre, act, rows, C,
                                   div, act_kind, slope, vec, st);
    case kF16:
      return launch<__half>(y, bias, res, acc, pre, act, rows, C, div,
                            act_kind, slope, vec, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* t2s_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
