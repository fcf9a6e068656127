// Polyphase regroup + complex matmul of the fused mixer/resampler, for Hopper.
//
// Replaces mix_regroup_matmul, the Pallas TPU kernel of the JAX package's
// ops/resample_pallas.py (body _kernel_cx). It computes, for frame f,
// polyphase group g and output phase p,
//
//     o[f, g, p] = sum_{c < W} x[f, g*down + c - pad_left] * B[p, c]
//
// with x complex (zero outside [0, n)) and B the oscillator-folded complex
// tap bank. Work is FP32 FMA (no TF32). At the FM geometry one channel batch
// moves ~213 MB and needs 10 * 20171 * 2381 complex MACs on the bank's
// nonzero taps (3.8 GFLOP), so memory bounds it (see ops/resample_kernel.py).
//
// Design: one CTA per (frame, tile of G consecutive groups). The CTA stages
// its contiguous input span (G-1)*down + W complex samples with cp.async
// (8-byte copies, zero-filled outside [0, n): the TPU caller's explicit
// left/right pads are never materialised) and the bank, packed once by
// pack_bank as (W, UPP) complex pairs with UPP = UP rounded to even, so one
// float4 shared-memory load broadcasts two phases to the whole warp. Thread
// t = half*G + gl owns group g0+gl and all UP phases (2*UP accumulators in
// registers) over the contraction half [half*Wh, min(W, (half+1)*Wh)); the
// two halves are summed through shared memory. Consecutive lanes read input
// samples `down` apart: for odd down the 8-byte loads fall in distinct banks.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KSPLIT = 2;
constexpr int MAX_SMEM = 227 * 1024;

__device__ __forceinline__ void cp_async_8(void* smem, const void* gmem,
                                           int src_bytes) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
}

template <int UP>
__global__ void __launch_bounds__(256) mix_regroup_kernel(
    const float2* __restrict__ x,       // (F, n) complex
    const float4* __restrict__ bank4,   // (W, UPP/2) pairs of complex taps
    float2* __restrict__ out,           // (F, groups, UP) complex
    int n, int W, int down, int groups, int pad_left, int G, int span_alloc) {
  constexpr int UPP = (UP + 1) & ~1;
  constexpr int Q = UPP / 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float4* bank_s = reinterpret_cast<float4*>(smem_raw);    // W * Q
  float2* span_s = reinterpret_cast<float2*>(bank_s + (size_t)W * Q);

  const int f = blockIdx.y;
  const int g0 = blockIdx.x * G;
  const int span_len = (G - 1) * down + W;
  const long long start = (long long)g0 * down - pad_left;
  const float2* xf = x + (size_t)f * n;

  for (int i = threadIdx.x; i < W * Q; i += blockDim.x)
    cp_async_16(bank_s + i, bank4 + i);
  for (int i = threadIdx.x; i < span_len; i += blockDim.x) {
    const long long s = start + i;
    const bool in = s >= 0 && s < n;
    cp_async_8(span_s + i, in ? xf + s : xf, in ? 8 : 0);
  }
  cp_async_wait_all();
  __syncthreads();

  const int half = threadIdx.x / G;
  const int gl = threadIdx.x - half * G;
  const int wh = (W + KSPLIT - 1) / KSPLIT;
  const int c0 = half * wh;
  const int c1 = min(W, c0 + wh);

  float ar[UP], ai[UP];
#pragma unroll
  for (int p = 0; p < UP; ++p) ar[p] = ai[p] = 0.f;

  const float2* xs = span_s + gl * down;
#pragma unroll 2
  for (int c = c0; c < c1; ++c) {
    const float2 v = xs[c];
    const float4* b = bank_s + c * Q;
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const float4 t = b[q];
      ar[2 * q] = fmaf(v.x, t.x, fmaf(-v.y, t.y, ar[2 * q]));
      ai[2 * q] = fmaf(v.x, t.y, fmaf(v.y, t.x, ai[2 * q]));
      if (2 * q + 1 < UP) {
        ar[2 * q + 1] = fmaf(v.x, t.z, fmaf(-v.y, t.w, ar[2 * q + 1]));
        ai[2 * q + 1] = fmaf(v.x, t.w, fmaf(v.y, t.z, ai[2 * q + 1]));
      }
    }
  }

  // split-K reduction: the span buffer is free once every thread is done
  __syncthreads();
  float2* red = span_s;   // (G, UP), span_alloc >= G * UP
  if (half == 1) {
#pragma unroll
    for (int p = 0; p < UP; ++p) red[gl * UP + p] = make_float2(ar[p], ai[p]);
  }
  __syncthreads();
  const int g = g0 + gl;
  if (half == 0 && g < groups) {
    float2* o = out + ((size_t)f * groups + g) * UP;
#pragma unroll
    for (int p = 0; p < UP; ++p) {
      const float2 r = red[gl * UP + p];
      o[p] = make_float2(ar[p] + r.x, ai[p] + r.y);
    }
  }
  (void)span_alloc;
}

template <int UP>
cudaError_t launch(const float* x, const float* bank_packed, float* out, int F,
                   int n, int W, int down, int groups, int pad_left,
                   cudaStream_t stream) {
  constexpr int UPP = (UP + 1) & ~1;
  // largest tile of groups (a multiple of 32, at most 64) whose staged span
  // and bank fit in one CTA's shared memory
  for (int G = 64; G >= 32; G -= 32) {
    const long long span = (long long)(G - 1) * down + W;
    const long long span_alloc = span > (long long)G * UP ? span : (long long)G * UP;
    const long long smem = (long long)W * UPP * 8 + span_alloc * 8;
    if (smem > MAX_SMEM) continue;
    cudaError_t err = cudaFuncSetAttribute(
        mix_regroup_kernel<UP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    dim3 grid((groups + G - 1) / G, F);
    mix_regroup_kernel<UP><<<grid, G * KSPLIT, (size_t)smem, stream>>>(
        reinterpret_cast<const float2*>(x),
        reinterpret_cast<const float4*>(bank_packed),
        reinterpret_cast<float2*>(out), n, W, down, groups, pad_left, G,
        (int)span_alloc);
    return cudaGetLastError();
  }
  return cudaErrorInvalidValue;   // window span too wide for shared memory
}

}  // namespace

extern "C" {

// x: (F, n, 2) float32; bank_packed: (W, UP rounded to even, 2) float32;
// out: (F, groups, UP, 2) float32; the pointers and the stream on card
// `device`, which the call makes current for the launch and then restores.
// Launches on `stream`, does not synchronise, and returns the first CUDA
// error that is not 0.
int mix_regroup_launch(const float* x, const float* bank_packed, float* out,
                       int F, int n, int W, int down, int groups, int up,
                       int pad_left, int device, void* stream) {
  if (F <= 0 || groups <= 0 || F > 65535 || up < 1 || up > 20 || device < 0)
    return (int)cudaErrorInvalidValue;
  int current;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (up) {
#define PR_CASE(U) \
  case U:          \
    err = launch<U>(x, bank_packed, out, F, n, W, down, groups, pad_left, s); \
    break;
    PR_CASE(1) PR_CASE(2) PR_CASE(3) PR_CASE(4) PR_CASE(5)
    PR_CASE(6) PR_CASE(7) PR_CASE(8) PR_CASE(9) PR_CASE(10)
    PR_CASE(11) PR_CASE(12) PR_CASE(13) PR_CASE(14) PR_CASE(15)
    PR_CASE(16) PR_CASE(17) PR_CASE(18) PR_CASE(19) PR_CASE(20)
#undef PR_CASE
  }
  if (current != device) {
    const cudaError_t back = cudaSetDevice(current);
    if (err == cudaSuccess) err = back;
  }
  return (int)err;
}

const char* mix_regroup_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
