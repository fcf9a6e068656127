// Batched complex NLMS clutter canceller, for Hopper.
//
// Replaces nlms_filter_pallas, the Pallas TPU kernel of the JAX package's
// ops/nlms_pallas.py (body _nlms_kernel). For each frame b, with
// m = filter_len + peek taps w (kept unflipped: w[j] weighs ref[k+1+j]) and
// steps = n - m, step k = 0 .. steps-1 computes
//
//     u = ref[b, k+1 : k+1+m]
//     e = srv[b, k+filter_len] - w^H u            -> out[b, filter_len+k]
//     w = w + mu * u * conj(e) / g(u^H u)
//
// with g(x) = max(x, 1e-30) (zero_window "zero", the TPU kernel's guard: an
// all-zero window leaves w unchanged) or g(x) = x ("nan", the JAX scan's
// plain division: an all-zero window turns w into NaN). out is zero on
// [0, filter_len) and [filter_len+steps, n).
//
// What bounds it: 16*m FLOP per step and frame are needed (8m for w^H u,
// 8m for the update; u^H u costs O(1) per step with a sliding update). At
// the FM geometry (F = 10, n = 262144, m = 185, 261959 steps) that is
// 7.75 GFLOP, 0.116 ms at the H100's 67 TFLOP/s FP32, against 63 MB of I/O
// (0.019 ms at 3.35 TB/s): operations bound it on paper. What holds it
// back is the recurrence: 261959 dependent steps per frame, each a dot
// product, a warp reduction, a division and an update, and only F warps
// in flight (10 of the card's 132 SMs busy at F = 10). Its time is the
// latency of one step times the step count.
//
// Design: one warp (one CTA) per frame. Lane l holds the taps j = l + 32*i,
// i < K = ceil(m/32), in registers (K is a template parameter, m <= 32*16).
// The warp stages CHUNK steps' worth of ref (CHUNK + m - 1 samples) and srv
// (CHUNK samples) in shared memory; step k reads its window there, lane l
// element i at ref[k+1+l+32*i], so the 32 lanes read 32 consecutive
// complex samples. FP32 FMAs build three partial sums per lane, Re w^H u,
// Im w^H u and u^H u; an xor-shuffle all-reduce leaves the same sums in
// every lane (a + b == b + a bit for bit), every lane forms e and the scale
// and updates its own taps. u^H u is recomputed exactly each step (2 FMAs a
// tap, off the critical path, which also keeps an all-zero window exactly
// zero), not carried by a running update. Lane (k mod 32) keeps e; every 32
// steps the warp stores 32 errors in one coalesced run. The TPU kernel's
// chunked u^H u (an exact start norm plus prefix-summed deltas), its
// 128-lane padding of m and its doubled reference planes exist for lane
// rolls and VMEM and are not carried over.

#include <cuda_runtime.h>

namespace {

constexpr int WARP = 32;
constexpr int CHUNK = 512;   // steps staged in shared memory at a time
constexpr int MAX_K = 16;    // taps per lane: m <= 512
constexpr unsigned FULL = 0xffffffffu;

template <int K>
__global__ void __launch_bounds__(WARP) nlms_kernel(
    const float2* __restrict__ ref,   // (B, n)
    const float2* __restrict__ srv,   // (B, n)
    const float2* __restrict__ w0,    // (B, m) unflipped, or null for zeros
    float2* __restrict__ out,         // (B, n)
    float2* __restrict__ w_out,       // (B, m) unflipped, or null
    int n, int filter_len, int m, float mu, int nan_window) {
  extern __shared__ float2 smem[];
  float2* win = smem;                 // CHUNK + m - 1 samples of ref
  float2* dsr = smem + CHUNK + m;     // CHUNK samples of srv
  const int lane = threadIdx.x;
  const long long row = (long long)blockIdx.x * n;
  ref += row;
  srv += row;
  out += row;
  const int steps = n - m;

  float wr[K], wi[K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const int j = lane + WARP * i;
    float2 w = make_float2(0.f, 0.f);
    if (w0 != nullptr && j < m) w = w0[(long long)blockIdx.x * m + j];
    wr[i] = w.x;
    wi[i] = w.y;
  }
  for (int j = lane; j < filter_len; j += WARP) out[j] = make_float2(0.f, 0.f);
  for (int j = filter_len + steps + lane; j < n; j += WARP)
    out[j] = make_float2(0.f, 0.f);

  for (int k0 = 0; k0 < steps; k0 += CHUNK) {
    const int T = min(CHUNK, steps - k0);
    __syncwarp();
    // the last sample read is ref[k0 + T + m - 1] <= ref[n - 1]
    for (int j = lane; j < T + m - 1; j += WARP) win[j] = ref[k0 + 1 + j];
    for (int j = lane; j < T; j += WARP) dsr[j] = srv[k0 + filter_len + j];
    __syncwarp();

    float2 ebuf = make_float2(0.f, 0.f);
    for (int t = 0; t < T; ++t) {
      float ur[K], ui[K];
      float dr = 0.f, di = 0.f, uu = 0.f;
#pragma unroll
      for (int i = 0; i < K; ++i) {
        const int j = lane + WARP * i;
        const float2 u = (j < m) ? win[t + j] : make_float2(0.f, 0.f);
        ur[i] = u.x;
        ui[i] = u.y;
        // conj(w) u = (wr ur + wi ui) + i (wr ui - wi ur)
        dr = fmaf(wr[i], u.x, dr);
        dr = fmaf(wi[i], u.y, dr);
        di = fmaf(wr[i], u.y, di);
        di = fmaf(-wi[i], u.x, di);
        uu = fmaf(u.x, u.x, uu);
        uu = fmaf(u.y, u.y, uu);
      }
#pragma unroll
      for (int off = WARP / 2; off > 0; off >>= 1) {
        dr += __shfl_xor_sync(FULL, dr, off);
        di += __shfl_xor_sync(FULL, di, off);
        uu += __shfl_xor_sync(FULL, uu, off);
      }
      const float2 d = dsr[t];
      const float er = d.x - dr;
      const float ei = d.y - di;
      // "zero": max(uu, 1e-30), written so that a NaN uu stays NaN
      const float g = (nan_window || !(uu < 1e-30f)) ? uu : 1e-30f;
      const float scale = mu / g;
      const float t1 = er * scale;
      const float t2 = ei * scale;
      // w += u conj(e) scale = (ur t1 + ui t2) + i (ui t1 - ur t2)
#pragma unroll
      for (int i = 0; i < K; ++i) {
        if (lane + WARP * i < m) {
          wr[i] = fmaf(ui[i], t2, fmaf(ur[i], t1, wr[i]));
          wi[i] = fmaf(-ur[i], t2, fmaf(ui[i], t1, wi[i]));
        }
      }
      const int slot = t & (WARP - 1);
      if (lane == slot) ebuf = make_float2(er, ei);
      if (slot == WARP - 1 || t == T - 1) {
        if (lane <= slot) out[filter_len + k0 + (t - slot) + lane] = ebuf;
      }
    }
  }

  if (w_out != nullptr) {
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const int j = lane + WARP * i;
      if (j < m) w_out[(long long)blockIdx.x * m + j] = make_float2(wr[i], wi[i]);
    }
  }
}

template <int K>
cudaError_t launch(const float2* ref, const float2* srv, const float2* w0,
                   float2* out, float2* w_out, int B, int n, int filter_len,
                   int m, float mu, int nan_window, cudaStream_t stream) {
  const size_t smem = (size_t)(2 * CHUNK + m) * sizeof(float2);
  nlms_kernel<K><<<B, WARP, smem, stream>>>(ref, srv, w0, out, w_out, n,
                                            filter_len, m, mu, nan_window);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// ref, srv, out: (B, n, 2) float32 (complex64); w0, w_out: (B, m, 2)
// float32 in the unflipped order, either may be null. Requires
// 1 <= filter_len, m = filter_len + peek <= 512 and n > m. Launches on
// `stream`, does not synchronise, and returns cudaGetLastError() of the
// launch.
int nlms_launch(const float* ref, const float* srv, const float* w0,
                float* out, float* w_out, int B, int n, int filter_len, int m,
                float mu, int nan_window, void* stream) {
  if (B <= 0 || filter_len < 1 || m < filter_len || m > WARP * MAX_K ||
      n <= m)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float2* r = reinterpret_cast<const float2*>(ref);
  const float2* v = reinterpret_cast<const float2*>(srv);
  const float2* w = reinterpret_cast<const float2*>(w0);
  float2* o = reinterpret_cast<float2*>(out);
  float2* wo = reinterpret_cast<float2*>(w_out);
  switch ((m + WARP - 1) / WARP) {
#define PR_CASE(K) \
  case K:          \
    return (int)launch<K>(r, v, w, o, wo, B, n, filter_len, m, mu, nan_window, s);
    PR_CASE(1) PR_CASE(2) PR_CASE(3) PR_CASE(4) PR_CASE(5) PR_CASE(6)
    PR_CASE(7) PR_CASE(8) PR_CASE(9) PR_CASE(10) PR_CASE(11) PR_CASE(12)
    PR_CASE(13) PR_CASE(14) PR_CASE(15) PR_CASE(16)
#undef PR_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* nlms_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
