// Levinson-Durbin recursion for a batch of Hermitian Toeplitz systems, for
// Hopper: x = T^-1 e_0 from each T's first column.
//
// Replaces levinson_first_col of the JAX package's ops/clutter.py (:113), a
// lax.scan over the order (:162) that XLA compiles into one while loop (no
// Pallas kernel there). Its contract is the port's plain loop,
// ops/levinson_kernel.py levinson_first_col_plain. For each system b, with
// c = c[b, 0..m-1] (complex64) and a_1 = e_0, e_1 = re c[0], ar_1 = e_1
// (the reversed conjugate of a_1, shifted by one sample), step
// k = 1 .. m-1 computes
//
//     kappa   = -(sum_{j<k} a[j] c[k-j]) / e
//     a      <- a + kappa ar
//     ar     <- shift_1(ar + conj(kappa) a)     (the old a)
//     e      <- e (1 - |kappa|^2)
//
// and x[b] = a / e. a has degree k-1 entering step k and ar its support
// [1, k], so a step touches j <= k only.
//
// Design: one warp a system, four warps a CTA (a CTA of fewer warps only
// where one warp's shared memory needs it). A lane holds a[j] for
// j = lane + 32 i in registers (I slots, I a power of two with 32 I >= m,
// up to m = 512; above that a lives in shared memory too). c is staged in
// shared memory once. Each step is one complex multiply-add a slot over
// j < k, one warp-shuffle butterfly (five levels, every lane ends with the
// same sum, so no broadcast), one division, and the update of the slots
// with j <= k. The one-sample shift of ar costs nothing: ar lives in shared
// memory as R with ar_k[j] = R[j + m - k], so each step's update reads and
// writes R at the same place, R[j + m - k] += conj(kappa) a[j], and the
// shift is the offset's decrement. A lane writes only the entries it reads,
// so one __syncwarp a step orders the hand-over to the neighbour that reads
// it next step; R[m - k - 1] (ar's zero at j = 0) is never written. No
// block barrier, no global memory inside the recursion. This is what the
// suggested design's __shfl_up shift becomes: four shuffles a slot traded
// for one shared load and store that the update needs anyway.
//
// What bounds it: not the card's rates. A launch reads B m complex values
// and writes B m: at the FM geometry (B = 50 systems of m = 185) 148 KB,
// 44 ns at 3.35 TB/s. The arithmetic is about 24 k + 16 float operations at
// step k, 12 m^2 a system: 20.4 MFLOP, 0.3 us at 67 TFLOP/s. Its time is
// the chain of m - 1 dependent steps, each a shared load, a multiply-add,
// a five-level shuffle reduction, a division and the update, whatever B
// is: at FM 13 CTAs on 132 SMs. Its figure of merit is ns a step.

#include <cuda_runtime.h>

namespace {

constexpr int WARP = 32;
constexpr int WARPS = 4;                  // systems a CTA
constexpr int MAX_M = 8192;               // one warp's c, R and a in shared
constexpr int MAX_DEVICES = 64;
constexpr int VARIANTS = 6;               // I = 1, 2, 4, 8, 16 and 0
constexpr unsigned FULL = 0xffffffffu;

// float2 words of one warp's shared memory: c (m), R (m + 1), and a (m)
// when it does not live in registers
__host__ __device__ inline int warp_words(int m, bool a_shared) {
  return 2 * m + 1 + (a_shared ? m : 0);
}

__device__ __forceinline__ float2 cmac(float2 acc, float2 p, float2 q) {
  acc.x += p.x * q.x - p.y * q.y;
  acc.y += p.x * q.y + p.y * q.x;
  return acc;
}

// one step's update of a[j] and R[j + off] with the old values
__device__ __forceinline__ void update(float2& a, float2* r_at, float2 kap) {
  const float2 r = *r_at, ao = a;
  a = make_float2(ao.x + kap.x * r.x - kap.y * r.y,
                  ao.y + kap.x * r.y + kap.y * r.x);
  *r_at = make_float2(r.x + kap.x * ao.x + kap.y * ao.y,
                      r.y + kap.x * ao.y - kap.y * ao.x);
}

// I > 0: a in I register slots a lane; I == 0: a in shared memory
template <int I>
__global__ void __launch_bounds__(WARPS * WARP)
levinson_kernel(const float2* __restrict__ c, float2* __restrict__ x, int B,
                int m) {
  extern __shared__ float2 sm[];
  const int lane = threadIdx.x % WARP;
  const int warp = threadIdx.x / WARP;
  const long long sys = (long long)blockIdx.x * (blockDim.x / WARP) + warp;
  if (sys >= B) return;                   // the whole warp: no block barrier
  float2* cs = sm + (size_t)warp * warp_words(m, I == 0);
  float2* R = cs + m;
  float2* as = R + m + 1;
  const float2* cg = c + sys * m;
  for (int t = lane; t < m; t += WARP) cs[t] = cg[t];
  for (int t = lane; t <= m; t += WARP)   // ar_1[1] = 1 at R[1 + m - 1]
    R[t] = make_float2(t == m ? 1.f : 0.f, 0.f);
  float2 reg[I > 0 ? I : 1];
  if constexpr (I > 0) {
#pragma unroll
    for (int i = 0; i < I; ++i)
      reg[i] = make_float2(lane + WARP * i == 0 ? 1.f : 0.f, 0.f);
  } else {
    for (int t = lane; t < m; t += WARP)
      as[t] = make_float2(t == 0 ? 1.f : 0.f, 0.f);
  }
  __syncwarp();
  float e = cs[0].x;

  for (int k = 1; k < m; ++k) {
    float2 acc = make_float2(0.f, 0.f);
    if constexpr (I > 0) {
#pragma unroll
      for (int i = 0; i < I; ++i) {
        const int j = lane + WARP * i;
        if (WARP * i < k && j < k) acc = cmac(acc, reg[i], cs[k - j]);
      }
    } else {
      for (int j = lane; j < k; j += WARP) acc = cmac(acc, as[j], cs[k - j]);
    }
#pragma unroll
    for (int s = WARP / 2; s > 0; s >>= 1) {
      acc.x += __shfl_xor_sync(FULL, acc.x, s);
      acc.y += __shfl_xor_sync(FULL, acc.y, s);
    }
    const float2 kap = make_float2(-acc.x / e, -acc.y / e);
    float2* Rk = R + (m - k);
    if constexpr (I > 0) {
#pragma unroll
      for (int i = 0; i < I; ++i) {
        const int j = lane + WARP * i;
        if (WARP * i <= k && j <= k) update(reg[i], Rk + j, kap);
      }
    } else {
      for (int j = lane; j <= k; j += WARP) update(as[j], Rk + j, kap);
    }
    e *= 1.f - (kap.x * kap.x + kap.y * kap.y);
    __syncwarp();
  }

  float2* xg = x + sys * m;
  if constexpr (I > 0) {
#pragma unroll
    for (int i = 0; i < I; ++i) {
      const int j = lane + WARP * i;
      if (j < m) xg[j] = make_float2(reg[i].x / e, reg[i].y / e);
    }
  } else {
    for (int j = lane; j < m; j += WARP)
      xg[j] = make_float2(as[j].x / e, as[j].y / e);
  }
}

using Kernel = void (*)(const float2*, float2*, int, int);
const Kernel KERNELS[VARIANTS] = {levinson_kernel<1>, levinson_kernel<2>,
                                  levinson_kernel<4>, levinson_kernel<8>,
                                  levinson_kernel<16>, levinson_kernel<0>};

// the variant for m: the fewest register slots that hold a, else shared
int variant(int m) {
  for (int v = 0; v < VARIANTS - 1; ++v)
    if (m <= WARP << v) return v;
  return VARIANTS - 1;
}

// The largest dynamic shared memory a block may opt into, once per device.
int optin_bytes[MAX_DEVICES];

}  // namespace

extern "C" {

// c, x: (B, m) complex64 as (B, m, 2) float32, contiguous, on card
// `device`, which the call makes current for the launch and then restores.
// Requires B >= 1 and 1 <= m <= levinson_max_order(). Launches on `stream`,
// does not synchronise, and returns the first CUDA error that is not 0
// (cudaErrorInvalidValue for sizes it does not take).
int levinson_launch(const float* c, float* x, int B, int m, int device,
                    void* stream) {
  if (B < 1 || m < 1 || m > MAX_M || device < 0 || device >= MAX_DEVICES)
    return (int)cudaErrorInvalidValue;
  int current;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (optin_bytes[device] == 0) {
    int most = 0;
    err = cudaDeviceGetAttribute(
        &most, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    for (int v = 0; v < VARIANTS && err == cudaSuccess; ++v)
      err = cudaFuncSetAttribute(KERNELS[v],
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 most);
    if (err == cudaSuccess) optin_bytes[device] = most;
  }
  const int v = variant(m);
  const size_t per_warp =
      (size_t)warp_words(m, v == VARIANTS - 1) * sizeof(float2);
  int warps = WARPS;
  while (warps > 1 && warps * per_warp > (size_t)optin_bytes[device]) --warps;
  if (err == cudaSuccess && per_warp > (size_t)optin_bytes[device])
    err = cudaErrorInvalidValue;
  if (err == cudaSuccess) {
    const int grid = (int)(((long long)B + warps - 1) / warps);
    KERNELS[v]<<<grid, warps * WARP, warps * per_warp,
                 static_cast<cudaStream_t>(stream)>>>(
        reinterpret_cast<const float2*>(c), reinterpret_cast<float2*>(x), B,
        m);
    err = cudaGetLastError();
  }
  if (current != device) {
    const cudaError_t back = cudaSetDevice(current);
    if (err == cudaSuccess) err = back;
  }
  return (int)err;
}

// The largest order m a launch takes.
int levinson_max_order() { return MAX_M; }

const char* levinson_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
