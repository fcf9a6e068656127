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
// [1, k].
//
// Design: the Schur-Levinson recursion. The kernel carries the residual
// correlations u[i] = sum_j a[j] c[i-j] and v[i] = sum_j ar[j] c[i-j] for
// i >= k beside the polynomials. Convolution with c is linear, so the
// updates carry over: u <- u + kappa v, v <- shift_1(v + conj(kappa) u),
// from u_1[i] = c[i], v_1[i] = c[i-1]; and kappa = -u[k] / e is one entry,
// with no sum. a lives on j < k and u on i >= k, so one array X holds both,
// X[j] = a[j] below k and u[j] from k on, and one array Y holds ar below
// the diagonal and v from it on; every entry then takes the same update
//
//     X[j] <- X[j] + kappa Y_k[j],  Y_k[j] <- Y_k[j] + conj(kappa) X[j]
//
// with old values on the right, except the pivot j = k, whose X becomes
// a[k] = kappa (ar[k] = conj(a[0]) = 1; u[k] is spent) while its Y carries
// v on. The one-sample shifts cost nothing: Y lives in shared memory with
// Y_k[j] = Y[j + m - k], so each step updates every entry in place and the
// shift is the offset's decrement; Y starts as m zeros (ar, whose zero at
// j = 0, Y[m - k - 1], is never written) and c[0..m-2] (v_1).
//
// One warp a system, four warps a CTA (fewer only where one warp's shared
// memory needs it). A lane holds X[j] for j = lane + 32 i in registers (I
// = ceil(m / 32) slots, up to m = 512; above that X lives in shared memory
// too). The next kappa needs u_k[k+1] and v_k[k+1] only; the lanes that
// update those two entries in step k - 1 also write them to two side cells
// (by the step's parity, so that a step never writes what it reads), and
// each lane reads both at the top of step k, with its Y entries. A step is
// then one straight run with no branch: the loads, the next kappa (one
// multiply-add, one reciprocal, two products), the entry updates, which do
// not depend on each other, the predicated stores, and one __syncwarp that
// orders Y's hand-over to the neighbour that reads it next step. No
// cross-lane reduction, no shuffle, no block barrier, no global memory
// inside the recursion.
//
// What bounds it: not the card's rates. A launch reads B m complex values
// and writes B m: at the FM geometry (B = 50 systems of m = 185) 148 KB,
// 44 ns at 3.35 TB/s. The plain recursion's arithmetic is about 12 m^2
// float operations a system (20.6 MFLOP at FM, 0.3 us at 67 TFLOP/s); this
// one does ~16 m a step, ~16 m^2 a system. Its time is m - 1 dependent
// steps, whatever B is (at FM 13 CTAs on 132 SMs): a step is one warp
// issuing ~17 instructions an entry for its ceil(m / 32) entries a lane
// (~160 at FM), after the shared-memory latency of the step's loads, which
// wait for the last step's stores; alone on its SM sub-partition, the warp
// issues about one instruction every two cycles (~157 ns a step at FM on
// an H100). Its figure of merit is ns a step.

#include <cuda_runtime.h>

namespace {

constexpr int WARP = 32;
constexpr int WARPS = 4;                  // systems a CTA
constexpr int MAX_M = 8192;               // one warp's Y and X in shared
constexpr int MAX_DEVICES = 64;
constexpr int MAX_SLOTS = 16;             // register slots: m <= 512
constexpr int VARIANTS = MAX_SLOTS + 1;   // I = 1 .. 16, and 0
constexpr int SIDE = 4;                   // u_k[k+1] and v_k[k+1], by parity

// float2 words of one warp's shared memory: Y (2m - 1), the side cells, and
// X (m) when it does not live in registers
__host__ __device__ inline int warp_words(int m, bool x_shared) {
  return 2 * m - 1 + SIDE + (x_shared ? m : 0);
}

// x + kap y
__device__ __forceinline__ float2 cmad(float2 x, float2 kap, float2 y) {
  return make_float2(x.x + kap.x * y.x - kap.y * y.y,
                     x.y + kap.x * y.y + kap.y * y.x);
}

// y + conj(kap) x
__device__ __forceinline__ float2 cmad_conj(float2 y, float2 kap, float2 x) {
  return make_float2(y.x + kap.x * x.x + kap.y * x.y,
                     y.y + kap.x * x.y - kap.y * x.x);
}

// -u / e, as u times one reciprocal
__device__ __forceinline__ float2 next_kappa(float2 u, float e) {
  const float r = __fdividef(1.f, e);
  return make_float2(-u.x * r, -u.y * r);
}

// Entry j's update at step k (old values in, new out; live: j < m); the
// pivot's X becomes kappa. The lanes of the two entries the next kappa
// reads also write them to the side cells of step k + 1's parity.
__device__ __forceinline__ void update(int j, int k, bool live, float2 kap,
                                       float2& xr, float2 yv, float2* yat,
                                       float2* side) {
  const float2 xo = xr;
  xr = j == k ? kap : cmad(xo, kap, yv);
  const float2 yn = cmad_conj(yv, kap, xo);
  if (live) *yat = yn;
  if (j == k + 2) side[(k + 1) & 1] = xr;
  if (j == k + 1) side[2 + ((k + 1) & 1)] = yn;
}

// I > 0: X in I register slots a lane; I == 0: X in shared memory
template <int I>
__global__ void __launch_bounds__(WARPS * WARP)
levinson_kernel(const float2* __restrict__ c, float2* __restrict__ x, int B,
                int m) {
  extern __shared__ float2 sm[];
  const int lane = threadIdx.x % WARP;
  const int warp = threadIdx.x / WARP;
  const long long sys = (long long)blockIdx.x * (blockDim.x / WARP) + warp;
  if (sys >= B) return;                   // the whole warp: no block barrier
  float2* Y = sm + (size_t)warp * warp_words(m, I == 0);
  float2* side = Y + 2 * m - 1;           // U[2], then V[2]
  float2* Xs = side + SIDE;
  const float2* cg = c + sys * m;
  const float2 zero = make_float2(0.f, 0.f), one = make_float2(1.f, 0.f);
  for (int t = lane; t < 2 * m - 1; t += WARP)
    Y[t] = t < m ? zero : cg[t - m];
  if (lane == 0) {                        // step 1 reads u_1[2], v_1[2]
    side[1] = m > 2 ? cg[2] : zero;
    side[3] = m > 1 ? cg[1] : zero;
  }
  float2 reg[I > 0 ? I : 1];
  if constexpr (I > 0) {
#pragma unroll
    for (int i = 0; i < I; ++i) {
      const int j = lane + WARP * i;
      reg[i] = j == 0 ? one : (j < m ? cg[j] : zero);
    }
  } else {
    for (int t = lane; t < m; t += WARP) Xs[t] = t == 0 ? one : cg[t];
  }
  float e = cg[0].x;
  float2 kap = m > 1 ? next_kappa(cg[1], e) : zero;
  __syncwarp();

#pragma unroll 2
  for (int k = 1; k < m; ++k) {
    float2* Yk = Y + (m - k);
    const float2 uk = side[k & 1], vk = side[2 + (k & 1)];
    const float e_next = e * (1.f - (kap.x * kap.x + kap.y * kap.y));
    // u_{k+1}[k+1] = u_k[k+1] + kappa v_k[k+1]
    const float2 kap_next = next_kappa(cmad(uk, kap, vk), e_next);
    if constexpr (I > 0) {
      // every slot but the last holds entries below m
      float2 y[I];
#pragma unroll
      for (int i = 0; i < I; ++i) {
        const int j = lane + WARP * i;
        y[i] = i < I - 1 || j < m ? Yk[j] : zero;
      }
#pragma unroll
      for (int i = 0; i < I; ++i) {
        const int j = lane + WARP * i;
        update(j, k, i < I - 1 || j < m, kap, reg[i], y[i], Yk + j, side);
      }
    } else {
      constexpr int U = 4;                // entries a lane in flight
      for (int j0 = lane; j0 < m; j0 += U * WARP) {
        float2 xv[U], y[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int j = j0 + u * WARP;
          xv[u] = j < m ? Xs[j] : zero;
          y[u] = j < m ? Yk[j] : zero;
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int j = j0 + u * WARP;
          update(j, k, j < m, kap, xv[u], y[u], Yk + j, side);
          if (j < m) Xs[j] = xv[u];
        }
      }
    }
    e = e_next;
    kap = kap_next;
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
      xg[j] = make_float2(Xs[j].x / e, Xs[j].y / e);
  }
}

using Kernel = void (*)(const float2*, float2*, int, int);
// KERNELS[I - 1] holds X in I register slots, KERNELS[MAX_SLOTS] in shared
const Kernel KERNELS[VARIANTS] = {
    levinson_kernel<1>,  levinson_kernel<2>,  levinson_kernel<3>,
    levinson_kernel<4>,  levinson_kernel<5>,  levinson_kernel<6>,
    levinson_kernel<7>,  levinson_kernel<8>,  levinson_kernel<9>,
    levinson_kernel<10>, levinson_kernel<11>, levinson_kernel<12>,
    levinson_kernel<13>, levinson_kernel<14>, levinson_kernel<15>,
    levinson_kernel<16>, levinson_kernel<0>};

// the variant for m: as many register slots as X needs, else shared
int variant(int m) {
  return m <= MAX_SLOTS * WARP ? (m + WARP - 1) / WARP - 1 : MAX_SLOTS;
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
