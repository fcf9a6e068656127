// Fused four-step FFT, for Hopper.
//
// Replaces _fft_fused_planes, the Pallas TPU kernel of the JAX package's
// ops/fft_pallas.py (body _kernel, wrapper fft_fused). For each of B frames
// of N = R*C complex samples, viewed as x[r, c] with n = c + C*r, it computes
//
//     A[k1, c]  = sum_r W_R^(r*k1) x[r, c]        (column DFTs)
//     Z[k1, c]  = A[k1, c] * W_N^(k1*c)           (twiddle)
//     Y[k1, k2] = sum_c W_C^(c*k2) Z[k1, c]       (row DFTs)
//     out[k1 + R*k2] = scale * Y[k1, k2]          (transposed store)
//
// with W_M = exp(-2 pi i / M) forward and its conjugate for the inverse,
// where the caller passes scale = 1/N (exact, N a power of two). The
// butterfly twiddles W_R^k, W_C^k (k < R/2, C/2) and the (R, C) plane
// W_N^(k1*c) come from the host, computed in float64 from reduced angles
// ((k*c mod N)/N) and rounded once to float32.
//
// What bounds it: bytes. One pass over x in and out is 16 bytes a sample:
// 125.8 MB for the FM clutter's forward call (B = 30, N = 2^18), 0.0376 ms
// at 3.35 TB/s, against 5 N log2 N = 0.71 GFLOP, 0.011 ms at 67 TFLOP/s.
// The TPU kernel holds a whole frame (2 MB at 2^18) in VMEM and touches HBM
// once; a CTA here has at most 227 KB of shared memory, so one frame does
// not fit and the design is two passes through device memory, twice the
// bound's bytes, plus the twiddle plane (2 MB, read from L2):
//
//   pass 1 (fft_columns): a CTA loads TC = 4096/R adjacent columns of all R
//     rows (each row's TC samples are contiguous: coalesced), runs TC R-point
//     FFTs in shared memory, multiplies by the twiddle plane and writes Z in
//     x's layout;
//   pass 2 (fft_rows): a CTA loads TR = 4096/C contiguous rows of Z, runs TR
//     C-point FFTs and stores out[k1 + R*k2] so that the TR rows of one k2
//     are contiguous (coalesced). Its rows are padded by 32/TR samples so the
//     transposed reads from shared memory are free of bank conflicts.
//
// Each FFT is radix-2 Stockham (self-sorting: natural order in and out, no
// bit reversal), ping-ponging two 32 KB tiles, one __syncthreads per stage,
// in FP32. A one-pass design (a thread-block cluster holding a frame in
// distributed shared memory), TMA and higher radices are later work.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int TILE = 4096;      // complex samples per tile
constexpr int MAX_L = 512;      // largest R or C
constexpr int MIN_C = 128;      // TR = TILE / C <= 32
constexpr int SMEM_MAX = (2 * (TILE + 32) + MAX_L / 2) * 8;

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(fmaf(a.x, b.x, -a.y * b.y), fmaf(a.x, b.y, a.y * b.x));
}

// Radix-2 Stockham FFTs of 2^logCount transforms of length L = 2^logL held
// in shared memory, element j of transform t at t*tstride + j*estride, in
// natural order in `a`. Ping-pongs with `b` and returns the buffer that
// holds the natural-order result. w[k] = W_L^k for k < L/2. With T_FAST,
// consecutive threads take consecutive transforms, else consecutive
// butterflies of one transform.
template <bool T_FAST>
__device__ float2* stockham(float2* a, float2* b, int logL, int logCount,
                            int estride, int tstride,
                            const float2* __restrict__ w) {
  const int half = 1 << (logL - 1);
  const int total = half << logCount;
  for (int s = 0; s < logL; ++s) {
    const int ns = 1 << s;
    const int wshift = logL - 1 - s;      // W_{2ns}^k = W_L^(k << wshift)
    for (int q = threadIdx.x; q < total; q += THREADS) {
      int t, j;
      if (T_FAST) {
        t = q & ((1 << logCount) - 1);
        j = q >> logCount;
      } else {
        j = q & (half - 1);
        t = q >> (logL - 1);
      }
      const int k = j & (ns - 1);
      const float2* in = a + t * tstride;
      float2* out = b + t * tstride;
      const float2 u = in[j * estride];
      const float2 v = cmul(in[(j + half) * estride], w[k << wshift]);
      const int o = ((j - k) << 1) + k;   // (j / ns) * 2ns + k
      out[o * estride] = make_float2(u.x + v.x, u.y + v.y);
      out[(o + ns) * estride] = make_float2(u.x - v.x, u.y - v.y);
    }
    __syncthreads();
    float2* tmp = a;
    a = b;
    b = tmp;
  }
  return a;
}

// Pass 1: grid (C / TC, B). Column DFTs of TC adjacent columns, twiddle,
// write Z[k1, c] at k1*C + c.
__global__ void __launch_bounds__(THREADS) fft_columns(
    const float2* __restrict__ x, float2* __restrict__ z,
    const float2* __restrict__ wr, const float2* __restrict__ tw, int logR,
    int logC, int logTC) {
  extern __shared__ float2 smem[];
  float2* a = smem;
  float2* b = smem + TILE;
  float2* w = smem + 2 * TILE;
  const int TC = 1 << logTC;
  const long long base = (long long)blockIdx.y << (logR + logC);
  const int c0 = blockIdx.x << logTC;
  for (int k = threadIdx.x; k < (1 << (logR - 1)); k += THREADS) w[k] = wr[k];
  for (int e = threadIdx.x; e < TILE; e += THREADS) {
    const int r = e >> logTC, c = e & (TC - 1);
    a[e] = x[base + ((long long)r << logC) + c0 + c];
  }
  __syncthreads();
  const float2* y = stockham<true>(a, b, logR, logTC, TC, 1, w);
  for (int e = threadIdx.x; e < TILE; e += THREADS) {
    const int k1 = e >> logTC, c = e & (TC - 1);
    const int idx = (k1 << logC) + c0 + c;
    z[base + idx] = cmul(y[e], tw[idx]);
  }
}

// Pass 2: grid (R / TR, B). Row DFTs of TR adjacent rows of Z, stored
// transposed: out[k2*R + k1].
__global__ void __launch_bounds__(THREADS) fft_rows(
    const float2* __restrict__ z, float2* __restrict__ out,
    const float2* __restrict__ wc, int logR, int logC, int logTR,
    float scale) {
  extern __shared__ float2 smem[];
  const int C = 1 << logC, TR = 1 << logTR;
  // row stride: the transposed reads below take 32/TR samples from each
  // of TR rows per warp; the pad puts them in distinct bank pairs
  const int P = C + (32 >> logTR);
  float2* a = smem;
  float2* b = smem + TR * P;
  float2* w = smem + 2 * TR * P;
  const long long base = (long long)blockIdx.y << (logR + logC);
  const int r0 = blockIdx.x << logTR;
  for (int k = threadIdx.x; k < C / 2; k += THREADS) w[k] = wc[k];
  for (int e = threadIdx.x; e < TILE; e += THREADS) {
    const int row = e >> logC, c = e & (C - 1);
    a[row * P + c] = z[base + ((long long)(r0 + row) << logC) + c];
  }
  __syncthreads();
  const float2* y = stockham<false>(a, b, logC, logTR, 1, P, w);
  for (int e = threadIdx.x; e < TILE; e += THREADS) {
    const int row = e & (TR - 1), k2 = e >> logTR;
    const float2 v = y[row * P + k2];
    out[base + ((long long)k2 << logR) + r0 + row] =
        make_float2(v.x * scale, v.y * scale);
  }
}

int log2_exact(int v) {
  int l = 0;
  while ((1 << l) < v) ++l;
  return (1 << l) == v ? l : -1;
}

}  // namespace

extern "C" {

// x, z, out: (B, R*C, 2) float32 (complex64), z is scratch of x's size;
// wr: (R/2, 2), wc: (C/2, 2), tw: (R, C, 2) float32 tables (see the note
// above). Requires R, C powers of two, 4096/C <= 32, R, C <= 512,
// R*C >= 4096 and 1 <= B <= 65535. Launches both passes on `stream`, does
// not synchronise, and returns the first cudaGetLastError() that is not 0.
int fft_fused_launch(const float* x, float* z, float* out, const float* wr,
                     const float* wc, const float* tw, int B, int R, int C,
                     float scale, void* stream) {
  const int logR = log2_exact(R), logC = log2_exact(C);
  if (B < 1 || B > 65535 || logR < 1 || logC < 1 || R > MAX_L ||
      C > MAX_L || C < MIN_C || R * C < TILE)
    return (int)cudaErrorInvalidValue;
  const int logTC = log2_exact(TILE / R), logTR = log2_exact(TILE / C);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // both tiles exceed the 48 KB a launch gets without this opt-in
  cudaError_t err = cudaFuncSetAttribute(
      fft_columns, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(
      fft_rows, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
  if (err != cudaSuccess) return (int)err;
  const size_t smem1 = (size_t)(2 * TILE + R / 2) * sizeof(float2);
  const size_t smem2 = (size_t)(2 * (TILE + 32) + C / 2) * sizeof(float2);
  fft_columns<<<dim3(C >> logTC, B), THREADS, smem1, s>>>(
      reinterpret_cast<const float2*>(x), reinterpret_cast<float2*>(z),
      reinterpret_cast<const float2*>(wr), reinterpret_cast<const float2*>(tw),
      logR, logC, logTC);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fft_rows<<<dim3(R >> logTR, B), THREADS, smem2, s>>>(
      reinterpret_cast<const float2*>(z), reinterpret_cast<float2*>(out),
      reinterpret_cast<const float2*>(wc), logR, logC, logTR, scale);
  return (int)cudaGetLastError();
}

const char* fft_fused_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
