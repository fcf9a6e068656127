// Fused four-step FFT, for Hopper: two passes, radix-8 butterflies in
// registers.
//
// Replaces _fft_fused_planes, the Pallas TPU kernel of the JAX package's
// ops/fft_pallas.py (body _kernel, wrapper fft_fused). For each of B frames
// of N = R*C complex samples, viewed as x[r, c] with n = c + C*r, it computes
//
//     A[k1, c]  = sum_r W_R^(r*k1) x[r, c]        (column DFTs, pass 1)
//     Z[k1, c]  = A[k1, c] * W_N^(k1*c)           (twiddle, pass 1)
//     Y[k1, k2] = sum_c W_C^(c*k2) Z[k1, c]       (row DFTs, pass 2)
//     out[k1 + R*k2] = scale * Y[k1, k2]          (transposed store, pass 2)
//
// with W_M = exp(-2 pi i / M). The inverse runs the same forward arithmetic
// on conj(x) and stores conj(Y) / N (the exact 1/N, N a power of two):
// every rounding is the mirror image of the conjugate-twiddle transform's.
//
// What bounds it: bytes. One pass over x in and out is 16 bytes a sample:
// at 3.35 TB/s the one-pass bound is 0.0376 ms for the FM clutter's forward
// call (B = 30, N = 2^18, 125.8 MB), 0.0125 ms for its inverse (B = 10),
// 0.0100 ms at B = 8 and 0.0038 / 0.0013 ms for a stream push's forward
// (B = 3) and inverse (B = 1), against 5 N log2 N = 0.71 GFLOP, 0.011 ms at
// 67 TFLOP/s, for the forward call. A frame (2 MB at 2^18) does not fit a
// CTA's 227 KB, so the design is two passes through device memory, and
// twice those bounds (0.075, 0.025, 0.020, 0.0075, 0.0025 ms) is its floor.
//
// Design, against what held the radix-2 version (nine barriered stages a
// pass over two shared tiles, 8-byte staging, a twiddle plane from memory,
// host attribute calls per launch) back:
//
//  1. Registers hold the data. A thread owns two lanes of 8 complex samples
//     and runs the R- or C-point FFT as three Stockham stages, radix 8, 8
//     and L/64 (512 = 8*8*8, 256 = 8*8*4, 128 = 8*8*2), the butterflies in
//     registers. Between stages the tile goes once through one shared
//     buffer: 2 exchanges a pass, 3 barriers in pass 1 and 5 in pass 2
//     (2 more for its transposed store). Pass 1's buffer is
//     [element][column] with >= 16 columns, so every 16-byte access of a
//     quarter-warp is conflict-free; pass 2's rows are XOR-swizzled in pairs
//     of samples (pair ^ (pair >> 3 & 7) ^ (row >> 1 & 7), the row term
//     doubled at 8 rows a CTA), which makes every exchange and the
//     transposed read conflict-free.
//     Kernels are templated on log2 L so that the loops unroll; the launch
//     bounds cap them at 64 registers (1,024 threads an SM), and ptxas
//     reports no spills.
//  2. Global accesses are 16 bytes a thread, straight to and from registers.
//     Pass 1 takes 8,192 samples a CTA (512 threads): a thread owns two
//     adjacent columns, so a quarter-warp reads and writes TC*8 = 128
//     contiguous bytes of a row (TC = 16 at R = 512).
//     Pass 2 takes 4,096 samples a CTA (256 threads): a thread owns two
//     adjacent samples of a row (butterflies 2i, 2i+1), so a warp reads 512
//     contiguous bytes; its transposed store out[k1 + R*k2] goes through the
//     buffer so that each thread writes two adjacent k1 and a quarter-warp a
//     run of TR*8 bytes (64 at C = 512, TR = 8).
//     Of the four pairs of 4,096 and 8,192 samples, this one was the fastest
//     at B >= 10 on the H100 (PERF.md); both keep 1,024 threads an SM.
//  3. No twiddle plane from memory. Pass 1 computes W_N^(k1*c) with
//     sincospif from the reduced angle 2*((k1*c) mod N)/N (exact in float).
//     The butterflies' own twiddles, W_64^(r*k) for the middle stage and
//     W_L^(r*b) for the last, come from a 4 KB table per length, built in
//     float64 on the host and rounded once, copied to shared memory by each
//     CTA and read there without conflicts (each thread's entries are
//     adjacent to its neighbours').
//  4. Host cost: the dynamic shared-memory opt-in is set once per kernel and
//     device; a call is a cudaGetDevice, two launches and a
//     cudaGetLastError each.

#include <cuda_runtime.h>

namespace {

constexpr int MAX_DEVICES = 64;
constexpr int COL_LOGT = 13;               // log2 samples a CTA, pass 1
constexpr int ROW_LOGT = 12;               // and pass 2
constexpr int TW_MID = 56;                 // W_64^(r*k), r = 1..7, k < 8
constexpr int TW_MAX = TW_MID + 7 * 64;    // + W_L^(r*b), r < L/64, b < 64
constexpr float SQRT_HALF = 0.707106781186547524f;

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(fmaf(a.x, b.x, -a.y * b.y), fmaf(a.x, b.y, a.y * b.x));
}

// a, b <- a + b, a - b
__device__ __forceinline__ void bfly(float2& a, float2& b) {
  const float2 t = a;
  a = make_float2(t.x + b.x, t.y + b.y);
  b = make_float2(t.x - b.x, t.y - b.y);
}

__device__ __forceinline__ float2 mul_minus_i(float2 a) {
  return make_float2(a.y, -a.x);
}

// In-place DFTs, natural order in and out, forward sign.
__device__ __forceinline__ void dft2(float2& a0, float2& a1) { bfly(a0, a1); }

__device__ __forceinline__ void dft4(float2& a0, float2& a1, float2& a2,
                                     float2& a3) {
  bfly(a0, a2);
  bfly(a1, a3);
  a3 = mul_minus_i(a3);
  bfly(a0, a1);                            // X0, X2
  bfly(a2, a3);                            // X1, X3
  const float2 t = a1;
  a1 = a2;
  a2 = t;
}

__device__ __forceinline__ void dft8(float2& a0, float2& a1, float2& a2,
                                     float2& a3, float2& a4, float2& a5,
                                     float2& a6, float2& a7) {
  bfly(a0, a4);
  bfly(a1, a5);
  bfly(a2, a6);
  bfly(a3, a7);
  a5 = make_float2((a5.x + a5.y) * SQRT_HALF, (a5.y - a5.x) * SQRT_HALF);
  a6 = mul_minus_i(a6);
  a7 = make_float2((a7.y - a7.x) * SQRT_HALF, -(a7.x + a7.y) * SQRT_HALF);
  dft4(a0, a1, a2, a3);                    // X0, X2, X4, X6
  dft4(a4, a5, a6, a7);                    // X1, X3, X5, X7
  const float2 t1 = a1, t2 = a2, t3 = a3;
  a1 = a4;
  a2 = t1;
  a3 = a5;
  a4 = t2;
  a5 = a6;
  a6 = t3;
}

__device__ __forceinline__ void dft8(float2 (&v)[8]) {
  dft8(v[0], v[1], v[2], v[3], v[4], v[5], v[6], v[7]);
}

// The last Stockham stage, radix R3 = L/64, on a thread's 8 samples
// v[m] = x[j + L/8*m]: 8/R3 butterflies b = j + L/8*h on v[h + 8/R3*r].
template <int R3>
__device__ __forceinline__ void dft_last(float2 (&v)[8]) {
  if (R3 == 8) {
    dft8(v);
  } else if (R3 == 4) {
    dft4(v[0], v[2], v[4], v[6]);
    dft4(v[1], v[3], v[5], v[7]);
  } else {
#pragma unroll
    for (int h = 0; h < 4; ++h) dft2(v[h], v[h + 4]);
  }
}

__device__ __forceinline__ float2 lo(float4 q) { return make_float2(q.x, q.y); }
__device__ __forceinline__ float2 hi(float4 q) { return make_float2(q.z, q.w); }
__device__ __forceinline__ float4 pack(float2 a, float2 b) {
  return make_float4(a.x, a.y, b.x, b.y);
}

// Pass 1: grid (C / TC, B), TC = 2^(LOGT - LOGR) adjacent columns a CTA.
// Thread t owns columns c0 + 2*(t % (TC/2)) + {0, 1} and, in the first two
// stages, butterfly j = t / (TC/2) of each. Z[k1, c] = A[k1, c] W_N^(k1*c),
// written in x's layout. sgn = -1 conjugates x (the inverse).
template <int LOGR>
__global__ void __launch_bounds__(1 << (COL_LOGT - 4), 1 << (14 - COL_LOGT))
    fft_columns(const float4* __restrict__ x, float4* __restrict__ z,
                const float2* __restrict__ tw_g, int logC, float sgn) {
  constexpr int LOGT = COL_LOGT;
  constexpr int R = 1 << LOGR, T = 1 << (LOGT - 4);
  constexpr int HP = 1 << (LOGT - LOGR - 1);      // column pairs
  constexpr int S = R / 8, R3 = R / 64;
  constexpr int NTW = TW_MID + (R3 - 1) * 64;
  extern __shared__ float4 smem[];
  float4* buf = smem;                             // [e][pair], e < R
  float2* tw = reinterpret_cast<float2*>(smem + (1 << (LOGT - 1)));
  const int t = threadIdx.x, c2 = t % HP, j = t / HP;
  const int logN = LOGR + logC;
  const long long base = (long long)blockIdx.y << (logN - 1);   // in float4
  const int col = (blockIdx.x << (LOGT - LOGR)) + 2 * c2;
  for (int i = t; i < NTW; i += T) tw[i] = tw_g[i];

  float2 u[8], v[8];                              // columns col, col + 1
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    const float4 q = x[base + (((j + S * p) << logC) + col) / 2];
    u[p] = make_float2(q.x, sgn * q.y);
    v[p] = make_float2(q.z, sgn * q.w);
  }
  // stage 1: Ns = 1, radix 8, out[8j + r]
  dft8(u);
  dft8(v);
#pragma unroll
  for (int r = 0; r < 8; ++r) buf[(8 * j + r) * HP + c2] = pack(u[r], v[r]);
  __syncthreads();
  // stage 2: Ns = 8, radix 8, twiddle W_64^(r*k), k = j % 8
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const float4 q = buf[(j + S * r) * HP + c2];
    u[r] = lo(q);
    v[r] = hi(q);
    if (r > 0) {
      const float2 w = tw[(r - 1) * 8 + (j & 7)];
      u[r] = cmul(u[r], w);
      v[r] = cmul(v[r], w);
    }
  }
  dft8(u);
  dft8(v);
  __syncthreads();
#pragma unroll
  for (int r = 0; r < 8; ++r)
    buf[((j >> 3) * 64 + (j & 7) + 8 * r) * HP + c2] = pack(u[r], v[r]);
  __syncthreads();
  // stage 3: Ns = 64, radix R3, twiddle W_R^(r*b), b = j + S*h
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    const float4 q = buf[(j + S * m) * HP + c2];
    u[m] = lo(q);
    v[m] = hi(q);
    const int r = m / (8 / R3), h = m % (8 / R3);
    if (r > 0) {
      const float2 w = tw[TW_MID + (r - 1) * 64 + j + S * h];
      u[m] = cmul(u[m], w);
      v[m] = cmul(v[m], w);
    }
  }
  dft_last<R3>(u);
  dft_last<R3>(v);
  // A[k1, c] for k1 = j + S*m; twiddle W_N^(k1*c) from the reduced angle.
  // The samples go back to the thread's own buffer slots (no other thread
  // reads them) and are read again one by one: kept in registers through
  // the 16 sincospif, they spilled at R < 512 under the 64-register cap.
#pragma unroll
  for (int m = 0; m < 8; ++m) buf[(j + S * m) * HP + c2] = pack(u[m], v[m]);
  const int nmask = (1 << logN) - 1;
  const float two_over_n = 2.0f / (float)(1 << logN);
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    const int k1 = j + S * m;
    float s0, c0, s1, c1;
    sincospif((float)((k1 * col) & nmask) * two_over_n, &s0, &c0);
    sincospif((float)((k1 * (col + 1)) & nmask) * two_over_n, &s1, &c1);
    const float4 a = buf[(j + S * m) * HP + c2];
    z[base + ((k1 << logC) + col) / 2] = pack(
        cmul(lo(a), make_float2(c0, -s0)), cmul(hi(a), make_float2(c1, -s1)));
  }
}

// Pass 2's buffer: TR rows of C samples, pairs of samples XOR-swizzled.
// The row term spreads the transposed read's row pairs over the 8 banks of
// 16 bytes: with TR = 8 a quarter-warp holds 4 row pairs at 2 columns, so
// their terms are spaced by 2.
template <int LOGC>
__device__ __forceinline__ int pair_at(int row, int e) {
  constexpr int SPREAD = ROW_LOGT - LOGC == 3 ? 1 : 0;
  const int p = e >> 1;
  return (row << (LOGC - 1)) +
         (p ^ ((p >> 3) & 7) ^ (((row >> 1) << SPREAD) & 7));
}

// Pass 2: grid (R / TR, B), TR = 2^(LOGT - LOGC) adjacent rows of Z a CTA.
// Thread t owns, in row t / (C/16), butterflies 2i and 2i + 1 (i = t %
// (C/16)) of each stage; then writes out[k1 + R*k2] for two adjacent k1.
// out = (Y.x * scale_re, Y.y * scale_im).
template <int LOGC>
__global__ void __launch_bounds__(1 << (ROW_LOGT - 4), 1 << (14 - ROW_LOGT))
    fft_rows(const float4* __restrict__ z, float4* __restrict__ out,
             const float2* __restrict__ tw_g, int logR, float scale_re,
             float scale_im) {
  constexpr int LOGT = ROW_LOGT;
  constexpr int C = 1 << LOGC, T = 1 << (LOGT - 4);
  constexpr int TPR = C / 16, TR = 1 << (LOGT - LOGC);
  constexpr int S = C / 8, R3 = C / 64;
  constexpr int NTW = TW_MID + (R3 - 1) * 64;
  extern __shared__ float4 smem[];
  float4* buf = smem;
  float2* tw = reinterpret_cast<float2*>(smem + (1 << (LOGT - 1)));
  const float4* tw4 = reinterpret_cast<const float4*>(tw);
  const int t = threadIdx.x, i = t % TPR, row = t / TPR;
  const int logN = logR + LOGC;
  const long long base = (long long)blockIdx.y << (logN - 1);   // in float4
  const int r0 = blockIdx.x * TR;
  for (int k = t; k < NTW; k += T) tw[k] = tw_g[k];

  float2 u[8], v[8];                              // butterflies 2i, 2i + 1
  const float4* zrow = z + base + (((r0 + row) << LOGC) >> 1);
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    const float4 q = zrow[i + (S / 2) * p];
    u[p] = lo(q);
    v[p] = hi(q);
  }
  // stage 1: Ns = 1, out[8j + r] for j = 2i (u) and 2i + 1 (v)
  dft8(u);
  dft8(v);
#pragma unroll
  for (int r = 0; r < 8; r += 2) {
    buf[pair_at<LOGC>(row, 16 * i + r)] = pack(u[r], u[r + 1]);
    buf[pair_at<LOGC>(row, 16 * i + 8 + r)] = pack(v[r], v[r + 1]);
  }
  __syncthreads();
  // stage 2: Ns = 8, twiddle W_64^(r*k), k = j % 8 = 2(i % 4) + {0, 1}
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const float4 q = buf[pair_at<LOGC>(row, 2 * i + S * r)];
    u[r] = lo(q);
    v[r] = hi(q);
    if (r > 0) {
      const float4 w = tw4[(r - 1) * 4 + (i & 3)];
      u[r] = cmul(u[r], lo(w));
      v[r] = cmul(v[r], hi(w));
    }
  }
  dft8(u);
  dft8(v);
  __syncthreads();
#pragma unroll
  for (int r = 0; r < 8; ++r)
    buf[pair_at<LOGC>(row, (i >> 2) * 64 + 2 * (i & 3) + 8 * r)] =
        pack(u[r], v[r]);
  __syncthreads();
  // stage 3: Ns = 64, radix R3, twiddle W_C^(r*b), b = 2i + S*h + {0, 1}
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    const float4 q = buf[pair_at<LOGC>(row, 2 * i + S * m)];
    u[m] = lo(q);
    v[m] = hi(q);
    const int r = m / (8 / R3), h = m % (8 / R3);
    if (r > 0) {
      const float4 w = tw4[(TW_MID + (r - 1) * 64 + 2 * i + S * h) / 2];
      u[m] = cmul(u[m], lo(w));
      v[m] = cmul(v[m], hi(w));
    }
  }
  dft_last<R3>(u);
  dft_last<R3>(v);
  __syncthreads();
  // Y[row, k2] for k2 = 2i + S*m + {0, 1}, back to the buffer
#pragma unroll
  for (int m = 0; m < 8; ++m)
    buf[pair_at<LOGC>(row, 2 * i + S * m)] = pack(u[m], v[m]);
  __syncthreads();
  // transposed store: rows 2q, 2q + 1 at columns 2w, 2w + 1, i.e.
  // out[r0 + 2q + {0, 1} + R*(2w + {0, 1})]. ptxas is at the 64-register
  // cap here: a rewrite of these lines (the scales in a float2, the index
  // as w*R + q) spilled 4 bytes at C < 512; check the build's spills after
  // any edit.
  const int R = 1 << logR;
  float4* o = out + base + (r0 >> 1);
#pragma unroll
  for (int it = 0; it < 4; ++it) {
    const int item = t + T * it;
    const int q = item % (TR / 2), w = item / (TR / 2);
    const float4 a = buf[pair_at<LOGC>(2 * q, 2 * w)];
    const float4 b = buf[pair_at<LOGC>(2 * q + 1, 2 * w)];
    o[(2 * w * R) / 2 + q] = make_float4(a.x * scale_re, a.y * scale_im,
                                         b.x * scale_re, b.y * scale_im);
    o[((2 * w + 1) * R) / 2 + q] = make_float4(a.z * scale_re, a.w * scale_im,
                                               b.z * scale_re, b.w * scale_im);
  }
}

using Columns = void (*)(const float4*, float4*, const float2*, int, float);
using Rows = void (*)(const float4*, float4*, const float2*, int, float,
                      float);

// Instantiations, indexed by log2 L - 7.
const Columns COLUMNS[3] = {fft_columns<7>, fft_columns<8>, fft_columns<9>};
const Rows ROWS[3] = {fft_rows<7>, fft_rows<8>, fft_rows<9>};

// dynamic shared memory of a launch: the tile and the stage twiddles
size_t smem_bytes(int logT) {
  return ((size_t)1 << logT) * sizeof(float2) + TW_MAX * sizeof(float2);
}

// The opt-in above the 48 KB default, once per kernel and device; the
// attribute belongs to the current device.
bool opted_in[MAX_DEVICES][2][3];

cudaError_t opt_in(const void* fn, int device, int pass, int l, int logT) {
  if (opted_in[device][pass][l]) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes(logT));
  if (err == cudaSuccess) opted_in[device][pass][l] = true;
  return err;
}

cudaError_t launch(const float* x, float* z, float* out, const float* tw_r,
                   const float* tw_c, int B, int logR, int logC, int inverse,
                   int device, cudaStream_t s) {
  const Columns columns = COLUMNS[logR - 7];
  const Rows rows = ROWS[logC - 7];
  cudaError_t err = opt_in((const void*)columns, device, 0, logR - 7,
                           COL_LOGT);
  if (err != cudaSuccess) return err;
  err = opt_in((const void*)rows, device, 1, logC - 7, ROW_LOGT);
  if (err != cudaSuccess) return err;
  const int n = 1 << (logR + logC);
  const float sgn = inverse ? -1.0f : 1.0f;
  const float scale = inverse ? 1.0f / (float)n : 1.0f;   // exact
  columns<<<dim3(n >> COL_LOGT, B), 1 << (COL_LOGT - 4),
            smem_bytes(COL_LOGT), s>>>(
      reinterpret_cast<const float4*>(x), reinterpret_cast<float4*>(z),
      reinterpret_cast<const float2*>(tw_r), logC, sgn);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  rows<<<dim3(n >> ROW_LOGT, B), 1 << (ROW_LOGT - 4),
         smem_bytes(ROW_LOGT), s>>>(
      reinterpret_cast<const float4*>(z), reinterpret_cast<float4*>(out),
      reinterpret_cast<const float2*>(tw_c), logR, scale, sgn * scale);
  return cudaGetLastError();
}

int log2_exact(int v) {
  int l = 0;
  while ((1 << l) < v) ++l;
  return (1 << l) == v ? l : -1;
}

}  // namespace

extern "C" {

// x, z, out: (B, R*C, 2) float32 (complex64), 16-byte aligned; z is scratch
// of x's size. tw_r, tw_c: the stage twiddles of an R- and a C-point FFT,
// (56 + (L/64 - 1)*64, 2) float32: W_64^(r*k) at (r-1)*8 + k (r = 1..7,
// k < 8), then W_L^(r*b) at 56 + (r-1)*64 + b (r < L/64, b < 64).
// R, C in {128, 256, 512}; 1 <= B <= 65535; the pointers and the stream on
// card `device`, which the call makes current for the launches and then
// restores. Launches both passes on `stream`, does not synchronise, and
// returns the first CUDA error that is not 0.
int fft_fused_launch(const float* x, float* z, float* out, const float* tw_r,
                     const float* tw_c, int B, int R, int C, int inverse,
                     int device, void* stream) {
  const int logR = log2_exact(R), logC = log2_exact(C);
  if (B < 1 || B > 65535 || logR < 7 || logR > 9 || logC < 7 || logC > 9 ||
      device < 0 || device >= MAX_DEVICES)
    return (int)cudaErrorInvalidValue;
  int current;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = launch(x, z, out, tw_r, tw_c, B, logR, logC, inverse, device,
               static_cast<cudaStream_t>(stream));
  if (current != device) {
    const cudaError_t back = cudaSetDevice(current);
    if (err == cudaSuccess) err = back;
  }
  return (int)err;
}

const char* fft_fused_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
