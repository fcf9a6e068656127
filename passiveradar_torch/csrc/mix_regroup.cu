// Polyphase regroup + complex matmul of the fused mixer/resampler, for Hopper.
//
// Replaces mix_regroup_matmul, the Pallas TPU kernel of the JAX package's
// ops/resample_pallas.py (body _kernel_cx). It computes, for frame f,
// polyphase group g and output phase p,
//
//     o[f, g, p] = sum_{c < W} x[f, g*down + c - pad_left] * B[p, c]
//
// with x complex (zero outside [0, n)) and B the oscillator-folded complex
// tap bank. Work is FP32 FMA (no TF32).
//
// What bounds it. At the FM geometry (F = 10, n = 2,399,625, 13/119,
// 20,171 groups, W = 294) one channel batch moves ~213 MB, 0.064 ms at
// 3.35 TB/s; the 2,381 nonzero taps need 3.8 GFLOP (0.057 ms of FP32 FMA),
// so bytes bound it. Each phase's nonzero taps form one run of ~183 of the
// 294 columns: a kernel that ran every (phase, column) pair would do 6.2
// GFLOP.
//
// Design:
// * Zero taps skipped. pack_bank lays the bank out as (UP, Wp) complex rows,
//   Wp a multiple of CHUNK, with a table that gives each chunk of CHUNK
//   columns the range [pa, pb] of phases that have a nonzero tap in it
//   (pa > pb: none). The live (chunk, phase) pairs are split evenly over the
//   KSPLIT warps of a CTA in chunk order, so a warp runs, chunk by chunk, a
//   run of phases: it jumps to its first phase and falls through the
//   unrolled phases to its last (with a branch of its own around each
//   phase's FMAs, the FMAs issued far below the FP32 rate). All lanes of a
//   warp are on the same (chunk, phase), so the accumulators keep
//   compile-time indices and nothing diverges. The phases left out have
//   only zero taps there.
// * Factored banks (FAC). The mixer's bank is real taps times one unit
//   phasor a column; pack_bank finds such factors, and the kernel then
//   turns each input sample by its column's phasor once a chunk and runs
//   real taps: 2 FMAs a tap in place of 4, on half the tap bytes. Other
//   banks run the complex taps.
// * Persistent CTAs. A grid of (CTAs an SM fits) x (SMs) walks the
//   (frame, tile of TILE groups; 32 where that span does not fit shared
//   memory) items with a grid stride. Each CTA stages the bank, re-laid
//   out chunk-major so that one chunk's rows are contiguous, and the table
//   into shared memory once.
// * Loads overlap the FMAs. An item's input span, (tile-1)*down + Wp
//   samples, is one bulk copy of the Tensor Memory Accelerator, completing
//   on an mbarrier; a span that reaches outside [0, n) is copied with 8-byte
//   cp.async copies that zero-fill there, so no pad is materialised. With
//   one span buffer a CTA (NBUF = 1) two CTAs fit an SM, and each one's
//   copy and partial-sum pass run under the other's FMAs; NBUF = 2 overlaps
//   them inside a CTA instead, at one CTA an SM.
// * Each thread owns GT groups (lane, lane + 32, ...) and all UP phases:
//   per chunk it keeps GT x CHUNK input samples in registers, and each
//   float4 broadcast of taps feeds every group of the thread. The warps'
//   partial sums go through the finished span buffer, and all threads add
//   them and store the tile's contiguous (tile, UP) output coalesced.
// The MR_* defines exist to build the variants that chip_smoke.py times
// against each other (its "config_table"); the defaults are the measured
// winner.

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef MR_CHUNK
#define MR_CHUNK 8
#endif
#ifndef MR_GT
#define MR_GT 2
#endif
#ifndef MR_KSPLIT
#define MR_KSPLIT 8
#endif
#ifndef MR_NBUF
#define MR_NBUF 1
#endif
#ifndef MR_MINB
#define MR_MINB 2
#endif

namespace {

constexpr int CHUNK = MR_CHUNK;      // columns a chunk of the phase table
constexpr int GT = MR_GT;            // groups a thread
constexpr int KSPLIT = MR_KSPLIT;    // warps a CTA, each a share of the pairs
constexpr int NBUF = MR_NBUF;        // span buffers a CTA
constexpr int MINB = MR_MINB;        // CTAs an SM the registers are capped for
constexpr int TILE = 32 * GT;        // groups an item
constexpr int THREADS = 32 * KSPLIT;
constexpr int MAX_SMEM = 227 * 1024;
constexpr int MAX_DEVICES = 64;
// the grid, CTAs an SM, shared memory and groups an item of the last launch
int last_launch[4];
static_assert(CHUNK % 4 == 0 && NBUF >= 1 && NBUF <= 2 && MINB >= 1,
              "bad MR_* define");

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async_8(void* smem, const void* gmem,
                                           int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   smem_u32(smem)),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
      smem_u32(bar)));
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n .reg .pred done;\n"
      "WAIT_%=:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      " @!done bra WAIT_%=;\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// generic-proxy accesses to shared memory before later async-proxy
// (bulk copy) writes to it
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// An item's input span: samples [start, start + len) of frame xf. An
// interior span goes as one bulk copy (the Tensor Memory Accelerator) of
// the 16-byte-aligned cover [start - off, start - off + bytes / 8), which
// lies in [0, n); an edge span (bytes = 0) as 8-byte cp.async copies that
// zero-fill outside [0, n), at off = 0.
struct Span {
  const float2* xf;
  int start, off, bytes;
};

__device__ __forceinline__ Span span_of(const float2* __restrict__ x,
                                        int item, int tiles, int tile, int n,
                                        int down, int pad_left, int len) {
  const int f = item / tiles;
  Span s{x + (size_t)f * n, (item - f * tiles) * tile * down - pad_left, 0,
         0};
  if (s.start >= 0) {
    const int off =
        (int)((reinterpret_cast<uintptr_t>(s.xf + s.start) >> 3) & 1);
    const int words = (len + off + 1) & ~1;
    if (s.start >= off && s.start - off + words <= n) {
      s.off = off;
      s.bytes = words * 8;
    }
  }
  return s;
}

// Starts the copy of span s into buf; every item completes one phase of
// bar (the bulk copy's bytes, or thread 0's arrival after the cp.async
// copies are issued, which the consumer also waits for).
__device__ __forceinline__ void issue_span(const Span& s, float2* buf,
                                           uint64_t* bar, int n, int len) {
  if (s.bytes) {
    if (threadIdx.x == 0) {
      asm volatile(
          "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
              smem_u32(bar)),
          "r"(s.bytes)
          : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%0], [%1], %2, [%3];\n" ::"r"(smem_u32(buf)),
          "l"(s.xf + s.start - s.off), "r"(s.bytes), "r"(smem_u32(bar))
          : "memory");
    }
    return;
  }
  for (int i = threadIdx.x; i < len; i += THREADS) {
    const int g = s.start + i;
    const bool in = g >= 0 && g < n;
    cp_async_8(buf + i, in ? s.xf + g : s.xf, in ? 8 : 0);
  }
  cp_async_commit();
  if (threadIdx.x == 0) mbar_arrive(bar);
}

// The FMAs of one (chunk, phase) pair for the thread's GT groups: v holds
// the chunk's CHUNK input samples of each group, t the phase's CHUNK taps
// as column pairs.
template <int P, int UP>
__device__ __forceinline__ void phase_fma(float (&ar)[GT][UP],
                                          float (&ai)[GT][UP],
                                          const float2 (&v)[GT][CHUNK],
                                          const float4* t) {
#pragma unroll
  for (int q = 0; q < CHUNK / 2; ++q) {
    const float4 b = t[P * (CHUNK / 2) + q];
#pragma unroll
    for (int k = 0; k < GT; ++k) {
      const float2 u = v[k][2 * q], w = v[k][2 * q + 1];
      ar[k][P] = fmaf(u.x, b.x, fmaf(-u.y, b.y, ar[k][P]));
      ai[k][P] = fmaf(u.x, b.y, fmaf(u.y, b.x, ai[k][P]));
      ar[k][P] = fmaf(w.x, b.z, fmaf(-w.y, b.w, ar[k][P]));
      ai[k][P] = fmaf(w.x, b.w, fmaf(w.y, b.z, ai[k][P]));
    }
  }
}

// The same for a factored bank: y holds the samples already turned by the
// column phasors, t the phase's CHUNK real taps as column quads.
template <int P, int UP>
__device__ __forceinline__ void phase_fma_real(float (&ar)[GT][UP],
                                               float (&ai)[GT][UP],
                                               const float2 (&y)[GT][CHUNK],
                                               const float4* t) {
#pragma unroll
  for (int r = 0; r < CHUNK / 4; ++r) {
    const float4 b = t[P * (CHUNK / 4) + r];
#pragma unroll
    for (int k = 0; k < GT; ++k) {
      const float2* u = &y[k][4 * r];
      ar[k][P] = fmaf(u[0].x, b.x, ar[k][P]);
      ai[k][P] = fmaf(u[0].y, b.x, ai[k][P]);
      ar[k][P] = fmaf(u[1].x, b.y, ar[k][P]);
      ai[k][P] = fmaf(u[1].y, b.y, ai[k][P]);
      ar[k][P] = fmaf(u[2].x, b.z, ar[k][P]);
      ai[k][P] = fmaf(u[2].y, b.z, ai[k][P]);
      ar[k][P] = fmaf(u[3].x, b.w, ar[k][P]);
      ai[k][P] = fmaf(u[3].y, b.w, ai[k][P]);
    }
  }
}

// Shared-memory float4s of one chunk of the bank: UP rows of CHUNK complex
// taps, or (FAC) CHUNK complex phasors and UP rows of CHUNK real taps.
template <int UP, bool FAC>
__host__ __device__ constexpr int chunk_float4s() {
  return FAC ? CHUNK / 2 + UP * (CHUNK / 4) : UP * (CHUNK / 2);
}

template <int UP, bool FAC>
__global__ void __launch_bounds__(THREADS, UP <= 14 ? MINB : 1)
    mix_regroup_kernel(
        const float2* __restrict__ x,       // (F, n) complex
        const float4* __restrict__ taps4,   // (UP, Wp) complex, column pairs
        const float4* __restrict__ real4,   // FAC: (UP, Wp) real, quads
        const float4* __restrict__ phasor4, // FAC: (Wp) complex, pairs
        const int2* __restrict__ ranges,    // (Wp / CHUNK) [pa, pb]
        float2* __restrict__ out,           // (F, groups, UP) complex
        int n, int Wp, int down, int groups, int pad_left, int tile,
        int tiles, int items, int span_alloc) {
  constexpr int Q = CHUNK / 2;         // float4 column pairs a chunk
  constexpr int R = CHUNK / 4;         // float4 column quads a chunk
  constexpr int S = chunk_float4s<UP, FAC>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nchunks = Wp / CHUNK;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem_raw);   // NBUF of 2
  float4* bank_s = reinterpret_cast<float4*>(smem_raw + 16);  // (chunk, S)
  int2* range_s = reinterpret_cast<int2*>(bank_s + (size_t)nchunks * S);
  float2* span_s = reinterpret_cast<float2*>(range_s + ((nchunks + 1) & ~1));
  const int span_len = (tile - 1) * down + Wp;

  if (threadIdx.x < NBUF) mbar_init(bar + threadIdx.x);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncthreads();
  // the first item's span is in flight while the bank is re-laid out
  issue_span(span_of(x, blockIdx.x, tiles, tile, n, down, pad_left,
                     span_len),
             span_s, bar, n, span_len);
  for (int j = threadIdx.x; j < nchunks * S; j += THREADS) {
    const int c = j / S, o = j - c * S;
    if constexpr (FAC)
      bank_s[j] = o < Q ? phasor4[c * Q + o]
                        : real4[(o - Q) / R * (Wp / 4) + c * R + (o - Q) % R];
    else
      bank_s[j] = taps4[o / Q * (Wp / 2) + c * Q + o % Q];
  }
  for (int i = threadIdx.x; i < nchunks; i += THREADS) range_s[i] = ranges[i];
  __syncthreads();

  // This warp's share of the live (chunk, phase) pairs, taken in chunk
  // order: pairs [b0, b1) of the table's `total`, so that the warps differ
  // by at most one pair; a chunk on a boundary is shared by two warps.
  // Its chunks are [lo, hi), `skip` pairs before chunk lo.
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int total = 0;
  for (int c = 0; c < nchunks; ++c)
    total += max(0, range_s[c].y - range_s[c].x + 1);
  const int b0 = warp * total / KSPLIT, b1 = (warp + 1) * total / KSPLIT;
  int lo = nchunks, hi = 0, skip = 0;
  for (int c = 0, cum = 0; c < nchunks; ++c) {
    const int a = max(0, range_s[c].y - range_s[c].x + 1);
    if (a > 0 && cum + a > b0 && cum < b1) {
      if (lo == nchunks) {
        lo = c;
        skip = cum;
      }
      hi = c + 1;
    }
    cum += a;
  }

  for (int j = 0, item = blockIdx.x; item < items;
       ++j, item += gridDim.x) {
    const int bi = NBUF == 2 ? (j & 1) : 0;
    float2* buf = span_s + (size_t)bi * span_alloc;
    const Span s =
        span_of(x, item, tiles, tile, n, down, pad_left, span_len);
    mbar_wait(bar + bi, (j / NBUF) & 1);
    if (!s.bytes) cp_async_wait_all();
    __syncthreads();
    const int next = item + gridDim.x;
    if (NBUF == 2 && next < items)
      issue_span(span_of(x, next, tiles, tile, n, down, pad_left, span_len),
                 span_s + (size_t)(bi ^ 1) * span_alloc, bar + (bi ^ 1), n,
                 span_len);

    float ar[GT][UP], ai[GT][UP];
#pragma unroll
    for (int k = 0; k < GT; ++k)
#pragma unroll
      for (int p = 0; p < UP; ++p) ar[k][p] = ai[k][p] = 0.f;

    // group lane + 32k of the item; beyond a narrow item's tile (k >=
    // tile / 32) the lane reads group `lane` again, and that sum is dropped
    const float2* xs = buf + s.off + lane * down;
    int koff[GT];
#pragma unroll
    for (int k = 0; k < GT; ++k) koff[k] = k * 32 < tile ? k * 32 * down : 0;
    for (int c = lo, cum = skip; c < hi; ++c) {
      // this warp's phases [pa, pb] of the chunk
      const int2 r = range_s[c];
      const int a = max(0, r.y - r.x + 1);
      const int pa = r.x + max(0, b0 - cum);
      const int pb = r.x + min(a, b1 - cum) - 1;
      cum += a;
      if (pa > pb) continue;
      float2 v[GT][CHUNK];
#pragma unroll
      for (int k = 0; k < GT; ++k)
#pragma unroll
        for (int q = 0; q < CHUNK; ++q)
          v[k][q] = xs[koff[k] + c * CHUNK + q];
      const float4* t = bank_s + (size_t)c * S;
      if constexpr (FAC) {
        // turn the samples by the column phasors once for all phases
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          const float4 w = t[q];
#pragma unroll
          for (int k = 0; k < GT; ++k) {
            const float2 a = v[k][2 * q], b = v[k][2 * q + 1];
            v[k][2 * q] = make_float2(fmaf(a.x, w.x, -a.y * w.y),
                                      fmaf(a.x, w.y, a.y * w.x));
            v[k][2 * q + 1] = make_float2(fmaf(b.x, w.z, -b.y * w.w),
                                          fmaf(b.x, w.w, b.y * w.z));
          }
        }
      }
      // enter at phase pa, run the unrolled phases in turn, leave after pb
      switch (pa) {
#define MR_PHASE(P)                                 \
  case P:                                           \
    if constexpr (P < UP) {                         \
      if constexpr (FAC)                            \
        phase_fma_real<P, UP>(ar, ai, v, t + Q);    \
      else                                          \
        phase_fma<P, UP>(ar, ai, v, t);             \
      if (pb <= P) break;                           \
    }                                               \
    [[fallthrough]];
        MR_PHASE(0) MR_PHASE(1) MR_PHASE(2) MR_PHASE(3) MR_PHASE(4)
        MR_PHASE(5) MR_PHASE(6) MR_PHASE(7) MR_PHASE(8) MR_PHASE(9)
        MR_PHASE(10) MR_PHASE(11) MR_PHASE(12) MR_PHASE(13) MR_PHASE(14)
        MR_PHASE(15) MR_PHASE(16) MR_PHASE(17) MR_PHASE(18) MR_PHASE(19)
#undef MR_PHASE
        default:
          break;
      }
    }

    // the warps' partial sums through the finished span buffer
    // (span_alloc >= KSPLIT * TILE * UP), then one coalesced store
    __syncthreads();
#pragma unroll
    for (int k = 0; k < GT; ++k)
#pragma unroll
      for (int p = 0; p < UP; ++p)
        buf[(warp * TILE + k * 32 + lane) * UP + p] =
            make_float2(ar[k][p], ai[k][p]);
    __syncthreads();
    const int f = item / tiles;
    const int g0 = (item - f * tiles) * tile;
    const int valid = min(tile, groups - g0) * UP;
    float2* o = out + ((size_t)f * groups + g0) * UP;
    for (int e = threadIdx.x; e < valid; e += THREADS) {
      float2 sum = buf[e];
#pragma unroll
      for (int k = 1; k < KSPLIT; ++k) {
        const float2 t = buf[k * TILE * UP + e];
        sum.x += t.x;
        sum.y += t.y;
      }
      o[e] = sum;
    }
    // this buffer's reads and writes before the next bulk copy into it
    fence_proxy_async();
    if (NBUF == 1 && next < items) {
      __syncthreads();
      issue_span(span_of(x, next, tiles, tile, n, down, pad_left, span_len),
                 buf, bar, n, span_len);
    }
  }
}

template <int UP, bool FAC>
cudaError_t launch(const float* x, const float* taps, const float* real,
                   const float* phasor, const int* ranges, float* out, int F,
                   int n, int Wp, int down, int groups, int pad_left,
                   int device, cudaStream_t stream) {
  // the shared-memory opt-in, the SM count and the CTAs an SM fits, once
  // per instantiation and card (the last size asked for)
  static bool opted_in[MAX_DEVICES];
  static int sms[MAX_DEVICES], last_smem[MAX_DEVICES],
      per_sm[MAX_DEVICES];
  const auto kernel = mix_regroup_kernel<UP, FAC>;
  // An item is TILE groups, or 32 where a span that wide does not fit;
  // its buffer holds the span and its alignment sample, or the warps'
  // partial sums.
  const int nchunks = Wp / CHUNK;
  const long long fixed =
      16 + (long long)nchunks * chunk_float4s<UP, FAC>() * 16 +
      ((nchunks + 1) & ~1) * 8;
  int tile = TILE;
  long long span_alloc = 0, smem = 0;
  for (;; tile -= 32) {
    const long long span_len = (long long)(tile - 1) * down + Wp + 2;
    span_alloc = span_len > (long long)KSPLIT * TILE * UP
                     ? span_len
                     : (long long)KSPLIT * TILE * UP;
    span_alloc = (span_alloc + 1) & ~1LL;
    smem = fixed + NBUF * span_alloc * 8;
    if (smem <= MAX_SMEM) break;
    if (tile == 32) return cudaErrorInvalidValue;   // span too wide
  }
  cudaError_t err = cudaSuccess;
  if (!opted_in[device]) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               MAX_SMEM);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms[device],
                                   cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    opted_in[device] = true;
  }
  if (last_smem[device] != smem) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm[device], kernel, THREADS, (size_t)smem);
    if (err != cudaSuccess) return err;
    if (per_sm[device] < 1) return cudaErrorInvalidConfiguration;
    last_smem[device] = (int)smem;
  }
  const int tiles = (groups + tile - 1) / tile;
  const long long items = (long long)F * tiles;
  if (items > 0x7fffffff) return cudaErrorInvalidValue;
  const long long fill = (long long)per_sm[device] * sms[device];
  const int grid = (int)(items < fill ? items : fill);
  last_launch[0] = grid;
  last_launch[1] = per_sm[device];
  last_launch[2] = (int)smem;
  last_launch[3] = tile;
  kernel<<<grid, THREADS, (size_t)smem, stream>>>(
      reinterpret_cast<const float2*>(x),
      reinterpret_cast<const float4*>(taps),
      reinterpret_cast<const float4*>(real),
      reinterpret_cast<const float4*>(phasor),
      reinterpret_cast<const int2*>(ranges), reinterpret_cast<float2*>(out),
      n, Wp, down, groups, pad_left, tile, tiles, (int)items,
      (int)span_alloc);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x: (F, n, 2) float32; taps: (up, Wp, 2) float32 and ranges: (Wp / chunk,
// 2) int32, both from pack_bank with chunk == the build's CHUNK; real:
// (up, Wp) float32 and phasor: (Wp, 2) float32, pack_bank's factors of
// taps, or both null; out: (F, groups, up, 2) float32; the pointers and the
// stream on card `device`, which the call makes current for the launch and
// then restores. Runs on the factors when they are given. Launches on
// `stream`, does not synchronise, and returns the first CUDA error that is
// not 0.
int mix_regroup_launch(const float* x, const float* taps, const float* real,
                       const float* phasor, const int* ranges, float* out,
                       int F, int n, int Wp, int chunk, int down, int groups,
                       int up, int pad_left, int device, void* stream) {
  if (F <= 0 || groups <= 0 || n <= 0 || down <= 0 || up < 1 || up > 20 ||
      chunk != CHUNK || Wp <= 0 || Wp % CHUNK != 0 || device < 0 ||
      device >= MAX_DEVICES || (real == nullptr) != (phasor == nullptr))
    return (int)cudaErrorInvalidValue;
  int current;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (up) {
#define PR_CASE(U)                                                         \
  case U:                                                                  \
    err = real ? launch<U, true>(x, taps, real, phasor, ranges, out, F, n, \
                                 Wp, down, groups, pad_left, device, s)    \
               : launch<U, false>(x, taps, real, phasor, ranges, out, F,  \
                                  n, Wp, down, groups, pad_left, device,  \
                                  s);                                      \
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

// The build's chunk width: pack_bank's `chunk` must equal it.
int mix_regroup_chunk() { return CHUNK; }

// The last launch's grid, CTAs an SM, dynamic shared memory in bytes and
// groups an item.
void mix_regroup_last_launch(int* info) {
  for (int i = 0; i < 4; ++i) info[i] = last_launch[i];
}

const char* mix_regroup_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
