// Batched complex NLMS clutter canceller, for Hopper: the exact block
// recurrence, its triangular solves replaced by products with inverses
// formed ahead of the chain while the card has SMs for them.
//
// Replaces nlms_filter_pallas, the Pallas TPU kernel of the JAX package's
// ops/nlms_pallas.py (body _nlms_kernel). For each frame b, with
// m = filter_len + peek taps w (kept unflipped: w[t] weighs ref[k+1+t]) and
// steps = n - m, step k = 0 .. steps-1 computes
//
//     u_k = ref[b, k+1 : k+1+m]
//     e_k = srv[b, k+filter_len] - w^H u_k          -> out[b, filter_len+k]
//     w   = w + s_k u_k conj(e_k),   s_k = mu / g(u_k^H u_k)
//
// with g(x) = max(x, 1e-30) (zero_window "zero", the TPU kernel's guard) or
// g(x) = x ("nan", the JAX scan's plain division). out is zero on
// [0, filter_len) and [filter_len+steps, n).
//
// The block form. Over a block of T <= P steps that starts from taps w0 the
// same recurrence reads, in exact arithmetic,
//
//     e_j = c_j - sum_{i<j} e_i (s_i G_ij),   c_j = d_j - w0^H u_j,
//     G_ij = u_i^H u_j,
//     w   = w0 + sum_{i<T} s_i conj(e_i) u_i,
//
// that is (I + L) e = c with L[j,i] = s_i G_ij (i < j), so e = M c with
// M = (I + L)^-1. L is built from ref alone, so M is too: where the card
// has SMs for it, M is formed before the chain reaches the block, and the
// chain's only step a block that the errors wait on is one dense P x P
// product. This is not block LMS: every step still sees the taps of the
// step before it.
//
// Two designs, one launch a batch. While the card holds a launch's F
// clusters of two CTAs at once (cudaOccupancyMaxActiveClusters; one CTA an
// SM), each frame takes a cluster of the chain and a producer that forms
// the M_b: nlms_kernel. Past that the clusters would run in waves, and one
// CTA a frame that solves each block itself takes less time:
// nlms_kernel_alone. The chain's latency sets a frame's time either way.
//
// nlms_kernel, a cluster of two CTAs of 8 warps a frame:
//   the chain (CTA 0), for each block b, between block-wide barriers:
//     1. dot products (all warps): c_j = d_j - w0^H u_j for the block's
//        steps; warp v sums its eighth of the taps for step j = lane;
//     2. e = M_b c (warp 0): warp 0 adds the eight parts, and lane j sums
//        M[j,i] c_i over i <= j from M's packed columns (four partial sums,
//        M's zero upper triangle never multiplied); the block's errors go
//        out as one coalesced run, s_i conj(e_i) to shared memory;
//     3. tap update (all warps): w = w0 + sum_i s_i conj(e_i) u_i, a
//        thread a tap.
//   the producer (CTA 1), NB blocks a hand-over, a warp a block: the Gram
//   of the block's windows, its step sizes and L, then M by forward
//   substitution on the identity's columns (a lane a column), into the
//   chain CTA's shared memory over distributed shared memory. Two buffers
//   of NB blocks change hands at cluster barriers: the producer fills one
//   while the chain reads the other. The chain arrives once it has read a
//   buffer and waits only before its next product, so the barrier's
//   latency hides behind a block's dot products.
//
// nlms_kernel_alone, one CTA of 8 warps a frame: the same dot products and
// tap update, and between them warp 0 solves (I + L) e = c by forward
// substitution, e_i broadcast from lane i by shuffles, a step an i, while
// the other seven warps build the Gram, step sizes and L of the blocks
// ahead from scans shared between blocks (below).
//
// The Gram. G_{i,i+l} = sum of conj(r_x) r_{x+l} over window i's positions.
// The positions are cut into segments of pb = min(P, m) (a block's steps:
// block b's windows start in segment b). Window i of block b is the suffix
// of segment b from offset i, whole segments b+1 .. b+q-1 and a prefix of
// segment b+q, q = Q or Q+1 (Q = m / pb). Each entry is (suffix + whole
// segments) + prefix, and no term outside window i enters G_{i,j}, so its
// rounding stays relative to |u_i||u_j|. M and the solve need that: at the
// edge of a zero run a window holds a few samples, u^H u is small and s_i
// large, and the samples that a slide would subtract leave a residue that
// s_i amplifies. An all-zero window has G = 0 and u^H u = 0 exactly (lag 0
// sums |r|^2 alone). The producer's warp takes a block, a lane a lag: the
// suffix sums of the block's segment, summed backwards; the sums of whole
// segments, each segment once for NB blocks; and the prefix of the
// window's last segment, summed forwards as the windows advance. The alone
// kernel scans each lag once a block: a prefix scan of one new segment
// (its sum to a ring of segment sums) and a suffix scan of the block's own
// segment; its helper warps scan two blocks ahead and scale one ahead, so
// the block barriers order every hand-over.
//
// Zero windows, u_i^H u_i == 0 (exactly when every |r|^2 of the window is 0
// in float32, as in the plain version's direct sum): under "zero" s_i = 0,
// which empties column i of L, so the window changes nothing, as u_i = 0
// does in the scan; under "nan" s_i = NaN, so rows j > i of M (of L's
// column i, for the solve) are NaN and rows <= i finite: e_i stays finite
// and every later error of the frame, and the taps, are NaN, as the scan's
// 0 * inf makes them. A window whose
// samples are not all 0 but whose |r|^2 all underflow counts as a zero
// window here (the scan would take one huge step there). 0 < u^H u < 1e-30
// takes g = 1e-30 under "zero" and u^H u under "nan", as in the scan.
//
// What bounds it: 16*m FLOP per step and frame are needed (8m for w^H u, 8m
// for the update). At the FM geometry (F = 10, n = 262144, m = 185, 261959
// steps) that is 7.75 GFLOP, 0.116 ms at the H100's 67 TFLOP/s FP32. The
// time is a block's latency on the chain's SM times the block count: the
// dot products and the tap update, each a window sample and a broadcast
// tap or step size from shared memory a complex MAC, the errors on one
// warp, and three barriers; the update takes the most. In a cluster the
// Gram and M (about 4 P^3 / 6 FLOP a block, and the Gram's scans) run on
// the producer's SM and keep ahead of the chain; alone, the solve's 32
// dependent shuffle-FMA steps take longer than the product with M, and the
// Gram rides on the helper warps under it.

#include <algorithm>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int P = 32;                     // steps a block, one a lane
constexpr int CLUSTER = 2;                // the chain and the producer
constexpr int WARP = 32;
constexpr int WARPS = 8;
constexpr int THREADS = WARP * WARPS;
constexpr int CHUNK = 2048;               // steps staged at a time
constexpr int SCB = CHUNK / P;            // blocks staged at a time
constexpr int NB = 16;                    // blocks a hand-over
constexpr int BPW = NB / WARPS;           // blocks a producer warp
static_assert(SCB % NB == 0 && NB % WARPS == 0,
              "hand-over sizes: whole hand-overs a chunk, whole blocks a "
              "producer warp");
constexpr int MAX_TAPS = 512;
constexpr int QMAX = MAX_TAPS / P;        // whole segments in a window
constexpr int TRI = P * (P - 1) / 2;      // L[j,i], i < j
constexpr int MT = P * (P + 1) / 2;       // M[j,i], i <= j
constexpr int MREC = MT + P / 2;          // a block's M and s, in float2
constexpr int MAX_DEVICES = 64;
constexpr int LOADS = 8;                  // terms loaded ahead of their sums
constexpr int TAPS_A_THREAD = MAX_TAPS / THREADS;
constexpr unsigned FULL = 0xffffffffu;

__host__ __device__ constexpr int even(int o) { return (o + 1) & ~1; }

// Shared memory, in float2 units from the start of the dynamic buffer. The
// chain's layout and the producer's share the buffer's size; mb, where the
// producer writes, is at the same place in both CTAs of a cluster.
struct ChainLayout {
  int win, dsr, w, part, q, cb, mb, total;
};

__host__ __device__ constexpr ChainLayout chain_layout(int m) {
  ChainLayout s{};
  int o = 0;
  s.win = o;  o += CHUNK + m + 2 * P; // ref of the chunk's windows
  s.dsr = o;  o += CHUNK;             // srv of the chunk's steps
  s.w = o = even(o);                  // the taps, read two at a time,
  o += m + 1;                         // and one past them
  s.part = o; o += WARPS * P;         // parts of w0^H u_j, one row a warp
  s.q = o = even(o);                  // s_i conj(e_i)
  o += P;
  s.cb = o;   o += P;                 // c_j
  s.mb = o = even(o);                 // two buffers of NB blocks' M and s
  o += 2 * NB * MREC;
  s.total = o;
  return s;
}

static_assert(2 * chain_layout(1).total * sizeof(float2) > 228 * 1024,
              "one CTA an SM at every m: the cluster count holds for all m");

struct ProducerLayout {
  int win, ssum, lt, st, total;
};

__host__ __device__ constexpr ProducerLayout producer_layout(int m) {
  ProducerLayout s{};
  int o = 0;
  s.win = o;  o += NB * P + m + 2 * P;     // ref of a hand-over's windows
  s.ssum = o; o += (NB + QMAX) * P;        // sums of whole segments [g][lag]
  s.lt = o;   o += WARPS * TRI;            // each warp's L, by columns
  s.st = o = even(o);                      // each warp's M and s
  o += NB * MREC;
  s.total = o;
  return s;
}

// Column i's first entry in the packed layouts: L[j,i] at tri(i) + j-i-1
// (j > i), M[j,i] at mcol(i) + j - i (j >= i).
__host__ __device__ constexpr int tri(int i) { return i * (2 * P - i - 1) / 2; }
__host__ __device__ constexpr int mcol(int i) {
  return i * (2 * P - i + 1) / 2;
}

__device__ __forceinline__ float2 add(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

// conj(a) b
__device__ __forceinline__ float2 conj_mul(float2 a, float2 b) {
  return make_float2(fmaf(a.x, b.x, a.y * b.y), fmaf(a.x, b.y, -a.y * b.x));
}

// acc + conj(a) b
__device__ __forceinline__ float2 conj_fma(float2 a, float2 b, float2 acc) {
  return make_float2(fmaf(a.y, b.y, fmaf(a.x, b.x, acc.x)),
                     fmaf(-a.y, b.x, fmaf(a.x, b.y, acc.y)));
}

// acc + a b
__device__ __forceinline__ float2 cfma(float2 a, float2 b, float2 acc) {
  return make_float2(fmaf(-a.y, b.y, fmaf(a.x, b.x, acc.x)),
                     fmaf(a.y, b.x, fmaf(a.x, b.y, acc.y)));
}

// acc - a b
__device__ __forceinline__ float2 cfms(float2 a, float2 b, float2 acc) {
  return make_float2(fmaf(a.y, b.y, fmaf(-a.x, b.x, acc.x)),
                     fmaf(-a.y, b.x, fmaf(-a.x, b.y, acc.y)));
}

// The Gram term of lag l at window position x: conj(r_x) r_{x+l}. At lag 0
// only the real part, fma(x, x, y*y) = |r_x|^2, is used: it is 0 exactly
// when the plain version's rounded x*x + y*y is, so a zero window sums to 0.
__device__ __forceinline__ float2 term(const float2* win, int x, int l) {
  return conj_mul(win[x], win[x + l]);
}

__device__ __forceinline__ float step_size(float uu, float mu,
                                           int nan_window) {
  if (uu == 0.f) return nan_window ? __int_as_float(0x7fc00000) : 0.f;
  // "zero": max(uu, 1e-30), written so that a NaN uu stays NaN
  return mu / ((nan_window || !(uu < 1e-30f)) ? uu : 1e-30f);
}

// The cluster's barrier in two halves: what a CTA wrote, to its own or
// another CTA's shared memory, before its arrive is seen after every CTA's
// wait.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The sum of segment g's pb terms of every lag, by one warp, each lane a
// lag (lanes past the block's lags compute unused sums).
__device__ void segment_sum(const float2* __restrict__ win, float2* ssum,
                            int g, int pb, int lane) {
  const float2 zero = make_float2(0.f, 0.f);
  float2 tv[P];
#pragma unroll
  for (int y = 0; y < P; ++y)
    tv[y] = y < pb ? term(win, g * pb + y, lane) : zero;
  float2 acc = zero;
#pragma unroll
  for (int y = 0; y < P; ++y) acc = add(acc, tv[y]);
  ssum[g * P + lane] = acc;
}

// Block r of a hand-over's windows (its segment is r, its T steps valid),
// by one warp: the Gram's entries window by window, each lane a lag; then
// each window's u^H u to a lane of its own, which takes its step size s_i
// (into sv); then L[j,i] = s_i G_ij by columns into lt (zero where j >= pb).
__device__ void block_gram(const float2* __restrict__ win,
                           const float2* __restrict__ ssum, float2* lt,
                           float* sv, int r, int T, int m, int pb, float mu,
                           int nan_window, int lane) {
  const float2 zero = make_float2(0.f, 0.f);
  const int Q = m / pb, o0 = m - Q * pb, x0 = r * pb, l = lane;
  // suffix sums of the block's own segment: suf[i] = terms [i, pb)
  float2 suf[P];
#pragma unroll
  for (int y = 0; y < P; ++y)
    suf[y] = y < pb ? term(win, x0 + y, l) : zero;
  float2 acc = zero;
#pragma unroll
  for (int y = P - 1; y >= 0; --y) {
    acc = add(acc, suf[y]);
    suf[y] = acc;
  }
  // whole segments r+1 .. r+Q-1 (q = Q), and r+Q besides (q = Q+1)
  float2 mq = zero;
#pragma unroll
  for (int k = 0; k < QMAX - 1; ++k)
    if (k < Q - 1) mq = add(mq, ssum[(r + 1 + k) * P + l]);
  const float2 mq1 = add(mq, ssum[(r + Q) * P + l]);
  // window 0's prefix of segment r+Q, to offset o0 < pb
  float2 tail = zero;
#pragma unroll
  for (int y = 0; y < P; ++y)
    if (y < o0) tail = add(tail, term(win, (r + Q) * pb + y, l));
  float2 g[P];
  int o = o0;
  bool wrapped = false;
#pragma unroll
  for (int i = 0; i < P; ++i) {
    g[i] = add(add(suf[i], wrapped ? mq1 : mq), tail);
    // window i+1 ends one position later: its prefix gains the term at
    // window i's end, or starts the next segment
    if (i + 1 < pb) {
      const float2 t = term(win, x0 + i + m, l);
      if (++o == pb) {
        o = 0;
        wrapped = true;
        tail = zero;
      } else {
        tail = add(tail, t);
      }
    }
  }
  float uu = 0.f;
#pragma unroll
  for (int i = 0; i < P; ++i) {
    const float u = __shfl_sync(FULL, g[i].x, 0);
    if (lane == i) uu = u;
  }
  const float si = lane < T ? step_size(uu, mu, nan_window) : 0.f;
  sv[lane] = si;
#pragma unroll
  for (int i = 0; i < P; ++i) {
    const float s = __shfl_sync(FULL, si, i);
    if (l >= 1 && i + l < P)
      lt[tri(i) + l - 1] =
          i + l < pb ? make_float2(s * g[i].x, s * g[i].y) : zero;
  }
  __syncwarp();
}

// M = (I + L)^-1 from lt by forward substitution, by one warp, lane k
// solving (I + L) x = e_k from the row of the identity's 1 down, into st by
// packed columns. Rows j of column k above k are never stored, and the
// updates of x_j go in the order of i, so a row's sum is the same sequence
// of rounded terms as the forward substitution of one column alone.
__device__ void block_invert(const float2* __restrict__ lt, float2* st,
                             int lane) {
  float2* col_k = st + mcol(lane) - lane;  // col_k[j] = M[j,lane], j >= lane
  float2 t[P];
#pragma unroll
  for (int j = 0; j < P; ++j) t[j] = make_float2(j == lane ? 1.f : 0.f, 0.f);
#pragma unroll
  for (int i = 0; i < P; ++i) {
    const float2* col = lt + tri(i) - i - 1;   // col[j] = L[j,i]
#pragma unroll
    for (int j = i + 1; j < P; ++j) t[j] = cfms(col[j], t[i], t[j]);
  }
#pragma unroll
  for (int j = 0; j < P; ++j)
    if (j >= lane) col_k[j] = t[j];
  __syncwarp();
}

// CTA 1 of a frame's cluster: the blocks of each hand-over c, built while
// the chain runs hand-over c-1 and copied into buffer c & 1 of the chain
// CTA once it has left hand-over c-2.
__device__ void producer(float2* sm, float2* remote_mb,
                         const float2* __restrict__ ref, int n, int m,
                         float mu, int nan_window) {
  const ProducerLayout L = producer_layout(m);
  float2* win = sm + L.win;
  float2* ssum = sm + L.ssum;
  const float2 zero = make_float2(0.f, 0.f);
  const int tid = threadIdx.x, warp = tid / WARP, lane = tid % WARP;
  const int steps = n - m, pb = min(P, m), Q = m / pb;
  const int nblk = (steps + pb - 1) / pb, C = (nblk + NB - 1) / NB;
  float2* lt = sm + L.lt + warp * TRI;
  float2* st = sm + L.st + warp * BPW * MREC;

  cluster_arrive();
  cluster_wait();
  for (int c = 0; c < C; ++c) {
    const int B0 = c * NB;
    const int nb = min(NB, nblk - B0);
    __syncthreads();
    const long long base = (long long)B0 * pb + 1;
    for (int x = tid; x < NB * P + m + 2 * P; x += THREADS)
      win[x] = base + x < n ? ref[base + x] : zero;
    __syncthreads();
    for (int g = 1 + warp; g < nb + Q; g += WARPS)
      segment_sum(win, ssum, g, pb, lane);
    __syncthreads();
    for (int r = warp; r < nb; r += WARPS) {
      float2* rec = st + (r / WARPS) * MREC;
      block_gram(win, ssum, lt, reinterpret_cast<float*>(rec + MT), r,
                 min(pb, steps - (B0 + r) * pb), m, pb, mu, nan_window,
                 lane);
      block_invert(lt, rec, lane);
    }
    if (c > 0) cluster_wait();
    for (int r = warp; r < nb; r += WARPS) {
      const float4* src =
          reinterpret_cast<const float4*>(st + (r / WARPS) * MREC);
      float4* dst =
          reinterpret_cast<float4*>(remote_mb + ((c & 1) * NB + r) * MREC);
      for (int x = lane; x < MREC / 2; x += WARP) dst[x] = src[x];
    }
    cluster_arrive();
  }
  cluster_wait();
  cluster_arrive();
  cluster_wait();
}

// CTA 0 of a frame's cluster: the recurrence, block by block.
__device__ void chain(float2* sm, const float2* __restrict__ ref,
                      const float2* __restrict__ srv,
                      const float2* __restrict__ w0, float2* __restrict__ out,
                      float2* __restrict__ w_out, int frame, int n,
                      int filter_len, int m) {
  const ChainLayout L = chain_layout(m);
  float2* win = sm + L.win;
  float2* dsr = sm + L.dsr;
  float2* w = sm + L.w;
  float2* part = sm + L.part;
  float2* q = sm + L.q;
  float2* cb = sm + L.cb;
  const float2 zero = make_float2(0.f, 0.f);
  const int tid = threadIdx.x, warp = tid / WARP, lane = tid % WARP;
  const long long row = (long long)frame * n;
  ref += row;
  srv += row;
  out += row;
  const int steps = n - m;
  const int pb = min(P, m);       // segments shorter than a window: Q >= 1
  const int nblk = (steps + pb - 1) / pb, C = (nblk + NB - 1) / NB;
  // taps a warp in phase 1, even: the warp's taps are read two at a time
  const int slice = (m + 2 * WARPS - 1) / (2 * WARPS) * 2;

  for (int t = tid; t < m; t += THREADS)
    w[t] = w0 != nullptr ? w0[(long long)frame * m + t] : zero;
  for (int j = tid; j < filter_len; j += THREADS) out[j] = zero;
  for (int j = filter_len + steps + tid; j < n; j += THREADS) out[j] = zero;

  cluster_arrive();
  cluster_wait();
  int k0 = 0;
  // hand-over c is in buffer c & 1: the chain waits for it before the
  // hand-over's first product, and arrives once its last product is done,
  // which frees buffer c & 1 for hand-over c + 2
  cluster_arrive();
  for (int c = 0; c < C; ++c) {
    const int b0 = c * NB;
    if (b0 % SCB == 0) {
      // windows of the staged steps and the reads past them (a ragged
      // block's idle lanes); zero past ref's end
      k0 = b0 * pb;
      const int TC = min(SCB * pb, steps - k0);
      __syncthreads();
      for (int x = tid; x < TC + m + 2 * P; x += THREADS) {
        const long long idx = (long long)k0 + 1 + x;
        win[x] = idx < n ? ref[idx] : zero;
      }
      for (int x = tid; x < TC; x += THREADS)
        dsr[x] = srv[k0 + filter_len + x];
      __syncthreads();
    }
    const int b1 = min(b0 + NB, nblk);
    for (int b = b0; b < b1; ++b) {
      const int bs = b * pb - k0;
      const int T = min(pb, steps - b * pb);
      // phase 1: warp `warp`'s share of w0^H u_j for j = lane
      float2 acc[4] = {zero, zero, zero, zero};
      const int t1 = min(m, (warp + 1) * slice);
      for (int t = min(m, warp * slice); t < t1; t += LOADS) {
        float2 wv[LOADS], xv[LOADS];
#pragma unroll
        for (int k = 0; k < LOADS; ++k) {
          const bool ok = t + k < t1;
          if (k % 2 == 0) {
            const float4 w2 = *reinterpret_cast<const float4*>(w + t + k);
            wv[k] = ok ? make_float2(w2.x, w2.y) : zero;
            wv[k + 1] = t + k + 1 < t1 ? make_float2(w2.z, w2.w) : zero;
          }
          xv[k] = ok ? win[bs + lane + t + k] : zero;
        }
#pragma unroll
        for (int k = 0; k < LOADS; ++k)
          acc[k % 4] = conj_fma(wv[k], xv[k], acc[k % 4]);
      }
      part[warp * P + lane] = add(add(acc[0], acc[1]), add(acc[2], acc[3]));
      __syncthreads();
      if (b == b0) cluster_wait();

      if (warp == 0) {
        // phase 2: c, then e = M c
        const int j = lane;
        const float2* mrec = sm + L.mb + ((c & 1) * NB + (b - b0)) * MREC;
        const float* sv = reinterpret_cast<const float*>(mrec + MT);
        float2 pv[WARPS];
#pragma unroll
        for (int v = 0; v < WARPS; ++v) pv[v] = part[v * P + j];
        float2 a = pv[0];
#pragma unroll
        for (int v = 1; v < WARPS; ++v) a = add(a, pv[v]);
        const float2 d = j < T ? dsr[bs + j] : zero;
        cb[j] = make_float2(d.x - a.x, d.y - a.y);
        __syncwarp();
        // i <= j only: for i > j the read is an unused neighbour (in the
        // buffer, mcol(i) >= i) and the select drops it
        float2 e4[4] = {zero, zero, zero, zero};
#pragma unroll
        for (int i = 0; i < P; ++i) {
          const float2 nv = cfma(mrec[mcol(i) + j - i], cb[i], e4[i % 4]);
          e4[i % 4] = i <= j ? nv : e4[i % 4];
        }
        const float2 e = add(add(e4[0], e4[1]), add(e4[2], e4[3]));
        if (j < T) {
          out[filter_len + k0 + bs + j] = e;
          const float s = sv[j];
          q[j] = make_float2(s * e.x, -s * e.y);
        }
      }
      __syncthreads();
      if (b == b1 - 1) cluster_arrive();

      // phase 3: w += sum_i q_i u_i, a thread a tap
#pragma unroll
      for (int k = 0; k < TAPS_A_THREAD; ++k) {
        const int t = tid + THREADS * k;
        if (t < m) {
          float2 a[4] = {zero, zero, zero, zero};
          for (int i0 = 0; i0 < T; i0 += LOADS) {
            float2 qv[LOADS], xv[LOADS];
#pragma unroll
            for (int kk = 0; kk < LOADS; ++kk) {
              const bool ok = i0 + kk < T;
              qv[kk] = ok ? q[i0 + kk] : zero;
              xv[kk] = ok ? win[bs + i0 + kk + t] : zero;
            }
#pragma unroll
            for (int kk = 0; kk < LOADS; ++kk)
              a[kk % 4] = cfma(qv[kk], xv[kk], a[kk % 4]);
          }
          w[t] = add(w[t], add(add(a[0], a[1]), add(a[2], a[3])));
        }
      }
      __syncthreads();
    }
  }
  cluster_wait();

  if (w_out != nullptr)
    for (int t = tid; t < m; t += THREADS)
      w_out[(long long)frame * m + t] = w[t];
}

__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(THREADS, 1)
    nlms_kernel(const float2* __restrict__ ref,   // (B, n)
                const float2* __restrict__ srv,   // (B, n)
                const float2* __restrict__ w0,    // (B, m) unflipped, or null
                float2* __restrict__ out,         // (B, n)
                float2* __restrict__ w_out,       // (B, m) unflipped, or null
                int n, int filter_len, int m, float mu, int nan_window) {
  extern __shared__ __align__(16) float2 sm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int frame = blockIdx.x / CLUSTER;
  if (cluster.block_rank() == 0) {
    chain(sm, ref, srv, w0, out, w_out, frame, n, filter_len, m);
  } else {
    float2* remote_mb =
        cluster.map_shared_rank(sm + chain_layout(m).mb, 0);
    producer(sm, remote_mb, ref + (long long)frame * n, n, m, mu,
             nan_window);
  }
}


// nlms_kernel_alone: one CTA a frame, the Gram on its helper warps.

constexpr int HELPERS = WARPS - 1;        // warps 1..7
constexpr int SCALERS = HELPERS - 2;      // helpers that scale; two scan
constexpr int RING = QMAX + 3;            // segment sums kept
constexpr int ENTRIES = (TRI + SCALERS * WARP - 1) / (SCALERS * WARP);

struct AloneLayout {
  int win, dsr, w, part, q, gs, pre, sfx, ssum, mid, sc, span, rows, total;
};

__host__ __device__ constexpr AloneLayout alone_layout(int m) {
  AloneLayout s{};
  int o = 0;
  s.win = o;  o += CHUNK + m + 4 * P; // ref of the chunk's windows
  s.dsr = o;  o += CHUNK;             // srv of the chunk's steps
  s.w = o;    o += m;                 // the taps
  s.part = o; o += WARPS * P;         // parts of w0^H u_j, one row a warp
  s.q = o;    o += P;                 // s_i conj(e_i)
  s.gs = o;   o += 2 * TRI;           // s_i G_ij, i < j, by block parity
  s.pre = o;  o += 3 * P * P;         // segment prefix sums [slot][o][lag]
  s.sfx = o;  o += 2 * P * P;         // block suffix sums [slot][i][lag]
  s.ssum = o; o += RING * P;          // segment sums [slot][lag]
  s.mid = o;  o += 4 * P;             // whole-segment sums [parity][q-Q][lag]
  s.sc = o;   o += P;                 // s_i, two blocks of P floats
  s.span = o; o += P;                 // row i's (q-Q)*P + o, two blocks of P
  s.rows = o; o += (TRI + 7) / 8;     // the row of each entry, one byte each
  s.total = o;
  return s;
}

// The Gram's scans, by one warp, each lane a lag (lanes past the block's
// lags compute unused sums). Segment g is positions [g*pb, (g+1)*pb) of win.
// Prefix: pre[slot][o][l] = sum of the terms at offsets [0, o) of segment g
// (kept when `keep`: only segments b+Q and b+Q+1 of a block b need it), and
// its whole sum into the ring. Suffix: sfx[slot][i][l] = the terms at
// offsets [i, pb) of block b's own segment. All pb terms of a lag are loaded
// before the serial sums.
__device__ void prefix_scan(const float2* __restrict__ win, float2* sm,
                            const AloneLayout& L, int g, int pb, bool keep,
                            int lane) {
  float2* __restrict__ pre = sm + L.pre + (g % 3) * P * P;
  const float2 zero = make_float2(0.f, 0.f);
  float2 tv[P];
#pragma unroll
  for (int y = 0; y < P; ++y)
    tv[y] = y < pb ? term(win, g * pb + y, lane) : zero;
  float2 acc = zero;
#pragma unroll
  for (int y = 0; y < P; ++y) {
    if (keep && y < pb) pre[y * P + lane] = acc;
    acc = add(acc, tv[y]);
  }
  sm[L.ssum + (g % RING) * P + lane] = acc;
}

__device__ void suffix_scan(const float2* __restrict__ win, float2* sm,
                            const AloneLayout& L, int b, int pb, int lane) {
  float2* __restrict__ sfx = sm + L.sfx + (b & 1) * P * P;
  const float2 zero = make_float2(0.f, 0.f);
  float2 tv[P];
#pragma unroll
  for (int y = 0; y < P; ++y)
    tv[y] = y < pb ? term(win, b * pb + y, lane) : zero;
  float2 acc = zero;
#pragma unroll
  for (int y = P - 1; y >= 0; --y) {
    acc = add(acc, tv[y]);
    if (y < pb) sfx[y * P + lane] = acc;
  }
}

// Window i of block b spans [b*pb + i, b*pb + i + m): the suffix of its own
// segment from offset i, the whole segments b+1 .. b+q-1 and the prefix of
// segment b+q to offset o, where i + m = q*pb + o (q is Q or Q+1, Q =
// m / pb >= 1). G_{i,i+l} is the sum of those three of lag l.
struct Middle {
  float2 q0, q1;   // segments b+1 .. b+Q-1, and b+1 .. b+Q
};

// The sums of whole segments of lag l, loaded in one batch.
__device__ __forceinline__ Middle middles(const float2* sm,
                                          const AloneLayout& L, int b, int Q,
                                          int l) {
  const float2 zero = make_float2(0.f, 0.f);
  float2 v[QMAX];
#pragma unroll
  for (int k = 0; k < QMAX; ++k)
    v[k] = k < Q ? sm[L.ssum + ((b + 1 + k) % RING) * P + l] : zero;
  Middle mid{zero, zero};
#pragma unroll
  for (int k = 0; k < QMAX; ++k) {
    if (k == Q - 1) mid.q1 = add(mid.q0, v[k]);
    if (k < Q - 1) mid.q0 = add(mid.q0, v[k]);
  }
  return mid;
}

// s_i of block b's T steps, into sc[b & 1], by one warp, each lane a step:
// u_i^H u_i from the scans (lag 0, real part), then the step size.
__device__ void step_sizes(float2* sm, const AloneLayout& L, int b, int T,
                           int m, int pb, float mu, int nan_window,
                           int lane) {
  float* sc = reinterpret_cast<float*>(sm + L.sc) + (b & 1) * P;
  const int Q = m / pb;
  const Middle mid = middles(sm, L, b, Q, 0);
  const int i = lane;
  if (i >= T) return;
  const int q = (i + m) / pb, o = i + m - q * pb;
  const int slot = (b + (q == Q ? Q : Q + 1)) % 3;
  reinterpret_cast<int*>(sm + L.span)[(b & 1) * P + i] = (q - Q) * P + o;
  const float uu = (sm[L.sfx + (b & 1) * P * P + i * P].x +
                    (q == Q ? mid.q0 : mid.q1).x) +
                   sm[L.pre + slot * P * P + o * P].x;
  sc[i] = step_size(uu, mu, nan_window);
}

// Block b's whole-segment sums of every lag into mid[b & 1], by one warp.
__device__ void middle_table(float2* sm, const AloneLayout& L, int b, int m,
                             int pb, int lane) {
  const Middle mid = middles(sm, L, b, m / pb, lane);
  sm[L.mid + (b & 1) * 2 * P + lane] = mid.q0;
  sm[L.mid + (b & 1) * 2 * P + P + lane] = mid.q1;
}

// The row of entry e of the triangular layout: tri(i) <= e < tri(i + 1).
__device__ __forceinline__ int row_of(int e) {
  const float c = 2 * P - 1;
  int i = (int)((c - sqrtf(c * c - 8.f * e)) * 0.5f);
  if (tri(i + 1) <= e) ++i;
  if (tri(i) > e) --i;
  return i;
}

// s_i G_ij of block b's T steps into gs[b & 1], by SCALERS warps (sw = 0 ..
// SCALERS-1), each thread a few entries of the triangular layout.
__device__ void gram_scale(float2* sm, const AloneLayout& L, int b, int T,
                           int m, int pb, int sw, int lane) {
  const float2* __restrict__ sfx = sm + L.sfx + (b & 1) * P * P;
  const float2* __restrict__ pre = sm + L.pre;
  const float2* __restrict__ mid = sm + L.mid + (b & 1) * 2 * P;
  const float* __restrict__ sc =
      reinterpret_cast<const float*>(sm + L.sc) + (b & 1) * P;
  float2* __restrict__ gs = sm + L.gs + (b & 1) * TRI;
  const int* __restrict__ span =
      reinterpret_cast<const int*>(sm + L.span) + (b & 1) * P;
  const unsigned char* __restrict__ rows =
      reinterpret_cast<const unsigned char*>(sm + L.rows);
  const int Q = m / pb;
  const int slot0 = (b + Q) % 3, slot1 = (b + Q + 1) % 3;
#pragma unroll
  for (int k = 0; k < ENTRIES; ++k) {
    const int e = (k * SCALERS + sw) * WARP + lane;
    const int i = rows[min(e, TRI - 1)], l = e - tri(i) + 1;
    if (e < TRI && i + l < T) {
      const int d = span[i] / P, o = span[i] % P;   // i + m = (Q+d)*pb + o
      const float2 g = add(add(sfx[i * P + l], mid[d * P + l]),
                           pre[(d ? slot1 : slot0) * P * P + o * P + l]);
      const float s = sc[i];
      gs[e] = make_float2(s * g.x, s * g.y);
    }
  }
}

__global__ void __launch_bounds__(THREADS) nlms_kernel_alone(
    const float2* __restrict__ ref,   // (B, n)
    const float2* __restrict__ srv,   // (B, n)
    const float2* __restrict__ w0,    // (B, m) unflipped, or null for zeros
    float2* __restrict__ out,         // (B, n)
    float2* __restrict__ w_out,       // (B, m) unflipped, or null
    int n, int filter_len, int m, float mu, int nan_window) {
  extern __shared__ __align__(16) float2 sm[];
  const AloneLayout L = alone_layout(m);
  float2* win = sm + L.win;
  float2* dsr = sm + L.dsr;
  float2* w = sm + L.w;
  float2* part = sm + L.part;
  float2* q = sm + L.q;
  const float* sc = reinterpret_cast<const float*>(sm + L.sc);
  const float2 zero = make_float2(0.f, 0.f);
  const int tid = threadIdx.x, warp = tid / WARP, lane = tid % WARP;
  const int hw = warp - 1;
  const long long row = (long long)blockIdx.x * n;
  ref += row;
  srv += row;
  out += row;
  const int steps = n - m;
  const int pb = min(P, m);       // segments shorter than a window: Q >= 1
  const int Q = m / pb;
  const int chunk = (CHUNK / pb) * pb;
  const int slice = (m + WARPS - 1) / WARPS;    // taps a warp in phase 2

  for (int t = tid; t < m; t += THREADS)
    w[t] = w0 != nullptr ? w0[(long long)blockIdx.x * m + t] : zero;
  for (int e = tid; e < TRI; e += THREADS)
    reinterpret_cast<unsigned char*>(sm + L.rows)[e] = (unsigned char)row_of(e);
  for (int j = tid; j < filter_len; j += THREADS) out[j] = zero;
  for (int j = filter_len + steps + tid; j < n; j += THREADS) out[j] = zero;

  for (int k0 = 0; k0 < steps; k0 += chunk) {
    const int TC = min(chunk, steps - k0);
    const int blocks = (TC + pb - 1) / pb;
    __syncthreads();
    // windows of steps k0 .. k0+TC-1 and the reads past them (a ragged
    // block's idle lanes, the scans of whole segments); zero past ref's end
    for (int x = tid; x < TC + m + 4 * P; x += THREADS) {
      const long long idx = (long long)k0 + 1 + x;
      win[x] = idx < n ? ref[idx] : zero;
    }
    for (int x = tid; x < TC; x += THREADS) dsr[x] = srv[k0 + filter_len + x];
    __syncthreads();
    // The Gram pipeline. Block b needs the suffix scan of its own segment,
    // the prefix scans of segments b+Q and b+Q+1 and the sums of segments
    // b+1 .. b+Q. Here: the prefix scans of segments 1 .. Q+2 and the
    // suffix scans of blocks 0 and 1, spread over the helper warps; then
    // the step sizes and whole-segment sums of blocks 0 and 1; then block
    // 0's s_i G_ij. In the loop, while warp 0 solves block b, helpers 0 and
    // 1 scan for block b+2 (segment b+Q+3's prefix, block b+2's suffix) and
    // the other five scale block b+1; the last two warps take block b+2's
    // step sizes and whole-segment sums during the tap update.
    if (warp > 0) {
      const int scans = Q + 2 + min(blocks, 2);
      for (int task = hw; task < scans; task += HELPERS) {
        if (task < Q + 2)
          prefix_scan(win, sm, L, task + 1, pb, task + 1 >= Q, lane);
        else
          suffix_scan(win, sm, L, task - Q - 2, pb, lane);
      }
    }
    __syncthreads();
    if (warp < min(blocks, 2))
      step_sizes(sm, L, warp, min(pb, TC - warp * pb), m, pb, mu, nan_window,
                 lane);
    else if (warp >= 2 && warp < 2 + min(blocks, 2))
      middle_table(sm, L, warp - 2, m, pb, lane);
    __syncthreads();
    if (hw >= 2) gram_scale(sm, L, 0, min(pb, TC), m, pb, hw - 2, lane);
    __syncthreads();

    for (int b = 0; b < blocks; ++b) {
      const int bs = b * pb, buf = b & 1;
      const int T = min(pb, TC - bs);
      // phase 2: warp `warp`'s share of w0^H u_j for j = lane
      float2 acc[2] = {zero, zero};
      const int t1 = min(m, (warp + 1) * slice);
      for (int t = warp * slice; t < t1; t += LOADS) {
        float2 wv[LOADS], xv[LOADS];
#pragma unroll
        for (int k = 0; k < LOADS; ++k) {
          const bool ok = t + k < t1;
          wv[k] = ok ? w[t + k] : zero;
          xv[k] = ok ? win[bs + lane + t + k] : zero;
        }
#pragma unroll
        for (int k = 0; k < LOADS; ++k)
          acc[k % 2] = conj_fma(wv[k], xv[k], acc[k % 2]);
      }
      part[warp * P + lane] = add(acc[0], acc[1]);
      __syncthreads();

      if (warp == 0) {
        // phase 3: the solve
        const float2* gs = sm + L.gs + buf * TRI;
        float2 pv[WARPS];
#pragma unroll
        for (int v = 0; v < WARPS; ++v) pv[v] = part[v * P + lane];
        float2 a = pv[0];
#pragma unroll
        for (int v = 1; v < WARPS; ++v) a = add(a, pv[v]);
        const float2 d = lane < T ? dsr[bs + lane] : zero;
        float2 cj = make_float2(d.x - a.x, d.y - a.y);
        // lane j's column of the rows in registers, so that a step waits on
        // the shuffle alone. The update is a select, not a branch, so the
        // warp stays converged for the shuffles. Steps i >= T of a ragged
        // block touch only lanes j > i >= T, whose values are dropped.
        float2 g[WARP];
#pragma unroll
        for (int i = 0; i < WARP; ++i)
          // for j <= i this reads an unused neighbour (at worst the element
          // before gs): the select below drops it
          g[i] = gs[tri(i) + lane - i - 1];
#pragma unroll
        for (int i = 0; i < WARP; ++i) {
          const float er = __shfl_sync(FULL, cj.x, i);
          const float ei = __shfl_sync(FULL, cj.y, i);
          const bool later = lane > i;
          const float x = fmaf(ei, g[i].y, fmaf(-er, g[i].x, cj.x));
          const float y = fmaf(-ei, g[i].x, fmaf(-er, g[i].y, cj.y));
          cj.x = later ? x : cj.x;
          cj.y = later ? y : cj.y;
        }
        if (lane < T) {
          out[filter_len + k0 + bs + lane] = cj;
          const float s = sc[buf * P + lane];
          q[lane] = make_float2(s * cj.x, -s * cj.y);
        }
      } else {
        // phase 1 of the next two blocks
        if (hw == 0 && b + 2 < blocks)
          prefix_scan(win, sm, L, b + Q + 3, pb, true, lane);
        else if (hw == 1 && b + 2 < blocks)
          suffix_scan(win, sm, L, b + 2, pb, lane);
        else if (hw >= 2 && b + 1 < blocks)
          gram_scale(sm, L, b + 1, min(pb, TC - bs - pb), m, pb, hw - 2, lane);
      }
      __syncthreads();

      // block b+2's step sizes and whole-segment sums, by the last two
      // warps (they have taps in phase 4 only when m > 192), then phase 4:
      // w += sum_i q_i u_i, a thread a tap
      if (warp == WARPS - 1 && b + 2 < blocks)
        step_sizes(sm, L, b + 2, min(pb, TC - bs - 2 * pb), m, pb, mu,
                   nan_window, lane);
      if (warp == WARPS - 2 && b + 2 < blocks)
        middle_table(sm, L, b + 2, m, pb, lane);
#pragma unroll
      for (int k = 0; k < TAPS_A_THREAD; ++k) {
        const int t = tid + THREADS * k;
        if (t < m) {
          float2 a[4] = {zero, zero, zero, zero};
          for (int i0 = 0; i0 < T; i0 += LOADS) {
            float2 qv[LOADS], xv[LOADS];
#pragma unroll
            for (int kk = 0; kk < LOADS; ++kk) {
              const bool ok = i0 + kk < T;
              qv[kk] = ok ? q[i0 + kk] : zero;
              xv[kk] = ok ? win[bs + i0 + kk + t] : zero;
            }
#pragma unroll
            for (int kk = 0; kk < LOADS; ++kk)
              a[kk % 4] = cfma(qv[kk], xv[kk], a[kk % 4]);
          }
          w[t] = add(w[t], add(add(a[0], a[1]), add(a[2], a[3])));
        }
      }
      __syncthreads();
    }
  }

  if (w_out != nullptr)
    for (int t = tid; t < m; t += THREADS)
      w_out[(long long)blockIdx.x * m + t] = w[t];
}

// Shared memory of a CTA: of a cluster's, or of the kernel alone.
size_t smem_bytes(int m, bool alone) {
  return (size_t)(alone ? alone_layout(m).total
                        : std::max(chain_layout(m).total,
                                   producer_layout(m).total)) *
         sizeof(float2);
}

// Per card, once: the opt-ins above the 48 KB default for the largest m,
// and the clusters the card holds at once (at the largest m; every m takes
// one CTA an SM, so the count holds for all). Attributes and counts belong
// to the current device.
bool ready[MAX_DEVICES];
int clusters[MAX_DEVICES];

cudaError_t prepare(int device) {
  if (ready[device]) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      nlms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes(MAX_TAPS, false));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(nlms_kernel_alone,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_bytes(MAX_TAPS, true));
  if (err == cudaSuccess) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(CLUSTER);
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = smem_bytes(MAX_TAPS, false);
    err = cudaOccupancyMaxActiveClusters(&clusters[device], nlms_kernel,
                                         &cfg);
  }
  ready[device] = err == cudaSuccess;
  return err;
}

// Runs fn with `device` current, then makes the caller's device current
// again; the first error that is not 0.
template <typename Fn>
cudaError_t on_device(int device, Fn fn) {
  int current;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  err = fn();
  if (current != device) {
    const cudaError_t back = cudaSetDevice(current);
    if (err == cudaSuccess) err = back;
  }
  return err;
}

}  // namespace

extern "C" {

// ref, srv, out: (B, n, 2) float32 (complex64); w0, w_out: (B, m, 2)
// float32 in the unflipped order, either may be null. Requires
// 1 <= filter_len, m = filter_len + peek <= 512, n > m, 1 <= B and
// 2 B <= 2^31-1; the pointers and the stream on card `device`, which the
// call makes current for the launch and then restores.
// Launches on `stream`, does not synchronise, and returns the first CUDA
// error that is not 0.
int nlms_launch(const float* ref, const float* srv, const float* w0,
                float* out, float* w_out, int B, int n, int filter_len, int m,
                float mu, int nan_window, int device, void* stream) {
  if (B <= 0 || B > 0x7fffffff / CLUSTER || filter_len < 1 ||
      m < filter_len || m > MAX_TAPS || n <= m || device < 0 ||
      device >= MAX_DEVICES)
    return (int)cudaErrorInvalidValue;
  return (int)on_device(device, [&]() {
    cudaError_t err = prepare(device);
    if (err != cudaSuccess) return err;
    const auto* ref2 = reinterpret_cast<const float2*>(ref);
    const auto* srv2 = reinterpret_cast<const float2*>(srv);
    const auto* w02 = reinterpret_cast<const float2*>(w0);
    auto* out2 = reinterpret_cast<float2*>(out);
    auto* w_out2 = reinterpret_cast<float2*>(w_out);
    const auto st = static_cast<cudaStream_t>(stream);
    if (B > clusters[device])
      nlms_kernel_alone<<<B, THREADS, smem_bytes(m, true), st>>>(
          ref2, srv2, w02, out2, w_out2, n, filter_len, m, mu, nan_window);
    else
      nlms_kernel<<<B * CLUSTER, THREADS, smem_bytes(m, false), st>>>(
          ref2, srv2, w02, out2, w_out2, n, filter_len, m, mu, nan_window);
    return cudaGetLastError();
  });
}

// The CTAs a frame that a launch of B frames takes on card `device`, into
// *ctas: 2 (a cluster), or 1 (alone); returns the first CUDA error that is
// not 0.
int nlms_cluster_ctas(int B, int device, int* ctas) {
  if (B <= 0 || B > 0x7fffffff / CLUSTER || device < 0 ||
      device >= MAX_DEVICES)
    return (int)cudaErrorInvalidValue;
  return (int)on_device(device, [&]() {
    const cudaError_t err = prepare(device);
    if (err == cudaSuccess) *ctas = B > clusters[device] ? 1 : CLUSTER;
    return err;
  });
}

// The block length P.
int nlms_block_steps() { return P; }

const char* nlms_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
