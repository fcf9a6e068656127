// Batched complex NLMS clutter canceller, for Hopper: the exact block
// recurrence.
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
// so only a scalar triangular solve stays serial. This is not block LMS:
// every step still sees the taps of the step before it. One CTA of 8 warps
// per frame. For each block b, between block-wide barriers:
//
//   1. Gram (helper warps 1-7, while warp 0 solves block b-1): the scans
//      of block b+1 (below), and s_i G_ij of block b in shared memory; the
//      step sizes s_i come from the last warp during the tap update before;
//   2. dot products (all warps): c_j = d_j - w0^H u_j for the block's steps;
//      warp v sums its eighth of the taps for step j = lane, and warp 0
//      adds the eight parts;
//   3. solve (warp 0): at step i lane i holds e_i = c_i, one __shfl_sync
//      per component broadcasts it, and each lane j > i does
//      c_j -= e_i (s_i G_ij) with its column of s_i G_ij in registers: one
//      shuffle and two dependent FMAs a step, where the one-warp-per-step
//      scan had a 5-level all-reduce of three sums and a division. The
//      block's errors go out as one coalesced run;
//   4. tap update (all warps): w = w0 + sum_i s_i conj(e_i) u_i, a thread a
//      tap.
//
// The Gram. G_{i,i+l} = sum of conj(r_x) r_{x+l} over window i's positions.
// The chunk's positions are cut into segments of pb = min(P, m) (a block's
// steps: block b's windows start in segment b). Window i of block b is the
// suffix of segment b from offset i, whole segments b+1 .. b+q-1 and a
// prefix of segment b+q, q = Q or Q+1 (Q = m / pb). So each lag is scanned
// once a block: a prefix scan of one new segment (its sum goes to a ring of
// segment sums) and a suffix scan of the block's own segment, about 2P
// products a lag instead of the m + P of a direct start-and-slide, and each
// entry is (suffix + whole segments) + prefix. No term outside window i
// enters G_{i,j}, so its rounding stays relative to |u_i||u_j|. The solve
// needs that: at the edge of a zero run a window holds a few samples, u^H u
// is small and s_i large, and the samples that a slide would subtract leave
// a residue that s_i amplifies. An all-zero window has G = 0 and u^H u = 0
// exactly (lag 0 sums |r|^2 alone). The scans run two blocks ahead, the
// scaling one, so the block barriers order every hand-over.
//
// Zero windows, u_i^H u_i == 0 (exactly when every |r|^2 of the window is 0
// in float32, as in the plain version's direct sum): under "zero" s_i = 0,
// so the window changes nothing, as u_i = 0 does in the scan; under "nan"
// s_i = NaN, so e_i stays finite and every later error of the frame, and the
// taps, are NaN, as the scan's 0 * inf makes them. A window whose samples
// are not all 0 but whose |r|^2 all underflow counts as a zero window here
// (the scan would take one huge step there). 0 < u^H u < 1e-30 takes
// g = 1e-30 under "zero" and u^H u under "nan", as in the scan.
//
// What bounds it: 16*m FLOP per step and frame are needed (8m for w^H u, 8m
// for the update). At the FM geometry (F = 10, n = 262144, m = 185, 261959
// steps) that is 7.75 GFLOP, 0.116 ms at the H100's 67 TFLOP/s FP32. With
// one CTA per frame (10 of 132 SMs at F = 10) the time is a block's latency
// times the block count: the dot products and the tap update, each bound by
// shared-memory traffic (a window sample and a broadcast tap or step size a
// complex MAC), and the solve's P dependent shuffle-FMA steps; the Gram
// rides on the helper warps under the solve.

#include <cuda_runtime.h>

namespace {

#ifndef NLMS_BLOCK
#define NLMS_BLOCK 32
#endif
constexpr int P = NLMS_BLOCK;   // steps a block: PERF.md has the P table
static_assert(P == 32 || P == 64, "the block is one or two steps a lane");
constexpr int WARP = 32;
constexpr int WARPS = 8;
constexpr int THREADS = WARP * WARPS;
constexpr int HELPERS = WARPS - 1;        // warps 1..7
constexpr int SCALERS = HELPERS - 2;      // helpers that scale; two scan
constexpr int JL = P / WARP;              // steps (or lags) a lane
constexpr int CHUNK = P == 32 ? 2048 : 512;   // steps staged at a time
constexpr int MAX_TAPS = 512;
constexpr int QMAX = MAX_TAPS / P;        // whole segments in a window
constexpr int RING = QMAX + 3;            // segment sums kept
constexpr int TRI = P * (P - 1) / 2;      // Gram entries i < j of a block
constexpr int ENTRIES = (TRI + SCALERS * WARP - 1) / (SCALERS * WARP);
constexpr int TAPS_A_THREAD = MAX_TAPS / THREADS;
constexpr int MAX_DEVICES = 64;
constexpr int LOADS = 8;                  // terms loaded ahead of their sums
constexpr unsigned FULL = 0xffffffffu;

// Shared memory, in float2 units from the start of the dynamic buffer.
struct Layout {
  int win, dsr, w, part, q, gs, pre, sfx, ssum, mid, sc, span, rows, total;
};

__host__ __device__ inline Layout layout(int m) {
  Layout s;
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

// Row i's first entry in the triangular layout of G_ij, i < j < P.
__host__ __device__ constexpr int tri(int i) { return i * (2 * P - i - 1) / 2; }

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

// The Gram term of lag l at window position x: conj(r_x) r_{x+l}. At lag 0
// only the real part, fma(x, x, y*y) = |r_x|^2, is used: it is 0 exactly
// when the plain version's rounded x*x + y*y is, so a zero window sums to 0.
__device__ __forceinline__ float2 term(const float2* win, int x, int l) {
  return conj_mul(win[x], win[x + l]);
}

// The Gram's scans, by one warp, each lane a lag (lanes past the block's
// lags compute unused sums). Segment g is positions [g*pb, (g+1)*pb) of win.
// Prefix: pre[slot][o][l] = sum of the terms at offsets [0, o) of segment g
// (kept when `keep`: only segments b+Q and b+Q+1 of a block b need it), and
// its whole sum into the ring. Suffix: sfx[slot][i][l] = the terms at
// offsets [i, pb) of block b's own segment. All pb terms of a lag are loaded
// before the serial sums.
__device__ void prefix_scan(const float2* __restrict__ win, float2* sm,
                            const Layout& L, int g, int pb, bool keep,
                            int lane) {
  float2* __restrict__ pre = sm + L.pre + (g % 3) * P * P;
  const float2 zero = make_float2(0.f, 0.f);
#pragma unroll 1
  for (int h = 0; h < JL; ++h) {
    const int l = lane + WARP * h;
    float2 tv[P];
#pragma unroll
    for (int y = 0; y < P; ++y)
      tv[y] = y < pb ? term(win, g * pb + y, l) : zero;
    float2 acc = zero;
#pragma unroll
    for (int y = 0; y < P; ++y) {
      if (keep && y < pb) pre[y * P + l] = acc;
      acc = add(acc, tv[y]);
    }
    sm[L.ssum + (g % RING) * P + l] = acc;
  }
}

__device__ void suffix_scan(const float2* __restrict__ win, float2* sm,
                            const Layout& L, int b, int pb, int lane) {
  float2* __restrict__ sfx = sm + L.sfx + (b & 1) * P * P;
  const float2 zero = make_float2(0.f, 0.f);
#pragma unroll 1
  for (int h = 0; h < JL; ++h) {
    const int l = lane + WARP * h;
    float2 tv[P];
#pragma unroll
    for (int y = 0; y < P; ++y)
      tv[y] = y < pb ? term(win, b * pb + y, l) : zero;
    float2 acc = zero;
#pragma unroll
    for (int y = P - 1; y >= 0; --y) {
      acc = add(acc, tv[y]);
      if (y < pb) sfx[y * P + l] = acc;
    }
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
__device__ __forceinline__ Middle middles(const float2* sm, const Layout& L,
                                          int b, int Q, int l) {
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
// u_i^H u_i from the scans (lag 0, real part), then mu / g(u_i^H u_i) with
// the zero-window rule of the note above.
__device__ void step_sizes(float2* sm, const Layout& L, int b, int T, int m,
                           int pb, float mu, int nan_window, int lane) {
  float* sc = reinterpret_cast<float*>(sm + L.sc) + (b & 1) * P;
  const int Q = m / pb;
  const Middle mid = middles(sm, L, b, Q, 0);
#pragma unroll
  for (int h = 0; h < JL; ++h) {
    const int i = lane + WARP * h;
    if (i >= T) continue;
    const int q = (i + m) / pb, o = i + m - q * pb;
    const int slot = (b + (q == Q ? Q : Q + 1)) % 3;
    reinterpret_cast<int*>(sm + L.span)[(b & 1) * P + i] = (q - Q) * P + o;
    const float uu = (sm[L.sfx + (b & 1) * P * P + i * P].x +
                      (q == Q ? mid.q0 : mid.q1).x) +
                     sm[L.pre + slot * P * P + o * P].x;
    float s;
    if (uu == 0.f) {
      s = nan_window ? __int_as_float(0x7fc00000) : 0.f;
    } else {
      // "zero": max(uu, 1e-30), written so that a NaN uu stays NaN
      s = mu / ((nan_window || !(uu < 1e-30f)) ? uu : 1e-30f);
    }
    sc[i] = s;
  }
}

// Block b's whole-segment sums of every lag into mid[b & 1], by one warp.
__device__ void middle_table(float2* sm, const Layout& L, int b, int m, int pb,
                             int lane) {
#pragma unroll
  for (int h = 0; h < JL; ++h) {
    const int l = lane + WARP * h;
    const Middle mid = middles(sm, L, b, m / pb, l);
    sm[L.mid + (b & 1) * 2 * P + l] = mid.q0;
    sm[L.mid + (b & 1) * 2 * P + P + l] = mid.q1;
  }
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
__device__ void gram_scale(float2* sm, const Layout& L, int b, int T, int m,
                           int pb, int sw, int lane) {
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

__global__ void __launch_bounds__(THREADS) nlms_kernel(
    const float2* __restrict__ ref,   // (B, n)
    const float2* __restrict__ srv,   // (B, n)
    const float2* __restrict__ w0,    // (B, m) unflipped, or null for zeros
    float2* __restrict__ out,         // (B, n)
    float2* __restrict__ w_out,       // (B, m) unflipped, or null
    int n, int filter_len, int m, float mu, int nan_window) {
  extern __shared__ float2 sm[];
  const Layout L = layout(m);
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
      // phase 2: warp `warp`'s share of w0^H u_j for j = lane + 32h
      float2 acc[JL][2];
#pragma unroll
      for (int h = 0; h < JL; ++h) acc[h][0] = acc[h][1] = zero;
      const int t1 = min(m, (warp + 1) * slice);
      for (int t = warp * slice; t < t1; t += LOADS) {
        float2 wv[LOADS], xv[JL][LOADS];
#pragma unroll
        for (int k = 0; k < LOADS; ++k) {
          const bool ok = t + k < t1;
          wv[k] = ok ? w[t + k] : zero;
#pragma unroll
          for (int h = 0; h < JL; ++h)
            xv[h][k] = ok ? win[bs + lane + WARP * h + t + k] : zero;
        }
#pragma unroll
        for (int k = 0; k < LOADS; ++k)
#pragma unroll
          for (int h = 0; h < JL; ++h)
            acc[h][k % 2] = conj_fma(wv[k], xv[h][k], acc[h][k % 2]);
      }
#pragma unroll
      for (int h = 0; h < JL; ++h)
        part[warp * P + lane + WARP * h] = add(acc[h][0], acc[h][1]);
      __syncthreads();

      if (warp == 0) {
        // phase 3: the solve
        const float2* gs = sm + L.gs + buf * TRI;
        float2 cj[JL];
#pragma unroll
        for (int h = 0; h < JL; ++h) {
          const int j = lane + WARP * h;
          float2 pv[WARPS];
#pragma unroll
          for (int v = 0; v < WARPS; ++v) pv[v] = part[v * P + j];
          float2 acc = pv[0];
#pragma unroll
          for (int v = 1; v < WARPS; ++v) acc = add(acc, pv[v]);
          const float2 d = j < T ? dsr[bs + j] : zero;
          cj[h] = make_float2(d.x - acc.x, d.y - acc.y);
        }
        // 32 steps at a time, with lane j's column of those rows in
        // registers, so that a step waits on the shuffle alone. The update
        // is a select, not a branch, so the warp stays converged for the
        // shuffles. Steps i >= T of a ragged block touch only lanes
        // j > i >= T, whose values are dropped.
#pragma unroll
        for (int r = 0; r < JL; ++r) {
          float2 g[JL][WARP];
#pragma unroll
          for (int h = r; h < JL; ++h)
#pragma unroll
            for (int ii = 0; ii < WARP; ++ii) {
              // for j <= i this reads an unused neighbour (at worst the
              // element before gs): the select below drops it
              const int i = r * WARP + ii, j = lane + WARP * h;
              g[h][ii] = gs[tri(i) + j - i - 1];
            }
#pragma unroll
          for (int ii = 0; ii < WARP; ++ii) {
            const float er = __shfl_sync(FULL, cj[r].x, ii);
            const float ei = __shfl_sync(FULL, cj[r].y, ii);
#pragma unroll
            for (int h = r; h < JL; ++h) {
              const bool later = lane + WARP * h > r * WARP + ii;
              const float2 gi = g[h][ii];
              const float x = fmaf(ei, gi.y, fmaf(-er, gi.x, cj[h].x));
              const float y = fmaf(-ei, gi.x, fmaf(-er, gi.y, cj[h].y));
              cj[h].x = later ? x : cj[h].x;
              cj[h].y = later ? y : cj[h].y;
            }
          }
        }
#pragma unroll
        for (int h = 0; h < JL; ++h) {
          const int j = lane + WARP * h;
          if (j < T) {
            out[filter_len + k0 + bs + j] = cj[h];
            const float s = sc[buf * P + j];
            q[j] = make_float2(s * cj[h].x, -s * cj[h].y);
          }
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

size_t smem_bytes(int m) { return (size_t)layout(m).total * sizeof(float2); }

// The opt-in above the 48 KB default, once per device for the largest m; the
// attribute belongs to the current device.
bool opted_in[MAX_DEVICES];

}  // namespace

extern "C" {

// ref, srv, out: (B, n, 2) float32 (complex64); w0, w_out: (B, m, 2)
// float32 in the unflipped order, either may be null. Requires
// 1 <= filter_len, m = filter_len + peek <= 512, n > m, 1 <= B <= 2^31-1;
// the pointers and the stream on card `device`, which the call makes
// current for the launch and then restores. Launches on `stream`, does not
// synchronise, and returns the first CUDA error that is not 0.
int nlms_launch(const float* ref, const float* srv, const float* w0,
                float* out, float* w_out, int B, int n, int filter_len, int m,
                float mu, int nan_window, int device, void* stream) {
  if (B <= 0 || filter_len < 1 || m < filter_len || m > MAX_TAPS || n <= m ||
      device < 0 || device >= MAX_DEVICES)
    return (int)cudaErrorInvalidValue;
  int current;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!opted_in[device]) {
    err = cudaFuncSetAttribute(nlms_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_bytes(MAX_TAPS));
    opted_in[device] = err == cudaSuccess;
  }
  if (err == cudaSuccess) {
    nlms_kernel<<<B, THREADS, smem_bytes(m),
                  static_cast<cudaStream_t>(stream)>>>(
        reinterpret_cast<const float2*>(ref),
        reinterpret_cast<const float2*>(srv),
        reinterpret_cast<const float2*>(w0), reinterpret_cast<float2*>(out),
        reinterpret_cast<float2*>(w_out), n, filter_len, m, mu, nan_window);
    err = cudaGetLastError();
  }
  if (current != device) {
    const cudaError_t back = cudaSetDevice(current);
    if (err == cudaSuccess) err = back;
  }
  return (int)err;
}

// The block length P this library was built with.
int nlms_block_steps() { return P; }

const char* nlms_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
