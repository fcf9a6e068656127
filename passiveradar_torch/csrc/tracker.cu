// The multitarget tracker's frame step over every channel's track table,
// for Hopper.
//
// Replaces multitarget_step of the JAX package's detect/trackers.py (:189),
// a jax.jit program whose slot loop is a lax.scan (no Pallas kernel there).
// Its contract is the port's plain step, detect/trackers.py
// multitarget_step_plain. One launch advances C channels' tables of N slots
// by T frames. For each channel and frame, in order:
//
//   1. the processing order from the statuses as they stand before the
//      frame: confirmed, preliminary, then free, by slot within a class;
//   2. from avail = valid, each slot in that order takes a candidate
//      (_associate): the early gate by status (everything for a free slot;
//      |dr| < 5, |dd| < 24 around the last measurement for a preliminary
//      one; |dr| < 4, |dd| < 20 around the estimate for a confirmed one)
//      AND avail, for a confirmed slot also z^T S^-1 z < 6; the first gated
//      candidate (the strongest) for a free or confirmed slot, the gated one
//      nearest the origin for a preliminary one (first index on ties, as
//      argmin); then the pool loses everything within 10 / 12 of the choice
//      (a free slot with several candidates), everything (a free slot with
//      one) or the early gate (a tracked slot), and nothing when no
//      candidate was found;
//   3. every slot's transition (_track_transition): a free slot that found
//      a candidate becomes a fresh track (the record `fresh`, built by the
//      wrapper from make_track, at the measurement), a free slot that found
//      none stays as it is, a live slot runs the adaptive Kalman update or
//      the extrapolation (state by F1, covariance by F2) and the status
//      rules on its pre-update history and lifetime;
//   4. the frame's table goes to out[t]; the input table is never written.
//
// Design: one CTA of 256 threads a channel; the channel's table (N records
// of 110 32-bit words, the leaves in the wrapper's order) stays in shared
// memory for the whole launch, with a frame's candidate ranges and
// Dopplers. A slot's gates read only its own state from before the frame
// and meet the pool only through AND avail, so they are computed for every
// slot at once; only the pool's hand-over from slot to slot is a chain.
// Sets of candidates are bitmasks of 32-bit words, lane-major: candidate
// k = 1024 q + 32 b + l is bit b of word q of lane l, so lane l owns every
// candidate k = l (mod 32) and reads its candidates at consecutive
// addresses with its neighbours. The slots' order (confirmed, preliminary,
// free), their statuses and their masks are kept by rank. A frame is four
// phases between block barriers:
//
//   a. every warp: the early and the full gate of each tracked slot over
//      every candidate, as masks (a free slot's gate is the pool itself):
//      a warp a (tracked slot, four rows), the early gate with no branch,
//      the Mahalanobis test only where some lane passed it;
//   b. warp 0 alone, the pool in its registers, the slots in rank order,
//      the next rank's masks loaded while this one runs: a tracked slot
//      ANDs its gate with the pool, keeps that set, and if it is not empty
//      (__any_sync) the pool drops its early gate; a free slot counts the
//      pool (__popc, __reduce_add_sync), takes its first candidate (__ffs,
//      __reduce_min_sync), and drops what lies within 10 / 12 of it (each
//      lane tests its own candidates) or, with one candidate, everything.
//      No block barrier on the chain;
//   c. a warp a tracked slot: its choice from the set it kept, the first
//      bit, or the nearest to the origin by a (distance, index) minimum
//      over the set bits (__reduce_min_sync on the distance's bits, which
//      order as the floats do for distances >= 0, then on the index);
//   d. two slots a warp, one a half: the transition, its Kalman products
//      an entry a lane in stages ordered by __syncwarp, and the slot's
//      gates for the next frame; then the frame's table goes out through
//      each record word's leaf pointer, found once a launch, the next
//      frame's candidates come in and warp 0 ranks the slots
//      (__ballot_sync).
//
// The gate arithmetic is the plain version's, operation for operation
// (built with -fmad=false, so no product is contracted into an FMA): equal
// inputs give equal gate decisions. The Kalman products are summed in the
// plain version's index order; its matrix products may round otherwise,
// so the float leaves agree within the tests' tolerances.
//
// What bounds it: not the card's rates. A launch moves C*T*(2K floats + K
// bytes) of candidates and (T+1)*C*N*440 bytes of table: at the wideband
// shape (C = 8, K = 384, N = 10, T = 1) 98 KB, 29 ns at 3.35 TB/s. Its time
// is latency, measured with clock64() stamps on an H100 at the FM shape
// (C = 1, K = 540, 10 slots, T = 1; ~19 k cycles a launch): the loads from
// device memory before the first frame ~27%, the gate pass ~22%, the
// transitions ~22%, the chain ~20% (a tracked slot's turn ~400 cycles),
// the choices and the table's way out the rest. Every phase takes several
// times what its chain of dependent shared-memory loads, votes and
// barriers would.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int N_LEAVES = 13;
constexpr int MAX_DEVICES = 64;
constexpr int VARIANTS = 6;            // pool words a lane: 1, 2, ..., 32
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned NONE = 0xffffffffu;  // no candidate

// A slot's record: the leaves status, lifetime, measurement, estimate,
// history, kalman x, P, F1, F2, Q, H, R, S, as 32-bit words.
constexpr int W_STATUS = 0, W_LIFETIME = 1, W_MEAS = 2, W_EST = 4,
              W_HIST = 6, W_X = 26, W_P = 30, W_F1 = 46, W_F2 = 62,
              W_Q = 78, W_H = 94, W_R = 102, W_S = 106, WORDS = 110;
constexpr int N_HISTORY = 20;

struct Leaves {
  const unsigned* in[N_LEAVES];   // (C, N, words) each
  unsigned* out[N_LEAVES];        // (T, C, N, words) each
};

// Word w of a record as its leaf, its offset there and its words a slot.
__device__ void leaf_of(int w, int& leaf, int& off, int& words) {
  constexpr int start[N_LEAVES + 1] = {W_STATUS, W_LIFETIME, W_MEAS, W_EST,
                                       W_HIST,   W_X,        W_P,    W_F1,
                                       W_F2,     W_Q,        W_H,    W_R,
                                       W_S,      WORDS};
  leaf = 0;
#pragma unroll
  for (int l = 1; l < N_LEAVES; ++l)
    if (w >= start[l]) leaf = l;
  int from = 0, to = 0;
#pragma unroll
  for (int l = 0; l < N_LEAVES; ++l)
    if (l == leaf) from = start[l], to = start[l + 1];
  off = w - from;
  words = to - from;
}

// The leaf l of a Leaves list (l known only at run time), by a select over
// constant indices: a kernel parameter indexed at run time would be read
// one distinct address at a time.
template <typename P>
__device__ __forceinline__ P pick(const P (&leaves)[N_LEAVES], int l) {
  P out = leaves[0];
#pragma unroll
  for (int i = 1; i < N_LEAVES; ++i)
    if (l == i) out = leaves[i];
  return out;
}

__device__ __forceinline__ float word_f(const unsigned* rec, int w) {
  return __uint_as_float(rec[w]);
}

// A slot's candidate gates, as _associate forms them, from its status, last
// measurement, estimate and S as they stand before the frame: the early
// gate's box (centre c, half-widths w; around the last measurement for a
// preliminary slot, the estimate for a confirmed one) and S^-1.
struct Gate {
  int status;
  float c0, c1, w0, w1, lm0, lm1, i00, i01, i10, i11;
};

__device__ Gate make_gate(int status, float lm0, float lm1, float le0,
                          float le1, float s00, float s01, float s10,
                          float s11) {
  // S^-1 as _inv2: the adjugate, each entry over the determinant
  const float det = s00 * s11 - s01 * s10;
  const bool prelim = status == 1;
  return Gate{status,      prelim ? lm0 : le0, prelim ? lm1 : le1,
              prelim ? 5.0f : 4.0f, prelim ? 24.0f : 20.0f, lm0, lm1,
              s11 / det,   -s01 / det, -s10 / det, s00 / det};
}

__device__ Gate record_gate(const unsigned* rec) {
  return make_gate((int)rec[W_STATUS], word_f(rec, W_MEAS),
                   word_f(rec, W_MEAS + 1), word_f(rec, W_EST),
                   word_f(rec, W_EST + 1), word_f(rec, W_S),
                   word_f(rec, W_S + 1), word_f(rec, W_S + 2),
                   word_f(rec, W_S + 3));
}

// The early gate of a tracked slot, with no branch.
__device__ __forceinline__ bool early(const Gate& g, float r, float d) {
  return (fabsf(r - g.c0) < g.w0) & (fabsf(d - g.c1) < g.w1);
}

// The Mahalanobis gate of a confirmed slot, centred on the last measurement.
__device__ __forceinline__ bool inside(const Gate& g, float r, float d) {
  const float zr = g.lm0 - r, zd = g.lm1 - d;
  const float m2 = zr * (g.i00 * zr + g.i01 * zd) +
                   zd * (g.i10 * zr + g.i11 * zd);
  return m2 < 6.0f;
}

// A status's place in the processing order.
__device__ __forceinline__ int priority(int status) {
  return status == 2 ? 0 : (status == 1 ? 1 : 2);
}

// order[rank] = slot, rstat[rank] = its status and rgates[rank] = its
// gates for every slot, and *tracked = the live slots' count, by warp 0
// from the slots' gates: confirmed, preliminary, free, by slot within a
// class.
__device__ void make_order(int N, int lane, int* order, int* rstat,
                           Gate* rgates, int* tracked, const Gate* gates) {
  int before[3] = {0, 0, 0};               // each class's slots so far
  for (int i0 = 0; i0 < N; i0 += 32) {
    const int i = i0 + lane;
    const int p = i < N ? priority(gates[i].status) : 3;
#pragma unroll
    for (int c = 0; c < 3; ++c)
      before[c] += __popc(__ballot_sync(FULL, p == c));
  }
  const int total0 = before[0], total1 = before[1];
  if (lane == 0) *tracked = total0 + total1;
  before[0] = before[1] = before[2] = 0;
  for (int i0 = 0; i0 < N; i0 += 32) {
    const int i = i0 + lane;
    const int st = i < N ? gates[i].status : 0;
    const int p = i < N ? priority(st) : 3;
    const unsigned below = (1u << lane) - 1;
    unsigned mine = 0;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const unsigned in = __ballot_sync(FULL, p == c);
      if (p == c) mine = before[c] + __popc(in & below);
      before[c] += __popc(in);
    }
    if (i < N) {
      const int rank = (p > 0 ? total0 : 0) + (p > 1 ? total1 : 0) + mine;
      order[rank] = i;
      rstat[rank] = st;
      rgates[rank] = gates[i];
    }
  }
}

// The lowest candidate index of a lane's set (NONE when empty).
template <int WPL>
__device__ __forceinline__ unsigned first_of(const unsigned (&g)[WPL],
                                             int lane) {
  unsigned k = NONE;
#pragma unroll
  for (int q = WPL - 1; q >= 0; --q)
    if (g[q]) k = 1024u * q + 32u * (__ffs(g[q]) - 1) + lane;
  return k;
}

// Candidate slots in shared memory: K rounded up to four rows of 32, the
// pad at +inf, so that four rows load with no bounds check.
__host__ __device__ inline int padded(int K) { return (K + 127) / 128 * 128; }

// Entry (i, j) of a @ b summed as the plain version's matmul sums it,
// a[i][0] b[0][j] then + a[i][t] b[t][j] in t order: a points at a[i][0],
// b at b[0][j], and sa, sb step along a's row and b's column.
template <int K>
__device__ __forceinline__ float dot(const float* a, int sa, const float* b,
                                     int sb) {
  float v = a[0] * b[0];
#pragma unroll
  for (int t = 1; t < K; ++t) v = v + a[t * sa] * b[t * sb];
  return v;
}

// A slot's scratch for its transition, in floats: F2 P (then K H), P',
// H P', P' H^T, K, S, x', H x, S^-1, z - H x.
constexpr int S_FP = 0, S_PP = 16, S_HP = 32, S_PHT = 40, S_K = 48,
              S_S = 56, S_XP = 60, S_HX = 64, S_SI = 66, S_Y = 70,
              SCRATCH = 72;

// The transitions (_track_transition) of two slots a warp, one a half
// (sl: the lane in its half), in place on their records: the Kalman
// products an entry a lane, each summed as the plain version's matmul
// sums it, their stages ordered by __syncwarp, which every lane of the
// warp runs. live: the slot is live; fresh_slot: it is free and found a
// candidate, so it becomes the fresh record at the measurement.
__device__ void transition(unsigned* rec, float m0, float m1, bool found,
                           bool live, bool fresh_slot,
                           const unsigned* fresh, float* sc, int sl) {
  const float* rf = reinterpret_cast<const float*>(rec);
  const float *F1 = rf + W_F1, *F2 = rf + W_F2, *H = rf + W_H;
  const int status = (int)rec[W_STATUS], lifetime = (int)rec[W_LIFETIME];
  const int i4 = sl >> 2, j4 = sl & 3, i2 = (sl & 7) >> 1, j2 = sl & 1;
  float r_scale = 1.0f;
  if (found) {
    const float d0 = m0 - rf[W_MEAS], d1 = m1 - rf[W_MEAS + 1];
    r_scale = d0 * d0 + d1 * d1;
  }
  // _advance: x by F1, P by F2, S with R scaled by |z - last z|^2 (by 1
  // when extrapolating)
  if (live) sc[S_FP + sl] = dot<4>(F2 + 4 * i4, 1, rf + W_P + j4, 4);
  __syncwarp();
  if (live)
    sc[S_PP + sl] =
        dot<4>(sc + S_FP + 4 * i4, 1, F2 + 4 * j4, 1) + rf[W_Q + sl];
  __syncwarp();
  if (live && sl < 8)
    sc[S_HP + sl] = dot<4>(H + 4 * i4, 1, sc + S_PP + j4, 4);
  else if (live)
    sc[S_PHT + sl - 8] = dot<4>(sc + S_PP + 4 * i2, 1, H + 4 * j2, 1);
  __syncwarp();
  if (live && sl < 4)
    sc[S_XP + sl] = dot<4>(F1 + 4 * sl, 1, rf + W_X, 1);
  else if (live && sl < 8)
    sc[S_S + sl - 4] = dot<4>(sc + S_HP + 4 * ((sl - 4) >> 1), 1,
                              H + 4 * (sl & 1), 1) +
                       rf[W_R + sl - 4] * r_scale;
  __syncwarp();
  const bool update = live && found;
  // _measurement_update: K = P H^T S^-1, x += K (z - H x), P = (I - K H) P
  if (live && sl < 2) {
    sc[S_HX + sl] = dot<4>(H + 4 * sl, 1, sc + S_XP, 1);
  } else if (update && sl >= 4 && sl < 8) {
    const float* ss = sc + S_S;
    const float det = ss[0] * ss[3] - ss[1] * ss[2];
    const float num = sl == 4   ? ss[3]
                      : sl == 5 ? -ss[1]
                      : sl == 6 ? -ss[2]
                                : ss[0];
    sc[S_SI + sl - 4] = num / det;
  }
  __syncwarp();
  if (update && sl < 8)
    sc[S_K + sl] = sc[S_PHT + 2 * i2] * sc[S_SI + j2] +
                   sc[S_PHT + 2 * i2 + 1] * sc[S_SI + 2 + j2];
  else if (update && sl < 10)
    sc[S_Y + sl - 8] = (sl == 8 ? m0 : m1) - sc[S_HX + sl - 8];
  __syncwarp();
  float x_new = 0.0f;
  if (update) {
    sc[S_FP + sl] =                                         // K H
        sc[S_K + 2 * i4] * H[j4] + sc[S_K + 2 * i4 + 1] * H[4 + j4];
    if (sl < 4) {
      const float ky = sc[S_K + 2 * sl] * sc[S_Y] +
                       sc[S_K + 2 * sl + 1] * sc[S_Y + 1];
      x_new = sc[S_XP + sl] + ky;
    }
  } else if (live && sl < 4) {
    x_new = sc[S_XP + sl];
  }
  __syncwarp();
  float p_new = live ? sc[S_PP + sl] : 0.0f;
  if (update) {                                 // (I - K H) P'
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int at = 4 * i4 + t;
      const float ikh = ((at % 5 == 0) ? 1.0f : 0.0f) - sc[S_FP + at];
      const float term = ikh * sc[S_PP + 4 * t + j4];
      p_new = t == 0 ? term : p_new + term;
    }
  }
  if (sl < 4) sc[S_XP + sl] = x_new;
  // the status rules on the pre-update history and lifetime; the history
  // shifted by one, the newest entry found
  float older[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int j = sl + 16 * h;
    older[h] = j > 0 && j < N_HISTORY ? rf[W_HIST + j - 1] : 0.0f;
  }
  int next = status;
  if (live && sl == 0) {
    float s10 = 0.0f, s20 = 0.0f;
#pragma unroll
    for (int j = 0; j < N_HISTORY; ++j) {
      if (j < 10) s10 = s10 + rf[W_HIST + j];
      s20 = s20 + rf[W_HIST + j];
    }
    const bool old_enough = lifetime > 4;
    if (status == 1)
      next = old_enough && s10 < 6.0f ? 0
                                      : (old_enough && s10 > 8.0f ? 2 : 1);
    else
      next = old_enough && s20 < 4.0f ? 0 : 2;
  }
  __syncwarp();
  if (live) {
    rec[W_P + sl] = __float_as_uint(p_new);
    if (sl < 4) {
      rec[W_X + sl] = __float_as_uint(x_new);
    } else if (sl < 8) {
      rec[W_S + sl - 4] = __float_as_uint(sc[S_S + sl - 4]);
    } else if (sl < 10) {
      const int i = sl - 8;
      rec[W_EST + i] = __float_as_uint(dot<4>(H + 4 * i, 1, sc + S_XP, 1));
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = sl + 16 * h;
      if (j < N_HISTORY)
        rec[W_HIST + j] = __float_as_uint(j == 0 ? (found ? 1.0f : 0.0f)
                                                 : older[h]);
    }
    if (sl == 0) {
      if (found) {
        rec[W_MEAS] = __float_as_uint(m0);
        rec[W_MEAS + 1] = __float_as_uint(m1);
      }
      rec[W_STATUS] = (unsigned)next;
      rec[W_LIFETIME] = (unsigned)(lifetime + 1);
    }
  } else if (fresh_slot) {
    for (int w = sl; w < WORDS; w += 16) rec[w] = fresh[w];
  }
  __syncwarp();
  if (fresh_slot && sl == 0) {
    rec[W_MEAS] = rec[W_EST] = rec[W_X] = __float_as_uint(m0);
    rec[W_MEAS + 1] = rec[W_EST + 1] = rec[W_X + 2] = __float_as_uint(m1);
  }
  __syncwarp();
}

// Dynamic shared memory, in 32-bit words, for K candidates, N slots and
// WPL pool words a lane.
__host__ __device__ inline size_t smem_words(int K, int N, int WPL) {
  const size_t L = 32 * (size_t)WPL;     // words of one candidate mask
  return (size_t)N * WORDS               // the table
         + WORDS                         // the fresh record
         + 5 * (size_t)WORDS             // each record word's leaf: its
                                         // input and output (two words
                                         // each) and its words a slot
         + 2 * (size_t)padded(K)         // candidate ranges and Dopplers
         + (size_t)N * sizeof(Gate) / 2  // the slots' gates, by slot and
                                         // by rank
         + 5 * (size_t)N + 1             // order, status by rank, found,
                                         // measurement a slot; the live
                                         // slots' count
         + L                             // the valid bits
         + 2 * (size_t)N * L             // gate and early masks by rank
         + (size_t)2 * WARPS * SCRATCH;  // the transitions' scratch
}

template <int WPL>
__global__ void __launch_bounds__(THREADS)
tracker_kernel(Leaves lv, const float* __restrict__ cand,
               const unsigned char* __restrict__ valid,
               const unsigned* __restrict__ fresh, int C, int T, int K,
               int N) {
  constexpr int L = 32 * WPL;
  extern __shared__ unsigned smem[];
  unsigned* table = smem;
  unsigned* fresh_s = table + (size_t)N * WORDS;
  const unsigned** src = reinterpret_cast<const unsigned**>(fresh_s + WORDS);
  unsigned** dst = reinterpret_cast<unsigned**>(fresh_s + WORDS) + WORDS;
  int* size = reinterpret_cast<int*>(dst + WORDS);
  float* cr = reinterpret_cast<float*>(size + WORDS);
  float* cd = cr + padded(K);
  Gate* gates = reinterpret_cast<Gate*>(cd + padded(K));
  Gate* rgates = gates + N;                                // by rank
  int* order = reinterpret_cast<int*>(rgates + N);
  int* rstat = order + N;                                  // status by rank
  int* found = rstat + N;
  float* meas = reinterpret_cast<float*>(found + N);       // 2N
  int* tracked = reinterpret_cast<int*>(meas + 2 * N);
  unsigned* vbits = reinterpret_cast<unsigned*>(tracked + 1);
  unsigned* gmask = vbits + L;                             // N L, by rank
  unsigned* emask = gmask + (size_t)N * L;                 // N L, by rank
  float* scratch = reinterpret_cast<float*>(emask + (size_t)N * L);

  const int c = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int words = N * WORDS;
  const size_t slots = (size_t)c * N;      // the channel's first slot

  auto put = [&](int k, float r, float d, bool v) {
    cr[k] = r;
    cd[k] = d;
    if (v) atomicOr(&vbits[(k >> 10) * 32 + (k & 31)], 1u << ((k >> 5) & 31));
  };
  // a frame's candidates: ranges, Dopplers and valid bits
  auto load_candidates = [&](int t) {
    const size_t frame = (size_t)c * T + t;
    const float* fr = cand + frame * 3 * K;
    const unsigned char* fv = valid + frame * K;
    for (int k = tid; k < K; k += THREADS)
      put(k, fr[k], fr[K + k], fv[k] != 0);
  };

  // each record word's leaf, once: where the channel's records start in
  // it (in and out, the offset included) and its words a slot; the fresh
  // record, the candidates' pad, the valid bits and masks zeroed; then the
  // table, the first frame's candidates, each slot's gates and the order
  if (tid < WORDS) {
    int leaf, off, n;
    leaf_of(tid, leaf, off, n);
    size[tid] = n;
    src[tid] = pick(lv.in, leaf) + slots * n + off;
    dst[tid] = pick(lv.out, leaf) + slots * n + off;
    fresh_s[tid] = fresh[tid];
  }
  for (int k = K + tid; k < padded(K); k += THREADS)
    cr[k] = cd[k] = CUDART_INF_F;
  for (int i = tid; i < L + 2 * N * L; i += THREADS) vbits[i] = 0;
  __syncthreads();
  constexpr int BATCH = 8;                 // table words a thread in flight
  for (int i0 = tid; i0 < words; i0 += BATCH * THREADS) {
    unsigned v[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int i = i0 + u * THREADS, w = i % WORDS;
      if (i < words) v[u] = src[w][(i / WORDS) * size[w]];
    }
#pragma unroll
    for (int u = 0; u < BATCH; ++u)
      if (i0 + u * THREADS < words) table[i0 + u * THREADS] = v[u];
  }
  load_candidates(0);
  __syncthreads();
  for (int i = tid; i < N; i += THREADS)
    gates[i] = record_gate(table + (size_t)i * WORDS);
  __syncthreads();
  if (warp == 0) make_order(N, lane, order, rstat, rgates, tracked, gates);
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    // a. every tracked slot's gate and early gate over every candidate,
    // into the zeroed masks (by rank): a warp a (tracked slot, four rows),
    // a lane its candidate of each row
    const int nt = *tracked, tasks = nt * (padded(K) / 128);
    for (int task = warp; task < tasks; task += WARPS) {
      const int n = task % nt, row0 = 4 * (task / nt);
      const int q = row0 >> 5, b0 = row0 & 31;
      const Gate g = rgates[n];
      float r[4], d[4];
      unsigned ew = 0, gw = 0;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int k = 1024 * q + 32 * (b0 + u) + lane;
        r[u] = cr[k];
        d[u] = cd[k];
        ew |= (unsigned)early(g, r[u], d[u]) << (b0 + u);
      }
      if (g.status == 1) {
        gw = ew;
      } else if (__any_sync(FULL, ew != 0)) {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          gw |= (ew >> (b0 + u) & (unsigned)inside(g, r[u], d[u]))
                << (b0 + u);
      }
      if (ew) atomicOr(&emask[n * L + q * 32 + lane], ew);
      if (gw) atomicOr(&gmask[n * L + q * 32 + lane], gw);
    }
    __syncthreads();

    // b. the association chain on warp 0, the next rank's masks loaded
    // while this one runs; gmask keeps each tracked slot's gated set as it
    // stood at its turn
    if (warp == 0) {
      unsigned pool[WPL], g[WPL], e[WPL], gn[WPL], en[WPL];
      auto masks = [&](int n, unsigned (&gq)[WPL], unsigned (&eq)[WPL]) {
#pragma unroll
        for (int q = 0; q < WPL; ++q) {
          gq[q] = gmask[n * L + q * 32 + lane];
          eq[q] = emask[n * L + q * 32 + lane];
        }
      };
#pragma unroll
      for (int q = 0; q < WPL; ++q) {
        pool[q] = vbits[q * 32 + lane];
        vbits[q * 32 + lane] = 0;
      }
      int st = rstat[0], s = order[0];
      masks(0, g, e);
      for (int n = 0; n < N; ++n) {
        const int nn = n + 1 < N ? n + 1 : n;
        const int stn = rstat[nn], sn = order[nn];
        masks(nn, gn, en);
        bool hit;
        if (st != 0) {
          bool any = false;
#pragma unroll
          for (int q = 0; q < WPL; ++q) {
            g[q] &= pool[q];
            any |= g[q] != 0;
          }
          hit = __any_sync(FULL, any);
#pragma unroll
          for (int q = 0; q < WPL; ++q) {
            if (hit) pool[q] &= ~e[q];
            gmask[n * L + q * 32 + lane] = g[q];
          }
        } else {
          int count = 0;
#pragma unroll
          for (int q = 0; q < WPL; ++q) count += __popc(pool[q]);
          count = __reduce_add_sync(FULL, count);
          hit = count > 0;
          if (hit) {
            const unsigned choice = __reduce_min_sync(FULL,
                                                      first_of(pool, lane));
            const float m0 = cr[choice], m1 = cd[choice];
#pragma unroll
            for (int q = 0; q < WPL; ++q) {
              unsigned drop = count > 1 ? 0u : FULL;
              for (unsigned live = count > 1 ? pool[q] : 0u; live;
                   live &= live - 1) {
                const int b = __ffs(live) - 1, k = 1024 * q + 32 * b + lane;
                if (fabsf(cr[k] - m0) < 10.0f && fabsf(cd[k] - m1) < 12.0f)
                  drop |= 1u << b;
              }
              pool[q] &= ~drop;
            }
            if (lane == 0) {
              meas[2 * s] = m0;
              meas[2 * s + 1] = m1;
            }
          }
        }
        if (lane == 0) found[s] = hit;
        st = stn;
        s = sn;
#pragma unroll
        for (int q = 0; q < WPL; ++q) {
          g[q] = gn[q];
          e[q] = en[q];
        }
      }
    }
    __syncthreads();

    // c. each tracked slot's choice from its gated set: the first, or the
    // nearest to the origin (distance, then index, as argmin)
    for (int n = warp; n < N && rstat[n] != 0; n += WARPS) {
      const int s = order[n];
      if (!found[s]) continue;                   // the whole warp
      unsigned g[WPL];
#pragma unroll
      for (int q = 0; q < WPL; ++q) g[q] = gmask[n * L + q * 32 + lane];
      unsigned choice;
      if (rstat[n] == 2) {
        choice = __reduce_min_sync(FULL, first_of(g, lane));
      } else {
        float best = CUDART_INF_F;
        unsigned at = NONE;
#pragma unroll
        for (int q = 0; q < WPL; ++q)
          for (unsigned bits = g[q]; bits; bits &= bits - 1) {
            const unsigned k = 1024u * q + 32u * (__ffs(bits) - 1) + lane;
            const float r = cr[k], d = cd[k];
            const float dist = sqrtf(r * r + d * d);
            if (dist < best) {
              best = dist;
              at = k;
            }
          }
        const unsigned key = __float_as_uint(best);
        const unsigned least = __reduce_min_sync(FULL, key);
        choice = __reduce_min_sync(FULL, key == least ? at : NONE);
        if (choice == NONE) choice = 0;   // no finite distance: argmin's 0
      }
      if (lane == 0) {
        meas[2 * s] = cr[choice];
        meas[2 * s + 1] = cd[choice];
      }
    }
    __syncthreads();

    // d. the transitions, two slots a warp, and the next frame's gates, the
    // masks zeroed for it; then the frame's table out, the next frame's
    // candidates in and its order
    for (int i0 = 2 * warp; i0 < N; i0 += 2 * WARPS) {
      const int i = i0 + (lane >> 4), sl = lane & 15;
      const bool here = i < N;
      unsigned* rec = table + (size_t)(here ? i : i0) * WORDS;
      const bool hit = here && found[i] != 0;
      const int status = here ? (int)rec[W_STATUS] : 0;
      transition(rec, here ? meas[2 * i] : 0.0f,
                 here ? meas[2 * i + 1] : 0.0f, hit, here && status != 0,
                 hit && status == 0, fresh_s,
                 scratch + (2 * warp + (lane >> 4)) * SCRATCH, sl);
      if (here && sl == 0) gates[i] = record_gate(rec);
    }
    for (int i = tid; i < 2 * N * L; i += THREADS) gmask[i] = 0;
    __syncthreads();
    const size_t frame_slots = (size_t)t * C * N;
    for (int i = tid; i < words; i += THREADS) {
      const int w = i % WORDS;
      dst[w][(frame_slots + i / WORDS) * size[w]] = table[i];
    }
    if (t + 1 < T) {
      load_candidates(t + 1);
      if (warp == 0)
        make_order(N, lane, order, rstat, rgates, tracked, gates);
    }
    __syncthreads();
  }
}

using Kernel = void (*)(Leaves, const float*, const unsigned char*,
                        const unsigned*, int, int, int, int);
const Kernel KERNELS[VARIANTS] = {tracker_kernel<1>, tracker_kernel<2>,
                                  tracker_kernel<4>, tracker_kernel<8>,
                                  tracker_kernel<16>, tracker_kernel<32>};

// The kernel for K candidates: the fewest pool words a lane, 2^v.
int variant(int K) {
  int v = 0;
  while (K > 1024 << v) ++v;
  return v;
}

// The largest dynamic shared memory a block may opt into, once per device.
int optin_bytes[MAX_DEVICES];

}  // namespace

extern "C" {

// in: the 13 leaves of a (C, N, ...) table, out: those of a (T, C, N, ...)
// history, in the order of the record above (status and lifetime int32,
// the rest float32, all contiguous); cand (C, T, 3, K) float32, valid
// (C, T, K) bool, fresh the 110 words of a fresh track's record; all on
// card `device`, which the call makes current for the launch and then
// restores. K may be at most 32768, and K and N only as large as the
// card's shared memory holds (tracker_smem_bytes). Launches
// on `stream`, does not synchronise, and returns the first CUDA error that
// is not 0 (cudaErrorInvalidValue for sizes it does not take).
int tracker_launch(const void* const* in, void* const* out,
                   const float* cand, const unsigned char* valid,
                   const unsigned* fresh, int C, int T, int K, int N,
                   int device, void* stream) {
  if (C < 1 || T < 1 || K < 1 || K > 1024 << (VARIANTS - 1) || N < 1 ||
      device < 0 || device >= MAX_DEVICES)
    return (int)cudaErrorInvalidValue;
  int current;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int v = variant(K);
  const size_t bytes = smem_words(K, N, 1 << v) * 4;
  if (optin_bytes[device] == 0) {
    int most = 0;
    err = cudaDeviceGetAttribute(
        &most, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    for (int i = 0; i < VARIANTS && err == cudaSuccess; ++i)
      err = cudaFuncSetAttribute(KERNELS[i],
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 most);
    if (err == cudaSuccess) optin_bytes[device] = most;
  }
  if (err == cudaSuccess && bytes > (size_t)optin_bytes[device])
    err = cudaErrorInvalidValue;
  if (err == cudaSuccess) {
    Leaves lv;
    for (int l = 0; l < N_LEAVES; ++l) {
      lv.in[l] = static_cast<const unsigned*>(in[l]);
      lv.out[l] = static_cast<unsigned*>(out[l]);
    }
    KERNELS[v]<<<C, THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
        lv, cand, valid, fresh, C, T, K, N);
    err = cudaGetLastError();
  }
  if (current != device) {
    const cudaError_t back = cudaSetDevice(current);
    if (err == cudaSuccess) err = back;
  }
  return (int)err;
}

// The dynamic shared memory, in bytes, that a launch for K candidates and N
// slots asks for (a channel's table, its gates and masks, a frame's
// candidates), or -1 for a K or N that no launch takes. tracker_launch
// refuses a launch that asks for more than the card's opt-in limit.
long long tracker_smem_bytes(int K, int N) {
  if (K < 1 || K > 1024 << (VARIANTS - 1) || N < 1) return -1;
  return (long long)smem_words(K, N, 1 << variant(K)) * 4;
}

// The card's opt-in limit of dynamic shared memory a block, in bytes, or
// minus the CUDA error.
int tracker_smem_optin(int device) {
  int most = 0;
  const cudaError_t err = cudaDeviceGetAttribute(
      &most, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return err == cudaSuccess ? most : -(int)err;
}

const char* tracker_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
