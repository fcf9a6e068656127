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
// A slot's association reads only its own state from before the frame, so
// step 2 is the only dependent chain; step 3 runs a thread a slot.
//
// Design: one CTA of 256 threads a channel. The channel's table (N records
// of 110 32-bit words, the leaves in the wrapper's order) stays in shared
// memory for the whole launch, with a frame's candidate ranges, Dopplers
// and pool. A slot is one pass over the candidates (gate, count, first
// gated index, (distance, index) minimum), one warp-shuffle reduction and
// one barrier, then a second pass that updates the pool, and a barrier.
// The gate arithmetic is the plain version's, operation for operation
// (built with -fmad=false, so no product is contracted into an FMA): equal
// inputs give equal gate decisions. The Kalman products follow the plain
// version's index order; its matrix products may round otherwise, so the
// float leaves agree within the tests' tolerances.
//
// What bounds it: not the card's rates. A launch moves C*T*(2K floats + K
// bytes) of candidates and (T+1)*C*N*440 bytes of table: at the wideband
// shape (C = 8, K = 384, N = 10, T = 1) 98 KB, 29 ns at 3.35 TB/s. Its time
// is the dependent chain: N slots a frame, each two passes, a reduction
// and two barriers, then one thread's Kalman algebra, T times over.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int N_LEAVES = 13;
constexpr int MAX_DEVICES = 64;
constexpr unsigned FULL = 0xffffffffu;

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

// The leaf of word w of a record, its offset there and its words a slot.
__device__ __forceinline__ void leaf_of(int w, int& leaf, int& off,
                                        int& words) {
  const int sizes[N_LEAVES] = {1, 1, 2, 2, N_HISTORY, 4, 16, 16, 16, 16,
                               8, 4, 4};
  int start = 0;
#pragma unroll
  for (int l = 0; l < N_LEAVES; ++l) {
    if (w >= start && w < start + sizes[l]) {
      leaf = l;
      off = w - start;
      words = sizes[l];
    }
    start += sizes[l];
  }
}

__device__ __forceinline__ float word_f(const unsigned* rec, int w) {
  return __uint_as_float(rec[w]);
}

// The candidate gates of one slot, as _associate forms them.
struct Gate {
  int status;
  float lm0, lm1, le0, le1, i00, i01, i10, i11;

  __device__ explicit Gate(const unsigned* rec) {
    status = (int)rec[W_STATUS];
    lm0 = word_f(rec, W_MEAS);
    lm1 = word_f(rec, W_MEAS + 1);
    le0 = word_f(rec, W_EST);
    le1 = word_f(rec, W_EST + 1);
    // S^-1 as _inv2: the adjugate, each entry over the determinant
    const float s00 = word_f(rec, W_S), s01 = word_f(rec, W_S + 1),
                s10 = word_f(rec, W_S + 2), s11 = word_f(rec, W_S + 3);
    const float det = s00 * s11 - s01 * s10;
    i00 = s11 / det;
    i01 = -s01 / det;
    i10 = -s10 / det;
    i11 = s00 / det;
  }

  __device__ bool early(float r, float d) const {
    if (status == 0) return true;
    if (status == 1) return fabsf(r - lm0) < 5.0f && fabsf(d - lm1) < 24.0f;
    return fabsf(r - le0) < 4.0f && fabsf(d - le1) < 20.0f;
  }

  __device__ bool gated(float r, float d, bool avail) const {
    const bool pool = early(r, d) && avail;
    if (status != 2) return pool;
    const float zr = lm0 - r, zd = lm1 - d;
    const float m2 = zr * (i00 * zr + i01 * zd) + zd * (i10 * zr + i11 * zd);
    return pool && m2 < 6.0f;
  }
};

// (d, i) < (bd, bi), lexicographically: argmin's first minimum.
__device__ __forceinline__ bool before(float d, int i, float bd, int bi) {
  return d < bd || (d == bd && i < bi);
}

// c = a (m x k) @ b (k x n), row-major, sums in index order.
template <int M, int K, int N>
__device__ __forceinline__ void matmul(const float* a, const float* b,
                                       float* c) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) {
      float s = a[i * K] * b[j];
#pragma unroll
      for (int k = 1; k < K; ++k) s = s + a[i * K + k] * b[k * N + j];
      c[i * N + j] = s;
    }
}

// b = a^T for a (m x n).
template <int M, int N>
__device__ __forceinline__ void transpose(const float* a, float* b) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) b[j * M + i] = a[i * N + j];
}

template <int N>
__device__ __forceinline__ void load(const unsigned* rec, int w, float* v) {
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = word_f(rec, w + i);
}

template <int N>
__device__ __forceinline__ void store(unsigned* rec, int w, const float* v) {
#pragma unroll
  for (int i = 0; i < N; ++i) rec[w + i] = __float_as_uint(v[i]);
}

// One slot's transition (_track_transition), in place on its record.
__device__ void transition(unsigned* rec, float m0, float m1, bool found,
                           const unsigned* __restrict__ fresh) {
  const int status = (int)rec[W_STATUS];
  if (status == 0) {
    if (!found) return;
    for (int w = 0; w < WORDS; ++w) rec[w] = fresh[w];
    rec[W_MEAS] = rec[W_EST] = rec[W_X] = __float_as_uint(m0);
    rec[W_MEAS + 1] = rec[W_EST + 1] = rec[W_X + 2] = __float_as_uint(m1);
    return;
  }

  // status rules on the pre-update history and lifetime
  const int lifetime = (int)rec[W_LIFETIME];
  float s10 = 0.0f, s20 = 0.0f;
  for (int j = 0; j < N_HISTORY; ++j) {
    if (j < 10) s10 = s10 + word_f(rec, W_HIST + j);
    s20 = s20 + word_f(rec, W_HIST + j);
  }
  const bool old_enough = lifetime > 4;
  int next = status;
  if (status == 1)
    next = old_enough && s10 < 6.0f ? 0 : (old_enough && s10 > 8.0f ? 2 : 1);
  else if (status == 2)
    next = old_enough && s20 < 4.0f ? 0 : 2;

  // _advance: x by F1, P by F2, S with R scaled by |meas - last meas|^2
  // (by 1 when extrapolating)
  float x[4], p[16], f1[16], f2[16], f2t[16], q[16], h[8], ht[8], r[4];
  load<4>(rec, W_X, x);
  load<16>(rec, W_P, p);
  load<16>(rec, W_F1, f1);
  load<16>(rec, W_F2, f2);
  load<16>(rec, W_Q, q);
  load<8>(rec, W_H, h);
  load<4>(rec, W_R, r);
  transpose<4, 4>(f2, f2t);
  transpose<2, 4>(h, ht);
  const float lm0 = word_f(rec, W_MEAS), lm1 = word_f(rec, W_MEAS + 1);
  float r_scale = 1.0f;
  if (found) {
    const float d0 = m0 - lm0, d1 = m1 - lm1;
    r_scale = d0 * d0 + d1 * d1;
  }
  float xp[4], fp[16], pp[16], hp[8], s[4];
  matmul<4, 4, 1>(f1, x, xp);
  matmul<4, 4, 4>(f2, p, fp);
  matmul<4, 4, 4>(fp, f2t, pp);
#pragma unroll
  for (int i = 0; i < 16; ++i) pp[i] = pp[i] + q[i];
  matmul<2, 4, 4>(h, pp, hp);
  matmul<2, 4, 2>(hp, ht, s);
#pragma unroll
  for (int i = 0; i < 4; ++i) s[i] = s[i] + r[i] * r_scale;

  float est[2];
  if (found) {
    // _measurement_update: K = P H^T S^-1, x += K (z - H x), P = (I - K H) P
    float pht[8], sinv[4], k[8], hx[2], y[2], kh[16], ikh[16], p2[16];
    const float det = s[0] * s[3] - s[1] * s[2];
    sinv[0] = s[3] / det;
    sinv[1] = -s[1] / det;
    sinv[2] = -s[2] / det;
    sinv[3] = s[0] / det;
    matmul<4, 4, 2>(pp, ht, pht);
    matmul<4, 2, 2>(pht, sinv, k);
    matmul<2, 4, 1>(h, xp, hx);
    y[0] = m0 - hx[0];
    y[1] = m1 - hx[1];
    float ky[4];
    matmul<4, 2, 1>(k, y, ky);
#pragma unroll
    for (int i = 0; i < 4; ++i) xp[i] = xp[i] + ky[i];
    matmul<4, 2, 4>(k, h, kh);
#pragma unroll
    for (int i = 0; i < 16; ++i)
      ikh[i] = ((i % 5 == 0) ? 1.0f : 0.0f) - kh[i];
    matmul<4, 4, 4>(ikh, pp, p2);
#pragma unroll
    for (int i = 0; i < 16; ++i) pp[i] = p2[i];
    rec[W_MEAS] = __float_as_uint(m0);
    rec[W_MEAS + 1] = __float_as_uint(m1);
  }
  matmul<2, 4, 1>(h, xp, est);
  store<2>(rec, W_EST, est);
  store<4>(rec, W_X, xp);
  store<16>(rec, W_P, pp);
  store<4>(rec, W_S, s);
  for (int j = N_HISTORY - 1; j > 0; --j)
    rec[W_HIST + j] = rec[W_HIST + j - 1];
  rec[W_HIST] = __float_as_uint(found ? 1.0f : 0.0f);
  rec[W_STATUS] = (unsigned)next;
  rec[W_LIFETIME] = (unsigned)(lifetime + 1);
}

// Dynamic shared memory, in 32-bit words, then the pool's K bytes.
__host__ __device__ inline size_t smem_words(int K, int N) {
  return (size_t)N * WORDS   // the table
         + 2 * (size_t)K     // candidate ranges and Dopplers
         + 4 * (size_t)N     // measurement, found and order a slot
         + 4 * WARPS;        // the reduction's warp partials
}

__host__ inline size_t smem_bytes(int K, int N) {
  return smem_words(K, N) * 4 + (size_t)K;
}

__global__ void __launch_bounds__(THREADS)
tracker_kernel(Leaves lv, const float* __restrict__ cand,
               const unsigned char* __restrict__ valid,
               const unsigned* __restrict__ fresh, int C, int T, int K,
               int N) {
  extern __shared__ unsigned smem[];
  unsigned* table = smem;
  float* cr = reinterpret_cast<float*>(table + (size_t)N * WORDS);
  float* cd = cr + K;
  float* meas = cd + K;                                   // 2N
  int* found = reinterpret_cast<int*>(meas + 2 * N);      // N
  int* order = found + N;                                 // N
  int* part_count = order + N;                            // WARPS each
  int* part_first = part_count + WARPS;
  float* part_dist = reinterpret_cast<float*>(part_first + WARPS);
  int* part_near = reinterpret_cast<int*>(part_dist + WARPS);
  unsigned char* avail = reinterpret_cast<unsigned char*>(part_near + WARPS);

  const int c = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int i = tid; i < N * WORDS; i += THREADS) {
    const int slot = i / WORDS;
    int leaf = 0, off = 0, words = 1;
    leaf_of(i % WORDS, leaf, off, words);
    table[i] = lv.in[leaf][((size_t)c * N + slot) * words + off];
  }

  for (int t = 0; t < T; ++t) {
    const size_t frame = (size_t)c * T + t;
    const float* fr = cand + frame * 3 * K;
    const unsigned char* fv = valid + frame * K;
    for (int k = tid; k < K; k += THREADS) {
      cr[k] = fr[k];
      cd[k] = fr[K + k];
      avail[k] = fv[k];
    }
    if (tid == 0) {
      int n = 0;
      for (int prio = 0; prio < 3; ++prio)
        for (int i = 0; i < N; ++i) {
          const int st = (int)table[i * WORDS + W_STATUS];
          if ((st == 2 ? 0 : (st == 1 ? 1 : 2)) == prio) order[n++] = i;
        }
    }
    __syncthreads();

    for (int s = 0; s < N; ++s) {
      const int i = order[s];
      const Gate g(table + (size_t)i * WORDS);

      // pass 1: count, first gated index, nearest gated (distance, index)
      int count = 0, first = K;
      float near_d = CUDART_INF_F;
      int near_i = K;
      for (int k = tid; k < K; k += THREADS) {
        const float r = cr[k], d = cd[k];
        const bool in = g.gated(r, d, avail[k] != 0);
        const float dist = in ? sqrtf(r * r + d * d) : CUDART_INF_F;
        count += in;
        if (in && k < first) first = k;
        if (before(dist, k, near_d, near_i)) {
          near_d = dist;
          near_i = k;
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        count += __shfl_xor_sync(FULL, count, o);
        first = min(first, __shfl_xor_sync(FULL, first, o));
        const float od = __shfl_xor_sync(FULL, near_d, o);
        const int oi = __shfl_xor_sync(FULL, near_i, o);
        if (before(od, oi, near_d, near_i)) {
          near_d = od;
          near_i = oi;
        }
      }
      if (lane == 0) {
        part_count[warp] = count;
        part_first[warp] = first;
        part_dist[warp] = near_d;
        part_near[warp] = near_i;
      }
      __syncthreads();
      count = 0;
      first = K;
      near_d = CUDART_INF_F;
      near_i = K;
      for (int w = 0; w < WARPS; ++w) {
        count += part_count[w];
        first = min(first, part_first[w]);
        if (before(part_dist[w], part_near[w], near_d, near_i)) {
          near_d = part_dist[w];
          near_i = part_near[w];
        }
      }
      const bool hit = count > 0;
      float m0 = 0.0f, m1 = 0.0f;
      if (hit) {
        const int choice = g.status == 1 ? near_i : first;
        m0 = cr[choice];
        m1 = cd[choice];
        // pass 2: the pool gives up what this slot consumed
        for (int k = tid; k < K; k += THREADS) {
          const float r = cr[k], d = cd[k];
          bool removal;
          if (g.status == 0)
            removal = count > 1
                          ? fabsf(r - m0) < 10.0f && fabsf(d - m1) < 12.0f
                          : true;
          else
            removal = g.early(r, d);
          if (removal) avail[k] = 0;
        }
      }
      if (tid == 0) {
        meas[2 * i] = m0;
        meas[2 * i + 1] = m1;
        found[i] = hit;
      }
      __syncthreads();
    }

    for (int i = tid; i < N; i += THREADS)
      transition(table + (size_t)i * WORDS, meas[2 * i], meas[2 * i + 1],
                 found[i] != 0, fresh);
    __syncthreads();

    for (int i = tid; i < N * WORDS; i += THREADS) {
      const int slot = i / WORDS;
      int leaf = 0, off = 0, words = 1;
      leaf_of(i % WORDS, leaf, off, words);
      lv.out[leaf][(((size_t)t * C + c) * N + slot) * words + off] = table[i];
    }
  }
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
// restores. Launches on `stream`, does not synchronise, and returns the
// first CUDA error that is not 0 (cudaErrorInvalidValue for sizes it does
// not take).
int tracker_launch(const void* const* in, void* const* out,
                   const float* cand, const unsigned char* valid,
                   const unsigned* fresh, int C, int T, int K, int N,
                   int device, void* stream) {
  if (C < 1 || T < 1 || K < 1 || N < 1 || device < 0 ||
      device >= MAX_DEVICES)
    return (int)cudaErrorInvalidValue;
  int current;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t bytes = smem_bytes(K, N);
  if (optin_bytes[device] == 0) {
    int most = 0;
    err = cudaDeviceGetAttribute(
        &most, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(tracker_kernel,
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
    tracker_kernel<<<C, THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
        lv, cand, valid, fresh, C, T, K, N);
    err = cudaGetLastError();
  }
  if (current != device) {
    const cudaError_t back = cudaSetDevice(current);
    if (err == cudaSuccess) err = back;
  }
  return (int)err;
}

const char* tracker_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
