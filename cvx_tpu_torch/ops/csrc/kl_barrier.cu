// K3: the batched primal log-barrier KL solve on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of cvx_tpu/ops/pallas_kl.py:
//   K3  kl_barrier_fused_{f32,f64}  <- _kl_fused_kernel  (pallas_call :295)
// The plain PyTorch version of the same algebra is kl_barrier_fused_plain
// in ../kl_barrier.py; the comments there and in the reference explain the
// Woodbury/Schur solve, the closed-form step bound and the no-step guard.
//
// What bounds it on this card.  Per instance and Newton step the work is
// five passes over the n coordinates, each ending in reductions that the
// next pass needs: the margins and f0; the Woodbury sums; the Schur sums;
// q, H dx and the step bound; the line-search candidates (two sums and one
// log each per coordinate).  At the bench shape (10k instances, n = 100,
// 21 steps) x0 and x are 8 MB (2.4 us at 3.35 TB/s), and the arithmetic is
// some 70 operations per coordinate and step plus 8 per candidate, the
// candidates averaging under 3 per step (about 2 G operations, 0.03 ms at
// the f32 peak): operations bound it, not bytes, and in practice the
// latency of the dependent chain of passes and reductions.
//
// Two paths, chosen in the C launcher (launch_k3; ../kl_barrier.py's
// path_of mirrors it).
//
// Register (kl_barrier_kernel, n <= kRegMaxN).  One warp per instance:
// every reduction is a register butterfly (__shfl_xor_sync) with no shared
// memory and no barrier, and every lane then holds the per-instance
// scalars, so no broadcast is needed and every branch on them is
// warp-uniform.  Four warps per block.  Each lane owns the coordinates i =
// lane + 32 c, NC of them, and keeps their state (x, log x, g, 1/h, H^-1 g,
// H^-1 a, dx) in registers.  The rows Hs and A are re-read from global
// memory (L1 / L2) in each pass.
//
// Group (kl_barrier_group_kernel, n > kRegMaxN).  What bounded the old
// one-warp loop there: one warp's serial walk over n / 32 coordinates, at
// 100 x n = 10,000 on 25 of 132 SMs, each coordinate a round trip to six
// rows in L2.  Design: one instance per group of G warps, G the least
// power of two with 32 G kGroupNC >= n, or with B G >= kGroupFillWarps
// (the card is full) and 32 G kGroupFullNC >= n, at most kGroupMaxWarps;
// thread t of a group owns the coordinates i = t + 32 G c.  Between passes
// a thread keeps x, log x, dx and pass 2's g and 1/h (H^-1 g and H^-1 a
// are computed again where needed): in registers while it owns at most
// kGroupNC coordinates, else in shared memory where a block's fit
// (kGroupSmemBytes), else in a row of global memory that only the
// instance's block touches.  A pass's sums are reduced by a butterfly in
// each warp, then, for G > 1, through shared memory with one __syncthreads
// (two buffers, alternating): lane w of every warp reads warp w's sums and
// a second butterfly adds them, so every thread of the group holds the
// same totals and every branch is uniform over the block; a group of G > 1
// has its block to itself, so its line search may run as many candidates
// as its own data needs.  An f32 thread that owns more than kGroupNC
// coordinates adds them kGroupNC at a time and compensates the block sums
// (Sums), so no sum runs more than kGroupNC rounded adds in a row.
//
// The line search does only the candidates the data needs.  The TPU
// evaluated all n_ls of them as one tensor and kept the longest accepted;
// here a step whose result is known is skipped (q < -eps fails, or no
// candidate is positive), and the candidates, non-increasing whenever
// beta^expo is (each warp reads them once, before its first step), are
// tried in order until one is accepted: that one is the longest.  Its x is
// the next x by the same expression, so its logs and its two sums are the
// next step's log x and f0 sums, and pass 1 takes no log after a step (the
// register path keeps the candidate's logs in registers; the group path
// writes them over log x, and takes the logs again in pass 1 after a step
// that accepted no candidate or not the last one it evaluated).  Every
// decision is the same bits as evaluating all candidates: each candidate's
// sums keep the per-thread order and the reductions.
//
// Numerics follow the reference: IEEE log/div (no fast math, no flush to
// zero), NaN-propagating min like jnp.minimum, and the same order of
// operations per coordinate (built with --fmad=false).  The kernel works
// out the continuation schedule itself from the scalars t0, mu and beta
// (Schedule): the per-stage t, the candidates' beta^expo and log n, with
// the functions PyTorch's CUDA exp, log and pow call, in the plain
// version's order, so the values are _schedule's bits and a launch waits
// on no tensor the host made for it.  Each block writes t and beta^expo
// once into the front of its dynamic shared memory (fill_schedule), and
// the steps read them there: a table at a fixed address holds no register
// through the step loop (the values held in registers instead made the
// register path 4-5 % slower on the H100, the step loop working out
// addresses again that it had kept).  Sums over the
// coordinates are reduced in a tree, which need not pair the partial sums
// as the plain version's row sums do, so late Armijo decisions at f32
// resolution may differ from it (on the bench family at n = 100 they have
// not: max |dx| 0); the kernel is held to the plain version by a tolerance.
//
// Interface: plain C, pointers and element strides; the lane axis of Hs,
// A and x0 is contiguous, their batch strides are free (0 for a shared,
// expanded matrix).  scratch is (B, 4, n), read only when the group path
// keeps its coordinates in global memory (path_of's "global").  t0, mu and
// beta are doubles, rounded to T in the kernel as torch.full rounds them;
// the table of n_outer + n_ls values must fit in a block's shared memory.
// kl_barrier_schedule_{f32,f64} write the table and log n, for the tests.
// Each entry launches on the given stream and returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cfloat>
#include <cmath>

namespace {

constexpr int kWarpsPerBlock = 4;  // register path: instances per block
constexpr int kThreads = kWarpsPerBlock * 32;
// line-search candidates per pass over the coordinates: 1 beat 2 and 4 at
// the bench shape (fewer registers, and most searches stop at the first)
constexpr int kLsChunk = 1;
constexpr int kRegMaxN = 256;      // _REG_MAX_N in ../kl_barrier.py
// group path: G is the least power of two with 32 G kGroupNC >= n, or with
// B G >= kGroupFillWarps (the card is full) and 32 G kGroupFullNC >= n, at
// most kGroupMaxWarps; one-warp groups sit kGroupBlockWarps to a block, a
// wider group has a block of its own.  A thread owns c = ceil(n / 32 G)
// coordinates and keeps their x, log x, dx, g and 1/h in registers for c
// <= kGroupNC, else in shared memory if the block's kGroupRows n values fit
// in kGroupSmemBytes (the card's 227 KB less the reduction buffers), else
// in global memory.  Mirrored by ../kl_barrier.py's _GROUP_* and path_of.
constexpr int kGroupNC = 8;
constexpr int kGroupFullNC = 16;
constexpr int kGroupFillWarps = 4096;
constexpr int kGroupMaxWarps = 16;
constexpr int kGroupBlockWarps = 4;
constexpr int kGroupRows = 5;      // x, log x, dx, g, 1/h
constexpr int kRedMax = 8;         // most values a pass reduces
constexpr int kGroupSmemBytes = 232448 - 2 * kGroupMaxWarps * kRedMax * 8;
constexpr int kSmemMax = 232448;   // shared memory a block may use
constexpr unsigned kFull = 0xffffffffu;

template <typename T> struct Lim;
template <> struct Lim<float> {
  static __device__ __forceinline__ float eps() { return FLT_EPSILON; }
};
template <> struct Lim<double> {
  static __device__ __forceinline__ double eps() { return DBL_EPSILON; }
};

__device__ __forceinline__ float klog(float v) { return logf(v); }
__device__ __forceinline__ double klog(double v) { return log(v); }
__device__ __forceinline__ float kexp(float v) { return expf(v); }
__device__ __forceinline__ double kexp(double v) { return exp(v); }
__device__ __forceinline__ float kpow(float a, float b) { return powf(a, b); }
__device__ __forceinline__ double kpow(double a, double b) {
  return pow(a, b);
}
__device__ __forceinline__ float kabs(float v) { return fabsf(v); }
__device__ __forceinline__ double kabs(double v) { return fabs(v); }

// jnp.minimum: a NaN in either argument gives NaN
template <typename T> __device__ __forceinline__ T jmin(T a, T b) {
  return (a < b || a != a) ? a : b;
}

// The continuation schedule's scalars, as the caller gives them
struct ScheduleArgs {
  double t0, mu, beta;
};

// The schedule in T, the values ../kl_barrier.py's _schedule makes with
// torch's CUDA ops (which call expf / logf / powf and their f64 forms), in
// its order: t = T(t0) exp(T(s) log T(mu)) at stage s, candidate l's factor
// beta^expo with expo = l below 32 and 32 + 3 (l - 32) from there, and
// log n.
template <typename T> struct Schedule {
  T t0, log_mu, beta;
  __device__ __forceinline__ explicit Schedule(ScheduleArgs a)
      : t0(T(a.t0)), log_mu(klog(T(a.mu))), beta(T(a.beta)) {}
  __device__ __forceinline__ T t(int s) const {
    return t0 * kexp(T(s) * log_mu);
  }
  __device__ __forceinline__ T factor(int l) const {
    return kpow(beta, T(l < 32 ? l : 32 + 3 * (l - 32)));
  }
};
template <typename T> __device__ __forceinline__ T log_n(int n) {
  return klog(T(n));
}

// Bytes of the schedule's table at the front of a block's dynamic shared
// memory: the n_ls factors, then t for each of the n_outer stages
template <typename T>
__host__ __device__ inline int schedule_bytes(int n_outer, int n_ls) {
  return ((n_outer + n_ls) * (int)sizeof(T) + 15) / 16 * 16;
}

// The block's threads write the table (every thread of the block, before
// any leaves); returns the factors, t per stage follows them
template <typename T>
__device__ __forceinline__ const T* fill_schedule(ScheduleArgs sa,
                                                  int n_outer, int n_ls) {
  extern __shared__ __align__(16) unsigned char kl_smem[];
  T* tab = reinterpret_cast<T*>(kl_smem);
  const Schedule<T> sch(sa);
  for (int l = threadIdx.x; l < n_ls; l += blockDim.x) tab[l] = sch.factor(l);
  for (int s = threadIdx.x; s < n_outer; s += blockDim.x)
    tab[n_ls + s] = sch.t(s);
  __syncthreads();
  return tab;
}

// butterfly all-reduce: every lane ends with the same bits
template <typename T> __device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = v + __shfl_xor_sync(kFull, v, o);
  return v;
}
template <typename T> __device__ __forceinline__ T warp_min(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = jmin(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// ------------------------------------------------------- register path
template <typename T, int K, int NC>
__global__ void __launch_bounds__(kThreads)
kl_barrier_kernel(const T* __restrict__ H, const T* __restrict__ u,
                  const T* __restrict__ A, const T* __restrict__ bv,
                  const T* __restrict__ x0, long long sHb, long long sHk,
                  long long sub, long long suk, long long sAb, long long sbb,
                  long long sxb, ScheduleArgs sa, T* __restrict__ xout,
                  int B, int n, int n_outer, int n_inner, int n_ls, T delta,
                  T alpha) {
  const int b = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  const T* ls_ts = fill_schedule<T>(sa, n_outer, n_ls);
  const T* ts = ls_ts + n_ls;
  if (b >= B) return;
  // the same trip count on every lane; coordinates i >= n are skipped
  constexpr int nc = NC;
  const T* Hb = H + b * sHb;
  const T* a0 = A + b * sAb;
  T ub[K];
#pragma unroll
  for (int j = 0; j < K; ++j) ub[j] = u[b * sub + j * suk];
  const T bb = bv[b * sbb];
  const T eps = Lim<T>::eps();
  const T lognv = log_n<T>(n);

  T x[NC], lx[NC], g[NC], ih[NC], hig[NC], hia[NC], dx[NC];
#pragma unroll
  for (int c = 0; c < nc; ++c) {
    const int i = lane + 32 * c;
    if (i < n) x[c] = x0[b * sxb + i];
  }

  // The candidates' factors beta^expo, read once a warp: when they do not
  // increase, neither do the candidates s_max beta^expo for s_max > 0, so
  // the first accepted candidate is the longest and the search stops
  // there; when none is negative, a non-positive (or NaN) s_max has no
  // positive candidate and the search is skipped.
  bool desc = true, neg = false;
  for (int l = lane; l < n_ls; l += 32) {
    const T f = ls_ts[l];
    neg = neg || f < T(0);
    if (l + 1 < n_ls) desc = desc && ls_ts[l + 1] <= f;
  }
  const bool ls_desc = __all_sync(kFull, desc);
  const bool ls_neg = __any_sync(kFull, neg);

  // f0's two coordinate sums for the current x, valid with lx = log x;
  // an accepted candidate hands over its own (the same bits: its xs is the
  // next x, computed by the same expression, summed in the same order)
  T sum_xl = T(0), sum_l = T(0);
  bool have_logs = false;

  for (int step = 0; step < n_outer * n_inner; ++step) {
    const T t = ts[step / n_inner];

    // pass 1: margins d_j = u_j - rows_j . x, a0 . x, and f0's sums
    T hx[K], ax = T(0), sxl = T(0), sl = T(0);
#pragma unroll
    for (int j = 0; j < K; ++j) hx[j] = T(0);
#pragma unroll
    for (int c = 0; c < nc; ++c) {
      const int i = lane + 32 * c;
      if (i >= n) continue;
      const T xi = x[c];
#pragma unroll
      for (int j = 0; j < K; ++j) hx[j] += Hb[j * sHk + i] * xi;
      ax += a0[i] * xi;
      if (!have_logs) {
        const T l = klog(xi);
        lx[c] = l;
        sxl += xi * (lognv + l);
        sl += l;
      }
    }
    T ds[K], inv_ds[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      ds[j] = ub[j] - warp_sum(hx[j]);
      inv_ds[j] = T(1) / ds[j];
    }
    ax = warp_sum(ax);
    if (!have_logs) {
      sum_xl = warp_sum(sxl);
      sum_l = warp_sum(sl);
      have_logs = true;
    }
    T f0 = t * sum_xl - sum_l;
#pragma unroll
    for (int j = 0; j < K; ++j) f0 = f0 - klog(ds[j]);

    // pass 2: gradient, 1/h and the Woodbury sums
    const T one_l = T(1) + lognv;
    T m00p = T(0), m11p = T(0), m01p = T(0), sg[K], sa[K];
#pragma unroll
    for (int j = 0; j < K; ++j) sg[j] = sa[j] = T(0);
#pragma unroll
    for (int c = 0; c < nc; ++c) {
      const int i = lane + 32 * c;
      if (i >= n) continue;
      const T xi = x[c];
      T gi = t * (one_l + lx[c]) - T(1) / xi;
      T row[K];
#pragma unroll
      for (int j = 0; j < K; ++j) {
        row[j] = Hb[j * sHk + i];
        gi = gi + row[j] * inv_ds[j];
      }
      const T hi = t / xi + T(1) / (xi * xi);
      const T ihi = T(1) / hi;
      g[c] = gi;
      ih[c] = ihi;
      const T ai = a0[i];
      const T ud0 = row[0] * ihi;
      m00p += ud0 * row[0];
      sg[0] += ud0 * gi;
      sa[0] += ud0 * ai;
      if constexpr (K == 2) {
        const T ud1 = row[1] * ihi;
        m11p += ud1 * row[1];
        m01p += ud0 * row[1];
        sg[1] += ud1 * gi;
        sa[1] += ud1 * ai;
      }
    }
    // the k x k inverse, closed form (the shifts differ for k = 1 and 2)
    T i00, i01 = T(0), i11 = T(0);
    if constexpr (K == 2) {
      T m00 = warp_sum(m00p) + ds[0] * ds[0];
      T m11 = warp_sum(m11p) + ds[1] * ds[1];
      const T m01 = warp_sum(m01p);
      const T sc = T(0.5) * (kabs(m00) + kabs(m11));
      m00 = m00 + delta * sc;
      m11 = m11 + delta * sc;
      const T det = m00 * m11 - m01 * m01;
      i00 = m11 / det;
      i01 = -m01 / det;
      i11 = m00 / det;
    } else {
      T m00 = warp_sum(m00p) + ds[0] * ds[0];
      m00 = m00 * (T(1) + delta);
      i00 = T(1) / m00;
    }
    T yg[K], ya[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      sg[j] = warp_sum(sg[j]);
      sa[j] = warp_sum(sa[j]);
    }
    if constexpr (K == 2) {
      yg[0] = i00 * sg[0] + i01 * sg[1];
      yg[1] = i01 * sg[0] + i11 * sg[1];
      ya[0] = i00 * sa[0] + i01 * sa[1];
      ya[1] = i01 * sa[0] + i11 * sa[1];
    } else {
      yg[0] = i00 * sg[0];
      ya[0] = i00 * sa[0];
    }

    // pass 3: H^-1 g, H^-1 a and the p = 1 Schur sums
    T S = T(0), ahg = T(0);
#pragma unroll
    for (int c = 0; c < nc; ++c) {
      const int i = lane + 32 * c;
      if (i >= n) continue;
      const T ihi = ih[c];
      const T ai = a0[i];
      T vg = g[c] * ihi, va = ai * ihi;
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const T ud = Hb[j * sHk + i] * ihi;
        vg = vg - ud * yg[j];
        va = va - ud * ya[j];
      }
      hig[c] = vg;
      hia[c] = va;
      S += ai * va;
      ahg += ai * vg;
    }
    S = warp_sum(S);
    const T wv = -((bb - ax) + warp_sum(ahg)) / S;

    // pass 4: dx, q = dx . g, rows . dx and the largest feasible step
    T q = T(0), udx[K], sx = T(INFINITY);
#pragma unroll
    for (int j = 0; j < K; ++j) udx[j] = T(0);
#pragma unroll
    for (int c = 0; c < nc; ++c) {
      const int i = lane + 32 * c;
      if (i >= n) continue;
      const T d = -(hig[c] + hia[c] * wv);
      dx[c] = d;
      q += d * g[c];
#pragma unroll
      for (int j = 0; j < K; ++j) udx[j] += Hb[j * sHk + i] * d;
      sx = jmin(sx, d < T(0) ? -x[c] / d : T(INFINITY));
    }
    q = warp_sum(q);
    T s_max = jmin(warp_min(sx), T(1.0 / 0.99));
#pragma unroll
    for (int j = 0; j < K; ++j) {
      udx[j] = warp_sum(udx[j]);
      s_max = jmin(s_max, udx[j] > T(0) ? ds[j] / udx[j] : T(INFINITY));
    }
    s_max = T(0.99) * s_max;

    // pass 5: the longest candidate s_max beta^expo that keeps every
    // margin positive and passes Armijo, kLsChunk candidates per pass over
    // the coordinates.  A failed q < -eps gate, or no positive candidate,
    // gives no step whatever the candidates would: skip them.  Every lane
    // holds the same sums, so each exit below is warp-uniform.
    T s_best = T(0);
    bool handed_over = false;     // the accepted candidate's logs and sums
    if (q < -eps && (s_max > T(0) || ls_neg)) {
      const bool first_wins = ls_desc && s_max > T(0);
      bool done = false;
      for (int l0 = 0; l0 < n_ls && !done; l0 += kLsChunk) {
        T ss[kLsChunk], a1[kLsChunk], a2[kLsChunk];
        T lc[kLsChunk][NC];       // their logs
        bool okx[kLsChunk];
#pragma unroll
        for (int l = 0; l < kLsChunk; ++l) {
          ss[l] = l0 + l < n_ls ? s_max * ls_ts[l0 + l] : T(0);
          a1[l] = a2[l] = T(0);
          okx[l] = true;
        }
#pragma unroll
        for (int c = 0; c < nc; ++c) {
          const int i = lane + 32 * c;
          if (i >= n) continue;
          const T xi = x[c], di = dx[c];
#pragma unroll
          for (int l = 0; l < kLsChunk; ++l) {
            const T xs = xi + ss[l] * di;
            okx[l] = okx[l] && xs > T(0);
            const T lxs = klog(xs > T(0) ? xs : T(1));
            lc[l][c] = lxs;
            a1[l] += xs * (lognv + lxs);
            a2[l] += lxs;
          }
        }
#pragma unroll
        for (int l = 0; l < kLsChunk; ++l) {
          if (done || l0 + l >= n_ls || !__all_sync(kFull, okx[l])) continue;
          const T s1 = warp_sum(a1[l]), s2 = warp_sum(a2[l]);
          T fs = t * s1 - s2;
          bool ok = true;
#pragma unroll
          for (int j = 0; j < K; ++j) {
            const T dsj = ds[j] - ss[l] * udx[j];
            ok = ok && dsj > T(0);
            fs = fs - klog(dsj > T(0) ? dsj : T(1));
          }
          const bool armijo = fs <= f0 + alpha * ss[l] * q;
          if (!(ok && armijo && ss[l] > s_best)) continue;
          s_best = ss[l];
          done = first_wins;
          if (done) {
#pragma unroll
            for (int c = 0; c < nc; ++c)
              if (lane + 32 * c < n) lx[c] = lc[l][c];
            sum_xl = s1;
            sum_l = s2;
            handed_over = true;
          }
        }
      }
    }
    // no-step guard: a non-finite dx never reaches x (0 * NaN = NaN)
    if (s_best > T(0)) {
#pragma unroll
      for (int c = 0; c < nc; ++c) {
        const int i = lane + 32 * c;
        if (i < n) x[c] = x[c] + s_best * dx[c];
      }
      have_logs = handed_over;
    }
  }
  T* xb = xout + (long long)b * n;
#pragma unroll
  for (int c = 0; c < nc; ++c) {
    const int i = lane + 32 * c;
    if (i < n) xb[i] = x[c];
  }
}

// ---------------------------------------------------------- group path
// A thread's E running sums over its coordinates.  BLOCKED (an f32 thread
// that owns more than kGroupNC coordinates) adds kGroupNC coordinates'
// terms at a time into block sums, and those into compensated totals
// (Kahan; --fmad=false and no fast math keep the compiler from folding it
// away): no sum then runs more than kGroupNC rounded adds in a row, as
// kl_dual.cu's group path bounds its lanes' chains, for one compensated
// add per kGroupNC terms (compensating every term ran 10,000 x n = 300
// 13 % slower on the H100).  start(c) comes first in the body of the loop
// over a thread's coordinates c.
template <typename T, int E, bool BLOCKED> struct Sums {
  T b[E], s[E], k[E];
  __device__ __forceinline__ Sums() {
#pragma unroll
    for (int e = 0; e < E; ++e) b[e] = s[e] = k[e] = T(0);
  }
  __device__ __forceinline__ void add(int e, T v) { b[e] += v; }
  __device__ __forceinline__ void flush() {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const T y = b[e] - k[e];
      const T t = s[e] + y;
      k[e] = (t - s[e]) - y;
      s[e] = t;
      b[e] = T(0);
    }
  }
  __device__ __forceinline__ void start(int c) {
    if constexpr (BLOCKED) {
      if (c > 0 && c % kGroupNC == 0) flush();
    }
  }
  template <int N>
  __device__ __forceinline__ void totals(T (&v)[N]) {
    static_assert(N >= E, "totals");
    if constexpr (BLOCKED) flush();
#pragma unroll
    for (int e = 0; e < E; ++e) v[e] = BLOCKED ? s[e] - k[e] : b[e];
  }
};

// A thread's coordinates i = t + S c of one vector: in registers (NC > 0)
// or at stride S in a row of shared or global memory (NC == 0).
template <typename T, int NC> struct Coords {
  T r[NC];
  __device__ __forceinline__ void bind(T*, int) {}
  __device__ __forceinline__ T& operator[](int c) { return r[c]; }
};
template <typename T> struct Coords<T, 0> {
  T* p;
  int s;
  __device__ __forceinline__ void bind(T* row, int stride) {
    p = row;
    s = stride;
  }
  __device__ __forceinline__ T& operator[](int c) { return p[s * c]; }
};

// A thread's place in its group, and the block's reduction buffers
template <typename T> struct Grp {
  int lane, warp, G;
  T* red;       // 2 buffers of kGroupMaxWarps x kRedMax
  int par;
};

// Totals over the group of v[0, E) (sums) and v[E, E + M) (minimums), the
// same bits in every thread: a butterfly in each warp, then for G > 1 each
// warp's lane 0 writes its warp's values, one __syncthreads, and lane w of
// every warp reads warp w's and a second butterfly combines them.  The
// buffers alternate, so a warp that runs ahead into the next reduction
// writes where no warp still reads.
template <int E, int M, typename T>
__device__ __forceinline__ void group_total(Grp<T>& g, T (&v)[E + M]) {
  static_assert(E + M <= kRedMax, "kRedMax");
#pragma unroll
  for (int e = 0; e < E + M; ++e)
    v[e] = e < E ? warp_sum(v[e]) : warp_min(v[e]);
  if (g.G == 1) return;
  T* r = g.red + g.par * (kGroupMaxWarps * kRedMax);
  g.par ^= 1;
  if (g.lane == 0) {
#pragma unroll
    for (int e = 0; e < E + M; ++e) r[g.warp * kRedMax + e] = v[e];
  }
  __syncthreads();
#pragma unroll
  for (int e = 0; e < E + M; ++e) {
    const T w = g.lane < g.G ? r[g.lane * kRedMax + e]
                             : (e < E ? T(0) : T(INFINITY));
    v[e] = e < E ? warp_sum(w) : warp_min(w);
  }
}

// Where a thread keeps its coordinates' state: in registers (NC > 0), in
// dynamic shared memory, or x in xout and the others in scratch (B, 4, n);
// a compile-time value, so that shared memory is addressed as such
enum Where { kRegisters, kShared, kGlobal };

template <typename T, int K, int NC, Where W>
__global__ void __launch_bounds__(32 * kGroupMaxWarps)
kl_barrier_group_kernel(const T* __restrict__ H, const T* __restrict__ u,
                        const T* __restrict__ A, const T* __restrict__ bv,
                        const T* __restrict__ x0, long long sHb,
                        long long sHk, long long sub, long long suk,
                        long long sAb, long long sbb, long long sxb,
                        ScheduleArgs sa, T* __restrict__ xout,
                        T* __restrict__ scratch, int B, int n, int n_outer,
                        int n_inner, int n_ls, T delta, T alpha, int G) {
  constexpr bool BLK = sizeof(T) == sizeof(float) && NC == 0;
  __shared__ T red[2 * kGroupMaxWarps * kRedMax];
  extern __shared__ __align__(16) unsigned char kl_smem[];
  const int wblk = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int per = G == 1 ? kGroupBlockWarps : 1;
  const int gi = wblk / G;
  const int b = blockIdx.x * per + gi;
  const T* ls_ts = fill_schedule<T>(sa, n_outer, n_ls);
  const T* ts = ls_ts + n_ls;
  // only one-warp groups run past B, and they use no block barrier after
  // this point
  if (b >= B) return;
  Grp<T> g{lane, wblk % G, G, red, 0};
  const int S = 32 * G;
  const int t0 = 32 * g.warp + lane;
  // the same trip count on every thread; coordinates i >= n are skipped
  const int nc = NC > 0 ? NC : (n + S - 1) / S;
  const T* Hb = H + b * sHb;
  const T* a0 = A + b * sAb;
  T ub[K];
#pragma unroll
  for (int j = 0; j < K; ++j) ub[j] = u[b * sub + j * suk];
  const T bb = bv[b * sbb];
  const T eps = Lim<T>::eps();
  const T lognv = log_n<T>(n);

  // x, log x, dx, and pass 2's g and 1/h for passes 3 and 4
  Coords<T, NC> x, lx, dx, gk, ihk;
  if constexpr (NC == 0) {
    T* row;
    if constexpr (W == kShared) {
      row = reinterpret_cast<T*>(kl_smem + schedule_bytes<T>(n_outer, n_ls)) +
            (long long)gi * kGroupRows * n + t0;
      x.bind(row, S);
      row += n;
    } else {
      row = scratch + (long long)b * (kGroupRows - 1) * n + t0;
      x.bind(xout + (long long)b * n + t0, S);
    }
    lx.bind(row, S);
    dx.bind(row + n, S);
    gk.bind(row + 2 * n, S);
    ihk.bind(row + 3 * n, S);
  }
#pragma unroll
  for (int c = 0; c < nc; ++c) {
    const int i = t0 + S * c;
    if (i < n) x[c] = x0[b * sxb + i];
  }

  // the candidates' factors, as the register path reads them
  bool desc = true, neg = false;
  for (int l = lane; l < n_ls; l += 32) {
    const T f = ls_ts[l];
    neg = neg || f < T(0);
    if (l + 1 < n_ls) desc = desc && ls_ts[l + 1] <= f;
  }
  const bool ls_desc = __all_sync(kFull, desc);
  const bool ls_neg = __any_sync(kFull, neg);

  T sum_xl = T(0), sum_l = T(0);
  bool have_logs = false;
  const T one_l = T(1) + lognv;

  for (int step = 0; step < n_outer * n_inner; ++step) {
    const T t = ts[step / n_inner];

    // pass 1: margins, a0 . x, and (after a step without hand-over) the
    // logs and f0's sums
    T v1[K + 3];      // rows . x, a0 . x, x . (log n + log x), sum log x
    {
      Sums<T, K + 3, BLK> ps;
#pragma unroll
      for (int c = 0; c < nc; ++c) {
        ps.start(c);
        const int i = t0 + S * c;
        if (i >= n) continue;
        const T xi = x[c];
#pragma unroll
        for (int j = 0; j < K; ++j) ps.add(j, Hb[j * sHk + i] * xi);
        ps.add(K, a0[i] * xi);
        if (!have_logs) {
          const T l = klog(xi);
          lx[c] = l;
          ps.add(K + 1, xi * (lognv + l));
          ps.add(K + 2, l);
        }
      }
      ps.totals(v1);
    }
    group_total<K + 3, 0>(g, v1);
    T ds[K], inv_ds[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      ds[j] = ub[j] - v1[j];
      inv_ds[j] = T(1) / ds[j];
    }
    const T ax = v1[K];
    if (!have_logs) {
      sum_xl = v1[K + 1];
      sum_l = v1[K + 2];
      have_logs = true;
    }
    T f0 = t * sum_xl - sum_l;
#pragma unroll
    for (int j = 0; j < K; ++j) f0 = f0 - klog(ds[j]);

    // pass 2: the Woodbury sums (rows/h . rows, . g and . a)
    constexpr int E2 = K == 2 ? 7 : 3;
    T v2[E2];         // m00, rows/h . g, rows/h . a, m11, m01
    {
      Sums<T, E2, BLK> ps;
#pragma unroll
      for (int c = 0; c < nc; ++c) {
        ps.start(c);
        const int i = t0 + S * c;
        if (i >= n) continue;
        const T xi = x[c];
        T gi = t * (one_l + lx[c]) - T(1) / xi;
        T row[K];
#pragma unroll
        for (int j = 0; j < K; ++j) {
          row[j] = Hb[j * sHk + i];
          gi = gi + row[j] * inv_ds[j];
        }
        const T hi = t / xi + T(1) / (xi * xi);
        const T ihi = T(1) / hi;
        gk[c] = gi;
        ihk[c] = ihi;
        const T ai = a0[i];
        const T ud0 = row[0] * ihi;
        ps.add(0, ud0 * row[0]);
        ps.add(1, ud0 * gi);
        ps.add(1 + K, ud0 * ai);
        if constexpr (K == 2) {
          const T ud1 = row[1] * ihi;
          ps.add(5, ud1 * row[1]);
          ps.add(6, ud0 * row[1]);
          ps.add(2, ud1 * gi);
          ps.add(4, ud1 * ai);
        }
      }
      ps.totals(v2);
    }
    group_total<E2, 0>(g, v2);
    T i00, i01 = T(0), i11 = T(0);
    if constexpr (K == 2) {
      T m00 = v2[0] + ds[0] * ds[0];
      T m11 = v2[5] + ds[1] * ds[1];
      const T m01 = v2[6];
      const T sc = T(0.5) * (kabs(m00) + kabs(m11));
      m00 = m00 + delta * sc;
      m11 = m11 + delta * sc;
      const T det = m00 * m11 - m01 * m01;
      i00 = m11 / det;
      i01 = -m01 / det;
      i11 = m00 / det;
    } else {
      T m00 = v2[0] + ds[0] * ds[0];
      m00 = m00 * (T(1) + delta);
      i00 = T(1) / m00;
    }
    T yg[K], ya[K];
    if constexpr (K == 2) {
      yg[0] = i00 * v2[1] + i01 * v2[2];
      yg[1] = i01 * v2[1] + i11 * v2[2];
      ya[0] = i00 * v2[3] + i01 * v2[4];
      ya[1] = i01 * v2[3] + i11 * v2[4];
    } else {
      yg[0] = i00 * v2[1];
      ya[0] = i00 * v2[2];
    }

    // pass 3: the p = 1 Schur sums a . H^-1 a and a . H^-1 g
    T v3[2];
    {
      Sums<T, 2, BLK> ps;
#pragma unroll
      for (int c = 0; c < nc; ++c) {
        ps.start(c);
        const int i = t0 + S * c;
        if (i >= n) continue;
        const T ihi = ihk[c], ai = a0[i];
        T vg = gk[c] * ihi, va = ai * ihi;
#pragma unroll
        for (int j = 0; j < K; ++j) {
          const T ud = Hb[j * sHk + i] * ihi;
          vg = vg - ud * yg[j];
          va = va - ud * ya[j];
        }
        ps.add(0, ai * va);
        ps.add(1, ai * vg);
      }
      ps.totals(v3);
    }
    group_total<2, 0>(g, v3);
    const T wv = -((bb - ax) + v3[1]) / v3[0];

    // pass 4: dx (kept), q = dx . g, rows . dx and the largest feasible
    // step
    T v4[K + 2];      // q, rows . dx, the least step to a bound x_i = 0
    {
      Sums<T, K + 1, BLK> ps;
      T sx = T(INFINITY);
#pragma unroll
      for (int c = 0; c < nc; ++c) {
        ps.start(c);
        const int i = t0 + S * c;
        if (i >= n) continue;
        const T xi = x[c];
        T row[K];
#pragma unroll
        for (int j = 0; j < K; ++j) row[j] = Hb[j * sHk + i];
        const T gi = gk[c], ihi = ihk[c], ai = a0[i];
        T vg = gi * ihi, va = ai * ihi;
#pragma unroll
        for (int j = 0; j < K; ++j) {
          const T ud = row[j] * ihi;
          vg = vg - ud * yg[j];
          va = va - ud * ya[j];
        }
        const T d = -(vg + va * wv);
        dx[c] = d;
        ps.add(0, d * gi);
#pragma unroll
        for (int j = 0; j < K; ++j) ps.add(1 + j, row[j] * d);
        sx = jmin(sx, d < T(0) ? -xi / d : T(INFINITY));
      }
      ps.totals(v4);
      v4[K + 1] = sx;
    }
    group_total<K + 1, 1>(g, v4);
    const T q = v4[0];
    T s_max = jmin(v4[K + 1], T(1.0 / 0.99));
    T udx[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      udx[j] = v4[1 + j];
      s_max = jmin(s_max, udx[j] > T(0) ? ds[j] / udx[j] : T(INFINITY));
    }
    s_max = T(0.99) * s_max;

    // pass 5: the candidates in order, one a pass, each writing its logs
    // over log x; every thread holds the same totals, so each exit is
    // uniform over the block
    T s_best = T(0);
    bool handed_over = false, lx_spent = false;
    if (q < -eps && (s_max > T(0) || ls_neg)) {
      const bool first_wins = ls_desc && s_max > T(0);
      bool done = false;
      for (int l = 0; l < n_ls && !done; ++l) {
        const T ss = s_max * ls_ts[l];
        T v5[3];      // the candidate's two f0 sums, and x_i <= 0 seen
        {
          Sums<T, 2, BLK> ps;
          T bad = T(0);
#pragma unroll
          for (int c = 0; c < nc; ++c) {
            ps.start(c);
            const int i = t0 + S * c;
            if (i >= n) continue;
            const T xs = x[c] + ss * dx[c];
            if (!(xs > T(0))) bad = T(1);
            const T lxs = klog(xs > T(0) ? xs : T(1));
            lx[c] = lxs;
            ps.add(0, xs * (lognv + lxs));
            ps.add(1, lxs);
          }
          ps.totals(v5);
          v5[2] = bad;
        }
        lx_spent = true;
        group_total<3, 0>(g, v5);
        if (v5[2] > T(0)) continue;       // a coordinate would leave x > 0
        T fs = t * v5[0] - v5[1];
        bool ok = true;
#pragma unroll
        for (int j = 0; j < K; ++j) {
          const T dsj = ds[j] - ss * udx[j];
          ok = ok && dsj > T(0);
          fs = fs - klog(dsj > T(0) ? dsj : T(1));
        }
        const bool armijo = fs <= f0 + alpha * ss * q;
        if (!(ok && armijo && ss > s_best)) continue;
        s_best = ss;
        done = first_wins;
        if (done) {        // the last candidate evaluated: its logs stand
          sum_xl = v5[0];
          sum_l = v5[1];
          handed_over = true;
        }
      }
    }
    // no-step guard: a non-finite dx never reaches x (0 * NaN = NaN)
    if (s_best > T(0)) {
#pragma unroll
      for (int c = 0; c < nc; ++c) {
        const int i = t0 + S * c;
        if (i < n) x[c] = x[c] + s_best * dx[c];
      }
      have_logs = handed_over;
    } else if (lx_spent) {
      have_logs = false;
    }
  }
  if constexpr (W != kGlobal) {
    T* xb = xout + (long long)b * n;
#pragma unroll
    for (int c = 0; c < nc; ++c) {
      const int i = t0 + S * c;
      if (i < n) xb[i] = x[c];
    }
  }
}

// G for the group path (n > kRegMaxN)
inline int group_warps(int n, int B) {
  int G = 1;
  while (G < kGroupMaxWarps && 32 * G * kGroupNC < n &&
         ((long long)B * G < kGroupFillWarps || 32 * G * kGroupFullNC < n))
    G *= 2;
  return G;
}

#define KL_K3_ARGS                                                         \
  H, u, A, bv, x0, sHb, sHk, sub, suk, sAb, sbb, sxb, sa, x, B, n, n_outer, \
      n_inner, n_ls, delta, alpha
#define KL_K3_GROUP_ARGS                                                   \
  H, u, A, bv, x0, sHb, sHk, sub, suk, sAb, sbb, sxb, sa, x, scratch, B, n, \
      n_outer, n_inner, n_ls, delta, alpha, G

// Launches kernel with `smem` bytes of dynamic shared memory, raising the
// kernel's limit first where it is above the default
template <typename F, typename... A>
void launch_smem(F kernel, int blocks, int threads, long long smem,
                 cudaStream_t st, A... args) {
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  kernel<<<blocks, threads, (size_t)smem, st>>>(args...);
}

template <typename T, int K>
void launch_k(const T* H, const T* u, const T* A, const T* bv, const T* x0,
              long long sHb, long long sHk, long long sub, long long suk,
              long long sAb, long long sbb, long long sxb, ScheduleArgs sa,
              T* x, T* scratch, int B, int n, int n_outer, int n_inner,
              int n_ls, T delta, T alpha, cudaStream_t st) {
  const int tab = schedule_bytes<T>(n_outer, n_ls);
  if (n <= kRegMaxN) {
    const int blocks = (B + kWarpsPerBlock - 1) / kWarpsPerBlock;
    if (n <= 4 * 32)
      launch_smem(kl_barrier_kernel<T, K, 4>, blocks, kThreads, tab, st,
                  KL_K3_ARGS);
    else
      launch_smem(kl_barrier_kernel<T, K, kRegMaxN / 32>, blocks, kThreads,
                  tab, st, KL_K3_ARGS);
    return;
  }
  const int G = group_warps(n, B);
  const int per = G == 1 ? kGroupBlockWarps : 1;
  const int blocks = (B + per - 1) / per;
  const int threads = 32 * G * per;
  const int c = (n + 32 * G - 1) / (32 * G);
  if (c <= kGroupNC) {
    launch_smem(kl_barrier_group_kernel<T, K, kGroupNC, kRegisters>, blocks,
                threads, tab, st, KL_K3_GROUP_ARGS);
  } else {
    // the rows follow the schedule's table; where both do not fit beside
    // the reduction buffers, the rows go to global memory
    const long long smem =
        (long long)per * kGroupRows * n * (long long)sizeof(T);
    if (smem <= kGroupSmemBytes &&
        smem + tab + 2 * kGroupMaxWarps * kRedMax * (long long)sizeof(T) <=
            kSmemMax) {
      launch_smem(kl_barrier_group_kernel<T, K, 0, kShared>, blocks, threads,
                  smem + tab, st, KL_K3_GROUP_ARGS);
    } else {
      launch_smem(kl_barrier_group_kernel<T, K, 0, kGlobal>, blocks, threads,
                  tab, st, KL_K3_GROUP_ARGS);
    }
  }
}
#undef KL_K3_ARGS
#undef KL_K3_GROUP_ARGS

// The schedule's table fits in a block's shared memory beside a group's
// reduction buffers
template <typename T> bool schedule_fits(int n_outer, int n_ls) {
  return (long long)(n_outer + n_ls) * (long long)sizeof(T) + 16 +
             2 * kGroupMaxWarps * kRedMax * (long long)sizeof(T) <=
         kSmemMax;
}

template <typename T>
int launch_k3(const void* H, const void* u, const void* A, const void* bv,
              const void* x0, long long sHb, long long sHk, long long sub,
              long long suk, long long sAb, long long sbb, long long sxb,
              void* x, void* scratch, int B, int n, int k, int n_outer,
              int n_inner, int n_ls, double t0, double mu, double beta,
              double delta, double alpha, void* stream) {
  if (B < 1 || n < 1 || n_outer < 0 || n_inner < 0 || n_ls < 1 ||
      !schedule_fits<T>(n_outer, n_ls))
    return cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const ScheduleArgs sa{t0, mu, beta};
  if (k == 1)
    launch_k<T, 1>((const T*)H, (const T*)u, (const T*)A, (const T*)bv,
                   (const T*)x0, sHb, sHk, sub, suk, sAb, sbb, sxb, sa,
                   (T*)x, (T*)scratch, B, n, n_outer, n_inner, n_ls,
                   T(delta), T(alpha), st);
  else if (k == 2)
    launch_k<T, 2>((const T*)H, (const T*)u, (const T*)A, (const T*)bv,
                   (const T*)x0, sHb, sHk, sub, suk, sAb, sbb, sxb, sa,
                   (T*)x, (T*)scratch, B, n, n_outer, n_inner, n_ls,
                   T(delta), T(alpha), st);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

// The table K3 works out, written to out: the n_ls candidates' factors,
// t for each of the n_outer stages, then log n
template <typename T>
__global__ void kl_barrier_schedule_kernel(T* __restrict__ out, int n,
                                           int n_outer, int n_ls,
                                           ScheduleArgs sa) {
  const T* tab = fill_schedule<T>(sa, n_outer, n_ls);
  for (int i = threadIdx.x; i < n_outer + n_ls; i += blockDim.x)
    out[i] = tab[i];
  if (threadIdx.x == 0) out[n_outer + n_ls] = log_n<T>(n);
}

template <typename T>
int launch_schedule(void* out, int n, int n_outer, int n_ls, double t0,
                    double mu, double beta, void* stream) {
  if (n < 1 || n_outer < 0 || n_ls < 1 ||
      !schedule_fits<T>(n_outer, n_ls))
    return cudaErrorInvalidValue;
  launch_smem(kl_barrier_schedule_kernel<T>, 1, 32,
              schedule_bytes<T>(n_outer, n_ls), (cudaStream_t)stream, (T*)out,
              n, n_outer, n_ls, ScheduleArgs{t0, mu, beta});
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int kl_barrier_fused_f32(const void* H, const void* u, const void* A,
                         const void* bv, const void* x0, long long sHb,
                         long long sHk, long long sub, long long suk,
                         long long sAb, long long sbb, long long sxb,
                         void* x, void* scratch, int B, int n, int k,
                         int n_outer, int n_inner, int n_ls, double t0,
                         double mu, double beta, double delta, double alpha,
                         void* stream) {
  return launch_k3<float>(H, u, A, bv, x0, sHb, sHk, sub, suk, sAb, sbb, sxb,
                          x, scratch, B, n, k, n_outer, n_inner, n_ls, t0,
                          mu, beta, delta, alpha, stream);
}

int kl_barrier_fused_f64(const void* H, const void* u, const void* A,
                         const void* bv, const void* x0, long long sHb,
                         long long sHk, long long sub, long long suk,
                         long long sAb, long long sbb, long long sxb,
                         void* x, void* scratch, int B, int n, int k,
                         int n_outer, int n_inner, int n_ls, double t0,
                         double mu, double beta, double delta, double alpha,
                         void* stream) {
  return launch_k3<double>(H, u, A, bv, x0, sHb, sHk, sub, suk, sAb, sbb,
                           sxb, x, scratch, B, n, k, n_outer, n_inner, n_ls,
                           t0, mu, beta, delta, alpha, stream);
}

int kl_barrier_schedule_f32(void* out, int n, int n_outer, int n_ls,
                            double t0, double mu, double beta, void* stream) {
  return launch_schedule<float>(out, n, n_outer, n_ls, t0, mu, beta, stream);
}

int kl_barrier_schedule_f64(void* out, int n, int n_outer, int n_ls,
                            double t0, double mu, double beta, void* stream) {
  return launch_schedule<double>(out, n, n_outer, n_ls, t0, mu, beta,
                                 stream);
}

const char* kl_barrier_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
