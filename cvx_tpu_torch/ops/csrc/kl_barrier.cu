// K3: the batched primal log-barrier KL solve on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of cvx_tpu/ops/pallas_kl.py:
//   K3  kl_barrier_fused_{f32,f64}  <- _kl_fused_kernel  (pallas_call :295)
// The plain PyTorch version of the same algebra is kl_barrier_fused_plain
// in ../kl_barrier.py; the comments there and in the reference explain the
// Woodbury/Schur solve, the closed-form step bound and the no-step guard.
//
// What bounds it on this card.  Per instance and Newton step the work is
// five passes over the n coordinates, each ending in warp reductions that
// the next pass needs: the margins and f0; the Woodbury sums; the Schur
// sums; q, H dx and the step bound; the line-search candidates (two sums
// and one log each per coordinate).  At the bench shape (10k instances,
// n = 100, 21 steps) x0 and x are 8 MB (2.4 us at 3.35 TB/s), and the
// arithmetic is some 70 operations per coordinate and step plus 8 per
// candidate, the candidates averaging under 3 per step (about 2 G
// operations, 0.03 ms at the f32 peak): operations bound it, not bytes,
// and in practice the latency of the dependent chain of passes and
// reductions.
//
// What the design does about it.  One warp per instance: every reduction
// is a register butterfly (__shfl_xor_sync) with no shared memory and no
// barrier, and every lane then holds the per-instance scalars, so no
// broadcast is needed and every branch on them is warp-uniform.  Four
// warps per block.  Each lane owns the coordinates i = lane + 32 c.  Up to
// n = kRegMaxN their state (x, log x, g, 1/h, H^-1 g, H^-1 a, dx) stays in
// registers, NC per lane; above it the same state lives in a per-instance
// scratch row of global memory (L2), read and written only by the lane
// that owns the coordinate.  The rows Hs and A are re-read from global
// memory in each pass.  K (1 or 2 rows) and NC are template parameters,
// so the small algebra and the coordinate loops unroll.
//
// The line search does only the candidates the data needs.  The TPU
// evaluated all n_ls of them as one tensor and kept the longest accepted;
// here a step whose result is known is skipped (q < -eps fails, or no
// candidate is positive), and the candidates, non-increasing whenever
// beta^expo is (each warp reads them once, before its first step), are
// tried kLsChunk at a time in order until one is accepted: that one is the
// longest.  Its x is the next x by the same expression, so its logs and
// its two sums are the next step's log x and f0 sums, and pass 1 takes no
// log after a step (in registers only; the scratch path recomputes them).
// Every decision is the same bits as evaluating all candidates: each
// candidate's sums keep the per-lane order and the butterfly.
//
// Numerics follow the reference: IEEE log/div (no fast math, no flush to
// zero), NaN-propagating min like jnp.minimum, and the same order of
// operations per coordinate (built with --fmad=false).  The per-stage t,
// the candidates' beta^expo and log n come from the wrapper as device
// arrays, computed by the same PyTorch ops as the plain version, so no
// value is read back to the host before the launch.  Sums over the
// coordinates are reduced by a warp butterfly, which need not pair the
// partial sums as the plain version's row sums do, so late Armijo decisions
// at f32 resolution may differ from it (on the bench family they have not:
// max |dx| 0); the kernel is held to the plain version by a tolerance.
//
// Interface: plain C, pointers and element strides; the lane axis of Hs,
// A and x0 is contiguous, their batch strides are free (0 for a shared,
// expanded matrix).  Each entry launches on the given stream and returns
// cudaGetLastError().

#include <cuda_runtime.h>

#include <cfloat>
#include <cmath>

namespace {

constexpr int kWarpsPerBlock = 4;  // instances per block
constexpr int kThreads = kWarpsPerBlock * 32;
// line-search candidates per pass over the coordinates: 1 beat 2 and 4 at
// the bench shape (fewer registers, and most searches stop at the first)
constexpr int kLsChunk = 1;
constexpr int kRegMaxN = 256;      // _REG_MAX_N in ../kl_barrier.py
constexpr int kScratchRows = 6;    // log x, g, 1/h, H^-1 g, H^-1 a, dx
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
__device__ __forceinline__ float kabs(float v) { return fabsf(v); }
__device__ __forceinline__ double kabs(double v) { return fabs(v); }

// jnp.minimum: a NaN in either argument gives NaN
template <typename T> __device__ __forceinline__ T jmin(T a, T b) {
  return (a < b || a != a) ? a : b;
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

// A lane's coordinates i = lane + 32 c of one per-coordinate vector: in
// registers (NC > 0) or in a scratch row of global memory (NC == 0).
template <typename T, int NC> struct Lanes {
  T r[NC];
  __device__ __forceinline__ void bind(T*) {}
  __device__ __forceinline__ T& operator[](int c) { return r[c]; }
};
template <typename T> struct Lanes<T, 0> {
  T* p;
  __device__ __forceinline__ void bind(T* row) { p = row; }
  __device__ __forceinline__ T& operator[](int c) { return p[32 * c]; }
};

template <typename T, int K, int NC>
__global__ void __launch_bounds__(kThreads)
kl_barrier_kernel(const T* __restrict__ H, const T* __restrict__ u,
                  const T* __restrict__ A, const T* __restrict__ bv,
                  const T* __restrict__ x0, long long sHb, long long sHk,
                  long long sub, long long suk, long long sAb, long long sbb,
                  long long sxb, const T* __restrict__ ts,
                  const T* __restrict__ ls_ts, T* __restrict__ xout,
                  T* __restrict__ scratch, int B, int n, int n_outer,
                  int n_inner, int n_ls, const T* __restrict__ lognv_p,
                  T delta, T alpha) {
  const int b = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (b >= B) return;
  // the same trip count on every lane; coordinates i >= n are skipped
  const int nc = NC > 0 ? NC : (n + 31) / 32;
  const T* Hb = H + b * sHb;
  const T* a0 = A + b * sAb;
  T ub[K];
#pragma unroll
  for (int j = 0; j < K; ++j) ub[j] = u[b * sub + j * suk];
  const T bb = bv[b * sbb];
  const T eps = Lim<T>::eps();
  const T lognv = *lognv_p;

  Lanes<T, NC> x, lx, g, ih, hig, hia, dx;
  x.bind(xout + (long long)b * n + lane);
  T* srow = scratch + (long long)b * kScratchRows * n + lane;
  lx.bind(srow);
  g.bind(srow + n);
  ih.bind(srow + 2 * n);
  hig.bind(srow + 3 * n);
  hia.bind(srow + 4 * n);
  dx.bind(srow + 5 * n);
#pragma unroll
  for (int c = 0; c < nc; ++c) {
    const int i = lane + 32 * c;
    if (i < n) x[c] = x0[b * sxb + i];
  }

  // The candidates' factors beta^expo, read once: when they do not
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
        T lc[kLsChunk][NC > 0 ? NC : 1];   // their logs, in registers only
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
            if constexpr (NC > 0) lc[l][c] = lxs;
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
          if constexpr (NC > 0) {
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

template <typename T, int K>
void launch_nc(int nc_needed, const T* H, const T* u, const T* A,
               const T* bv, const T* x0, long long sHb, long long sHk,
               long long sub, long long suk, long long sAb, long long sbb,
               long long sxb, const T* ts, const T* ls_ts, T* x, T* scratch,
               int B, int n, int n_outer, int n_inner, int n_ls,
               const T* lognv, T delta, T alpha, cudaStream_t st) {
  const int blocks = (B + kWarpsPerBlock - 1) / kWarpsPerBlock;
#define KL_K3_ARGS                                                         \
  H, u, A, bv, x0, sHb, sHk, sub, suk, sAb, sbb, sxb, ts, ls_ts, x,        \
      scratch, B, n, n_outer, n_inner, n_ls, lognv, delta, alpha
  if (nc_needed <= 4)
    kl_barrier_kernel<T, K, 4><<<blocks, kThreads, 0, st>>>(KL_K3_ARGS);
  else if (n <= kRegMaxN)
    kl_barrier_kernel<T, K, kRegMaxN / 32><<<blocks, kThreads, 0, st>>>(
        KL_K3_ARGS);
  else
    kl_barrier_kernel<T, K, 0><<<blocks, kThreads, 0, st>>>(KL_K3_ARGS);
#undef KL_K3_ARGS
}

template <typename T>
int launch_k3(const void* H, const void* u, const void* A, const void* bv,
              const void* x0, long long sHb, long long sHk, long long sub,
              long long suk, long long sAb, long long sbb, long long sxb,
              const void* ts, const void* ls_ts, void* x, void* scratch,
              int B, int n, int k, int n_outer, int n_inner, int n_ls,
              const void* lognv, double delta, double alpha,
              void* stream) {
  if (B < 1 || n < 1 || n_outer < 0 || n_inner < 0 || n_ls < 1)
    return cudaErrorInvalidValue;
  const int nc = (n + 31) / 32;
  cudaStream_t st = (cudaStream_t)stream;
  if (k == 1)
    launch_nc<T, 1>(nc, (const T*)H, (const T*)u, (const T*)A, (const T*)bv,
                    (const T*)x0, sHb, sHk, sub, suk, sAb, sbb, sxb,
                    (const T*)ts, (const T*)ls_ts, (T*)x, (T*)scratch, B, n,
                    n_outer, n_inner, n_ls, (const T*)lognv, T(delta),
                    T(alpha), st);
  else if (k == 2)
    launch_nc<T, 2>(nc, (const T*)H, (const T*)u, (const T*)A, (const T*)bv,
                    (const T*)x0, sHb, sHk, sub, suk, sAb, sbb, sxb,
                    (const T*)ts, (const T*)ls_ts, (T*)x, (T*)scratch, B, n,
                    n_outer, n_inner, n_ls, (const T*)lognv, T(delta),
                    T(alpha), st);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int kl_barrier_fused_f32(const void* H, const void* u, const void* A,
                         const void* bv, const void* x0, long long sHb,
                         long long sHk, long long sub, long long suk,
                         long long sAb, long long sbb, long long sxb,
                         const void* ts, const void* ls_ts, void* x,
                         void* scratch, int B, int n, int k, int n_outer,
                         int n_inner, int n_ls, const void* lognv,
                         double delta, double alpha, void* stream) {
  return launch_k3<float>(H, u, A, bv, x0, sHb, sHk, sub, suk, sAb, sbb, sxb,
                          ts, ls_ts, x, scratch, B, n, k, n_outer, n_inner,
                          n_ls, lognv, delta, alpha, stream);
}

int kl_barrier_fused_f64(const void* H, const void* u, const void* A,
                         const void* bv, const void* x0, long long sHb,
                         long long sHk, long long sub, long long suk,
                         long long sAb, long long sbb, long long sxb,
                         const void* ts, const void* ls_ts, void* x,
                         void* scratch, int B, int n, int k, int n_outer,
                         int n_inner, int n_ls, const void* lognv,
                         double delta, double alpha, void* stream) {
  return launch_k3<double>(H, u, A, bv, x0, sHb, sHk, sub, suk, sAb, sbb,
                           sxb, ts, ls_ts, x, scratch, B, n, k, n_outer,
                           n_inner, n_ls, lognv, delta, alpha, stream);
}

const char* kl_barrier_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
