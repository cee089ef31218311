// K1 and K2: the batched KL dual solve on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of cvx_tpu/ops/pallas_kl_dual.py:
//   K1  kl_dual_fused_{f32,f64}  <- _kl_dual_kernel      (pallas_call :953)
//   K2  kl_dual_fused_cert_f32   <- _kl_dual_cert_kernel (pallas_call :836)
// The plain PyTorch versions of the same algebra are kl_dual_fused_plain
// and kl_dual_fused_cert_plain in ../kl_dual.py; the comments there and in
// the reference explain each guard (sick flag, trust cap, fallback
// candidate, projected candidate, boundary-jam purge, dead lanes).
//
// What bounds it on this card.  Per instance and Newton step the work is
// one pass over the n lanes that accumulates dim(dim+3)/2 sums, a second
// pass for the n_ls line-search candidates, the fallback candidate and
// (dim > 8) the projected candidate, and between them a chain of
// dependent warp reductions and a dim x dim solve in scalar code.  At the
// bench shape (10k instances, n = 100, dim 3) the rows are 8 MB and stay
// in the 50 MB L2, and the arithmetic is a few hundred MFLOP: the kernel
// is bound by the latency of that dependent chain, not by bytes or FLOPs.
//
// What the design does about it.  One warp per instance: every reduction
// is a register butterfly (__shfl_xor_sync), with no shared memory and no
// block barrier, and every lane then solves the small system redundantly
// so that no broadcast is needed.  Many independent warps per SM (four per
// block) hide one another's latency.  Lane l owns the coordinates i = 32 c
// + l and masks the ragged edge itself, so nothing is padded.  DIM is a
// template parameter, so the small-system algebra is unrolled into
// registers; where k is a runtime value (the streamed path below),
// per-coordinate code tests it as a predicate (never as an index) to keep
// arrays in registers.
//
// Two paths over the coordinates, chosen by shape in the C launchers
// (held_shape).  Held (template parameter NC = kHeldNC > 0): f32 rows, dual
// dim <= kHeldMaxDim, no extra equality rows and n <= 32 NC, which covers
// the main shape n = 100, dim 3.  A lane loads the rows and the log prior
// of its NC coordinates once, before the step loop, and keeps them in
// registers; each pass is a fully unrolled loop over c < NC with no load
// and no address arithmetic in it, pass 2 reuses pass 1's y = exp(-B'z - 1
// + lp), the epilogues compute their exp once, and k = DIM - 1 is a
// compile-time value.  A lane skips a coordinate past n.  Streamed (NC =
// 0; every other shape): each pass walks i0 = 0, 32, ... with a runtime
// trip count and re-reads the rows from global (L2) memory.  Both paths
// add a lane's coordinates in the same order (c ascending) through the
// same expressions; the streamed f32 path compensates the sums of the
// value and the gradient (LaneSum below), so at n <= 128 the two agree to
// rounding, not bit for bit.  At the main shape the held kernel keeps the
// SMs' instruction schedulers busy most of the time: what is left to gain
// there is fewer instructions, not shorter chains.
//
// Numerics follow the reference: IEEE exp/log/div/sqrt (no fast math, no
// flush to zero), NaN-propagating min/max like jnp.maximum, and the same
// order of operations per lane (built with --fmad=false).  Sums over the
// lanes are reduced by a warp butterfly, which nothing forces to pair the
// partial sums as the plain version's row sums do, so chip_smoke.py and
// tests/test_torch_cuda.py hold the kernels to the plain versions by a
// tolerance, not bit for bit (on an H100, K1's x has matched the plain
// version's bits at the bench shape and dims 3, 8 and 16).  K2 runs the
// K1 f32 device code, then the warm polish and the certificate in native
// f64, where the TPU kernel used double-single pairs.
//
// Interface: plain C, pointers and element strides; the lane axis is
// contiguous, the batch and row strides are free (0 for a shared,
// expanded matrix).  Each entry launches on the given stream and returns
// cudaGetLastError().  KL_DUAL_ENTRY = 1, 2 or 3 builds only
// kl_dual_fused_f32, kl_dual_fused_f64 or kl_dual_fused_cert_f32, so that
// three compilers can share the template instances; unset, all three.

#include <cuda_runtime.h>

#include <cfloat>
#include <cmath>

namespace {

constexpr int kMaxLs = 8;          // line-search levels with accumulators
constexpr int kWarpsPerBlock = 4;  // instances per block
constexpr int kHeldNC = 4;         // coordinates a lane holds (n <= 32 NC)
constexpr int kHeldMaxDim = 8;     // widest dual dim with a held path
constexpr int kCopyMaxDim = 5;     // newton_z copies w, z up to this dim
constexpr unsigned kFull = 0xffffffffu;

template <typename T> struct Lim;
template <> struct Lim<float> {
  static __device__ __forceinline__ float eps() { return FLT_EPSILON; }
  static __device__ __forceinline__ float tiny() { return FLT_MIN; }
  static __device__ __forceinline__ float maxv() { return FLT_MAX; }
};
template <> struct Lim<double> {
  static __device__ __forceinline__ double eps() { return DBL_EPSILON; }
  static __device__ __forceinline__ double tiny() { return DBL_MIN; }
  static __device__ __forceinline__ double maxv() { return DBL_MAX; }
};

__device__ __forceinline__ float kexp(float v) { return expf(v); }
__device__ __forceinline__ double kexp(double v) { return exp(v); }
__device__ __forceinline__ float klog(float v) { return logf(v); }
__device__ __forceinline__ double klog(double v) { return log(v); }
__device__ __forceinline__ float ksqrt(float v) { return sqrtf(v); }
__device__ __forceinline__ double ksqrt(double v) { return sqrt(v); }
__device__ __forceinline__ float kabs(float v) { return fabsf(v); }
__device__ __forceinline__ double kabs(double v) { return fabs(v); }

// jnp.maximum / jnp.minimum: a NaN in either argument gives NaN
template <typename T> __device__ __forceinline__ T jmax(T a, T b) {
  return (a > b || a != a) ? a : b;
}
template <typename T> __device__ __forceinline__ T jmin(T a, T b) {
  return (a < b || a != a) ? a : b;
}
template <typename T> __device__ __forceinline__ T jclip(T v, T lo, T hi) {
  return jmin(jmax(v, lo), hi);
}

// butterfly all-reduce: every lane ends with the same bits
template <typename T> __device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = v + __shfl_xor_sync(kFull, v, o);
  return v;
}
template <typename T> __device__ __forceinline__ T warp_max(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = jmax(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// A lane's running sum of its coordinates' terms.  Streamed, a lane adds
// n/32 terms in turn, and their rounding errors add up with n: on bench.py's
// family, where most terms are equal, to ~1e-5 of the sum at n = 10,000,
// which gives the f32 dual value a false minimum ~5e-6 below the true one.
// A lane then stops there (gap 1.4e-3 where the plain version's pairwise
// sums reach 2.5e-6).  COMP = true compensates the sum (Kahan; --fmad=false
// and no fast math keep the compiler from folding it away).  The streamed
// f32 path compensates the sums of the value and the gradient, whose line
// search and fallback decide the steps; the Hessian's sums only shape the
// direction and stay plain.  A held lane adds at most kHeldNC terms.
template <typename T, bool COMP> struct LaneSum {
  T s = T(0);
  __device__ __forceinline__ void add(T v) { s += v; }
  __device__ __forceinline__ T total() const { return s; }
};
template <typename T> struct LaneSum<T, true> {
  T s = T(0), c = T(0);
  __device__ __forceinline__ void add(T v) {
    const T y = v - c;
    const T t = s + y;
    c = (t - s) - y;
    s = t;
  }
  __device__ __forceinline__ T total() const { return s - c; }
};
// compensated: the streamed path in f32
template <int NC, typename T> __host__ __device__ constexpr bool comp_sums() {
  return NC == 0 && sizeof(T) == sizeof(float);
}

// packed upper triangle (i <= j) of a DIM x DIM symmetric matrix
template <int DIM> __host__ __device__ constexpr int pidx(int i, int j) {
  return i * DIM - i * (i - 1) / 2 + (j - i);
}

// One instance's rows: B = [H; 1'; A], lane axis contiguous.
template <typename R, typename LP> struct Rows {
  const R* H;
  long long sHk;
  const R* A;
  long long sAm;
  const LP* logp;
  int n, k;
};

// h[j] = B[j, i] (h[k] = 1 exactly) and the log prior at lane i
template <int DIM, typename TH, typename TL, typename R, typename LP>
__device__ __forceinline__ void load_lane(const Rows<R, LP>& P, int k, int i,
                                          TH (&h)[DIM], TL& lp) {
#pragma unroll
  for (int j = 0; j < DIM; ++j) {
    if (j < k)
      h[j] = TH(P.H[j * P.sHk + i]);
    else if (j == k)
      h[j] = TH(1);
    else
      h[j] = TH(P.A[(j - k - 1) * P.sAm + i]);
  }
  lp = TL(P.logp[i]);
}

// The number of inequality rows.  The held path takes no extra equality
// rows (the launchers see to it), so there k = DIM - 1 at compile time:
// the tests on k fold away and row k, exactly 1, costs no register.
template <int DIM, int NC, typename R, typename LP>
__device__ __forceinline__ int rows_k(const Rows<R, LP>& P) {
  return NC > 0 ? DIM - 1 : P.k;
}

// (B'v)_i = v[k] + sum_{j != k} v[j] h[j], in the reference's order
template <int DIM, typename T>
__device__ __forceinline__ T bt_of(const T (&v)[DIM], const T (&h)[DIM],
                                   int k) {
  T out = T(0);
#pragma unroll
  for (int j = 0; j < DIM; ++j)
    if (j == k) out = v[j];
#pragma unroll
  for (int j = 0; j < DIM; ++j)
    if (j != k) out = out + v[j] * h[j];
  return out;
}

template <int DIM, typename T>
__device__ __forceinline__ T pick(const T (&v)[DIM], int k) {
  T out = T(0);
#pragma unroll
  for (int j = 0; j < DIM; ++j)
    if (j == k) out = v[j];
  return out;
}

// y_i = p_i exp(-(B'z)_i - 1)
template <int DIM, typename T>
__device__ __forceinline__ T y_of(const T (&z)[DIM], const T (&h)[DIM],
                                  int k, T lp) {
  return kexp(-bt_of<DIM>(z, h, k) - T(1) + lp);
}

// A lane's coordinates i = 32 c + lane, c < NC, held in registers: the
// rows as TH and the log prior as TL (unset past n).  NC = 0 holds nothing.
template <int DIM, int NC, typename TH, typename TL> struct Held {
  TH h[NC][DIM];
  TL lp[NC];
};
template <int DIM, typename TH, typename TL> struct Held<DIM, 0, TH, TL> {};

template <int DIM, int NC, typename TH, typename TL, typename R, typename LP>
__device__ __forceinline__ void hold(const Rows<R, LP>& P, int lane,
                                     Held<DIM, NC, TH, TL>& S) {
  if constexpr (NC > 0) {
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int i = 32 * c + lane;
      if (i < P.n) load_lane<DIM>(P, DIM - 1, i, S.h[c], S.lp[c]);
    }
  }
}

// body(h, lp, c, i) in T for each of the lane's coordinates i < n, c
// ascending.  Held: unrolled over c < NC.  Streamed: a runtime loop that
// loads the rows, and c is 0.
template <int DIM, int NC, typename T, typename TH, typename TL, typename R,
          typename LP, typename F>
__device__ __forceinline__ void each_coord(const Rows<R, LP>& P, int lane,
                                           const Held<DIM, NC, TH, TL>& S,
                                           F&& body) {
  if constexpr (NC > 0) {
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int i = 32 * c + lane;
      if (i >= P.n) continue;
      T h[DIM];
#pragma unroll
      for (int j = 0; j < DIM; ++j) h[j] = T(S.h[c][j]);
      body(h, T(S.lp[c]), c, i);
    }
  } else {
    for (int i0 = 0; i0 < P.n; i0 += 32) {  // same trip count on every lane
      const int i = i0 + lane;
      if (i >= P.n) continue;
      T h[DIM], lp;
      load_lane<DIM>(P, P.k, i, h, lp);
      body(h, lp, 0, i);
    }
  }
}

// a if C else b, as a reference (the two may differ in const)
template <bool C, typename A, typename B>
__device__ __forceinline__ auto& ref_if(A& a, B& b) {
  if constexpr (C)
    return a;
  else
    return b;
}

// projected-gradient norm^2 (lam at 0 wanting to decrease dropped)
template <int DIM, typename T>
__device__ __forceinline__ T pgnorm(const T (&z)[DIM], const T (&g)[DIM],
                                    int k) {
  T s = T(0);
#pragma unroll
  for (int j = 0; j < DIM; ++j) {
    const T gj = (j < k && z[j] <= T(0) && g[j] > T(0)) ? T(0) : g[j];
    s = s + gj * gj;
  }
  return s;
}

// dz = -M^-1 gf with the per-instance sick flag (pallas_kl_dual.py:81-163):
// closed-form adjugate for DIM <= 3, Cholesky for DIM 4..16.
template <int DIM, typename T>
__device__ __forceinline__ bool solve_small(const T (&m)[DIM * (DIM + 1) / 2],
                                            const T (&gf)[DIM], T (&dz)[DIM]) {
#define M(i, j) m[pidx<DIM>((i), (j))]
  const T eps10 = T(10) * Lim<T>::eps();
  if constexpr (DIM == 2) {
    const T det = M(0, 0) * M(1, 1) - M(0, 1) * M(0, 1);
    const bool sick = det <= eps10 * (M(0, 0) * M(1, 1));
    dz[0] = -(M(1, 1) * gf[0] - M(0, 1) * gf[1]) / det;
    dz[1] = -(M(0, 0) * gf[1] - M(0, 1) * gf[0]) / det;
    return sick;
  } else if constexpr (DIM == 3) {
    const T c00 = M(1, 1) * M(2, 2) - M(1, 2) * M(1, 2);
    const T c01 = M(1, 2) * M(0, 2) - M(0, 1) * M(2, 2);
    const T c02 = M(0, 1) * M(1, 2) - M(1, 1) * M(0, 2);
    const T det = M(0, 0) * c00 + M(0, 1) * c01 + M(0, 2) * c02;
    const bool sick = det <= eps10 * (M(0, 0) * M(1, 1) * M(2, 2));
    dz[0] = -(c00 * gf[0] + c01 * gf[1] + c02 * gf[2]) / det;
    dz[1] = -(c01 * gf[0] + (M(0, 0) * M(2, 2) - M(0, 2) * M(0, 2)) * gf[1] +
              (M(0, 1) * M(0, 2) - M(0, 0) * M(1, 2)) * gf[2]) / det;
    dz[2] = -(c02 * gf[0] + (M(0, 1) * M(0, 2) - M(0, 0) * M(1, 2)) * gf[1] +
              (M(0, 0) * M(1, 1) - M(0, 1) * M(0, 1)) * gf[2]) / det;
    return sick;
  } else {
    // L(i, j), i >= j, stored at pidx(j, i)
    T L[DIM * (DIM + 1) / 2];
#define LL(i, j) L[pidx<DIM>((j), (i))]
    const T tiny = Lim<T>::tiny();
    bool sick = false;
#pragma unroll
    for (int j = 0; j < DIM; ++j) {
      T d = M(j, j);
#pragma unroll
      for (int p = 0; p < j; ++p) d = d - LL(j, p) * LL(j, p);
      sick = sick || (d <= eps10 * M(j, j));
      LL(j, j) = ksqrt(jmax(d, tiny));
#pragma unroll
      for (int i = j + 1; i < DIM; ++i) {
        T off = M(j, i);
#pragma unroll
        for (int p = 0; p < j; ++p) off = off - LL(i, p) * LL(j, p);
        LL(i, j) = off / LL(j, j);
      }
    }
    T yv[DIM];
#pragma unroll
    for (int i = 0; i < DIM; ++i) {
      T s = -gf[i];
#pragma unroll
      for (int p = 0; p < i; ++p) s = s - LL(i, p) * yv[p];
      yv[i] = s / LL(i, i);
    }
#pragma unroll
    for (int i = DIM - 1; i >= 0; --i) {
      T s = yv[i];
#pragma unroll
      for (int p = i + 1; p < DIM; ++p) s = s - LL(p, i) * dz[p];
      dz[i] = s / LL(i, i);
    }
#undef LL
    return sick;
  }
#undef M
}

// The fixed-schedule active-set projected-Newton loop (the reference's
// _newton_z, pallas_kl_dual.py:245-486), one warp per instance.
// __noinline__: inlined into the K2 kernel, nvcc 12.9 (-O3, sm_90a) built
// a kernel whose f32 phase never moved z (its w read as NaN), while the
// same code inlined into K1 was right; a call boundary fixes it.  w and z
// cross that boundary in memory, so up to dim kCopyMaxDim the loop works
// on copies in registers (a wider dual has no registers to spare); the
// held rows are loaded on this side of it.
template <int DIM, int NC, typename T, typename R, typename LP>
__device__ __noinline__ void newton_z(const Rows<R, LP>& P,
                                      const T (&w_in)[DIM], T (&z_out)[DIM],
                                      int n_steps, T z0, int n_ls, int lane) {
  constexpr int NP = DIM * (DIM + 1) / 2;
  constexpr bool copy = DIM <= kCopyMaxDim;
  constexpr bool kc = comp_sums<NC, T>();
  const int k = rows_k<DIM, NC>(P);
  Held<DIM, NC, T, T> S;
  hold<DIM, NC>(P, lane, S);
  T w_copy[DIM], z_copy[DIM];
  const T(&w)[DIM] = ref_if<copy>(w_copy, w_in);
  T(&z)[DIM] = ref_if<copy>(z_copy, z_out);
  if constexpr (copy) {
#pragma unroll
    for (int j = 0; j < DIM; ++j) w_copy[j] = w_in[j];
  }
  const T eps = Lim<T>::eps(), tiny = Lim<T>::tiny();
  const T inf = T(INFINITY);
  const T max_e = T(0.9) * klog(Lim<T>::maxv());
  const T scale_deep = T(1.0 / double(1 << (n_ls - 1)));
  const T diag_scale = T(1.0 + 10.0 * double(Lim<T>::eps()));
#pragma unroll
  for (int j = 0; j < DIM; ++j) z[j] = z0;

  for (int it = 0; it < n_steps; ++it) {
    // pass 1: y = p exp(-B'z - 1); s_j = sum y B_j; acc_ab = sum y B_a B_b
    LaneSum<T, kc> sl[DIM];
    T s[DIM], acc[NP];
#pragma unroll
    for (int a = 0; a < NP; ++a) acc[a] = T(0);
    T ys[NC > 0 ? NC : 1];  // held: pass 1's y, reused by pass 2
    each_coord<DIM, NC, T>(P, lane, S, [&](const T(&h)[DIM], T lp, int c,
                                           int) {
      const T y = y_of<DIM>(z, h, k, lp);
      if constexpr (NC > 0) ys[c] = y;
#pragma unroll
      for (int a = 0; a < DIM; ++a) {
        const T ya = y * h[a];
        sl[a].add(ya);
#pragma unroll
        for (int b = a; b < DIM; ++b) acc[pidx<DIM>(a, b)] += ya * h[b];
      }
    });
#pragma unroll
    for (int a = 0; a < DIM; ++a) s[a] = warp_sum(sl[a].total());
#pragma unroll
    for (int a = 0; a < NP; ++a) acc[a] = warp_sum(acc[a]);

    const T ry = pick<DIM>(s, k);
    T f0 = ry;
#pragma unroll
    for (int i = 0; i < DIM; ++i) f0 = f0 + w[i] * z[i];
    T g[DIM], fr[DIM], gf[DIM];
#pragma unroll
    for (int j = 0; j < DIM; ++j) {
      g[j] = w[j] - s[j];
      fr[j] = (j < k && z[j] <= T(0) && g[j] > T(0)) ? T(0) : T(1);
      gf[j] = g[j] * fr[j];
    }
    // Hessian, frozen coordinates masked to a unit row/col
    T m[NP];
#pragma unroll
    for (int a = 0; a < DIM; ++a) {
#pragma unroll
      for (int b = a; b < DIM; ++b) {
        T v = acc[pidx<DIM>(a, b)] * fr[a] * fr[b];
        if (a == b) {
          v = v + (T(1) - fr[a]);
          v = v * diag_scale;
        }
        m[pidx<DIM>(a, b)] = v;
      }
    }
    T dz[DIM];
    const bool sick = solve_small<DIM>(m, gf, dz);
    T dz_inf = T(0), t_bd = inf;
#pragma unroll
    for (int j = 0; j < DIM; ++j) {
      // sick: Jacobi-preconditioned gradient direction instead
      if (sick) dz[j] = -gf[j] / m[pidx<DIM>(j, j)];
      // a lam already at its bound cannot move down
      if (j < k && z[j] <= T(0) && dz[j] < T(0)) dz[j] = T(0);
      // fraction-to-boundary cap
      if (j < k && dz[j] < T(0)) t_bd = jmin(t_bd, -z[j] / dz[j]);
      dz_inf = jmax(dz_inf, kabs(dz[j]));
    }
    // far-field trust cap of 8 per coordinate
    const T t_trust = T(8) / jmax(dz_inf, T(8));
    const T t_full = jmin(jclip(t_bd, T(0), T(1)), t_trust);

    // fallback candidate t* = clip(-g.dz / dz'M dz, 0, t_full)
    T q = g[0] * dz[0];
#pragma unroll
    for (int j = 1; j < DIM; ++j) q = q + g[j] * dz[j];
    T curv = T(0);
#pragma unroll
    for (int a = 0; a < DIM; ++a) {
#pragma unroll
      for (int b = 0; b < DIM; ++b) {
        const T mab = a <= b ? m[pidx<DIM>(a, b)] : m[pidx<DIM>(b, a)];
        curv = curv + mab * dz[a] * dz[b];
      }
    }
    const T t_star = jmin(jmax(-q / jmax(curv, tiny), T(0)), t_full);
    T zs[DIM], zpr[DIM];
    const T t_pr = jmin(T(1), t_trust);
#pragma unroll
    for (int j = 0; j < DIM; ++j) {
      zs[j] = z[j] + t_star * dz[j];
      zpr[j] = z[j] + t_pr * dz[j];
      if (j < k) zpr[j] = jmax(zpr[j], T(0));
    }

    // pass 2: the n_ls candidates along the ray, deepest first (one exp,
    // then a squaring per level), the fallback candidate's value and
    // gradient, and (DIM > 8) the projected candidate's value
    const T neg_tdeep = -(t_full * scale_deep);
    const T neg_tstar = -t_star;
    LaneSum<T, kc> lsl[kMaxLs], gsl[DIM], sprl;
    T ls[kMaxLs], gs[DIM];
    T cmax = -inf, spr = T(0);
    each_coord<DIM, NC, T>(P, lane, S, [&](const T(&h)[DIM], T lp, int c,
                                           int) {
      T y;
      if constexpr (NC > 0)
        y = ys[c];
      else
        y = y_of<DIM>(z, h, k, lp);
      const T wdir = bt_of<DIM>(dz, h, k);
      const T e = neg_tdeep * wdir;
      cmax = jmax(cmax, e);
      T efac = kexp(jclip(e, -max_e, max_e));
#pragma unroll
      for (int l = 0; l < kMaxLs; ++l) {
        if (l < n_ls) {
          lsl[l].add(y * efac);
          efac = efac * efac;
        }
      }
      const T ystar = y * kexp(jclip(neg_tstar * wdir, -max_e, max_e));
#pragma unroll
      for (int j = 0; j < DIM; ++j) gsl[j].add(h[j] * ystar);
      if constexpr (DIM > 8) sprl.add(y_of<DIM>(zpr, h, k, lp));
    });
#pragma unroll
    for (int l = 0; l < kMaxLs; ++l)
      ls[l] = l < n_ls ? warp_sum(lsl[l].total()) : T(0);
#pragma unroll
    for (int j = 0; j < DIM; ++j) gs[j] = warp_sum(gsl[j].total());
    cmax = warp_max(cmax);
    if constexpr (DIM > 8) spr = warp_sum(sprl.total());

    // a lane whose deepest exponent already clips scores every candidate
    // on a distorted factor: disqualify the whole chain
    const bool chain_bad = cmax > max_e;
    T best_f = f0, tf = T(0), t = t_full * scale_deep;
#pragma unroll
    for (int l = 0; l < kMaxLs; ++l) {
      if (l < n_ls) {
        T ft = ls[l];
#pragma unroll
        for (int i = 0; i < DIM; ++i) ft = ft + w[i] * (z[i] + t * dz[i]);
        if (!isfinite(ft) || chain_bad) ft = inf;
        // strict improvement over f0; on ties the larger t wins
        if (ft < f0 && ft <= best_f) {
          best_f = ft;
          tf = t;
        }
        t = T(2) * t;
      }
    }
    bool finite = true;
#pragma unroll
    for (int j = 0; j < DIM; ++j) finite = finite && isfinite(dz[j]);
    const bool f_ok = best_f < f0 && finite;
    T fs = pick<DIM>(gs, k);
#pragma unroll
    for (int i = 0; i < DIM; ++i) fs = fs + w[i] * zs[i];
    T gsv[DIM];
#pragma unroll
    for (int j = 0; j < DIM; ++j) gsv[j] = w[j] - gs[j];
    const T noise = T(32.0 * double(eps)) * (T(1) + kabs(f0));
    const bool g_ok = pgnorm<DIM>(zs, gsv, k) < T(0.81) * pgnorm<DIM>(z, g, k)
                      && fs <= f0 + noise && finite;
    const T t_take = f_ok ? tf : t_star;
    const bool take = f_ok || g_ok;
    T zn[DIM];
#pragma unroll
    for (int j = 0; j < DIM; ++j) {
      zn[j] = take ? z[j] + t_take * dz[j] : z[j];
      if (j < k) zn[j] = jmax(zn[j], T(0));
    }
    if constexpr (DIM > 8) {
      T fpr = spr;
#pragma unroll
      for (int i = 0; i < DIM; ++i) fpr = fpr + w[i] * zpr[i];
      if (isfinite(fpr) && fpr < best_f && finite) {
#pragma unroll
        for (int j = 0; j < DIM; ++j) zn[j] = zpr[j];
      }
    }
    // snap boundary landings to 0, and purge a lam below ~32 eps scale
    // whose gradient says "decrease" (the boundary-jam fix; zinf is the
    // old iterate's)
    T zinf = T(0);
#pragma unroll
    for (int j = 0; j < DIM; ++j) zinf = jmax(zinf, kabs(z[j]));
    const T purge_th = T(32.0 * double(eps)) * (T(1) + zinf);
#pragma unroll
    for (int j = 0; j < DIM; ++j) {
      if (j < k && (zn[j] <= T(8.0 * double(eps)) * kabs(z[j]) ||
                    (g[j] > T(0) && zn[j] <= purge_th)))
        zn[j] = T(0);
    }
#pragma unroll
    for (int j = 0; j < DIM; ++j) z[j] = zn[j];
  }
  if constexpr (copy) {
#pragma unroll
    for (int j = 0; j < DIM; ++j) z_out[j] = z_copy[j];
  }
}

template <int DIM, typename T>
__device__ __forceinline__ void load_w(const T* u, long long sub,
                                       long long suk, const T* r,
                                       long long srb, long long srm, int b,
                                       int k, T (&w)[DIM]) {
#pragma unroll
  for (int j = 0; j < DIM; ++j) {
    if (j < k)
      w[j] = u[b * sub + j * suk];
    else if (j == k)
      w[j] = T(1);
    else
      w[j] = r[b * srb + (j - k - 1) * srm];
  }
}

// K1: the solve, then x = y / sum(y) and the measured gap f(x) - g(z)
template <int DIM, int NC, typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
kl_dual_kernel(const T* __restrict__ H, const T* __restrict__ u,
               const T* __restrict__ A, const T* __restrict__ r,
               const T* __restrict__ logp, long long sHb, long long sHk,
               long long sub, long long suk, long long sAb, long long sAm,
               long long srb, long long srm, T* __restrict__ x,
               T* __restrict__ gap, T* __restrict__ zout, int B, int n,
               int k_rows, int n_steps, T z0, int n_ls) {
  const int b = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (b >= B) return;
  const Rows<T, T> P{H + b * sHb, sHk, A + b * sAb, sAm, logp, n, k_rows};
  const int k = rows_k<DIM, NC>(P);
  T w[DIM], z[DIM];
  load_w<DIM>(u, sub, suk, r, srb, srm, b, k, w);
  newton_z<DIM, NC>(P, w, z, n_steps, z0, n_ls, lane);

  Held<DIM, NC, T, T> S;
  hold<DIM, NC>(P, lane, S);
  T ys[NC > 0 ? NC : 1];  // held: the exp serves sum(y) and x
  LaneSum<T, comp_sums<NC, T>()> syl, fpl;
  each_coord<DIM, NC, T>(P, lane, S, [&](const T(&h)[DIM], T lp, int c, int) {
    const T y = y_of<DIM>(z, h, k, lp);
    if constexpr (NC > 0) ys[c] = y;
    syl.add(y);
  });
  const T sy = warp_sum(syl.total());
  // sum(y) underflowed to 0 (the unbounded dual of an infeasible
  // instance): the gap is +inf instead of NaN
  const bool dead = sy <= T(0);
  const T den = dead ? T(1) : sy;
  T* xb = x + (long long)b * n;
  each_coord<DIM, NC, T>(P, lane, S, [&](const T(&h)[DIM], T lp, int c,
                                         int i) {
    T y;
    if constexpr (NC > 0)
      y = ys[c];
    else
      y = y_of<DIM>(z, h, k, lp);
    const T xi = y / den;
    xb[i] = xi;
    fpl.add(xi * (klog(xi > T(0) ? xi : T(1)) - lp));
  });
  const T fp = warp_sum(fpl.total());
  if (lane == 0) {
    T val = sy;
#pragma unroll
    for (int j = 0; j < DIM; ++j) val = val + w[j] * z[j];
    gap[b] = dead ? T(INFINITY) : fp + val;
#pragma unroll
    for (int j = 0; j < DIM; ++j) zout[(long long)b * DIM + j] = z[j];
  }
}

// K2 polish: one warm projected-Newton step in f64 (_kl_warm_polish's
// algebra; no step for a non-finite, sick or |dz| > 1e3 direction)
template <int DIM, int NC>
__device__ void polish_step(const Rows<float, double>& P,
                            const Held<DIM, NC, float, double>& S,
                            const double (&w)[DIM], double (&z)[DIM],
                            int lane) {
  constexpr int NP = DIM * (DIM + 1) / 2;
  const int k = rows_k<DIM, NC>(P);
  const double eps = DBL_EPSILON;
  const double max_e = 0.9 * log(DBL_MAX);
  double s[DIM], acc[NP];
#pragma unroll
  for (int a = 0; a < DIM; ++a) s[a] = 0.0;
#pragma unroll
  for (int a = 0; a < NP; ++a) acc[a] = 0.0;
  each_coord<DIM, NC, double>(P, lane, S, [&](const double(&h)[DIM],
                                              double lp, int, int) {
    const double y =
        exp(jclip(-bt_of<DIM>(z, h, k) - 1.0 + lp, -max_e, max_e));
#pragma unroll
    for (int a = 0; a < DIM; ++a) {
      const double ya = y * h[a];
      s[a] += ya;
#pragma unroll
      for (int b = a; b < DIM; ++b) acc[pidx<DIM>(a, b)] += ya * h[b];
    }
  });
#pragma unroll
  for (int a = 0; a < DIM; ++a) s[a] = warp_sum(s[a]);
#pragma unroll
  for (int a = 0; a < NP; ++a) acc[a] = warp_sum(acc[a]);
  double g[DIM], fr[DIM], gf[DIM], m[NP], dz[DIM];
#pragma unroll
  for (int j = 0; j < DIM; ++j) {
    g[j] = w[j] - s[j];
    fr[j] = (j < k && z[j] <= 0.0 && g[j] > 0.0) ? 0.0 : 1.0;
    gf[j] = g[j] * fr[j];
  }
#pragma unroll
  for (int a = 0; a < DIM; ++a) {
#pragma unroll
    for (int b = a; b < DIM; ++b) {
      double v = acc[pidx<DIM>(a, b)] * fr[a] * fr[b];
      if (a == b) {
        v = v + (1.0 - fr[a]);
        v = v + 1e-13 * v;
      }
      m[pidx<DIM>(a, b)] = v;
    }
  }
  const bool sick = solve_small<DIM>(m, gf, dz);
  double t_bd = INFINITY;
#pragma unroll
  for (int j = 0; j < DIM; ++j) {
    if (j < k && z[j] <= 0.0 && dz[j] < 0.0) dz[j] = 0.0;
    if (j < k && dz[j] < 0.0) t_bd = jmin(t_bd, -z[j] / dz[j]);
  }
  const double t = jmin(t_bd, 1.0);
  bool ok = !sick;
  double dz_inf = 0.0, zn[DIM];
#pragma unroll
  for (int j = 0; j < DIM; ++j) {
    double v = z[j] + t * dz[j];
    if (j < k) {
      v = jmax(v, 0.0);
      if (v <= 8.0 * eps * fabs(z[j])) v = 0.0;
    }
    ok = ok && isfinite(v);
    dz_inf = jmax(dz_inf, fabs(dz[j]));
    zn[j] = v;
  }
  ok = ok && dz_inf <= 1e3;
  if (ok) {
#pragma unroll
    for (int j = 0; j < DIM; ++j) z[j] = zn[j];
  }
}

// K2: the K1 f32 solve, polish_steps f64 polish steps, and the f64
// certificate (x, gap, ineq_res, eq_res) from one exp pass
template <int DIM, int NC>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
kl_dual_cert_kernel(const float* __restrict__ H, const float* __restrict__ u,
                    const float* __restrict__ A, const float* __restrict__ r,
                    const double* __restrict__ logp, long long sHb,
                    long long sHk, long long sub, long long suk,
                    long long sAb, long long sAm, long long srb,
                    long long srm, double* __restrict__ x,
                    double* __restrict__ zout, double* __restrict__ gap,
                    double* __restrict__ ineq, double* __restrict__ eq,
                    int B, int n, int k_rows, int n_steps, float z0,
                    int n_ls, int polish_steps) {
  const int b = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (b >= B) return;
  const Rows<float, double> P{H + b * sHb, sHk, A + b * sAb, sAm, logp, n,
                              k_rows};
  const int k = rows_k<DIM, NC>(P);
  float w32[DIM], z32[DIM];
  load_w<DIM>(u, sub, suk, r, srb, srm, b, k, w32);
  newton_z<DIM, NC>(P, w32, z32, n_steps, z0, n_ls, lane);
  double w[DIM], z[DIM];
#pragma unroll
  for (int j = 0; j < DIM; ++j) {
    w[j] = double(w32[j]);
    z[j] = double(z32[j]);
  }
  // held: the rows stay f32 (half the registers) and lift to f64, exactly,
  // at each use
  Held<DIM, NC, float, double> S;
  hold<DIM, NC>(P, lane, S);
  for (int s = 0; s < polish_steps; ++s)
    polish_step<DIM, NC>(P, S, w, z, lane);

  double ys[NC > 0 ? NC : 1];  // held: the exp serves sum(y) and x
  double sy = 0.0;
  each_coord<DIM, NC, double>(P, lane, S, [&](const double(&h)[DIM],
                                              double lp, int c, int) {
    const double y = y_of<DIM>(z, h, k, lp);
    if constexpr (NC > 0) ys[c] = y;
    sy += y;
  });
  sy = warp_sum(sy);
  const bool dead = sy <= 0.0;
  const double den = dead ? 1.0 : sy;
  double xbtz = 0.0, hx[DIM], nmax = -INFINITY;
#pragma unroll
  for (int j = 0; j < DIM; ++j) hx[j] = 0.0;
  double* xb = x + (long long)b * n;
  each_coord<DIM, NC, double>(P, lane, S, [&](const double(&h)[DIM],
                                              double lp, int c, int i) {
    const double btz = bt_of<DIM>(z, h, k);
    double y;
    if constexpr (NC > 0)
      y = ys[c];
    else
      y = exp(-btz - 1.0 + lp);
    const double xi = y / den;
    xb[i] = xi;
    xbtz += xi * btz;
#pragma unroll
    for (int j = 0; j < DIM; ++j) hx[j] += xi * h[j];
    nmax = jmax(nmax, -xi);
  });
  xbtz = warp_sum(xbtz);
#pragma unroll
  for (int j = 0; j < DIM; ++j) hx[j] = warp_sum(hx[j]);
  nmax = warp_max(nmax);
  if (lane == 0) {
    double wz = w[0] * z[0];
#pragma unroll
    for (int j = 1; j < DIM; ++j) wz = wz + w[j] * z[j];
    // log x - log p = -B'z - 1 - log sum(y): one scalar log
    const double f_ref = -xbtz - 1.0 - log(sy);
    gap[b] = dead ? INFINITY : f_ref + (wz + sy);
    double viol = jmax(nmax, 0.0), eqr = fabs(pick<DIM>(hx, k) - 1.0);
#pragma unroll
    for (int j = 0; j < DIM; ++j) {
      if (j < k) viol = jmax(viol, jmax(hx[j] - w[j], 0.0));
      if (j > k) eqr = jmax(eqr, fabs(hx[j] - w[j]));
    }
    ineq[b] = viol;
    eq[b] = eqr;
#pragma unroll
    for (int j = 0; j < DIM; ++j) zout[(long long)b * DIM + j] = z[j];
  }
}

constexpr int kThreads = kWarpsPerBlock * 32;

inline int blocks_for(int B) { return (B + kWarpsPerBlock - 1) / kWarpsPerBlock; }

// Which path a shape takes.  Held: f32 rows, a dual dim with a held
// instance, no extra equality rows (k = dim - 1) and an n of which a lane
// can hold its share.  Everything else is streamed.
template <int DIM> constexpr bool held_dim() { return DIM <= kHeldMaxDim; }
inline bool held_shape(int dim, int k, int n) {
  return k == dim - 1 && n <= 32 * kHeldNC;
}

template <typename T>
cudaError_t launch_k1(int dim, const void* H, const void* u, const void* A,
                      const void* r, const void* logp, long long sHb,
                      long long sHk, long long sub, long long suk,
                      long long sAb, long long sAm, long long srb,
                      long long srm, void* x, void* gap, void* z, int B,
                      int n, int k, int n_steps, double z0, int n_ls,
                      cudaStream_t stream) {
  // K1 in f64 at 100+ registers gains nothing from holding its rows
  constexpr bool held_type = sizeof(T) == sizeof(float);
#define KL_K1_LAUNCH(D, NC)                                                  \
  kl_dual_kernel<D, NC, T><<<blocks_for(B), kThreads, 0, stream>>>(          \
      (const T*)H, (const T*)u, (const T*)A, (const T*)r, (const T*)logp,    \
      sHb, sHk, sub, suk, sAb, sAm, srb, srm, (T*)x, (T*)gap, (T*)z, B, n,   \
      k, n_steps, T(z0), n_ls)
#define KL_K1_CASE(D)                                                        \
  case D:                                                                    \
    if constexpr (held_dim<D>() && held_type) {                              \
      if (held_shape(D, k, n)) {                                             \
        KL_K1_LAUNCH(D, kHeldNC);                                            \
        break;                                                               \
      }                                                                      \
    }                                                                        \
    KL_K1_LAUNCH(D, 0);                                                      \
    break;
  switch (dim) {
    KL_K1_CASE(2) KL_K1_CASE(3) KL_K1_CASE(4) KL_K1_CASE(5) KL_K1_CASE(6)
    KL_K1_CASE(7) KL_K1_CASE(8) KL_K1_CASE(9) KL_K1_CASE(10) KL_K1_CASE(11)
    KL_K1_CASE(12) KL_K1_CASE(13) KL_K1_CASE(14) KL_K1_CASE(15)
    KL_K1_CASE(16)
    default:
      return cudaErrorInvalidValue;
  }
#undef KL_K1_CASE
#undef KL_K1_LAUNCH
  return cudaGetLastError();
}

}  // namespace

#ifndef KL_DUAL_ENTRY
#define KL_DUAL_ENTRY 0
#endif

extern "C" {

#if KL_DUAL_ENTRY == 0 || KL_DUAL_ENTRY == 1
int kl_dual_fused_f32(const void* H, const void* u, const void* A,
                      const void* r, const void* logp, long long sHb,
                      long long sHk, long long sub, long long suk,
                      long long sAb, long long sAm, long long srb,
                      long long srm, void* x, void* gap, void* z, int B,
                      int n, int k, int m_eq, int n_steps, double z0,
                      int n_ls, void* stream) {
  if (n_ls < 1 || n_ls > kMaxLs) return cudaErrorInvalidValue;
  return launch_k1<float>(k + 1 + m_eq, H, u, A, r, logp, sHb, sHk, sub, suk,
                          sAb, sAm, srb, srm, x, gap, z, B, n, k, n_steps,
                          z0, n_ls, (cudaStream_t)stream);
}

#endif

#if KL_DUAL_ENTRY == 0 || KL_DUAL_ENTRY == 2
int kl_dual_fused_f64(const void* H, const void* u, const void* A,
                      const void* r, const void* logp, long long sHb,
                      long long sHk, long long sub, long long suk,
                      long long sAb, long long sAm, long long srb,
                      long long srm, void* x, void* gap, void* z, int B,
                      int n, int k, int m_eq, int n_steps, double z0,
                      int n_ls, void* stream) {
  if (n_ls < 1 || n_ls > kMaxLs) return cudaErrorInvalidValue;
  return launch_k1<double>(k + 1 + m_eq, H, u, A, r, logp, sHb, sHk, sub,
                           suk, sAb, sAm, srb, srm, x, gap, z, B, n, k,
                           n_steps, z0, n_ls, (cudaStream_t)stream);
}

#endif

#if KL_DUAL_ENTRY == 0 || KL_DUAL_ENTRY == 3
int kl_dual_fused_cert_f32(const void* H, const void* u, const void* A,
                           const void* r, const void* logp, long long sHb,
                           long long sHk, long long sub, long long suk,
                           long long sAb, long long sAm, long long srb,
                           long long srm, void* x, void* z, void* gap,
                           void* ineq, void* eq, int B, int n, int k,
                           int m_eq, int n_steps, double z0, int n_ls,
                           int polish_steps, void* stream) {
  if (n_ls < 1 || n_ls > kMaxLs) return cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define KL_K2_LAUNCH(D, NC)                                                 \
  kl_dual_cert_kernel<D, NC><<<blocks_for(B), kThreads, 0, st>>>(           \
      (const float*)H, (const float*)u, (const float*)A, (const float*)r,   \
      (const double*)logp, sHb, sHk, sub, suk, sAb, sAm, srb, srm,          \
      (double*)x, (double*)z, (double*)gap, (double*)ineq, (double*)eq, B,  \
      n, k, n_steps, float(z0), n_ls, polish_steps)
#define KL_K2_CASE(D)                                                       \
  case D:                                                                   \
    if constexpr (held_dim<D>()) {                                          \
      if (held_shape(D, k, n)) {                                            \
        KL_K2_LAUNCH(D, kHeldNC);                                           \
        break;                                                              \
      }                                                                     \
    }                                                                       \
    KL_K2_LAUNCH(D, 0);                                                     \
    break;
  switch (k + 1 + m_eq) {
    KL_K2_CASE(2) KL_K2_CASE(3) KL_K2_CASE(4) KL_K2_CASE(5) KL_K2_CASE(6)
    KL_K2_CASE(7) KL_K2_CASE(8) KL_K2_CASE(9) KL_K2_CASE(10) KL_K2_CASE(11)
    KL_K2_CASE(12) KL_K2_CASE(13) KL_K2_CASE(14) KL_K2_CASE(15)
    KL_K2_CASE(16)
    default:
      return cudaErrorInvalidValue;
  }
#undef KL_K2_CASE
#undef KL_K2_LAUNCH
  return cudaGetLastError();
}

#endif

const char* kl_dual_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
