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
// one pass over the n coordinates that accumulates dim(dim+3)/2 sums, a
// second pass for the n_ls line-search candidates, the fallback candidate
// and (dim > 8) the projected candidate, and between them the sums'
// reductions and a dim x dim solve in scalar code.  The rows stay in the
// 50 MB L2 (a shared, stride-0 matrix in L1) and the arithmetic is a few
// hundred MFLOP, so no shape is bound by bytes or FLOPs: a shape is bound
// by the instructions an SM issues (many short instances: the reductions
// and the scalar solve, which grow as dim^2 and dim^3) or by one
// instance's dependent chain of loads and exps (few long instances).
//
// Three paths, chosen by shape in the C launchers (held_shape,
// group_warps, kWarpLoopMaxDimF64; ../kl_dual.py's path_of mirrors them).
//
// Held (kl_dual_kernel, NC = kHeldNC): f32 rows, dual dim <= kHeldMaxDim,
// no extra equality rows and n <= 32 NC, which covers the main shape n =
// 100, dim 3.  One warp per instance, four a block; every reduction is a
// register butterfly (__shfl_xor_sync) and every lane then solves the small
// system redundantly, so nothing is broadcast.  A lane loads the rows and
// the log prior of its NC coordinates i = 32 c + lane once, before the step
// loop, and keeps them in registers; each pass is a fully unrolled loop over
// c < NC with no load in it, pass 2 reuses pass 1's y = exp(-B'z - 1 + lp),
// the epilogues compute their exp once, and k = DIM - 1 is a compile-time
// value.  At the main shape it keeps the SMs' schedulers busy most of the
// time: what is left to gain there is fewer instructions.
//
// Group (kl_dual_group_kernel, kl_dual_cert_group_kernel; every other
// shape: dual dims 9-16, extra equality rows, n > 128, f64).  What bounds
// the old one-warp loop there: at few long instances (100 x n = 10,000)
// one warp's serial walk over n / 32 coordinates on 25 of 132 SMs; at the
// wide dims the small solve, which every lane ran in full (at dim 16 three
// fifths of the time, with spill).  Design: one instance per group of G
// warps, G the least power of two with 32 G kGroupNC >= n or with B G >=
// kGroupFillWarps (the card is full), at most kGroupMaxWarps
// (kGroupWideMaxWarps past dual dim kGroupWideDim); a block holds max(1,
// kGroupBlockWarps / G) instances.  Thread t of a group walks the
// coordinates i = t, t + 32 G, ... (the rows from L1 / L2), so a long
// instance spreads over up to 16 warps of one SM.  The sums of a pass are
// reduced once: each warp reduce-scatters its lanes' partials (recursive
// halving, lane pairs swap halves: about N shuffles for N sums where a
// butterfly takes 5 N), writes them to shared memory, and for G > 1 warp 0
// adds the group's rows after one __syncthreads.  Warp 0 alone then solves
// the small system, once per instance: for dim <= 3 the closed form in
// every lane, from dim kWarpSolveMinDim a Cholesky in the Crout order of
// solve_small with lane i holding row i (the same operations in the same
// order, so the same sick flag and dz as solve_small on the same matrix),
// the substitutions by shuffles, the curvature dz'M dz from the lanes'
// rows.  Warp 0 runs the step's decision code and keeps what it carries
// across pass 2 in shared memory (not in every thread's registers); z, dz
// (and zpr) reach the group's other warps through shared memory.  k is a
// runtime value, tested as a predicate (never as an index) to keep arrays
// in registers.  An f32 lane that adds more than kGroupCompTerms terms a
// sum compensates the sums of the value and the gradient (LaneSum); each
// pass is built both ways and the launch picks one.  Registers set the
// blocks an SM holds, so the launch bounds differ by shape: f32 one-warp
// groups at the narrow dims have an instance of their own at 64 registers
// (kGroupOneMinBlocks), the wide f32 dims up to kGroupTwoBlocksK1 /
// kGroupTwoBlocksK2 two blocks of 256 threads an SM.
//
// Warp loop (kl_dual_kernel, NC = 0): K1 in f64 at dual dims <=
// kWarpLoopMaxDimF64 where the group path would run one-warp groups keeps
// the first design, one warp per instance that re-reads its rows every
// pass and reduces by butterflies; there it measured faster than one-warp
// groups.
//
// One copy of the decision code.  Every path calls step_grad, hess_entry,
// step_ray and step_take (K2's polish: polish_grad, polish_entry,
// polish_take) on its reduced sums, so a guard ported from the reference
// (the sick flag and its Jacobi direction, the trust cap, the fallback and
// projected candidates, the boundary-jam purge, the dead-lane rule, the
// polish's no-step guard) cannot drift apart between them.
//
// Numerics follow the reference: IEEE exp/log/div/sqrt (no fast math, no
// flush to zero), NaN-propagating min/max like jnp.maximum, and the same
// order of operations per lane (built with --fmad=false).  Sums over the
// lanes are reduced in a tree that nothing forces to pair the partial sums
// as the plain version's row sums do, so chip_smoke.py and
// tests/test_torch_cuda.py hold the kernels to the plain versions by a
// tolerance, not bit for bit.  K2 runs the K1 f32 device code, then the
// warm polish and the certificate in native f64, where the TPU kernel used
// double-single pairs.  Its epilogue also writes the Solution's
// per-instance leaves (CertLeaves: the stall flag by the route's rule and
// the constant leaves), so that a certified call launches K2 alone; the
// finiteness of x that the flag needs is a warp vote, on the group path
// gathered from the group's warps beside the last reduction's sums.
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
#include <type_traits>

namespace {

constexpr int kMaxLs = 8;          // line-search levels with accumulators
constexpr int kWarpsPerBlock = 4;  // held path: instances (warps) a block
constexpr int kHeldNC = 4;         // coordinates a lane holds (n <= 32 NC)
constexpr int kHeldMaxDim = 8;     // widest dual dim with a held path
constexpr int kCopyMaxDim = 5;     // newton_z copies w, z up to this dim
// K1 in f64 up to this dual dim keeps the warp loop (newton_z with NC = 0:
// one warp an instance, the rows re-read each pass) where the group path
// would run one-warp groups (G = 1), on which the warp loop measured faster
constexpr int kWarpLoopMaxDimF64 = 4;
// group path: G is the least power of two with 32 G kGroupNC >= n or B G
// >= kGroupFillWarps (the card is full), at most kGroupMaxWarps at dual
// dims <= kGroupWideDim (512 threads a block, 128 registers a thread) and
// kGroupWideMaxWarps above (256, 255); a block
// holds max(1, kGroupBlockWarps / G) instances; warp 0 factors the small
// system cooperatively from dual dim kWarpSolveMinDim (>= 4), every lane
// runs solve_small below it
constexpr int kGroupNC = 4;
constexpr int kGroupFillWarps = 1024;
constexpr int kGroupMaxWarps = 16;
constexpr int kGroupWideDim = 4;
constexpr int kGroupWideMaxWarps = 8;
constexpr int kGroupBlockWarps = 4;
constexpr int kWarpSolveMinDim = 4;
// an f32 group lane compensates its sums (LaneSum) when it adds more than
// kGroupCompTerms terms: a lane's sequential sum of at most 8 terms and the
// reductions' tree (5 levels in a warp, G in order across warps) add no
// more rounding steps than the plain version's pairwise row sums
constexpr int kGroupCompTerms = 8;
// blocks an SM must hold of a group kernel, which caps its registers at
// 65,536 / (threads x blocks): one at dual dims <= kGroupWideDim (512
// threads, 128 registers), except f32 K1 and K2 on one-warp groups (G = 1),
// whose own instance holds kGroupOneMinBlocks blocks of kGroupBlockWarps
// warps (64 registers) up to dual dim kGroupOneMaxDim; above, two for f32
// K1 up to dual dim kGroupTwoBlocksK1 and for K2 up to kGroupTwoBlocksK2
// (256 threads, 128 registers), else one
constexpr int kGroupOneMaxDim = 4;
constexpr int kGroupOneMinBlocks = 8;
constexpr int kGroupTwoBlocksK1 = 12;
constexpr int kGroupTwoBlocksK2 = 9;
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

// A lane's running sum of its coordinates' terms.  A lane that adds many
// terms in turn adds up their rounding errors: on bench.py's family, where
// most terms are equal, to ~1e-5 of the sum at n/32 = 313 terms, which gave
// the f32 dual value a false minimum ~5e-6 below the true one, where a lane
// stopped (gap 1.4e-3 where the plain version's pairwise sums reach
// 2.5e-6).  COMP = true compensates the sum (Kahan; --fmad=false and no
// fast math keep the compiler from folding it away).  The group path in
// f32 compensates the sums of the value and the gradient, whose line search
// and fallback decide the steps; the Hessian's sums only shape the
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

// A held lane's coordinates i = 32 c + lane, c < NC, in registers: the
// rows as TH and the log prior as TL (unset past n).  NC = 0 (the warp
// loop) holds nothing.
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

// body(h, lp, c, i) in T for each of a lane's coordinates i < n, c
// ascending.  Held: unrolled over c < NC.  The warp loop (NC = 0): a
// runtime loop that loads the rows (k at run time), and c is 0.
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

// solve_small's Cholesky for DIM >= 4 by one warp: lane i < DIM holds row i
// of M (mr[b] = M(i, b)) and builds row i of L; lanes past DIM hold a copy of
// the last row and their results are never read.  Each entry is the same
// operations in the same order as solve_small's (every sum over p
// ascending), so the sick flag and dz are its bits on the same M; every lane
// ends with all of dz.
template <int DIM, typename T>
__device__ __forceinline__ bool solve_warp(const T (&mr)[DIM],
                                           const T (&gf)[DIM], T (&dz)[DIM],
                                           int lane) {
  const T eps10 = T(10) * Lim<T>::eps();
  const T tiny = Lim<T>::tiny();
  T Lr[DIM];
  bool sick = false;
#pragma unroll
  for (int j = 0; j < DIM; ++j) {
    // the pivot on lane j, then every lane's L(i, j) for i > j
    T d = mr[j];
#pragma unroll
    for (int p = 0; p < j; ++p) d = d - Lr[p] * Lr[p];
    d = __shfl_sync(kFull, d, j);
    const T mjj = __shfl_sync(kFull, mr[j], j);
    sick = sick || (d <= eps10 * mjj);
    const T ljj = ksqrt(jmax(d, tiny));
    T off = mr[j];
#pragma unroll
    for (int p = 0; p < j; ++p)
      off = off - Lr[p] * __shfl_sync(kFull, Lr[p], j);
    Lr[j] = lane == j ? ljj : off / ljj;
  }
  // forward: y_i on lane i, broadcast
  T yv[DIM];
#pragma unroll
  for (int i = 0; i < DIM; ++i) {
    T s = -gf[i];
#pragma unroll
    for (int p = 0; p < i; ++p) s = s - Lr[p] * yv[p];
    yv[i] = __shfl_sync(kFull, s / Lr[i], i);
  }
  // backward: L(p, i) from lane p, the same sum on every lane
#pragma unroll
  for (int i = DIM - 1; i >= 0; --i) {
    T s = yv[i];
#pragma unroll
    for (int p = i + 1; p < DIM; ++p)
      s = s - __shfl_sync(kFull, Lr[i], p) * dz[p];
    dz[i] = s / __shfl_sync(kFull, Lr[i], i);
  }
  return sick;
}

// ------------------------------------------------ the step's decision code
// shared by both paths, on the reduced sums s_j = sum y B_j, acc_ab = sum y
// B_a B_b and the second pass's sums

// f0 = g(z), the gradient g = w - s, the frozen mask (a lam at 0 whose
// gradient says "decrease") and the masked gradient gf
template <int DIM, typename T>
__device__ __forceinline__ T step_grad(const T (&s)[DIM], const T (&w)[DIM],
                                       const T (&z)[DIM], int k, T (&g)[DIM],
                                       T (&fr)[DIM], T (&gf)[DIM]) {
  const T ry = pick<DIM>(s, k);
  T f0 = ry;
#pragma unroll
  for (int i = 0; i < DIM; ++i) f0 = f0 + w[i] * z[i];
#pragma unroll
  for (int j = 0; j < DIM; ++j) {
    g[j] = w[j] - s[j];
    fr[j] = (j < k && z[j] <= T(0) && g[j] > T(0)) ? T(0) : T(1);
    gf[j] = g[j] * fr[j];
  }
  return f0;
}

// the Hessian's entry (a, b) from its sum, frozen coordinates masked to a
// unit row/col (fr is 0 or 1, so the products are exact in any order)
template <typename T>
__device__ __forceinline__ T hess_entry(T acc, T fra, T frb, bool diag,
                                        T diag_scale) {
  T v = acc * fra * frb;
  if (diag) {
    v = v + (T(1) - fra);
    v = v * diag_scale;
  }
  return v;
}

// After the solve: the Jacobi direction if sick, the guards on dz, the
// fraction-to-boundary and trust caps, the fallback step t* = clip(-g.dz /
// dz'M dz, 0, t_full) and its point zs, and the projected full-step point
// zpr.  diag(j) = M(j, j); curv_of(dz) = dz'M dz.
template <int DIM, typename T, typename Diag, typename Curv>
__device__ __forceinline__ void step_ray(const T (&z)[DIM],
                                         const T (&g)[DIM],
                                         const T (&gf)[DIM], bool sick,
                                         int k, Diag&& diag, Curv&& curv_of,
                                         T (&dz)[DIM], T& t_full, T& t_star,
                                         T (&zs)[DIM], T (&zpr)[DIM]) {
  const T inf = T(INFINITY), tiny = Lim<T>::tiny();
  T dz_inf = T(0), t_bd = inf;
#pragma unroll
  for (int j = 0; j < DIM; ++j) {
    // sick: Jacobi-preconditioned gradient direction instead
    if (sick) dz[j] = -gf[j] / diag(j);
    // a lam already at its bound cannot move down
    if (j < k && z[j] <= T(0) && dz[j] < T(0)) dz[j] = T(0);
    // fraction-to-boundary cap
    if (j < k && dz[j] < T(0)) t_bd = jmin(t_bd, -z[j] / dz[j]);
    dz_inf = jmax(dz_inf, kabs(dz[j]));
  }
  // far-field trust cap of 8 per coordinate
  const T t_trust = T(8) / jmax(dz_inf, T(8));
  t_full = jmin(jclip(t_bd, T(0), T(1)), t_trust);

  // fallback candidate t* = clip(-g.dz / dz'M dz, 0, t_full)
  T q = g[0] * dz[0];
#pragma unroll
  for (int j = 1; j < DIM; ++j) q = q + g[j] * dz[j];
  const T curv = curv_of(dz);
  t_star = jmin(jmax(-q / jmax(curv, tiny), T(0)), t_full);
  const T t_pr = jmin(T(1), t_trust);
#pragma unroll
  for (int j = 0; j < DIM; ++j) {
    zs[j] = z[j] + t_star * dz[j];
    zpr[j] = z[j] + t_pr * dz[j];
    if (j < k) zpr[j] = jmax(zpr[j], T(0));
  }
}

// serial dz'M dz over the packed upper triangle m
template <int DIM, typename T>
__device__ __forceinline__ T curv_packed(const T (&m)[DIM * (DIM + 1) / 2],
                                         const T (&dz)[DIM]) {
  T curv = T(0);
#pragma unroll
  for (int a = 0; a < DIM; ++a) {
#pragma unroll
    for (int b = 0; b < DIM; ++b) {
      const T mab = a <= b ? m[pidx<DIM>(a, b)] : m[pidx<DIM>(b, a)];
      curv = curv + mab * dz[a] * dz[b];
    }
  }
  return curv;
}

// One coordinate's terms of pass 1: s_a += y h_a, acc_ab += y h_a h_b
template <int DIM, typename T, bool KC>
__device__ __forceinline__ void pass1_add(T y, const T (&h)[DIM],
                                          LaneSum<T, KC> (&sl)[DIM],
                                          T (&acc)[DIM * (DIM + 1) / 2]) {
#pragma unroll
  for (int a = 0; a < DIM; ++a) {
    const T ya = y * h[a];
    sl[a].add(ya);
#pragma unroll
    for (int b = a; b < DIM; ++b) acc[pidx<DIM>(a, b)] += ya * h[b];
  }
}

// The second pass's scalars: -t_full / 2^(n_ls-1), -t*, the exponent clip
template <typename T> struct Pass2 {
  T neg_tdeep, neg_tstar, max_e;
  int n_ls;
};

// One coordinate's terms of pass 2: the n_ls candidates along the ray,
// deepest first (one exp, then a squaring per level), the fallback
// candidate's value and gradient, and (DIM > 8) the projected candidate's
// value
template <int DIM, typename T, bool KC>
__device__ __forceinline__ void pass2_add(
    T y, const T (&h)[DIM], T lp, const T (&dz)[DIM], const T (&zpr)[DIM],
    int k, const Pass2<T>& c2, T& cmax, LaneSum<T, KC> (&lsl)[kMaxLs],
    LaneSum<T, KC> (&gsl)[DIM], LaneSum<T, KC>& sprl) {
  const T wdir = bt_of<DIM>(dz, h, k);
  const T e = c2.neg_tdeep * wdir;
  cmax = jmax(cmax, e);
  T efac = kexp(jclip(e, -c2.max_e, c2.max_e));
#pragma unroll
  for (int l = 0; l < kMaxLs; ++l) {
    if (l < c2.n_ls) {
      lsl[l].add(y * efac);
      efac = efac * efac;
    }
  }
  const T ystar = y * kexp(jclip(c2.neg_tstar * wdir, -c2.max_e, c2.max_e));
#pragma unroll
  for (int j = 0; j < DIM; ++j) gsl[j].add(h[j] * ystar);
  if constexpr (DIM > 8) sprl.add(y_of<DIM>(zpr, h, k, lp));
}

// After pass 2: the line search's pick (strict improvement over f0, on
// ties the larger t), the fallback candidate's test, the projected
// candidate (DIM > 8), the boundary snap and the boundary-jam purge; z
// becomes the new iterate.
template <int DIM, typename T>
__device__ __forceinline__ void step_take(
    const T (&ls)[kMaxLs], const T (&gs)[DIM], T cmax, T spr,
    const T (&w)[DIM], const T (&g)[DIM], const T (&dz)[DIM],
    const T (&zs)[DIM], const T (&zpr)[DIM], T f0, T t_full, T t_star,
    const Pass2<T>& c2, T scale_deep, int k, T (&z)[DIM]) {
  const T eps = Lim<T>::eps();
  const T inf = T(INFINITY);
  // a lane whose deepest exponent already clips scores every candidate
  // on a distorted factor: disqualify the whole chain
  const bool chain_bad = cmax > c2.max_e;
  T best_f = f0, tf = T(0), t = t_full * scale_deep;
#pragma unroll
  for (int l = 0; l < kMaxLs; ++l) {
    if (l < c2.n_ls) {
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

// K2's polish (_kl_warm_polish's algebra): the masked gradient, the
// Hessian's entry with a ridge of 1e-13 of the diagonal, and the step: a
// full step capped at the first lam boundary, a snap at 8 eps |z|, and no
// step for a sick, non-finite or |dz| > 1e3 direction
template <int DIM>
__device__ __forceinline__ void polish_grad(const double (&s)[DIM],
                                            const double (&w)[DIM],
                                            const double (&z)[DIM], int k,
                                            double (&fr)[DIM],
                                            double (&gf)[DIM]) {
#pragma unroll
  for (int j = 0; j < DIM; ++j) {
    const double g = w[j] - s[j];
    fr[j] = (j < k && z[j] <= 0.0 && g > 0.0) ? 0.0 : 1.0;
    gf[j] = g * fr[j];
  }
}

__device__ __forceinline__ double polish_entry(double acc, double fra,
                                               double frb, bool diag) {
  double v = acc * fra * frb;
  if (diag) {
    v = v + (1.0 - fra);
    v = v + 1e-13 * v;
  }
  return v;
}

template <int DIM>
__device__ __forceinline__ void polish_take(double (&dz)[DIM], bool sick,
                                            int k, double (&z)[DIM]) {
  const double eps = DBL_EPSILON;
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

// K2's per-instance Solution leaves beside the certificate, so that the
// certified route launches nothing else: stalled by _stalled's rule
// (../kl_dual.py; the not-<= form flags NaN and the dead lane's +inf gap),
// the quiet NaN torch.full writes for the leaves no certified route
// measures, the steps taken, and maxed_out false
struct CertLeaves {
  bool* stalled;
  double* nan;
  long long* iters;
  bool* maxed;
  double tol, tol_feas;
  long long steps;
  __device__ __forceinline__ void write(int b, bool x_finite, double gap,
                                        double ineq, double eq) const {
    stalled[b] = !x_finite ||
                 !(fabs(gap) <= tol && ineq <= tol_feas && eq <= tol_feas);
    nan[b] = __longlong_as_double(0x7ff8000000000000LL);
    iters[b] = steps;
    maxed[b] = false;
  }
};

// ------------------------------------------------------------ held path
// The fixed-schedule active-set projected-Newton loop (the reference's
// _newton_z, pallas_kl_dual.py:245-486), one warp per instance: the held
// path (NC = kHeldNC), and the warp loop (NC = 0) that K1 in f64 keeps at
// the narrow dims (kWarpLoopMaxDimF64).
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
  static_assert(NC > 0 || sizeof(T) == sizeof(double),
                "the warp loop's f32 sums would need compensating");
  const int k = NC > 0 ? DIM - 1 : P.k;
  Held<DIM, NC, T, T> S;
  hold<DIM, NC>(P, lane, S);
  T w_copy[DIM], z_copy[DIM];
  const T(&w)[DIM] = ref_if<copy>(w_copy, w_in);
  T(&z)[DIM] = ref_if<copy>(z_copy, z_out);
  if constexpr (copy) {
#pragma unroll
    for (int j = 0; j < DIM; ++j) w_copy[j] = w_in[j];
  }
  const T max_e = T(0.9) * klog(Lim<T>::maxv());
  const T scale_deep = T(1.0 / double(1 << (n_ls - 1)));
  const T diag_scale = T(1.0 + 10.0 * double(Lim<T>::eps()));
#pragma unroll
  for (int j = 0; j < DIM; ++j) z[j] = z0;

  for (int it = 0; it < n_steps; ++it) {
    // pass 1: y = p exp(-B'z - 1); s_j = sum y B_j; acc_ab = sum y B_a B_b
    LaneSum<T, false> sl[DIM];
    T s[DIM], acc[NP];
#pragma unroll
    for (int a = 0; a < NP; ++a) acc[a] = T(0);
    T ys[NC > 0 ? NC : 1];  // held: pass 1's y, reused by pass 2
    each_coord<DIM, NC, T>(P, lane, S, [&](const T(&h)[DIM], T lp, int c,
                                          int) {
      const T y = y_of<DIM>(z, h, k, lp);
      if constexpr (NC > 0) ys[c] = y;
      pass1_add<DIM>(y, h, sl, acc);
    });
#pragma unroll
    for (int a = 0; a < DIM; ++a) s[a] = warp_sum(sl[a].total());
#pragma unroll
    for (int a = 0; a < NP; ++a) acc[a] = warp_sum(acc[a]);

    T g[DIM], fr[DIM], gf[DIM];
    const T f0 = step_grad<DIM>(s, w, z, k, g, fr, gf);
    T m[NP];
#pragma unroll
    for (int a = 0; a < DIM; ++a) {
#pragma unroll
      for (int b = a; b < DIM; ++b)
        m[pidx<DIM>(a, b)] = hess_entry(acc[pidx<DIM>(a, b)], fr[a], fr[b],
                                        a == b, diag_scale);
    }
    T dz[DIM];
    const bool sick = solve_small<DIM>(m, gf, dz);
    T t_full, t_star, zs[DIM], zpr[DIM];
    step_ray<DIM>(
        z, g, gf, sick, k, [&](int j) { return m[pidx<DIM>(j, j)]; },
        [&](const T(&d)[DIM]) { return curv_packed<DIM>(m, d); }, dz, t_full,
        t_star, zs, zpr);

    // pass 2, on pass 1's y
    const Pass2<T> c2{-(t_full * scale_deep), -t_star, max_e, n_ls};
    LaneSum<T, false> lsl[kMaxLs], gsl[DIM], sprl;
    T ls[kMaxLs], gs[DIM];
    T cmax = -T(INFINITY), spr = T(0);
    each_coord<DIM, NC, T>(P, lane, S, [&](const T(&h)[DIM], T lp, int c,
                                          int) {
      T y;
      if constexpr (NC > 0)
        y = ys[c];
      else
        y = y_of<DIM>(z, h, k, lp);
      pass2_add<DIM>(y, h, lp, dz, zpr, k, c2, cmax, lsl, gsl, sprl);
    });
#pragma unroll
    for (int l = 0; l < kMaxLs; ++l)
      ls[l] = l < n_ls ? warp_sum(lsl[l].total()) : T(0);
#pragma unroll
    for (int j = 0; j < DIM; ++j) gs[j] = warp_sum(gsl[j].total());
    cmax = warp_max(cmax);
    if constexpr (DIM > 8) spr = warp_sum(sprl.total());
    step_take<DIM>(ls, gs, cmax, spr, w, g, dz, zs, zpr, f0, t_full, t_star,
                   c2, scale_deep, k, z);
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

// K1 (held, or the warp loop): the solve, then x = y / sum(y) and the
// measured gap f(x) - g(z)
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
  const int k = NC > 0 ? DIM - 1 : k_rows;
  T w[DIM], z[DIM];
  load_w<DIM>(u, sub, suk, r, srb, srm, b, k, w);
  newton_z<DIM, NC>(P, w, z, n_steps, z0, n_ls, lane);

  Held<DIM, NC, T, T> S;
  hold<DIM, NC>(P, lane, S);
  T ys[NC > 0 ? NC : 1];  // held: the exp serves sum(y) and x
  T syl = T(0), fpl = T(0);
  each_coord<DIM, NC, T>(P, lane, S, [&](const T(&h)[DIM], T lp, int c, int) {
    const T y = y_of<DIM>(z, h, k, lp);
    if constexpr (NC > 0) ys[c] = y;
    syl += y;
  });
  const T sy = warp_sum(syl);
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
    fpl += xi * (klog(xi > T(0) ? xi : T(1)) - lp);
  });
  const T fp = warp_sum(fpl);
  if (lane == 0) {
    T val = sy;
#pragma unroll
    for (int j = 0; j < DIM; ++j) val = val + w[j] * z[j];
    gap[b] = dead ? T(INFINITY) : fp + val;
#pragma unroll
    for (int j = 0; j < DIM; ++j) zout[(long long)b * DIM + j] = z[j];
  }
}

// K2 polish (held): one warm projected-Newton step in f64
template <int DIM, int NC>
__device__ void polish_step(const Rows<float, double>& P,
                            const Held<DIM, NC, float, double>& S,
                            const double (&w)[DIM], double (&z)[DIM],
                            int lane) {
  constexpr int NP = DIM * (DIM + 1) / 2;
  constexpr int k = DIM - 1;
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
  double fr[DIM], gf[DIM], m[NP], dz[DIM];
  polish_grad<DIM>(s, w, z, k, fr, gf);
#pragma unroll
  for (int a = 0; a < DIM; ++a) {
#pragma unroll
    for (int b = a; b < DIM; ++b)
      m[pidx<DIM>(a, b)] =
          polish_entry(acc[pidx<DIM>(a, b)], fr[a], fr[b], a == b);
  }
  const bool sick = solve_small<DIM>(m, gf, dz);
  polish_take<DIM>(dz, sick, k, z);
}

// K2 (held): the K1 f32 solve, polish_steps f64 polish steps, and the f64
// certificate (x, gap, ineq_res, eq_res) from one exp pass, with the
// Solution's leaves
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
                    int n_ls, int polish_steps, const CertLeaves leaves) {
  const int b = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (b >= B) return;
  const Rows<float, double> P{H + b * sHb, sHk, A + b * sAb, sAm, logp, n,
                              k_rows};
  constexpr int k = DIM - 1;
  float w32[DIM], z32[DIM];
  load_w<DIM>(u, sub, suk, r, srb, srm, b, k, w32);
  newton_z<DIM, NC>(P, w32, z32, n_steps, z0, n_ls, lane);
  double w[DIM], z[DIM];
#pragma unroll
  for (int j = 0; j < DIM; ++j) {
    w[j] = double(w32[j]);
    z[j] = double(z32[j]);
  }
  // the rows stay f32 (half the registers) and lift to f64, exactly, at
  // each use
  Held<DIM, NC, float, double> S;
  hold<DIM, NC>(P, lane, S);
  for (int s = 0; s < polish_steps; ++s)
    polish_step<DIM, NC>(P, S, w, z, lane);

  double ys[NC];  // the exp serves sum(y) and x
  double sy = 0.0;
  each_coord<DIM, NC, double>(P, lane, S, [&](const double(&h)[DIM],
                                             double lp, int c, int) {
    const double y = y_of<DIM>(z, h, k, lp);
    ys[c] = y;
    sy += y;
  });
  sy = warp_sum(sy);
  const bool dead = sy <= 0.0;
  const double den = dead ? 1.0 : sy;
  double xbtz = 0.0, hx[DIM], nmax = -INFINITY;
#pragma unroll
  for (int j = 0; j < DIM; ++j) hx[j] = 0.0;
  bool xfin = true;
  double* xb = x + (long long)b * n;
  each_coord<DIM, NC, double>(P, lane, S, [&](const double(&h)[DIM],
                                             double lp, int c, int i) {
    const double btz = bt_of<DIM>(z, h, k);
    const double xi = ys[c] / den;
    xb[i] = xi;
    xfin = xfin && isfinite(xi);
    xbtz += xi * btz;
#pragma unroll
    for (int j = 0; j < DIM; ++j) hx[j] += xi * h[j];
    nmax = jmax(nmax, -xi);
  });
  xbtz = warp_sum(xbtz);
#pragma unroll
  for (int j = 0; j < DIM; ++j) hx[j] = warp_sum(hx[j]);
  nmax = warp_max(nmax);
  xfin = __all_sync(kFull, xfin);
  if (lane == 0) {
    double wz = w[0] * z[0];
#pragma unroll
    for (int j = 1; j < DIM; ++j) wz = wz + w[j] * z[j];
    // log x - log p = -B'z - 1 - log sum(y): one scalar log
    const double f_ref = -xbtz - 1.0 - log(sy);
    const double g = dead ? INFINITY : f_ref + (wz + sy);
    gap[b] = g;
    double viol = jmax(nmax, 0.0), eqr = fabs(pick<DIM>(hx, k) - 1.0);
#pragma unroll
    for (int j = 0; j < DIM; ++j) {
      if (j < k) viol = jmax(viol, jmax(hx[j] - w[j], 0.0));
      if (j > k) eqr = jmax(eqr, fabs(hx[j] - w[j]));
    }
    ineq[b] = viol;
    eq[b] = eqr;
    leaves.write(b, xfin, g, viol, eqr);
#pragma unroll
    for (int j = 0; j < DIM; ++j) zout[(long long)b * DIM + j] = z[j];
  }
}

// ----------------------------------------------------------- group path
// G's cap at a dual dim
__host__ __device__ constexpr int group_max_warps(int dim) {
  return dim <= kGroupWideDim ? kGroupMaxWarps : kGroupWideMaxWarps;
}
// a group block's most threads (its shared memory is sized for them), and
// the launch bounds of an instance: ONE, one-warp groups only
template <int DIM> __host__ __device__ constexpr int group_block_threads() {
  return 32 * (group_max_warps(DIM) > kGroupBlockWarps ? group_max_warps(DIM)
                                                       : kGroupBlockWarps);
}
template <int DIM, bool ONE>
__host__ __device__ constexpr int group_bound_threads() {
  return ONE ? 32 * kGroupBlockWarps : group_block_threads<DIM>();
}
// MAXDIM: kGroupTwoBlocksK1 (K1 f32), kGroupTwoBlocksK2 (K2) or 0 (f64)
template <int DIM, int MAXDIM, bool ONE>
__host__ __device__ constexpr int group_min_blocks() {
  return ONE ? kGroupOneMinBlocks
             : (DIM > kGroupWideDim && DIM <= MAXDIM ? 2 : 1);
}

// f(std::true_type) if a lane's sums are compensated, else
// f(std::false_type): each pass is built both ways, and the launch's n
// and G pick one
template <typename F>
__device__ __forceinline__ void with_comp(bool comp, F&& f) {
  if (comp)
    f(std::true_type{});
  else
    f(std::false_type{});
}
// entries of a warp's row of partial sums: pass 1's s and acc, pass 2's
// line-search values, gradient, projected value and chain max
template <int DIM> __host__ __device__ constexpr int group_row() {
  return DIM + DIM * (DIM + 1) / 2 > kMaxLs + DIM + 2
             ? DIM + DIM * (DIM + 1) / 2
             : kMaxLs + DIM + 2;
}
// a group's area in shared memory: dz, zpr and the second pass's scalars,
// z, and warp 0's w, g, zs, f0, t_full and t_star (newton_group)
template <int DIM> __host__ __device__ constexpr int group_bcast() {
  return 6 * DIM + 5;
}

// Where a thread sits: its lane, its warp in the group and in the block,
// and the group's G warps; thread t = 32 warp + lane walks i = t, t + 32 G.
struct Grp {
  int lane, warp, wblk, G;
  __device__ __forceinline__ int t() const { return 32 * warp + lane; }
  __device__ __forceinline__ int stride() const { return 32 * G; }
};

// Reduce-scatter of a warp's lanes' partials v[0, S) by recursive halving:
// at offset O a lane keeps one half (the upper if its lane bit O is set)
// and adds its partner's copy of that half, so after the five offsets each
// lane holds the sums of a few entries, which it writes to out.  An odd
// half is padded with a zero; cnt counts a lane's entries that are not
// padding.
template <int S, int O, typename T>
__device__ __forceinline__ void rs_round(const T (&v)[S], int lane, int off,
                                         int cnt, T* out) {
  if constexpr (O == 0) {
#pragma unroll
    for (int j = 0; j < S; ++j)
      if (j < cnt) out[off + j] = v[j];
  } else {
    constexpr int H = (S + 1) / 2;
    const bool up = (lane & O) != 0;
    T nv[H];
#pragma unroll
    for (int j = 0; j < H; ++j) {
      const T lo = v[j];
      const T hi = H + j < S ? v[H + j < S ? H + j : 0] : T(0);
      const T got = __shfl_xor_sync(kFull, up ? lo : hi, O);
      nv[j] = (up ? hi : lo) + got;
    }
    const int keep = up ? cnt - H : (cnt < H ? cnt : H);
    rs_round<H, O / 2>(nv, lane, up ? off + H : off, keep > 0 ? keep : 0,
                       out);
  }
}

// Sums v[0, E) over the group's threads (and, with MAX, the max of mx as
// entry E).  Each warp reduce-scatters into its row of part; for G > 1 warp
// 0 then adds the group's rows in order (compensated) after one
// __syncthreads.  The totals are at group_fin(...), for warp 0 of the group
// to read (all of a one-warp group).
template <int E, bool MAX, typename T>
__device__ __forceinline__ void group_reduce(const Grp& g, T (&v)[E], T mx,
                                             T* part, int row_len) {
  __syncwarp();  // the warp's reads of its row's last totals are done
  T* row = part + g.wblk * row_len;
  rs_round<E, 16>(v, g.lane, 0, E, row);
  if constexpr (MAX) {
    mx = warp_max(mx);
    if (g.lane == 0) row[E] = mx;
  }
  if (g.G == 1) {
    __syncwarp();
    return;
  }
  __syncthreads();
  if (g.warp == 0) {
    for (int e = g.lane; e < E + (MAX ? 1 : 0); e += 32) {
      if (MAX && e == E) {
        T m = row[e];
        for (int w = 1; w < g.G; ++w) m = jmax(m, row[w * row_len + e]);
        row[e] = m;
      } else {
        LaneSum<T, true> acc;
        for (int w = 0; w < g.G; ++w) acc.add(row[w * row_len + e]);
        row[e] = acc.total();
      }
    }
    __syncwarp();
  }
}

template <typename T>
__device__ __forceinline__ const T* group_fin(const Grp& g, const T* part,
                                              int row_len) {
  return part + (g.wblk - g.warp) * row_len;
}

// The sum of one value over the group, in every thread of it
template <typename T>
__device__ __forceinline__ T group_sum1(const Grp& g, T v, T* part,
                                        int row_len, T* bc) {
  T vv[1] = {v};
  group_reduce<1, false>(g, vv, T(0), part, row_len);
  const T* fin = group_fin(g, part, row_len);
  if (g.G == 1) return fin[0];
  if (g.warp == 0 && g.lane == 0) bc[0] = fin[0];
  __syncthreads();
  return bc[0];
}

// warp 0's results to the group's other warps: lane 0 of warp 0 writes
// v[0, N) to bc, the others read them after one __syncthreads
template <int N, typename T>
__device__ __forceinline__ void group_bcast(const Grp& g, T (&v)[N], T* bc) {
  if (g.G == 1) return;
  if (g.warp == 0 && g.lane == 0) {
#pragma unroll
    for (int j = 0; j < N; ++j) bc[j] = v[j];
  }
  __syncthreads();
  if (g.warp != 0) {
#pragma unroll
    for (int j = 0; j < N; ++j) v[j] = bc[j];
  }
}

// The masked Hessian in warp 0 and its solve.  Below kWarpSolveMinDim
// every lane holds all of it and runs solve_small (the closed form at DIM
// <= 3); from it lane i holds row i and the warp factors it (solve_warp).
template <int DIM, typename T> struct WarpHess {
  static constexpr bool kWhole = DIM < kWarpSolveMinDim;
  static constexpr int NP = DIM * (DIM + 1) / 2;
  T m[kWhole ? NP : DIM];
  int lane;

  template <typename Entry>
  __device__ __forceinline__ WarpHess(const T* acc, const T (&fr)[DIM],
                                      int lane_, Entry&& entry)
      : lane(lane_) {
    if constexpr (kWhole) {
#pragma unroll
      for (int a = 0; a < DIM; ++a) {
#pragma unroll
        for (int b = a; b < DIM; ++b)
          m[pidx<DIM>(a, b)] =
              entry(acc[pidx<DIM>(a, b)], fr[a], fr[b], a == b);
      }
    } else {
      const int i = lane < DIM ? lane : DIM - 1;
      const T fri = pick<DIM>(fr, i);
#pragma unroll
      for (int b = 0; b < DIM; ++b)
        m[b] = entry(acc[i <= b ? pidx<DIM>(i, b) : pidx<DIM>(b, i)], fri,
                     fr[b], i == b);
    }
  }
  __device__ __forceinline__ bool solve(const T (&gf)[DIM],
                                        T (&dz)[DIM]) const {
    if constexpr (kWhole)
      return solve_small<DIM>(m, gf, dz);
    else
      return solve_warp<DIM>(m, gf, dz, lane);
  }
  __device__ __forceinline__ T diag(int j) const {
    if constexpr (kWhole)
      return m[pidx<DIM>(j, j)];
    else
      return __shfl_sync(kFull, m[j], j);
  }
  // dz'M dz: serial (whole), else lane i's (M dz)_i dz_i over the lanes
  __device__ __forceinline__ T curv(const T (&dz)[DIM]) const {
    if constexpr (kWhole) {
      return curv_packed<DIM>(m, dz);
    } else {
      T r = T(0);
#pragma unroll
      for (int b = 0; b < DIM; ++b) r = r + m[b] * dz[b];
      return warp_sum(lane < DIM ? pick<DIM>(dz, lane) * r : T(0));
    }
  }
};

// The Newton loop of the group path: the same algebra as newton_z, with
// the sums reduced once a pass over the group and the decision code run
// by warp 0.  A warp's row of part is RL entries of T at stride RL (in T);
// bc is the group's area of group_bcast<DIM>() entries: dz, zpr and the
// second pass's scalars, z, then what warp 0 keeps across pass 2 (w, g,
// zs, f0, t_full, t_star), in shared memory rather than in the registers
// of every thread.  __noinline__ as newton_z: inlined, K1 and K2 at dual
// dims 2-8 failed the plain check on the card with z barely moved.
template <int DIM, typename T, typename R, typename LP>
__device__ __noinline__ void newton_group(const Rows<R, LP>& P, const Grp& g,
                                          T* part, int RL, T* bc,
                                          const T (&w_in)[DIM],
                                          T (&z_out)[DIM], int n_steps, T z0,
                                          int n_ls) {
  constexpr int NP = DIM * (DIM + 1) / 2;
  const bool comp = sizeof(T) == sizeof(float) &&
                    P.n > kGroupCompTerms * g.stride();
  T* const keep = bc + 3 * DIM + 2;  // w, g, zs, f0, t_full, t_star
  const int k = P.k;
  T z[DIM];
#pragma unroll
  for (int j = 0; j < DIM; ++j) z[j] = z0;
  if (g.warp == 0 && g.lane == 0) {
#pragma unroll
    for (int j = 0; j < DIM; ++j) keep[j] = w_in[j];
  }
  const T max_e = T(0.9) * klog(Lim<T>::maxv());
  const T scale_deep = T(1.0 / double(1 << (n_ls - 1)));
  const T diag_scale = T(1.0 + 10.0 * double(Lim<T>::eps()));
  const T* fin = group_fin(g, part, RL);

  for (int it = 0; it < n_steps; ++it) {
    // pass 1
    T v1[DIM + NP];
    with_comp(comp, [&](auto kc) {
      LaneSum<T, decltype(kc)::value> sl[DIM];
      T acc[NP];
#pragma unroll
      for (int a = 0; a < NP; ++a) acc[a] = T(0);
      for (int i = g.t(); i < P.n; i += g.stride()) {
        T h[DIM], lp;
        load_lane<DIM>(P, k, i, h, lp);
        pass1_add<DIM>(y_of<DIM>(z, h, k, lp), h, sl, acc);
      }
#pragma unroll
      for (int a = 0; a < DIM; ++a) v1[a] = sl[a].total();
#pragma unroll
      for (int a = 0; a < NP; ++a) v1[DIM + a] = acc[a];
    });
    group_reduce<DIM + NP, false>(g, v1, T(0), part, RL);

    // warp 0: the gradient, the solve and the ray; the group gets dz, zpr
    // and the second pass's scalars
    T bcv[2 * DIM + 2];
    if (g.warp == 0) {
      T w[DIM], s[DIM], gv[DIM], fr[DIM], gf[DIM], dz[DIM], zs[DIM],
          zpr[DIM], t_full, t_star;
#pragma unroll
      for (int a = 0; a < DIM; ++a) {
        w[a] = keep[a];
        s[a] = fin[a];
      }
      const T f0 = step_grad<DIM>(s, w, z, k, gv, fr, gf);
      const WarpHess<DIM, T> M(fin + DIM, fr, g.lane,
                               [&](T a, T fa, T fb, bool d) {
                                 return hess_entry(a, fa, fb, d, diag_scale);
                               });
      T dg[DIM];
#pragma unroll
      for (int j = 0; j < DIM; ++j) dg[j] = M.diag(j);
      const bool sick = M.solve(gf, dz);
      step_ray<DIM>(
          z, gv, gf, sick, k, [&](int j) { return dg[j]; },
          [&](const T(&d)[DIM]) { return M.curv(d); }, dz, t_full, t_star,
          zs, zpr);
      if (g.lane == 0) {
#pragma unroll
        for (int j = 0; j < DIM; ++j) {
          keep[DIM + j] = gv[j];
          keep[2 * DIM + j] = zs[j];
        }
        keep[3 * DIM] = f0;
        keep[3 * DIM + 1] = t_full;
        keep[3 * DIM + 2] = t_star;
      }
#pragma unroll
      for (int j = 0; j < DIM; ++j) {
        bcv[j] = dz[j];
        bcv[DIM + j] = zpr[j];
      }
      bcv[2 * DIM] = -(t_full * scale_deep);
      bcv[2 * DIM + 1] = -t_star;
    }
    group_bcast<2 * DIM + 2>(g, bcv, bc);
    T dz[DIM], zpr[DIM];
#pragma unroll
    for (int j = 0; j < DIM; ++j) {
      dz[j] = bcv[j];
      zpr[j] = bcv[DIM + j];
    }
    const Pass2<T> c2{bcv[2 * DIM], bcv[2 * DIM + 1], max_e, n_ls};

    // pass 2
    T v2[kMaxLs + DIM + 1], cmax = -T(INFINITY);
    with_comp(comp, [&](auto kc) {
      LaneSum<T, decltype(kc)::value> lsl[kMaxLs], gsl[DIM], sprl;
      for (int i = g.t(); i < P.n; i += g.stride()) {
        T h[DIM], lp;
        load_lane<DIM>(P, k, i, h, lp);
        pass2_add<DIM>(y_of<DIM>(z, h, k, lp), h, lp, dz, zpr, k, c2, cmax,
                       lsl, gsl, sprl);
      }
#pragma unroll
      for (int l = 0; l < kMaxLs; ++l)
        v2[l] = l < n_ls ? lsl[l].total() : T(0);
#pragma unroll
      for (int j = 0; j < DIM; ++j) v2[kMaxLs + j] = gsl[j].total();
      v2[kMaxLs + DIM] = sprl.total();
    });
    group_reduce<kMaxLs + DIM + 1, true>(g, v2, cmax, part, RL);

    // warp 0: the pick and the new z, to the group
    if (g.warp == 0) {
      T ls[kMaxLs], gs[DIM], w[DIM], gv[DIM], zs[DIM];
#pragma unroll
      for (int l = 0; l < kMaxLs; ++l) ls[l] = fin[l];
#pragma unroll
      for (int j = 0; j < DIM; ++j) {
        gs[j] = fin[kMaxLs + j];
        w[j] = keep[j];
        gv[j] = keep[DIM + j];
        zs[j] = keep[2 * DIM + j];
      }
      const T spr = DIM > 8 ? fin[kMaxLs + DIM] : T(0);
      step_take<DIM>(ls, gs, fin[kMaxLs + DIM + 1], spr, w, gv, dz, zs, zpr,
                     keep[3 * DIM], keep[3 * DIM + 1], keep[3 * DIM + 2], c2,
                     scale_deep, k, z);
    }
    group_bcast<DIM>(g, z, bc + 2 * DIM + 2);
  }
#pragma unroll
  for (int j = 0; j < DIM; ++j) z_out[j] = z[j];
}

// the group of a block's thread; an instance past B repeats instance B - 1
// (the block's barriers stay uniform) and writes nothing
struct GroupAt {
  Grp g;
  int b, gi;
  bool live;
};
__device__ __forceinline__ GroupAt group_at(int G, int B) {
  const int wblk = threadIdx.x >> 5;
  const int per = blockDim.x / (32 * G);
  GroupAt at;
  at.g = Grp{int(threadIdx.x & 31), wblk % G, wblk, G};
  at.gi = wblk / G;
  at.b = blockIdx.x * per + at.gi;
  at.live = at.b < B;
  if (!at.live) at.b = B - 1;
  return at;
}

// K1 (group): the solve, then x = y / sum(y) and the measured gap
template <int DIM, typename T, bool ONE>
__global__ void __launch_bounds__(
    group_bound_threads<DIM, ONE>(),
    group_min_blocks<DIM,
                     sizeof(T) == sizeof(float) ? kGroupTwoBlocksK1 : 0,
                     ONE>())
kl_dual_group_kernel(const T* __restrict__ H, const T* __restrict__ u,
                     const T* __restrict__ A, const T* __restrict__ r,
                     const T* __restrict__ logp, long long sHb, long long sHk,
                     long long sub, long long suk, long long sAb,
                     long long sAm, long long srb, long long srm,
                     T* __restrict__ x, T* __restrict__ gap,
                     T* __restrict__ zout, int B, int n, int k_rows,
                     int n_steps, T z0, int n_ls, int G) {
  constexpr int RL = group_row<DIM>(), BC = group_bcast<DIM>();
  __shared__ T part[group_block_threads<DIM>() / 32 * RL];
  __shared__ T bcast[kGroupBlockWarps * BC];
  const GroupAt at = group_at(G, B);
  const Grp& g = at.g;
  const int b = at.b;
  T* bc = bcast + at.gi * BC;
  const Rows<T, T> P{H + b * sHb, sHk, A + b * sAb, sAm, logp, n, k_rows};
  const int k = k_rows;
  T w[DIM], z[DIM];
  load_w<DIM>(u, sub, suk, r, srb, srm, b, k, w);
  newton_group<DIM>(P, g, part, RL, bc, w, z, n_steps, z0, n_ls);

  const bool comp =
      sizeof(T) == sizeof(float) && n > kGroupCompTerms * g.stride();
  T sy = T(0), fp = T(0);
  with_comp(comp, [&](auto kc) {
    LaneSum<T, decltype(kc)::value> syl;
    for (int i = g.t(); i < n; i += g.stride()) {
      T h[DIM], lp;
      load_lane<DIM>(P, k, i, h, lp);
      syl.add(y_of<DIM>(z, h, k, lp));
    }
    sy = syl.total();
  });
  sy = group_sum1(g, sy, part, RL, bc);
  // sum(y) underflowed to 0 (the unbounded dual of an infeasible
  // instance): the gap is +inf instead of NaN
  const bool dead = sy <= T(0);
  const T den = dead ? T(1) : sy;
  T* xb = x + (long long)b * n;
  with_comp(comp, [&](auto kc) {
    LaneSum<T, decltype(kc)::value> fpl;
    for (int i = g.t(); i < n; i += g.stride()) {
      T h[DIM], lp;
      load_lane<DIM>(P, k, i, h, lp);
      const T xi = y_of<DIM>(z, h, k, lp) / den;
      if (at.live) xb[i] = xi;
      fpl.add(xi * (klog(xi > T(0) ? xi : T(1)) - lp));
    }
    fp = fpl.total();
  });
  T v[1] = {fp};
  group_reduce<1, false>(g, v, T(0), part, RL);
  if (at.live && g.warp == 0 && g.lane == 0) {
    T val = sy;
#pragma unroll
    for (int j = 0; j < DIM; ++j) val = val + w[j] * z[j];
    gap[b] = dead ? T(INFINITY) : group_fin(g, part, RL)[0] + val;
#pragma unroll
    for (int j = 0; j < DIM; ++j) zout[(long long)b * DIM + j] = z[j];
  }
}

// K2 polish (group): one warm f64 step, the pass's sums reduced once, the
// system solved by warp 0, the new z broadcast
template <int DIM>
__device__ void polish_group(const Rows<float, double>& P, const Grp& g,
                             double* part, double* bc,
                             const double (&w)[DIM], double (&z)[DIM]) {
  constexpr int NP = DIM * (DIM + 1) / 2;
  constexpr int RL = group_row<DIM>();
  const int k = P.k;
  const double max_e = 0.9 * log(DBL_MAX);
  double v[DIM + NP];
#pragma unroll
  for (int a = 0; a < DIM + NP; ++a) v[a] = 0.0;
  for (int i = g.t(); i < P.n; i += g.stride()) {
    double h[DIM], lp;
    load_lane<DIM>(P, k, i, h, lp);
    const double y =
        exp(jclip(-bt_of<DIM>(z, h, k) - 1.0 + lp, -max_e, max_e));
#pragma unroll
    for (int a = 0; a < DIM; ++a) {
      const double ya = y * h[a];
      v[a] += ya;
#pragma unroll
      for (int b = a; b < DIM; ++b) v[DIM + pidx<DIM>(a, b)] += ya * h[b];
    }
  }
  group_reduce<DIM + NP, false>(g, v, 0.0, part, RL);
  if (g.warp == 0) {
    const double* fin = group_fin(g, part, RL);
    double s[DIM], fr[DIM], gf[DIM], dz[DIM];
#pragma unroll
    for (int a = 0; a < DIM; ++a) s[a] = fin[a];
    polish_grad<DIM>(s, w, z, k, fr, gf);
    const WarpHess<DIM, double> M(
        fin + DIM, fr, g.lane, [](double a, double fa, double fb, bool d) {
          return polish_entry(a, fa, fb, d);
        });
    const bool sick = M.solve(gf, dz);
    polish_take<DIM>(dz, sick, k, z);
  }
  group_bcast<DIM>(g, z, bc);
}

// K2 (group): the K1 f32 solve, the f64 polish and the certificate, with
// the Solution's leaves
template <int DIM, bool ONE>
__global__ void __launch_bounds__(
    group_bound_threads<DIM, ONE>(),
    group_min_blocks<DIM, kGroupTwoBlocksK2, ONE>())
kl_dual_cert_group_kernel(
    const float* __restrict__ H, const float* __restrict__ u,
    const float* __restrict__ A, const float* __restrict__ r,
    const double* __restrict__ logp, long long sHb, long long sHk,
    long long sub, long long suk, long long sAb, long long sAm,
    long long srb, long long srm, double* __restrict__ x,
    double* __restrict__ zout, double* __restrict__ gap,
    double* __restrict__ ineq, double* __restrict__ eq, int B, int n,
    int k_rows, int n_steps, float z0, int n_ls, int polish_steps,
    const CertLeaves leaves, int G) {
  constexpr int RL = group_row<DIM>(), BC = group_bcast<DIM>();
  // f32 phase and f64 phase share the buffers
  __shared__ double part_d[group_block_threads<DIM>() / 32 * RL];
  __shared__ double bcast_d[kGroupBlockWarps * BC];
  const GroupAt at = group_at(G, B);
  const Grp& g = at.g;
  const int b = at.b;
  const Rows<float, double> P{H + b * sHb, sHk, A + b * sAb, sAm, logp, n,
                              k_rows};
  const int k = k_rows;
  float w32[DIM], z32[DIM];
  load_w<DIM>(u, sub, suk, r, srb, srm, b, k, w32);
  // the f32 rows at the f64 rows' stride, so that no warp's f32 row
  // overlaps another's f64 row (one-warp groups run on unsynchronized)
  newton_group<DIM>(P, g, reinterpret_cast<float*>(part_d), 2 * RL,
                    reinterpret_cast<float*>(bcast_d + at.gi * BC), w32, z32,
                    n_steps, z0, n_ls);
  double* bc = bcast_d + at.gi * BC;
  if (g.G > 1) __syncthreads();  // the f32 phase's last reads are done
  double w[DIM], z[DIM];
#pragma unroll
  for (int j = 0; j < DIM; ++j) {
    w[j] = double(w32[j]);
    z[j] = double(z32[j]);
  }
  for (int s = 0; s < polish_steps; ++s)
    polish_group<DIM>(P, g, part_d, bc, w, z);

  double sy = 0.0;
  for (int i = g.t(); i < n; i += g.stride()) {
    double h[DIM], lp;
    load_lane<DIM>(P, k, i, h, lp);
    sy += y_of<DIM>(z, h, k, lp);
  }
  sy = group_sum1(g, sy, part_d, RL, bc + DIM);
  const bool dead = sy <= 0.0;
  const double den = dead ? 1.0 : sy;
  double v[DIM + 1], nmax = -INFINITY;  // x.B'z, then B_j x
#pragma unroll
  for (int j = 0; j < DIM + 1; ++j) v[j] = 0.0;
  bool xfin = true;
  double* xb = x + (long long)b * n;
  for (int i = g.t(); i < n; i += g.stride()) {
    double h[DIM], lp;
    load_lane<DIM>(P, k, i, h, lp);
    const double btz = bt_of<DIM>(z, h, k);
    const double xi = exp(-btz - 1.0 + lp) / den;
    if (at.live) xb[i] = xi;
    xfin = xfin && isfinite(xi);
    v[0] += xi * btz;
#pragma unroll
    for (int j = 0; j < DIM; ++j) v[1 + j] += xi * h[j];
    nmax = jmax(nmax, -xi);
  }
  // each warp's vote that its x is finite, in its row past the sums and
  // the max, where group_reduce's barrier orders it before warp 0's read
  const int vote = DIM + 2;
  xfin = __all_sync(kFull, xfin);
  if (g.lane == 0) part_d[g.wblk * RL + vote] = xfin ? 1.0 : 0.0;
  group_reduce<DIM + 1, true>(g, v, nmax, part_d, RL);
  if (at.live && g.warp == 0 && g.lane == 0) {
    const double* fin = group_fin(g, part_d, RL);
    bool x_finite = true;
    for (int q = 0; q < g.G; ++q)
      x_finite = x_finite && fin[q * RL + vote] != 0.0;
    double hx[DIM];
#pragma unroll
    for (int j = 0; j < DIM; ++j) hx[j] = fin[1 + j];
    double wz = w[0] * z[0];
#pragma unroll
    for (int j = 1; j < DIM; ++j) wz = wz + w[j] * z[j];
    // log x - log p = -B'z - 1 - log sum(y): one scalar log
    const double f_ref = -fin[0] - 1.0 - log(sy);
    const double gp = dead ? INFINITY : f_ref + (wz + sy);
    gap[b] = gp;
    double viol = jmax(fin[DIM + 1], 0.0), eqr = fabs(pick<DIM>(hx, k) - 1.0);
#pragma unroll
    for (int j = 0; j < DIM; ++j) {
      if (j < k) viol = jmax(viol, jmax(hx[j] - w[j], 0.0));
      if (j > k) eqr = jmax(eqr, fabs(hx[j] - w[j]));
    }
    ineq[b] = viol;
    eq[b] = eqr;
    leaves.write(b, x_finite, gp, viol, eqr);
#pragma unroll
    for (int j = 0; j < DIM; ++j) zout[(long long)b * DIM + j] = z[j];
  }
}

// ------------------------------------------------------------- launchers
constexpr int kThreads = kWarpsPerBlock * 32;

inline int blocks_for(int B) { return (B + kWarpsPerBlock - 1) / kWarpsPerBlock; }

// Which path a shape takes.  Held: f32 rows, a dual dim with a held
// instance, no extra equality rows (k = dim - 1) and an n of which a lane
// can hold its share.  Everything else takes the group path.
template <int DIM> constexpr bool held_dim() { return DIM <= kHeldMaxDim; }
inline bool held_shape(int dim, int k, int n) {
  return k == dim - 1 && n <= 32 * kHeldNC;
}
// The group path's G for B instances of n coordinates: the least power of
// two with 32 G kGroupNC >= n or B G >= kGroupFillWarps, at most the dual
// dim's cap
inline int group_warps(int dim, int n, int B) {
  const int cap = group_max_warps(dim);
  int G = 1;
  while (G < cap && 32 * G * kGroupNC < n &&
         (long long)B * G < kGroupFillWarps)
    G *= 2;
  return G;
}
// instances a group block holds
inline int group_per_block(int G) {
  return G >= kGroupBlockWarps ? 1 : kGroupBlockWarps / G;
}

template <typename T>
cudaError_t launch_k1(int dim, const void* H, const void* u, const void* A,
                      const void* r, const void* logp, long long sHb,
                      long long sHk, long long sub, long long suk,
                      long long sAb, long long sAm, long long srb,
                      long long srm, void* x, void* gap, void* z, int B,
                      int n, int k, int n_steps, double z0, int n_ls,
                      cudaStream_t stream) {
  // K1 in f64 has no held path
  constexpr bool held_type = sizeof(T) == sizeof(float);
  const int G = group_warps(dim, n, B), per = group_per_block(G);
#define KL_K1_ARGS                                                           \
  (const T*)H, (const T*)u, (const T*)A, (const T*)r, (const T*)logp, sHb,   \
      sHk, sub, suk, sAb, sAm, srb, srm, (T*)x, (T*)gap, (T*)z, B, n, k,     \
      n_steps, T(z0), n_ls
#define KL_K1_CASE(D)                                                        \
  case D:                                                                    \
    if constexpr (held_dim<D>() && held_type) {                              \
      if (held_shape(D, k, n)) {                                             \
        kl_dual_kernel<D, kHeldNC, T>                                        \
            <<<blocks_for(B), kThreads, 0, stream>>>(KL_K1_ARGS);            \
        break;                                                               \
      }                                                                      \
    }                                                                        \
    if constexpr (!held_type && D <= kWarpLoopMaxDimF64) {                   \
      if (G == 1) {                                                          \
        kl_dual_kernel<D, 0, T>                                              \
            <<<blocks_for(B), kThreads, 0, stream>>>(KL_K1_ARGS);            \
        break;                                                               \
      }                                                                      \
    }                                                                        \
    if constexpr (held_type && D <= kGroupOneMaxDim) {                       \
      if (G == 1) {                                                          \
        kl_dual_group_kernel<D, T, true>                                     \
            <<<(B + per - 1) / per, 32 * per, 0, stream>>>(KL_K1_ARGS, 1);   \
        break;                                                               \
      }                                                                      \
    }                                                                        \
    kl_dual_group_kernel<D, T, false>                                        \
        <<<(B + per - 1) / per, 32 * G * per, 0, stream>>>(KL_K1_ARGS, G);   \
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
#undef KL_K1_ARGS
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
                           void* ineq, void* eq, void* stalled, void* nan,
                           void* iters, void* maxed, int B, int n, int k,
                           int m_eq, int n_steps, double z0, int n_ls,
                           int polish_steps, double tol, double tol_feas,
                           void* stream) {
  if (n_ls < 1 || n_ls > kMaxLs) return cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int dim = k + 1 + m_eq;
  const int G = group_warps(dim, n, B), per = group_per_block(G);
  const CertLeaves leaves{(bool*)stalled, (double*)nan, (long long*)iters,
                          (bool*)maxed, tol, tol_feas,
                          (long long)n_steps + polish_steps};
#define KL_K2_ARGS                                                          \
  (const float*)H, (const float*)u, (const float*)A, (const float*)r,       \
      (const double*)logp, sHb, sHk, sub, suk, sAb, sAm, srb, srm,          \
      (double*)x, (double*)z, (double*)gap, (double*)ineq, (double*)eq, B,  \
      n, k, n_steps, float(z0), n_ls, polish_steps, leaves
#define KL_K2_CASE(D)                                                       \
  case D:                                                                   \
    if constexpr (held_dim<D>()) {                                          \
      if (held_shape(D, k, n)) {                                            \
        kl_dual_cert_kernel<D, kHeldNC>                                     \
            <<<blocks_for(B), kThreads, 0, st>>>(KL_K2_ARGS);               \
        break;                                                              \
      }                                                                     \
    }                                                                       \
    if constexpr (D <= kGroupOneMaxDim) {                                   \
      if (G == 1) {                                                         \
        kl_dual_cert_group_kernel<D, true>                                  \
            <<<(B + per - 1) / per, 32 * per, 0, st>>>(KL_K2_ARGS, 1);      \
        break;                                                              \
      }                                                                     \
    }                                                                       \
    kl_dual_cert_group_kernel<D, false>                                     \
        <<<(B + per - 1) / per, 32 * G * per, 0, st>>>(KL_K2_ARGS, G);      \
    break;
  switch (dim) {
    KL_K2_CASE(2) KL_K2_CASE(3) KL_K2_CASE(4) KL_K2_CASE(5) KL_K2_CASE(6)
    KL_K2_CASE(7) KL_K2_CASE(8) KL_K2_CASE(9) KL_K2_CASE(10) KL_K2_CASE(11)
    KL_K2_CASE(12) KL_K2_CASE(13) KL_K2_CASE(14) KL_K2_CASE(15)
    KL_K2_CASE(16)
    default:
      return cudaErrorInvalidValue;
  }
#undef KL_K2_CASE
#undef KL_K2_ARGS
  return cudaGetLastError();
}

#endif

const char* kl_dual_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
