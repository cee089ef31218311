// The primal route's measured certificate kl_dual_gap as one kernel on
// Hopper (sm_90a): the least-squares fit of the dual, the line-searched
// projected-Newton polish and the gap.
//
// Replaces no TPU kernel: the reference's kl_dual_gap
// (cvx_tpu/models/dist_kl.py) is plain JAX that XLA fuses.  The plain
// PyTorch version of the same algebra is kl_gap_fused_plain in
// ../kl_gap.py (the fit, duality._polish_dual, the gap); on the card its
// torch ops were ~1,580 small launches a call.
//
// Per instance (B = [H; A] the shared rows, dim = k + p <= 8, w = (u, b),
// R = p / e, lam = z[:k] >= 0):
//
//   fit     c = -(1 + log x - log p),  z = (BB' + ridge I)^-1 B c,  lam >= 0
//   polish  steps x { snap; y = R exp(-B'z); f0, g = w - B y,
//                     H = B diag(y) B'; freeze lam at 0 with g > 0; ridge;
//                     d = -Hf^-1 gf; 9 candidates z + t d (t = 1 ... 1/128
//                     and the exact step to the first lam boundary), each
//                     projected, each one more pass for its value and
//                     projected gradient; strict decrease wins, else a
//                     projected-gradient decrease within the value's noise
//                     band; boundary landings snap to 0 }
//   gap     sum x (log x - log p) + w.z + sum R exp(-B'z)
//
// What bounds it on this card.  At the primal cell (10,000 x n = 100, dim
// 3, 8 steps) an instance is 81 evaluations of -L* (8 steps of a point and
// 9 candidates, and the final value), one exp a coordinate each, ~8,100
// exps and ~1.3 G operations for the fleet (0.02 ms at the f32 peak).  No vector of an instance but x is
// needed: y reads only the shared rows and the prior, so the passes stream
// the same few kB for every instance.  What remains is instructions: the
// exps, the dim-wide dot products, and the reductions of (1 + dim) sums a
// candidate, which the 9 candidates' pass reduces together.
//
// Design.  One warp per instance, kWarps to a block.  A lane owns the
// coordinates i = lane + 32 c.  In f32 at n <= 32 kHeldNC a lane loads its
// rows and R once and keeps them in registers (held); otherwise lanes read
// them from L1 / L2, where they stay resident across the fleet (streamed).
// Measured on the H100 at 10,000 x n = 100: held 0.214 against streamed
// 0.295 ms at f32 dim 3, 0.918 against 1.139 at f32 dim 8, but 0.622
// against 0.503 at f64 dim 3, so f64 always streams; staging the rows in
// shared memory was no faster than L1 / L2 at n = 300 and 1,000 (0.98-1.0x
// the time) and is not done.  z, w, the dim x dim system and the decision code live in
// registers and run redundantly in every lane, so nothing is broadcast and
// every branch is warp-uniform.  A pass's sums are reduce-scattered across
// the warp (recursive halving: about S shuffles for S sums where a
// butterfly takes 5 S) into the warp's row of shared memory, which every
// lane then reads.  The 9 candidates are evaluated in one pass over the
// coordinates (kCands / chunk passes where their z and sums would not fit
// in kChunkWords registers), each coordinate's rows read once for all of
// them.  An f32 lane on the streamed path compensates (Kahan) the sums of
// the value, the gradient and the fit's right-hand side, as K1/K2's group
// path does: a lane's plain sum of hundreds of terms gave the f32 dual a
// false minimum there.  The final two sums, the primal value and sum y at
// the last z, accumulate in f64.
//
// Numerics follow the plain version: IEEE exp/log/div/sqrt (no fast math,
// no flush to zero), NaN-propagating min/max and clamps like torch's, the
// first index on ties and a NaN first like torch.argmin, and the same
// order of operations per coordinate (built with --fmad=false).  The small
// solves are duality._small_solve's branches (the adjugate for dims 1-3, an
// unrolled Cholesky with the f32 tiny pivot floor for dims 4-8), not
// K1/K2's solve_small.  Sums over the coordinates pair their terms in
// another order than torch's reductions and matmuls, so the kernel is held
// to the plain version by a tolerance, not bit for bit.
//
// Interface: plain C, pointers and element strides; the lane axis of H, A,
// x and the prior terms is contiguous, the row strides of H and A and
// every stride of u and b are free.  logp and R are null for the uniform
// prior, whose constants come as lpc and rc.  Each entry launches on the
// given stream and returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cfloat>
#include <cmath>
#include <type_traits>

namespace {

constexpr int kWarps = 4;          // instances (warps) a block
constexpr int kThreads = 32 * kWarps;
constexpr int kHeldNC = 4;         // held path (f32): a lane's coordinates
constexpr int kMaxDim = 8;         // widest dual dim k + p (_MAX_DIM)
constexpr int kCands = 9;          // 1, 1/2, ..., 1/128, the boundary step
// registers (32-bit words) the candidates of one pass may hold for their
// z and their sums; more candidates take more passes
constexpr int kChunkWords = 64;
constexpr unsigned kFull = 0xffffffffu;

template <typename T> struct Lim;
template <> struct Lim<float> {
  static __device__ __forceinline__ float eps() { return FLT_EPSILON; }
};
template <> struct Lim<double> {
  static __device__ __forceinline__ double eps() { return DBL_EPSILON; }
};

__device__ __forceinline__ float kexp(float v) { return expf(v); }
__device__ __forceinline__ double kexp(double v) { return exp(v); }
__device__ __forceinline__ float klog(float v) { return logf(v); }
__device__ __forceinline__ double klog(double v) { return log(v); }
__device__ __forceinline__ float ksqrt(float v) { return sqrtf(v); }
__device__ __forceinline__ double ksqrt(double v) { return sqrt(v); }
__device__ __forceinline__ float kabs(float v) { return fabsf(v); }
__device__ __forceinline__ double kabs(double v) { return fabs(v); }

// torch.maximum / torch.minimum: a NaN in either argument gives NaN
template <typename T> __device__ __forceinline__ T jmax(T a, T b) {
  return (a > b || a != a) ? a : b;
}
template <typename T> __device__ __forceinline__ T jmin(T a, T b) {
  return (a < b || a != a) ? a : b;
}
// torch.clamp_min(v, lo): NaN stays NaN
template <typename T> __device__ __forceinline__ T clamp_lo(T v, T lo) {
  return v < lo ? lo : v;
}

template <typename T> __device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = v + __shfl_xor_sync(kFull, v, o);
  return v;
}

// A lane's running sum; COMP = true compensates it (Kahan; --fmad=false
// and no fast math keep the compiler from folding it away).
template <typename T, bool COMP> struct LaneSum {
  T s = T(0);
  __device__ __forceinline__ void add(T v) { s = s + v; }
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

// Reduce-scatter of a warp's lanes' partials v[0, S) by recursive halving
// (K1/K2's rs_round): at offset O a lane keeps one half (the upper if its
// lane bit O is set) and adds its partner's copy of that half; after the
// five offsets each lane writes the totals it holds to out.  An odd half
// is padded with a zero; cnt counts a lane's entries that are not padding.
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

// Sums v over the warp's lanes into row[0, S); the caller syncs the warp
// before it reads them.
template <int S, typename T>
__device__ __forceinline__ void warp_reduce(const T (&v)[S], int lane,
                                            T* row) {
  rs_round<S, 16>(v, lane, 0, S, row);
}

// duality._small_solve on a symmetric system (packed upper triangle a):
// the adjugate for DIM <= 3, the unrolled Cholesky with the f32 tiny pivot
// floor for DIM 4-8, each in the plain version's order of operations.
template <int DIM, typename T>
__device__ __forceinline__ void small_solve(const T (&a)[DIM * (DIM + 1) / 2],
                                            const T (&b)[DIM], T (&x)[DIM]) {
  auto m = [&](int i, int j) {
    return a[i <= j ? pidx<DIM>(i, j) : pidx<DIM>(j, i)];
  };
  if constexpr (DIM == 1) {
    x[0] = b[0] / m(0, 0);
  } else if constexpr (DIM == 2) {
    const T det = m(0, 0) * m(1, 1) - m(0, 1) * m(1, 0);
    x[0] = (m(1, 1) * b[0] - m(0, 1) * b[1]) / det;
    x[1] = (m(0, 0) * b[1] - m(1, 0) * b[0]) / det;
  } else if constexpr (DIM == 3) {
    const T c00 = m(1, 1) * m(2, 2) - m(1, 2) * m(2, 1);
    const T c01 = m(1, 2) * m(2, 0) - m(1, 0) * m(2, 2);
    const T c02 = m(1, 0) * m(2, 1) - m(1, 1) * m(2, 0);
    const T det = m(0, 0) * c00 + m(0, 1) * c01 + m(0, 2) * c02;
    const T c10 = m(0, 2) * m(2, 1) - m(0, 1) * m(2, 2);
    const T c11 = m(0, 0) * m(2, 2) - m(0, 2) * m(2, 0);
    const T c12 = m(0, 1) * m(2, 0) - m(0, 0) * m(2, 1);
    const T c20 = m(0, 1) * m(1, 2) - m(0, 2) * m(1, 1);
    const T c21 = m(0, 2) * m(1, 0) - m(0, 0) * m(1, 2);
    const T c22 = m(0, 0) * m(1, 1) - m(0, 1) * m(1, 0);
    x[0] = (c00 * b[0] + c10 * b[1] + c20 * b[2]) / det;
    x[1] = (c01 * b[0] + c11 * b[1] + c21 * b[2]) / det;
    x[2] = (c02 * b[0] + c12 * b[1] + c22 * b[2]) / det;
  } else {
    const T tiny = T(FLT_MIN);   // the reference's floor in every dtype
    T L[DIM * (DIM + 1) / 2];    // packed: L(i, j), j <= i, at pidx(j, i)
#pragma unroll
    for (int j = 0; j < DIM; ++j) {
      T d = m(j, j);
#pragma unroll
      for (int p = 0; p < j; ++p)
        d = d - L[pidx<DIM>(p, j)] * L[pidx<DIM>(p, j)];
      const T ljj = ksqrt(clamp_lo(d, tiny));
      L[pidx<DIM>(j, j)] = ljj;
#pragma unroll
      for (int i = j + 1; i < DIM; ++i) {
        T off = m(i, j);
#pragma unroll
        for (int p = 0; p < j; ++p)
          off = off - L[pidx<DIM>(p, i)] * L[pidx<DIM>(p, j)];
        L[pidx<DIM>(j, i)] = off / ljj;
      }
    }
    T y[DIM];
#pragma unroll
    for (int i = 0; i < DIM; ++i) {
      T s = b[i];
#pragma unroll
      for (int p = 0; p < i; ++p) s = s - L[pidx<DIM>(p, i)] * y[p];
      y[i] = s / L[pidx<DIM>(i, i)];
    }
#pragma unroll
    for (int i = DIM - 1; i >= 0; --i) {
      T s = y[i];
#pragma unroll
      for (int p = i + 1; p < DIM; ++p) s = s - L[pidx<DIM>(i, p)] * x[p];
      x[i] = s / L[pidx<DIM>(i, i)];
    }
  }
}

template <typename T> struct GapArgs {
  const T *H, *u, *A, *b, *x, *logp, *R;
  long long sHk, sub, suk, sAk, sbb, sbk, sxb;
  T lpc, rc, band;     // uniform log p and R, the value's noise band
  T *gap, *z;
  int B, n, k, steps;
};

// the candidates a pass evaluates: as many as kChunkWords registers hold
// for their z and their sums, the 9 spread evenly over the passes
template <typename T, int DIM, bool COMP>
__host__ __device__ constexpr int cand_chunk() {
  constexpr int words =
      (DIM + (1 + DIM) * (COMP ? 2 : 1)) * int(sizeof(T) / 4);
  constexpr int passes = (kCands * words + kChunkWords - 1) / kChunkWords;
  return (kCands + passes - 1) / passes;
}

template <typename T, int DIM> __host__ __device__ constexpr int row_len() {
  return kCands * (1 + DIM);
}

template <typename T, int DIM, int NC, bool COMP>
__global__ void __launch_bounds__(kThreads)
    kl_gap_polish_kernel(const GapArgs<T> a) {
  constexpr int P = DIM * (DIM + 1) / 2;
  constexpr int ROW = row_len<T, DIM>();
  constexpr int CH = cand_chunk<T, DIM, COMP>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const red = reinterpret_cast<T*>(smem_raw);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n = a.n, k = a.k;
  T* const row = red + warp * ROW;
  const int b = blockIdx.x * kWarps + warp;
  if (b >= a.B) return;

  // the rows B = [H; A]
  const T* rp[DIM];
#pragma unroll
  for (int i = 0; i < DIM; ++i)
    rp[i] = i < k ? a.H + i * a.sHk : a.A + (i - k) * a.sAk;
  // held: a lane's rows and R in registers (unset past n)
  T hh[NC > 0 ? NC : 1][DIM], rr[NC > 0 ? NC : 1];
  if constexpr (NC > 0) {
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int j = lane + 32 * c;
      if (j < n) {
#pragma unroll
        for (int i = 0; i < DIM; ++i) hh[c][i] = rp[i][j];
        rr[c] = a.R != nullptr ? a.R[j] : a.rc;
      }
    }
  }
  // body(j, h, r) for each of the lane's coordinates j < n, in order
  auto each = [&](auto&& body) {
    if constexpr (NC > 0) {
#pragma unroll
      for (int c = 0; c < NC; ++c)
        if (lane + 32 * c < n) body(lane + 32 * c, hh[c], rr[c]);
    } else {
      for (int j = lane; j < n; j += 32) {
        T h[DIM];
#pragma unroll
        for (int i = 0; i < DIM; ++i) h[i] = rp[i][j];
        body(j, h, a.R != nullptr ? a.R[j] : a.rc);
      }
    }
  };
  // s = (B'z)_j, in the order of z @ B
  auto btz = [](const T (&z)[DIM], const T (&h)[DIM]) {
    T s = z[0] * h[0];
#pragma unroll
    for (int i = 1; i < DIM; ++i) s = s + z[i] * h[i];
    return s;
  };
  auto dot = [](const T (&p)[DIM], const T (&q)[DIM]) {
    T s = p[0] * q[0];
#pragma unroll
    for (int i = 1; i < DIM; ++i) s = s + p[i] * q[i];
    return s;
  };

  T w[DIM];
#pragma unroll
  for (int i = 0; i < DIM; ++i)
    w[i] = i < k ? a.u[b * a.sub + i * a.suk]
                 : a.b[b * a.sbb + (i - k) * a.sbk];
  const T eps = Lim<T>::eps();

  // ---- the fit and the primal value: the one pass that reads x
  T z[DIM];
  double prim;
  {
    LaneSum<T, COMP> rhs[DIM];
    T bbt[P];
#pragma unroll
    for (int p = 0; p < P; ++p) bbt[p] = T(0);
    double pl = 0.0;
    const T* xb = a.x + b * a.sxb;
    each([&](int j, const T (&h)[DIM], T) {
      const T xj = clamp_lo(xb[j], T(1e-30));
      const T lx = klog(xj);
      const T lp = a.logp != nullptr ? a.logp[j] : a.lpc;
      const T c = -((T(1) + lx) - lp);
      pl += double(xj * (lx - lp));
#pragma unroll
      for (int i = 0; i < DIM; ++i) {
        rhs[i].add(c * h[i]);
#pragma unroll
        for (int l = i; l < DIM; ++l)
          bbt[pidx<DIM>(i, l)] = bbt[pidx<DIM>(i, l)] + h[i] * h[l];
      }
    });
    prim = warp_sum(pl);
    T v[DIM + P];
#pragma unroll
    for (int i = 0; i < DIM; ++i) v[i] = rhs[i].total();
#pragma unroll
    for (int p = 0; p < P; ++p) v[DIM + p] = bbt[p];
    warp_reduce(v, lane, row);
    __syncwarp();
    T m[P], r[DIM];
#pragma unroll
    for (int i = 0; i < DIM; ++i) r[i] = row[i];
#pragma unroll
    for (int p = 0; p < P; ++p) m[p] = row[DIM + p];
    T ds = kabs(m[0]);
#pragma unroll
    for (int i = 1; i < DIM; ++i) ds = ds + kabs(m[pidx<DIM>(i, i)]);
    const T ridge = T(10) * eps * (ds / T(DIM));
#pragma unroll
    for (int i = 0; i < DIM; ++i)
#pragma unroll
      for (int l = i; l < DIM; ++l)
        m[pidx<DIM>(i, l)] = m[pidx<DIM>(i, l)] + ridge * T(i == l ? 1 : 0);
    small_solve<DIM>(m, r, z);
#pragma unroll
    for (int i = 0; i < DIM; ++i)
      if (i < k) z[i] = clamp_lo(z[i], T(0));
  }

  // ---- the polish: duality._polish_dual, one step a trip
  const T inf = T(INFINITY);
  for (int step = 0; step < a.steps; ++step) {
    T zmax = kabs(z[0]);
#pragma unroll
    for (int i = 1; i < DIM; ++i) zmax = jmax(zmax, kabs(z[i]));
    const T thr = T(64) * eps * (T(1) + zmax);
#pragma unroll
    for (int i = 0; i < DIM; ++i)
      if (i < k && z[i] <= thr) z[i] = T(0);

    // value, gradient and Hessian at z
    T g[DIM], hs[P], f0;
    {
      LaneSum<T, COMP> sy, sg[DIM];
      T sh[P];
#pragma unroll
      for (int p = 0; p < P; ++p) sh[p] = T(0);
      each([&](int, const T (&h)[DIM], T rj) {
        const T y = rj * kexp(-btz(z, h));
        sy.add(y);
#pragma unroll
        for (int i = 0; i < DIM; ++i) {
          sg[i].add(y * h[i]);
          const T hy = h[i] * y;
#pragma unroll
          for (int l = i; l < DIM; ++l)
            sh[pidx<DIM>(i, l)] = sh[pidx<DIM>(i, l)] + hy * h[l];
        }
      });
      T v[1 + DIM + P];
      v[0] = sy.total();
#pragma unroll
      for (int i = 0; i < DIM; ++i) v[1 + i] = sg[i].total();
#pragma unroll
      for (int p = 0; p < P; ++p) v[1 + DIM + p] = sh[p];
      __syncwarp();   // every lane has read the row's last totals
      warp_reduce(v, lane, row);
      __syncwarp();
      f0 = dot(w, z) + row[0];
#pragma unroll
      for (int i = 0; i < DIM; ++i) g[i] = w[i] - row[1 + i];
#pragma unroll
      for (int p = 0; p < P; ++p) hs[p] = row[1 + DIM + p];
    }

    // the Newton direction on the free coordinates
    T ff[DIM], gf[DIM], d[DIM];
#pragma unroll
    for (int i = 0; i < DIM; ++i) {
      const bool frozen = i < k && z[i] <= T(0) && g[i] > T(0);
      ff[i] = frozen ? T(0) : T(1);
      gf[i] = frozen ? T(0) : g[i];
    }
    {
      T hf[P];
#pragma unroll
      for (int i = 0; i < DIM; ++i)
#pragma unroll
        for (int l = i; l < DIM; ++l)
          hf[pidx<DIM>(i, l)] = hs[pidx<DIM>(i, l)] * (ff[i] * ff[l]) +
                                (i == l ? T(1) - ff[i] : T(0));
      T ds = kabs(hf[0]);
#pragma unroll
      for (int i = 1; i < DIM; ++i) ds = ds + kabs(hf[pidx<DIM>(i, i)]);
      const T ridge = T(10) * eps * (ds / T(DIM));
#pragma unroll
      for (int i = 0; i < DIM; ++i)
#pragma unroll
        for (int l = i; l < DIM; ++l)
          hf[pidx<DIM>(i, l)] =
              hf[pidx<DIM>(i, l)] + ridge * T(i == l ? 1 : 0);
      small_solve<DIM>(hf, gf, d);
    }
    bool dir_ok = true;
    T tbd = inf;   // the exact step to the first lam boundary crossed
#pragma unroll
    for (int i = 0; i < DIM; ++i) {
      d[i] = -d[i];
      dir_ok = dir_ok && isfinite(d[i]);
      if (i < k && d[i] < T(0)) tbd = jmin(tbd, -z[i] / d[i]);
    }
    T cand[kCands];
    {
      T t = T(1);
#pragma unroll
      for (int c = 0; c < kCands - 1; ++c) {
        cand[c] = t;
        t = t * T(0.5);
      }
      cand[kCands - 1] = tbd < T(0) ? T(0) : (tbd > T(1) ? T(1) : tbd);
    }
    auto cand_z = [&](int c, T (&zt)[DIM]) {
#pragma unroll
      for (int i = 0; i < DIM; ++i) {
        zt[i] = z[i] + cand[c] * d[i];
        if (i < k) zt[i] = clamp_lo(zt[i], T(0));
      }
    };

    // the candidates' value and gradient sums, CH a pass
    __syncwarp();
#pragma unroll
    for (int c0 = 0; c0 < kCands; c0 += CH) {
      constexpr int NV = CH * (1 + DIM);
      T zt[CH][DIM];
#pragma unroll
      for (int c = 0; c < CH; ++c)
        if (c0 + c < kCands) cand_z(c0 + c, zt[c]);
      LaneSum<T, COMP> sy[CH], sg[CH][DIM];
      each([&](int, const T (&h)[DIM], T rj) {
#pragma unroll
        for (int c = 0; c < CH; ++c) {
          if (c0 + c >= kCands) continue;
          const T y = rj * kexp(-btz(zt[c], h));
          sy[c].add(y);
#pragma unroll
          for (int i = 0; i < DIM; ++i) sg[c][i].add(y * h[i]);
        }
      });
      T v[NV];
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        v[c * (1 + DIM)] = sy[c].total();
#pragma unroll
        for (int i = 0; i < DIM; ++i)
          v[c * (1 + DIM) + 1 + i] = sg[c][i].total();
      }
      // a last, short pass writes only its candidates' totals
      const int cnt = (kCands - c0 < CH ? kCands - c0 : CH) * (1 + DIM);
      rs_round<NV, 16>(v, lane, 0, cnt, row + c0 * (1 + DIM));
    }
    __syncwarp();

    // the choice, one candidate a lane (lanes past them lose every tie):
    // torch.argmin's first minimum of the values, then its first minimum
    // (a NaN first) of the projected-gradient norms, each a butterfly over
    // (value, index)
    T gq = T(0);
#pragma unroll
    for (int i = 0; i < DIM; ++i) gq = gq + gf[i] * gf[i];
    const T gn0 = ksqrt(gq);
    auto cand_of = [&](int c) {
      return c < kCands - 1 ? T(1) / T(1 << c) : cand[kCands - 1];
    };
    T ft = inf, gn = inf;
    if (lane < kCands) {
      const T t = cand_of(lane);
      const T* tot = row + lane * (1 + DIM);
      T zt[DIM];
#pragma unroll
      for (int i = 0; i < DIM; ++i) {
        zt[i] = z[i] + t * d[i];
        if (i < k) zt[i] = clamp_lo(zt[i], T(0));
      }
      ft = dot(w, zt) + tot[0];
      T sq = T(0);
#pragma unroll
      for (int i = 0; i < DIM; ++i) {
        const T gi = w[i] - tot[1 + i];
        const T gv = (i < k && zt[i] <= T(0) && gi > T(0)) ? T(0) : gi;
        sq = sq + gv * gv;
      }
      gn = ksqrt(sq);
      if (!isfinite(ft)) {
        ft = inf;
        gn = inf;
      }
    }
    T bf_f = ft, bg_g = gn;
    int bf = lane, bg = lane;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const T vf = __shfl_xor_sync(kFull, bf_f, o);
      const int jf = __shfl_xor_sync(kFull, bf, o);
      if (vf < bf_f || (vf == bf_f && jf < bf)) {
        bf_f = vf;
        bf = jf;
      }
      const T vg = __shfl_xor_sync(kFull, bg_g, o);
      const int jg = __shfl_xor_sync(kFull, bg, o);
      const bool vn = vg != vg, bn = bg_g != bg_g;
      const bool first = vg < bg_g || (vg == bg_g && jg < bg);
      if (vn != bn ? vn : (vn ? jg < bg : first)) {
        bg_g = vg;
        bg = jg;
      }
    }
    const T bg_f = __shfl_sync(kFull, ft, bg);
    const T bf_t = cand_of(bf), bg_t = cand_of(bg);
    const bool f_ok = bf_f < f0 && dir_ok;
    const T noise = a.band * (T(1) + kabs(f0));
    const bool g_ok = bg_g < T(0.9) * gn0 && bg_f <= f0 + noise && dir_ok;
    const T tt = f_ok ? bf_t : bg_t;
    const bool take = f_ok || g_ok;
#pragma unroll
    for (int i = 0; i < DIM; ++i) {
      T zo = z[i];
      if (take) {
        zo = z[i] + tt * d[i];
        if (i < k) zo = clamp_lo(zo, T(0));
      }
      // snap boundary landings (O(eps z) residue) to the bound
      const T snap = T(8) * eps * kabs(z[i]);
      z[i] = (i < k && zo <= snap) ? T(0) : zo;
    }
  }

  // ---- the gap: f(x) - g(z), g(z) = -(w.z + sum R exp(-B'z))
  double sy = 0.0;
  each([&](int, const T (&h)[DIM], T rj) {
    sy += double(rj * kexp(-btz(z, h)));
  });
  sy = warp_sum(sy);
  if (lane == 0) {
    const T dual = -(dot(w, z) + T(sy));
    a.gap[b] = T(prim) - dual;
#pragma unroll
    for (int i = 0; i < DIM; ++i) a.z[b * DIM + i] = z[i];
  }
}

template <typename T, int DIM>
void launch_dim(const GapArgs<T>& a, cudaStream_t st) {
  const int blocks = (a.B + kWarps - 1) / kWarps;
  const int red = kWarps * row_len<T, DIM>() * int(sizeof(T));
  constexpr bool f32 = std::is_same<T, float>::value;
  if constexpr (f32) {
    if (a.n <= 32 * kHeldNC) {
      kl_gap_polish_kernel<T, DIM, kHeldNC, false>
          <<<blocks, kThreads, red, st>>>(a);
      return;
    }
  }
  kl_gap_polish_kernel<T, DIM, 0, f32><<<blocks, kThreads, red, st>>>(a);
}

template <typename T>
int launch_gap(const void* H, long long sHk, const void* u, long long sub,
               long long suk, const void* A, long long sAk, const void* bv,
               long long sbb, long long sbk, const void* x, long long sxb,
               const void* logp, const void* R, double lpc, double rc,
               void* gap, void* z, int B, int n, int k, int p, int steps,
               double band_eps, void* stream) {
  const int dim = k + p;
  if (B < 1 || n < 1 || k < 0 || p < 0 || dim < 1 || dim > kMaxDim ||
      steps < 0 || (logp == nullptr) != (R == nullptr))
    return cudaErrorInvalidValue;
  GapArgs<T> a{(const T*)H, (const T*)u, (const T*)A, (const T*)bv,
               (const T*)x, (const T*)logp, (const T*)R, sHk, sub, suk, sAk,
               sbb, sbk, sxb, T(lpc), T(rc), T(band_eps), (T*)gap, (T*)z,
               B, n, k, steps};
  cudaStream_t st = (cudaStream_t)stream;
  switch (dim) {
    case 1: launch_dim<T, 1>(a, st); break;
    case 2: launch_dim<T, 2>(a, st); break;
    case 3: launch_dim<T, 3>(a, st); break;
    case 4: launch_dim<T, 4>(a, st); break;
    case 5: launch_dim<T, 5>(a, st); break;
    case 6: launch_dim<T, 6>(a, st); break;
    case 7: launch_dim<T, 7>(a, st); break;
    default: launch_dim<T, 8>(a, st); break;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int kl_gap_fused_f32(const void* H, long long sHk, const void* u,
                     long long sub, long long suk, const void* A,
                     long long sAk, const void* bv, long long sbb,
                     long long sbk, const void* x, long long sxb,
                     const void* logp, const void* R, double lpc, double rc,
                     void* gap, void* z, int B, int n, int k, int p,
                     int steps, double band_eps, void* stream) {
  return launch_gap<float>(H, sHk, u, sub, suk, A, sAk, bv, sbb, sbk, x, sxb,
                           logp, R, lpc, rc, gap, z, B, n, k, p, steps,
                           band_eps, stream);
}

int kl_gap_fused_f64(const void* H, long long sHk, const void* u,
                     long long sub, long long suk, const void* A,
                     long long sAk, const void* bv, long long sbb,
                     long long sbk, const void* x, long long sxb,
                     const void* logp, const void* R, double lpc, double rc,
                     void* gap, void* z, int B, int n, int k, int p,
                     int steps, double band_eps, void* stream) {
  return launch_gap<double>(H, sHk, u, sub, suk, A, sAk, bv, sbb, sbk, x,
                            sxb, logp, R, lpc, rc, gap, z, B, n, k, p, steps,
                            band_eps, stream);
}

const char* kl_gap_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
