// K4: the batched lower Cholesky factor on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of cvx_tpu/ops/pallas_chol.py:
//   K4  chol_batched_{f32,f64}  <- _chol_tile_kernel  (pallas_call :139)
// The plain PyTorch version of the same algorithm is
// cholesky_batched_plain in ../chol.py.
//
// Two paths, chosen by the launcher by n and type: the held path for n <=
// kHeldMaxN (f32) / kHeldMaxNF64 (f64), the panel path above, up to kMaxN
// / kMaxNF64.  Both give L with its strict upper triangle zeroed; a pivot
// that is not positive gives NaN (1/sqrt of a negative, or 0 * inf on a
// zero pivot), which spreads to the columns after it, as in the reference.
//
// What bounds it on this card.  At 4096 matrices of n = 100 in f32 the
// kernel must read each input's lower triangle (83 MB) and write the whole
// factor (164 MB), 0.074 ms at 3.35 TB/s, against n^3/3 flops per matrix
// (1.4 GFLOP, 0.02 ms at 67 TFLOP/s): by bytes, but what holds a kernel
// back at this n is instruction issue and the latency of the n dependent
// column steps, not either bound.
//
// The held path (the main shape).  One block of 16 x 16 threads per
// matrix; thread (ty, tx) holds the elements (ty + 16 i, tx + 16 s), i >= s,
// of the lower triangle in registers from load to store (a 2-D cyclic map:
// with equal moduli the triangle is known at compile time, so no loop body
// divides or tests an upper element, and every thread keeps work as the
// active corner shrinks).  The algorithm is the unblocked right-looking
// one: for each column j, every thread reads column j and 1/sqrt of its
// pivot from shared memory, forms L[r][j] = A[r][j] * rs and L[c][j] =
// A[c][j] * rs itself (the same values the plain version stores) and
// updates its elements with c > j by one fma each.  The owners of column
// j + 1 then publish it into the other of two column buffers, and the
// owner of its pivot its 1/sqrt: one barrier per column.  Column j's own
// elements are scaled only at the store.  The columns run in phases of
// 16, one per column group and each compiled for its group, so that which
// groups are still active is known at compile time: a step touches only
// the active groups' registers and column values, and only the group that
// holds column j tests its columns against j.  The matrix is read once
// (the lower triangle) and L written once (upper zeros included).  The
// registers (28 f32 elements a thread at n = 100, 78 at n = 192) set the
// limit; above it the panel path takes over.
//
// The panel path (n above the held limit).  What bounds it: at 1024 x 256
// in f32 the bytes (the lower triangle in, L out: 402 MB, 0.12 ms at 3.35
// TB/s, against n^3/3 flops, 0.09 ms at 67 TFLOP/s); at 256 x 512 the
// operations (n^3/3 flops a matrix, 11.5 GFLOP, 0.17 ms, against 0.12 ms
// of bytes).  A right-looking factor (the reference's order) reads and
// writes the whole trailing triangle once per column block, ~n^3 / (3 kBk)
// elements a matrix that go to device memory once the batch's factors
// outgrow the 50 MB L2, and its trailing products, one element a thread,
// issue two shared loads per fma.  So the panel path is left-looking and
// blocked, one block of kThreads per matrix, registers for kMinBlocks
// blocks an SM.  For each column block [j0, j0 + kBk):
//   1. update: S = A[j0:, j0:j0+kBk] - L[j0:, :j0] L[j0:j0+kBk, :j0]^T, an
//      output-stationary product.  Each thread keeps a register tile of
//      up to kTm rows x kTn columns of S (rows rg + R i, columns cg + C j:
//      neighbouring threads on neighbouring rows and columns, so the
//      16-byte shared loads are free of bank conflicts) and reads, per 16
//      bytes of depth, one 16-byte load a row and a column: kTm + kTn
//      loads per kVec kTm kTn fmas.  The operand tiles of L (kKt columns
//      deep, the chunk's rows and the block's kBk rows) stream from device
//      memory into a ring of kStages shared buffers with cp.async,
//      kStages - 1 tiles ahead of the product, 16 bytes a copy where n
//      keeps L's rows aligned (a kernel compiled for each case, so neither
//      carries the other's code and registers); A's column block is copied
//      into S's shared buffer beside them.  The rows below j0 run in
//      chunks of at most kTm slabs of R rows, the slabs spread evenly over
//      the chunks and each chunk compiled for its number of slabs, so that
//      a ragged chunk computes no empty slab;
//   2. factor the kBk x kBk diagonal tile in one warp: lane i holds rows
//      i (+ 32) in registers, each column's pivot and values reach the
//      other lanes by shuffles, no block barrier;
//   3. solve the chunk's other rows against it: one thread a row, held in
//      registers, reading the tile's columns 16 bytes at a time and 1/sqrt
//      of its pivots from shared memory as broadcasts (the plain version's
//      rank-1 updates, in its order, as fmas), in place in S;
//   4. write the chunk's rows of the column block of L once, a warp a row.
// A enters once (its lower triangle) and L leaves once; the earlier
// columns are read again once per column block, ~n^3 / (6 kBk) elements a
// matrix: half the right-looking traffic, and no writes.  Shared memory
// holds the operand ring, the chunk of S and the tile, not a panel of n
// rows, so it does not grow with n (max_n stays as the old panel set it).
// What still holds it back (probe_k4.py's time-only variants, PERF.md):
// the product is a third of the time; the one-warp diagonal tile, whose
// pivot chain (shuffle, sqrt, division) the other warps wait for, and the
// copies' latency between the ring's barriers take most of the rest.
//
// Numerics: IEEE sqrt and division (no fast math, --fmad=false); the
// updates are explicit fmas, the panel path's sums over the earlier
// columns one chain in ascending column order subtracted from A at the
// end; neither path matches the plain version's matmul in every bit, so
// the kernel is held to it by a tolerance.
//
// Interface: plain C; X with any batch and row stride and contiguous
// columns, L contiguous (B, n, n).  Each entry launches once on the given
// stream and returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cmath>

namespace {

__device__ __forceinline__ float ksqrt(float v) { return sqrtf(v); }
__device__ __forceinline__ double ksqrt(double v) { return sqrt(v); }

// the held path: n up to these (0: every n takes the panel path)
constexpr int kHeldMaxN = 192;
constexpr int kHeldMaxNF64 = 192;
constexpr int kSide = 16;        // the held path's block is kSide x kSide

__device__ __forceinline__ float kfma(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double kfma(double a, double b, double c) {
  return fma(a, b, c);
}

// G = ceil(n / kSide) column (and row) groups; thread (ty, tx) holds
// a[i][s] = element (ty + kSide i, tx + kSide s) for i >= s (for i = s
// also the upper elements ty < tx, whose values are never used).  Rows
// and columns past n are padding: they take part in the arithmetic (no
// predicate for them) but never in a real element or in the store.

// Column j1 of the matrix, in group S, as updated through column j1 - 1:
// its owners (tx = j1 - kSide S) write it to the column buffer cn, and
// the owner of its pivot writes 1 / sqrt of the pivot to rsq[j1].
template <typename T, int G, int S>
__device__ __forceinline__ void publish(const T (&a)[G][G], T* cn, T* rsq,
                                        int j1, int n, int tx, int ty) {
  if constexpr (S < G) {
    if (tx == j1 - kSide * S && j1 < n) {
      if (ty >= tx) cn[ty + kSide * S] = a[S][S];
#pragma unroll
      for (int i = S + 1; i < G; ++i) cn[ty + kSide * i] = a[i][S];
      if (ty == tx) rsq[j1] = T(1) / ksqrt(a[S][S]);
    }
  }
}

// Columns j of group G0 (kSide G0 <= j < min(kSide (G0 + 1), n)), the
// groups before it factored: for each, the rank-1 update of the columns
// after j with L[r][j] = A[r][j] rs and L[c][j] = A[c][j] rs, then column
// j + 1 published, then one barrier.  Group G0's columns up to j keep
// their values; the groups after it are updated whole.
template <typename T, int G, int G0>
__device__ __forceinline__ void held_phase(T (&a)[G][G], T*& cj, T*& cn,
                                           T* rsq, int n, int tx, int ty) {
  const int jend = min(kSide * (G0 + 1), n);
  for (int j = kSide * G0; j < jend; ++j) {
    const T rs = rsq[j];
    T lr[G];
#pragma unroll
    for (int i = G0; i < G; ++i) lr[i] = cj[ty + kSide * i] * rs;
    const T l0 = cj[tx + kSide * G0] * rs;
    const bool on = tx > j - kSide * G0;
#pragma unroll
    for (int i = G0; i < G; ++i)
      a[i][G0] = on ? kfma(-lr[i], l0, a[i][G0]) : a[i][G0];
#pragma unroll
    for (int s = G0 + 1; s < G; ++s) {
      const T lc = cj[tx + kSide * s] * rs;
#pragma unroll
      for (int i = s; i < G; ++i) a[i][s] = kfma(-lr[i], lc, a[i][s]);
    }
    const int j1 = j + 1;
    if (j1 < kSide * (G0 + 1))
      publish<T, G, G0>(a, cn, rsq, j1, n, tx, ty);
    else
      publish<T, G, G0 + 1>(a, cn, rsq, j1, n, tx, ty);
    __syncthreads();
    T* t = cj;
    cj = cn;
    cn = t;
  }
  if constexpr (G0 + 1 < G)
    held_phase<T, G, G0 + 1>(a, cj, cn, rsq, n, tx, ty);
}

template <typename T, int G>
__global__ void __launch_bounds__(kSide * kSide)
chol_held_kernel(const T* __restrict__ X, long long sXb, long long sXr,
                 T* __restrict__ Lout, int n) {
  __shared__ T col[2][kSide * G];   // columns j and j + 1 before scaling
  __shared__ T rsq[kSide * G];      // 1 / sqrt of pivot j
  const int tx = threadIdx.x, ty = threadIdx.y;
  const T* Xb = X + blockIdx.x * sXb;
  T* L = Lout + (long long)blockIdx.x * n * n;

  T a[G][G];
#pragma unroll
  for (int i = 0; i < G; ++i)
#pragma unroll
    for (int s = 0; s <= i; ++s) {
      const int r = ty + kSide * i, c = tx + kSide * s;
      a[i][s] = (r < n && c <= r) ? Xb[r * sXr + c] : T(0);
    }
  T* cj = col[0];     // column j; column j + 1 goes to cn
  T* cn = col[1];
  publish<T, G, 0>(a, cj, rsq, 0, n, tx, ty);
  __syncthreads();
  held_phase<T, G, 0>(a, cj, cn, rsq, n, tx, ty);

  // L[r][c] = A[r][c] rs_c on and below the diagonal, 0 above
#pragma unroll
  for (int i = 0; i < G; ++i)
#pragma unroll
    for (int s = 0; s < G; ++s) {
      const int r = ty + kSide * i, c = tx + kSide * s;
      if (r < n && c < n) {
        T v = T(0);
        if (i > s || (i == s && ty >= tx)) v = a[i][s] * rsq[c];
        L[(long long)r * n + c] = v;
      }
    }
}

template <typename T, int G>
int launch_held(const T* X, long long sXb, long long sXr, T* L, int B, int n,
                cudaStream_t stream) {
  if constexpr (G > 1) {
    if (n <= kSide * (G - 1))
      return launch_held<T, G - 1>(X, sXb, sXr, L, B, n, stream);
  }
  chol_held_kernel<T, G><<<B, dim3(kSide, kSide), 0, stream>>>(
      X, sXb, sXr, L, n);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- panel

constexpr int kThreads = 256;    // the panel path's block
constexpr int kMinBlocks = 2;    // blocks an SM its registers allow
constexpr int kBk = 32;          // column block width (the reference's bk)
constexpr int kTm = 4;           // the update's register tile: row slabs
constexpr int kTn = 4;           // and columns a thread
constexpr int kStages = 3;       // the operand ring's depth, in tiles
// the largest n the launcher takes (the old panel's shared memory limit)
constexpr int kMaxN = 1760;
constexpr int kMaxNF64 = 880;

template <typename T>
struct Panel {
  static constexpr int kVec = 16 / sizeof(T);    // elements of 16 bytes
  static constexpr int kC = kBk / kTn;           // column groups
  static constexpr int kR = kThreads / kC;       // row groups: a slab's rows
  static constexpr int kRows = kR * kTm;         // a chunk's rows, at most
  static constexpr int kKt = sizeof(T) == 4 ? 16 : 8;   // a tile's depth
  static constexpr int kKp = kKt + kVec;         // its padded row
  static constexpr int kSp = kBk + 1;            // padded row of S
  static constexpr int kStage = (kRows + kBk) * kKp;
  static constexpr size_t smem() {
    return (size_t(kStages) * kStage + size_t(kRows) * kSp + kBk * kBk +
            kBk) * sizeof(T);
  }
  static_assert(kBk % 32 == 0 && kBk % kTn == 0 && kThreads % kC == 0 &&
                kBk % kKt == 0 && kBk <= 64);
  static_assert(kBk <= kRows && (kBk % kR == 0 || kR % kBk == 0),
                "chunk 0 must hold the diagonal tile's rows");
  static_assert(kRows <= kThreads, "one row of a chunk a thread");
};

// cp.async of one element, zeros where ``in`` is false
template <typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src, bool in) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s),
               "l"(src), "n"(sizeof(T)), "r"(in ? int(sizeof(T)) : 0)
               : "memory");
}
// cp.async of 16 bytes (both addresses aligned), zeros where ``in`` is
// false
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void load16(float (&r)[4], const float* p) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  r[0] = v.x; r[1] = v.y; r[2] = v.z; r[3] = v.w;
}
__device__ __forceinline__ void load16(double (&r)[2], const double* p) {
  const double2 v = *reinterpret_cast<const double2*>(p);
  r[0] = v.x; r[1] = v.y;
}

// Step 1 for a chunk of sc <= SC slabs, rows j0 + r0 + rg + kR i (i <
// sc): S (shared, the chunk's rows x kBk) = A - L[., :j0] L[j0:j0+kBk,
// :j0]^T.  The registers hold SC slabs; update_slabs passes sc = SC, so
// that the tests of i against sc fold away.  VL: L's rows are 16-byte
// aligned (n a multiple of kVec), so its tiles are copied 16 bytes at a
// time; S's rows are never (kSp is odd), so A is copied element by
// element.
template <typename T, bool VL, int SC>
__device__ __forceinline__ void update_chunk(
    int sc, T* stage, T* S, const T* Xb, long long sXr, const T* L, int n,
    int j0, int r0, int tid) {
  using P = Panel<T>;
  const int rows = sc * P::kR;
  const int cg = tid % P::kC, rg = tid / P::kC;
  const int nk = j0 / P::kKt;
  __syncthreads();                 // S and the ring are free again
  for (int e = tid; e < rows * kBk; e += kThreads) {
    const int r = e / kBk, c = e % kBk;
    const int gr = j0 + r0 + r, gc = j0 + c;
    const bool in = gr < n && gc <= gr;          // A's lower triangle
    cp_async(S + r * P::kSp + c, in ? Xb + gr * sXr + gc : Xb, in);
  }
  // tile t: columns [t kKt, (t + 1) kKt) of the chunk's rows, then of the
  // column block's rows (all left of the diagonal)
  auto load_tile = [&](int t) {
    T* st = stage + (t % kStages) * P::kStage;
    const int k0 = t * P::kKt;
    if constexpr (VL) {
      constexpr int G = P::kKt / P::kVec;       // 16-byte groups a row
      for (int e = tid; e < (rows + kBk) * G; e += kThreads) {
        const int r = e / G, k = (e % G) * P::kVec;
        const int gr = r < rows ? j0 + r0 + r : j0 + r - rows;
        const bool in = gr < n;
        cp_async16(st + r * P::kKp + k,
                   in ? L + (long long)gr * n + k0 + k : L, in);
      }
    } else {
      for (int e = tid; e < (rows + kBk) * P::kKt; e += kThreads) {
        const int r = e / P::kKt, k = e % P::kKt;
        const int gr = r < rows ? j0 + r0 + r : j0 + r - rows;
        const bool in = gr < n;
        cp_async(st + r * P::kKp + k,
                 in ? L + (long long)gr * n + k0 + k : L, in);
      }
    }
  };
  for (int t = 0; t < kStages - 1; ++t) {   // A joins tile 0's group
    if (t < nk) load_tile(t);
    cp_async_commit();
  }
  T acc[SC][kTn];
#pragma unroll
  for (int i = 0; i < SC; ++i)
#pragma unroll
    for (int j = 0; j < kTn; ++j) acc[i][j] = T(0);
  for (int t = 0; t < nk; ++t) {
    cp_async_wait<kStages - 2>();   // tile t has landed
    __syncthreads();               // ... for every thread; t - 1 is done
    if (t + kStages - 1 < nk) load_tile(t + kStages - 1);
    cp_async_commit();
    const T* a = stage + (t % kStages) * P::kStage;
    const T* b = a + rows * P::kKp;
#pragma unroll
    for (int kk = 0; kk < P::kKt; kk += P::kVec) {
      T ra[SC][P::kVec], rb[kTn][P::kVec];
#pragma unroll
      for (int i = 0; i < SC; ++i)
        if (i < sc) load16(ra[i], a + (rg + P::kR * i) * P::kKp + kk);
#pragma unroll
      for (int j = 0; j < kTn; ++j)
        load16(rb[j], b + (cg + P::kC * j) * P::kKp + kk);
#pragma unroll
      for (int v = 0; v < P::kVec; ++v)
#pragma unroll
        for (int i = 0; i < SC; ++i) {
          if (i < sc) {
#pragma unroll
            for (int j = 0; j < kTn; ++j)
              acc[i][j] = kfma(ra[i][v], rb[j][v], acc[i][j]);
          }
        }
    }
  }
  cp_async_wait<0>();
  __syncthreads();                 // A is in S for every thread
#pragma unroll
  for (int i = 0; i < SC; ++i) {
    if (i < sc) {
#pragma unroll
      for (int j = 0; j < kTn; ++j) {
        T* s = S + (rg + P::kR * i) * P::kSp + cg + P::kC * j;
        *s = *s - acc[i][j];
      }
    }
  }
  __syncthreads();
}

// update_chunk compiled for each slab count 1 .. SC (probe_k4.py's
// ``oneslab`` runs one body of kTm slabs instead, the empty ones skipped
// by its tests of i against sc)
template <typename T, bool VL, int SC>
__device__ __forceinline__ void update_slabs(
    int sc, T* stage, T* S, const T* Xb, long long sXr, const T* L, int n,
    int j0, int r0, int tid) {
  if constexpr (SC > 1) {
    if (sc < SC) {
      update_slabs<T, VL, SC - 1>(sc, stage, S, Xb, sXr, L, n, j0, r0, tid);
      return;
    }
  }
  update_chunk<T, VL, SC>(SC, stage, S, Xb, sXr, L, n, j0, r0, tid);
}

// Step 2, one warp: factor the diagonal tile, rows 0 .. BK - 1 of S, in
// place.  Lane i holds row i + 32 t (t < BK / 32), columns up to its own
// diagonal slab; writes the tile's lower triangle back to S and to D
// (column-major: D[c BK + r] = L[j0 + r][j0 + c]) and 1/sqrt of its
// pivots to rsq.  Upper elements are updated with the rest but never read
// for a lower one.
template <typename T, int BK, int SP>
__device__ __forceinline__ void factor_diag(T* S, T* D, T* rsq, int lane) {
  constexpr int R = BK / 32;
  T a[R][BK];
#pragma unroll
  for (int t = 0; t < R; ++t)
#pragma unroll
    for (int c = 0; c < 32 * (t + 1); ++c) a[t][c] = S[(lane + 32 * t) * SP + c];
#pragma unroll
  for (int j = 0; j < BK; ++j) {
    const T rs = T(1) / ksqrt(__shfl_sync(0xffffffffu, a[j / 32][j], j % 32));
    T l[R];
#pragma unroll
    for (int t = 0; t < R; ++t)
      if (j < 32 * (t + 1)) a[t][j] = l[t] = a[t][j] * rs;
#pragma unroll
    for (int c = j + 1; c < BK; ++c) {
      const T lc = __shfl_sync(0xffffffffu, l[c / 32], c % 32);
#pragma unroll
      for (int t = c / 32; t < R; ++t) a[t][c] = kfma(-l[t], lc, a[t][c]);
    }
    if (lane == 0) rsq[j] = rs;
  }
#pragma unroll
  for (int t = 0; t < R; ++t) {
    const int r = lane + 32 * t;
#pragma unroll
    for (int c = 0; c < 32 * (t + 1); ++c)
      if (c <= r) D[c * BK + r] = S[r * SP + c] = a[t][c];
  }
}

// Step 3: row r of S (r >= BK in chunk 0) against the tile, in place; the
// tile's column c is read 16 bytes at a time from D.
template <typename T, int BK, int SP>
__device__ __forceinline__ void solve_row(T* S, const T* D, const T* rsq,
                                          int r) {
  constexpr int V = 16 / sizeof(T);
  T s[BK];
#pragma unroll
  for (int c = 0; c < BK; ++c) s[c] = S[r * SP + c];
#pragma unroll
  for (int c = 0; c < BK; ++c) {
    s[c] = s[c] * rsq[c];
#pragma unroll
    for (int g = (c + 1) / V; g < BK / V; ++g) {
      T d[V];
      load16(d, D + c * BK + g * V);
#pragma unroll
      for (int e = 0; e < V; ++e)
        if (g * V + e > c) s[g * V + e] = kfma(-s[c], d[e], s[g * V + e]);
    }
  }
#pragma unroll
  for (int c = 0; c < BK; ++c) S[r * SP + c] = s[c];
}

template <typename T, bool VL>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
chol_panel_kernel(const T* __restrict__ X, long long sXb, long long sXr,
                  T* __restrict__ Lout, int n) {
  using P = Panel<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* stage = reinterpret_cast<T*>(smem_raw);   // the operand ring
  T* S = stage + kStages * P::kStage;           // the chunk's S
  T* D = S + P::kRows * P::kSp;                 // the diagonal tile
  T* rsq = D + kBk * kBk;                       // 1/sqrt of its pivots
  const int tid = threadIdx.x;
  const T* Xb = X + blockIdx.x * sXb;
  T* L = Lout + (long long)blockIdx.x * n * n;

  for (int r = tid / 32; r < n; r += kThreads / 32)   // the upper zeros
    for (int c = r + 1 + tid % 32; c < n; c += 32)
      L[(long long)r * n + c] = T(0);

  for (int j0 = 0; j0 < n; j0 += kBk) {
    const int m = n - j0, w = min(kBk, m);
    // the rows j0 .. n - 1 in slabs of kR, spread evenly over the chunks;
    // chunk 0 holds at least the diagonal tile's slabs
    const int slabs = (m + P::kR - 1) / P::kR;
    const int chunks = (slabs + kTm - 1) / kTm;
    const int per = max((slabs + chunks - 1) / chunks,
                        min(slabs, (kBk + P::kR - 1) / P::kR));
    for (int s0 = 0; s0 < slabs; s0 += per) {
      const int sc = min(per, slabs - s0), r0 = s0 * P::kR;
      update_slabs<T, VL, kTm>(sc, stage, S, Xb, sXr, L, n, j0, r0, tid);
      if (s0 == 0) {
        if (tid < 32) factor_diag<T, kBk, P::kSp>(S, D, rsq, tid);
        __syncthreads();
      }
      // one row a thread (a loop would let the compiler hoist the tile's
      // loads out of it into registers)
      const int rows = min(sc * P::kR, m - r0);
      const int r = (s0 == 0 ? kBk : 0) + tid;
      if (r < rows) solve_row<T, kBk, P::kSp>(S, D, rsq, r);
      __syncthreads();
      // step 4: the chunk's rows of L's columns j0 .. j0 + w - 1, lower
      // triangle, a warp a row
      for (int e = tid; e < rows * kBk; e += kThreads) {
        const int rr = e / kBk, c = e % kBk;
        if (c < w && c <= r0 + rr)
          L[(long long)(j0 + r0 + rr) * n + j0 + c] = S[rr * P::kSp + c];
      }
    }
  }
}

template <typename T>
int launch_panel(const T* X, long long sXb, long long sXr, T* L, int B, int n,
                 cudaStream_t stream) {
  // 16-byte copies of L's tiles where its rows are aligned to 16 bytes
  const bool vec = n % (16 / sizeof(T)) == 0 &&
                   reinterpret_cast<unsigned long long>(L) % 16 == 0;
  auto kernel = vec ? chol_panel_kernel<T, true> : chol_panel_kernel<T, false>;
  const int smem = (int)Panel<T>::smem();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<B, kThreads, smem, stream>>>(X, sXb, sXr, L, n);
  return cudaGetLastError();
}

template <typename T>
constexpr int held_max_n() {
  return sizeof(T) == 4 ? kHeldMaxN : kHeldMaxNF64;
}

template <typename T>
int launch_chol(const void* X, long long sXb, long long sXr, void* L, int B,
                int n, void* stream) {
  if (B < 1 || n < 1 || n > (sizeof(T) == 4 ? kMaxN : kMaxNF64))
    return cudaErrorInvalidValue;
  constexpr int G = (held_max_n<T>() + kSide - 1) / kSide;
  if constexpr (G > 0) {
    if (n <= held_max_n<T>())
      return launch_held<T, G>((const T*)X, sXb, sXr, (T*)L, B, n,
                               (cudaStream_t)stream);
  }
  return launch_panel<T>((const T*)X, sXb, sXr, (T*)L, B, n,
                         (cudaStream_t)stream);
}

}  // namespace

extern "C" {

int chol_batched_f32(const void* X, long long sXb, long long sXr, void* L,
                     int B, int n, void* stream) {
  return launch_chol<float>(X, sXb, sXr, L, B, n, stream);
}

int chol_batched_f64(const void* X, long long sXb, long long sXr, void* L,
                     int B, int n, void* stream) {
  return launch_chol<double>(X, sXb, sXr, L, B, n, stream);
}

const char* chol_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
