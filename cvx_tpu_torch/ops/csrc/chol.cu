// K4: the batched lower Cholesky factor on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of cvx_tpu/ops/pallas_chol.py:
//   K4  chol_batched_{f32,f64}  <- _chol_tile_kernel  (pallas_call :139)
// The plain PyTorch version of the same algorithm is
// cholesky_batched_plain in ../chol.py.
//
// Two paths, chosen by the launcher by n and type: the held path for n <=
// kHeldMaxN (f32) / kHeldMaxNF64 (f64), the panel path above.  Both give L
// with its strict upper triangle zeroed; a pivot that is not positive gives
// NaN (1/sqrt of a negative, or 0 * inf on a zero pivot), which spreads to
// the columns after it, as in the reference.
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
// The panel path (n above the held limit, up to the shared memory of one
// block: right-looking and blocked with kBk = 32 columns, as the
// reference).  For each column block: factor its bk columns one at a time
// (column j of L is column j of the updated matrix times 1/sqrt of its
// pivot, then a rank-1 update of the block's remaining columns), then
// subtract P P^T from the trailing matrix, P the block's rows below it.
// One block of kThreads per matrix factors in place in the output buffer
// (global memory, hot in L2); the column block being factored, with every
// row below it, is staged in shared memory (n x (kBk + 1) elements; the +1
// keeps the column reads of the rank-1 and trailing updates off one bank),
// factored there with a barrier per column, and written back.  Nothing is
// padded: the last block is ragged.
//
// Numerics: IEEE sqrt and division (no fast math, --fmad=false); the held
// path's updates are explicit fmas, the panel path's trailing sums run in
// ascending column order; neither matches the plain version's matmul in
// every bit, so the kernel is held to it by a tolerance.
//
// Interface: plain C; X with any batch and row stride and contiguous
// columns, L contiguous (B, n, n).  Each entry launches once on the given
// stream and returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kBk = 32;          // column block width (the reference's bk)
constexpr int kPad = kBk + 1;    // shared row stride of the panel
constexpr int kThreads = 256;

__device__ __forceinline__ float ksqrt(float v) { return sqrtf(v); }
__device__ __forceinline__ double ksqrt(double v) { return sqrt(v); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
chol_kernel(const T* __restrict__ X, long long sXb, long long sXr,
            T* __restrict__ Lout, int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* P = reinterpret_cast<T*>(smem_raw);   // (n - j0) x kPad panel
  const int tid = threadIdx.x;
  const T* Xb = X + blockIdx.x * sXb;
  T* L = Lout + (long long)blockIdx.x * n * n;

  // the lower triangle of X, upper triangle zeroed
  for (int e = tid; e < n * n; e += kThreads) {
    const int r = e / n, c = e - r * n;
    L[e] = c <= r ? Xb[r * sXr + c] : T(0);
  }
  __syncthreads();

  for (int j0 = 0; j0 < n; j0 += kBk) {
    const int w = min(kBk, n - j0);  // columns in this block
    const int m = n - j0;            // panel rows: j0 .. n-1
    for (int e = tid; e < m * w; e += kThreads) {
      const int r = e / w, c = e - r * w;
      P[r * kPad + c] = L[(long long)(j0 + r) * n + j0 + c];
    }
    __syncthreads();
    for (int jj = 0; jj < w; ++jj) {
      const T rs = T(1) / ksqrt(P[jj * kPad + jj]);
      __syncthreads();  // every thread has read the pivot
      for (int r = jj + tid; r < m; r += kThreads)
        P[r * kPad + jj] = P[r * kPad + jj] * rs;
      __syncthreads();
      // rank-1 update of the block's later columns, lower triangle
      const int wr = w - jj - 1, mr = m - jj - 1;
      for (int e = tid; e < mr * wr; e += kThreads) {
        const int r = jj + 1 + e / wr, c = jj + 1 + e % wr;
        if (c <= r)
          P[r * kPad + c] = P[r * kPad + c] - P[r * kPad + jj] * P[c * kPad + jj];
      }
      __syncthreads();
    }
    for (int e = tid; e < m * w; e += kThreads) {
      const int r = e / w, c = e - r * w;
      if (c <= r) L[(long long)(j0 + r) * n + j0 + c] = P[r * kPad + c];
    }
    // trailing update L[r][c] -= sum_p P[r][p] P[c][p], r >= c >= j0 + w
    const int mt = m - w;
    for (int e = tid; e < mt * mt; e += kThreads) {
      const int r = e / mt, c = e - r * mt;
      if (c > r) continue;
      const T* pr = P + (w + r) * kPad;
      const T* pc = P + (w + c) * kPad;
      T acc = T(0);
      for (int p = 0; p < w; ++p) acc = acc + pr[p] * pc[p];
      T* lrc = L + (long long)(j0 + w + r) * n + (j0 + w + c);
      *lrc = *lrc - acc;
    }
    __syncthreads();
  }
}

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

template <typename T>
constexpr int held_max_n() {
  return sizeof(T) == 4 ? kHeldMaxN : kHeldMaxNF64;
}

template <typename T>
int launch_chol(const void* X, long long sXb, long long sXr, void* L, int B,
                int n, void* stream) {
  if (B < 1 || n < 1) return cudaErrorInvalidValue;
  constexpr int G = (held_max_n<T>() + kSide - 1) / kSide;
  if constexpr (G > 0) {
    if (n <= held_max_n<T>())
      return launch_held<T, G>((const T*)X, sXb, sXr, (T*)L, B, n,
                               (cudaStream_t)stream);
  }
  const size_t smem = (size_t)n * kPad * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      chol_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  chol_kernel<T><<<B, kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)X, sXb, sXr, (T*)L, n);
  return cudaGetLastError();
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
