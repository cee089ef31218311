// K4: the batched lower Cholesky factor on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of cvx_tpu/ops/pallas_chol.py:
//   K4  chol_batched_{f32,f64}  <- _chol_tile_kernel  (pallas_call :139)
// The plain PyTorch version of the same algorithm is
// cholesky_batched_plain in ../chol.py.
//
// Algorithm (the reference's): right-looking and blocked with kBk = 32
// columns.  For each column block: factor its bk columns one at a time
// (column j of L is column j of the updated matrix times 1/sqrt of its
// pivot, then a rank-1 update of the block's remaining columns), then
// subtract P P^T from the trailing matrix, P the block's rows below it.
// The result is L with its strict upper triangle zeroed; a pivot that is
// not positive gives NaN (1/sqrt of a negative), which spreads to the
// columns after it, as in the reference.
//
// What bounds it on this card.  At 4096 matrices of n = 100 in f32 the
// kernel must read 164 MB and write 164 MB (about 0.1 ms at 3.35 TB/s)
// against n^3/3 flops per matrix (1.4 GFLOP, 0.02 ms at 67 TFLOP/s): it is
// bound by bytes, and by the latency of the n dependent column steps.
//
// What the design does about it.  One block of kThreads per matrix.  The
// matrix is factored in place in the output buffer (global memory, hot in
// L2); the column block being factored, with every row below it, is staged
// in shared memory (n x (kBk + 1) elements; the +1 keeps the column reads
// of the rank-1 and trailing updates off one bank), factored there with a
// barrier per column, and written back.  The trailing update reads P from
// shared memory and updates only the lower triangle, each thread one
// element at a time, its bk-term sum written out by hand.  Nothing is
// padded: the last block is ragged.
//
// Numerics: IEEE sqrt and division (no fast math, --fmad=false); the
// trailing sums run in ascending column order, which need not match the
// plain version's matmul, so the kernel is held to it by a tolerance.
//
// Interface: plain C; X with any batch and row stride and contiguous
// columns, L contiguous (B, n, n).  Each entry launches on the given
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

template <typename T>
int launch_chol(const void* X, long long sXb, long long sXr, void* L, int B,
                int n, void* stream) {
  if (B < 1 || n < 1) return cudaErrorInvalidValue;
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
