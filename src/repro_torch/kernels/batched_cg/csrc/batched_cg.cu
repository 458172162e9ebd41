// Batched conjugate gradient for Hopper (sm_90a), the stream route: one
// thread block per instance of a batch of dense SPD systems
// A[i] x[i] = b[i], d <= 512, reading A from device memory on every
// iteration.
//
// Replaces repro/kernels/batched_cg/kernel.py::_batched_cg_kernel, the Pallas
// TPU kernel behind the `pallas_cg` solver, for the systems whose slice no
// thread-block cluster holds (kernel.py::layout: float64 at d = 512).  Every
// other system takes the cluster route, batched_cg_cluster.cu, which keeps A
// in the shared memory of a cluster and reads it from device memory once.
// Same algorithm and guards as repro_torch/kernels/batched_cg/ref.py: CG from
// x0 = 0, alpha = 0 where p'Ap = 0, beta = 0 where rs = 0, an instance stops
// once rs <= max(tol^2 |b|^2, 1e-30) or after maxiter steps.  The Pallas
// kernel keeps a converged row frozen until its whole block is done; here
// each instance owns its block and simply leaves the loop, which gives the
// same x because a frozen row's update is a no-op.
//
// Layout: grid = B, 256 threads.  x, r, p and Ap live in shared memory
// (4 d sizeof(T): at most 16 KB in f64 at d = 512).  A is read from device
// memory on every iteration: for A p one warp takes a row with its lanes
// spread across the columns (coalesced reads) and a shuffle reduction makes
// the element of Ap; for the backward solve on A^T each thread takes a
// column and walks the rows, so neighbouring threads still read neighbouring
// addresses.  Dot products use a block reduction whose result every thread
// computes in the same order, so the loop condition is uniform in the block.
//
// What bounds it on the H100: every iteration streams B d^2 sizeof(T) bytes
// of A (128 MiB at B = 64, d = 512, f64).  That is more than the 50 MB L2,
// so it comes from HBM on every iteration, and only B of the 132 SMs have
// work.  It stays for what the cluster route cannot hold; chip_smoke.py
// times it beside the cluster route at (64, 512) float32.
//
// C interface (bound with ctypes): batched_cg_f32 / batched_cg_f64 launch on
// the given stream, allocate nothing, and return cudaGetLastError().

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDim = 512;

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

// Sum of one value per thread.  Every thread returns the same value.
template <typename T>
__device__ __forceinline__ T block_sum(T v, T* red) {
  v = warp_sum(v);
  __syncthreads();  // earlier readers of red are done
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  T s = T(0);
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s += red[w];
  return s;
}

// ap = A p: one warp per row, four independent partial sums per lane.
template <typename T>
__device__ __forceinline__ void matvec_rows(const T* __restrict__ A,
                                            const T* p, T* ap, int d) {
  const int lane = threadIdx.x & 31;
  for (int row = threadIdx.x >> 5; row < d; row += kWarps) {
    const T* Ar = A + static_cast<size_t>(row) * d;
    T s0 = T(0), s1 = T(0), s2 = T(0), s3 = T(0);
    int j = lane;
    for (; j + 96 < d; j += 128) {
      s0 += Ar[j] * p[j];
      s1 += Ar[j + 32] * p[j + 32];
      s2 += Ar[j + 64] * p[j + 64];
      s3 += Ar[j + 96] * p[j + 96];
    }
    for (; j < d; j += 32) s0 += Ar[j] * p[j];
    const T s = warp_sum((s0 + s1) + (s2 + s3));
    if (lane == 0) ap[row] = s;
  }
}

// ap = A^T p: one thread per column, two independent partial sums.
template <typename T>
__device__ __forceinline__ void matvec_cols(const T* __restrict__ A,
                                            const T* p, T* ap, int d) {
  for (int col = threadIdx.x; col < d; col += kThreads) {
    T s0 = T(0), s1 = T(0);
    int i = 0;
    for (; i + 1 < d; i += 2) {
      s0 += A[static_cast<size_t>(i) * d + col] * p[i];
      s1 += A[static_cast<size_t>(i + 1) * d + col] * p[i + 1];
    }
    if (i < d) s0 += A[static_cast<size_t>(i) * d + col] * p[i];
    ap[col] = s0 + s1;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
batched_cg_kernel(const T* __restrict__ A, const T* __restrict__ b,
                  T* __restrict__ x_out, int d, T tol2, int maxiter,
                  int transpose) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* x = reinterpret_cast<T*>(smem);
  T* r = x + d;
  T* p = r + d;
  T* ap = p + d;
  __shared__ T red[kWarps];

  const size_t inst = blockIdx.x;
  const T* Ai = A + inst * static_cast<size_t>(d) * d;
  const T* bi = b + inst * static_cast<size_t>(d);

  T part = T(0);
  for (int i = threadIdx.x; i < d; i += kThreads) {
    const T v = bi[i];
    x[i] = T(0);
    r[i] = v;  // r0 = b - A 0
    p[i] = v;
    part += v * v;
  }
  const T bb = block_sum(part, red);
  T rs = bb;
  T atol2 = tol2 * bb;
  if (atol2 < T(1e-30)) atol2 = T(1e-30);

  for (int k = 0; k < maxiter && rs > atol2; ++k) {
    if (transpose) {
      matvec_cols(Ai, p, ap, d);
    } else {
      matvec_rows(Ai, p, ap, d);
    }
    __syncthreads();  // ap complete

    part = T(0);
    for (int i = threadIdx.x; i < d; i += kThreads) part += p[i] * ap[i];
    const T denom = block_sum(part, red);
    const T alpha = denom == T(0) ? T(0) : rs / denom;

    part = T(0);
    for (int i = threadIdx.x; i < d; i += kThreads) {
      x[i] += alpha * p[i];
      const T ri = r[i] - alpha * ap[i];
      r[i] = ri;
      part += ri * ri;
    }
    const T rs_new = block_sum(part, red);
    const T beta = rs == T(0) ? T(0) : rs_new / rs;
    for (int i = threadIdx.x; i < d; i += kThreads) p[i] = r[i] + beta * p[i];
    rs = rs_new;
    __syncthreads();  // p complete before the next A p
  }

  T* xo = x_out + inst * static_cast<size_t>(d);
  for (int i = threadIdx.x; i < d; i += kThreads) xo[i] = x[i];
}

template <typename T>
int launch(const void* A, const void* b, void* x, int batch, int d,
           double tol, int maxiter, int transpose, void* stream) {
  if (d < 1 || d > kMaxDim || batch < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0) return static_cast<int>(cudaSuccess);
  const size_t smem = 4 * static_cast<size_t>(d) * sizeof(T);
  batched_cg_kernel<T><<<batch, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(A), static_cast<const T*>(b), static_cast<T*>(x),
      d, static_cast<T>(tol * tol), maxiter, transpose);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int batched_cg_f32(const void* A, const void* b, void* x,
                              int batch, int d, double tol, int maxiter,
                              int transpose, void* stream) {
  return launch<float>(A, b, x, batch, d, tol, maxiter, transpose, stream);
}

extern "C" int batched_cg_f64(const void* A, const void* b, void* x,
                              int batch, int d, double tol, int maxiter,
                              int transpose, void* stream) {
  return launch<double>(A, b, x, batch, d, tol, maxiter, transpose, stream);
}
