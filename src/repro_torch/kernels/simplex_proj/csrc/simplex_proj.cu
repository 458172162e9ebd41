// Row-wise Euclidean projection onto the scale-simplex {x >= 0, sum x = scale}
// for Hopper (sm_90a): one warp per row of a (rows, d) matrix.
//
// Replaces repro/kernels/simplex_proj/kernel.py::_simplex_kernel, the Pallas
// TPU kernel behind projection_simplex_batched.  Same algorithm as
// repro_torch/kernels/simplex_proj/ref.py: everything in float32 whatever the
// input type, the threshold tau found by kIters = 50 bisection steps on
//   phi(tau) = sum_i max(y_i - tau, 0) - scale
// over the bracket hi = max(y), lo = min(max(y) - scale, min(y) - scale/d),
// the output max(y - tau, 0) cast back to the input type.
//
// Layout: for d <= 1024 a block holds 8 warps, one row each, and a lane holds
// the row's elements lane, lane + 32, ... in registers (V = ceil(d/32)
// values, V a power of two chosen at launch), so y is read once, with
// neighbouring lanes on neighbouring addresses, and x written once.  Above
// that a block is one warp whose row lives in dynamic shared memory
// (d <= 32768, 128 KB).  max, min and the phi-sum are xor-butterfly shuffle
// reductions: at every stage a lane and its partner add the same two values,
// so all 32 lanes hold bit-identical results, see the same lo/hi, and run the
// bisection loop in lockstep with no divergence.  Padding slots hold -inf,
// which drops out of max and of the phi-sum (max(-inf - mid, 0) = 0); min
// skips them explicitly.
//
// What bounds it on the H100: at the main path's shape (50000, 100) float32
// the bytes term is 2 x 20 MB over 3.35 TB/s ~ 12 us and the operations term
// 50 steps x 3 operations (subtract, max, add) x R d ~ 0.75 GFLOP over
// 67 TFLOP/s ~ 11 us: the two are balanced.  Holding the row in registers
// keeps the 50 passes off memory altogether, so the kernel reads and writes
// each element once; at d = 100 a quarter of the lanes' slots are padding
// (V = 4 holds 128), which costs operations, not bytes.  At small R launch
// latency dominates.
//
// C interface (bound with ctypes): simplex_proj_f32 / simplex_proj_f64 take
// float32 / float64 y and x, launch on the given stream, allocate nothing,
// and return the CUDA error code of the launch (0 on success).

#include <cuda_runtime.h>

#include <math_constants.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = 32 * kWarpsPerBlock;
constexpr int kMaxRegDim = 1024;  // 32 values a lane
constexpr int kMaxDim = 32768;    // shared-memory path: 128 KB a row
constexpr int kIters = 50;        // bisection steps, as on the TPU
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  }
  return v;
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v = fminf(v, __shfl_xor_sync(kFull, v, off));
  }
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(kFull, v, off);
  }
  return v;
}

// Rows of d <= 32 V, each held in registers by one warp.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
simplex_rows_reg(const T* __restrict__ y, T* __restrict__ x, int rows, int d,
                 float scale, float scale_over_d) {
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp leaves together
  const T* yr = y + row * d;

  float v[V];
  float mx = -CUDART_INF_F;
  float mn = CUDART_INF_F;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int j = lane + 32 * i;
    if (j < d) {
      v[i] = static_cast<float>(yr[j]);
      mx = fmaxf(mx, v[i]);
      mn = fminf(mn, v[i]);
    } else {
      v[i] = -CUDART_INF_F;
    }
  }
  float hi = warp_max(mx);
  float lo = fminf(hi - scale, warp_min(mn) - scale_over_d);

  for (int it = 0; it < kIters; ++it) {
    const float mid = 0.5f * (lo + hi);
    float s = 0.0f;
#pragma unroll
    for (int i = 0; i < V; ++i) s += fmaxf(v[i] - mid, 0.0f);
    if (warp_sum(s) - scale > 0.0f) {
      lo = mid;  // tau too small
    } else {
      hi = mid;
    }
  }
  const float tau = 0.5f * (lo + hi);

  T* xr = x + row * d;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int j = lane + 32 * i;
    if (j < d) xr[j] = static_cast<T>(fmaxf(v[i] - tau, 0.0f));
  }
}

// Rows of d > 1024: one warp per block, the row in dynamic shared memory.
template <typename T>
__global__ void __launch_bounds__(32)
simplex_rows_smem(const T* __restrict__ y, T* __restrict__ x, int d,
                  float scale, float scale_over_d) {
  extern __shared__ float row_s[];
  const int lane = threadIdx.x;
  const long long row = blockIdx.x;
  const T* yr = y + row * d;

  float mx = -CUDART_INF_F;
  float mn = CUDART_INF_F;
  for (int j = lane; j < d; j += 32) {
    const float t = static_cast<float>(yr[j]);
    row_s[j] = t;
    mx = fmaxf(mx, t);
    mn = fminf(mn, t);
  }
  __syncwarp();
  float hi = warp_max(mx);
  float lo = fminf(hi - scale, warp_min(mn) - scale_over_d);

  for (int it = 0; it < kIters; ++it) {
    const float mid = 0.5f * (lo + hi);
    float s = 0.0f;
    for (int j = lane; j < d; j += 32) s += fmaxf(row_s[j] - mid, 0.0f);
    if (warp_sum(s) - scale > 0.0f) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  const float tau = 0.5f * (lo + hi);

  T* xr = x + row * d;
  for (int j = lane; j < d; j += 32) {
    xr[j] = static_cast<T>(fmaxf(row_s[j] - tau, 0.0f));
  }
}

template <typename T, int V>
void launch_reg(const T* y, T* x, int rows, int d, float scale,
                float scale_over_d, cudaStream_t stream) {
  const int grid = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  simplex_rows_reg<T, V><<<grid, kThreads, 0, stream>>>(
      y, x, rows, d, scale, scale_over_d);
}

template <typename T>
int launch(const void* y_ptr, void* x_ptr, int rows, int d, double scale,
           void* stream_ptr) {
  if (rows < 0 || d < 1 || d > kMaxDim) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows == 0) return static_cast<int>(cudaSuccess);
  const T* y = static_cast<const T*>(y_ptr);
  T* x = static_cast<T*>(x_ptr);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  // scale and scale / d are rounded to float32 once, as the TPU kernel's
  // weakly typed Python scalars are
  const float sc = static_cast<float>(scale);
  const float sod = static_cast<float>(scale / d);
  if (d <= kMaxRegDim) {
    const int vals = (d + 31) / 32;
    if (vals <= 1) {
      launch_reg<T, 1>(y, x, rows, d, sc, sod, stream);
    } else if (vals <= 2) {
      launch_reg<T, 2>(y, x, rows, d, sc, sod, stream);
    } else if (vals <= 4) {
      launch_reg<T, 4>(y, x, rows, d, sc, sod, stream);
    } else if (vals <= 8) {
      launch_reg<T, 8>(y, x, rows, d, sc, sod, stream);
    } else if (vals <= 16) {
      launch_reg<T, 16>(y, x, rows, d, sc, sod, stream);
    } else {
      launch_reg<T, 32>(y, x, rows, d, sc, sod, stream);
    }
  } else {
    const int smem = d * static_cast<int>(sizeof(float));
    const cudaError_t err = cudaFuncSetAttribute(
        simplex_rows_smem<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    simplex_rows_smem<T><<<rows, 32, smem, stream>>>(y, x, d, sc, sod);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int simplex_proj_f32(const void* y, void* x, int rows, int d,
                                double scale, void* stream) {
  return launch<float>(y, x, rows, d, scale, stream);
}

extern "C" int simplex_proj_f64(const void* y, void* x, int rows, int d,
                                double scale, void* stream) {
  return launch<double>(y, x, rows, d, scale, stream);
}
