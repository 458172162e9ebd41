// Row-wise Euclidean projection onto the scale-simplex {x >= 0, sum x = scale}
// for Hopper (sm_90a): a few lanes per row, and a bisection that stops as
// soon as the support of the answer is known.
//
// Replaces repro/kernels/simplex_proj/kernel.py::_simplex_kernel, the Pallas
// TPU kernel behind projection_simplex_batched.  Same function as
// repro_torch/kernels/simplex_proj/ref.py: everything in float32 whatever the
// input type, the threshold tau of
//   phi(tau) = sum_i max(y_i - tau, 0) - scale = 0
// bisected over the bracket hi = max(y), lo = min(max(y) - scale,
// min(y) - scale/d) for at most kIters = 50 steps, the output
// max(y - tau, 0) cast back to the input type.
//
// Early end.  Each step evaluates phi at mid from the sum s and the count c
// of the row's values above mid (phi(mid) = s - c mid - scale) and keeps the
// count at both ends of the bracket.  Once c(lo) == c(hi), no value lies in
// (lo, hi], so the support {y > tau} is fixed and phi is linear on the
// bracket: tau = (s(lo) - scale) / c(lo) exactly, and the loop stops.  The
// bracket starts with c(lo) = d and s(lo) = sum y (lo < min y whenever
// scale > 0; when it is not, c(hi) can never reach d and the claim is never
// used).  A row whose tau equals one of its values (ties at the threshold,
// e.g. y = (2, 1, 1)) keeps that value inside the bracket, never meets the
// test and runs the 50 steps, taking the bracket's midpoint as the TPU
// kernel does.  (Should rounding of phi flip a decision within float32
// rounding of tau, the test may then pass: the support it takes differs
// from {y > tau} only by values equal to tau, which add nothing to the sum,
// so tau is still right.  At y = (1, 0, 0) that happens after two steps.)
//
// Layout, one rule (kernel.py::layout, the caller's choice):
//   * d <= 1024: a row gets L lanes, L in {8, 16, 32} the fewest that hold
//     it at V = 16 values a lane (V = 32 on the whole warp for
//     512 < d <= 1024); lane p of a row holds y[p], y[p + L], ... in
//     registers.  A warp holds 32 / L rows and a block 256 threads, so loads
//     stay coalesced across the warp's rows.  Reductions are xor butterflies
//     over the L lanes of a row (log2 L levels; sum and count side by side),
//     so every lane of a row holds the same bits and takes the same branch.
//     L is a template parameter, so the butterflies have no branches.  L
//     stops at 8 below: fewer lanes would put more rows in a warp, and a
//     warp runs until its slowest row ends.  At d = 100: L = 8, V = 16, 4
//     rows a warp, 3 shuffle levels a step.  Four instantiations per input
//     type: (L, V) = (8, 16), (16, 16), (32, 16) and (32, 32).
//   * 1024 < d <= 32768: one warp per row, the row in dynamic shared memory,
//     the same bisection with the early end over the warp.
// Padding slots hold -inf: never above mid, and skipped by min and sum.  A
// warp runs until the last of its rows is done; rows past the end are done
// from the start.
//
// What bounds it on the H100: at the main path's shape (50000, 100) float32
// the bytes term is 2 x 20 MB over 3.35 TB/s = 12 us; the TPU kernel's 50
// steps would be 50 x 3 operations x R d = 0.75 GFLOP, 11 us at 67 TFLOP/s.
// Random rows there end their bisection after a few steps (the emulation
// in tests/test_torch_simplex_proj.py counts them), each step 3 operations
// a slot (128 slots for 100 values) and two 3-level butterflies, so the
// loop is a minority of the time and the kernel is bound by moving y and x,
// near the bytes bound.  Rows with ties at the threshold run all 50 steps
// (chip_smoke.py times both).  The host's cost of a launch through
// kernel.launch is of the same order as the kernel's time on the card.
// PERF.md has the times.
//
// C interface (bound with ctypes): simplex_proj_f32 / simplex_proj_f64 take
// float32 / float64 y and x and the layout (lanes, values: values = 0 for
// the shared-memory path), launch on the given stream, allocate nothing, and
// return the CUDA error code of the launch (0 on success;
// cudaErrorInvalidValue for a layout that does not hold the row).

#include <cuda_runtime.h>

#include <math_constants.h>

namespace {

constexpr int kThreads = 256;     // register path: 8 warps a block
constexpr int kMaxDim = 32768;    // shared-memory path: 128 KB a row
constexpr int kIters = 50;        // bisection steps at most, as on the TPU
constexpr unsigned kFull = 0xffffffffu;

// Reductions over the L lanes (a power of two) of one row: xor butterflies
// that stay inside each aligned group of L lanes.
template <int L>
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1) {
    v += __shfl_xor_sync(kFull, v, off);
  }
  return v;
}

template <int L>
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  }
  return v;
}

template <int L>
__device__ __forceinline__ float row_min(float v) {
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1) {
    v = fminf(v, __shfl_xor_sync(kFull, v, off));
  }
  return v;
}

// tau of one row held by L lanes.  above(mid, s, c) sets this lane's sum
// and count of the row's values above mid; (s_lo, c_lo) are the sum and
// count above lo.  Every lane of the warp calls it (the shuffles span the
// warp); a lane whose row is done leaves its bracket as it is.
template <int L, typename Above>
__device__ __forceinline__ float threshold(Above above, float lo, float hi,
                                           float s_lo, float c_lo,
                                           float scale, bool done) {
  float c_hi = 0.0f;  // nothing lies above max(y)
  for (int it = 0; it < kIters && __any_sync(kFull, !done); ++it) {
    const float mid = 0.5f * (lo + hi);
    float s, c;
    above(mid, s, c);
    s = row_sum<L>(s);
    c = row_sum<L>(c);
    const bool up = !done && s - c * mid - scale > 0.0f;  // tau too small
    const bool down = !done && !up;
    lo = up ? mid : lo;
    s_lo = up ? s : s_lo;
    c_lo = up ? c : c_lo;
    hi = down ? mid : hi;
    c_hi = down ? c : c_hi;
    done = done || c_lo == c_hi;
  }
  return c_lo == c_hi ? (s_lo - scale) / c_lo : 0.5f * (lo + hi);
}

// Rows of d <= L * V, each held in registers by L lanes.
template <typename T, int L, int V>
__global__ void __launch_bounds__(kThreads)
simplex_rows_reg(const T* __restrict__ y, T* __restrict__ x, int rows, int d,
                 float scale, float scale_over_d) {
  const int pos = threadIdx.x % L;
  const long long row =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) / L;
  const bool live = row < rows;
  if (!__any_sync(kFull, live)) return;  // the whole warp is past the end
  const T* yr = y + row * d;

  float v[V];
  float mx = -CUDART_INF_F;
  float mn = CUDART_INF_F;
  float sum = 0.0f;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int j = pos + L * i;
    if (live && j < d) {
      v[i] = static_cast<float>(yr[j]);
      mx = fmaxf(mx, v[i]);
      mn = fminf(mn, v[i]);
      sum += v[i];
    } else {
      v[i] = -CUDART_INF_F;
    }
  }
  const float hi = row_max<L>(mx);
  const float lo = fminf(hi - scale, row_min<L>(mn) - scale_over_d);
  sum = row_sum<L>(sum);

  auto above = [&](float mid, float& s, float& c) {
    s = 0.0f;
    c = 0.0f;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      if (v[i] > mid) {
        s += v[i];
        c += 1.0f;
      }
    }
  };
  const float tau = threshold<L>(above, lo, hi, sum, static_cast<float>(d),
                                 scale, !live);
  if (!live) return;

  T* xr = x + row * d;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int j = pos + L * i;
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
  float sum = 0.0f;
  for (int j = lane; j < d; j += 32) {
    const float t = static_cast<float>(yr[j]);
    row_s[j] = t;
    mx = fmaxf(mx, t);
    mn = fminf(mn, t);
    sum += t;
  }
  __syncwarp();
  const float hi = row_max<32>(mx);
  const float lo = fminf(hi - scale, row_min<32>(mn) - scale_over_d);
  sum = row_sum<32>(sum);

  auto above = [&](float mid, float& s, float& c) {
    s = 0.0f;
    c = 0.0f;
    for (int j = lane; j < d; j += 32) {
      const float t = row_s[j];
      if (t > mid) {
        s += t;
        c += 1.0f;
      }
    }
  };
  const float tau = threshold<32>(above, lo, hi, sum, static_cast<float>(d),
                                  scale, false);

  T* xr = x + row * d;
  for (int j = lane; j < d; j += 32) {
    xr[j] = static_cast<T>(fmaxf(row_s[j] - tau, 0.0f));
  }
}

template <typename T, int L, int V>
void launch_reg(const T* y, T* x, int rows, int d, float scale,
                float scale_over_d, cudaStream_t stream) {
  const long long threads = static_cast<long long>(rows) * L;
  const int grid = static_cast<int>((threads + kThreads - 1) / kThreads);
  simplex_rows_reg<T, L, V><<<grid, kThreads, 0, stream>>>(
      y, x, rows, d, scale, scale_over_d);
}

template <typename T>
int launch(const void* y_ptr, void* x_ptr, int rows, int d, int lanes,
           int values, double scale, void* stream_ptr) {
  const bool reg = ((lanes == 8 || lanes == 16 || lanes == 32) &&
                    values == 16) || (lanes == 32 && values == 32);
  if (rows < 0 || d < 1 || d > kMaxDim || !(reg || values == 0) ||
      (reg && d > lanes * values)) {
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
  if (reg && values == 32) {
    launch_reg<T, 32, 32>(y, x, rows, d, sc, sod, stream);
  } else if (reg && lanes == 32) {
    launch_reg<T, 32, 16>(y, x, rows, d, sc, sod, stream);
  } else if (reg && lanes == 16) {
    launch_reg<T, 16, 16>(y, x, rows, d, sc, sod, stream);
  } else if (reg) {
    launch_reg<T, 8, 16>(y, x, rows, d, sc, sod, stream);
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
                                int lanes, int values, double scale,
                                void* stream) {
  return launch<float>(y, x, rows, d, lanes, values, scale, stream);
}

extern "C" int simplex_proj_f64(const void* y, void* x, int rows, int d,
                                int lanes, int values, double scale,
                                void* stream) {
  return launch<double>(y, x, rows, d, lanes, values, scale, stream);
}
