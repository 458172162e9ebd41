// Batched conjugate gradient for Hopper (sm_90a), the cluster route: each
// instance of a batch of dense SPD systems A[i] x[i] = b[i] (d <= 512) is
// solved by one thread-block cluster of C CTAs that holds the instance's A in
// shared memory for all of its iterations.
//
// Replaces repro/kernels/batched_cg/kernel.py::_batched_cg_kernel, the Pallas
// TPU kernel behind the `pallas_cg` solver, for every (d, dtype) whose slice
// fits (kernel.py::layout; what does not fit, float64 at d = 512, takes the
// stream route of batched_cg.cu).  Same recurrence and guards as
// repro_torch/kernels/batched_cg/ref.py: Hestenes-Stiefel CG from x0 = 0,
// alpha = 0 where p'Ap = 0, beta = 0 where rs = 0, an instance stops once
// rs <= max(tol^2 |b|^2, 1e-30) or after maxiter steps; each instance leaves
// its loop on its own, which gives the Pallas kernel's x because a frozen
// row's update is a no-op there.
//
// Layout.  Grid = B C CTAs of 256 threads, cluster dimension (C, 1, 1),
// C in {1, 2, 4, 8} (the portable sizes); kernel.py::layout picks the
// smallest C whose slice fits the 227 KB a block may use (the same byte
// count as smem_bytes below).  CTA c of an instance's cluster owns rows
// [c R, (c + 1) R) of the system, R = ceil(d / C), and keeps in dynamic
// shared memory:
//   * its R x d slice of A, rows `stride` elements apart: d rounded up to
//     128 bytes plus 16, so that eight consecutive rows start in eight
//     different 16-byte bank groups;
//   * its slices of x, r and Ap, a full copy of p (zero past d), the warps'
//     partial sums and two cluster slots (p'Ap and r'r).
// The slice is loaded once with cp.async: 16-byte copies of row pieces when
// d is a multiple of the vector width and A is 16-byte aligned, one element
// at a time otherwise.  The backward solve on A^T loads columns [c R, ...)
// of A as the rows of its slice: a warp copies an 8 x 4 tile (8 columns
// next to each other in a row of A, 4 rows), so the device-memory reads stay
// in whole 32-byte sectors and the shared-memory writes hit 32 banks; the
// iteration loop is then the same code in both directions.
//
// One iteration:
//   1. Ap_slice = A_slice p from shared memory: a warp per row, four rows
//      (two in float64) reduced side by side, lanes over the columns with
//      float4 / double2 reads (a row is contiguous, so no bank conflicts),
//      each lane's share of p held in registers for the whole matvec; p'Ap
//      over the slice beside it.
//   2. The CTA's partial goes to its p'Ap slot; cluster barrier; every CTA
//      reads the C slots through distributed shared memory and sums them in
//      rank order 0 .. C-1, so all CTAs of a cluster hold bit-identical
//      alpha (and below beta and rs) and leave the loop on the same
//      iteration (a CTA that left alone would deadlock the barrier).
//   3. x and r slices updated, r'r partial to the r'r slot; cluster barrier;
//      rs_new summed in rank order as in 2.
//   4. p = r + beta p over the whole vector on every CTA, reading the other
//      CTAs' r slices through distributed shared memory (the gather of the
//      new r takes the place of a gather of the new p, with the same
//      arithmetic, so it needs no third barrier).
// Two slots alternate, so a value is overwritten only after a barrier that
// every reader of it has passed: the p'Ap slot is rewritten after step 3's
// barrier, which a CTA reaches after reading the slot in step 2; the r'r
// slot and the r slice are rewritten after the next iteration's step-2
// barrier, which a CTA reaches after reading them in steps 3 and 4.  A last
// cluster barrier keeps every CTA resident until no other can read its
// shared memory.
//
// What bounds it on the H100: A is read from device memory once, B d^2
// sizeof(T) bytes (64 MiB at B = 64, d = 512, float32: 0.020 ms at
// 3.35 TB/s), the bound chip_smoke.py reports.  After the load an iteration
// costs a shared-memory matvec (128 KB a CTA at d = 512, C = 8: about 1,000
// cycles at 128 bytes a cycle), two cluster barriers and a 2 KB gather; one
// CTA of this size fits an SM, so about 16 clusters of 8 run at once and a
// batch of 64 takes four to five waves.  PERF.md has the times.
//
// C interface (bound with ctypes): batched_cg_cluster_f32 / _f64 launch on
// the given stream, allocate nothing, refuse (cudaErrorInvalidValue) a
// layout whose slice does not fit or a C outside {1, 2, 4, 8}, and return
// cudaGetLastError(); batched_cg_cluster_smem_bytes gives the shared memory
// a CTA of a layout takes, and batched_cg_cluster_max_active the most
// clusters of a layout that are resident at once on the current device.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <atomic>
#include <climits>
#include <cstddef>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDim = 512;
constexpr int kBudget = 232448;   // 227 KB, the most a block may use
constexpr int kSlots = 3;         // p'Ap, r'r, |b|^2
constexpr int kGather = (kMaxDim + kThreads - 1) / kThreads;

template <typename T>
struct Vec;
template <>
struct Vec<float> {
  using type = float4;
  static constexpr int n = 4;
};
template <>
struct Vec<double> {
  using type = double2;
  static constexpr int n = 2;
};

__device__ __forceinline__ float dot_acc(float4 a, float4 b, float s) {
  s = fmaf(a.x, b.x, s);
  s = fmaf(a.y, b.y, s);
  s = fmaf(a.z, b.z, s);
  return fmaf(a.w, b.w, s);
}

__device__ __forceinline__ double dot_acc(double2 a, double2 b, double s) {
  s = fma(a.x, b.x, s);
  return fma(a.y, b.y, s);
}

// Elements between two rows of the slice: d rounded up to 128 bytes, plus
// 16 bytes.
__host__ __device__ constexpr int row_stride(int d, int elem) {
  return ((d * elem / 4 + 31) / 32 * 32 + 4) * 4 / elem;
}

__host__ __device__ constexpr int rows_per_cta(int d, int C) {
  return (d + C - 1) / C;
}

// Dynamic shared memory of one CTA: the slice, x, r and Ap slices, the full
// p, the warps' partials and the slots.  kernel.py::smem_bytes is the same
// count.
__host__ __device__ constexpr size_t smem_bytes(int d, int C, int elem) {
  return static_cast<size_t>(elem) *
         (static_cast<size_t>(rows_per_cta(d, C)) * (row_stride(d, elem) + 3) +
          row_stride(d, elem) + kWarps + kSlots);
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

// Sum of one value a thread over the CTA into *out, in warp order; the
// caller's barrier publishes it.
template <typename T>
__device__ __forceinline__ void cta_sum(T v, T* wpart, T* out) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) wpart[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    T s = wpart[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s += wpart[w];
    *out = s;
  }
}

// The C CTAs' values of a slot, summed in rank order: the same bits on every
// CTA of the cluster.
template <typename T, int C>
__device__ __forceinline__ T cluster_sum(cg::cluster_group& cluster,
                                         T* slot) {
  T s = *cluster.map_shared_rank(slot, 0);
#pragma unroll
  for (int c = 1; c < C; ++c) s += *cluster.map_shared_rank(slot, c);
  return s;
}

template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
                 "l"(src), "n"(kBytes)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Rows [row0, row0 + rows) of Ai (transpose == 0), or columns (transpose ==
// 1) as rows, into As, rows `stride` apart; the columns from d up to the
// next multiple of the vector width are zeroed.  Asynchronous: the caller
// waits with cp_async_wait_all.
template <typename T>
__device__ __forceinline__ void load_slice(const T* __restrict__ Ai, T* As,
                                           int d, int row0, int rows,
                                           int stride, int transpose,
                                           bool vec_ok) {
  constexpr int kVec = Vec<T>::n;
  const int tid = threadIdx.x;
  if (transpose) {
    // a warp copies 8 slice rows (columns of A) x 4 of their elements
    const int lane = tid & 31, warp = tid >> 5;
    const int ii = lane & 7, jj = lane >> 3;
    const int ni = (rows + 7) / 8, nj = (d + 3) / 4;
    for (int u = warp; u < ni * nj; u += kWarps) {
      const int i = (u % ni) * 8 + ii;
      const int j = (u / ni) * 4 + jj;
      if (i < rows && j < d) {
        cp_async<sizeof(T)>(As + static_cast<size_t>(i) * stride + j,
                            Ai + static_cast<size_t>(j) * d + row0 + i);
      }
    }
  } else if (vec_ok) {
    const int nv = d / kVec;
    for (int e = tid; e < rows * nv; e += kThreads) {
      const int i = e / nv, v = e - i * nv;
      cp_async<16>(As + static_cast<size_t>(i) * stride + v * kVec,
                   Ai + static_cast<size_t>(row0 + i) * d + v * kVec);
    }
  } else {
    for (int e = tid; e < rows * d; e += kThreads) {
      const int i = e / d, j = e - i * d;
      cp_async<sizeof(T)>(As + static_cast<size_t>(i) * stride + j,
                          Ai + static_cast<size_t>(row0 + i) * d + j);
    }
  }
  const int pad = (d + kVec - 1) / kVec * kVec - d;
  for (int e = tid; e < rows * pad; e += kThreads) {
    const int i = e / pad;
    As[static_cast<size_t>(i) * stride + d + (e - i * pad)] = T(0);
  }
}

template <typename T, int C>
__global__ void __launch_bounds__(kThreads)
batched_cg_cluster_kernel(const T* __restrict__ A, const T* __restrict__ b,
                          T* __restrict__ x_out, int d, T tol2, int maxiter,
                          int transpose, int vec_ok) {
  using V = typename Vec<T>::type;
  constexpr int kVec = Vec<T>::n;
  constexpr int kLaneVecs = kMaxDim / (32 * kVec);  // of p, a lane
  // rows a warp reduces side by side (fewer in float64: registers)
  constexpr int kRowsAtOnce = sizeof(T) == 4 ? 4 : 2;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const size_t inst = blockIdx.x / C;
  const int stride = row_stride(d, sizeof(T));
  const int R = rows_per_cta(d, C);
  const int row0 = rank * R;
  const int rows = max(0, min(R, d - row0));
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  extern __shared__ __align__(16) unsigned char smem[];
  T* As = reinterpret_cast<T*>(smem);
  T* p = As + static_cast<size_t>(R) * stride;  // the full vector
  T* x = p + stride;
  T* r = x + R;
  T* ap = r + R;
  T* wpart = ap + R;
  T* slot = wpart + kWarps;  // [0] p'Ap, [1] r'r, [2] |b|^2

  const T* Ai = A + inst * static_cast<size_t>(d) * d;
  const T* bi = b + inst * static_cast<size_t>(d);
  load_slice(Ai, As, d, row0, rows, stride, transpose, vec_ok != 0);

  // |b|^2 over the whole vector: the same bits on every CTA
  T part = T(0);
  for (int j = tid; j < stride; j += kThreads) {
    const T v = j < d ? bi[j] : T(0);
    p[j] = v;
    part += v * v;
  }
  for (int i = tid; i < rows; i += kThreads) {
    x[i] = T(0);
    r[i] = bi[row0 + i];  // r0 = b - A 0
  }
  cta_sum(part, wpart, &slot[2]);
  // where each of this thread's entries of the new p reads its r
  const T* rsrc[kGather];
#pragma unroll
  for (int t = 0; t < kGather; ++t) {
    const int j = tid + t * kThreads;
    const int owner = j < d ? j / R : 0;
    rsrc[t] = cluster.map_shared_rank(r, owner) + (j < d ? j - owner * R : 0);
  }
  cp_async_wait_all();
  __syncthreads();  // slice, vectors and |b|^2 in place
  const T bb = slot[2];
  T rs = bb;
  T atol2 = tol2 * bb;
  if (atol2 < T(1e-30)) atol2 = T(1e-30);

  const int nv = (d + kVec - 1) / kVec;
  const V* p_v = reinterpret_cast<const V*>(p);
  for (int k = 0; k < maxiter && rs > atol2; ++k) {
    // 1. Ap = A p on the slice, and p'Ap beside it
    V pr[kLaneVecs];
#pragma unroll
    for (int q = 0; q < kLaneVecs; ++q) {
      const int v = lane + 32 * q;
      pr[q] = v < nv ? p_v[v] : V{};
    }
    T pap = T(0);
    for (int i0 = warp * kRowsAtOnce; i0 < rows;
         i0 += kWarps * kRowsAtOnce) {
      T s[kRowsAtOnce];
#pragma unroll
      for (int u = 0; u < kRowsAtOnce; ++u) {
        s[u] = T(0);
        if (i0 + u < rows) {
          const V* Ar = reinterpret_cast<const V*>(
              As + static_cast<size_t>(i0 + u) * stride);
#pragma unroll
          for (int q = 0; q < kLaneVecs; ++q) {
            const int v = lane + 32 * q;
            if (v < nv) s[u] = dot_acc(Ar[v], pr[q], s[u]);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kRowsAtOnce; ++u) s[u] = warp_sum(s[u]);
#pragma unroll
      for (int u = 0; u < kRowsAtOnce; ++u) {
        if (i0 + u < rows) {
          if (lane == 0) ap[i0 + u] = s[u];
          pap += p[row0 + i0 + u] * s[u];
        }
      }
    }
    // 2. alpha from the cluster's p'Ap
    cta_sum(lane == 0 ? pap : T(0), wpart, &slot[0]);
    cluster.sync();
    const T denom = cluster_sum<T, C>(cluster, &slot[0]);
    const T alpha = denom == T(0) ? T(0) : rs / denom;

    // 3. x, r and the cluster's r'r
    T rr = T(0);
    for (int i = tid; i < rows; i += kThreads) {
      x[i] += alpha * p[row0 + i];
      const T ri = r[i] - alpha * ap[i];
      r[i] = ri;
      rr += ri * ri;
    }
    cta_sum(rr, wpart, &slot[1]);
    cluster.sync();
    const T rs_new = cluster_sum<T, C>(cluster, &slot[1]);
    const T beta = rs == T(0) ? T(0) : rs_new / rs;
    rs = rs_new;

    // 4. p = r + beta p, every CTA over the whole vector, unless the loop
    // ends here
    if (k + 1 < maxiter && rs > atol2) {
#pragma unroll
      for (int t = 0; t < kGather; ++t) {
        const int j = tid + t * kThreads;
        if (j < d) p[j] = *rsrc[t] + beta * p[j];
      }
      __syncthreads();  // p complete before the next matvec
    }
  }

  T* xo = x_out + inst * static_cast<size_t>(d) + row0;
  for (int i = tid; i < rows; i += kThreads) xo[i] = x[i];
  cluster.sync();  // no CTA leaves while another may read its r or slots
}

// One attribute call a device and instantiation (not on every launch, so
// that a launch can be captured in a CUDA graph): the most dynamic shared
// memory a block may use.
template <typename T, int C>
cudaError_t allow_smem() {
  static std::atomic<unsigned long long> done{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (done.load() & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(batched_cg_cluster_kernel<T, C>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kBudget);
  if (err == cudaSuccess) done.fetch_or(bit);
  return err;
}

template <typename T, int C>
cudaLaunchConfig_t config(int grid, int d, cudaStream_t stream,
                          cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem_bytes(d, C, sizeof(T));
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename T, int C>
int launch_c(const void* A, const void* b, void* x, int batch, int d,
             double tol, int maxiter, int transpose, cudaStream_t stream) {
  cudaError_t err = allow_smem<T, C>();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config<T, C>(batch * C, d, stream, &attr);
  constexpr int kVec = Vec<T>::n;
  const int vec_ok =
      d % kVec == 0 && reinterpret_cast<uintptr_t>(A) % 16 == 0;
  err = cudaLaunchKernelEx(&cfg, batched_cg_cluster_kernel<T, C>,
                           static_cast<const T*>(A),
                           static_cast<const T*>(b), static_cast<T*>(x), d,
                           static_cast<T>(tol * tol), maxiter, transpose,
                           vec_ok);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

bool fits(int d, int C, int elem) {
  return d >= 1 && d <= kMaxDim && (C == 1 || C == 2 || C == 4 || C == 8) &&
         smem_bytes(d, C, elem) <= static_cast<size_t>(kBudget);
}

template <typename T>
int launch(const void* A, const void* b, void* x, int batch, int d,
           double tol, int maxiter, int transpose, int C, void* stream) {
  if (!fits(d, C, sizeof(T)) || batch < 0 || batch > INT_MAX / C) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0) return static_cast<int>(cudaSuccess);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 1:
      return launch_c<T, 1>(A, b, x, batch, d, tol, maxiter, transpose, s);
    case 2:
      return launch_c<T, 2>(A, b, x, batch, d, tol, maxiter, transpose, s);
    case 4:
      return launch_c<T, 4>(A, b, x, batch, d, tol, maxiter, transpose, s);
    default:
      return launch_c<T, 8>(A, b, x, batch, d, tol, maxiter, transpose, s);
  }
}

template <typename T, int C>
int max_active_c(int d, int* clusters) {
  cudaError_t err = allow_smem<T, C>();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config<T, C>(1024 * C, d, nullptr, &attr);
  return static_cast<int>(cudaOccupancyMaxActiveClusters(
      clusters, batched_cg_cluster_kernel<T, C>, &cfg));
}

template <typename T>
int max_active(int d, int C, int* clusters) {
  if (!fits(d, C, sizeof(T))) return static_cast<int>(cudaErrorInvalidValue);
  switch (C) {
    case 1:
      return max_active_c<T, 1>(d, clusters);
    case 2:
      return max_active_c<T, 2>(d, clusters);
    case 4:
      return max_active_c<T, 4>(d, clusters);
    default:
      return max_active_c<T, 8>(d, clusters);
  }
}

}  // namespace

extern "C" int batched_cg_cluster_f32(const void* A, const void* b, void* x,
                                      int batch, int d, double tol,
                                      int maxiter, int transpose, int C,
                                      void* stream) {
  return launch<float>(A, b, x, batch, d, tol, maxiter, transpose, C,
                       stream);
}

extern "C" int batched_cg_cluster_f64(const void* A, const void* b, void* x,
                                      int batch, int d, double tol,
                                      int maxiter, int transpose, int C,
                                      void* stream) {
  return launch<double>(A, b, x, batch, d, tol, maxiter, transpose, C,
                        stream);
}

// Shared memory of one CTA of layout C at (d, element size), whether or not
// it fits.
extern "C" long long batched_cg_cluster_smem_bytes(int elem, int d, int C) {
  return static_cast<long long>(smem_bytes(d, C, elem));
}

// The most clusters of layout C at (d, element size) resident at once on the
// current device, into *clusters.
extern "C" int batched_cg_cluster_max_active(int elem, int d, int C,
                                             int* clusters) {
  return elem == 8 ? max_active<double>(d, C, clusters)
                   : max_active<float>(d, C, clusters);
}
