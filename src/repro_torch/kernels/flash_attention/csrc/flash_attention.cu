// Forward flash attention for Hopper (sm_90a): online softmax over key tiles,
// one thread block per (batch * head, tile of 64 query rows).
//
// Replaces repro/kernels/flash_attention/kernel.py::_fa_kernel (reached
// through flash_attention_bhsd and the op repro/kernels/flash_attention/
// ops.py::flash_attention), the Pallas TPU kernel behind the dense models'
// prefill attention.  Same function: q is scaled by 1/sqrt(D) in float32,
// logits, the running row max m, the running row sum l and the accumulator
// are float32, causal entries above the diagonal get -1e30, key tiles past
// the diagonal are skipped, out = acc / max(l, 1e-30) in the input type.
// Causal alignment is the TPU kernel's: top-left, key j visible to query i
// when j <= i, also when Sq != Sk.
//
// Layout: q, o (B, Sq, H, D) and k, v (B, Sk, Hkv, D), contiguous, read and
// written in place (no transpose, no folding of heads).  GQA: query head h
// reads kv head h / (H / Hkv), so the kv heads are never repeated in memory.
// The TPU grid's sequential kv axis and its VMEM scratch become a loop inside
// the block: the block stages its Q tile (scaled, float32) in shared memory
// once, then for every key tile up to the causal limit stages K and V
// (float32), computes the 64 x 64 logits with each of 256 threads holding a
// 4 x 4 register tile (rows ty + 16 i, columns tx + 16 j), reduces row max and
// row sum over the 16 lanes that share a row with xor shuffles, writes P to
// shared memory, and adds P V into its 4 x (kMaxD / 16) accumulator.  Ragged
// tiles are masked (keys past Sk get probability 0, rows past Sq are not
// stored), so any Sq, Sk >= 1 work; D <= 256, with the unused head columns
// of the staged tiles zero.  kMaxD (64, 128 or 256) is the smallest that
// holds D; shared memory is 66 / 115 / 214 KB, dynamic above 48 KB.
//
// What bounds it on the H100: at the prefill shape (B, S, H, D) =
// (4, 2048, 20, 128) causal the work is ~86 GFLOP (QK^T and PV over the lower
// triangle) against ~168 MB of q, k, v and o, so the bound is the tensor-core
// rate (989 TFLOP/s bf16, 0.087 ms).  This first kernel does its products in
// float32 FMAs on CUDA cores (67 TFLOP/s peak) and feeds each FMA with about
// half a shared-memory load, so it is bound by instruction issue and shared
// memory bandwidth, far from the tensor-core bound: mma/wgmma tiles, K/V in
// bf16 through TMA, and warp specialisation are the redesign's work.
//
// C interface (bound with ctypes): flash_attention_f32 / flash_attention_bf16
// take float32 / bfloat16 q, k, v, o; launch on the given stream; allocate
// nothing; and return the CUDA error code of the launch (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;  // 16 x 16: ty picks rows, tx picks columns
constexpr int kRows = kBlockQ / 16;   // rows a thread owns: ty + 16 i
constexpr int kCols = kBlockK / 16;   // key columns a thread owns: tx + 16 j
constexpr int kPStride = kBlockK + 1;
constexpr float kNegInf = -1e30f;     // the TPU kernel's mask value

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// max / sum over the 16 lanes that hold one row (a half warp)
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

template <int kMaxD>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t(kBlockQ) * (kMaxD + 1)  // Q (padded rows)
                          + size_t(kBlockK) * (kMaxD + 1)  // K (padded rows)
                          + size_t(kBlockK) * kMaxD        // V
                          + size_t(kBlockQ) * kPStride);   // P
}

template <typename T, int kMaxD>
__global__ void __launch_bounds__(kThreads)
fa_forward(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, T* __restrict__ o, int Sq, int Sk, int H,
           int Hkv, int D, int causal, float scale) {
  constexpr int kQStride = kMaxD + 1;   // padded: rows on distinct banks
  constexpr int kKStride = kMaxD + 1;
  constexpr int kDCols = kMaxD / 16;  // head columns a thread owns
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + kBlockQ * kQStride;
  float* sV = sK + kBlockK * kKStride;
  float* sP = sV + kBlockK * kMaxD;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int hk = h / (H / Hkv);
  const int q0 = blockIdx.y * kBlockQ;
  const long long q_row = (long long)H * D;     // stride of a q/o row
  const long long k_row = (long long)Hkv * D;   // stride of a k/v row
  const T* qb = q + ((long long)b * Sq) * q_row + (long long)h * D;
  const T* kb = k + ((long long)b * Sk) * k_row + (long long)hk * D;
  const T* vb = v + ((long long)b * Sk) * k_row + (long long)hk * D;
  T* ob = o + ((long long)b * Sq) * q_row + (long long)h * D;

  for (int idx = tid; idx < kBlockQ * kMaxD; idx += kThreads) {
    const int r = idx / kMaxD, d = idx % kMaxD;
    const int qi = q0 + r;
    sQ[r * kQStride + d] =
        (qi < Sq && d < D) ? to_float(qb[qi * q_row + d]) * scale : 0.f;
  }

  float m[kRows], l[kRows], acc[kRows][kDCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kDCols; ++c) acc[i][c] = 0.f;
  }

  // causal: keys past the tile's last query row are never visible
  int k_end = Sk;
  if (causal) k_end = min(Sk, min(q0 + kBlockQ, Sq));
  for (int k0 = 0; k0 < k_end; k0 += kBlockK) {
    __syncthreads();  // the previous tile's K, V and P are no longer read
    for (int idx = tid; idx < kBlockK * kMaxD; idx += kThreads) {
      const int c = idx / kMaxD, d = idx % kMaxD;
      const int kj = k0 + c;
      const bool in = kj < Sk && d < D;
      sK[c * kKStride + d] = in ? to_float(kb[kj * k_row + d]) : 0.f;
      sV[idx] = in ? to_float(vb[kj * k_row + d]) : 0.f;
    }
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < kMaxD; ++d) {
      float qv[kRows], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = sQ[(ty + 16 * i) * kQStride + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kv[j] = sK[(tx + 16 * j) * kKStride + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qi = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kj = k0 + tx + 16 * j;
        if (kj >= Sk) {
          s[i][j] = -CUDART_INF_F;  // ragged tile: probability exactly 0
        } else if (causal && kj > qi) {
          s[i][j] = kNegInf;
        }
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        sP[(ty + 16 * i) * kPStride + tx + 16 * j] = p;
      }
      l[i] = alpha * l[i] + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kDCols; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    const int n_keys = min(kBlockK, Sk - k0);
#pragma unroll 4
    for (int c = 0; c < n_keys; ++c) {
      float pv[kRows], vv[kDCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = sP[(ty + 16 * i) * kPStride + c];
#pragma unroll
      for (int e = 0; e < kDCols; ++e) vv[e] = sV[c * kMaxD + tx + 16 * e];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int e = 0; e < kDCols; ++e)
          acc[i][e] = fmaf(pv[i], vv[e], acc[i][e]);
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= Sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int e = 0; e < kDCols; ++e) {
      const int d = tx + 16 * e;
      if (d < D) ob[qi * q_row + d] = from_float<T>(acc[i][e] * inv);
    }
  }
}

template <typename T, int kMaxD>
int launch_d(const T* q, const T* k, const T* v, T* o, int B, int Sq, int Sk,
             int H, int Hkv, int D, int causal, float scale,
             cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<kMaxD>();
  cudaError_t err = cudaFuncSetAttribute(
      fa_forward<T, kMaxD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(bytes));
  if (err != cudaSuccess) return int(err);
  dim3 grid(B * H, (Sq + kBlockQ - 1) / kBlockQ);
  fa_forward<T, kMaxD><<<grid, kThreads, bytes, stream>>>(
      q, k, v, o, Sq, Sk, H, Hkv, D, causal, scale);
  return int(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Sk, int H, int Hkv, int D, int causal, float scale,
           cudaStream_t stream) {
  auto* qt = static_cast<const T*>(q);
  auto* kt = static_cast<const T*>(k);
  auto* vt = static_cast<const T*>(v);
  auto* ot = static_cast<T*>(o);
  if (D <= 64)
    return launch_d<T, 64>(qt, kt, vt, ot, B, Sq, Sk, H, Hkv, D, causal,
                           scale, stream);
  if (D <= 128)
    return launch_d<T, 128>(qt, kt, vt, ot, B, Sq, Sk, H, Hkv, D, causal,
                            scale, stream);
  if (D <= 256)
    return launch_d<T, 256>(qt, kt, vt, ot, B, Sq, Sk, H, Hkv, D, causal,
                            scale, stream);
  return int(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

int flash_attention_f32(const void* q, const void* k, const void* v, void* o,
                        int B, int Sq, int Sk, int H, int Hkv, int D,
                        int causal, float scale, void* stream) {
  return launch<float>(q, k, v, o, B, Sq, Sk, H, Hkv, D, causal, scale,
                       static_cast<cudaStream_t>(stream));
}

int flash_attention_bf16(const void* q, const void* k, const void* v, void* o,
                         int B, int Sq, int Sk, int H, int Hkv, int D,
                         int causal, float scale, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, B, Sq, Sk, H, Hkv, D, causal,
                               scale, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
