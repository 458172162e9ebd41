// RWKV-6 WKV recurrence (forward) for Hopper (sm_90a): one thread block of
// 64 threads per (batch, head), looping over all T time steps.
//
// Replaces repro/kernels/rwkv_wkv/kernel.py::_wkv_kernel (reached through
// wkv_bh and the op repro/kernels/rwkv_wkv/ops.py::wkv), the Pallas TPU
// kernel behind the RWKV-6 models' prefill time mixing.  Same function, per
// head of size N = 64, in float32:
//
//   o_t[j] = sum_i r_t[i] (S[i][j] + u[i] k_t[i] v_t[j])
//   S[i][j] <- w_t[i] S[i][j] + k_t[i] v_t[j]
//
// from S = state0 (zeros when none is given), returning o in r's type and the
// final S in float32.  The u-term is refactored as v_t[j] sum_i r_t[i] u[i]
// k_t[i]: the same function, with the bonus computed once per step.
//
// Layout: r, k, v, w and o are (B, T, H, 64), contiguous, read and written
// in place (no transpose to (B H, T, N)); u is (H, 64); state0 and the final
// state are (B, H, 64, 64) row-major, S[i][j] at i * 64 + j.  Thread j keeps
// column j of S in 64 registers for the whole sequence, so the state never
// leaves the SM (the TPU kernel keeps it in VMEM across its sequential chunk
// axis; here the time loop is inside the block and needs no chunking).
// Every kChunk = 32 steps the block stages r, k, v, w of those steps in
// shared memory (each thread loads its own lane of every step, so the loads
// of the chunk are in flight together); inside the chunk a step reads r, k,
// w and u by broadcast from shared memory and needs no barrier.  Any T >= 1.
//
// What bounds it on the H100: at the prefill shape (B, T, H) = (4, 2048, 40)
// the function moves ~257 MB (r, k, v in bf16, w in float32, o, and the two
// states) = 0.077 ms at 3.35 TB/s, and does 5 N^2 = 20,480 float32
// operations a (b, h, t) (a multiply-add for o: 2 N^2; k v, w S and their
// sum for S: 3 N^2) ~ 6.7 GFLOP = 0.100 ms at 67 TFLOP/s, so it is bound by
// operations, narrowly.  This kernel runs only B H = 160 blocks of two warps
// (about one block an SM), each a dependent walk over 2048 steps of about 400
// instructions a thread, so it is bound by per-warp instruction issue and
// latency, not by bytes or the card's FLOP rate: splitting a head's columns
// over more threads, or the chunked (matrix) form on tensor cores, is the
// redesign's work.
//
// C interface (bound with ctypes): rwkv_wkv_f32 / rwkv_wkv_bf16 take float32 /
// bfloat16 r, k, v and o, float32 w, u, state0 (may be null) and final state;
// launch on the given stream; allocate nothing; and return the CUDA error
// code of the launch (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kN = 64;       // RWKV-6 head size; one thread a column of S
constexpr int kChunk = 32;   // time steps staged in shared memory at once

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

template <typename T>
__global__ void __launch_bounds__(kN)
wkv6_forward(const T* __restrict__ r, const T* __restrict__ k,
             const T* __restrict__ v, const float* __restrict__ w,
             const float* __restrict__ u, const float* __restrict__ state0,
             T* __restrict__ o, float* __restrict__ state_out, int T_len,
             int H) {
  __shared__ __align__(16) float s_r[kChunk][kN];
  __shared__ __align__(16) float s_k[kChunk][kN];
  __shared__ __align__(16) float s_w[kChunk][kN];
  __shared__ __align__(16) float s_u[kN];
  __shared__ float s_v[kChunk][kN];

  const int j = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const long long row = (long long)H * kN;            // stride of a time step
  const long long base = (long long)b * T_len * row + (long long)h * kN + j;

  float S[kN];
  const float* s0 = state0 ? state0 + (long long)bh * kN * kN : nullptr;
#pragma unroll
  for (int i = 0; i < kN; ++i) S[i] = s0 ? s0[i * kN + j] : 0.f;
  s_u[j] = u[h * kN + j];

  for (int t0 = 0; t0 < T_len; t0 += kChunk) {
    const int n = min(kChunk, T_len - t0);
    __syncthreads();  // the previous chunk is no longer read
    for (int s = 0; s < n; ++s) {
      const long long off = base + (long long)(t0 + s) * row;
      s_r[s][j] = to_float(r[off]);
      s_k[s][j] = to_float(k[off]);
      s_v[s][j] = to_float(v[off]);
      s_w[s][j] = w[off];
    }
    __syncthreads();
    for (int s = 0; s < n; ++s) {
      const float vj = s_v[s][j];
      const float4* r4 = reinterpret_cast<const float4*>(s_r[s]);
      const float4* k4 = reinterpret_cast<const float4*>(s_k[s]);
      const float4* w4 = reinterpret_cast<const float4*>(s_w[s]);
      const float4* u4 = reinterpret_cast<const float4*>(s_u);
      float y[4] = {0.f, 0.f, 0.f, 0.f};    // sum_i r_i S_ij, four partials
      float bonus[4] = {0.f, 0.f, 0.f, 0.f};  // sum_i r_i u_i k_i
#pragma unroll
      for (int q = 0; q < kN / 4; ++q) {
        const float4 rq = r4[q], kq = k4[q], wq = w4[q], uq = u4[q];
        const float ri[4] = {rq.x, rq.y, rq.z, rq.w};
        const float ki[4] = {kq.x, kq.y, kq.z, kq.w};
        const float wi[4] = {wq.x, wq.y, wq.z, wq.w};
        const float ui[4] = {uq.x, uq.y, uq.z, uq.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float& Sij = S[4 * q + e];
          y[e] = fmaf(ri[e], Sij, y[e]);
          bonus[e] = fmaf(ri[e] * ui[e], ki[e], bonus[e]);
          Sij = fmaf(wi[e], Sij, ki[e] * vj);
        }
      }
      const float out = (y[0] + y[1]) + (y[2] + y[3])
                        + vj * ((bonus[0] + bonus[1]) + (bonus[2] + bonus[3]));
      o[base + (long long)(t0 + s) * row] = from_float<T>(out);
    }
  }

  float* sT = state_out + (long long)bh * kN * kN;
#pragma unroll
  for (int i = 0; i < kN; ++i) sT[i * kN + j] = S[i];
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const float* w,
           const float* u, const float* state0, void* o, float* state_out,
           int B, int T_len, int H, cudaStream_t stream) {
  wkv6_forward<T><<<B * H, kN, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), w, u, state0, static_cast<T*>(o), state_out,
      T_len, H);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

int rwkv_wkv_f32(const void* r, const void* k, const void* v, const void* w,
                 const void* u, const void* state0, void* o, void* state_out,
                 int B, int T, int H, void* stream) {
  return launch<float>(r, k, v, static_cast<const float*>(w),
                       static_cast<const float*>(u),
                       static_cast<const float*>(state0), o,
                       static_cast<float*>(state_out), B, T, H,
                       static_cast<cudaStream_t>(stream));
}

int rwkv_wkv_bf16(const void* r, const void* k, const void* v, const void* w,
                  const void* u, const void* state0, void* o, void* state_out,
                  int B, int T, int H, void* stream) {
  return launch<__nv_bfloat16>(r, k, v, static_cast<const float*>(w),
                               static_cast<const float*>(u),
                               static_cast<const float*>(state0), o,
                               static_cast<float*>(state_out), B, T, H,
                               static_cast<cudaStream_t>(stream));
}

}  // extern "C"
