// RWKV-6 WKV recurrence (forward) for Hopper (sm_90a): each thread keeps an
// 8 x 4 tile of a head's state in registers, eight threads share a group of
// four columns, two blocks of 64 threads cover a (batch, head), and the
// inputs of the next 16 time steps are copied in by cp.async while the
// current 16 compute.
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
// in place; u is (H, 64); state0 and the final state are (B, H, 64, 64)
// row-major, S[i][j] at i * 64 + j.  Columns of S evolve independently, so
// a head's 64 columns go to two blocks of kCols = 32.  Lane (c, p) =
// (lane & 3, lane >> 2) of warp w keeps rows 8p .. 8p + 7 of the four
// columns 4 (4w + c) .. + 3 of its block (kRows x kColsPer = 32 registers):
// each r, k, w it reads from shared memory serves four columns, and each v
// eight rows.  The eight partial sums of o_t[j] (one a row group) meet in a
// reduce-scatter of three xor shuffles (4 shuffles a step, not 12), after
// which two lanes hold each column's o.  The state never leaves the SM (the
// TPU kernel keeps it in VMEM across its sequential chunk axis; here the
// time loop is inside the block).
//
// Staging, in chunks of kChunk = 16 steps: every thread issues cp.async
// copies (16 bytes each) of r, k, w (all 64 rows of the head) and v (the
// block's 32 columns) of chunk c + 1 into the free half of a double buffer,
// then waits for chunk c's copies, widens chunk c to float32 into a second
// buffer (16 bytes a load) and computes the bonus sum_i r_i u_i k_i of each
// step.  The global loads thus leave the dependent chain; two
// __syncthreads a chunk.  Inside a chunk a step reads r, k, w of its 8 rows
// and v of its 4 columns as float4 from shared memory and needs no barrier,
// and the steps are pipelined: step s + 1's operands are loaded into
// registers and step s - 1's o reduced and stored while step s's products
// run (one basic block a step, so the compiler can interleave them).
// Any T >= 1; the last chunk may be short.  One design, two instantiations
// (float32 and bfloat16 r/k/v).
//
// What bounds it on the H100: at the prefill shape (B, T, H) = (4, 2048, 40)
// the function moves ~254 MB (r, k, v in bf16, w in float32, o, and the
// final state) = 0.076 ms at 3.35 TB/s, and does 5 N^2 = 20,480 float32
// operations a (b, h, t) (a multiply-add for o: 2 N^2; k v, w S and their
// sum for S: 3 N^2) ~ 6.7 GFLOP = 0.100 ms at 67 TFLOP/s, so it is bound by
// operations, narrowly.  The kernel issues 3 float32 instructions a state
// entry and step (FFMA for o, FMUL k v, FFMA for S), 96 a thread and step,
// and about 50 more (shared loads, shuffles, selects, the store, the loop):
// ~150 a warp and step for 640 warps in 320 blocks, two or three blocks an
// SM.  It is bound by instruction issue on the SMs that hold three blocks
// (six warps), at well under one instruction a cycle each; the pipelining
// above shortens each step's dependent chain.  Four columns a thread is
// what keeps shared memory off the bound: it serves a 16-byte load to a
// warp in four cycles whatever the addresses, and one column a thread
// needed such a load for every 8 float32 instructions.  PERF.md has the
// times.
//
// C interface (bound with ctypes): rwkv_wkv_f32 / rwkv_wkv_bf16 take float32 /
// bfloat16 r, k, v and o, float32 w, u, state0 (may be null) and final state;
// r, k, v and w 16-byte aligned; launch on the given stream; allocate
// nothing; and return the CUDA error code of the launch (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kN = 64;                  // RWKV-6 head size
constexpr int kRows = 8;                // rows of S a thread keeps
constexpr int kColsPer = 4;             // columns of S a thread keeps
constexpr int kCols = 32;               // columns of S a block owns
constexpr int kParts = kN / kCols;      // blocks a (batch, head)
constexpr int kThreads = (kN / kRows) * (kCols / kColsPer);  // 64
constexpr int kChunk = 16;              // time steps staged at once
constexpr int kBonusThreads = kThreads / kChunk;  // threads a step's bonus
constexpr unsigned kFull = 0xffffffffu;
static_assert(kThreads % kChunk == 0 && kBonusThreads <= 32,
              "the bonus takes whole groups of lanes a step");

// Shared memory holds bfloat16 values as their bits.
template <typename T>
struct Bits {
  using type = T;
};
template <>
struct Bits<__nv_bfloat16> {
  using type = unsigned short;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(unsigned short x) {
  return __uint_as_float(static_cast<unsigned>(x) << 16);
}
template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most one group of this thread's copies is in flight
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// The raw copies of one chunk, in the inputs' own types.
template <typename T>
struct Raw {
  using E = typename Bits<T>::type;
  E r[kChunk][kN];
  E k[kChunk][kN];
  float w[kChunk][kN];
  E v[kChunk][kCols];
};

// Copy the first n of kChunk time steps of kWidth values, `stride` apart
// in global memory, into dst (kChunk x kWidth), 16 bytes a copy: a loop of
// fixed trip count whose copies past step n are predicated off.
template <int kWidth, typename E>
__device__ __forceinline__ void stage(E* dst, const E* src, long long stride,
                                      int n) {
  constexpr int kPer = 16 / sizeof(E);
  constexpr int kPieces = kWidth / kPer;
  static_assert(kChunk * kPieces % kThreads == 0, "whole rounds of copies");
#pragma unroll
  for (int m = 0; m < kChunk * kPieces / kThreads; ++m) {
    const int q = threadIdx.x + m * kThreads;
    const int s = q / kPieces;
    const int e = (q % kPieces) * kPer;
    if (s < n) cp_async16(dst + s * kWidth + e, src + s * stride + e);
  }
}

// dst[0, kCount) = float32 of src[0, kCount), 16 bytes a load (the whole
// chunk: values past the last step are never read).
template <int kCount>
__device__ __forceinline__ void widen(float* dst, const float* src) {
  static_assert(kCount % (kThreads * 4) == 0, "whole rounds of loads");
#pragma unroll
  for (int m = 0; m < kCount / (kThreads * 4); ++m) {
    const int q = (threadIdx.x + m * kThreads) * 4;
    *reinterpret_cast<float4*>(dst + q) =
        *reinterpret_cast<const float4*>(src + q);
  }
}
template <int kCount>
__device__ __forceinline__ void widen(float* dst,
                                      const unsigned short* src) {
  static_assert(kCount % (kThreads * 8) == 0, "whole rounds of loads");
#pragma unroll
  for (int m = 0; m < kCount / (kThreads * 8); ++m) {
    const int q = (threadIdx.x + m * kThreads) * 8;
    const uint4 bits = *reinterpret_cast<const uint4*>(src + q);
    // each 32-bit word holds two bfloat16, the first in its low half
    const unsigned words[4] = {bits.x, bits.y, bits.z, bits.w};
    float out[8];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      out[2 * e] = __uint_as_float(words[e] << 16);
      out[2 * e + 1] = __uint_as_float(words[e] & 0xffff0000u);
    }
    *reinterpret_cast<float4*>(dst + q) =
        make_float4(out[0], out[1], out[2], out[3]);
    *reinterpret_cast<float4*>(dst + q + 4) =
        make_float4(out[4], out[5], out[6], out[7]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
wkv6_forward(const T* __restrict__ r, const T* __restrict__ k,
             const T* __restrict__ v, const float* __restrict__ w,
             const float* __restrict__ u, const float* __restrict__ state0,
             T* __restrict__ o, float* __restrict__ state_out, int T_len,
             int H) {
  __shared__ __align__(16) Raw<T> raw[2];
  __shared__ __align__(16) float f_r[kChunk][kN];
  __shared__ __align__(16) float f_k[kChunk][kN];
  __shared__ __align__(16) float f_w[kChunk][kN];
  __shared__ __align__(16) float f_v[kChunk][kCols];
  __shared__ float f_bonus[kChunk];
  __shared__ float s_u[kN];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int p = lane >> 2;                          // rows 8p .. 8p + 7
  const int cs = (tid >> 5) * 4 + (lane & 3);       // columns 4cs .. 4cs + 3
  const int bh = blockIdx.x / kParts;
  const int part = blockIdx.x % kParts;
  const int b = bh / H;
  const int h = bh % H;
  const int j0 = part * kCols + kColsPer * cs;      // first column, in the head
  const long long row = static_cast<long long>(H) * kN;  // a time step
  const long long head = static_cast<long long>(b) * T_len * row +
                         static_cast<long long>(h) * kN;
  const int chunks = (T_len + kChunk - 1) / kChunk;
  // after the reduce-scatter this lane holds column j0 + mine of o
  const bool hi2 = lane & 16;
  const bool hi1 = lane & 8;
  const int mine = (hi2 ? 2 : 0) + (hi1 ? 1 : 0);

  auto issue = [&](int c) {
    const int t0 = c * kChunk;
    const int n = min(kChunk, T_len - t0);
    const long long off = head + t0 * row;
    using E = typename Raw<T>::E;
    Raw<T>& dst = raw[c & 1];
    stage<kN>(&dst.r[0][0], reinterpret_cast<const E*>(r) + off, row, n);
    stage<kN>(&dst.k[0][0], reinterpret_cast<const E*>(k) + off, row, n);
    stage<kN>(&dst.w[0][0], w + off, row, n);
    stage<kCols>(&dst.v[0][0],
                 reinterpret_cast<const E*>(v) + off + part * kCols, row, n);
  };

  // A step's operands for this thread: r, k, w of its 8 rows and v of its
  // 4 columns, read as float4 from the staged chunk.
  struct Operands {
    float4 r[kRows / 4], k[kRows / 4], w[kRows / 4], v;
  };
  auto operands = [&](int s, Operands& a) {
#pragma unroll
    for (int q = 0; q < kRows / 4; ++q) {
      const int i = kRows * p + 4 * q;
      a.r[q] = *reinterpret_cast<const float4*>(&f_r[s][i]);
      a.k[q] = *reinterpret_cast<const float4*>(&f_k[s][i]);
      a.w[q] = *reinterpret_cast<const float4*>(&f_w[s][i]);
    }
    a.v = *reinterpret_cast<const float4*>(&f_v[s][4 * cs]);
  };
  // The products of a step: S <- w S + k v over this thread's tile, and
  // y[c] = sum over its 8 rows of r_i S_ic (with S before the update).
  float S[kRows][kColsPer];  // S[8p + e][j0 + c]
  auto products = [&](const Operands& a, float (&y)[kColsPer]) {
    const float vj[kColsPer] = {a.v.x, a.v.y, a.v.z, a.v.w};
#pragma unroll
    for (int cc = 0; cc < kColsPer; ++cc) y[cc] = 0.f;
#pragma unroll
    for (int q = 0; q < kRows / 4; ++q) {
      const float ri[4] = {a.r[q].x, a.r[q].y, a.r[q].z, a.r[q].w};
      const float ki[4] = {a.k[q].x, a.k[q].y, a.k[q].z, a.k[q].w};
      const float wi[4] = {a.w[q].x, a.w[q].y, a.w[q].z, a.w[q].w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int cc = 0; cc < kColsPer; ++cc) {
          float& Sij = S[4 * q + e][cc];
          y[cc] = fmaf(ri[e], Sij, y[cc]);
          Sij = fmaf(wi[e], Sij, ki[e] * vj[cc]);
        }
      }
    }
  };
  // o of step s from the partial sums y: a reduce-scatter of the four
  // columns over the eight row groups (lane bits 4, 3, 2) keeps two columns
  // and sends two, keeps one and sends one, then adds the last pair; the
  // bonus term goes on last.
  // (Branch-free, so that the compiler can interleave it with the next
  // step's products; one lane of each pair stores.)
  const bool stores = (lane & 4) == 0;
  auto finish = [&](int s, T* out, const float (&y)[kColsPer]) {
    float a0 = hi2 ? y[2] : y[0];
    float a1 = hi2 ? y[3] : y[1];
    a0 += __shfl_xor_sync(kFull, hi2 ? y[0] : y[2], 16);
    a1 += __shfl_xor_sync(kFull, hi2 ? y[1] : y[3], 16);
    float z = hi1 ? a1 : a0;
    z += __shfl_xor_sync(kFull, hi1 ? a0 : a1, 8);
    z += __shfl_xor_sync(kFull, z, 4);
    const T value = from_float<T>(fmaf(f_v[s][4 * cs + mine], f_bonus[s], z));
    if (stores) *out = value;
  };

  if (chunks > 0) issue(0);
  cp_async_commit();

  const float* s0 =
      state0 ? state0 + static_cast<long long>(bh) * kN * kN : nullptr;
#pragma unroll
  for (int e = 0; e < kRows; ++e) {
#pragma unroll
    for (int c = 0; c < kColsPer; ++c) {
      S[e][c] = s0 ? s0[(kRows * p + e) * kN + j0 + c] : 0.f;
    }
  }
  for (int i = tid; i < kN; i += kThreads) s_u[i] = u[h * kN + i];

  for (int c = 0; c < chunks; ++c) {
    const int t0 = c * kChunk;
    const int n = min(kChunk, T_len - t0);
    if (c + 1 < chunks) issue(c + 1);
    cp_async_commit();
    cp_async_wait_one();  // chunk c has landed (for this thread's copies)
    __syncthreads();      // ... for every thread's; chunk c - 1 is computed

    const Raw<T>& in = raw[c & 1];
    widen<kChunk * kN>(&f_r[0][0], &in.r[0][0]);
    widen<kChunk * kN>(&f_k[0][0], &in.k[0][0]);
    widen<kChunk * kN>(&f_w[0][0], &in.w[0][0]);
    widen<kChunk * kCols>(&f_v[0][0], &in.v[0][0]);
    {  // the bonus of each step, kBonusThreads neighbouring threads a step
      constexpr int kSpan = kN / kBonusThreads;
      const int s = tid / kBonusThreads;
      const int i0 = (tid % kBonusThreads) * kSpan;
      float bonus = 0.f;
      if (s < n) {
#pragma unroll
        for (int i = i0; i < i0 + kSpan; ++i) {
          bonus = fmaf(to_float(in.r[s][i]) * s_u[i], to_float(in.k[s][i]),
                       bonus);
        }
      }
#pragma unroll
      for (int off = kBonusThreads / 2; off > 0; off >>= 1) {
        bonus += __shfl_xor_sync(kFull, bonus, off);
      }
      if (tid % kBonusThreads == 0 && s < n) f_bonus[s] = bonus;
    }
    __syncthreads();

    // Software pipeline: step s + 1's operands are loaded and step s - 1's
    // partial sums reduced while step s's products run, none of them
    // waiting on the others.
    T* out = o + head + t0 * row + j0 + mine;  // o of step t0, this column
    Operands now, next;
    float y[kColsPer];
    operands(0, now);
    operands(min(1, n - 1), next);
    products(now, y);
    for (int s = 1; s < n; ++s, out += row) {
      now = next;
      operands(min(s + 1, n - 1), next);
      const float done[kColsPer] = {y[0], y[1], y[2], y[3]};
      products(now, y);
      finish(s - 1, out, done);
    }
    finish(n - 1, out, y);
  }

  float* sT = state_out + static_cast<long long>(bh) * kN * kN;
#pragma unroll
  for (int e = 0; e < kRows; ++e) {
#pragma unroll
    for (int c = 0; c < kColsPer; ++c) {
      sT[(kRows * p + e) * kN + j0 + c] = S[e][c];
    }
  }
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const float* w,
           const float* u, const float* state0, void* o, float* state_out,
           int B, int T_len, int H, cudaStream_t stream) {
  wkv6_forward<T><<<kParts * B * H, kThreads, 0, stream>>>(
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
