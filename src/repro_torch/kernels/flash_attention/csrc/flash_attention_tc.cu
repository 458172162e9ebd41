// Forward flash attention on Hopper's tensor cores (sm_90a), bfloat16:
// wgmma products on bf16 tiles that TMA brings into shared memory, one
// producer warpgroup and two consumer warpgroups a block.
//
// Replaces repro/kernels/flash_attention/kernel.py::_fa_kernel (reached
// through flash_attention_bhsd and the op repro/kernels/flash_attention/
// ops.py::flash_attention), the Pallas TPU kernel behind the dense models'
// prefill attention, on its bfloat16 route (kernel.py::route: bf16, D a
// multiple of 8 from 64 to 256, 16-byte aligned base and strides).  The
// CUDA-core kernel of flash_attention.cu keeps float32 and the other bf16
// shapes.  Same function: float32 logits S = Q Kᵀ (bf16 products are exact
// in float32, sums in float32), scaled by 1/sqrt(D) of the true D, -1e30 on
// entries the causal mask hides, key tiles past the diagonal skipped,
// online softmax with float32 row statistics (m, l) and a float32
// accumulator, out = acc / max(l, 1e-30) in bf16.  Causal alignment is the
// TPU kernel's: top-left, key j visible to query i when j <= i, also when
// Sq != Sk.  The softmax runs in base 2: log2(e)/sqrt(D) is folded into the
// FFMA that feeds each exponent, exp2(s * scale - m), which differs from the
// TPU kernel's q * scale by float32 rounding only.
//
// Departure: the PV product needs P in bf16, the tensor cores' input type.
// One bf16 rounding of P (8 significant bits) moves the output by up to
// ~2^-9 of |v|, which breaks the bf16 kernel-against-plain limit
// (2^-7|ref| + 1e-4 max|ref|) on rows that see few keys or whose output
// cancels.  So P is carried as two bf16 terms, hi = bf16(p) and
// lo = bf16(p - hi), and O += hi V + lo V: 16 significant bits, as close to
// the TPU kernel's float32 P as the limits can see, for one more PV product
// a tile (the kernel does 1.5x the work of the function).  l sums the
// unrounded float32 p.
//
// Layout: q, o (B, Sq, H, D) and k, v (B, Sk, Hkv, D), read in place
// through 4-D tensor maps over (D, heads, S, B) with the tensors' own
// strides (the innermost stride 1), so GQA is the kv-head coordinate
// h / (H / Hkv) and never a copy.  o is written contiguous.
//
// Block: 128 query rows of one (b, h) and 384 threads.
//   - Warpgroup 0, the producer, gives up registers (setmaxnreg 24) and one
//     thread issues the TMA loads: the Q tile once, then the K and V tiles
//     of every key tile into a ring of two stages, each stage with a K and
//     a V "full" mbarrier (transaction bytes) and an "empty" mbarrier that
//     the 8 consumer warps arrive on when their products have retired.
//     The ring's phase bit flips each time the stage index wraps.
//   - Warpgroups 1 and 2, the consumers (setmaxnreg 240), own 64 query
//     rows each and take turns on the tensor cores (ping-pong): in its
//     turn a warpgroup runs O += P V of its previous key tile by
//     2 kBlockN/16 wgmma m64n{kD}k16, A = P from registers and B = V from
//     shared memory as the MN-major operand (transpose bit set; see
//     hopper.cuh for the descriptors), and S = Q Kᵀ of this key tile by
//     kD/16 wgmma m64n{kBlockN}k16 from shared memory (both operands
//     K-major); then it hands the turn over (an mbarrier per warpgroup,
//     arrived on by the other's 4 warps) and runs its softmax while the
//     other's products run: the ragged key tile (kj >= Sk, which TMA
//     zero-fills: logit 0, not -inf) and the diagonal tiles masked; row
//     max and row sum over the 4 lanes that share a row; the accumulator
//     rescaled; P split into hi / lo bf16 A fragments in registers.
//     wgmma.fence before each batch of products (their accumulator and A
//     registers were written by ordinary instructions), commit,
//     wait_group 0, and register fences so that the compiler does not move
//     reads of the accumulators across the wait.
//   - Tiles: a K or V tile is kBlockN keys by kD columns in kD/64 panels of
//     64 bf16 (128 bytes, the widest box of a 128-byte swizzle), so D = 128
//     arrives as two boxes; D = 80 or 192 pads to 128 / 192 by the TMA's
//     zero fill of columns past D.  kBlockN = 128 for kD <= 128 and 64
//     above: shared memory 80 / 160 / 144 / 192 KB for kD = 64 / 128 /
//     192 / 256 (Q 16-64 KB once, K and V two stages).
//   - Causal: a block stops at its last visible key tile; only tiles that
//     cross the diagonal (or Sk) are masked.  The grid is one-dimensional
//     and walks groups of 8 (b, h) pairs, whose K and V stay in L2 while
//     the group runs; inside a group the query tiles with the most key
//     tiles start first, so the triangle leaves no tail.
//   - Roles: the warpgroup index is broadcast from lane 0 (a warp-uniform
//     branch).  ptxas holds every path to the launch's 168 registers:
//     setmaxnreg.dec keeps the producer within 24, but setmaxnreg.inc does
//     not let the consumers past 168 (the -Xptxas -v spills are the same
//     with and without it).  So the consumer's S (kBlockN / 2), P
//     (kBlockN / 2) and O (kD / 2) registers must fit in 168: this rules
//     out holding the next tile's S beside this tile's P (intra-warpgroup
//     pipelining) at kBlockN = 128; the ping-pong of the two consumer
//     warpgroups overlaps softmax and products instead.
//   - Epilogue: l summed over the quad, out = acc / max(l, 1e-30) in
//     float32, bf16 pairs stored straight from registers to (B, Sq, H, D)
//     for rows < Sq and columns < D.
//
// What bounds it on the H100: at the prefill shape (4, 2048, 20, 128)
// causal the function is ~86 GFLOP (QKᵀ and PV over the lower triangle)
// against ~168 MB of q, k, v and o: the bf16 tensor-core rate (989
// TFLOP/s, 0.087 ms) bounds it.  The design feeds the tensor cores from
// shared memory that TMA fills ahead of the products, and overlaps one
// consumer warpgroup's softmax with the other's products; the hi / lo P
// adds a third of the work, each turn drains the tensor pipe twice
// (wait_group 0 after PV and after S), and a short causal block pays its
// Q load and epilogue alone (no persistent scheduling yet).
//
// Build: inline PTX (hopper.cuh), no CUTLASS / CuTe templates, so nvcc
// takes seconds for this file.  The tensor maps are encoded on the host at
// every launch with cuTensorMapEncodeTiled, which the CUDA runtime hands
// out (cudaGetDriverEntryPoint), so the library needs no -lcuda.
//
// C interface (bound with ctypes): flash_attention_tc_bf16 takes bfloat16
// q, k, v with their element strides (batch, sequence, head; the head-dim
// stride is 1) and a contiguous o; launches on the given stream; allocates
// nothing; and returns 0, the CUDA error code of the launch, or a negative
// code when the tensor maps cannot be made (-1000: no cuTensorMapEncodeTiled
// in the CUDA driver; -1 - CUresult: the CUDA driver refused a map).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kBlockM = 128;       // query rows a block: two warpgroups of 64
constexpr int kThreads = 384;      // producer warpgroup + two consumers
constexpr int kStages = 2;         // K / V ring depth
constexpr int kPanelCols = 64;     // bf16 columns of a 128-byte swizzled row
constexpr int kRowBytes = 128;
constexpr float kNegInf = -1e30f;  // the TPU kernel's mask value
constexpr int kGroup = 8;          // (b, h) pairs a scheduling group

template <int kD>
struct Tile {
  static constexpr int kPanels = kD / kPanelCols;
  static constexpr int kBlockN = kD <= 128 ? 128 : 64;
  static constexpr int kQPanelBytes = kBlockM * kRowBytes;
  static constexpr int kKVPanelBytes = kBlockN * kRowBytes;
  static constexpr int kQBytes = kPanels * kQPanelBytes;
  static constexpr int kKVBytes = kPanels * kKVPanelBytes;  // one K or V tile
  static constexpr int kKOff = kQBytes;
  static constexpr int kVOff = kKOff + kStages * kKVBytes;
  static constexpr int kBarOff = kVOff + kStages * kKVBytes;
  // barriers: q_full, k_full[kStages], v_full[kStages], empty[kStages],
  // turn[2]
  static constexpr int kBars = 1 + 3 * kStages + 2;
  // + 1024 to align the dynamic shared memory's base to the swizzle atom
  static constexpr int kSmemBytes = kBarOff + 8 * kBars + 1024;
};

template <int kD>
__global__ void __launch_bounds__(kThreads, 1)
fa_forward_tc(const __grid_constant__ CUtensorMap tm_q,
              const __grid_constant__ CUtensorMap tm_k,
              const __grid_constant__ CUtensorMap tm_v,
              __nv_bfloat16* __restrict__ o, int Sq, int Sk, int H, int Hkv,
              int D, int causal, float scale_log2) {
  using T = Tile<kD>;
  constexpr int kBlockN = T::kBlockN;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (hopper::smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base;
  const uint32_t sK = base + T::kKOff;
  const uint32_t sV = base + T::kVOff;
  const uint32_t q_full = base + T::kBarOff;
  auto k_full = [&](int s) { return q_full + 8u * (1 + s); };
  auto v_full = [&](int s) { return q_full + 8u * (1 + kStages + s); };
  auto empty = [&](int s) { return q_full + 8u * (1 + 2 * kStages + s); };
  auto turn = [&](int c) { return q_full + 8u * (1 + 3 * kStages + c); };

  // The blocks run in groups of kGroup (b, h) pairs, whose K and V (8 MB
  // at the prefill shape) stay in L2 while the group runs; inside a group
  // the query tiles with the most key tiles go first, across its heads.
  const int n_m = (Sq + kBlockM - 1) / kBlockM;
  const int pairs = gridDim.x / n_m;
  const int g = blockIdx.x / (kGroup * n_m);
  const int g_size = min(kGroup, pairs - g * kGroup);
  const int slot = blockIdx.x - g * kGroup * n_m;
  const int m_block = n_m - 1 - slot / g_size;
  const int bh = g * kGroup + slot % g_size;
  const int h = bh % H;
  const int b = bh / H;
  const int hk = h / (H / Hkv);
  const int m0 = m_block * kBlockM;
  // causal: keys past the block's last query row are never visible
  const int n_end = causal ? min(Sk, min(m0 + kBlockM, Sq)) : Sk;
  const int n_tiles = (n_end + kBlockN - 1) / kBlockN;

  const int tid = threadIdx.x;
  if (tid == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(k_full(s), 1);
      hopper::mbar_init(v_full(s), 1);
      hopper::mbar_init(empty(s), 8);  // the 8 consumer warps
    }
    hopper::mbar_init(turn(0), 4);     // the 4 warps of the other warpgroup
    hopper::mbar_init(turn(1), 4);
    hopper::mbar_fence_init();
  }
  __syncthreads();

  // the warpgroup's role, broadcast from lane 0 so that the compiler sees
  // a warp-uniform branch
  const int role = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (role == 0) {
    // ---- producer ----------------------------------------------------------
    hopper::setmaxnreg_dec<24>();
    if (tid == 0) {
      hopper::mbar_expect_tx(q_full, T::kQBytes);
      for (int p = 0; p < T::kPanels; ++p)
        hopper::tma_load_4d(sQ + p * T::kQPanelBytes, &tm_q, q_full,
                            p * kPanelCols, h, m0, b);
      for (int n = 0; n < n_tiles; ++n) {
        const int s = n % kStages;
        // a fresh barrier counts as having completed the phase of parity 1,
        // so the first pass over the ring does not wait
        hopper::mbar_wait(empty(s), ((n / kStages) & 1) ^ 1);
        hopper::mbar_expect_tx(k_full(s), T::kKVBytes);
        for (int p = 0; p < T::kPanels; ++p)
          hopper::tma_load_4d(sK + s * T::kKVBytes + p * T::kKVPanelBytes,
                              &tm_k, k_full(s), p * kPanelCols, hk,
                              n * kBlockN, b);
        hopper::mbar_expect_tx(v_full(s), T::kKVBytes);
        for (int p = 0; p < T::kPanels; ++p)
          hopper::tma_load_4d(sV + s * T::kKVBytes + p * T::kKVPanelBytes,
                              &tm_v, v_full(s), p * kPanelCols, hk,
                              n * kBlockN, b);
      }
    }
    return;
  }

  // ---- consumers -----------------------------------------------------------
  hopper::setmaxnreg_inc<240>();
  const int c = role - 1;                // consumer warpgroup: rows 64c..
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int row0 = m0 + 64 * c;          // first query row of the warpgroup
  const int rA = row0 + 16 * warp + lane / 4;  // rows of registers 4j, 4j+1
  const int rB = rA + 8;                       // and of 4j+2, 4j+3
  const int col = 2 * (lane % 4);              // + 8j: column of 4j, 4j+2
  const uint32_t sQc = sQ + c * 64 * kRowBytes;

  constexpr int kSRegs = kBlockN / 2;    // 64 x kBlockN floats / 128 threads
  constexpr int kORegs = kD / 2;
  constexpr int kKSteps = kBlockN / 16;  // k-steps of the PV product
  float o_acc[kORegs];
#pragma unroll
  for (int i = 0; i < kORegs; ++i) o_acc[i] = 0.f;
  float m_A = kNegInf, m_B = kNegInf;    // running max (base-2 logits)
  float l_A = 0.f, l_B = 0.f;            // this thread's part of the row sum

  // The two consumer warpgroups take turns on the tensor cores: in its turn
  // a warpgroup runs the PV product of its previous tile and the S product
  // of this one, then hands the turn over and runs the softmax while the
  // other one's products run.  turn(c) completes a phase when the 4 warps
  // of the other warpgroup arrive; warpgroup 1 lets warpgroup 0 go first.
  uint32_t p_hi[kKSteps][4], p_lo[kKSteps][4];
  uint32_t turn_parity = 0;
  if (c == 1 && lane == 0) hopper::mbar_arrive(turn(0));
  hopper::mbar_wait(q_full, 0);
  for (int n = 0; n <= n_tiles; ++n) {
    hopper::mbar_wait(turn(c), turn_parity);
    turn_parity ^= 1;
    if (n > 0) {
      // O += P V of tile n - 1, P = hi + lo
      const int sp = (n - 1) % kStages;
      hopper::mbar_wait(v_full(sp), ((n - 1) / kStages) & 1);
      hopper::fence_regs(o_acc);
      hopper::fence_regs(p_hi);
      hopper::fence_regs(p_lo);
      hopper::wgmma_fence();
#pragma unroll
      for (int t = 0; t < kKSteps; ++t) {
        const uint64_t dv = hopper::desc_mnmajor(
            sV + sp * T::kKVBytes + t * 16 * kRowBytes, T::kKVPanelBytes);
        hopper::WgmmaRS<kD>::rs(o_acc, p_hi[t], dv);
        hopper::WgmmaRS<kD>::rs(o_acc, p_lo[t], dv);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(o_acc);
      hopper::fence_regs(p_hi);
      hopper::fence_regs(p_lo);
      if (lane == 0) hopper::mbar_arrive(empty(sp));  // this warp is done
    }
    if (n == n_tiles) {
      if (c == 0 && lane == 0) hopper::mbar_arrive(turn(1));
      break;
    }
    const int s = n % kStages;
    const uint32_t sKs = sK + s * T::kKVBytes;

    // S = Q Kᵀ
    float sacc[kSRegs];
#pragma unroll
    for (int i = 0; i < kSRegs; ++i) sacc[i] = 0.f;
    hopper::mbar_wait(k_full(s), (n / kStages) & 1);
    hopper::fence_regs(sacc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;  // 16 columns of the panel
      hopper::WgmmaSS<kBlockN>::ss(
          sacc,
          hopper::desc_kmajor(sQc + (kk / 4) * T::kQPanelBytes + off),
          hopper::desc_kmajor(sKs + (kk / 4) * T::kKVPanelBytes + off),
          kk > 0);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sacc);
    if (lane == 0) hopper::mbar_arrive(turn(1 - c));   // the other's turn

    // mask, online softmax (the scale folded into the exponent's FFMA)
    const int k0 = n * kBlockN;
    const bool masked = k0 + kBlockN > Sk ||
                        (causal && k0 + kBlockN - 1 > row0);
    float mx_A = kNegInf, mx_B = kNegInf;
#pragma unroll
    for (int j = 0; j < kBlockN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sacc[4 * j + e];
        if (masked) {
          const int kj = k0 + 8 * j + col + (e & 1);
          const int qi = e < 2 ? rA : rB;
          if (kj >= Sk) {
            x = __int_as_float(0xff800000);  // ragged tile: probability 0
          } else if (causal && kj > qi) {
            x = kNegInf;
          }
        }
        sacc[4 * j + e] = x;
        if (e < 2) mx_A = fmaxf(mx_A, x);
        else mx_B = fmaxf(mx_B, x);
      }
    }
    const float mn_A = fmaxf(m_A, hopper::quad_max(mx_A) * scale_log2);
    const float mn_B = fmaxf(m_B, hopper::quad_max(mx_B) * scale_log2);
    const float alpha_A = hopper::exp2_approx(m_A - mn_A);
    const float alpha_B = hopper::exp2_approx(m_B - mn_B);
    m_A = mn_A;
    m_B = mn_B;
    float sum_A = 0.f, sum_B = 0.f;
#pragma unroll
    for (int t = 0; t < kKSteps; ++t) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        // a[r]: chunk j = 2t + r / 2, registers 4j + 2(r % 2) + {0, 1}
        const int i = 4 * (2 * t + r / 2) + 2 * (r % 2);
        const float mr = (r % 2) ? mn_B : mn_A;
        const float p0 = hopper::exp2_approx(fmaf(sacc[i], scale_log2, -mr));
        const float p1 =
            hopper::exp2_approx(fmaf(sacc[i + 1], scale_log2, -mr));
        if (r % 2) sum_B += p0 + p1;
        else sum_A += p0 + p1;
        const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
        const float2 hf = __bfloat1622float2(hi);
        p_hi[t][r] = hopper::pack_bf16(hi);
        p_lo[t][r] =
            hopper::pack_bf16(__floats2bfloat162_rn(p0 - hf.x, p1 - hf.y));
      }
    }
    l_A = alpha_A * l_A + sum_A;
    l_B = alpha_B * l_B + sum_B;
#pragma unroll
    for (int j = 0; j < kD / 8; ++j) {
      o_acc[4 * j + 0] *= alpha_A;
      o_acc[4 * j + 1] *= alpha_A;
      o_acc[4 * j + 2] *= alpha_B;
      o_acc[4 * j + 3] *= alpha_B;
    }
  }

  // epilogue
  const float inv_A = 1.f / fmaxf(hopper::quad_sum(l_A), 1e-30f);
  const float inv_B = 1.f / fmaxf(hopper::quad_sum(l_B), 1e-30f);
  const long long row_stride = (long long)H * D;
  __nv_bfloat16* oA = o + ((long long)b * Sq + rA) * row_stride +
                      (long long)h * D;
  __nv_bfloat16* oB = oA + 8 * row_stride;
#pragma unroll
  for (int j = 0; j < kD / 8; ++j) {
    const int d = 8 * j + col;
    if (d >= D) continue;
    if (rA < Sq)
      *reinterpret_cast<__nv_bfloat162*>(oA + d) = __floats2bfloat162_rn(
          o_acc[4 * j] * inv_A, o_acc[4 * j + 1] * inv_A);
    if (rB < Sq)
      *reinterpret_cast<__nv_bfloat162*>(oB + d) = __floats2bfloat162_rn(
          o_acc[4 * j + 2] * inv_B, o_acc[4 * j + 3] * inv_B);
  }
}

// A 4-D map over (D, heads, S, B) of a bf16 tensor with element strides
// (head, sequence, batch) and unit stride along D; boxes of 64 columns by
// `rows` positions of one head, 128-byte swizzle, zero fill out of bounds.
int make_map(CUtensorMap* map, const void* ptr, int D, int heads, int S,
             int B, long long s_head, long long s_seq, long long s_batch,
             int rows) {
  hopper::EncodeTiled fn = hopper::encode_fn();
  if (fn == nullptr) return -1000;
  const cuuint64_t dims[4] = {cuuint64_t(D), cuuint64_t(heads), cuuint64_t(S),
                              cuuint64_t(B)};
  const cuuint64_t strides[3] = {cuuint64_t(s_head) * 2,
                                 cuuint64_t(s_seq) * 2,
                                 cuuint64_t(s_batch) * 2};
  const cuuint32_t box[4] = {cuuint32_t(kPanelCols), 1, cuuint32_t(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult res = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                          const_cast<void*>(ptr), dims, strides, box, elem,
                          CU_TENSOR_MAP_INTERLEAVE_NONE,
                          CU_TENSOR_MAP_SWIZZLE_128B,
                          CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : -1 - int(res);
}

template <int kD>
int launch_tc(const void* q, const void* k, const void* v, void* o, int B,
              int Sq, int Sk, int H, int Hkv, int D, const long long* sq,
              const long long* sk, const long long* sv, int causal,
              float scale, cudaStream_t stream) {
  using T = Tile<kD>;
  CUtensorMap tm_q, tm_k, tm_v;
  int err = make_map(&tm_q, q, D, H, Sq, B, sq[2], sq[1], sq[0], kBlockM);
  if (err == 0)
    err = make_map(&tm_k, k, D, Hkv, Sk, B, sk[2], sk[1], sk[0], T::kBlockN);
  if (err == 0)
    err = make_map(&tm_v, v, D, Hkv, Sk, B, sv[2], sv[1], sv[0], T::kBlockN);
  if (err != 0) return err;
  cudaError_t cerr = cudaFuncSetAttribute(
      fa_forward_tc<kD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      T::kSmemBytes);
  if (cerr != cudaSuccess) return int(cerr);
  const dim3 grid(unsigned((Sq + kBlockM - 1) / kBlockM) * H * B);
  const float log2e = 1.4426950408889634f;
  fa_forward_tc<kD><<<grid, kThreads, T::kSmemBytes, stream>>>(
      tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(o), Sq, Sk, H, Hkv, D,
      causal, scale * log2e);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// strides_q / _k / _v: element strides (batch, sequence, head)
int flash_attention_tc_bf16(const void* q, const void* k, const void* v,
                            void* o, int B, int Sq, int Sk, int H, int Hkv,
                            int D, const long long* strides_q,
                            const long long* strides_k,
                            const long long* strides_v, int causal,
                            float scale, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  const int kD = (D + kPanelCols - 1) / kPanelCols * kPanelCols;
  switch (kD) {
    case 64:
      return launch_tc<64>(q, k, v, o, B, Sq, Sk, H, Hkv, D, strides_q,
                           strides_k, strides_v, causal, scale, st);
    case 128:
      return launch_tc<128>(q, k, v, o, B, Sq, Sk, H, Hkv, D, strides_q,
                            strides_k, strides_v, causal, scale, st);
    case 192:
      return launch_tc<192>(q, k, v, o, B, Sq, Sk, H, Hkv, D, strides_q,
                            strides_k, strides_v, causal, scale, st);
    case 256:
      return launch_tc<256>(q, k, v, o, B, Sq, Sk, H, Hkv, D, strides_q,
                            strides_k, strides_v, causal, scale, st);
    default:
      return int(cudaErrorInvalidValue);
  }
}

}  // extern "C"
