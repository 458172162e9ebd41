// Forward MLA (multi-head latent attention) prefill on Hopper's tensor cores
// (sm_90a), bfloat16: wgmma products on bf16 tiles that TMA brings into
// shared memory, one producer and two consumer warpgroups a block.
//
// Replaces no TPU kernel: the JAX package computes DeepSeek-V2's MLA core
// with einsums (repro/models/layers.py::mla_apply), which materialise the
// float32 (B, H, S, S) logits: 137 GB at 4 x 8,192 tokens and 128 heads.
// This kernel computes the same prefill core without them, for
// models/layers.mla_apply's bf16 prefill on the card.
//
// Function, per (b, h): logits = (q_nope k_nopeᵀ + q_rope k_ropeᵀ) * scale
// in float32 (bf16 products are exact in float32), a query and key width of
// dn + dr = 128 + 64 = 192, where k_rope (B, S, dr) is one vector a
// position shared by every head; -1e30 on entries the causal mask hides
// (key j visible to query i when j <= i; queries and keys are the same S
// positions of a prefill); online softmax with
// float32 row statistics; out = (P v) / l with v and out 128 wide, in bf16.
// As flash_attention_tc.cu, the softmax runs in base 2 (log2(e) * scale
// folded into the FFMA that feeds each exponent) and P enters the PV
// product as two bf16 terms, hi = bf16(p) and lo = bf16(p - hi), for 16
// significant bits: one bf16 rounding of P moves the output by up to 2^-9
// of |v|, which the bf16 kernel-against-plain limit sees (ROADMAP §C).
//
// Layout, read in place through TMA tensor maps with the tensors' own
// strides (the innermost stride 1): q_nope (B, S, H, 128) and q_rope (B,
// S, H, 64), k_nope (B, S, H, 128) and v (B, S, H, 128) as 4-D maps over
// (columns, heads, S, B); k_rope (B, S, 64) as a 3-D map over (64, S, B),
// loaded into every head's key tile from the one copy (L2 serves the 8
// heads of a scheduling group), never repeated over the heads in memory.
// q_nope may be a view of the up-projected query (the rope columns first).
// o (B, S, H, 128) is written contiguous.
//
// Block: 128 query rows of one (b, h) and 384 threads, the design of
// flash_attention_tc.cu at its D = 128 with a wider QKᵀ:
//   - Warpgroup 0, the producer (setmaxnreg 24): one thread issues the TMA
//     loads, the Q tile once (two q_nope panels and the q_rope panel of 64
//     bf16 columns, 48 KB) and, for every key tile, the K tile (two k_nope
//     panels and the shared k_rope panel, 48 KB) and the V tile (two
//     panels, 32 KB) into a ring of two stages, each stage with a K and a
//     V "full" mbarrier (transaction bytes) and an "empty" mbarrier that
//     the 8 consumer warps arrive on when their products have retired.
//   - Warpgroups 1 and 2, the consumers, own 64 query rows each and take
//     turns on the tensor cores (ping-pong, an mbarrier a warpgroup): in
//     its turn a warpgroup runs O += P V of its previous key tile
//     (2 x 8 wgmma m64n128k16, A = P hi / lo from registers, B = V from
//     shared memory as the MN-major operand) and S = Q Kᵀ of this one
//     (12 wgmma m64n128k16 over the three 64-column panels, both operands
//     K-major), then hands the turn over and runs its softmax while the
//     other's products run: the ragged key tile (kj >= S, zero-filled by
//     TMA: probability 0) and the diagonal tiles masked, row max and sum
//     over the quad of lanes that share a row, the accumulator rescaled,
//     P split into hi / lo A fragments.  Registers as flash_attention_tc's
//     D = 128: S 64, P 64, O 64 a thread, within the launch's 168.
//   - Shared memory 48 + 2 x (48 + 32) KB + barriers = 214,080 bytes of the
//     227 KB a block may have: one block an SM.
//   - Causal: a block stops at its last visible key tile; only tiles that
//     cross the diagonal (or S) are masked.  The grid walks groups of 8
//     (b, h) pairs, the query tiles with the most key tiles first inside a
//     group, so the triangle leaves no tail.
//   - Epilogue: l summed over the quad, out = acc / max(l, 1e-30) in
//     float32, bf16 pairs stored from registers for rows < S.
//
// What bounds it on the H100: at DeepSeek-V2's prefill of 4 x 8,192 tokens
// and 128 heads the function is 2 (192 + 128) = 640 FLOP a head and a pair
// of a query and a key at or before it, 11.0 TFLOP (11.1 ms at the 989
// TFLOP/s bf16 rate), against 4.8 GB of q, k, v and o (1.4 ms at 3.35
// TB/s): the tensor cores bound it.  The hi / lo P makes the issued
// products 2 (192 + 2 x 128) = 896 FLOP a pair, 1.4 x the function; each
// turn drains the tensor pipe twice (wait_group 0 after PV and after S).
//
// C interface (bound with ctypes): mla_attention_tc_bf16 takes bfloat16
// q_nope, q_rope, k_nope, v with their element strides (batch, sequence,
// head) and k_rope with its (batch, sequence) strides, the head-dim stride
// 1 everywhere, and a contiguous o; launches on the given stream; allocates
// nothing; returns 0, the CUDA error code of the launch, or a negative code
// when the tensor maps cannot be made (-1000: no cuTensorMapEncodeTiled in
// the CUDA driver; -1 - CUresult: the CUDA driver refused a map).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../flash_attention/csrc/hopper.cuh"

namespace {

constexpr int kBlockM = 128;       // query rows a block: two warpgroups of 64
constexpr int kBlockN = 128;       // keys a tile
constexpr int kThreads = 384;      // producer warpgroup + two consumers
constexpr int kStages = 2;         // K / V ring depth
constexpr int kPanelCols = 64;     // bf16 columns of a 128-byte swizzled row
constexpr int kRowBytes = 128;
constexpr float kNegInf = -1e30f;  // the plain version's mask value
constexpr int kGroup = 8;          // (b, h) pairs a scheduling group

constexpr int kDn = 128;           // q_nope / k_nope width
constexpr int kDr = 64;            // q_rope / k_rope width: one panel
constexpr int kDv = 128;           // v / o width
constexpr int kNopePanels = kDn / kPanelCols;
constexpr int kQKPanels = kNopePanels + kDr / kPanelCols;
constexpr int kVPanels = kDv / kPanelCols;
constexpr int kQPanelBytes = kBlockM * kRowBytes;
constexpr int kKVPanelBytes = kBlockN * kRowBytes;
constexpr int kQBytes = kQKPanels * kQPanelBytes;
constexpr int kKBytes = kQKPanels * kKVPanelBytes;   // one K tile
constexpr int kVBytes = kVPanels * kKVPanelBytes;    // one V tile
constexpr int kKOff = kQBytes;
constexpr int kVOff = kKOff + kStages * kKBytes;
constexpr int kBarOff = kVOff + kStages * kVBytes;
// barriers: q_full, k_full[kStages], v_full[kStages], empty[kStages], turn[2]
constexpr int kBars = 1 + 3 * kStages + 2;
// + 1024 to align the dynamic shared memory's base to the swizzle atom
constexpr int kSmemBytes = kBarOff + 8 * kBars + 1024;
static_assert(kDr == kPanelCols, "the rope columns are one panel");
static_assert(kSmemBytes <= 232448, "shared memory of one block");

__global__ void __launch_bounds__(kThreads, 1)
mla_attention_fwd_tc(const __grid_constant__ CUtensorMap tm_qn,
                     const __grid_constant__ CUtensorMap tm_qr,
                     const __grid_constant__ CUtensorMap tm_kn,
                     const __grid_constant__ CUtensorMap tm_kr,
                     const __grid_constant__ CUtensorMap tm_v,
                     __nv_bfloat16* __restrict__ o, int S, int H,
                     float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (hopper::smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base;
  const uint32_t sK = base + kKOff;
  const uint32_t sV = base + kVOff;
  const uint32_t q_full = base + kBarOff;
  auto k_full = [&](int s) { return q_full + 8u * (1 + s); };
  auto v_full = [&](int s) { return q_full + 8u * (1 + kStages + s); };
  auto empty = [&](int s) { return q_full + 8u * (1 + 2 * kStages + s); };
  auto turn = [&](int c) { return q_full + 8u * (1 + 3 * kStages + c); };

  // groups of kGroup (b, h) pairs; inside a group the query tiles with the
  // most key tiles go first, across its heads
  const int n_m = (S + kBlockM - 1) / kBlockM;
  const int pairs = gridDim.x / n_m;
  const int g = blockIdx.x / (kGroup * n_m);
  const int g_size = min(kGroup, pairs - g * kGroup);
  const int slot = blockIdx.x - g * kGroup * n_m;
  const int m_block = n_m - 1 - slot / g_size;
  const int bh = g * kGroup + slot % g_size;
  const int h = bh % H;
  const int b = bh / H;
  const int m0 = m_block * kBlockM;
  // keys past the block's last query row are never visible
  const int n_end = min(m0 + kBlockM, S);
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

  const int role = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (role == 0) {
    // ---- producer ----------------------------------------------------------
    hopper::setmaxnreg_dec<24>();
    if (tid == 0) {
      hopper::mbar_expect_tx(q_full, kQBytes);
      for (int p = 0; p < kNopePanels; ++p)
        hopper::tma_load_4d(sQ + p * kQPanelBytes, &tm_qn, q_full,
                            p * kPanelCols, h, m0, b);
      hopper::tma_load_4d(sQ + kNopePanels * kQPanelBytes, &tm_qr, q_full, 0,
                          h, m0, b);
      for (int n = 0; n < n_tiles; ++n) {
        const int s = n % kStages;
        // a fresh barrier counts as having completed the phase of parity 1
        hopper::mbar_wait(empty(s), ((n / kStages) & 1) ^ 1);
        const uint32_t sKs = sK + s * kKBytes;
        hopper::mbar_expect_tx(k_full(s), kKBytes);
        for (int p = 0; p < kNopePanels; ++p)
          hopper::tma_load_4d(sKs + p * kKVPanelBytes, &tm_kn, k_full(s),
                              p * kPanelCols, h, n * kBlockN, b);
        hopper::tma_load_3d(sKs + kNopePanels * kKVPanelBytes, &tm_kr,
                            k_full(s), 0, n * kBlockN, b);
        hopper::mbar_expect_tx(v_full(s), kVBytes);
        for (int p = 0; p < kVPanels; ++p)
          hopper::tma_load_4d(sV + s * kVBytes + p * kKVPanelBytes, &tm_v,
                              v_full(s), p * kPanelCols, h, n * kBlockN, b);
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
  constexpr int kORegs = kDv / 2;
  constexpr int kKSteps = kBlockN / 16;  // k-steps of the PV product
  float o_acc[kORegs];
#pragma unroll
  for (int i = 0; i < kORegs; ++i) o_acc[i] = 0.f;
  float m_A = kNegInf, m_B = kNegInf;    // running max (base-2 logits)
  float l_A = 0.f, l_B = 0.f;            // this thread's part of the row sum

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
            sV + sp * kVBytes + t * 16 * kRowBytes, kKVPanelBytes);
        hopper::WgmmaRS<kDv>::rs(o_acc, p_hi[t], dv);
        hopper::WgmmaRS<kDv>::rs(o_acc, p_lo[t], dv);
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
    const uint32_t sKs = sK + s * kKBytes;

    // S = Q Kᵀ over the two nope panels and the rope panel
    float sacc[kSRegs];
#pragma unroll
    for (int i = 0; i < kSRegs; ++i) sacc[i] = 0.f;
    hopper::mbar_wait(k_full(s), (n / kStages) & 1);
    hopper::fence_regs(sacc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kQKPanels * 4; ++kk) {
      const uint32_t off = (kk % 4) * 32;  // 16 columns of the panel
      hopper::WgmmaSS<kBlockN>::ss(
          sacc, hopper::desc_kmajor(sQc + (kk / 4) * kQPanelBytes + off),
          hopper::desc_kmajor(sKs + (kk / 4) * kKVPanelBytes + off), kk > 0);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sacc);
    if (lane == 0) hopper::mbar_arrive(turn(1 - c));   // the other's turn

    // mask, online softmax (the scale folded into the exponent's FFMA)
    const int k0 = n * kBlockN;
    const bool masked = k0 + kBlockN > S || k0 + kBlockN - 1 > row0;
    float mx_A = kNegInf, mx_B = kNegInf;
#pragma unroll
    for (int j = 0; j < kBlockN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sacc[4 * j + e];
        if (masked) {
          const int kj = k0 + 8 * j + col + (e & 1);
          const int qi = e < 2 ? rA : rB;
          if (kj >= S) {
            x = __int_as_float(0xff800000);  // ragged tile: probability 0
          } else if (kj > qi) {
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
    for (int j = 0; j < kDv / 8; ++j) {
      o_acc[4 * j + 0] *= alpha_A;
      o_acc[4 * j + 1] *= alpha_A;
      o_acc[4 * j + 2] *= alpha_B;
      o_acc[4 * j + 3] *= alpha_B;
    }
  }

  // epilogue
  const float inv_A = 1.f / fmaxf(hopper::quad_sum(l_A), 1e-30f);
  const float inv_B = 1.f / fmaxf(hopper::quad_sum(l_B), 1e-30f);
  const long long row_stride = (long long)H * kDv;
  __nv_bfloat16* oA = o + ((long long)b * S + rA) * row_stride +
                      (long long)h * kDv;
  __nv_bfloat16* oB = oA + 8 * row_stride;
#pragma unroll
  for (int j = 0; j < kDv / 8; ++j) {
    const int d = 8 * j + col;
    if (rA < S)
      *reinterpret_cast<__nv_bfloat162*>(oA + d) = __floats2bfloat162_rn(
          o_acc[4 * j] * inv_A, o_acc[4 * j + 1] * inv_A);
    if (rB < S)
      *reinterpret_cast<__nv_bfloat162*>(oB + d) = __floats2bfloat162_rn(
          o_acc[4 * j + 2] * inv_B, o_acc[4 * j + 3] * inv_B);
  }
}

// A map of `rank` (3 or 4) dims over a bf16 tensor: dims innermost first,
// element strides of dims 1.. (the innermost stride 1), boxes of 64 columns
// by `rows` positions (one head, one batch row), 128-byte swizzle, zero fill
// out of bounds.  4-D: (columns, heads, S, B); 3-D: (columns, S, B).
int make_map(CUtensorMap* map, const void* ptr, int rank,
             const cuuint64_t* dims, const long long* elem_strides,
             int rows) {
  hopper::EncodeTiled fn = hopper::encode_fn();
  if (fn == nullptr) return -1000;
  cuuint64_t strides[3];
  for (int i = 0; i < rank - 1; ++i)
    strides[i] = cuuint64_t(elem_strides[i]) * 2;
  const cuuint32_t box4[4] = {cuuint32_t(kPanelCols), 1, cuuint32_t(rows),
                              1};
  const cuuint32_t box3[3] = {cuuint32_t(kPanelCols), cuuint32_t(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult res = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                          cuuint32_t(rank), const_cast<void*>(ptr), dims,
                          strides, rank == 4 ? box4 : box3, elem,
                          CU_TENSOR_MAP_INTERLEAVE_NONE,
                          CU_TENSOR_MAP_SWIZZLE_128B,
                          CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : -1 - int(res);
}

// a 4-D map of a (B, S, heads, cols) tensor with element strides
// (batch, sequence, head)
int map4(CUtensorMap* map, const void* ptr, int cols, int heads, int S, int B,
         const long long* st, int rows) {
  const cuuint64_t dims[4] = {cuuint64_t(cols), cuuint64_t(heads),
                              cuuint64_t(S), cuuint64_t(B)};
  const long long s[3] = {st[2], st[1], st[0]};
  return make_map(map, ptr, 4, dims, s, rows);
}

}  // namespace

extern "C" {

// strides_*: element strides (batch, sequence, head); strides_kr: (batch,
// sequence)
int mla_attention_tc_bf16(const void* q_nope, const void* q_rope,
                          const void* k_nope, const void* k_rope,
                          const void* v, void* o, int B, int S, int H,
                          const long long* strides_qn,
                          const long long* strides_qr,
                          const long long* strides_kn,
                          const long long* strides_kr,
                          const long long* strides_v, float scale,
                          void* stream) {
  CUtensorMap tm_qn, tm_qr, tm_kn, tm_kr, tm_v;
  int err = map4(&tm_qn, q_nope, kDn, H, S, B, strides_qn, kBlockM);
  if (err == 0) err = map4(&tm_qr, q_rope, kDr, H, S, B, strides_qr, kBlockM);
  if (err == 0) err = map4(&tm_kn, k_nope, kDn, H, S, B, strides_kn, kBlockN);
  if (err == 0) err = map4(&tm_v, v, kDv, H, S, B, strides_v, kBlockN);
  if (err == 0) {
    const cuuint64_t dims[3] = {cuuint64_t(kDr), cuuint64_t(S),
                                cuuint64_t(B)};
    const long long s[2] = {strides_kr[1], strides_kr[0]};
    err = make_map(&tm_kr, k_rope, 3, dims, s, kBlockN);
  }
  if (err != 0) return err;
  cudaError_t cerr = cudaFuncSetAttribute(
      mla_attention_fwd_tc, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (cerr != cudaSuccess) return int(cerr);
  const dim3 grid(unsigned((S + kBlockM - 1) / kBlockM) * H * B);
  const float log2e = 1.4426950408889634f;
  mla_attention_fwd_tc<<<grid, kThreads, kSmemBytes,
                         static_cast<cudaStream_t>(stream)>>>(
      tm_qn, tm_qr, tm_kn, tm_kr, tm_v, static_cast<__nv_bfloat16*>(o), S, H,
      scale * log2e);
  return int(cudaGetLastError());
}

}  // extern "C"
