// Contextual attention on patch tensors (v1) for bf16 on Hopper (sm_90a):
// the bf16 route, on the tensor cores. Plain C interface.
//
// Replaces, for bf16 inputs, the Pallas TPU kernel `attention_scores_paste`
// / `_attention_kernel` (healthivert_tpu/ops/attention_pallas.py:98-249):
// from foreground patches fpat (B, P, K), background patches wnorm (B, L, K)
// that arrive already divided by their norm, raw patches raw (B, L, RC) and
// the gate mm (B, L), the scores s = wnorm fpat^T, both fuse passes, the
// gated column softmax and the patch values vals = probs^T raw (B, P, RC),
// before any fold. L = P = hd * wd. float32 inputs take the 3xTF32 route
// of attention_tf32_v1.cu. healthivert_tpu_torch/ops/attention_cuda.py
// holds the wrapper (the K and RC zero pad to a multiple of 64, the
// scratch) and the plain PyTorch version.
//
// What bounds it on this card: the work. At the generator's shapes (L = P
// = 1024, K = 9C = 576, RC = 16C = 1024) a sample is 2 L P (K + RC) = 3.36
// GFLOP, #1's work (0.217 ms at B = 64 at the 989 TFLOP/s bf16 peak),
// against ~6.6 MB of bf16 inputs and output: the patch tensors are 9x and
// 16x the feature maps #1 reads, but still far above the ~295 FLOP/byte
// ridge.
//
// What this design does about it: it is #1's forward (attention_tc.cu) with
// one tap and no shift, from the same pieces (attention_tc_kernels.cuh):
//   * The (B, N, K) operands are feature maps: fpat and wnorm are viewed as
//     (B, hd, wd, Kp), raw as (B, hd, wd, RCp), and read through #1's 5-D
//     tensor maps (phases = 1) in its padded position order. TMA fills the
//     phantom columns between wd and wdp, and rows past hd, with zeros.
//   * score: v1_gemm<kV1Score>, #1's (L, P) tile (m64n128, the TMA ring of
//     attention_tc.cuh) over Kp / 64 chunks of one tap (9 at K = 576, as
//     #1's 9 taps of one chunk), written as s (B, L, P) float at the real
//     indices with row scale 1: wnorm arrives normalised, no norm is taken.
//   * fuse + softmax: #1's fuse_softmax_tc_kernel, unchanged: it writes
//     probs^T in hi and lo bf16 planes (B, P, kp), the paste's A operand,
//     and no float32 probs (v1 returns none).
//   * paste: v1_gemm<kV1Paste>, #1's (P, C) tile (m64n64) with one tap, no
//     shift and no phases: M = output positions p, N = 64 columns of RC,
//     K = kp positions l. A is the hi/lo planes (two products a step, so
//     that probs keep ~2^-17 of their value: one bf16 rounding breaks y's
//     gate, PERF.md), B raw, MN-major. vals is written in bf16 at the real
//     p, cut back to the real RC.
// Rounding: as #1's forward. s is a float32 sum of exact bf16 products,
// probs are split hi/lo, vals rounds once to bf16 from float32 sums.
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "attention_tc_kernels.cuh"

namespace {

enum V1Kind : int { kV1Score = 0, kV1Paste = 1 };

// The score's operands, both K-major feature maps (Kp, wd, hd, 1, B): A
// wnorm at the 64 rows l of the tile, B fpat at its 128 columns p.
struct V1ScoreOp : Bf16Ring {
  static constexpr int BN = 128, NA = 1, TRANS_B = 0;
  static constexpr bool REG_A = false;
  const CUtensorMap* ma;
  const CUtensorMap* mb;
  int b, li0, lj0, pi0, pj0, chunks;
  __device__ int iters() const { return chunks; }
  __device__ uint32_t stage_bytes() const { return 3 * TILE_BYTES; }
  __device__ void load(int it, uint8_t* a0, uint8_t*, uint8_t* bt, uint64_t* bar) const {
    tma_load_5d(a0, ma, bar, it * BK, lj0, li0, 0, b);
    tma_load_5d(bt, mb, bar, it * BK, pj0, pi0, 0, b);
  }
};

// The paste's operands: A the probs^T planes (kp, wd, hd, B), hi and lo, at
// the tile's 64 output positions and K block k0 of positions l; B raw
// (RCp, wd, hd, 1, B), MN-major, its 64 K rows the positions l of that
// block (64 consecutive padded positions are a rectangle of the grid).
struct V1PasteOp : Bf16Ring {
  static constexpr int BN = 64, NA = 2, TRANS_B = 1;
  static constexpr bool REG_A = false;
  const CUtensorMap* ma_hi;
  const CUtensorMap* ma_lo;
  const CUtensorMap* mb;
  int b, mi0, mj0, c0, wdp, chunks;
  __device__ int iters() const { return chunks; }
  __device__ uint32_t stage_bytes() const { return 3 * TILE_BYTES; }
  __device__ void load(int it, uint8_t* a0, uint8_t* a1, uint8_t* bt, uint64_t* bar) const {
    const int k0 = it * BK;
    tma_load_4d(a0, ma_hi, bar, k0, mj0, mi0, b);
    tma_load_4d(a1, ma_lo, bar, k0, mj0, mi0, b);
    tma_load_5d(bt, mb, bar, c0, k0 % wdp, k0 / wdp, 0, b);
  }
};

// kV1Score: grid (ceil(hd wdp / 128), ceil(hd wdp / 64), B), maps (wnorm,
// unused, fpat), g.Cp = Kp, out s (B, L, P) float. kV1Paste: grid (RCp /
// 64, ceil(hd wdp / 64), B), maps (hi, lo, raw), g.C = RC and g.Cp = RCp,
// out vals (B, P, RC) bf16.
template <int KIND>
__global__ void __launch_bounds__(THREADS)
v1_gemm(const __grid_constant__ CUtensorMap ma, const __grid_constant__ CUtensorMap ma_lo,
        const __grid_constant__ CUtensorMap mb, Geom g, void* __restrict__ out) {
  const int b = blockIdx.z;
  const int m0 = blockIdx.y * BM;
  if constexpr (KIND == kV1Score) {
    const int n0 = blockIdx.x * 128;
    const V1ScoreOp op{{}, &ma, &mb, b, m0 / g.wdp, m0 % g.wdp, n0 / g.wdp, n0 % g.wdp,
                       g.Cp / BK};
    float acc[64];
    mainloop(op, acc);
    v1_store_scores(acc, g, b, m0, n0, static_cast<float*>(out));
  } else {
    const int c0 = blockIdx.x * 64;
    const V1PasteOp op{{}, &ma, &ma_lo, &mb, b, m0 / g.wdp, m0 % g.wdp, c0, g.wdp, g.kp / BK};
    float acc[32];
    mainloop(op, acc);
    v1_store_vals(acc, g, b, m0, c0, static_cast<bf16*>(out));
  }
}

}  // namespace

// The bf16 v1 pipeline on `stream`: score GEMM, fuse + softmax, paste GEMM.
// fpat_p, wnorm_p (B, P, Kp) and raw_p (B, L, RCp) bf16, K and RC
// zero-padded to multiples of 64 (Kp, RCp); mm (B, L) float. Writes vals
// (B, P, RC) bf16. Scratch from the caller: s (B, L, P) float, pt_hi and
// pt_lo (B, P, kp) bf16. wdp, kp: the padded position order
// (attention_cuda.tc_geometry). Does not synchronise and allocates nothing.
// Returns 0, a CUDA error, or 1000 + a CUresult when a tensor map cannot be
// built (every map is built before the first launch).
extern "C" int hv_attention_tc_scores_paste(const void* fpat_p, const void* wnorm_p,
                                            const void* raw_p, const float* mm, void* vals,
                                            float* s, void* pt_hi, void* pt_lo, int B, int hd,
                                            int wd, int K, int Kp, int RC, int RCp, int wdp,
                                            int kp, float scale, void* stream) {
  const Geom gk{hd, wd, wdp, kp, K, Kp}, gr{hd, wd, wdp, kp, RC, RCp};
  if (!valid(gk, B) || !valid(gr, B)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  CUtensorMap m_w, m_f, m_hi, m_lo, m_raw;
  HV_TRY(feature_map(&m_w, wnorm_p, gk, 1, B, BM));
  HV_TRY(feature_map(&m_f, fpat_p, gk, 1, B, 128));
  HV_TRY(plane_map(&m_hi, pt_hi, gk, B));
  HV_TRY(plane_map(&m_lo, pt_lo, gk, B));
  HV_TRY(feature_map(&m_raw, raw_p, gr, 1, B, BM));
  const int L = hd * wd;
  HV_TRY(smem_attribute(v1_gemm<kV1Score>));
  v1_gemm<kV1Score><<<lp_grid(gk, B), THREADS, SMEM_BYTES, st>>>(m_w, m_w, m_f, gk, s);
  HV_TRY(static_cast<int>(cudaGetLastError()));
  fuse_softmax_tc_kernel<><<<dim3((L + SM_COLS - 1) / SM_COLS, B),
                             dim3(SM_COLS, SOFTMAX_ROWS), 0, st>>>(
      s, mm, nullptr, static_cast<bf16*>(pt_hi), static_cast<bf16*>(pt_lo), gk, scale);
  HV_TRY(static_cast<int>(cudaGetLastError()));
  HV_TRY(smem_attribute(v1_gemm<kV1Paste>));
  v1_gemm<kV1Paste><<<pc_grid(gr, B, 1), THREADS, SMEM_BYTES, st>>>(m_hi, m_lo, m_raw, gr, vals);
  return static_cast<int>(cudaGetLastError());
}
