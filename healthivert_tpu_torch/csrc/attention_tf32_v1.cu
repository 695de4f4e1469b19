// Contextual attention on patch tensors (v1) for float32 on Hopper
// (sm_90a): the float32 route, on the tensor cores in 3xTF32. Plain C
// interface.
//
// Replaces, for float32 inputs, the Pallas TPU kernel
// `attention_scores_paste` / `_attention_kernel`
// (healthivert_tpu/ops/attention_pallas.py:98-249): from foreground patches
// fpat (B, P, K), background patches wnorm (B, L, K) that arrive already
// divided by their norm, raw patches raw (B, L, RC) and the gate mm (B, L),
// the scores s = wnorm fpat^T, both fuse passes, the gated column softmax
// and the patch values vals = probs^T raw (B, P, RC), before any fold. L =
// P = hd * wd. bf16 inputs take attention_tc_v1.cu.
// healthivert_tpu_torch/ops/attention_cuda.py holds the wrapper (the K and
// RC zero pad to a multiple of 64, the scratch) and the plain PyTorch
// version.
//
// What bounds it on this card: the work. At the generator's shapes (L = P
// = 1024, K = 9C = 576, RC = 16C = 1024) a sample is 2 L P (K + RC) = 3.36
// GFLOP, #1's work; a float32 product kept within the float32 gates costs
// three TF32 products (attention_tf32.cu), so the bound is 1.30 ms at B =
// 64 at the TF32 peak over three, against ~13 MB of float32 inputs and
// output a sample.
//
// What this design does about it: it is the float32 forward
// (attention_tf32.cu) with one tap and no shift, as attention_tc_v1.cu is
// the bf16 forward's, from the same pieces (attention_tf32_kernels.cuh,
// attention_tc_kernels.cuh):
//   * The (B, N, K) operands are feature maps: fpat and wnorm are viewed as
//     (B, hd, wd, Kp), raw as (B, hd, wd, RCp), read through the forward's
//     5-D float32 tensor maps (phases = 1) in boxes of 32 channels (128
//     bytes) in its padded position order; TMA fills the phantom columns
//     between wd and wdp, and rows past hd, with zeros.
//   * Where the score's halves come from: split_kernel, once a call, into
//     big and small maps of fpat and wnorm (B, hd, wd, Kp) each, as the
//     forward splits fd and bd. Both operands are K-major already, so the
//     split is the only work a shared-memory pass could take over; at B =
//     64 it moves ~0.9 GB (fpat and wnorm read once, written twice), ~0.27
//     ms at the memory rate (its device time: PERF.md §6, the `split`
//     stage).
//   * score: v1_gemm_tf32<kV1Score>, the forward's (L, P) tile (m64n128,
//     the ring of TF32_STAGES) over Kp / 32 chunks of one tap, three TF32
//     products a K step, written as s (B, L, P) float at the real indices
//     with row scale 1: wnorm arrives normalised, no norm is taken.
//   * fuse + softmax: fuse_softmax_tc_kernel<kFull, float>, unchanged: it
//     writes probs^T in big and small float32 planes (B, P, kp), the
//     paste's A operand, and no float32 probs (v1 returns none).
//   * paste: v1_gemm_tf32<kV1Paste>, the forward's (P, C) tile (m64n64)
//     with one tap, no shift and no phases: M = output positions p, N = 64
//     columns of RC, K = kp positions l. A is the probs^T planes; B raw,
//     MN-major, loaded as two boxes of 32 columns and rewritten K-major and
//     split in shared memory (`PCOpTf32::transform`). vals is written in
//     float32 at the real p, cut back to the real RC.
// Rounding: as the float32 forward's. Every product is small big + big
// small + big big of TF32 halves, summed in float32.
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "attention_tf32_kernels.cuh"

namespace {

enum V1Kind : int { kV1Score = 0, kV1Paste = 1 };

// The score's operands, split K-major feature maps (Kp, wd, hd, 1, B): A
// wnorm at the 64 rows l of the tile, B fpat at its 128 columns p; one tap,
// no shift.
struct V1ScoreOpTf32 : LPOpTf32<kScore> {
  __device__ int iters() const { return chunks; }
  __device__ void load(int it, uint8_t* a0, uint8_t* a1, uint8_t* bt, uint64_t* bar) const {
    const int k0 = it * BK_F32;
    tma_load_5d(a0, ma_big, bar, k0, lj0, li0, 0, b);
    tma_load_5d(a1, ma_small, bar, k0, lj0, li0, 0, b);
    tma_load_5d(bt, mb_big, bar, k0, pj0, pi0, 0, b);
    tma_load_5d(bt + BN * 128, mb_small, bar, k0, pj0, pi0, 0, b);
  }
};

// The paste's operands: A the probs^T planes (kp, wd, hd, B), big and
// small, at the tile's 64 output positions and K block k0 of positions l;
// B raw (RCp, wd, hd, 1, B), MN-major, its 32 K rows the positions l of
// that block (32 consecutive padded positions are a rectangle of the
// grid), as two boxes of 32 columns; one tap, no shift.
struct V1PasteOpTf32 : PCOpTf32<kPaste> {
  __device__ int iters() const { return chunks; }
  __device__ void load(int it, uint8_t* a0, uint8_t* a1, uint8_t* bt, uint64_t* bar) const {
    const int k0 = it * BK_F32;
    tma_load_4d(a0, ma_big, bar, k0, mj0, mi0, b);
    tma_load_4d(a1, ma_small, bar, k0, mj0, mi0, b);
    uint8_t* raw = bt + (RAW_OFF - NA * TILE_BYTES);
    for (int half = 0; half < 2; ++half)
      tma_load_5d(raw + half * (TILE_BYTES / 2), mb, bar, c0 + half * BK_F32, k0 % wdp,
                  k0 / wdp, 0, b);
  }
};

// kV1Score: grid (ceil(hd wdp / 128), ceil(hd wdp / 64), B), maps (wnorm
// big, small, fpat big, small), g.Cp = Kp, out s (B, L, P). kV1Paste: grid
// (RCp / 64, ceil(hd wdp / 64), B), maps (probs^T big, small, raw, unused),
// g.C = RC and g.Cp = RCp, out vals (B, P, RC). Both float32.
template <int KIND>
__global__ void __launch_bounds__(THREADS)
v1_gemm_tf32(const __grid_constant__ CUtensorMap ma_big, const __grid_constant__ CUtensorMap ma_small,
             const __grid_constant__ CUtensorMap mb_big, const __grid_constant__ CUtensorMap mb_small,
             Geom g, float* __restrict__ out) {
  const int b = blockIdx.z;
  const int m0 = blockIdx.y * BM;
  if constexpr (KIND == kV1Score) {
    const int n0 = blockIdx.x * 128;
    const V1ScoreOpTf32 op{{{}, &ma_big, &ma_small, &mb_big, &mb_small, b, m0 / g.wdp,
                            m0 % g.wdp, n0 / g.wdp, n0 % g.wdp, g.Cp / BK_F32}};
    float acc[64];
    mainloop(op, acc);
    v1_store_scores(acc, g, b, m0, n0, out);
  } else {
    const int c0 = blockIdx.x * 64;
    const V1PasteOpTf32 op{{{}, &ma_big, &ma_small, &mb_big, b, m0 / g.wdp, m0 % g.wdp, c0,
                            g.wdp, 0, g.kp / BK_F32, nullptr, g.hd, g.wd}};
    float acc[32];
    mainloop(op, acc);
    v1_store_vals(acc, g, b, m0, c0, out);
  }
}

}  // namespace

// The float32 v1 pipeline on `stream`: split, score GEMM, fuse + softmax,
// paste GEMM. fpat_p, wnorm_p (B, P, Kp) and raw_p (B, L, RCp) float32, K
// and RC zero-padded to multiples of 64 (Kp, RCp); mm (B, L) float. Writes
// vals (B, P, RC) float32. Scratch from the caller: s (B, L, P); maps (4,
// B, P, Kp), fpat's and wnorm's big and small halves; pt (2, B, P, kp),
// probs^T's; all float32. wdp, kp: the padded position order
// (attention_cuda.tc_geometry). fpat_p and wnorm_p start on a 16-byte
// boundary (split_kernel reads four floats at a time). Does not
// synchronise and allocates nothing. Returns 0, a CUDA error, or 1000 + a
// CUresult when a tensor map cannot be built (every map is built before
// the first launch).
extern "C" int hv_attention_tf32_scores_paste(const float* fpat_p, const float* wnorm_p,
                                              const float* raw_p, const float* mm, float* vals,
                                              float* s, float* maps, float* pt, int B, int hd,
                                              int wd, int K, int Kp, int RC, int RCp, int wdp,
                                              int kp, float scale, void* stream) {
  const Geom gk{hd, wd, wdp, kp, K, Kp}, gr{hd, wd, wdp, kp, RC, RCp};
  if (!valid(gk, B) || !valid(gr, B)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int L = hd * wd;
  const size_t n_map = (size_t)B * L * Kp, n_plane = (size_t)B * L * kp;
  float* f_big = maps;
  float* f_small = maps + n_map;
  float* w_big = maps + 2 * n_map;
  float* w_small = maps + 3 * n_map;
  CUtensorMap m_w_big, m_w_small, m_f_big, m_f_small, m_pt_big, m_pt_small, m_raw;
  HV_TRY(feature_map<float>(&m_w_big, w_big, gk, 1, B, BM));
  HV_TRY(feature_map<float>(&m_w_small, w_small, gk, 1, B, BM));
  HV_TRY(feature_map<float>(&m_f_big, f_big, gk, 1, B, 128));
  HV_TRY(feature_map<float>(&m_f_small, f_small, gk, 1, B, 128));
  HV_TRY(plane_map<float>(&m_pt_big, pt, gk, B));
  HV_TRY(plane_map<float>(&m_pt_small, pt + n_plane, gk, B));
  HV_TRY(feature_map<float>(&m_raw, raw_p, gr, 1, B, BK_F32));
  HV_TRY(split_async(fpat_p, f_big, f_small, n_map, st));
  HV_TRY(split_async(wnorm_p, w_big, w_small, n_map, st));
  constexpr int score_bytes = smem_bytes<V1ScoreOpTf32>();
  HV_TRY(smem_attribute(v1_gemm_tf32<kV1Score>, score_bytes));
  v1_gemm_tf32<kV1Score><<<lp_grid(gk, B), THREADS, score_bytes, st>>>(
      m_w_big, m_w_small, m_f_big, m_f_small, gk, s);
  HV_TRY(static_cast<int>(cudaGetLastError()));
  fuse_softmax_tc_kernel<kFull, float><<<dim3((L + SM_COLS - 1) / SM_COLS, B),
                                         dim3(SM_COLS, SOFTMAX_ROWS), 0, st>>>(
      s, mm, nullptr, pt, pt + n_plane, gk, scale);
  HV_TRY(static_cast<int>(cudaGetLastError()));
  constexpr int paste_bytes = smem_bytes<V1PasteOpTf32>();
  HV_TRY(smem_attribute(v1_gemm_tf32<kV1Paste>, paste_bytes));
  v1_gemm_tf32<kV1Paste><<<pc_grid(gr, B, 1), THREADS, paste_bytes, st>>>(
      m_pt_big, m_pt_small, m_raw, m_raw, gr, vals);
  return static_cast<int>(cudaGetLastError());
}
