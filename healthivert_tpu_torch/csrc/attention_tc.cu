// Contextual attention, forward and backward, for bf16 on Hopper (sm_90a):
// the bf16 route, on the tensor cores. Plain C interface.
//
// Replaces the Pallas TPU kernels `attention_v2` / `_attention_v2_kernel`
// (healthivert_tpu/ops/attention_pallas.py:304-549) and `attention_v2_bwd`
// / `_attention_v2_bwd_kernel` (:597-819) for bf16 inputs, with the same
// arguments and results as the float32 route (attention_tf32.cu, the same
// stages in 3xTF32 on the same mainloop).
// healthivert_tpu_torch/ops/attention_cuda.py holds the wrappers, the
// channel padding and phase split of the inputs, the scratch planes and
// the plain PyTorch versions.
//
// What bounds it on this card: the work. Per sample (L = P = 1024, C = 64)
// the forward is 9 + 16 shifted (L, P, C) products = 3.36 GFLOP (0.217 ms
// at B = 64 at the 989 TFLOP/s bf16 peak) and the backward twice that
// (0.217 ms at B = 32), against a few MB of bf16 maps. The first, CUDA-
// core kernels ran at ~1.3 % of that bound: float FMAs on 67 TFLOP/s
// cores, per-element division, modulo and bounds checks in every tile
// loader, synchronous loads. The fuse and softmax sweeps over the (L, P)
// float32 matrices are bound by bytes: reading s once and writing the
// probabilities once is ~12 MB a sample, 0.23 ms at B = 64 at 3.35 TB/s
// (0.12 ms without the float32 probs, which serving does not emit).
//
// What this design does about it:
//   * All six GEMMs (score, paste; dprobs, db_full, dfd, dbd) run one
//     mainloop (attention_tc.cuh): TMA loads into a 4-stage ring,
//     wgmma.mma_async with float32 sums in registers, one warpgroup a tile.
//   * TMA does the 2-D shifts: each operand is a tensor map over a view
//     (channels or an (L, P) row, then wd, hd, phase plane, sample) loaded
//     at the tile's corner plus the tap's signed offset; its out-of-bounds
//     fill is the zero padding of the shift. No index arithmetic per loaded
//     element remains.
//   * The 2 x 2 phase planes of b_full and dy come from a phase split in the
//     wrapper (one copy, with the channel pad); the paste's B operand is
//     then a plain 5-D map. The stage ablation (attention_tc_ablate.cu)
//     also reads b_full in its natural layout, through a tensor map with
//     element stride 2, and measures what that copy costs (PERF.md).
//   * The sweeps between GEMMs write the next GEMM's operand directly, in
//     bf16, in the layout its tensor map reads.
//
// Rounding, each against the plain float32 version at the gates of
// tests/test_torch_cuda_kernel.py:
//   * fd, bd, b_full and dy are bf16 inputs: exact in the tensor cores, and
//     s, dprobs are float32 sums of exact products (s within 2e-5).
//   * probs (paste, db_full) and ds0 (dfd, dbd) are float32 (L, P) values.
//     One bf16 rounding (2^-9 relative) moved y by 3.3e-3 of its largest
//     entry in the CUDA-core ablation (paste_bf16), beyond two bf16 ulps of
//     small entries. So each is split into hi = bf16(v) and lo = bf16(v -
//     hi), two products summed in one accumulator: |v - hi - lo| <= 2^-17
//     |v|. At 1 x 32 x 32 x 64 the split moves y by 5.4e-6 (its largest
//     entry is 3.0) and leaves y and the gradients within a quarter of the
//     bf16 gates against the JAX package; one bf16 rounding of probs would
//     take y to 1.6x its gate (tests/test_torch_attention_tc.py).
//   * Outputs are rounded once to bf16 from the float32 sums.
// Measured on an H100 against the plain version (chip_smoke.py, PERF.md):
// s within 3.3e-7, probs within 1.7e-5, y within the two-ulp gate (largest
// error 0.0156), the gradients within two ulps plus 1e-4 of their largest
// entry.
//
// Kernels, one after another on the caller's stream (the forward's, and
// the tensor maps, in attention_tc_kernels.cuh, which the ablation shares):
//   forward   patch_norm_kernel (attention_v2_kernels.cuh), lp_gemm (score),
//             fuse_softmax_tc_kernel, pc_gemm (paste, one GEMM per output
//             phase)
//   backward  lp_gemm (dprobs), split_rows_kernel (probs to hi/lo), pc_gemm
//             (db_full), softmax_bwd_kernel (attention_v2_common.cuh),
//             fuse_adj_tc_kernel (ds0 and its transpose, hi/lo, and the norm
//             row sums), dn2_kernel, pc_gemm (dfd), pc_gemm (dbd, with the
//             norm term 2 bd box(dn2) in its epilogue); the sweeps are in
//             attention_tc_kernels.cuh too, shared with the float32 route
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "attention_tc_kernels.cuh"

// The bf16 forward. fd_p, bd_p (B, hd, wd, Cp) and bph (B, 4, hd, wd, Cp),
// the phase planes of b_full, all bf16 with the channels zero-padded to Cp;
// mm (B, L) float. Writes y (B, 2hd, 2wd, C) bf16, s (B, L, P) and
// nrm_raw (B, L) float, and probs (B, L, P) float when it is not null.
// pt_hi, pt_lo: (B, P, kp) bf16 scratch. Returns 0, a CUDA error, or
// 1000 + a CUresult when a tensor map cannot be built.
extern "C" int hv_attention_tc_forward(const void* fd_p, const void* bd_p, const void* bph,
                                       const float* mm, void* y, float* s, float* probs,
                                       float* nrm_raw, void* pt_hi, void* pt_lo, int B, int hd,
                                       int wd, int C, int Cp, int wdp, int kp, float scale,
                                       void* stream) {
  const Geom g{hd, wd, wdp, kp, C, Cp};
  if (!valid(g, B)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  CUtensorMap m_bd, m_fd, m_hi, m_lo, m_bph;
  HV_TRY(feature_map(&m_bd, bd_p, g, 1, B, BM));
  HV_TRY(feature_map(&m_fd, fd_p, g, 1, B, 128));
  HV_TRY(plane_map(&m_hi, pt_hi, g, B));
  HV_TRY(plane_map(&m_lo, pt_lo, g, B));
  HV_TRY(feature_map(&m_bph, bph, g, 4, B, BM));
  const int L = hd * wd;
  const int n_rows = B * L;
  hv_attn::patch_norm_kernel<bf16><<<(n_rows + 255) / 256, 256, 0, st>>>(
      static_cast<const bf16*>(bd_p), nrm_raw, n_rows, hd, wd, Cp);
  HV_TRY(static_cast<int>(cudaGetLastError()));
  HV_TRY(launch_lp<kScore>(m_bd, m_fd, g, B, nrm_raw, s, st));
  fuse_softmax_tc_kernel<><<<dim3((L + SM_COLS - 1) / SM_COLS, B),
                             dim3(SM_COLS, SOFTMAX_ROWS), 0, st>>>(
      s, mm, probs, static_cast<bf16*>(pt_hi), static_cast<bf16*>(pt_lo), g, scale);
  HV_TRY(static_cast<int>(cudaGetLastError()));
  return launch_pc<kPaste>(m_hi, m_lo, m_bph, g, B, nullptr, nullptr, y, st);
}

// The bf16 backward. fd_p, bd_p (B, hd, wd, Cp), bph and dyph (B, 4, hd,
// wd, Cp): the inputs and the phase planes of b_full and dy, bf16, channels
// zero-padded; probs, s (B, L, P), nrm_raw, mm (B, L) float from the
// forward. Writes dfd, dbd (B, hd, wd, C) and db_full (B, 2hd, 2wd, C)
// bf16. Scratch: grad (B, L, P) float; pl_hi, pl_lo, plt_hi, plt_lo (B, L,
// kp) bf16; rowsum, dn2 (B, L) float. Returns as the forward.
extern "C" int hv_attention_tc_backward(const void* fd_p, const void* bd_p, const void* bph,
                                        const void* dyph, const float* probs, const float* s,
                                        const float* nrm_raw, const float* mm, void* dfd,
                                        void* dbd, void* db_full, float* grad, void* pl_hi,
                                        void* pl_lo, void* plt_hi, void* plt_lo, float* rowsum,
                                        float* dn2, int B, int hd, int wd, int C, int Cp,
                                        int wdp, int kp, float scale, void* stream) {
  const Geom g{hd, wd, wdp, kp, C, Cp};
  if (!valid(g, B)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  CUtensorMap m_bph, m_dyph_n, m_dyph, m_fd, m_bd, m_hi, m_lo, m_thi, m_tlo;
  HV_TRY(feature_map(&m_bph, bph, g, 4, B, BM));
  HV_TRY(feature_map(&m_dyph_n, dyph, g, 4, B, 128));
  HV_TRY(feature_map(&m_dyph, dyph, g, 4, B, BM));
  HV_TRY(feature_map(&m_fd, fd_p, g, 1, B, BM));
  HV_TRY(feature_map(&m_bd, bd_p, g, 1, B, BM));
  HV_TRY(plane_map(&m_hi, pl_hi, g, B));
  HV_TRY(plane_map(&m_lo, pl_lo, g, B));
  HV_TRY(plane_map(&m_thi, plt_hi, g, B));
  HV_TRY(plane_map(&m_tlo, plt_lo, g, B));
  const int L = hd * wd;
  bf16* hi = static_cast<bf16*>(pl_hi);
  bf16* lo = static_cast<bf16*>(pl_lo);

  HV_TRY(launch_lp<kDprobs>(m_bph, m_dyph_n, g, B, nullptr, grad, st));
  split_rows_kernel<bf16><<<B * L, 256, 0, st>>>(probs, hi, lo, g);
  HV_TRY(static_cast<int>(cudaGetLastError()));
  HV_TRY(launch_pc<kDbfull>(m_hi, m_lo, m_dyph, g, B, nullptr, nullptr, db_full, st));
  hv_attn::softmax_bwd_kernel<><<<dim3((L + SM_COLS - 1) / SM_COLS, B), dim3(SM_COLS, SM_ROWS),
                                   0, st>>>(probs, mm, grad, L, scale);
  HV_TRY(static_cast<int>(cudaGetLastError()));
  HV_TRY(static_cast<int>(cudaMemsetAsync(rowsum, 0, sizeof(float) * B * L, st)));
  // ds0 goes into the planes that held probs: db_full has read them
  fuse_adj_tc_kernel<bf16><<<dim3(kp / BK, kp / BK, B), dim3(SM_COLS, SM_ROWS), 0, st>>>(
      grad, s, nrm_raw, hi, lo, static_cast<bf16*>(plt_hi), static_cast<bf16*>(plt_lo), rowsum, g);
  HV_TRY(static_cast<int>(cudaGetLastError()));
  dn2_kernel<<<(B * L + 255) / 256, 256, 0, st>>>(rowsum, nrm_raw, dn2, B * L);
  HV_TRY(static_cast<int>(cudaGetLastError()));
  HV_TRY(launch_pc<kDfd>(m_thi, m_tlo, m_bd, g, B, nullptr, nullptr, dfd, st));
  return launch_pc<kDbd>(m_hi, m_lo, m_fd, g, B, dn2, bd_p, dbd, st);
}
