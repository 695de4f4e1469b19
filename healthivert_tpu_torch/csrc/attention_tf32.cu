// Contextual attention, forward and backward, for float32 on Hopper
// (sm_90a): the float32 route, on the tensor cores in 3xTF32. Plain C
// interface.
//
// Replaces the Pallas TPU kernels `attention_v2` / `_attention_v2_kernel`
// (healthivert_tpu/ops/attention_pallas.py:304-549) and `attention_v2_bwd`
// / `_attention_v2_bwd_kernel` (:597-819) for float32 inputs, with the same
// arguments and results as the bf16 route (attention_tc.cu), whose stages
// it repeats: the training path's default dtype is float32.
// healthivert_tpu_torch/ops/attention_cuda.py holds the wrappers, the
// channel padding and phase split of the inputs, the scratch and the plain
// PyTorch versions.
//
// What bounds it on this card: the work. Per sample (L = P = 1024, C = 64)
// the forward is 9 + 16 shifted (L, P, C) products = 3.36 GFLOP and the
// backward twice that. A float32 product kept within the float32 gates
// costs three TF32 tensor-core products (below), so the bound is the TF32
// peak over three: 1.30 ms for the forward at B = 64 and for the backward
// at B = 32, against 3.21 ms on the 67 TFLOP/s CUDA cores that the first
// float32 kernels used (and reached 18-20 % of).
//
// What this design does about it: the bf16 route's design (TMA-fed wgmma
// GEMMs on the mainloop of attention_tc.cuh, the 2-D shifts as signed TMA
// coordinates with zero fill, the sweeps writing the next GEMM's operand)
// with float32 tiles: 32 values a 128-byte swizzle row, wgmma m64nNk8 in
// TF32, and every operand split:
//   * 3xTF32. A TF32 product keeps 10 mantissa bits (2^-11 relative); one
//     such rounding of the score operands moves s beyond its 2e-5 gate
//     (tests/test_torch_attention_tf32.py). Each float32 operand x is held
//     as big = tf32(x) and small = tf32(x - big) (cvt.rna: the tensor
//     cores drop the low 13 bits of a float32 rather than round them), and
//     x y ~ small big + big small + big big, summed in float32, the small
//     terms first; what is left out (small small, the rounding of small)
//     is ~2^-21 of the product. Every GEMM therefore reads two A and two B
//     tiles a stage and issues three wgmma a K step.
//   * Where the halves come from. The (L, P) operands (probs^T, probs,
//     ds0, ds0^T) are split by the sweeps that write them, as the bf16
//     route's hi/lo planes are, into float32 planes (B, L, kp). The feature
//     maps are float32 too (exact in the bf16 route): the score's and
//     dprobs' (fd, bd; b_full's and dy's phase planes) are split once a
//     call into big and small maps (split_kernel); the (P, C) GEMMs' maps
//     are split in shared memory, below.
//   * K-major B. TF32 wgmma takes no transpose: both operands K-major. The
//     (L, P) GEMMs' operands are (channels innermost). The (P, C) GEMMs
//     (paste, db_full, dfd, dbd) read their B, a feature map with positions
//     as K and channels as N, MN-major. Of the candidates (a transposed
//     copy of the maps in global memory, a transpose in shared memory, or
//     the register-A form on the transposed product) this takes the
//     transpose in shared memory (`PCOpTf32::transform`): TMA loads the map
//     exactly as the bf16 route does, channel rows of 128 bytes, so no box
//     has an inner extent below the swizzle's 128 bytes (a position-
//     innermost copy would have one wherever wdp < 32: the 6 x 10 and
//     16 x 16 grids); and the same pass splits each value into big and
//     small, so the maps need no split copy. The warpgroup rewrites the
//     stage's 32 x 64 tile into two K-major 64 x 32 tiles (16 values a
//     thread, conflict-free loads, 16-byte stores), fences the generic
//     stores to wgmma's async proxy, meets at a barrier and runs the
//     products; the previous stage's products are still in flight.
//   * The ring. A stage holds 48 KiB for an (L, P) GEMM (A big and small,
//     64 x 32; B big and small, 128 x 32) and 40 KiB for a (P, C) GEMM (A
//     big and small, B as loaded and its two K-major halves). The ring has
//     two stages: at 80-96 KiB a block, two blocks fit an SM and hide each
//     other's loads; rings of three and four stages (one block an SM) were
//     slower on the H100 for both the forward and the backward (PERF.md §6).
//   * The sums. The tensor cores truncate each step's float32 sum, so the
//     (P, C) GEMMs, whose K runs to 4 or 9 taps of kp positions, restart
//     their products every 4 stages and add them to the sums in registers
//     (`mainloop`'s PROMOTE, attention_tc.cuh).
//
// The GEMMs (LPOpTf32, PCOpTf32), their kernels and split_kernel are in
// attention_tf32_kernels.cuh, which v1 (attention_tf32_v1.cu) and the stage
// ablation (attention_tf32_ablate.cu) share. Kernels, one after another on
// the caller's stream:
//   forward   split_kernel (fd, bd), patch_norm_kernel<float>
//             (attention_v2_kernels.cuh), lp_gemm_tf32 (score),
//             fuse_softmax_tc_kernel<kFull, float> (probs^T big and small,
//             and probs when asked), pc_gemm_tf32 (paste, one GEMM per
//             output phase)
//   backward  split_kernel (b_full's and dy's phase planes), lp_gemm_tf32
//             (dprobs), split_rows_kernel<float> (probs), pc_gemm_tf32
//             (db_full), softmax_bwd_kernel (attention_v2_common.cuh),
//             fuse_adj_tc_kernel<float> (ds0 and ds0^T, big and small, and
//             the norm row sums), dn2_kernel, pc_gemm_tf32 (dfd),
//             pc_gemm_tf32 (dbd, with the norm term 2 bd box(dn2))
// The sweeps are attention_tc_kernels.cuh's, instantiated on float32
// planes.
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "attention_tf32_kernels.cuh"

// The float32 forward. fd_p, bd_p (B, hd, wd, Cp) and bph (B, 4, hd, wd,
// Cp), the phase planes of b_full, float32 with the channels zero-padded
// to Cp; mm (B, L) float. Writes y (B, 2hd, 2wd, C), s (B, L, P) and
// nrm_raw (B, L), and probs (B, L, P) when it is not null, all float32.
// Scratch: maps (4, B, hd, wd, Cp), fd's and bd's big and small halves;
// pt (2, B, P, kp), probs^T's. Does not synchronise and allocates nothing.
// Returns 0, a CUDA error, or 1000 + a CUresult when a tensor map cannot
// be built (every map is built before the first launch).
extern "C" int hv_attention_tf32_forward(const float* fd_p, const float* bd_p, const float* bph,
                                         const float* mm, float* y, float* s, float* probs,
                                         float* nrm_raw, float* maps, float* pt, int B, int hd,
                                         int wd, int C, int Cp, int wdp, int kp, float scale,
                                         void* stream) {
  const Geom g{hd, wd, wdp, kp, C, Cp};
  if (!valid(g, B)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int L = hd * wd;
  const size_t n_map = (size_t)B * L * Cp, n_plane = (size_t)B * L * kp;
  float* fd_big = maps;
  float* fd_small = maps + n_map;
  float* bd_big = maps + 2 * n_map;
  float* bd_small = maps + 3 * n_map;
  CUtensorMap m_bd_big, m_bd_small, m_fd_big, m_fd_small, m_pt_big, m_pt_small, m_bph;
  HV_TRY(feature_map<float>(&m_bd_big, bd_big, g, 1, B, BM));
  HV_TRY(feature_map<float>(&m_bd_small, bd_small, g, 1, B, BM));
  HV_TRY(feature_map<float>(&m_fd_big, fd_big, g, 1, B, 128));
  HV_TRY(feature_map<float>(&m_fd_small, fd_small, g, 1, B, 128));
  HV_TRY(plane_map<float>(&m_pt_big, pt, g, B));
  HV_TRY(plane_map<float>(&m_pt_small, pt + n_plane, g, B));
  HV_TRY(feature_map<float>(&m_bph, bph, g, 4, B, BK_F32));
  HV_TRY(split_async(fd_p, fd_big, fd_small, n_map, st));
  HV_TRY(split_async(bd_p, bd_big, bd_small, n_map, st));
  const int n_rows = B * L;
  hv_attn::patch_norm_kernel<float><<<(n_rows + 255) / 256, 256, 0, st>>>(bd_p, nrm_raw, n_rows,
                                                                          hd, wd, Cp);
  HV_TRY(static_cast<int>(cudaGetLastError()));
  HV_TRY(launch_lp_tf32<kScore>(m_bd_big, m_bd_small, m_fd_big, m_fd_small, g, B, nrm_raw, s, st));
  fuse_softmax_tc_kernel<kFull, float><<<dim3((L + SM_COLS - 1) / SM_COLS, B),
                                         dim3(SM_COLS, SOFTMAX_ROWS), 0, st>>>(
      s, mm, probs, pt, pt + n_plane, g, scale);
  HV_TRY(static_cast<int>(cudaGetLastError()));
  return launch_pc_tf32<kPaste>(m_pt_big, m_pt_small, m_bph, g, B, nullptr, nullptr, y, st);
}

// The float32 backward. fd_p, bd_p (B, hd, wd, Cp), bph and dyph (B, 4,
// hd, wd, Cp): the inputs and the phase planes of b_full and dy, float32,
// channels zero-padded; probs, s (B, L, P), nrm_raw, mm (B, L) float from
// the forward. Writes dfd, dbd (B, hd, wd, C) and db_full (B, 2hd, 2wd, C)
// float32. Scratch: grad (B, L, P); planes (4, B, L, kp): probs's big and
// small, then ds0's (in the same two), ds0^T's; maps (4, B, 4, hd, wd,
// Cp): bph's and dyph's big and small halves; rowsum, dn2 (B, L). Returns
// as the forward.
extern "C" int hv_attention_tf32_backward(const float* fd_p, const float* bd_p, const float* bph,
                                          const float* dyph, const float* probs, const float* s,
                                          const float* nrm_raw, const float* mm, float* dfd,
                                          float* dbd, float* db_full, float* grad, float* planes,
                                          float* maps, float* rowsum, float* dn2, int B, int hd,
                                          int wd, int C, int Cp, int wdp, int kp, float scale,
                                          void* stream) {
  const Geom g{hd, wd, wdp, kp, C, Cp};
  if (!valid(g, B)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int L = hd * wd;
  const size_t n_ph = (size_t)B * 4 * L * Cp, n_plane = (size_t)B * L * kp;
  float* bph_big = maps;
  float* bph_small = maps + n_ph;
  float* dy_big = maps + 2 * n_ph;
  float* dy_small = maps + 3 * n_ph;
  float* pl_big = planes;
  float* pl_small = planes + n_plane;
  float* plt_big = planes + 2 * n_plane;
  float* plt_small = planes + 3 * n_plane;
  CUtensorMap m_bph_big, m_bph_small, m_dy_big, m_dy_small, m_dyph, m_fd, m_bd;
  CUtensorMap m_pl_big, m_pl_small, m_plt_big, m_plt_small;
  HV_TRY(feature_map<float>(&m_bph_big, bph_big, g, 4, B, BM));
  HV_TRY(feature_map<float>(&m_bph_small, bph_small, g, 4, B, BM));
  HV_TRY(feature_map<float>(&m_dy_big, dy_big, g, 4, B, 128));
  HV_TRY(feature_map<float>(&m_dy_small, dy_small, g, 4, B, 128));
  HV_TRY(feature_map<float>(&m_dyph, dyph, g, 4, B, BK_F32));
  HV_TRY(feature_map<float>(&m_fd, fd_p, g, 1, B, BK_F32));
  HV_TRY(feature_map<float>(&m_bd, bd_p, g, 1, B, BK_F32));
  HV_TRY(plane_map<float>(&m_pl_big, pl_big, g, B));
  HV_TRY(plane_map<float>(&m_pl_small, pl_small, g, B));
  HV_TRY(plane_map<float>(&m_plt_big, plt_big, g, B));
  HV_TRY(plane_map<float>(&m_plt_small, plt_small, g, B));

  HV_TRY(split_async(bph, bph_big, bph_small, n_ph, st));
  HV_TRY(split_async(dyph, dy_big, dy_small, n_ph, st));
  HV_TRY(launch_lp_tf32<kDprobs>(m_bph_big, m_bph_small, m_dy_big, m_dy_small, g, B, nullptr, grad,
                                 st));
  split_rows_kernel<float><<<B * L, 256, 0, st>>>(probs, pl_big, pl_small, g);
  HV_TRY(static_cast<int>(cudaGetLastError()));
  HV_TRY(launch_pc_tf32<kDbfull>(m_pl_big, m_pl_small, m_dyph, g, B, nullptr, nullptr, db_full,
                                 st));
  hv_attn::softmax_bwd_kernel<><<<dim3((L + SM_COLS - 1) / SM_COLS, B), dim3(SM_COLS, SM_ROWS),
                                   0, st>>>(probs, mm, grad, L, scale);
  HV_TRY(static_cast<int>(cudaGetLastError()));
  HV_TRY(static_cast<int>(cudaMemsetAsync(rowsum, 0, sizeof(float) * B * L, st)));
  // ds0 goes into the planes that held probs: db_full has read them
  fuse_adj_tc_kernel<float><<<dim3(kp / BK, kp / BK, B), dim3(SM_COLS, SM_ROWS), 0, st>>>(
      grad, s, nrm_raw, pl_big, pl_small, plt_big, plt_small, rowsum, g);
  HV_TRY(static_cast<int>(cudaGetLastError()));
  dn2_kernel<<<(B * L + 255) / 256, 256, 0, st>>>(rowsum, nrm_raw, dn2, B * L);
  HV_TRY(static_cast<int>(cudaGetLastError()));
  HV_TRY(launch_pc_tf32<kDfd>(m_plt_big, m_plt_small, m_bd, g, B, nullptr, nullptr, dfd, st));
  return launch_pc_tf32<kDbd>(m_pl_big, m_pl_small, m_fd, g, B, dn2, bd_p, dbd, st);
}
