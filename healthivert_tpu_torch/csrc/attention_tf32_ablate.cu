// Stage ablation of the contextual-attention forward on the float32
// tensor-core route (3xTF32), for Hopper (sm_90a), with a plain C
// interface.
//
// Replaces, for float32 inputs, the Pallas TPU kernels of the JAX package's
// timing ablation, experiments/attn_ablate.py: `run` (:247) and
// `run_padded` (:289) over `_kernel` (:52-243), `run_auto` (:466) over
// `_kernel_auto` (:326-462) and `run_fold` (:657) over `_kernel_fold`
// (:504-653). bf16 inputs take attention_tc_ablate.cu.
// healthivert_tpu_torch/experiments/attn_ablate.py holds the wrappers and
// the plain PyTorch version of every mode.
//
// Each mode runs the float32 forward of attention_tf32.cu (its kernels,
// from attention_tf32_kernels.cuh and attention_tc_kernels.cuh) with one
// stage dropped or changed, the mode fixed at compile time, as
// attention_tc_ablate.cu does for bf16:
//   full        split_kernel (fd, bd), patch_norm_kernel<float>,
//               lp_gemm_tf32<kScore>, fuse_softmax_tc_kernel<kFull, float>,
//               the paste GEMM: the forward's launches in its order
//   no_score    s = 0.5 everywhere in place of the split, the norm and the
//               score GEMM
//   no_fuse     the sweep reads s[l, p] in place of the 9-tap gather
//   no_softmax  the sweep writes the fused scores, split big/small: no max
//               and sum sweep, no exp, 1/sum or gate
//   no_paste    y = 0 in place of the paste GEMM
//   paste_bf16  the sweep writes each probability rounded to bf16 into the
//               big plane alone, and the paste rounds b_full to bf16 in its
//               transform and takes one TF32 product a step. bf16 values
//               are exact in TF32 and their products in float32, so this is
//               the plain version's rounding; on this route the mode
//               measures what the split of probs and the two extra products
//               cost
//   fold_norm   the sweep writes e * g unnormalised and 1/sum per column;
//               the paste's transform scales each A row, big + small, by
//               its column's 1/sum in shared memory and splits it again
//               (the bf16 route's register-A form and this rescale took the
//               same time there, attention_tc_ablate.cu)
//   floor       y = 0 and nothing else
// and `layout` picks how b_full comes in and y goes out: natural (B, 2hd,
// 2wd, C), read through `natural_map<float>` (attention_ablate.cuh: element
// stride 2 on the pixel rows, boxes of 32 channels by 32 positions), or the
// 2 x 2 phase planes (B, 2, 2, hd, wd, C). `ring` is the depth of every
// GEMM's TMA ring: TF32_STAGES (2), the forward's, or 1 (mainloop_sync,
// synchronous loads; phase layout only): `run_auto`'s question on this
// card.
//
// What bounds it: as the forward in mode full, the work (3.36 GFLOP a
// sample at L = P = 1024, C = 64; 1.30 ms at B = 64 at the TF32 peak over
// three); the dropped stages' times are what the ablation measures. The
// design is the float32 forward's; no mode changes full's launches, and
// full's products are the forward's in the same order, so its y equals the
// float32 attention_v2's bit for bit in either layout and at either ring
// depth.
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "attention_ablate.cuh"
#include "attention_tf32_kernels.cuh"

namespace {

// The score GEMM at ring depth 1.
template <int KIND>
__global__ void __launch_bounds__(THREADS)
lp_gemm_tf32_sync(const __grid_constant__ CUtensorMap ma_big,
                  const __grid_constant__ CUtensorMap ma_small,
                  const __grid_constant__ CUtensorMap mb_big,
                  const __grid_constant__ CUtensorMap mb_small, Geom g,
                  const float* __restrict__ nrm_raw, float* __restrict__ out) {
  lp_tile_tf32<KIND, 1>(ma_big, ma_small, mb_big, mb_small, g, nrm_raw, out);
}

// The ablation's paste: variant VAR, layout IO, ring depth NSTAGES. Grid
// (Cp / 64, ceil(hd wdp / 64) x 4, B).
template <int VAR, int IO, int NSTAGES>
__global__ void __launch_bounds__(THREADS)
paste_gemm_tf32(const __grid_constant__ CUtensorMap ma_big,
                const __grid_constant__ CUtensorMap ma_small,
                const __grid_constant__ CUtensorMap mb, Geom g,
                const float* __restrict__ col_inv, float* __restrict__ out) {
  pc_tile_tf32<kPaste, VAR, IO, NSTAGES>(ma_big, ma_small, mb, g, nullptr, nullptr, col_inv,
                                         out);
}

template <int NSTAGES>
int launch_score(const CUtensorMap& ma_big, const CUtensorMap& ma_small,
                 const CUtensorMap& mb_big, const CUtensorMap& mb_small, const Geom& g, int B,
                 const float* nrm_raw, float* s, cudaStream_t st) {
  if constexpr (NSTAGES == TF32_STAGES) {
    return launch_lp_tf32<kScore>(ma_big, ma_small, mb_big, mb_small, g, B, nrm_raw, s, st);
  } else {
    constexpr int bytes = smem_bytes<LPOpTf32<kScore>>();
    HV_TRY(smem_attribute(lp_gemm_tf32_sync<kScore>, bytes));
    lp_gemm_tf32_sync<kScore><<<lp_grid(g, B), THREADS, bytes, st>>>(
        ma_big, ma_small, mb_big, mb_small, g, nrm_raw, s);
    return static_cast<int>(cudaGetLastError());
  }
}

template <int VAR, int IO, int NSTAGES>
int launch_paste(const CUtensorMap& ma_big, const CUtensorMap& ma_small, const CUtensorMap& mb,
                 const Geom& g, int B, const float* col_inv, float* y, cudaStream_t st) {
  constexpr int bytes = smem_bytes<PCOpTf32<kPaste, VAR, IO>>();
  HV_TRY(smem_attribute(paste_gemm_tf32<VAR, IO, NSTAGES>, bytes));
  paste_gemm_tf32<VAR, IO, NSTAGES><<<pc_grid(g, B, 4), THREADS, bytes, st>>>(
      ma_big, ma_small, mb, g, col_inv, y);
  return static_cast<int>(cudaGetLastError());
}

struct Args {
  const float* fd;
  const float* bd;
  const float* b_op;  // b_full natural (B, 2hd, 2wd, Cp) or its planes (B, 4, hd, wd, Cp)
  const float* mm;
  float* y;
  float* s;
  float* nrm_raw;
  float* maps;  // (4, B, hd, wd, Cp): fd's and bd's big and small halves
  float* pt_big;
  float* pt_small;
  float* col_inv;
  int B;
  Geom g;
  float scale;
};

// The forward's stages with sweep variant SMODE and paste variant PVAR:
// constant scores in place of the split, the norm and the score GEMM when
// !score, zeros in place of the paste when !paste. Every tensor map is
// built before the first launch, so a map cuTensorMapEncodeTiled refuses
// launches nothing.
template <int SMODE, int PVAR, int IO, int NSTAGES>
int stages(const Args& a, bool score, bool paste, cudaStream_t st) {
  const Geom& g = a.g;
  const int L = g.L();
  const size_t n_map = (size_t)a.B * L * g.Cp;
  float *fd_big = nullptr, *fd_small = nullptr, *bd_big = nullptr, *bd_small = nullptr;
  CUtensorMap m_bd_big, m_bd_small, m_fd_big, m_fd_small, m_pt_big, m_pt_small, m_b;
  if (score) {
    fd_big = a.maps;
    fd_small = a.maps + n_map;
    bd_big = a.maps + 2 * n_map;
    bd_small = a.maps + 3 * n_map;
    HV_TRY(feature_map<float>(&m_bd_big, bd_big, g, 1, a.B, BM));
    HV_TRY(feature_map<float>(&m_bd_small, bd_small, g, 1, a.B, BM));
    HV_TRY(feature_map<float>(&m_fd_big, fd_big, g, 1, a.B, 128));
    HV_TRY(feature_map<float>(&m_fd_small, fd_small, g, 1, a.B, 128));
  }
  if (paste) {
    HV_TRY(plane_map<float>(&m_pt_big, a.pt_big, g, a.B));
    // paste_bf16 reads no small plane: its map is never loaded
    HV_TRY(plane_map<float>(&m_pt_small, PVAR == kPasteBf16 ? a.pt_big : a.pt_small, g, a.B));
    HV_TRY(IO == kNaturalToNatural ? natural_map<float>(&m_b, a.b_op, g, a.B)
                                   : feature_map<float>(&m_b, a.b_op, g, 4, a.B, BK_F32));
  }
  if (score) {
    HV_TRY(split_async(a.fd, fd_big, fd_small, n_map, st));
    HV_TRY(split_async(a.bd, bd_big, bd_small, n_map, st));
    const int n_rows = a.B * L;
    hv_attn::patch_norm_kernel<float><<<(n_rows + 255) / 256, 256, 0, st>>>(
        a.bd, a.nrm_raw, n_rows, g.hd, g.wd, g.Cp);
    HV_TRY(static_cast<int>(cudaGetLastError()));
    HV_TRY(launch_score<NSTAGES>(m_bd_big, m_bd_small, m_fd_big, m_fd_small, g, a.B, a.nrm_raw,
                                 a.s, st));
  } else {
    HV_TRY(fill_async<float>(a.s, 0.5f, (size_t)a.B * L * L, st));
  }
  fuse_softmax_tc_kernel<SMODE, float><<<dim3((L + SM_COLS - 1) / SM_COLS, a.B),
                                         dim3(SM_COLS, SOFTMAX_ROWS), 0, st>>>(
      a.s, a.mm, nullptr, a.pt_big, a.pt_small, g, a.scale, a.col_inv);
  HV_TRY(static_cast<int>(cudaGetLastError()));
  if (paste) {
    return launch_paste<PVAR, IO, NSTAGES>(m_pt_big, m_pt_small, m_b, g, a.B, a.col_inv, a.y, st);
  }
  return fill_async<float>(a.y, 0.f, (size_t)a.B * 4 * L * g.C, st);
}

template <int IO, int NSTAGES>
int dispatch(const Args& a, int mode, cudaStream_t st) {
  switch (mode) {
    case kAblFull: return stages<kFull, kFull, IO, NSTAGES>(a, true, true, st);
    case kAblNoScore: return stages<kFull, kFull, IO, NSTAGES>(a, false, true, st);
    case kAblNoFuse: return stages<kNoFuse, kFull, IO, NSTAGES>(a, true, true, st);
    case kAblNoSoftmax: return stages<kNoSoftmax, kFull, IO, NSTAGES>(a, true, true, st);
    case kAblNoPaste: return stages<kFull, kFull, IO, NSTAGES>(a, true, false, st);
    case kAblPasteBf16: return stages<kPasteBf16, kPasteBf16, IO, NSTAGES>(a, true, true, st);
    case kAblFoldNorm: return stages<kFoldNorm, kFoldNorm, IO, NSTAGES>(a, true, true, st);
    case kAblFloor: return fill_async<float>(a.y, 0.f, (size_t)a.B * 4 * a.g.L() * a.g.C, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Launches one mode of the ablation on the float32 route on `stream`.
// fd_p, bd_p (B, hd, wd, Cp) float32, starting on a 16-byte boundary
// (split_kernel reads four floats at a time), and b_op (b_full (B, 2hd,
// 2wd, Cp) for layout 0 = natural, its planes (B, 4, hd, wd, Cp) for layout
// 1 = phases), channels zero-padded to Cp; mm (B, L) float; y (B, 2hd, 2wd,
// C) or (B, 2, 2, hd, wd, C) float32. Scratch from the caller, each NULL
// where the mode launches no stage that uses it: s (B, L, P) (all but
// floor); nrm_raw (B, L) and maps (4, B, hd, wd, Cp) (all but floor and
// no_score); pt_big (B, P, kp) (all but floor), pt_small the same (all but
// floor and paste_bf16); col_inv (B, L) (fold_norm); all float32. mode: the
// index into MODES; ring: TF32_STAGES, or 1 with layout 1. Does not
// synchronise and allocates nothing. Returns 0, a CUDA error, or 1000 + a
// CUresult when a tensor map cannot be built.
extern "C" int hv_attention_tf32_ablate(const float* fd_p, const float* bd_p, const float* b_op,
                                        const float* mm, float* y, float* s, float* nrm_raw,
                                        float* maps, float* pt_big, float* pt_small,
                                        float* col_inv, int B, int hd, int wd, int C, int Cp,
                                        int wdp, int kp, float scale, int mode, int layout,
                                        int ring, void* stream) {
  const Args a{fd_p, bd_p, b_op, mm, y, s, nrm_raw, maps, pt_big, pt_small, col_inv,
               B, Geom{hd, wd, wdp, kp, C, Cp}, scale};
  if (!valid(a.g, B)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (layout == 0 && ring == TF32_STAGES) return dispatch<kNaturalToNatural, TF32_STAGES>(a, mode, st);
  if (layout == 1 && ring == TF32_STAGES) return dispatch<kPlanesToPlanes, TF32_STAGES>(a, mode, st);
  if (layout == 1 && ring == 1) return dispatch<kPlanesToPlanes, 1>(a, mode, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
