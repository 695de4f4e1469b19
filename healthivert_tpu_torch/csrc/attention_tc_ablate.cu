// Stage ablation of the contextual-attention forward on the bf16
// tensor-core route, for Hopper (sm_90a), with a plain C interface.
//
// Replaces, for bf16 inputs, the Pallas TPU kernels of the JAX package's
// timing ablation, experiments/attn_ablate.py: `run` (:247) and
// `run_padded` (:289) over `_kernel` (:52-243), `run_auto` (:466) over
// `_kernel_auto` (:326-462) and `run_fold` (:657) over `_kernel_fold`
// (:504-653). float32 inputs take the 3xTF32 ablation
// (attention_tf32_ablate.cu). healthivert_tpu_torch/experiments/attn_ablate.py
// holds the wrappers and the plain PyTorch version of every mode.
//
// Each mode runs the bf16 forward of attention_tc.cu (its kernels, from
// attention_tc_kernels.cuh) with one stage dropped or changed, the mode
// fixed at compile time:
//   full        patch_norm_kernel, lp_gemm<kScore>, fuse_softmax_tc_kernel,
//               the paste GEMM: the forward's four stages
//   no_score    s = 0.5 everywhere in place of the norm and score GEMM
//   no_fuse     the sweep reads s[l, p] in place of the 9-tap gather
//   no_softmax  the sweep writes the fused scores, split hi/lo: no max and
//               sum sweep, no exp, 1/sum or gate
//   no_paste    y = 0 in place of the paste GEMM
//   paste_bf16  the sweep writes the hi plane alone and the paste takes one
//               product a step: what the hi/lo split of probs costs
//   fold_norm   the sweep writes e * g unnormalised and 1/sum per column;
//               the paste builds its A operand in registers (wgmma's
//               register-A form): hi + lo of each row times that column's
//               1/sum, split again. (Rescaling the tiles in shared memory
//               instead, behind a proxy fence and a barrier, took the same
//               time on an H100: PERF.md.)
//   floor       y = 0 and nothing else
// and `layout` picks how b_full comes in and y goes out: natural (B, 2hd,
// 2wd, C), read through a tensor map with element stride 2 (`natural_map`),
// or the 2 x 2 phase planes (B, 2, 2, hd, wd, C). `ring` is the depth of
// every GEMM's TMA ring: 4, the forward's, or 1 (mainloop_sync, synchronous
// loads; phase layout only): `run_auto`'s question on this card.
//
// What bounds it: as the forward in mode full, the work (3.36 GFLOP a
// sample at L = P = 1024, C = 64; 0.217 ms at B = 64 at the bf16 peak);
// the dropped stages' times are what the ablation measures. The design is
// the forward's; no mode changes full's launches, and full's products are
// the forward's in the same order, so its y equals attention_v2's bit for
// bit in either layout and at either ring depth.
//
// The natural-layout map (`natural_map<bf16>`, attention_ablate.cuh) reads
// boxes of 64 channels by 64 positions.
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "attention_ablate.cuh"
#include "attention_tc_kernels.cuh"

namespace {

// The score GEMM at ring depth 1.
template <int KIND>
__global__ void __launch_bounds__(THREADS)
lp_gemm_sync(const __grid_constant__ CUtensorMap ma, const __grid_constant__ CUtensorMap mb,
             Geom g, const float* __restrict__ nrm_raw, float* __restrict__ out) {
  lp_tile<KIND, 1>(ma, mb, g, nrm_raw, out);
}

// The ablation's paste: variant VAR, layout IO, ring depth NSTAGES. Grid
// (Cp / 64, ceil(hd wdp / 64) x 4, B).
template <int VAR, int IO, int NSTAGES>
__global__ void __launch_bounds__(THREADS)
paste_gemm(const __grid_constant__ CUtensorMap ma_hi, const __grid_constant__ CUtensorMap ma_lo,
           const __grid_constant__ CUtensorMap mb, Geom g, const float* __restrict__ col_inv,
           bf16* __restrict__ out) {
  pc_tile<kPaste, VAR, IO, NSTAGES>(ma_hi, ma_lo, mb, g, nullptr, nullptr, col_inv, out);
}

template <int NSTAGES>
int launch_score(const CUtensorMap& ma, const CUtensorMap& mb, const Geom& g, int B,
                 const float* nrm_raw, float* s, cudaStream_t st) {
  if constexpr (NSTAGES == STAGES) {
    return launch_lp<kScore>(ma, mb, g, B, nrm_raw, s, st);
  } else {
    HV_TRY(smem_attribute(lp_gemm_sync<kScore>));
    lp_gemm_sync<kScore><<<lp_grid(g, B), THREADS, SMEM_BYTES, st>>>(ma, mb, g, nrm_raw, s);
    return static_cast<int>(cudaGetLastError());
  }
}

template <int VAR, int IO, int NSTAGES>
int launch_paste(const CUtensorMap& ma_hi, const CUtensorMap& ma_lo, const CUtensorMap& mb,
                 const Geom& g, int B, const float* col_inv, void* y, cudaStream_t st) {
  HV_TRY(smem_attribute(paste_gemm<VAR, IO, NSTAGES>));
  paste_gemm<VAR, IO, NSTAGES><<<pc_grid(g, B, 4), THREADS, SMEM_BYTES, st>>>(
      ma_hi, ma_lo, mb, g, col_inv, static_cast<bf16*>(y));
  return static_cast<int>(cudaGetLastError());
}

struct Args {
  const void* fd;
  const void* bd;
  const void* b_op;  // b_full natural (B, 2hd, 2wd, Cp) or its planes (B, 4, hd, wd, Cp)
  const float* mm;
  void* y;
  float* s;
  float* nrm_raw;
  bf16* pt_hi;
  bf16* pt_lo;
  float* col_inv;
  int B;
  Geom g;
  float scale;
};

// The forward's stages with sweep variant SMODE and paste variant PVAR:
// constant scores in place of the norm and score GEMM when !score, zeros in
// place of the paste when !paste. Every tensor map is built before the
// first launch, so a map cuTensorMapEncodeTiled refuses launches nothing.
template <int SMODE, int PVAR, int IO, int NSTAGES>
int stages(const Args& a, bool score, bool paste, cudaStream_t st) {
  const Geom& g = a.g;
  const int L = g.L();
  CUtensorMap m_bd, m_fd, m_hi, m_lo, m_b;
  if (score) {
    HV_TRY(feature_map(&m_bd, a.bd, g, 1, a.B, BM));
    HV_TRY(feature_map(&m_fd, a.fd, g, 1, a.B, 128));
  }
  if (paste) {
    HV_TRY(plane_map(&m_hi, a.pt_hi, g, a.B));
    // paste_bf16 reads no lo plane: its map is never loaded
    HV_TRY(plane_map(&m_lo, PVAR == kPasteBf16 ? a.pt_hi : a.pt_lo, g, a.B));
    HV_TRY(IO == kNaturalToNatural ? natural_map<bf16>(&m_b, a.b_op, g, a.B)
                                   : feature_map(&m_b, a.b_op, g, 4, a.B, BM));
  }
  if (score) {
    const int n_rows = a.B * L;
    hv_attn::patch_norm_kernel<bf16><<<(n_rows + 255) / 256, 256, 0, st>>>(
        static_cast<const bf16*>(a.bd), a.nrm_raw, n_rows, g.hd, g.wd, g.Cp);
    HV_TRY(static_cast<int>(cudaGetLastError()));
    HV_TRY(launch_score<NSTAGES>(m_bd, m_fd, g, a.B, a.nrm_raw, a.s, st));
  } else {
    HV_TRY(fill_async<float>(a.s, 0.5f, (size_t)a.B * L * L, st));
  }
  fuse_softmax_tc_kernel<SMODE><<<dim3((L + SM_COLS - 1) / SM_COLS, a.B),
                                  dim3(SM_COLS, SOFTMAX_ROWS), 0, st>>>(
      a.s, a.mm, nullptr, a.pt_hi, a.pt_lo, g, a.scale, a.col_inv);
  HV_TRY(static_cast<int>(cudaGetLastError()));
  if (paste) return launch_paste<PVAR, IO, NSTAGES>(m_hi, m_lo, m_b, g, a.B, a.col_inv, a.y, st);
  return fill_async<bf16>(a.y, 0.f, (size_t)a.B * 4 * L * g.C, st);
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
    case kAblFloor: return fill_async<bf16>(a.y, 0.f, (size_t)a.B * 4 * a.g.L() * a.g.C, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Launches one mode of the ablation on the tensor-core route on `stream`.
// fd_p, bd_p (B, hd, wd, Cp) bf16 and b_op (b_full (B, 2hd, 2wd, Cp) for
// layout 0 = natural, its planes (B, 4, hd, wd, Cp) for layout 1 = phases),
// channels zero-padded to Cp; mm (B, L) float; y (B, 2hd, 2wd, C) or
// (B, 2, 2, hd, wd, C) bf16. Scratch from the caller, each NULL where the
// mode launches no stage that uses it: s (B, L, P) float (all but floor);
// nrm_raw (B, L) float (all but floor and no_score); pt_hi (B, P, kp) bf16
// (all but floor), pt_lo the same (all but floor and paste_bf16); col_inv
// (B, L) float (fold_norm). mode: the index into MODES; ring: 4, or 1 with
// layout 1. Does not synchronise and allocates nothing. Returns 0, a CUDA
// error, or 1000 + a CUresult when a tensor map cannot be built.
extern "C" int hv_attention_tc_ablate(const void* fd_p, const void* bd_p, const void* b_op,
                                      const float* mm, void* y, float* s, float* nrm_raw,
                                      void* pt_hi, void* pt_lo, float* col_inv, int B, int hd,
                                      int wd, int C, int Cp, int wdp, int kp, float scale,
                                      int mode, int layout, int ring, void* stream) {
  const Args a{fd_p, bd_p, b_op, mm, y, s, nrm_raw, static_cast<bf16*>(pt_hi),
               static_cast<bf16*>(pt_lo), col_inv, B, Geom{hd, wd, wdp, kp, C, Cp}, scale};
  if (!valid(a.g, B)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (layout == 0 && ring == STAGES) return dispatch<kNaturalToNatural, STAGES>(a, mode, st);
  if (layout == 1 && ring == STAGES) return dispatch<kPlanesToPlanes, STAGES>(a, mode, st);
  if (layout == 1 && ring == 1) return dispatch<kPlanesToPlanes, 1>(a, mode, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
