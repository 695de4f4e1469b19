// Stage ablation of the contextual-attention forward for Hopper (sm_90a),
// float32 (the CUDA-core route), with a plain C interface.
//
// Replaces, for float32 inputs (bf16 takes attention_tc_ablate.cu), the
// Pallas TPU kernels of the JAX package's timing ablation,
// experiments/attn_ablate.py: `run` (:247) and `run_padded` (:289) over
// `_kernel` (:52-243), `run_auto` (:466) over `_kernel_auto` (:326-462) and
// `run_fold` (:657) over `_kernel_fold` (:504-653). Each runs the four
// stages of the first, CUDA-core forward (the float32 forward itself now
// runs attention_tf32.cu on the tensor cores; this ablation keeps the
// CUDA-core kernels of attention_v2_kernels.cuh) with one stage dropped or
// changed, the mode fixed at compile time (StageMode there):
//   full        norm, score GEMM, fuse + softmax, paste GEMM
//   no_score    s = 0.5 everywhere in place of the norm and score GEMM
//   no_fuse     the softmax of the unfused scores
//   no_softmax  probs = the fused scores, no exp, 1/sum or gate
//   no_paste    y = 0 in place of the paste GEMM
//   paste_bf16  probs and b_full rounded to bf16 for the paste, float sums
//   fold_norm   1/column-sum applied to the probs as the paste loads them
//   floor       y = 0 and nothing else
// and `layout` picks how b_full comes in and y goes out: natural
// (B, 2hd, 2wd, C), or the 2 x 2 phase planes (B, 2, 2, hd, wd, C) that
// the TPU wrapper built with a transpose.
// healthivert_tpu_torch/experiments/attn_ablate.py holds the wrappers and
// the plain PyTorch version of every mode.
//
// What bounds it on this card: in mode full, the work (3.36 GFLOP a sample
// at L = P = 1024, C = 64); the dropped stages' times are what the
// ablation measures. The design is the first forward's, with no tuning of
// its own.
#include <algorithm>

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "attention_v2_kernels.cuh"

namespace {

using namespace hv_attn;

// out[i] = v for i < n, grid-stride.
template <typename T>
__global__ void ablate_fill_kernel(T* __restrict__ out, float v, size_t n) {
  const T val = from_f<T>(v);
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x)
    out[i] = val;
}

template <typename T>
void fill_async(T* out, float v, size_t n, cudaStream_t stream) {
  const int blocks = (int)std::min<size_t>((n + 255) / 256, 132 * 32);
  ablate_fill_kernel<T><<<blocks, 256, 0, stream>>>(out, v, n);
}

// The modes in the order of MODES in experiments/attn_ablate.py.
enum AblateMode : int {
  kAblFull = 0, kAblNoScore, kAblNoFuse, kAblNoSoftmax, kAblNoPaste,
  kAblPasteBf16, kAblFoldNorm, kAblFloor,
};

struct Operands {
  const void* fd;
  const void* bd;
  const void* b_in;  // b_full in the natural layout, its phase planes in kPhases
  const float* mm;
  void* y;
  float* s;
  float* probs;
  __nv_bfloat16* probs16;  // kPasteBf16 only
  float* col_inv;          // kFoldNorm only
  float* nrm_raw;
  int B, hd, wd, C;
  float scale;
};

// The forward's stages with softmax variant SMODE: constant scores in place
// of the norm and score GEMM when const_scores, zeros in place of the paste
// when !paste.
template <typename T, int LAYOUT, int SMODE>
void stages(const Operands& a, bool const_scores, bool paste, cudaStream_t stream) {
  constexpr int PMODE = (SMODE == kPasteBf16 || SMODE == kFoldNorm) ? SMODE : kFull;
  const int L = a.hd * a.wd;
  if (const_scores) {
    fill_async<float>(a.s, 0.5f, (size_t)a.B * L * L, stream);
  } else {
    const int n_rows = a.B * L;
    patch_norm_kernel<T><<<(n_rows + 255) / 256, 256, 0, stream>>>(
        static_cast<const T*>(a.bd), a.nrm_raw, n_rows, a.hd, a.wd, a.C);
    const dim3 score_grid((L + TN - 1) / TN, (L + TM - 1) / TM, a.B);
    score_kernel<T><<<score_grid, GEMM_THREADS, 0, stream>>>(
        static_cast<const T*>(a.fd), static_cast<const T*>(a.bd), a.nrm_raw, a.s, a.hd, a.wd,
        a.C);
  }
  const dim3 sm_grid((L + SM_COLS - 1) / SM_COLS, a.B);
  fuse_softmax_kernel<SMODE><<<sm_grid, dim3(SM_COLS, SM_ROWS), 0, stream>>>(
      a.s, a.mm, a.probs, a.hd, a.wd, a.scale, a.probs16, a.col_inv);
  if (paste) {
    const dim3 paste_grid((a.C + TN - 1) / TN, 4 * ((L + TM - 1) / TM), a.B);
    paste_kernel<T, PMODE, LAYOUT><<<paste_grid, GEMM_THREADS, 0, stream>>>(
        a.probs, static_cast<const T*>(a.b_in), static_cast<T*>(a.y), a.hd, a.wd, a.C,
        a.probs16, a.col_inv);
  } else {
    fill_async<T>(static_cast<T*>(a.y), 0.f, (size_t)a.B * 4 * L * a.C, stream);
  }
}

template <typename T, int LAYOUT>
int dispatch(const Operands& a, int mode, cudaStream_t stream) {
  switch (mode) {
    case kAblFull: stages<T, LAYOUT, kFull>(a, false, true, stream); break;
    case kAblNoScore: stages<T, LAYOUT, kFull>(a, true, true, stream); break;
    case kAblNoFuse: stages<T, LAYOUT, kNoFuse>(a, false, true, stream); break;
    case kAblNoSoftmax: stages<T, LAYOUT, kNoSoftmax>(a, false, true, stream); break;
    case kAblNoPaste: stages<T, LAYOUT, kFull>(a, false, false, stream); break;
    case kAblPasteBf16: stages<T, LAYOUT, kPasteBf16>(a, false, true, stream); break;
    case kAblFoldNorm: stages<T, LAYOUT, kFoldNorm>(a, false, true, stream); break;
    case kAblFloor:
      fill_async<T>(static_cast<T*>(a.y), 0.f, (size_t)a.B * 4 * a.hd * a.wd * a.C, stream);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}


}  // namespace

// Launches one mode of the ablation on `stream` and returns
// cudaGetLastError() (0 on success). fd, bd, b_in and y float32; mode: the
// index into MODES; layout: 0 = natural, 1 = phases. Does not synchronise and allocates nothing: y and the scratch
// come from the caller, each NULL where the mode launches no stage that
// uses it: s, probs (B, L, L) float (all but floor); nrm_raw (B, L) float
// (all but floor and no_score); probs16 (B, L, L) bf16 (paste_bf16);
// col_inv (B, L) float (fold_norm).
extern "C" int hv_attention_v2_ablate(const void* fd, const void* bd, const void* b_in,
                                      const float* mm, void* y, float* s, float* probs,
                                      void* probs16, float* col_inv, float* nrm_raw, int B,
                                      int hd, int wd, int C, float scale, int mode, int layout,
                                      void* stream) {
  const Operands a{fd, bd, b_in, mm, y, s, probs, static_cast<__nv_bfloat16*>(probs16),
                   col_inv, nrm_raw, B, hd, wd, C, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (layout == kNatural) return dispatch<float, kNatural>(a, mode, st);
  if (layout == kPhases) return dispatch<float, kPhases>(a, mode, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
