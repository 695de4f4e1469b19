// Device code of the contextual-attention forward that the tensor-core
// routes (attention_tc_kernels.cuh) share: the stage modes of the sweep,
// the patch norm and the fused-score gather.
//
// Layouts: bd (B, hd, wd, C), NHWC, T = float or __nv_bfloat16; s (B, L,
// P) float, row l = background patch, column p = foreground query; nrm_raw
// (B, L) float. L = P = hd * wd. Every sum is taken in float.
#pragma once

#include "attention_v2_common.cuh"

namespace hv_attn {

// Variants of the softmax and paste stages, chosen at compile time. kFull
// is the forward's own; the others serve the stage ablation (the sweep in
// attention_tc_kernels.cuh, the pastes there and in
// attention_tf32_kernels.cuh) and put no branch into the forward's kernels.
enum StageMode : int {
  kFull = 0,   // fused scores, gated softmax, probs = e / sum * g
  kNoFuse,     // the softmax of the unfused scores
  kNoSoftmax,  // probs = the fused scores as they stand: no exp, 1/sum or gate
  kPasteBf16,  // probs also written in bf16; the paste reads those and
               // rounds b_full to bf16, summing in float
  kFoldNorm,   // probs = e * g and col_inv = 1 / sum per column p; the paste
               // scales each probs value by its column's col_inv as it loads it
};

// nrm_raw[b, l] = sqrt(sum over the 3x3 window around l, zero outside the
// hd x wd grid, of ||bd[b, pixel]||^2).
template <typename T>
__global__ void patch_norm_kernel(const T* __restrict__ bd, float* __restrict__ nrm_raw,
                                  int n_rows, int hd, int wd, int C) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n_rows) return;
  const int L = hd * wd;
  const int b = idx / L, l = idx % L;
  const int li = l / wd, lj = l % wd;
  float acc = 0.f;
  for (int dy = -1; dy <= 1; ++dy) {
    for (int dx = -1; dx <= 1; ++dx) {
      const int y = li + dy, x = lj + dx;
      if (y < 0 || y >= hd || x < 0 || x >= wd) continue;
      const T* v = bd + ((size_t)(b * hd + y) * wd + x) * C;
      float sq = 0.f;
      for (int c = 0; c < C; ++c) {
        const float f = to_f(v[c]);
        sq += f * f;
      }
      acc += sq;
    }
  }
  nrm_raw[idx] = sqrtf(acc);
}

// fused[l, p] = sum over sigma in {id, sigma+, sigma-} and d in {-1, 0, 1} of
// s[sigma(l) + d, sigma(p) + d], terms with an invalid index being zero: the
// diagonal fuse followed by the permuted fuse, as one 9-tap gather.
__device__ __forceinline__ float fused_score(const float* __restrict__ sb, int l, int p,
                                             int wd, int L) {
  float f = 0.f;
  for (int q = 0; q < 3; ++q) {
    const int sl = q == 0 ? l : (q == 1 ? sigma_plus(l, wd, L) : sigma_minus(l, wd, L));
    const int sp = q == 0 ? p : (q == 1 ? sigma_plus(p, wd, L) : sigma_minus(p, wd, L));
    if (sl < 0 || sp < 0) continue;
    for (int d = -1; d <= 1; ++d) {
      const int a = sl + d, c = sp + d;
      if (a < 0 || a >= L || c < 0 || c >= L) continue;
      f += sb[(size_t)a * L + c];
    }
  }
  return f;
}

}  // namespace hv_attn
