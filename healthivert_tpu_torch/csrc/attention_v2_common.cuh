// Helpers shared by the contextual-attention kernels of the tensor-core
// routes (attention_tc.cu, attention_tf32.cu and their v1 and ablation):
// type conversion, the column-sweep block shape, the sigma+/sigma- steps
// of the second fuse pass, the fuse adjoint and the softmax backward.
// Inline functions, templates and constants only, so that every
// translation unit of the library can include it.
//
// Layouts: feature maps (B, hd, wd, C) and full-resolution maps
// (B, 2hd, 2wd, C), NHWC, T = float or __nv_bfloat16; (L, P) matrices float,
// row l = background patch, column p = foreground query; L = P = hd * wd.
#pragma once

#include <cuda_bf16.h>

namespace hv_attn {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Column-sweep blocks over an (L, P) matrix: 32 query columns per block, one
// per lane, and 8 row groups, one per warp.
constexpr int SM_COLS = 32;
constexpr int SM_ROWS = 8;

// The +-1 steps of the transposed flatten of the (L/n, n) grid; -1 marks the
// invalid end (zero in the reference's permuted shifts).
__device__ __forceinline__ int sigma_plus(int i, int n, int m) {
  if (i < m - n) return i + n;
  if (i < m - 1) return i + n - m + 1;
  return -1;
}
__device__ __forceinline__ int sigma_minus(int i, int n, int m) {
  if (i == 0) return -1;
  if (i < n) return i + m - n - 1;
  return i - n;
}

// ds[a, c] = sum over d in {-1, 0, 1} and sigma in {id, sigma+, sigma-} of
// dfused[sigma(a + d), sigma(c + d)], terms with an index outside [0, L) or
// an invalid sigma being zero: the fuse adjoint, the transpose of the
// forward's fused_score (which reads s[sigma(l) + d, ...]).
__device__ __forceinline__ float fuse_adjoint_at(const float* __restrict__ fb, int a, int col,
                                                 int wd, int L) {
  float f = 0.f;
  for (int d = -1; d <= 1; ++d) {
    const int i = a + d, j = col + d;
    if (i < 0 || i >= L || j < 0 || j >= L) continue;
    f += fb[(size_t)i * L + j];
    const int ip = sigma_plus(i, wd, L), jp = sigma_plus(j, wd, L);
    if (ip >= 0 && jp >= 0) f += fb[(size_t)ip * L + jp];
    const int im = sigma_minus(i, wd, L), jm = sigma_minus(j, wd, L);
    if (im >= 0 && jm >= 0) f += fb[(size_t)im * L + jm];
  }
  return f;
}

// Softmax and gate backward, per column p, in place over dprobs:
//   dq = dprobs * g[l],  t_p = sum_l probs * dq,
//   dfused = probs * (dq - t_p) * g[l] * scale.
// The saved probs are already gated, so they stand in for the softmax of
// the gated logits (rows with g = 0 have dq = 0 and are gated again).
// Grid (ceil(P/32), B), block (32, 8).
template <typename = void>
__global__ void __launch_bounds__(SM_COLS * SM_ROWS)
softmax_bwd_kernel(const float* __restrict__ probs, const float* __restrict__ mm,
                   float* __restrict__ grad, int L, float scale) {
  __shared__ float part[SM_ROWS][SM_COLS];
  const int b = blockIdx.y;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int p = blockIdx.x * SM_COLS + tx;
  const float* pb = probs + (size_t)b * L * L;
  const float* g = mm + (size_t)b * L;
  float* gb = grad + (size_t)b * L * L;

  float acc = 0.f;
  if (p < L) {
    for (int l = ty; l < L; l += SM_ROWS) {
      const size_t at = (size_t)l * L + p;
      acc += pb[at] * gb[at] * g[l];
    }
  }
  part[ty][tx] = acc;
  __syncthreads();
  float tcol = 0.f;
  for (int rr = 0; rr < SM_ROWS; ++rr) tcol += part[rr][tx];
  if (p < L) {
    for (int l = ty; l < L; l += SM_ROWS) {
      const size_t at = (size_t)l * L + p;
      const float gl = g[l];
      gb[at] = pb[at] * (gb[at] * gl - tcol) * gl * scale;
    }
  }
}

}  // namespace hv_attn
