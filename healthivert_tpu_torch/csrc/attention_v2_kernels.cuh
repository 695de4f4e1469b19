// Device code of the contextual-attention forward on the CUDA cores: the
// float32 stage ablation (attention_v2_ablate.cu), float32 v1
// (attention_v1.cu), and the patch norm and fused-score gather that the
// tensor-core routes (attention_tc_kernels.cuh) share.
//
// Layouts: fd, bd (B, hd, wd, C) and b_full (B, 2hd, 2wd, C), NHWC, T = float
// or __nv_bfloat16; mm (B, L) float; s, probs (B, L, P) float, row l =
// background patch, column p = foreground query; nrm_raw (B, L) float;
// y (B, 2hd, 2wd, C) T. L = P = hd * wd. Every sum is taken in float.
#pragma once

#include "attention_v2_common.cuh"

namespace hv_attn {

// Variants of the softmax (3) and paste (4) stages, chosen at compile time.
// kFull is the forward's own; the others serve the stage ablation
// (attention_v2_ablate.cu, and the tensor-core route's sweep in
// attention_tc_kernels.cuh) and put no branch into the forward's kernels.
enum StageMode : int {
  kFull = 0,   // fused scores, gated softmax, probs = e / sum * g
  kNoFuse,     // the softmax of the unfused scores
  kNoSoftmax,  // probs = the fused scores as they stand: no exp, 1/sum or gate
  kPasteBf16,  // probs also written in bf16; the paste reads those and
               // rounds b_full to bf16, summing in float
  kFoldNorm,   // probs = e * g and col_inv = 1 / sum per column p; the paste
               // scales each probs value by its column's col_inv as it loads it
};

// Layout of the paste's b_full operand and its output: kNatural is
// (B, 2hd, 2wd, C); kPhases is (B, 2, 2, hd, wd, C), [b, r, t, i, j] holding
// pixel (2i + r, 2j + t).
enum PasteLayout : int { kNatural = 0, kPhases = 1 };

// (1) nrm_raw[b, l] = sqrt(sum over the 3x3 window around l, zero outside the
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

// (2) s[b, l, p] = sum over the 9 window offsets o and channels c of
// bd[l + o, c] * fd[p + o, c], divided by max(nrm_raw[l], 1e-4).
// Grid (ceil(P/TN), ceil(L/TM), B), GEMM_THREADS threads.
template <typename T>
__global__ void __launch_bounds__(GEMM_THREADS)
score_kernel(const T* __restrict__ fd, const T* __restrict__ bd,
             const float* __restrict__ nrm_raw, float* __restrict__ s,
             int hd, int wd, int C) {
  __shared__ float As[TK][TM + SMEM_PAD];  // bd side, rows l
  __shared__ float Bs[TK][TN + SMEM_PAD];  // fd side, columns p
  const int L = hd * wd;
  const int b = blockIdx.z;
  const int l0 = blockIdx.y * TM, p0 = blockIdx.x * TN;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const T* bdb = bd + (size_t)b * L * C;
  const T* fdb = fd + (size_t)b * L * C;

  float acc[4][4];
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int o = 0; o < 9; ++o) {
    const int dy = o / 3 - 1, dx = o % 3 - 1;
    for (int c0 = 0; c0 < C; c0 += TK) {
      // consecutive threads read consecutive channels of one pixel
      for (int e = tid; e < TK * TM; e += GEMM_THREADS) {
        const int k = e % TK, m = e / TK;
        const int l = l0 + m, p = p0 + m;
        As[k][m] = l < L ? shifted(bdb, l, dy, dx, c0 + k, hd, wd, C) : 0.f;
        Bs[k][m] = p < L ? shifted(fdb, p, dy, dx, c0 + k, hd, wd, C) : 0.f;
      }
      __syncthreads();
      tile_fma(As, Bs, tx, ty, acc);
      __syncthreads();
    }
  }
  for (int i = 0; i < 4; ++i) {
    const int l = l0 + ty * 4 + i;
    if (l >= L) continue;
    const float nrm = fmaxf(nrm_raw[(size_t)b * L + l], 1e-4f);
    float* row = s + ((size_t)b * L + l) * L;
    for (int j = 0; j < 4; ++j) {
      const int p = p0 + tx * 4 + j;
      if (p < L) row[p] = acc[i][j] / nrm;
    }
  }
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

// (3) Column softmax over l of fused * g * scale, times g again:
// probs[l, p] = exp(fused * g[l] * scale - max) / sum * g[l]. A gated row
// (g = 0) still adds exp(0 - max) to the sum. Grid (ceil(P/32), B),
// block (32, 8); each thread runs an online max/sum over its rows, the
// block merges the 8 partials, and a second sweep writes probs. MODE picks
// a variant (see StageMode); probs16 and col_inv are written only by
// kPasteBf16 and kFoldNorm.
template <int MODE = kFull>
__global__ void __launch_bounds__(SM_COLS * SM_ROWS)
fuse_softmax_kernel(const float* __restrict__ s, const float* __restrict__ mm,
                    float* __restrict__ probs, int hd, int wd, float scale,
                    __nv_bfloat16* __restrict__ probs16 = nullptr,
                    float* __restrict__ col_inv = nullptr) {
  __shared__ float part_max[SM_ROWS][SM_COLS];
  __shared__ float part_sum[SM_ROWS][SM_COLS];
  const int L = hd * wd;
  const int b = blockIdx.y;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int p = blockIdx.x * SM_COLS + tx;
  const float* sb = s + (size_t)b * L * L;
  const float* g = mm + (size_t)b * L;
  float* pb = probs + (size_t)b * L * L;

  float run_max = -INFINITY, run_sum = 0.f;
  if (p < L) {
    for (int l = ty; l < L; l += SM_ROWS) {
      const float f = MODE == kNoFuse ? sb[(size_t)l * L + p] : fused_score(sb, l, p, wd, L);
      pb[(size_t)l * L + p] = f;  // kept for the second sweep
      if constexpr (MODE == kNoSoftmax) continue;
      const float logit = f * g[l] * scale;
      if (logit > run_max) {
        run_sum = run_sum * expf(run_max - logit) + 1.f;
        run_max = logit;
      } else {
        run_sum += expf(logit - run_max);
      }
    }
  }
  if constexpr (MODE == kNoSoftmax) return;
  part_max[ty][tx] = run_max;
  part_sum[ty][tx] = run_sum;
  __syncthreads();
  float col_max = -INFINITY;
  for (int r = 0; r < SM_ROWS; ++r) col_max = fmaxf(col_max, part_max[r][tx]);
  float col_sum = 0.f;
  for (int r = 0; r < SM_ROWS; ++r) {
    const float pm = part_max[r][tx];
    if (pm > -INFINITY) col_sum += part_sum[r][tx] * expf(pm - col_max);
  }
  if (p < L) {
    const float inv = 1.f / col_sum;
    if constexpr (MODE == kFoldNorm) {
      if (ty == 0) col_inv[(size_t)b * L + p] = inv;
    }
    for (int l = ty; l < L; l += SM_ROWS) {
      float* cell = pb + (size_t)l * L + p;
      const float gl = g[l];
      if constexpr (MODE == kFoldNorm) {
        *cell = expf(*cell * gl * scale - col_max) * gl;
      } else if constexpr (MODE == kPasteBf16) {
        probs16[((size_t)b * L + l) * L + p] =
            __float2bfloat16(expf(*cell * gl * scale - col_max) * inv * gl);
      } else {
        *cell = expf(*cell * gl * scale - col_max) * inv * gl;
      }
    }
  }
}

// (4) Paste into the 2 x 2 output phases. For phase (r, t) and query grid
// position m = (i, j):
//   y[2i + r, 2j + t, c] = 1/4 sum over (a, bb) and l of
//       probs[l, (i - a, j - bb)] * b_full[2(li + a) + r, 2(lj + bb) + t, c]
// with a in {0, 1} for r = 0 and {-1, 0} for r = 1 (bb likewise from t),
// terms with a position outside the grid being zero. One GEMM per phase:
// M = P positions, N = C channels, K = 4 offsets x L rows.
// Grid (ceil(C/TN), 4 * ceil(P/TM), B), GEMM_THREADS threads. MODE
// kPasteBf16 and kFoldNorm change the probs load (see StageMode); LAYOUT
// addresses b_full and y (see PasteLayout).
template <typename T, int MODE = kFull, int LAYOUT = kNatural>
__global__ void __launch_bounds__(GEMM_THREADS)
paste_kernel(const float* __restrict__ probs, const T* __restrict__ b_full,
             T* __restrict__ y, int hd, int wd, int C,
             const __nv_bfloat16* __restrict__ probs16 = nullptr,
             const float* __restrict__ col_inv = nullptr) {
  __shared__ float As[TK][TM + SMEM_PAD];  // probs side, rows m
  __shared__ float Bs[TK][TN + SMEM_PAD];  // b_full side, channels
  const int L = hd * wd;
  const int b = blockIdx.z;
  const int phase = blockIdx.y % 4, m_tile = blockIdx.y / 4;
  const int r = phase / 2, t = phase % 2;
  const int m0 = m_tile * TM, c0 = blockIdx.x * TN;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int W2 = 2 * wd;
  const float* pb = probs + (size_t)b * L * L;
  const T* bfb = b_full + (size_t)b * 4 * L * C;

  float acc[4][4];
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int ab = 0; ab < 4; ++ab) {
    const int a = (ab / 2) - r;   // r = 0: {0, 1}; r = 1: {-1, 0}
    const int bb = (ab % 2) - t;
    for (int k0 = 0; k0 < L; k0 += TK) {
      // consecutive threads take consecutive query positions / channels
      for (int e = tid; e < TK * TM; e += GEMM_THREADS) {
        const int k = e / TM, mn = e % TM;
        const int l = k0 + k;
        // A: probs[l, (i - a, j - bb)]
        const int m = m0 + mn;
        float va = 0.f;
        if (l < L && m < L) {
          const int pi = m / wd - a, pj = m % wd - bb;
          if (pi >= 0 && pi < hd && pj >= 0 && pj < wd) {
            const int q = pi * wd + pj;
            if constexpr (MODE == kPasteBf16) {
              va = __bfloat162float(probs16[((size_t)b * L + l) * L + q]);
            } else {
              va = pb[(size_t)l * L + q];
            }
            if constexpr (MODE == kFoldNorm) va *= col_inv[(size_t)b * L + q];
          }
        }
        As[k][mn] = va;
        // B: b_full[2(li + a) + r, 2(lj + bb) + t, c]
        const int c = c0 + mn;
        float vb = 0.f;
        if (l < L && c < C) {
          const int si = l / wd + a, sj = l % wd + bb;
          if (si >= 0 && si < hd && sj >= 0 && sj < wd) {
            if constexpr (LAYOUT == kNatural) {
              vb = to_f(bfb[((size_t)(2 * si + r) * W2 + (2 * sj + t)) * C + c]);
            } else {
              vb = to_f(bfb[((size_t)phase * L + si * wd + sj) * C + c]);
            }
            if constexpr (MODE == kPasteBf16) vb = __bfloat162float(__float2bfloat16(vb));
          }
        }
        Bs[k][mn] = vb;
      }
      __syncthreads();
      tile_fma(As, Bs, tx, ty, acc);
      __syncthreads();
    }
  }
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= L) continue;
    T* out;
    if constexpr (LAYOUT == kNatural) {
      const int yi = 2 * (m / wd) + r, yj = 2 * (m % wd) + t;
      out = y + (((size_t)b * 2 * hd + yi) * W2 + yj) * C;
    } else {
      out = y + (((size_t)b * 4 + phase) * L + m) * C;
    }
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + tx * 4 + j;
      if (c < C) out[c] = from_f<T>(acc[i][j] / 4.f);
    }
  }
}

}  // namespace hv_attn
