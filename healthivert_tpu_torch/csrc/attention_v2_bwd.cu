// Contextual-attention backward for Hopper (sm_90a), with a plain C interface:
// the float32 route, on the CUDA cores. bf16 inputs take the tensor-core
// route of attention_tc.cu.
//
// Replaces the Pallas TPU kernel `attention_v2_bwd` / `_attention_v2_bwd_kernel`
// (healthivert_tpu/ops/attention_pallas.py:597-819): the adjoint of the
// forward in attention_v2.cu, computed from the forward's residuals (s, probs,
// nrm_raw) and the output cotangent dy. It returns dfd, dbd and db_full in the
// input type; the gate mm gets no gradient. healthivert_tpu_torch/ops/
// attention_cuda.py holds the wrapper, the plain PyTorch version and the
// autograd Function that calls both directions.
//
// What bounds it on this card: the work. Per sample (L = P = 1024, C = 64)
// the two paste adjoints are 2 x 16 x 2 * L * P * C = 4.29 GFLOP and the two
// score adjoints 2 x 9 x 2 * L * P * C = 2.42 GFLOP, 6.71 GFLOP in all,
// against 8 MiB of float32 residuals (s, probs) and ~1.3 MB of bf16 maps:
// ~800 FLOP per byte, above the H100's ~295 FLOP/byte ridge, so the tensor
// cores' rate is the bound.
//
// What this design does about it: for now, little; it is the simple, right
// first version, shaped like the forward. The (L, P) intermediates do not fit
// in a block's 227 KB of shared memory, so they live in two float32 scratch
// matrices in device memory, and six kernels run one after another on the
// caller's stream:
//   1. dprobs_kernel        dprobs = paste adjoint in probs: tiled float GEMM,
//                           M = L, N = P, K = 16 taps x C, the 16 taps as
//                           zero-filled shifts of the 2 x 2 phase planes
//   2. dbfull_kernel        db_full = paste adjoint in b_full: tiled float
//                           GEMM per output phase, M = L, N = C, K = 4 x P
//                           (the forward's paste_kernel, probs transposed)
//   3. softmax_bwd_kernel   (attention_v2_common.cuh) per column p: t_p = sum_l P dq, then
//                           dfused = P (dq - t_p) g scale, with dq = dprobs g
//   4. fuse_adj_norm_kernel the fuse adjoint as one 9-tap gather of dfused
//                           (the forward's gather with sigma and the +-1
//                           shift in the other order), ds0 = ds / nrm, and
//                           the row sum that gives the norm's gradient
//   5. score_bwd_kernel     dfd: tiled float GEMM, M = P, N = C, K = 9 x L
//   6. score_bwd_kernel     dbd: the same with ds0 transposed, K = 9 x P, plus
//                           the norm term 2 bd (3 x 3 box sum of dn / 2 nrm)
// The GEMMs run on the CUDA cores in float (64 x 64 tiles, 4 x 4 per thread).
// The TPU kernel's channel padding 64 -> 128 and offset-pair lane packing
// exist for its 128 lanes only and are not carried over.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "attention_v2_common.cuh"

namespace {

using namespace hv_attn;

// Tap `tap` in 0..15 of the paste: output phase (r, t) and window offset
// (a, bb), with a in {0, 1} for r = 0 and {-1, 0} for r = 1 (bb from t).
__device__ __forceinline__ void paste_tap(int tap, int& r, int& t, int& a, int& bb) {
  const int phase = tap / 4, ab = tap % 4;
  r = phase / 2;
  t = phase % 2;
  a = ab / 2 - r;
  bb = ab % 2 - t;
}

// X[2(qi + a) + r, 2(qj + bb) + t, c] of a (2hd, 2wd, C) map for grid index
// q = (qi, qj): the (a, bb)-shifted phase plane (r, t), zero when the shifted
// position leaves the hd x wd grid or c >= C.
template <typename T>
__device__ __forceinline__ float phase_tap(const T* __restrict__ base, int q, int a, int bb,
                                           int r, int t, int c, int hd, int wd, int C) {
  const int i = q / wd + a, j = q % wd + bb;
  if (i < 0 || i >= hd || j < 0 || j >= wd || c >= C) return 0.f;
  return to_f(base[((size_t)(2 * i + r) * (2 * wd) + (2 * j + t)) * C + c]);
}

// (1) dprobs[l, p] = 1/4 sum over the 16 taps and channels c of
//   b_full[2(li + a) + r, 2(lj + bb) + t, c] * dy[2(pi + a) + r, 2(pj + bb) + t, c]
// (the forward reads probs[l, p] once per tap into y[2(pi + a) + r, ...]).
// Grid (ceil(P/TN), ceil(L/TM), B), GEMM_THREADS threads.
template <typename T>
__global__ void __launch_bounds__(GEMM_THREADS)
dprobs_kernel(const T* __restrict__ b_full, const T* __restrict__ dy,
              float* __restrict__ dprobs, int hd, int wd, int C) {
  __shared__ float As[TK][TM + SMEM_PAD];  // b_full taps, rows l
  __shared__ float Bs[TK][TN + SMEM_PAD];  // dy taps, columns p
  const int L = hd * wd;
  const int b = blockIdx.z;
  const int l0 = blockIdx.y * TM, p0 = blockIdx.x * TN;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const T* bfb = b_full + (size_t)b * 4 * L * C;
  const T* dyb = dy + (size_t)b * 4 * L * C;

  float acc[4][4];
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int tap = 0; tap < 16; ++tap) {
    int r, t, a, bb;
    paste_tap(tap, r, t, a, bb);
    for (int c0 = 0; c0 < C; c0 += TK) {
      // consecutive threads read consecutive channels of one pixel
      for (int e = tid; e < TK * TM; e += GEMM_THREADS) {
        const int k = e % TK, m = e / TK;
        const int l = l0 + m, p = p0 + m;
        As[k][m] = l < L ? phase_tap(bfb, l, a, bb, r, t, c0 + k, hd, wd, C) : 0.f;
        Bs[k][m] = p < L ? phase_tap(dyb, p, a, bb, r, t, c0 + k, hd, wd, C) : 0.f;
      }
      __syncthreads();
      tile_fma(As, Bs, tx, ty, acc);
      __syncthreads();
    }
  }
  for (int i = 0; i < 4; ++i) {
    const int l = l0 + ty * 4 + i;
    if (l >= L) continue;
    float* row = dprobs + ((size_t)b * L + l) * L;
    for (int j = 0; j < 4; ++j) {
      const int p = p0 + tx * 4 + j;
      if (p < L) row[p] = acc[i][j] * 0.25f;
    }
  }
}

// (2) For phase (r, t) and grid position m = (si, sj):
//   db_full[2 si + r, 2 sj + t, c] = 1/4 sum over (a, bb) and p of
//       probs[(si - a, sj - bb), p] * dy[2(pi + a) + r, 2(pj + bb) + t, c]
// with (a, bb) as in the forward, terms with a position outside the grid
// being zero. One GEMM per phase: M = L positions, N = C, K = 4 x P.
// Grid (ceil(C/TN), 4 * ceil(L/TM), B), GEMM_THREADS threads.
template <typename T>
__global__ void __launch_bounds__(GEMM_THREADS)
dbfull_kernel(const float* __restrict__ probs, const T* __restrict__ dy,
              T* __restrict__ db_full, int hd, int wd, int C) {
  __shared__ float As[TK][TM + SMEM_PAD];  // probs side, rows m
  __shared__ float Bs[TK][TN + SMEM_PAD];  // dy taps, channels
  const int L = hd * wd;
  const int b = blockIdx.z;
  const int phase = blockIdx.y % 4, m_tile = blockIdx.y / 4;
  const int r = phase / 2, t = phase % 2;
  const int m0 = m_tile * TM, c0 = blockIdx.x * TN;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int W2 = 2 * wd;
  const float* pb = probs + (size_t)b * L * L;
  const T* dyb = dy + (size_t)b * 4 * L * C;

  float acc[4][4];
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int ab = 0; ab < 4; ++ab) {
    const int a = (ab / 2) - r;
    const int bb = (ab % 2) - t;
    for (int k0 = 0; k0 < L; k0 += TK) {
      // A: probs[(si - a, sj - bb), p]; consecutive threads take consecutive p
      for (int e = tid; e < TK * TM; e += GEMM_THREADS) {
        const int k = e % TK, mn = e / TK;
        const int p = k0 + k, m = m0 + mn;
        float va = 0.f;
        if (p < L && m < L) {
          const int li = m / wd - a, lj = m % wd - bb;
          if (li >= 0 && li < hd && lj >= 0 && lj < wd) va = pb[(size_t)(li * wd + lj) * L + p];
        }
        As[k][mn] = va;
      }
      // B: dy taps; consecutive threads take consecutive channels
      for (int e = tid; e < TK * TN; e += GEMM_THREADS) {
        const int k = e / TN, n = e % TN;
        const int p = k0 + k;
        Bs[k][n] = p < L ? phase_tap(dyb, p, a, bb, r, t, c0 + n, hd, wd, C) : 0.f;
      }
      __syncthreads();
      tile_fma(As, Bs, tx, ty, acc);
      __syncthreads();
    }
  }
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= L) continue;
    const int yi = 2 * (m / wd) + r, yj = 2 * (m % wd) + t;
    T* out = db_full + (((size_t)b * 2 * hd + yi) * W2 + yj) * C;
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + tx * 4 + j;
      if (c < C) out[c] = from_f<T>(acc[i][j] * 0.25f);
    }
  }
}

constexpr int ROW_THREADS = 256;

// (4) Fuse adjoint and norm backward, one block per row a of sample b:
// ds[a, c] = fuse_adjoint_at(dfused, a, c). Writes ds0 = ds / max(nrm_raw,
// 1e-4) and the norm's gradient
//   dn2[a] = -sum_c ds * s / nrm * 0.5 / nrm_raw   where nrm_raw > 1e-4, else 0.
// Grid (L, B), ROW_THREADS threads.
__global__ void __launch_bounds__(ROW_THREADS)
fuse_adj_norm_kernel(const float* __restrict__ dfused, const float* __restrict__ s,
                     const float* __restrict__ nrm_raw, float* __restrict__ ds0,
                     float* __restrict__ dn2, int wd, int L) {
  __shared__ float warp_sums[ROW_THREADS / 32];
  const int a = blockIdx.x, b = blockIdx.y;
  const float* fb = dfused + (size_t)b * L * L;
  const float* srow = s + ((size_t)b * L + a) * L;
  float* orow = ds0 + ((size_t)b * L + a) * L;
  const float nr = nrm_raw[(size_t)b * L + a];
  const float nrm = fmaxf(nr, 1e-4f);

  float acc = 0.f;
  for (int col = threadIdx.x; col < L; col += ROW_THREADS) {
    const float f = fuse_adjoint_at(fb, a, col, wd, L);
    orow[col] = f / nrm;
    acc += f * srow[col];
  }
  for (int off = 16; off > 0; off /= 2) acc += __shfl_down_sync(0xffffffffu, acc, off);
  if (threadIdx.x % 32 == 0) warp_sums[threadIdx.x / 32] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.f;
    for (int w = 0; w < ROW_THREADS / 32; ++w) total += warp_sums[w];
    const float dn = -total / nrm;
    dn2[(size_t)b * L + a] = nr > 1e-4f ? dn * 0.5f / fmaxf(nr, 1e-12f) : 0.f;
  }
}

// (5, 6) Score backward, with o = (oy, ox) the 9 window offsets:
//   FOR_BD = false:  dfd[y, c] = sum_o sum_l ds0[l, y - o] * bd[l + o, c]
//   FOR_BD = true:   dbd[y, c] = sum_o sum_p ds0[y - o, p] * fd[p + o, c]
//                              + 2 bd[y, c] * (3 x 3 box sum of dn2 around y)
// (the forward's score_kernel read bd[l + o] and fd[p + o]), terms with a
// position outside the grid being zero. M = L positions, N = C, K = 9 x L.
// Grid (ceil(C/TN), ceil(L/TM), B), GEMM_THREADS threads.
template <typename T, bool FOR_BD>
__global__ void __launch_bounds__(GEMM_THREADS)
score_bwd_kernel(const float* __restrict__ ds0, const T* __restrict__ fd,
                 const T* __restrict__ bd, const float* __restrict__ dn2,
                 T* __restrict__ out, int hd, int wd, int C) {
  __shared__ float As[TK][TM + SMEM_PAD];  // ds0 side, rows m
  __shared__ float Bs[TK][TN + SMEM_PAD];  // shifted feature map, channels
  const int L = hd * wd;
  const int b = blockIdx.z;
  const int m0 = blockIdx.y * TM, c0 = blockIdx.x * TN;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const float* db = ds0 + (size_t)b * L * L;
  const T* src = (FOR_BD ? fd : bd) + (size_t)b * L * C;

  float acc[4][4];
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int o = 0; o < 9; ++o) {
    const int oy = o / 3 - 1, ox = o % 3 - 1;
    for (int k0 = 0; k0 < L; k0 += TK) {
      // A: ds0 at (row, column) = (k, y - o) or (y - o, k); consecutive
      // threads take consecutive addresses of ds0 in both cases
      for (int e = tid; e < TK * TM; e += GEMM_THREADS) {
        const int k = FOR_BD ? e % TK : e / TM;
        const int mn = FOR_BD ? e / TK : e % TM;
        const int kk = k0 + k, m = m0 + mn;
        float va = 0.f;
        if (kk < L && m < L) {
          const int qi = m / wd - oy, qj = m % wd - ox;
          if (qi >= 0 && qi < hd && qj >= 0 && qj < wd) {
            const int q = qi * wd + qj;
            va = FOR_BD ? db[(size_t)q * L + kk] : db[(size_t)kk * L + q];
          }
        }
        As[k][mn] = va;
      }
      // B: the other feature map at k + o; consecutive threads on channels
      for (int e = tid; e < TK * TN; e += GEMM_THREADS) {
        const int k = e / TN, n = e % TN;
        const int kk = k0 + k;
        Bs[k][n] = kk < L ? shifted(src, kk, oy, ox, c0 + n, hd, wd, C) : 0.f;
      }
      __syncthreads();
      tile_fma(As, Bs, tx, ty, acc);
      __syncthreads();
    }
  }
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= L) continue;
    float box = 0.f;
    if (FOR_BD) {
      const int mi = m / wd, mj = m % wd;
      for (int dy = -1; dy <= 1; ++dy)
        for (int dx = -1; dx <= 1; ++dx) {
          const int y = mi + dy, x = mj + dx;
          if (y >= 0 && y < hd && x >= 0 && x < wd) box += dn2[(size_t)b * L + y * wd + x];
        }
    }
    const size_t row = ((size_t)b * L + m) * C;
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + tx * 4 + j;
      if (c >= C) continue;
      float v = acc[i][j];
      if (FOR_BD) v += 2.f * to_f(bd[row + c]) * box;
      out[row + c] = from_f<T>(v);
    }
  }
}

template <typename T>
void launch_all(const void* fd, const void* bd, const void* b_full, const void* dy,
                const float* probs, const float* s, const float* nrm_raw, const float* mm,
                void* dfd, void* dbd, void* db_full, float* grad_a, float* grad_b,
                float* dn2, int B, int hd, int wd, int C, float scale, cudaStream_t stream) {
  const int L = hd * wd;
  const T* fdt = static_cast<const T*>(fd);
  const T* bdt = static_cast<const T*>(bd);
  const T* dyt = static_cast<const T*>(dy);
  const dim3 lp_grid((L + TN - 1) / TN, (L + TM - 1) / TM, B);
  dprobs_kernel<T><<<lp_grid, GEMM_THREADS, 0, stream>>>(
      static_cast<const T*>(b_full), dyt, grad_a, hd, wd, C);
  const dim3 paste_grid((C + TN - 1) / TN, 4 * ((L + TM - 1) / TM), B);
  dbfull_kernel<T><<<paste_grid, GEMM_THREADS, 0, stream>>>(
      probs, dyt, static_cast<T*>(db_full), hd, wd, C);
  const dim3 sm_grid((L + SM_COLS - 1) / SM_COLS, B);
  softmax_bwd_kernel<><<<sm_grid, dim3(SM_COLS, SM_ROWS), 0, stream>>>(
      probs, mm, grad_a, L, scale);
  fuse_adj_norm_kernel<<<dim3(L, B), ROW_THREADS, 0, stream>>>(
      grad_a, s, nrm_raw, grad_b, dn2, wd, L);
  const dim3 feat_grid((C + TN - 1) / TN, (L + TM - 1) / TM, B);
  score_bwd_kernel<T, false><<<feat_grid, GEMM_THREADS, 0, stream>>>(
      grad_b, fdt, bdt, dn2, static_cast<T*>(dfd), hd, wd, C);
  score_bwd_kernel<T, true><<<feat_grid, GEMM_THREADS, 0, stream>>>(
      grad_b, fdt, bdt, dn2, static_cast<T*>(dbd), hd, wd, C);
}

}  // namespace

// Launches the backward on `stream` and returns cudaGetLastError() (0 on
// success). float32 fd, bd, b_full, dy and outputs: bfloat16 takes the
// tensor-core route (attention_tc.cu). grad_a, grad_b: (B, L, L) float scratch; dn2: (B, L) float
// scratch. Does not synchronise and allocates nothing.
extern "C" int hv_attention_v2_backward(const void* fd, const void* bd, const void* b_full,
                                        const void* dy, const float* probs, const float* s,
                                        const float* nrm_raw, const float* mm, void* dfd,
                                        void* dbd, void* db_full, float* grad_a, float* grad_b,
                                        float* dn2, int B, int hd, int wd, int C, float scale,
                                        void* stream) {
  launch_all<float>(fd, bd, b_full, dy, probs, s, nrm_raw, mm, dfd, dbd, db_full, grad_a, grad_b,
                    dn2, B, hd, wd, C, scale, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}
