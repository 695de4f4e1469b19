// Contextual attention on patch tensors (v1) for Hopper (sm_90a), with a
// plain C interface.
//
// Replaces the Pallas TPU kernel `attention_scores_paste` / `_attention_kernel`
// (healthivert_tpu/ops/attention_pallas.py:98-249): from foreground patches
// fpat (B, P, K), background patches wnorm (B, L, K) that arrive already
// divided by their norm, raw patches raw (B, L, RC) and the gate mm (B, L),
// it computes the scores s = wnorm fpat^T, the diagonal and the permuted
// fuse passes, the gated column softmax, and the patch values
// vals = probs^T raw (B, P, RC), before any fold. L = P = hd * wd; K and RC
// are free. healthivert_tpu_torch/ops/attention_cuda.py holds the wrapper
// and the plain PyTorch version.
//
// What bounds it on this card: the work. At the shapes of the generator
// (L = P = 1024, K = 9C = 576, RC = 16C = 1024) a sample is
// 2 * L * P * (K + RC) = 3.36 GFLOP against ~6.6 MB of bf16 inputs and
// output: far above the H100's ~295 FLOP/byte ridge, so the tensor cores'
// rate is the bound, as for the v2 forward.
//
// What this design does about it: for now, little; it is the simple, right
// first version, built from the v2 forward's pieces. No norm is taken (the
// background patches arrive normalised), and three kernels run one after
// another on the caller's stream, with the (L, P) scores and probabilities
// in device memory:
//   1. v1_score_kernel      tiled float GEMM s = wnorm fpat^T over any K,
//                           the ragged edge masked
//   2. fuse_softmax_kernel  the v2 forward's own (attention_v2_kernels.cuh)
//   3. v1_paste_kernel      tiled float GEMM vals = probs^T raw over K = L
// The TPU kernel's K padding to 128 lanes and its row tiles are not
// carried over. Tensor cores (wgmma), TMA and on-chip scores are later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "attention_v2_kernels.cuh"

namespace {

using namespace hv_attn;

// s[b, l, p] = sum over k of wnorm[b, l, k] * fpat[b, p, k]; M = L, N = P.
// Grid (ceil(P/TN), ceil(L/TM), B), GEMM_THREADS threads.
template <typename T>
__global__ void __launch_bounds__(GEMM_THREADS)
v1_score_kernel(const T* __restrict__ fpat, const T* __restrict__ wnorm,
                float* __restrict__ s, int L, int K) {
  __shared__ float As[TK][TM + SMEM_PAD];  // wnorm side, rows l
  __shared__ float Bs[TK][TN + SMEM_PAD];  // fpat side, columns p
  const int b = blockIdx.z;
  const int l0 = blockIdx.y * TM, p0 = blockIdx.x * TN;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const T* wb = wnorm + (size_t)b * L * K;
  const T* fb = fpat + (size_t)b * L * K;

  float acc[4][4];
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += TK) {
    // consecutive threads read consecutive k of one patch
    for (int e = tid; e < TK * TM; e += GEMM_THREADS) {
      const int k = e % TK, m = e / TK;
      const int kk = k0 + k, l = l0 + m, p = p0 + m;
      As[k][m] = l < L && kk < K ? to_f(wb[(size_t)l * K + kk]) : 0.f;
      Bs[k][m] = p < L && kk < K ? to_f(fb[(size_t)p * K + kk]) : 0.f;
    }
    __syncthreads();
    tile_fma(As, Bs, tx, ty, acc);
    __syncthreads();
  }
  for (int i = 0; i < 4; ++i) {
    const int l = l0 + ty * 4 + i;
    if (l >= L) continue;
    float* row = s + ((size_t)b * L + l) * L;
    for (int j = 0; j < 4; ++j) {
      const int p = p0 + tx * 4 + j;
      if (p < L) row[p] = acc[i][j];
    }
  }
}

// vals[b, p, r] = sum over l of probs[b, l, p] * raw[b, l, r]; M = P,
// N = RC, K = L. Grid (ceil(RC/TN), ceil(P/TM), B), GEMM_THREADS threads.
template <typename T>
__global__ void __launch_bounds__(GEMM_THREADS)
v1_paste_kernel(const float* __restrict__ probs, const T* __restrict__ raw,
                T* __restrict__ vals, int L, int RC) {
  __shared__ float As[TK][TM + SMEM_PAD];  // probs side, rows p
  __shared__ float Bs[TK][TN + SMEM_PAD];  // raw side, columns r
  const int b = blockIdx.z;
  const int p0 = blockIdx.y * TM, r0 = blockIdx.x * TN;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const float* pb = probs + (size_t)b * L * L;
  const T* rb = raw + (size_t)b * L * RC;

  float acc[4][4];
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < L; k0 += TK) {
    // consecutive threads take consecutive columns p / r of one row l
    for (int e = tid; e < TK * TM; e += GEMM_THREADS) {
      const int k = e / TM, mn = e % TM;
      const int l = k0 + k, p = p0 + mn, r = r0 + mn;
      As[k][mn] = l < L && p < L ? pb[(size_t)l * L + p] : 0.f;
      Bs[k][mn] = l < L && r < RC ? to_f(rb[(size_t)l * RC + r]) : 0.f;
    }
    __syncthreads();
    tile_fma(As, Bs, tx, ty, acc);
    __syncthreads();
  }
  for (int i = 0; i < 4; ++i) {
    const int p = p0 + ty * 4 + i;
    if (p >= L) continue;
    T* out = vals + ((size_t)b * L + p) * RC;
    for (int j = 0; j < 4; ++j) {
      const int r = r0 + tx * 4 + j;
      if (r < RC) out[r] = from_f<T>(acc[i][j]);
    }
  }
}

template <typename T>
void launch_v1(const void* fpat, const void* wnorm, const void* raw, const float* mm,
               void* vals, float* s, float* probs, int B, int hd, int wd, int K, int RC,
               float scale, cudaStream_t stream) {
  const int L = hd * wd;
  const dim3 score_grid((L + TN - 1) / TN, (L + TM - 1) / TM, B);
  v1_score_kernel<T><<<score_grid, GEMM_THREADS, 0, stream>>>(
      static_cast<const T*>(fpat), static_cast<const T*>(wnorm), s, L, K);
  const dim3 sm_grid((L + SM_COLS - 1) / SM_COLS, B);
  fuse_softmax_kernel<kFull><<<sm_grid, dim3(SM_COLS, SM_ROWS), 0, stream>>>(
      s, mm, probs, hd, wd, scale);
  const dim3 paste_grid((RC + TN - 1) / TN, (L + TM - 1) / TM, B);
  v1_paste_kernel<T><<<paste_grid, GEMM_THREADS, 0, stream>>>(
      probs, static_cast<const T*>(raw), static_cast<T*>(vals), L, RC);
}

}  // namespace

// Launches the v1 pipeline on `stream` and returns cudaGetLastError() (0 on
// success). dtype_code: 0 = float32, 1 = bfloat16 (fpat, wnorm, raw and vals);
// mm, s and probs are float. Does not synchronise and allocates nothing:
// vals and the (B, L, L) scratch s and probs come from the caller.
extern "C" int hv_attention_scores_paste(const void* fpat, const void* wnorm, const void* raw,
                                         const float* mm, void* vals, float* s, float* probs,
                                         int B, int hd, int wd, int K, int RC, float scale,
                                         int dtype_code, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype_code == 1) {
    launch_v1<__nv_bfloat16>(fpat, wnorm, raw, mm, vals, s, probs, B, hd, wd, K, RC, scale, st);
  } else if (dtype_code == 0) {
    launch_v1<float>(fpat, wnorm, raw, mm, vals, s, probs, B, hd, wd, K, RC, scale, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
