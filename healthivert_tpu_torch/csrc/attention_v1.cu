// Contextual attention on patch tensors (v1) for Hopper (sm_90a), float32
// on the CUDA cores, with a plain C interface.
//
// Replaces, for float32 inputs, the Pallas TPU kernel
// `attention_scores_paste` / `_attention_kernel`
// (healthivert_tpu/ops/attention_pallas.py:98-249): from foreground patches
// fpat (B, P, K), background patches wnorm (B, L, K) that arrive already
// divided by their norm, raw patches raw (B, L, RC) and the gate mm (B, L),
// it computes the scores s = wnorm fpat^T, the diagonal and the permuted
// fuse passes, the gated column softmax, and the patch values
// vals = probs^T raw (B, P, RC), before any fold. L = P = hd * wd; K and RC
// are free. bf16 inputs take the tensor-core route (attention_tc_v1.cu).
// healthivert_tpu_torch/ops/attention_cuda.py holds the wrapper and the
// plain PyTorch version.
//
// What bounds it on this card: the work. At the shapes of the generator
// (L = P = 1024, K = 9C = 576, RC = 16C = 1024) a sample is
// 2 * L * P * (K + RC) = 3.36 GFLOP against ~13 MB of float32 inputs and
// output: above the ridge of the 67 TFLOP/s float32 CUDA cores, whose rate
// is the bound (3.2 ms at B = 64).
//
// What this design does about it: little; it is the simple, right first
// version, built from the v2 forward's CUDA-core pieces. No norm is taken
// (the background patches arrive normalised), and three kernels run one
// after another on the caller's stream, with the (L, P) scores and
// probabilities in device memory:
//   1. v1_score_kernel      tiled float GEMM s = wnorm fpat^T over any K,
//                           the ragged edge masked
//   2. fuse_softmax_kernel  the v2 forward's own (attention_v2_kernels.cuh)
//   3. v1_paste_kernel      tiled float GEMM vals = probs^T raw over K = L
// The TPU kernel's K padding to 128 lanes and its row tiles are not
// carried over. A tensor-core float32 route (3xTF32) is later work.
#include <cuda_runtime.h>

#include "attention_v2_kernels.cuh"

namespace {

using namespace hv_attn;

// s[b, l, p] = sum over k of wnorm[b, l, k] * fpat[b, p, k]; M = L, N = P.
// Grid (ceil(P/TN), ceil(L/TM), B), GEMM_THREADS threads.
__global__ void __launch_bounds__(GEMM_THREADS)
v1_score_kernel(const float* __restrict__ fpat, const float* __restrict__ wnorm,
                float* __restrict__ s, int L, int K) {
  __shared__ float As[TK][TM + SMEM_PAD];  // wnorm side, rows l
  __shared__ float Bs[TK][TN + SMEM_PAD];  // fpat side, columns p
  const int b = blockIdx.z;
  const int l0 = blockIdx.y * TM, p0 = blockIdx.x * TN;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const float* wb = wnorm + (size_t)b * L * K;
  const float* fb = fpat + (size_t)b * L * K;

  float acc[4][4];
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += TK) {
    // consecutive threads read consecutive k of one patch
    for (int e = tid; e < TK * TM; e += GEMM_THREADS) {
      const int k = e % TK, m = e / TK;
      const int kk = k0 + k, l = l0 + m, p = p0 + m;
      As[k][m] = l < L && kk < K ? wb[(size_t)l * K + kk] : 0.f;
      Bs[k][m] = p < L && kk < K ? fb[(size_t)p * K + kk] : 0.f;
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
__global__ void __launch_bounds__(GEMM_THREADS)
v1_paste_kernel(const float* __restrict__ probs, const float* __restrict__ raw,
                float* __restrict__ vals, int L, int RC) {
  __shared__ float As[TK][TM + SMEM_PAD];  // probs side, rows p
  __shared__ float Bs[TK][TN + SMEM_PAD];  // raw side, columns r
  const int b = blockIdx.z;
  const int p0 = blockIdx.y * TM, r0 = blockIdx.x * TN;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const float* pb = probs + (size_t)b * L * L;
  const float* rb = raw + (size_t)b * L * RC;

  float acc[4][4];
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < L; k0 += TK) {
    // consecutive threads take consecutive columns p / r of one row l
    for (int e = tid; e < TK * TM; e += GEMM_THREADS) {
      const int k = e / TM, mn = e % TM;
      const int l = k0 + k, p = p0 + mn, r = r0 + mn;
      As[k][mn] = l < L && p < L ? pb[(size_t)l * L + p] : 0.f;
      Bs[k][mn] = l < L && r < RC ? rb[(size_t)l * RC + r] : 0.f;
    }
    __syncthreads();
    tile_fma(As, Bs, tx, ty, acc);
    __syncthreads();
  }
  for (int i = 0; i < 4; ++i) {
    const int p = p0 + ty * 4 + i;
    if (p >= L) continue;
    float* out = vals + ((size_t)b * L + p) * RC;
    for (int j = 0; j < 4; ++j) {
      const int r = r0 + tx * 4 + j;
      if (r < RC) out[r] = acc[i][j];
    }
  }
}

}  // namespace

// Launches the float32 v1 pipeline on `stream` and returns
// cudaGetLastError() (0 on success). fpat, wnorm, raw, vals, mm, s and
// probs are float. Does not synchronise and allocates nothing: vals and the
// (B, L, L) scratch s and probs come from the caller.
extern "C" int hv_attention_scores_paste(const float* fpat, const float* wnorm, const float* raw,
                                         const float* mm, float* vals, float* s, float* probs,
                                         int B, int hd, int wd, int K, int RC, float scale,
                                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int L = hd * wd;
  v1_score_kernel<<<dim3((L + TN - 1) / TN, (L + TM - 1) / TM, B), GEMM_THREADS, 0, st>>>(
      fpat, wnorm, s, L, K);
  fuse_softmax_kernel<kFull><<<dim3((L + SM_COLS - 1) / SM_COLS, B), dim3(SM_COLS, SM_ROWS), 0,
                               st>>>(s, mm, probs, hd, wd, scale);
  v1_paste_kernel<<<dim3((RC + TN - 1) / TN, (L + TM - 1) / TM, B), GEMM_THREADS, 0, st>>>(
      probs, raw, vals, L, RC);
  return static_cast<int>(cudaGetLastError());
}
