// Contextual-attention forward for Hopper (sm_90a), with a plain C interface:
// the float32 route, on the CUDA cores. bf16 inputs take the tensor-core
// route of attention_tc.cu.
//
// Replaces the Pallas TPU kernel `attention_v2` / `_attention_v2_kernel`
// (healthivert_tpu/ops/attention_pallas.py:304-549): scores of 3x3 patches
// divided by the background patch norm, the diagonal and the permuted fuse
// passes, the gated column softmax, and the paste of 4x4 stride-2 raw
// patches into the 2x2 output phases, / 4. Same arguments and results:
// healthivert_tpu_torch/ops/attention_cuda.py holds the wrapper and the
// plain PyTorch version.
//
// What bounds it on this card: the work. Per sample (L = P = 1024, C = 64)
// the score product is 9 * 2 * L * P * C = 1.21 GFLOP and the paste
// 16 * 2 * P * L * C = 2.15 GFLOP, against ~1.3 MB of bf16 inputs and
// output: far above the H100's ~295 FLOP/byte ridge, so the tensor cores'
// rate is the bound.
//
// What this design does about it: for now, little. It is the simple, right
// first version. The TPU kernel kept both (L, P) float score matrices
// (4 MiB each) in VMEM; a Hopper block has at most 227 KB of shared memory,
// so here the scores and the probabilities live in device memory (which
// also gives the `s` and `probs` residuals for free), and four kernels run
// one after another on the caller's stream:
//   1. patch_norm_kernel    the 3x3-window norm of bd per row l
//   2. score_kernel         tiled float GEMM over K = 9 offsets x C, the 9
//                           offsets as 2-D zero-filled shifts of the grid
//   3. fuse_softmax_kernel  both fuse passes as a 9-tap gather of s through
//                           tau = sigma + d, and the gated column softmax
//   4. paste_kernel         tiled float GEMM per output phase, K = 4 x L
// The GEMMs run on the CUDA cores in float (64 x 64 tiles, 4 x 4 per
// thread), the route's own type; the stage ablation (attention_v2_ablate.cu)
// shares these kernels as templates.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "attention_v2_kernels.cuh"

namespace {

template <typename T>
void launch_all(const void* fd, const void* bd, const void* b_full, const float* mm,
                void* y, float* s, float* probs, float* nrm_raw,
                int B, int hd, int wd, int C, float scale, cudaStream_t stream) {
  using namespace hv_attn;
  const int L = hd * wd;
  const int n_rows = B * L;
  patch_norm_kernel<T><<<(n_rows + 255) / 256, 256, 0, stream>>>(
      static_cast<const T*>(bd), nrm_raw, n_rows, hd, wd, C);
  const dim3 score_grid((L + TN - 1) / TN, (L + TM - 1) / TM, B);
  score_kernel<T><<<score_grid, GEMM_THREADS, 0, stream>>>(
      static_cast<const T*>(fd), static_cast<const T*>(bd), nrm_raw, s, hd, wd, C);
  const dim3 sm_grid((L + SM_COLS - 1) / SM_COLS, B);
  fuse_softmax_kernel<kFull><<<sm_grid, dim3(SM_COLS, SM_ROWS), 0, stream>>>(
      s, mm, probs, hd, wd, scale);
  const dim3 paste_grid((C + TN - 1) / TN, 4 * ((L + TM - 1) / TM), B);
  paste_kernel<T><<<paste_grid, GEMM_THREADS, 0, stream>>>(
      probs, static_cast<const T*>(b_full), static_cast<T*>(y), hd, wd, C);
}

}  // namespace

// Launches the forward on `stream` and returns cudaGetLastError() (0 on
// success). float32 inputs and outputs: bfloat16 takes the tensor-core
// route (attention_tc.cu). Does not synchronise and allocates nothing:
// every output and scratch buffer comes from the caller.
extern "C" int hv_attention_v2_forward(const void* fd, const void* bd, const void* b_full,
                                       const float* mm, void* y, float* s, float* probs,
                                       float* nrm_raw, int B, int hd, int wd, int C,
                                       float scale, void* stream) {
  launch_all<float>(fd, bd, b_full, mm, y, s, probs, nrm_raw, B, hd, wd, C, scale,
                    static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}
