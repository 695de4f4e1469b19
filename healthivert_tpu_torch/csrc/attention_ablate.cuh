// What the stage ablation's two routes share: the bf16 one
// (attention_tc_ablate.cu) and the float32 one (attention_tf32_ablate.cu).
// The modes, the fill that stands in for a dropped stage, and the tensor
// map that reads b_full in the natural layout.
//
// The natural-layout map. b_full (B, 2hd, 2wd, Cp) is the 5-D tensor
// (Cp, 2, wd, 2hd, B), innermost first: dim 1 is the column phase t, dim 2
// the column j of pixel 2j + t, dim 3 the pixel row. A paste tile of
// phase (r, t) and tap (sy, sx) reads box (n, 1, w, 2h, 1) with element
// strides (1, 1, 1, 2, 1) at (c0, t, j0 + sx, 2 (i0 + sy) + r, b), n the
// values of one 128-byte row (64 bf16, 32 float32) and w x h that many
// positions. The rule cuda.h states for a traversal stride: a box of
// boxDim[i] elements with elementStrides[i] = 2 loads ceil(boxDim[i] / 2)
// of them, so 2h rows are asked for to get h, every second pixel row from
// 2 (i0 + sy) + r. Outside [0, wd) and [0, 2hd) TMA fills zeros, the
// shift's zero padding, as for the phase planes. The inner box is 128
// bytes, the 128-byte swizzle's limit, and the tile lands in shared memory
// exactly as the phase-plane map's (n, w, h) box does. Channels are padded
// to 64 in the wrapper (nothing to copy at C = 64).
#pragma once

#include <algorithm>

#include <cuda.h>
#include <cuda_runtime.h>

#include "attention_tc_kernels.cuh"

namespace {

// out[i] = v for i < n, grid-stride.
template <typename T>
__global__ void fill_kernel(T* __restrict__ out, float v, size_t n) {
  const T val = hv_attn::from_f<T>(v);
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x)
    out[i] = val;
}

template <typename T>
int fill_async(void* out, float v, size_t n, cudaStream_t st) {
  const int blocks = (int)std::min<size_t>((n + 255) / 256, 132 * 32);
  fill_kernel<T><<<blocks, 256, 0, st>>>(static_cast<T*>(out), v, n);
  return static_cast<int>(cudaGetLastError());
}

// The modes in the order of MODES in experiments/attn_ablate.py.
enum AblateMode : int {
  kAblFull = 0, kAblNoScore, kAblNoFuse, kAblNoSoftmax, kAblNoPaste,
  kAblPasteBf16, kAblFoldNorm, kAblFloor,
};

// b_full (B, 2hd, 2wd, Cp) of T for the paste's B operand (see the note
// above): boxes of one 128-byte row of channels by as many positions.
template <typename T>
int natural_map(CUtensorMap* map, const void* ptr, const Geom& g, int B) {
  constexpr int n = ROW_VALUES<T>;
  const int w = g.wdp < n ? g.wdp : n;
  const uint64_t dims[5] = {(uint64_t)g.Cp, 2, (uint64_t)g.wd, (uint64_t)(2 * g.hd),
                            (uint64_t)B};
  const uint32_t box[5] = {n, 1, (uint32_t)w, (uint32_t)(2 * (n / w)), 1};
  const uint32_t estride[5] = {1, 1, 1, 2, 1};
  return make_map<T>(map, ptr, 5, dims, box, estride);
}

}  // namespace
