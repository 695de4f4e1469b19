// Contextual attention, forward and backward, for bf16 on Hopper (sm_90a):
// the bf16 route, on the tensor cores. Plain C interface.
//
// Replaces the Pallas TPU kernels `attention_v2` / `_attention_v2_kernel`
// (healthivert_tpu/ops/attention_pallas.py:304-549) and `attention_v2_bwd`
// / `_attention_v2_bwd_kernel` (:597-819) for bf16 inputs, with the same
// arguments and results as the float32 route (attention_v2.cu,
// attention_v2_bwd.cu, which stay on the CUDA cores).
// healthivert_tpu_torch/ops/attention_cuda.py holds the wrappers, the
// channel padding and phase split of the inputs, the scratch planes and
// the plain PyTorch versions.
//
// What bounds it on this card: the work. Per sample (L = P = 1024, C = 64)
// the forward is 9 + 16 shifted (L, P, C) products = 3.36 GFLOP (0.217 ms
// at B = 64 at the 989 TFLOP/s bf16 peak) and the backward twice that
// (0.217 ms at B = 32), against a few MB of bf16 maps. The float32 CUDA-
// core kernels ran at ~1.3 % of that bound: float FMAs on 67 TFLOP/s
// cores, per-element division, modulo and bounds checks in every tile
// loader, synchronous loads. The fuse and softmax sweeps over the (L, P)
// float32 matrices are bound by bytes: reading s once and writing the
// probabilities once is ~12 MB a sample, 0.23 ms at B = 64 at 3.35 TB/s
// (0.12 ms without the float32 probs, which serving does not emit).
//
// What this design does about it:
//   * All six GEMMs (score, paste; dprobs, db_full, dfd, dbd) run one
//     mainloop (attention_tc.cuh): TMA loads into a 4-stage ring,
//     wgmma.mma_async with float32 sums in registers, one warpgroup a tile.
//   * TMA does the 2-D shifts: each operand is a tensor map over a view
//     (channels or an (L, P) row, then wd, hd, phase plane, sample) loaded
//     at the tile's corner plus the tap's signed offset; its out-of-bounds
//     fill is the zero padding of the shift. No index arithmetic per loaded
//     element remains.
//   * The 2 x 2 phase planes of b_full and dy come from a phase split in the
//     wrapper (one copy, with the channel pad); the paste's B operand is
//     then a plain 5-D map. A stride-2 tensor map over the natural layout
//     would save that copy; it is not built.
//   * The sweeps between GEMMs write the next GEMM's operand directly, in
//     bf16, in the layout its tensor map reads.
//
// Rounding, each against the plain float32 version at the gates of
// tests/test_torch_cuda_kernel.py:
//   * fd, bd, b_full and dy are bf16 inputs: exact in the tensor cores, and
//     s, dprobs are float32 sums of exact products (s within 2e-5).
//   * probs (paste, db_full) and ds0 (dfd, dbd) are float32 (L, P) values.
//     One bf16 rounding (2^-9 relative) moved y by 3.3e-3 of its largest
//     entry in the CUDA-core ablation (paste_bf16), beyond two bf16 ulps of
//     small entries. So each is split into hi = bf16(v) and lo = bf16(v -
//     hi), two products summed in one accumulator: |v - hi - lo| <= 2^-17
//     |v|. At 1 x 32 x 32 x 64 the split moves y by 5.4e-6 (its largest
//     entry is 3.0) and leaves y and the gradients within a quarter of the
//     bf16 gates against the JAX package; one bf16 rounding of probs would
//     take y to 1.6x its gate (tests/test_torch_attention_tc.py).
//   * Outputs are rounded once to bf16 from the float32 sums.
// Measured on an H100 against the plain version (chip_smoke.py, PERF.md):
// s within 3.3e-7, probs within 1.7e-5, y within the two-ulp gate (largest
// error 0.0156), the gradients within two ulps plus 1e-4 of their largest
// entry.
//
// Kernels, one after another on the caller's stream:
//   forward   patch_norm_kernel (attention_v2_kernels.cuh), lp_gemm (score),
//             fuse_softmax_tc_kernel, pc_gemm (paste, one GEMM per output
//             phase)
//   backward  lp_gemm (dprobs), split_rows_kernel (probs to hi/lo), pc_gemm
//             (db_full), softmax_bwd_kernel (attention_v2_common.cuh),
//             fuse_adj_tc_kernel (ds0 and its transpose, hi/lo, and the norm
//             row sums), dn2_kernel, pc_gemm (dfd), pc_gemm (dbd, with the
//             norm term 2 bd box(dn2) in its epilogue)
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "attention_tc.cuh"
#include "attention_v2_kernels.cuh"

namespace {

using namespace hv_tc;
using bf16 = __nv_bfloat16;
using hv_attn::SM_COLS;
using hv_attn::SM_ROWS;

// Grid geometry shared by every kernel. wdp: the padded row length of the
// position order; kp: the width of an (L, P) scratch plane row (positions
// in that order, zero at phantoms). Cp: channels padded to a multiple of 64.
struct Geom {
  int hd, wd, wdp, kp, C, Cp;
  __device__ __forceinline__ int L() const { return hd * wd; }
  // real grid index of padded position q, or -1 for a phantom
  __device__ __forceinline__ int real(int q) const {
    const int i = q / wdp, j = q % wdp;
    return (i < hd && j < wd) ? i * wd + j : -1;
  }
};

enum GemmKind : int { kScore, kDprobs, kPaste, kDbfull, kDfd, kDbd };

// (L, P) GEMMs, M = rows l, N = columns p, K = taps x channels; both
// operands K-major feature maps (Cp, wd, hd, phase, B), rows shifted by the
// tap. score: 9 window taps of bd (A) and fd (B); dprobs: the 16 paste taps
// of the phase planes of b_full (A) and dy (B).
template <int KIND>
struct LPOp {
  static constexpr int BN = 128, NA = 1, TRANS_B = 0;
  const CUtensorMap* ma;
  const CUtensorMap* mb;
  int b, li0, lj0, pi0, pj0, chunks;
  __device__ int iters() const { return (KIND == kDprobs ? 16 : 9) * chunks; }
  __device__ uint32_t stage_bytes() const { return 3 * TILE_BYTES; }
  __device__ void load(int it, uint8_t* a0, uint8_t*, uint8_t* bt, uint64_t* bar) const {
    const int tap = it / chunks, k0 = (it % chunks) * BK;
    int sy, sx, ph = 0;
    if (KIND == kDprobs) {
      ph = tap / 4;
      paste_tap(ph, tap % 4, sy, sx);
    } else {
      window_tap(tap, sy, sx);
    }
    tma_load_5d(a0, ma, bar, k0, lj0 + sx, li0 + sy, ph, b);
    tma_load_5d(bt, mb, bar, k0, pj0 + sx, pi0 + sy, ph, b);
  }
};

// out[b, l, p] (B, L, P) float: the score divided by max(nrm_raw[l], 1e-4),
// or dprobs / 4. Grid (ceil(hd wdp / 128), ceil(hd wdp / 64), B).
template <int KIND>
__global__ void __launch_bounds__(THREADS)
lp_gemm(const __grid_constant__ CUtensorMap ma, const __grid_constant__ CUtensorMap mb,
        Geom g, const float* __restrict__ nrm_raw, float* __restrict__ out) {
  const int b = blockIdx.z;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * 128;
  const LPOp<KIND> op{&ma, &mb, b, m0 / g.wdp, m0 % g.wdp, n0 / g.wdp, n0 % g.wdp, g.Cp / BK};
  float acc[64];
  mainloop(op, acc);
  const int tid = threadIdx.x;
  const int L = g.L();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int l = g.real(m0 + acc_row(tid, 2 * h));
    if (l < 0) continue;
    const float scale =
        KIND == kDprobs ? 0.25f : 1.f / fmaxf(nrm_raw[(size_t)b * L + l], 1e-4f);
    float* row = out + ((size_t)b * L + l) * L;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * j + 2 * h + e;
        const int p = g.real(n0 + acc_col(tid, i));
        if (p >= 0) row[p] = acc[i] * scale;
      }
    }
  }
}

// (P, C) GEMMs, M = output positions, N = 64 channels, K = taps x kp: A is
// a split (hi, lo) scratch plane (kp, wd, hd, B), rows shifted by -tap; B
// a feature map (Cp, wd, hd, phase, B), MN-major, its K rows (positions)
// shifted by +tap.
//   paste:  y(r, t)[m]   = 1/4 sum_ab sum_l probsT[m - s, l] b_full(r, t)[l + s]
//   db_full: db(r, t)[m] = 1/4 sum_ab sum_p probs[m - s, p] dy(r, t)[p + s]
//   dfd:    dfd[y] = sum_o sum_l ds0T[y - o, l] bd[l + o]
//   dbd:    dbd[y] = sum_o sum_p ds0[y - o, p] fd[p + o] + 2 bd[y] box(dn2)[y]
// with s = (a, bb) the 4 offsets of output phase (r, t), o the 9 window
// offsets.
template <int KIND>
struct PCOp {
  static constexpr int BN = 64, NA = 2, TRANS_B = 1;
  static constexpr bool PASTE = KIND == kPaste || KIND == kDbfull;
  const CUtensorMap* ma_hi;
  const CUtensorMap* ma_lo;
  const CUtensorMap* mb;
  int b, mi0, mj0, c0, wdp, phase, chunks;
  __device__ int iters() const { return (PASTE ? 4 : 9) * chunks; }
  __device__ uint32_t stage_bytes() const { return 3 * TILE_BYTES; }
  __device__ void load(int it, uint8_t* a0, uint8_t* a1, uint8_t* bt, uint64_t* bar) const {
    const int tap = it / chunks, k0 = (it % chunks) * BK;
    int sy, sx;
    if (PASTE) {
      paste_tap(phase, tap, sy, sx);
    } else {
      window_tap(tap, sy, sx);
    }
    tma_load_4d(a0, ma_hi, bar, k0, mj0 - sx, mi0 - sy, b);
    tma_load_4d(a1, ma_lo, bar, k0, mj0 - sx, mi0 - sy, b);
    tma_load_5d(bt, mb, bar, c0, k0 % wdp + sx, k0 / wdp + sy, PASTE ? phase : 0, b);
  }
};

// Grid (Cp / 64, ceil(hd wdp / 64) x phases, B); out in bf16 with C
// channels: (B, 2hd, 2wd, C) for paste and db_full, (B, hd, wd, C) else.
template <int KIND>
__global__ void __launch_bounds__(THREADS)
pc_gemm(const __grid_constant__ CUtensorMap ma_hi, const __grid_constant__ CUtensorMap ma_lo,
        const __grid_constant__ CUtensorMap mb, Geom g, const float* __restrict__ dn2,
        const bf16* __restrict__ bd, bf16* __restrict__ out) {
  constexpr bool PASTE = PCOp<KIND>::PASTE;
  const int b = blockIdx.z;
  const int phase = PASTE ? blockIdx.y % 4 : 0;
  const int m0 = (PASTE ? blockIdx.y / 4 : blockIdx.y) * BM, c0 = blockIdx.x * 64;
  const PCOp<KIND> op{&ma_hi, &ma_lo, &mb, b, m0 / g.wdp, m0 % g.wdp, c0, g.wdp, phase,
                      g.kp / BK};
  float acc[32];
  mainloop(op, acc);
  const int tid = threadIdx.x;
  const int L = g.L();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = g.real(m0 + acc_row(tid, 2 * h));
    if (m < 0) continue;
    const int mi = m / g.wd, mj = m % g.wd;
    size_t at;
    if (PASTE) {
      at = (((size_t)b * 2 * g.hd + 2 * mi + phase / 2) * 2 * g.wd + 2 * mj + phase % 2) * g.C;
    } else {
      at = ((size_t)b * L + m) * g.C;
    }
    float box = 0.f;
    if (KIND == kDbd) {
      for (int dy = -1; dy <= 1; ++dy)
        for (int dx = -1; dx <= 1; ++dx) {
          const int y = mi + dy, x = mj + dx;
          if (y >= 0 && y < g.hd && x >= 0 && x < g.wd) box += dn2[(size_t)b * L + y * g.wd + x];
        }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * j + 2 * h + e;
        const int c = c0 + acc_col(tid, i);
        if (c >= g.C) continue;
        float v = acc[i];
        if (PASTE) v *= 0.25f;
        if (KIND == kDbd) v += 2.f * __bfloat162float(bd[((size_t)b * L + m) * g.Cp + c]) * box;
        out[at + c] = __float2bfloat16(v);
      }
    }
  }
}

__device__ __forceinline__ void split(float v, bf16& hi, bf16& lo) {
  hi = __float2bfloat16(v);
  lo = __float2bfloat16(v - __bfloat162float(hi));
}

constexpr int ROW_PAD = BK + 8;  // bf16 row of a transpose tile: 144 bytes
// Warps of a fuse + softmax block, one row group each: 32 (1024 threads,
// at most 64 registers a thread). The sweep took 1.87 ms at B = 64 on an
// H100 with 32, 2.30 ms with 8 (chip_smoke.py's stage split, PERF.md).
constexpr int SOFTMAX_ROWS = 32;

// Fuse and gated column softmax (as hv_attn::fuse_softmax_kernel), writing
// the paste's operand: probsT (B, P, kp) in hi and lo bf16, row p holding
// probs[l, p] at l's padded position, zero at phantoms; and, when probs is
// not null, the float32 probs (B, L, P). Grid (ceil(P / 32), B), block
// (32, SOFTMAX_ROWS). The first sweep takes the online max and sum of each
// column's logits; the second computes the fused scores again (the 9-tap
// gather of s) rather than storing them, and goes through a 32 x 64 tile
// in shared memory so that the transposed rows are written whole.
__global__ void __launch_bounds__(SM_COLS * SOFTMAX_ROWS)
fuse_softmax_tc_kernel(const float* __restrict__ s, const float* __restrict__ mm,
                       float* __restrict__ probs, bf16* __restrict__ pt_hi,
                       bf16* __restrict__ pt_lo, Geom g, float scale) {
  using namespace hv_attn;
  __shared__ float part_max[SOFTMAX_ROWS][SM_COLS];
  __shared__ float part_sum[SOFTMAX_ROWS][SM_COLS];
  __shared__ __align__(16) bf16 tile[2][SM_COLS][ROW_PAD];
  const int L = g.L();
  const int b = blockIdx.y;
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * SM_COLS + tx;
  const int p = blockIdx.x * SM_COLS + tx;
  const float* sb = s + (size_t)b * L * L;
  const float* gb = mm + (size_t)b * L;

  float run_max = -INFINITY, run_sum = 0.f;
  if (p < L) {
    for (int l = ty; l < L; l += SOFTMAX_ROWS) {
      const float logit = fused_score(sb, l, p, g.wd, L) * gb[l] * scale;
      if (logit > run_max) {
        run_sum = run_sum * expf(run_max - logit) + 1.f;
        run_max = logit;
      } else {
        run_sum += expf(logit - run_max);
      }
    }
  }
  part_max[ty][tx] = run_max;
  part_sum[ty][tx] = run_sum;
  __syncthreads();
  float col_max = -INFINITY;
  for (int r = 0; r < SOFTMAX_ROWS; ++r) col_max = fmaxf(col_max, part_max[r][tx]);
  float col_sum = 0.f;
  for (int r = 0; r < SOFTMAX_ROWS; ++r) {
    const float pm = part_max[r][tx];
    if (pm > -INFINITY) col_sum += part_sum[r][tx] * expf(pm - col_max);
  }
  const float inv = 1.f / col_sum;

  const int row = tid / 8, chunk = tid % 8;  // the write-out: 16 bytes a thread
  const int prow = blockIdx.x * SM_COLS + row;
  for (int k0 = 0; k0 < g.kp; k0 += BK) {
    for (int kk = ty; kk < BK; kk += SOFTMAX_ROWS) {
      const int l = g.real(k0 + kk);
      float v = 0.f;
      if (p < L && l >= 0) {
        const float gl = gb[l];
        v = expf(fused_score(sb, l, p, g.wd, L) * gl * scale - col_max) * inv * gl;
        if (probs != nullptr) probs[((size_t)b * L + l) * L + p] = v;
      }
      split(v, tile[0][tx][kk], tile[1][tx][kk]);
    }
    __syncthreads();
    if (tid < SM_COLS * 8 && prow < L) {
      const size_t at = ((size_t)b * L + prow) * g.kp + k0 + chunk * 8;
      *reinterpret_cast<uint4*>(pt_hi + at) = *reinterpret_cast<const uint4*>(&tile[0][row][chunk * 8]);
      *reinterpret_cast<uint4*>(pt_lo + at) = *reinterpret_cast<const uint4*>(&tile[1][row][chunk * 8]);
    }
    __syncthreads();
  }
}

// hi/lo planes (B, L, kp) of a float (B, L, P) matrix, columns at their
// padded positions, zero at phantoms. Grid (B * L): one block a row, on
// grid x, whose limit (2^31 - 1) no batch reaches; 256 threads.
__global__ void __launch_bounds__(256)
split_rows_kernel(const float* __restrict__ x, bf16* __restrict__ hi, bf16* __restrict__ lo,
                  Geom g) {
  const int L = g.L();
  const size_t row = blockIdx.x;
  for (int q = threadIdx.x; q < g.kp; q += 256) {
    const int p = g.real(q);
    const float v = p >= 0 ? x[row * L + p] : 0.f;
    split(v, hi[row * g.kp + q], lo[row * g.kp + q]);
  }
}

// Fuse adjoint over a 64 x 64 tile of padded (row a, column c) positions:
// ds0 = fuse_adjoint_at(dfused, a, c) / max(nrm_raw[a], 1e-4), written in
// hi and lo bf16 both as ds0 (B, L, kp), row a, and as its transpose ds0T
// (B, P, kp), row c; zero at phantoms. rowsum[b, a] += sum_c ds * s[a, c]
// (zeroed beforehand): the norm's gradient before dn2_kernel. Grid (kp / 64,
// kp / 64, B), block (32, 8).
__global__ void __launch_bounds__(SM_COLS * SM_ROWS)
fuse_adj_tc_kernel(const float* __restrict__ dfused, const float* __restrict__ s,
                   const float* __restrict__ nrm_raw, bf16* __restrict__ ds_hi,
                   bf16* __restrict__ ds_lo, bf16* __restrict__ dst_hi,
                   bf16* __restrict__ dst_lo, float* __restrict__ rowsum, Geom g) {
  using namespace hv_attn;
  __shared__ __align__(16) bf16 tile[2][BK][ROW_PAD];
  const int L = g.L();
  const int b = blockIdx.z;
  const int c0 = blockIdx.x * BK, a0 = blockIdx.y * BK;
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * SM_COLS + tx;
  const float* fb = dfused + (size_t)b * L * L;
  const int cols[2] = {g.real(c0 + tx), g.real(c0 + tx + 32)};

  for (int ar = ty; ar < BK; ar += SM_ROWS) {
    const int a = g.real(a0 + ar);
    float part = 0.f;
    const float nrm = a >= 0 ? fmaxf(nrm_raw[(size_t)b * L + a], 1e-4f) : 1.f;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float v = 0.f;
      if (a >= 0 && cols[e] >= 0) {
        const float ds = fuse_adjoint_at(fb, a, cols[e], g.wd, L);
        part += ds * s[((size_t)b * L + a) * L + cols[e]];
        v = ds / nrm;
      }
      split(v, tile[0][ar][tx + 32 * e], tile[1][ar][tx + 32 * e]);
    }
    for (int off = 16; off > 0; off /= 2) part += __shfl_down_sync(0xffffffffu, part, off);
    if (tx == 0 && a >= 0) atomicAdd(rowsum + (size_t)b * L + a, part);
  }
  __syncthreads();
  // rows a: 64 rows of 8 16-byte chunks a plane, two per thread
  for (int k = tid; k < BK * 8; k += SM_COLS * SM_ROWS) {
    const int ar = k / 8, chunk = k % 8;
    const int a = g.real(a0 + ar);
    if (a < 0) continue;
    const size_t at = ((size_t)b * L + a) * g.kp + c0 + chunk * 8;
    *reinterpret_cast<uint4*>(ds_hi + at) = *reinterpret_cast<const uint4*>(&tile[0][ar][chunk * 8]);
    *reinterpret_cast<uint4*>(ds_lo + at) = *reinterpret_cast<const uint4*>(&tile[1][ar][chunk * 8]);
  }
  // rows c of the transpose: a column of the tile, gathered 8 values a chunk
  for (int k = tid; k < BK * 8; k += SM_COLS * SM_ROWS) {
    const int cr = k / 8, chunk = k % 8;
    const int c = g.real(c0 + cr);
    if (c < 0) continue;
    const size_t at = ((size_t)b * L + c) * g.kp + a0 + chunk * 8;
#pragma unroll
    for (int plane = 0; plane < 2; ++plane) {
      __align__(16) bf16 v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = tile[plane][chunk * 8 + e][cr];
      *reinterpret_cast<uint4*>((plane ? dst_lo : dst_hi) + at) = *reinterpret_cast<const uint4*>(v);
    }
  }
}

// dn2 = -rowsum / nrm * 0.5 / nrm_raw where nrm_raw > 1e-4, else 0 (as the
// float32 route's fuse_adj_norm_kernel).
__global__ void dn2_kernel(const float* __restrict__ rowsum, const float* __restrict__ nrm_raw,
                           float* __restrict__ dn2, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float nr = nrm_raw[i];
  const float dn = -rowsum[i] / fmaxf(nr, 1e-4f);
  dn2[i] = nr > 1e-4f ? dn * 0.5f / fmaxf(nr, 1e-12f) : 0.f;
}

// ---- host side ----

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime's entry-point
// query (no link against libcuda, whose version the toolkit's stub need not
// match).
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t rc =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &found);
#else
    const cudaError_t rc =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    const bool ok = rc == cudaSuccess && found == cudaDriverEntryPointSuccess;
    return ok ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

constexpr int kMapError = 1000;  // returned, plus the CUresult, when a map fails

// A bf16 tensor map over a dense tensor, dims innermost first, 128-byte
// swizzle, zero fill out of bounds. Returns 0 or kMapError + CUresult.
int make_map(CUtensorMap* map, const void* ptr, int rank, const uint64_t* dims,
             const uint32_t* box) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return kMapError + static_cast<int>(CUDA_ERROR_NOT_FOUND);
  cuuint64_t gdim[5], gstride[4];
  cuuint32_t bdim[5], estride[5];
  uint64_t stride = sizeof(bf16);
  for (int i = 0; i < rank; ++i) {
    gdim[i] = dims[i];
    bdim[i] = box[i];
    estride[i] = 1;
    if (i > 0) gstride[i - 1] = stride;
    stride *= dims[i];
  }
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr), gdim,
                        gstride, bdim, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kMapError + static_cast<int>(r);
}

// A feature map (B, phases, hd, wd, Cp) read in boxes of 64 channels by
// `positions` grid positions (a rectangle of the padded order).
int feature_map(CUtensorMap* map, const void* ptr, const Geom& g, int phases, int B,
                int positions) {
  const int w = g.wdp < positions ? g.wdp : positions;
  const uint64_t dims[5] = {(uint64_t)g.Cp, (uint64_t)g.wd, (uint64_t)g.hd, (uint64_t)phases,
                            (uint64_t)B};
  const uint32_t box[5] = {BK, (uint32_t)w, (uint32_t)(positions / w), 1, 1};
  return make_map(map, ptr, 5, dims, box);
}

// A scratch plane (B, hd, wd, kp) read in boxes of 64 row entries by 64
// grid positions.
int plane_map(CUtensorMap* map, const void* ptr, const Geom& g, int B) {
  const int w = g.wdp < BM ? g.wdp : BM;
  const uint64_t dims[4] = {(uint64_t)g.kp, (uint64_t)g.wd, (uint64_t)g.hd, (uint64_t)B};
  const uint32_t box[4] = {BK, (uint32_t)w, (uint32_t)(BM / w), 1};
  return make_map(map, ptr, 4, dims, box);
}

// The geometry the wrapper chose, checked against what the maps need, and
// the batch against the grid's z limit.
bool valid(const Geom& g, int B) {
  const bool wdp_ok = g.wdp <= 64 ? (g.wdp >= 8 && 64 % g.wdp == 0) : g.wdp % 128 == 0;
  return wdp_ok && g.wdp >= g.wd && g.kp % BK == 0 && g.kp >= g.hd * g.wdp && g.Cp % BK == 0 &&
         g.Cp >= g.C && g.hd >= 2 && g.wd >= 2 && B >= 1 && B <= 65535;
}

// The GEMM kernels' dynamic shared memory (above the 48 KiB default), set
// once per kernel on the first launch.
template <class K>
int smem_attribute(K kernel) {
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES));
}

template <int KIND>
int launch_lp(const CUtensorMap& ma, const CUtensorMap& mb, const Geom& g, int B,
              const float* nrm_raw, float* out, cudaStream_t st) {
  static const int attr = smem_attribute(lp_gemm<KIND>);
  if (attr != 0) return attr;
  const int q = g.hd * g.wdp;
  lp_gemm<KIND><<<dim3((q + 127) / 128, (q + BM - 1) / BM, B), THREADS, SMEM_BYTES, st>>>(
      ma, mb, g, nrm_raw, out);
  return static_cast<int>(cudaGetLastError());
}

template <int KIND>
int launch_pc(const CUtensorMap& ma_hi, const CUtensorMap& ma_lo, const CUtensorMap& mb,
              const Geom& g, int B, const float* dn2, const void* bd, void* out,
              cudaStream_t st) {
  static const int attr = smem_attribute(pc_gemm<KIND>);
  if (attr != 0) return attr;
  const int tiles = (g.hd * g.wdp + BM - 1) / BM;
  const int phases = PCOp<KIND>::PASTE ? 4 : 1;
  pc_gemm<KIND><<<dim3(g.Cp / 64, tiles * phases, B), THREADS, SMEM_BYTES, st>>>(
      ma_hi, ma_lo, mb, g, dn2, static_cast<const bf16*>(bd), static_cast<bf16*>(out));
  return static_cast<int>(cudaGetLastError());
}

#define HV_TRY(x)          \
  do {                     \
    const int rc_ = (x);   \
    if (rc_ != 0) return rc_; \
  } while (0)

}  // namespace

// The bf16 forward. fd_p, bd_p (B, hd, wd, Cp) and bph (B, 4, hd, wd, Cp),
// the phase planes of b_full, all bf16 with the channels zero-padded to Cp;
// mm (B, L) float. Writes y (B, 2hd, 2wd, C) bf16, s (B, L, P) and
// nrm_raw (B, L) float, and probs (B, L, P) float when it is not null.
// pt_hi, pt_lo: (B, P, kp) bf16 scratch. Returns 0, a CUDA error, or
// 1000 + a CUresult when a tensor map cannot be built.
extern "C" int hv_attention_tc_forward(const void* fd_p, const void* bd_p, const void* bph,
                                       const float* mm, void* y, float* s, float* probs,
                                       float* nrm_raw, void* pt_hi, void* pt_lo, int B, int hd,
                                       int wd, int C, int Cp, int wdp, int kp, float scale,
                                       void* stream) {
  const Geom g{hd, wd, wdp, kp, C, Cp};
  if (!valid(g, B)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  CUtensorMap m_bd, m_fd, m_hi, m_lo, m_bph;
  HV_TRY(feature_map(&m_bd, bd_p, g, 1, B, BM));
  HV_TRY(feature_map(&m_fd, fd_p, g, 1, B, 128));
  HV_TRY(plane_map(&m_hi, pt_hi, g, B));
  HV_TRY(plane_map(&m_lo, pt_lo, g, B));
  HV_TRY(feature_map(&m_bph, bph, g, 4, B, BM));
  const int L = hd * wd;
  const int n_rows = B * L;
  hv_attn::patch_norm_kernel<bf16><<<(n_rows + 255) / 256, 256, 0, st>>>(
      static_cast<const bf16*>(bd_p), nrm_raw, n_rows, hd, wd, Cp);
  HV_TRY(static_cast<int>(cudaGetLastError()));
  HV_TRY(launch_lp<kScore>(m_bd, m_fd, g, B, nrm_raw, s, st));
  fuse_softmax_tc_kernel<<<dim3((L + SM_COLS - 1) / SM_COLS, B), dim3(SM_COLS, SOFTMAX_ROWS), 0,
                           st>>>(
      s, mm, probs, static_cast<bf16*>(pt_hi), static_cast<bf16*>(pt_lo), g, scale);
  HV_TRY(static_cast<int>(cudaGetLastError()));
  return launch_pc<kPaste>(m_hi, m_lo, m_bph, g, B, nullptr, nullptr, y, st);
}

// The bf16 backward. fd_p, bd_p (B, hd, wd, Cp), bph and dyph (B, 4, hd,
// wd, Cp): the inputs and the phase planes of b_full and dy, bf16, channels
// zero-padded; probs, s (B, L, P), nrm_raw, mm (B, L) float from the
// forward. Writes dfd, dbd (B, hd, wd, C) and db_full (B, 2hd, 2wd, C)
// bf16. Scratch: grad (B, L, P) float; pl_hi, pl_lo, plt_hi, plt_lo (B, L,
// kp) bf16; rowsum, dn2 (B, L) float. Returns as the forward.
extern "C" int hv_attention_tc_backward(const void* fd_p, const void* bd_p, const void* bph,
                                        const void* dyph, const float* probs, const float* s,
                                        const float* nrm_raw, const float* mm, void* dfd,
                                        void* dbd, void* db_full, float* grad, void* pl_hi,
                                        void* pl_lo, void* plt_hi, void* plt_lo, float* rowsum,
                                        float* dn2, int B, int hd, int wd, int C, int Cp,
                                        int wdp, int kp, float scale, void* stream) {
  const Geom g{hd, wd, wdp, kp, C, Cp};
  if (!valid(g, B)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  CUtensorMap m_bph, m_dyph_n, m_dyph, m_fd, m_bd, m_hi, m_lo, m_thi, m_tlo;
  HV_TRY(feature_map(&m_bph, bph, g, 4, B, BM));
  HV_TRY(feature_map(&m_dyph_n, dyph, g, 4, B, 128));
  HV_TRY(feature_map(&m_dyph, dyph, g, 4, B, BM));
  HV_TRY(feature_map(&m_fd, fd_p, g, 1, B, BM));
  HV_TRY(feature_map(&m_bd, bd_p, g, 1, B, BM));
  HV_TRY(plane_map(&m_hi, pl_hi, g, B));
  HV_TRY(plane_map(&m_lo, pl_lo, g, B));
  HV_TRY(plane_map(&m_thi, plt_hi, g, B));
  HV_TRY(plane_map(&m_tlo, plt_lo, g, B));
  const int L = hd * wd;
  bf16* hi = static_cast<bf16*>(pl_hi);
  bf16* lo = static_cast<bf16*>(pl_lo);

  HV_TRY(launch_lp<kDprobs>(m_bph, m_dyph_n, g, B, nullptr, grad, st));
  split_rows_kernel<<<B * L, 256, 0, st>>>(probs, hi, lo, g);
  HV_TRY(static_cast<int>(cudaGetLastError()));
  HV_TRY(launch_pc<kDbfull>(m_hi, m_lo, m_dyph, g, B, nullptr, nullptr, db_full, st));
  hv_attn::softmax_bwd_kernel<><<<dim3((L + SM_COLS - 1) / SM_COLS, B), dim3(SM_COLS, SM_ROWS),
                                   0, st>>>(probs, mm, grad, L, scale);
  HV_TRY(static_cast<int>(cudaGetLastError()));
  HV_TRY(static_cast<int>(cudaMemsetAsync(rowsum, 0, sizeof(float) * B * L, st)));
  // ds0 goes into the planes that held probs: db_full has read them
  fuse_adj_tc_kernel<<<dim3(kp / BK, kp / BK, B), dim3(SM_COLS, SM_ROWS), 0, st>>>(
      grad, s, nrm_raw, hi, lo, static_cast<bf16*>(plt_hi), static_cast<bf16*>(plt_lo), rowsum, g);
  HV_TRY(static_cast<int>(cudaGetLastError()));
  dn2_kernel<<<(B * L + 255) / 256, 256, 0, st>>>(rowsum, nrm_raw, dn2, B * L);
  HV_TRY(static_cast<int>(cudaGetLastError()));
  HV_TRY(launch_pc<kDfd>(m_thi, m_tlo, m_bd, g, B, nullptr, nullptr, dfd, st));
  return launch_pc<kDbd>(m_hi, m_lo, m_fd, g, B, dn2, bd_p, dbd, st);
}
