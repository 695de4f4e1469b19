"""Space-to-depth execution domain for wide-resolution narrow-channel convs.

Counterpart of healthivert_tpu/ops/s2d.py. The generator's 256^2 layers run
at C=1..33 (reference inpaint_networks.py:36-117,169-232 with ngf=16).
Transforming those layers into the half-resolution space-to-depth domain
multiplies both channel dims by 4 (N 16->64, K 9C->36C), trading denser GEMM
tiles for structurally-zero FLOPs. The weight transforms below are EXACT: a
transformed conv on the s2d tensor produces the same math as the original
conv on the dense tensor (up to float reassociation), held by
tests/test_torch_edges_s2d.py. As in the JAX package, the module is a tested
building block and is NOT wired into the generator.

Layouts are the JAX package's: NHWC tensors, kernels (k, k, C, F) as flax
keeps them (the port's convs hold OIHW: w_hwio = weight.permute(2, 3, 1, 0)).

Layout convention (channel-major): s2d(x)[b, i, j, c*4 + di*2 + dj]
= x[b, 2i+di, 2j+dj, c]. Channel-major (c outer, phase inner) makes channel
concatenation commute with s2d, and makes the 2x nearest-neighbor UPSAMPLE
of a half-res tensor exactly `repeat_interleave(z, 4, dim=-1)`.

Conv transforms (odd kernels, symmetric explicit padding p=(k-1)/2):

- kernel_s2d_s2d:   s2d in  -> s2d out, stride 1. k x k -> 3 x 3 taps in the
                    half-res grid (pad 1) for both k=3 (p=1) and k=5 (p=2).
- kernel_s2d_down:  s2d in  -> DENSE half-res out; replaces a stride-2 conv
                    (k=3, p=1) with a stride-1 2x2-tap conv on the s2d grid
                    (pad (1, 0)).

Each transform is one gather with a cached numpy index map (the JAX
package's maps, copied), so the per-step cost is a single O(|W'|) gather.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, H/2, W/2, 4C), channel-major phase packing."""
    b, h, w, c = x.shape
    y = x.reshape(b, h // 2, 2, w // 2, 2, c)
    y = y.permute(0, 1, 3, 5, 2, 4)  # (B, H2, W2, C, di, dj)
    return y.reshape(b, h // 2, w // 2, c * 4)


def depth_to_space(y: torch.Tensor) -> torch.Tensor:
    """(B, H/2, W/2, 4C) -> (B, H, W, C), inverse of space_to_depth."""
    b, h2, w2, c4 = y.shape
    c = c4 // 4
    x = y.reshape(b, h2, w2, c, 2, 2)
    x = x.permute(0, 1, 4, 2, 5, 3)  # (B, H2, di, W2, dj, C)
    return x.reshape(b, h2 * 2, w2 * 2, c)


def _phase_split(t: int):
    """t = 2a + b with b in {0, 1}: (a, b)."""
    a, b = divmod(t, 2)  # python divmod floors, so b >= 0 for negative t
    return a, b


@functools.lru_cache(maxsize=None)
def _s2d_s2d_index(k: int, c: int, f: int) -> np.ndarray:
    """Gather map (3, 3, 4c, 4f) into flat w (+1 zero slot at index k*k*c*f)."""
    p = (k - 1) // 2
    zero = k * k * c * f
    idx = np.full((3, 3, 4 * c, 4 * f), zero, np.int32)
    for di in range(2):
        for dj in range(2):
            for u in range(k):
                a, b = _phase_split(di + u - p)
                assert -1 <= a <= 1, (k, di, u)
                for v in range(k):
                    a2, b2 = _phase_split(dj + v - p)
                    src = (np.arange(c)[:, None] * f + np.arange(f)[None, :]) + (
                        (u * k + v) * c * f
                    )
                    idx[a + 1, a2 + 1, b * 2 + b2 :: 4, di * 2 + dj :: 4] = src
    return idx


@functools.lru_cache(maxsize=None)
def _s2d_down_index(c: int, f: int) -> np.ndarray:
    zero = 9 * c * f
    idx = np.full((2, 2, 4 * c, f), zero, np.int32)
    for u in range(3):
        a, b = _phase_split(u - 1)  # t in {-1, 0, 1} -> a in {-1, 0}
        for v in range(3):
            a2, b2 = _phase_split(v - 1)
            src = (np.arange(c)[:, None] * f + np.arange(f)[None, :]) + (
                (u * 3 + v) * c * f
            )
            idx[a + 1, a2 + 1, b * 2 + b2 :: 4, :] = src
    return idx


def _gather(w: torch.Tensor, idx: np.ndarray) -> torch.Tensor:
    flat = torch.cat([w.reshape(-1), w.new_zeros(1)])
    return flat[torch.from_numpy(idx.astype(np.int64)).to(w.device)]


def kernel_s2d_s2d(w: torch.Tensor) -> torch.Tensor:
    """(k, k, C, F) stride-1 pad-(k-1)/2 conv -> (3, 3, 4C, 4F) conv on the
    s2d tensors with pad 1. Exact for k in {3, 5}."""
    k, k2, c, f = w.shape
    assert k in (3, 5) and k2 == k, w.shape
    return _gather(w, _s2d_s2d_index(k, c, f))


def kernel_s2d_down(w: torch.Tensor) -> torch.Tensor:
    """(3, 3, C, F) stride-2 pad-1 conv -> (2, 2, 4C, F) stride-1 conv on the
    s2d INPUT producing the dense half-res output, pad ((1,0),(1,0))."""
    assert tuple(w.shape[:2]) == (3, 3), w.shape
    c, f = w.shape[2], w.shape[3]
    return _gather(w, _s2d_down_index(c, f))


def bias_s2d(bias: torch.Tensor) -> torch.Tensor:
    """(F,) -> (4F,): each feature's bias lands on its 4 phase channels."""
    return torch.repeat_interleave(bias, 4)


def upsample2x_as_s2d(z: torch.Tensor) -> torch.Tensor:
    """s2d form of resize_nearest(z, 2H, 2W): every phase sees z itself."""
    return torch.repeat_interleave(z, 4, dim=-1)
