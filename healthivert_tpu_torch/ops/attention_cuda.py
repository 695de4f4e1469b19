"""Fused contextual attention, forward and backward: the CUDA kernels and
their plain versions, and the autograd Function that joins them.

`attention_v2` replaces the Pallas TPU kernel of the same name
(healthivert_tpu/ops/attention_pallas.py:476, body `_attention_v2_kernel`
:304-470) and `attention_v2_bwd` replaces `attention_v2_bwd` (:772, body
`_attention_v2_bwd_kernel` :597-766), with the same arguments and results,
in NHWC. On a CUDA tensor each launches its hand-written kernel or
raises; the dtype picks the route, with no other switch and no fallback.
Both routes run on the tensor cores, TMA-fed wgmma GEMMs with the channels
zero-padded to a multiple of 64 and b_full and dy split into their 2 x 2
phase planes here: bfloat16 in bf16 (csrc/attention_tc.cu), float32 in
3xTF32, each float32 operand as big and small TF32 halves
(csrc/attention_tf32.cu). One library holds every route, built for
sm_90a with nvcc at first use and loaded with ctypes. On a CPU
tensor each runs its plain PyTorch version (`attention_v2_reference`,
`attention_v2_bwd_reference`), which the CPU tests hold against the JAX
package. `AttentionV2Function` is the counterpart of the custom VJP
`attention_v2_diff` (:822-850). `attention_scores_paste` replaces the v1
Pallas kernel `attention_scores_paste` (:199, body `_attention_kernel`
:98-195), which works on patch tensors built beforehand, on the same two
routes with one tap: bfloat16 in csrc/attention_tc_v1.cu, float32 in
csrc/attention_tf32_v1.cu (3xTF32); plain version
`attention_scores_paste_reference`.
The library also holds the forward's stage ablation on both routes
(csrc/attention_tc_ablate.cu for bf16, csrc/attention_tf32_ablate.cu for
float32), whose wrappers live in `healthivert_tpu_torch.experiments.attn_ablate`.
No kernel of the library runs a GEMM on the CUDA cores.

Each kernel's source note says what bounds it on an H100 and what its
design does about it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import NamedTuple

import torch

from .contextual_attention import (
    _fold_overlap_add,
    extract_patches,
    fuse_adjoint,
    fuse_scores,
    patches_adjoint,
)

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("attention_tc.cu", "attention_tf32.cu", "attention_tc_v1.cu", "attention_tf32_v1.cu",
           "attention_tc_ablate.cu", "attention_tf32_ablate.cu", "attention_v2_common.cuh",
           "attention_v2_kernels.cuh", "attention_tc.cuh", "attention_tc_kernels.cuh",
           "attention_tf32_kernels.cuh", "attention_ablate.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
LINK_FLAGS = ("-shared", "-gencode", "arch=compute_90a,code=sm_90a")


class BuildInfo(NamedTuple):
    path: Path
    seconds: float  # 0.0 when an up-to-date library was reused
    ptxas: str  # nvcc's -Xptxas -v report: registers, shared memory, spills


_lock = threading.Lock()
_lib = None
_build_info = None


def _nvcc() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin and PATH)")
    return found


def build(force: bool = False) -> BuildInfo:
    """Compile each .cu file of SOURCES in its own nvcc process, all started
    together, and link the objects into one library in BUILD_DIR (named by a
    hash of the sources and flags, so a stale library is never loaded).
    Returns where it is, how long the build took and the ptxas report.
    force=True rebuilds."""
    digest = hashlib.sha1(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for name in SOURCES:
        digest.update((CSRC / name).read_bytes())
    out = BUILD_DIR / f"attention_v2_{digest.hexdigest()[:16]}.so"
    if out.exists() and not force:
        return BuildInfo(out, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    stem = BUILD_DIR / f"{out.stem}.tmp{os.getpid()}"
    units = [name for name in SOURCES if name.endswith(".cu")]
    objs = [f"{stem}.{Path(name).stem}.o" for name in units]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(CSRC / name)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for name, obj in zip(units, objs)]
    reports = [proc.communicate()[0] for proc in procs]
    failed = [f"{name} ({proc.returncode}):\n{report}"
              for name, proc, report in zip(units, procs, reports) if proc.returncode]
    if not failed:
        link = subprocess.run([nvcc, *LINK_FLAGS, "-o", f"{stem}.so", *objs],
                              capture_output=True, text=True)
        if link.returncode:
            failed.append(f"link ({link.returncode}):\n{link.stdout}{link.stderr}")
    seconds = time.perf_counter() - t0
    for obj in objs:
        Path(obj).unlink(missing_ok=True)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    os.replace(f"{stem}.so", out)
    return BuildInfo(out, seconds, "\n".join(reports).strip())


def load_library(force_build: bool = False):
    """Build (if needed) and load the kernel library once per process."""
    global _lib, _build_info
    with _lock:
        if _lib is None or force_build:
            info = build(force=force_build)
            lib = ctypes.CDLL(str(info.path))
            fn = lib.hv_attention_tf32_forward
            fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [
                ctypes.c_float, ctypes.c_void_p,
            ]
            fn.restype = ctypes.c_int
            fn = lib.hv_attention_tf32_backward
            fn.argtypes = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 7 + [
                ctypes.c_float, ctypes.c_void_p,
            ]
            fn.restype = ctypes.c_int
            fn = lib.hv_attention_tc_forward
            fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [
                ctypes.c_float, ctypes.c_void_p,
            ]
            fn.restype = ctypes.c_int
            fn = lib.hv_attention_tc_backward
            fn.argtypes = [ctypes.c_void_p] * 18 + [ctypes.c_int] * 7 + [
                ctypes.c_float, ctypes.c_void_p,
            ]
            fn.restype = ctypes.c_int
            for name in ("hv_attention_tc_scores_paste", "hv_attention_tf32_scores_paste"):
                fn = getattr(lib, name)
                fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + [
                    ctypes.c_float, ctypes.c_void_p,
                ]
                fn.restype = ctypes.c_int
            fn = lib.hv_attention_tc_ablate
            fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [
                ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ]
            fn.restype = ctypes.c_int
            fn = lib.hv_attention_tf32_ablate
            fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 7 + [
                ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ]
            fn.restype = ctypes.c_int
            _lib, _build_info = lib, info
        return _lib, _build_info


def attention_v2_reference(fd, bd, b_full, mm, hd: int, wd: int,
                           scale: float = 10.0, emit_residuals: bool = False):
    """Plain PyTorch version of `attention_v2`, from the batched patch
    formulation (healthivert_tpu/ops/contextual_attention.py:169-209) with
    the norm applied to the score rows as the kernel does. Computes in
    float32 and returns y in the input dtype."""
    bs, _, _, c = fd.shape
    num_l = hd * wd
    f32 = torch.float32
    fpat = extract_patches(fd.to(f32), 3, 1).reshape(bs, num_l, -1)
    wpat = extract_patches(bd.to(f32), 3, 1).reshape(bs, num_l, -1)
    nrm_raw = torch.sqrt(torch.sum(wpat * wpat, dim=-1, keepdim=True))  # (B, L, 1)
    s = torch.einsum("blk,bpk->blp", wpat, fpat) / torch.clamp(nrm_raw, min=1e-4)
    g = mm.to(f32)[:, :, None]
    probs = torch.softmax(fuse_scores(s, wd) * g * scale, dim=1) * g
    raw = extract_patches(b_full.to(f32), 4, 2).reshape(bs, num_l, -1)
    vals = torch.einsum("blp,blk->bpk", probs, raw).reshape(bs, hd, wd, 4, 4, c)
    y = _fold_overlap_add(vals, 2 * hd, 2 * wd, 2, 4).to(fd.dtype)
    if emit_residuals:
        return y, s, probs, nrm_raw
    return y


def _check(fd, bd, b_full, mm, hd, wd):
    if fd.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"attention_v2 takes float32 or bfloat16, got {fd.dtype}")
    bs, c = fd.shape[0], fd.shape[-1]
    want = {
        "fd": (fd, (bs, hd, wd, c), fd.dtype),
        "bd": (bd, (bs, hd, wd, c), fd.dtype),
        "b_full": (b_full, (bs, 2 * hd, 2 * wd, c), fd.dtype),
        "mm": (mm, (bs, hd * wd), torch.float32),
    }
    for name, (t, shape, dtype) in want.items():
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(
                f"attention_v2: {name} is {tuple(t.shape)} {t.dtype}, "
                f"expected {shape} {dtype}"
            )
        if t.device != fd.device:
            raise ValueError(f"attention_v2: {name} is on {t.device}, fd on {fd.device}")
        if not t.is_contiguous():
            raise ValueError(f"attention_v2: {name} must be contiguous")
    if hd < 2 or wd < 2:
        raise ValueError("attention_v2: the matching grid must be at least 2 x 2")


def attention_v2(fd, bd, b_full, mm, hd: int, wd: int, scale: float = 10.0,
                 emit_residuals: bool = False):
    """Fused contextual-attention forward.

    fd, bd: (B, hd, wd, C) downscaled foreground/background features;
    b_full: (B, 2hd, 2wd, C) full-resolution background; mm: (B, hd*wd)
    float32 availability gate. Returns y (B, 2hd, 2wd, C) in the input
    dtype; with emit_residuals also s (B, L, L) (post-norm, pre-fuse
    scores), probs (B, L, L) and nrm_raw (B, L, 1), all float32."""
    if fd.device.type == "cpu":
        return attention_v2_reference(fd, bd, b_full, mm, hd, wd, scale, emit_residuals)
    if fd.device.type != "cuda":
        raise ValueError(f"attention_v2: no kernel for device {fd.device}")
    _check(fd, bd, b_full, mm, hd, wd)
    if fd.dtype == torch.bfloat16:
        return _attention_tc(fd, bd, b_full, mm, hd, wd, scale, emit_residuals)
    return _attention_tf32(fd, bd, b_full, mm, hd, wd, scale, emit_residuals)


attention_v2.launches = 0  # kernel launches in this process, both routes
attention_v2.tc_launches = 0  # of which on the bf16 tensor-core route
attention_v2.tf32_launches = 0  # of which on the float32 (3xTF32) tensor-core route


def tc_geometry(hd: int, wd: int):
    """(wdp, kp) of the tensor-core route: its tiles are rectangles of the
    grid in a padded row-major order, position (i, j) at i * wdp + j with
    wdp = wd rounded up to a power of two >= 8 (to a multiple of 128 above
    64), so that 64 or 128 consecutive positions are a rectangle one tensor
    map box reads; kp = hd * wdp rounded up to 64 is the row width of its
    (L, P) scratch planes."""
    if wd <= 64:
        wdp = max(8, 1 << (wd - 1).bit_length())
    else:
        wdp = -(-wd // 128) * 128
    return wdp, -(-hd * wdp // 64) * 64


def pad_channels(x, cp: int):
    """x with its last (channel) dimension zero-padded to cp: zero channels
    add nothing to a score or a paste, and the route cuts its outputs back
    to the real channels."""
    c = x.shape[-1]
    return x if c == cp else torch.nn.functional.pad(x, (0, cp - c))


def to_phase_planes(x, hd: int, wd: int, cp: int):
    """(B, 2hd, 2wd, C) -> (B, 4, hd, wd, cp): plane r * 2 + t holds pixel
    (2i + r, 2j + t), channels zero-padded to cp; one copy (and a zero fill
    only when there are channels to pad)."""
    bs, c = x.shape[0], x.shape[-1]
    out = x.new_empty((bs, 4, hd, wd, cp)) if c == cp else x.new_zeros((bs, 4, hd, wd, cp))
    out.view(bs, 2, 2, hd, wd, cp)[..., :c] = x.view(bs, hd, 2, wd, 2, c).permute(0, 2, 4, 1, 3, 5)
    return out


def check_aligned(name, **tensors):
    """Raises ValueError for a tensor that does not start on a 16-byte
    boundary: the float32 route's split_kernel reads four floats at a time
    with no tensor map to check the address first, and a misaligned read
    would poison the CUDA context instead of raising."""
    for key, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name} (3xTF32): {key} must start on a 16-byte boundary")


def _tc_call(name, rc):
    if rc >= 1000:
        raise RuntimeError(f"{name}: cuTensorMapEncodeTiled failed: CUresult {rc - 1000}")
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def _attention_tc(fd, bd, b_full, mm, hd, wd, scale, emit_residuals):
    """attention_v2 on the bf16 tensor-core route (csrc/attention_tc.cu).
    Serving (emit_residuals False) allocates no float32 probs."""
    lib, _ = load_library()
    bs, c = fd.shape[0], fd.shape[-1]
    cp = -(-c // 64) * 64
    wdp, kp = tc_geometry(hd, wd)
    num_l = hd * wd
    dev = fd.device
    f32 = torch.float32
    fd_p, bd_p = pad_channels(fd, cp), pad_channels(bd, cp)
    bph = to_phase_planes(b_full, hd, wd, cp)
    y = torch.empty((bs, 2 * hd, 2 * wd, c), dtype=fd.dtype, device=dev)
    s = torch.empty((bs, num_l, num_l), dtype=f32, device=dev)
    probs = torch.empty_like(s) if emit_residuals else None
    nrm_raw = torch.empty((bs, num_l, 1), dtype=f32, device=dev)
    pt_hi = torch.empty((bs, num_l, kp), dtype=torch.bfloat16, device=dev)
    pt_lo = torch.empty_like(pt_hi)
    with torch.cuda.device(dev):
        rc = lib.hv_attention_tc_forward(
            fd_p.data_ptr(), bd_p.data_ptr(), bph.data_ptr(), mm.data_ptr(), y.data_ptr(),
            s.data_ptr(), None if probs is None else probs.data_ptr(), nrm_raw.data_ptr(),
            pt_hi.data_ptr(), pt_lo.data_ptr(), bs, hd, wd, c, cp, wdp, kp, float(scale),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _tc_call("attention_v2 (tensor cores)", rc)
    attention_v2.launches += 1
    attention_v2.tc_launches += 1
    if emit_residuals:
        return y, s, probs, nrm_raw
    return y


def _attention_tf32(fd, bd, b_full, mm, hd, wd, scale, emit_residuals):
    """attention_v2 on the float32 route (csrc/attention_tf32.cu), laid out
    as the bf16 route. Scratch: fd's and bd's big and small halves, and
    probs^T's (2, B, P, kp); float32 probs only with emit_residuals. fd and
    bd go to split_kernel (uncopied at C == Cp): `check_aligned`."""
    lib, _ = load_library()
    bs, c = fd.shape[0], fd.shape[-1]
    cp = -(-c // 64) * 64
    wdp, kp = tc_geometry(hd, wd)
    num_l = hd * wd
    dev = fd.device
    f32 = torch.float32
    fd_p, bd_p = pad_channels(fd, cp), pad_channels(bd, cp)
    check_aligned("attention_v2", fd=fd_p, bd=bd_p)
    bph = to_phase_planes(b_full, hd, wd, cp)
    y = torch.empty((bs, 2 * hd, 2 * wd, c), dtype=f32, device=dev)
    s = torch.empty((bs, num_l, num_l), dtype=f32, device=dev)
    probs = torch.empty_like(s) if emit_residuals else None
    nrm_raw = torch.empty((bs, num_l, 1), dtype=f32, device=dev)
    maps = torch.empty((4, bs, hd, wd, cp), dtype=f32, device=dev)
    pt = torch.empty((2, bs, num_l, kp), dtype=f32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.hv_attention_tf32_forward(
            fd_p.data_ptr(), bd_p.data_ptr(), bph.data_ptr(), mm.data_ptr(), y.data_ptr(),
            s.data_ptr(), None if probs is None else probs.data_ptr(), nrm_raw.data_ptr(),
            maps.data_ptr(), pt.data_ptr(), bs, hd, wd, c, cp, wdp, kp, float(scale),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _tc_call("attention_v2 (3xTF32)", rc)
    attention_v2.launches += 1
    attention_v2.tf32_launches += 1
    if emit_residuals:
        return y, s, probs, nrm_raw
    return y


def attention_v2_bwd_reference(fd, bd, b_full, dy, probs, s, nrm_raw, mm, hd: int,
                               wd: int, scale: float = 10.0):
    """Plain PyTorch version of `attention_v2_bwd`, in float32, from the
    JAX package's XLA backward (healthivert_tpu/ops/attention_pallas.py:
    853-916) with the kernel's norm gate (nrm_raw > 1e-4). Returns (dfd,
    dbd, db_full) in the input dtype."""
    bs, _, _, c = fd.shape
    num_l = hd * wd
    f32 = torch.float32
    probs, s, nrm_raw = probs.to(f32), s.to(f32), nrm_raw.to(f32)
    nrm = torch.clamp(nrm_raw, min=1e-4)
    g = mm.to(f32)[:, :, None]

    # paste adjoints: dv = 4x4 stride-2 patches of dy / 4
    raw = extract_patches(b_full.to(f32), 4, 2).reshape(bs, num_l, -1)
    dv = extract_patches(dy.to(f32), 4, 2).reshape(bs, num_l, -1) / 4.0
    dprobs = torch.einsum("blr,bpr->blp", raw, dv)
    draw = torch.einsum("blp,bpr->blr", probs, dv)
    db_full = _fold_overlap_add(draw.reshape(bs, hd, wd, 4, 4, c), 2 * hd, 2 * wd, 2, 4) * 4.0

    # softmax and gate backward (the softmax runs over l, axis 1)
    dq = dprobs * g
    colsum = torch.sum(probs * dq, dim=1, keepdim=True)
    ds = fuse_adjoint(probs * (dq - colsum) * g * scale, wd)

    # norm backward, then the score products
    ds0 = ds / nrm
    dn = -torch.sum(ds * s, dim=2, keepdim=True) / nrm
    dnrm2 = torch.where(nrm_raw > 1e-4, dn * 0.5 / torch.clamp(nrm_raw, min=1e-12), 0.0)
    fpat = extract_patches(fd.to(f32), 3, 1).reshape(bs, num_l, -1)
    wpat = extract_patches(bd.to(f32), 3, 1).reshape(bs, num_l, -1)
    dfpat = torch.einsum("blp,blk->bpk", ds0, wpat)
    dwpat = torch.einsum("blp,bpk->blk", ds0, fpat) + 2.0 * wpat * dnrm2
    dfd = patches_adjoint(dfpat, hd, wd, c, 3)
    dbd = patches_adjoint(dwpat, hd, wd, c, 3)
    return dfd.to(fd.dtype), dbd.to(bd.dtype), db_full.to(b_full.dtype)


def _check_bwd(fd, bd, b_full, dy, probs, s, nrm_raw, mm, hd, wd):
    _check(fd, bd, b_full, mm, hd, wd)
    bs, c, num_l = fd.shape[0], fd.shape[-1], hd * wd
    want = {
        "dy": (dy, (bs, 2 * hd, 2 * wd, c), fd.dtype),
        "probs": (probs, (bs, num_l, num_l), torch.float32),
        "s": (s, (bs, num_l, num_l), torch.float32),
        "nrm_raw": (nrm_raw, (bs, num_l, 1), torch.float32),
    }
    for name, (t, shape, dtype) in want.items():
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(
                f"attention_v2_bwd: {name} is {tuple(t.shape)} {t.dtype}, "
                f"expected {shape} {dtype}"
            )
        if t.device != fd.device:
            raise ValueError(f"attention_v2_bwd: {name} is on {t.device}, fd on {fd.device}")
        if not t.is_contiguous():
            raise ValueError(f"attention_v2_bwd: {name} must be contiguous")


def attention_v2_bwd(fd, bd, b_full, dy, probs, s, nrm_raw, mm, hd: int, wd: int,
                     scale: float = 10.0):
    """Adjoint of `attention_v2` from its residuals.

    fd, bd (B, hd, wd, C), b_full and the output cotangent dy (B, 2hd, 2wd,
    C), all in one dtype (float32 or bfloat16); probs, s (B, L, L), nrm_raw
    (B, L, 1) and mm (B, L), float32, as the forward returned them. Returns
    (dfd, dbd, db_full) in the input dtype; the gate gets no gradient."""
    if fd.device.type == "cpu":
        return attention_v2_bwd_reference(fd, bd, b_full, dy, probs, s, nrm_raw, mm,
                                          hd, wd, scale)
    if fd.device.type != "cuda":
        raise ValueError(f"attention_v2_bwd: no kernel for device {fd.device}")
    _check_bwd(fd, bd, b_full, dy, probs, s, nrm_raw, mm, hd, wd)
    if fd.dtype == torch.bfloat16:
        return _attention_tc_bwd(fd, bd, b_full, dy, probs, s, nrm_raw, mm, hd, wd, scale)
    return _attention_tf32_bwd(fd, bd, b_full, dy, probs, s, nrm_raw, mm, hd, wd, scale)


attention_v2_bwd.launches = 0  # kernel launches in this process, both routes
attention_v2_bwd.tc_launches = 0  # of which on the bf16 tensor-core route
attention_v2_bwd.tf32_launches = 0  # of which on the float32 (3xTF32) tensor-core route


def _attention_tf32_bwd(fd, bd, b_full, dy, probs, s, nrm_raw, mm, hd, wd, scale):
    """attention_v2_bwd on the float32 route (csrc/attention_tf32.cu).
    Scratch: grad (B, L, P); planes (4, B, L, kp), probs's then ds0's big
    and small and ds0^T's; the big and small halves of b_full's and dy's
    phase planes (4, B, 4, hd, wd, Cp)."""
    lib, _ = load_library()
    bs, c = fd.shape[0], fd.shape[-1]
    cp = -(-c // 64) * 64
    wdp, kp = tc_geometry(hd, wd)
    num_l = hd * wd
    dev = fd.device
    f32 = torch.float32
    fd_p, bd_p = pad_channels(fd, cp), pad_channels(bd, cp)
    bph, dyph = to_phase_planes(b_full, hd, wd, cp), to_phase_planes(dy, hd, wd, cp)
    dfd, dbd, db_full = torch.empty_like(fd), torch.empty_like(bd), torch.empty_like(b_full)
    grad = torch.empty((bs, num_l, num_l), dtype=f32, device=dev)
    planes = torch.empty((4, bs, num_l, kp), dtype=f32, device=dev)
    maps = torch.empty((4, bs, 4, hd, wd, cp), dtype=f32, device=dev)
    rowsum = torch.empty((bs, num_l), dtype=f32, device=dev)
    dn2 = torch.empty_like(rowsum)
    with torch.cuda.device(dev):
        rc = lib.hv_attention_tf32_backward(
            fd_p.data_ptr(), bd_p.data_ptr(), bph.data_ptr(), dyph.data_ptr(),
            probs.data_ptr(), s.data_ptr(), nrm_raw.data_ptr(), mm.data_ptr(),
            dfd.data_ptr(), dbd.data_ptr(), db_full.data_ptr(), grad.data_ptr(),
            planes.data_ptr(), maps.data_ptr(), rowsum.data_ptr(), dn2.data_ptr(),
            bs, hd, wd, c, cp, wdp, kp, float(scale), torch.cuda.current_stream(dev).cuda_stream,
        )
    _tc_call("attention_v2_bwd (3xTF32)", rc)
    attention_v2_bwd.launches += 1
    attention_v2_bwd.tf32_launches += 1
    return dfd, dbd, db_full


def _attention_tc_bwd(fd, bd, b_full, dy, probs, s, nrm_raw, mm, hd, wd, scale):
    """attention_v2_bwd on the bf16 tensor-core route (csrc/attention_tc.cu)."""
    lib, _ = load_library()
    bs, c = fd.shape[0], fd.shape[-1]
    cp = -(-c // 64) * 64
    wdp, kp = tc_geometry(hd, wd)
    num_l = hd * wd
    dev = fd.device
    f32, bf16 = torch.float32, torch.bfloat16
    fd_p, bd_p = pad_channels(fd, cp), pad_channels(bd, cp)
    bph, dyph = to_phase_planes(b_full, hd, wd, cp), to_phase_planes(dy, hd, wd, cp)
    dfd, dbd, db_full = torch.empty_like(fd), torch.empty_like(bd), torch.empty_like(b_full)
    grad = torch.empty((bs, num_l, num_l), dtype=f32, device=dev)
    planes = [torch.empty((bs, num_l, kp), dtype=bf16, device=dev) for _ in range(4)]
    rowsum = torch.empty((bs, num_l), dtype=f32, device=dev)
    dn2 = torch.empty_like(rowsum)
    with torch.cuda.device(dev):
        rc = lib.hv_attention_tc_backward(
            fd_p.data_ptr(), bd_p.data_ptr(), bph.data_ptr(), dyph.data_ptr(),
            probs.data_ptr(), s.data_ptr(), nrm_raw.data_ptr(), mm.data_ptr(),
            dfd.data_ptr(), dbd.data_ptr(), db_full.data_ptr(), grad.data_ptr(),
            *(p.data_ptr() for p in planes), rowsum.data_ptr(), dn2.data_ptr(),
            bs, hd, wd, c, cp, wdp, kp, float(scale), torch.cuda.current_stream(dev).cuda_stream,
        )
    _tc_call("attention_v2_bwd (tensor cores)", rc)
    attention_v2_bwd.launches += 1
    attention_v2_bwd.tc_launches += 1
    return dfd, dbd, db_full


def attention_scores_paste_reference(fpat, wnorm, raw, mm, hd: int, wd: int,
                                     scale: float = 10.0):
    """Plain PyTorch version of `attention_scores_paste`, in float32, from
    the einsum formulation of healthivert_tpu/ops/contextual_attention.py:
    169-206 without the fold. Returns vals (B, P, RC) in fpat's dtype."""
    f32 = torch.float32
    s = torch.einsum("blk,bpk->blp", wnorm.to(f32), fpat.to(f32))
    g = mm.to(f32)[:, :, None]
    probs = torch.softmax(fuse_scores(s, wd) * g * scale, dim=1) * g
    return torch.einsum("blp,blr->bpr", probs, raw.to(f32)).to(fpat.dtype)


def _check_v1(fpat, wnorm, raw, mm, hd, wd):
    if fpat.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"attention_scores_paste takes float32 or bfloat16, got {fpat.dtype}")
    if fpat.dim() != 3 or wnorm.dim() != 3 or raw.dim() != 3:
        raise ValueError("attention_scores_paste: fpat, wnorm and raw must be (B, N, K)")
    bs, num_p, k = fpat.shape
    num_l = hd * wd
    if num_p != num_l:
        raise ValueError(f"attention_scores_paste: P = {num_p}, expected hd * wd = {num_l}")
    want = {
        "fpat": (fpat, (bs, num_l, k), fpat.dtype),
        "wnorm": (wnorm, (bs, num_l, k), fpat.dtype),
        "raw": (raw, (bs, num_l, raw.shape[-1]), fpat.dtype),
        "mm": (mm, (bs, num_l), torch.float32),
    }
    for name, (t, shape, dtype) in want.items():
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(
                f"attention_scores_paste: {name} is {tuple(t.shape)} {t.dtype}, "
                f"expected {shape} {dtype}"
            )
        if t.device != fpat.device:
            raise ValueError(
                f"attention_scores_paste: {name} is on {t.device}, fpat on {fpat.device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"attention_scores_paste: {name} must be contiguous")
    if hd < 2 or wd < 2:
        raise ValueError("attention_scores_paste: the matching grid must be at least 2 x 2")


def attention_scores_paste(fpat, wnorm, raw, mm, hd: int, wd: int, scale: float = 10.0):
    """Contextual attention on patch tensors (v1), before the fold.

    fpat: (B, P, K) foreground patches; wnorm: (B, L, K) background patches,
    already divided by their norm; raw: (B, L, RC) raw patches, all in one
    dtype (float32 or bfloat16); mm: (B, L) float32 gate. L = P = hd * wd.
    Returns vals (B, P, RC) = (gated softmax of the fused scores)^T raw, in
    fpat's dtype."""
    if fpat.device.type == "cpu":
        return attention_scores_paste_reference(fpat, wnorm, raw, mm, hd, wd, scale)
    if fpat.device.type != "cuda":
        raise ValueError(f"attention_scores_paste: no kernel for device {fpat.device}")
    _check_v1(fpat, wnorm, raw, mm, hd, wd)
    return _attention_v1_kernel(fpat, wnorm, raw, mm, hd, wd, scale)


attention_scores_paste.launches = 0  # kernel launches in this process, both routes
attention_scores_paste.tc_launches = 0  # of which on the bf16 tensor-core route
attention_scores_paste.tf32_launches = 0  # of which on the float32 (3xTF32) tensor-core route


def v1_tc_operands(fpat, wnorm, raw):
    """fpat, wnorm and raw as the tensor-core routes read them: K and RC
    zero-padded to multiples of 64 (TMA strides rows in 16-byte steps and
    reads boxes of 64 bf16 or 32 float32 channels; zero channels add
    nothing to a score or a paste), copied only where a pad is needed (not
    at the generator's K = 576, RC = 1024)."""
    k_pad, r_pad = -(-fpat.shape[-1] // 64) * 64, -(-raw.shape[-1] // 64) * 64
    return pad_channels(fpat, k_pad), pad_channels(wnorm, k_pad), pad_channels(raw, r_pad)


def _attention_v1_kernel(fpat, wnorm, raw, mm, hd, wd, scale):
    """attention_scores_paste on the tensor-core route of fpat's dtype:
    bf16 (csrc/attention_tc_v1.cu; scratch s and probs^T's hi and lo bf16
    planes) or float32 (csrc/attention_tf32_v1.cu, 3xTF32; scratch s,
    fpat's and wnorm's big and small halves (4, B, P, Kp), probs^T's (2, B,
    P, kp); fpat and wnorm go to split_kernel: `check_aligned`). vals is cut
    back to the real RC by the kernel."""
    lib, _ = load_library()
    bs, num_l, k = fpat.shape
    num_r = raw.shape[-1]
    wdp, kp = tc_geometry(hd, wd)
    dev = fpat.device
    f32 = fpat.dtype == torch.float32
    fpat_p, wnorm_p, raw_p = v1_tc_operands(fpat, wnorm, raw)
    vals = torch.empty((bs, num_l, num_r), dtype=fpat.dtype, device=dev)
    s = torch.empty((bs, num_l, num_l), dtype=torch.float32, device=dev)
    if f32:
        check_aligned("attention_scores_paste", fpat=fpat_p, wnorm=wnorm_p)
        scratch = (torch.empty((4, bs, num_l, fpat_p.shape[-1]), dtype=fpat.dtype, device=dev),
                   torch.empty((2, bs, num_l, kp), dtype=fpat.dtype, device=dev))
        fn, name = lib.hv_attention_tf32_scores_paste, "attention_scores_paste (3xTF32)"
    else:
        scratch = [torch.empty((bs, num_l, kp), dtype=torch.bfloat16, device=dev) for _ in range(2)]
        fn, name = lib.hv_attention_tc_scores_paste, "attention_scores_paste (tensor cores)"
    with torch.cuda.device(dev):
        rc = fn(
            fpat_p.data_ptr(), wnorm_p.data_ptr(), raw_p.data_ptr(), mm.data_ptr(),
            vals.data_ptr(), s.data_ptr(), *(t.data_ptr() for t in scratch),
            bs, hd, wd, k, fpat_p.shape[-1], num_r, raw_p.shape[-1], wdp, kp, float(scale),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _tc_call(name, rc)
    attention_scores_paste.launches += 1
    if f32:
        attention_scores_paste.tf32_launches += 1
    else:
        attention_scores_paste.tc_launches += 1
    return vals


def v1_patches(fd, bd, b_full):
    """The v1 kernel's operands from feature maps, as the JAX package's
    contextual_attention builds them: 3 x 3 patches of fd, norm-scaled 3 x 3
    patches of bd, 4 x 4 stride-2 patches of b_full, in fd's dtype."""
    bs, hd, wd, _ = fd.shape
    num_l = hd * wd
    f32 = torch.float32
    fpat = extract_patches(fd, 3, 1).reshape(bs, num_l, -1)
    wpat = extract_patches(bd.to(f32), 3, 1).reshape(bs, num_l, -1)
    nrm = torch.sqrt(torch.sum(wpat * wpat, dim=-1, keepdim=True))
    wnorm = (wpat / torch.clamp(nrm, min=1e-4)).to(fd.dtype)
    raw = extract_patches(b_full, 4, 2).reshape(bs, num_l, -1)
    return fpat.contiguous(), wnorm.contiguous(), raw.contiguous()


def v1_fold(vals, hd: int, wd: int):
    """The v1 kernel's patch values (B, P, 16C) folded into y (B, 2hd, 2wd, C)."""
    bs, c = vals.shape[0], vals.shape[-1] // 16
    folded = _fold_overlap_add(vals.float().reshape(bs, hd, wd, 4, 4, c), 2 * hd, 2 * wd, 2, 4)
    return folded.to(vals.dtype)


class AttentionV2Function(torch.autograd.Function):
    """Differentiable `attention_v2`: the forward saves its residuals (s,
    probs, nrm_raw) and the backward runs `attention_v2_bwd` on them. Both
    directions take the kernel on a CUDA tensor and the plain version on a
    CPU tensor. The gate mm gets no gradient. With with_probs it also
    returns probs (B, L, P), float32 and not differentiable (the attention
    offsets' argmax reads them).

    apply(fd, bd, b_full, mm, hd, wd, scale[, with_probs]) -> y, or (y, probs)"""

    @staticmethod
    def forward(ctx, fd, bd, b_full, mm, hd, wd, scale, with_probs=False):
        y, s, probs, nrm_raw = attention_v2(fd, bd, b_full, mm, hd, wd, scale,
                                            emit_residuals=True)
        ctx.save_for_backward(fd, bd, b_full, mm, s, probs, nrm_raw)
        ctx.grid = (hd, wd, scale)
        if not with_probs:
            return y
        ctx.mark_non_differentiable(probs)
        return y, probs

    @staticmethod
    def backward(ctx, dy, *_):
        fd, bd, b_full, mm, s, probs, nrm_raw = ctx.saved_tensors
        hd, wd, scale = ctx.grid
        dfd, dbd, db_full = attention_v2_bwd(
            fd, bd, b_full, dy.contiguous(), probs, s, nrm_raw, mm, hd, wd, scale
        )
        return dfd, dbd, db_full, None, None, None, None, None
