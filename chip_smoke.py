#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Drives `healthivert_tpu_torch` at full width (ngf=16, 256 x 256 slices, the
shipped pretrained_synthetic weights and training recipe) and holds its CUDA
kernels against their plain PyTorch versions. Phases, each printing one
JSON line:

  1. device     card name and count, nvidia-smi name and power limit. No
                phase switches TF32 off for the process: each CLI sets
                exact float32 itself (utils.device.float32_exact: PyTorch's
                own matmuls and convolutions without TF32; the float32
                attention route runs 3xTF32 by design), and the phases that
                call the library directly call that helper first
  2. build      one nvcc process per source for sm_90a, all started
                together (csrc/attention_tc.cu, attention_tf32.cu,
                attention_tc_v1.cu, attention_tf32_v1.cu,
                attention_tc_ablate.cu, attention_tf32_ablate.cu), linked
                into one library, with the -Xptxas -v register and
                shared-memory report of each kernel; the SASS (cuobjdump
                -sass) of every tensor-core GEMM kernel of both routes (bf16
                and float32 3xTF32: the forward's and backward's six, v1's
                score and paste, and the ablation's score and paste
                instantiations, the depth-1 ring's included) must hold HGMMA
                (wgmma, all TF32 in the float32 ones) and UTMALDG (TMA
                loads); then, for comparison, the seconds of one nvcc call
                over the same files (its library thrown away); and the host
                geometry library of the de-pedicle masks (native/geometry.cpp,
                g++) that phase straighten loads
  3. kernel     attention_v2 kernel vs plain version at B=4, 32 x 32, C=64,
                f32 (3xTF32 route, counted by tf32_launches) and bf16
                (tensor-core route), hole band in the middle, bottom and
                top; odd cases (16 x 16, C=4; 6 x 10, C=20); and B=64 f32:
                y, s, probs, nrm_raw
  4. kernel_bwd attention_v2_bwd kernel vs plain version on the forward
                kernel's residuals and a random cotangent, at the same
                cases plus 6 x 10, C=20, B=64 bf16 and B=32 f32 (32 x 32,
                C=64): dfd, dbd, db_full
  5. kernel_v1  attention_scores_paste (v1) kernel vs plain version on the
                patch tensors of the same cases at production shapes (K =
                576, RC = 1024), plus 6 x 10, C=20 (K = 180, padded to 192;
                RC = 320) and B=64 in each dtype; bf16 on the bf16
                tensor-core route (counted by tc_launches), f32 on the 3xTF32
                route (tf32_launches)
  6. fwd_f32    generator_forward on the card (kernel) against the port's
                CPU path (plain version), batch 2, float32
  7. grad_f32   one train_step at lr=0, full width (ngf=16, ndf=64, 256 x
                256), batch 2, float32, on the card against the port's CPU
                path: every loss and every G and D gradient tensor; one
                forward and one backward launch on the 3xTF32 route
  8. fwd_bf16   generator_forward at the 3D synthesis batch of 64, bf16:
                one tensor-core launch per forward, finite outputs,
                slices/s
  9. synth3d    the serving path: synthesize_volumes on a 256 x 256 x 64
                synthetic spine, vertebrae 19-21, bf16, batch 64; launches
                on the tensor-core route must equal the synthesis's forward
                dispatches
 9b. int8      int8 inference (--compute_dtype int8): (1) every distinct
                int8 conv shape of the shipped generator at batch 64, 256 x
                256, on random int8 data from a seed, the card route
                (im2col of int8 views, torch._int_mm) bit-equal to its
                plain version (float64 conv) on the card, with its ms, its
                im2col's ms and share and the ms of cuDNN's bf16 conv of
                the shape (CUDA events); (2) the shipped generator's int8
                forward at batch 64 with dynamic and with static scales
                (calibrated on the batch, the 99.5 % quantile): ms, slices/s
                and peak bytes beside fwd_bf16's ms, one bf16 tensor-core
                attention launch and 43 int8 convs a forward, finite
                outputs; on a batch of 4 the card against the port's CPU
                path, the bf16 forward's under the same gate (CARD_CPU_TOL:
                maps mean 2.5e-2, binarised segs apart on 1e-4 of pixels,
                heights 1e-3; the largest error reported), and, not gated,
                int8 against bf16 on the batch of 64 (mean |delta
                x_stage2|, fine-seg IoU); (3) synthesize_volumes(quant=
                "auto") at batch 64 writing the scale store, then at batch
                16 reading it: bit-equal volumes, attention launches equal
                to dispatches (calibration included); (4) the 3D CLI and
                the test CLI at --compute_dtype int8 on 3 patients and 4
                images, with PyTorch's TF32 defaults before each and the
                counts set to 0 just before each and read just after
 10. train_bf16 the training path: run_training with the shipped recipe
                (checkpoints/pretrained_synthetic/train_opt.txt: batch 32,
                bf16), 2 warm-up and 20 timed steps, each timed; one
                forward and one backward launch on the tensor-core route
                per step, finite losses, every parameter tensor moved; one
                more step under torch.profiler for its top ten device
                kernels; then the top ten of one bf16 forward at batch 64
                (the profiler first starts after the timed steps)
 11. train_f32 the float32 training path, the port's and the train CLI's
                default dtype: run_training on the same recipe with
                compute_dtype float32, 2 warm-up and 10 timed steps, one
                forward and one backward launch on the 3xTF32 route per
                step, finite losses, every parameter moved; one more step
                under torch.profiler: its device time and the attention
                route's share of it
 11b. legacy   the rest of the JAX package on the card (phase_legacy):
                (a) the shipped recipe with --netD seg (the seg
                discriminators of models/legacy.py, float32 whatever the
                dtype), bf16 2 + 10 steps beside the recipe's basic
                discriminators run the same way, and float32 2 + 5 steps,
                64 synthetic examples built ahead; ms per step, its range,
                peak device bytes, one launch of #1 and of #2 a step on the
                dtype's route, every parameter moved but the seg decoder's
                (no loss reaches it: Adam steps it by exactly 0); one
                float32 seg step at lr 0, batch 2, card against CPU under
                grad_f32's gates and the discriminators' running statistics
                (STATS_TOL); (b) unet_256, resnet_9blocks and
                DualHeadUNet(5, 64) at batch 8, 256 x 256, float32, in
                training and then eval mode, card against CPU within 1e-4
                of the largest |output|, ms per forward; (c) Prewitt and
                Canny at batch 64, 256 x 256 (atol 1e-5; a Canny pixel may
                differ only on a 45 degree rounding boundary of its
                orientation, counted), gradient_penalty through a basic
                PatchGAN at ndf 64, batch 8 (rtol 1e-4), the s2d kernels
                bit-equal and their convs against the dense ones (1e-5 of
                the largest |output|)
 12. cli        the port's three command-line entry points on a cohort of 8
                patients of 5 vertebrae (256 x 256 x 64) written as NIfTI with
                the port's own writer, with the counts set to 0 just before
                each CLI and read just after: the 3D synthesis CLI on every
                patient (shipped weights through --load_npz, bf16,
                --slice_batch 64) with every output finite, of its input's
                shape and affine and bit-equal to synthesize_volumes called
                directly, tensor-core launches equal to its dispatches; the
                train CLI on the shipped recipe's flags (batch 32, bf16) for 4
                steps, evaluated every epoch, a checkpoint at step 2 (iter_64),
                one forward and one backward launch per step, finite losses,
                eval SSIM/PSNR/Dice/IoU in metrics.jsonl, then resumed from
                that checkpoint to step 4; the test CLI's gallery of 4 images
                on the run's latest checkpoint, one forward launch per image,
                index.html and its 28 PNGs (offset_flow among them) decoded by
                the port's PNG reader; the train CLI at its default dtype,
                float32, for 10 steps with --profile_steps 7,9: one forward
                and one backward launch on the 3xTF32 route per step; the
                same as a process of its own, as a user starts it, with a
                kernel record in its trace for every kernel launch. Each CLI
                runs with PyTorch's TF32 defaults restored before it, and
                must leave float32 exact. Its line has the wall seconds of
                each CLI, per patient and the NIfTI IO share, the train
                CLI's ms per step with data loading, the loader's
                examples/s, and the float32 train CLI's ms per step
 13. hgam       the classifier CLI (python -m healthivert_tpu_torch.cli.
                grad_cam_3d_sagittal) on the cli phase's cohort at its
                defaults (width 32, batch 16, band 128, z_context 2, lr
                1e-3): `train` for 60 steps (cut from 500), then `generate`
                for all 40 vertebrae; finite losses, every CAM volume finite
                and in [0, 1]; each vertebra's Grad-CAM++ recomputed with the
                trained weights on the port's CPU path within 1e-4 of the
                card's (at the precision the CLI sets, TF32 off), the same
                class votes. Its line has the ms
                per train step split into host batch assembly and device
                time, the seconds per vertebra of `generate` and the
                held-out vote accuracy
 14. grade      the grading chain through the user's CLIs on a cohort of 13
                patients x 5 vertebrae (256 x 256 x 64; patients 0-5 train,
                6-9 test, 10-12 val; one fractured vertebra each, grade 2 at
                height ratio 0.7 or grade 3 at 0.5): the classifier CLI
                (train 60 steps, generate); the 3D CLI on those CAMs
                (shipped generator, bf16, --slice_batch 64), tensor-core
                launches equal to its dispatches; generation_eval_sagittal on
                the val split on the card, every average within rtol 1e-4 of
                the same CLI with --gpu_ids -1; rhlv_quantification sagittal
                and coronal; svm_grading and svm_grading_2_5d, each report
                present and finite. Its line has each stage's wall seconds
                and both reports' macro F1 and accuracy
 15. straighten the first step of the user's chain, from raw CTs: two
                patients of 512 x 512 x 400 voxels in Hounsfield units with
                twelve vertebrae on a bent spine, one stored R, P, I, written
                as NIfTI; location_json_local, then straighten_mask_3d
                --reorient RAI on the card, and for one patient with
                --gpu_ids -1: every label/ and mask_2d/ crop bit-equal card
                vs CPU, every CT/ crop within 1e-3; every crop 256 x 256 x 64
                with the reoriented CT's affine, holding its vertebra; then
                the 3D CLI (bf16, --slice_batch 64) on one straightened
                patient, tensor-core launches equal to its dispatches. Its
                line has each patient's seconds split into NIfTI reads, the
                HU window, the resamples, the label cleanup, the masks, the
                writes and the rest; each resample's gather in ms (CUDA
                events on the card, the host clock on the CPU), its knots,
                grid points and peak device memory
 16. ablate     the forward's stage ablation, once in bf16 and once in f32:
                every mode in both layouts, kernel vs plain on soft
                attention at (64, 32, 32, 64) and (1, 6, 10, 20) in bf16 and
                at (2, 32, 32, 64), (1, 6, 10, 20) and (64, 32, 32, 64) in
                f32, and on the entry point's own inputs at its batch in
                bf16, each launch counted on the dtype's route
                (attention_v2_ablate.tc_launches or .tf32_launches);
                run(mode="full") equal to attention_v2 of its dtype bit for
                bit, and run_auto and run_fold to run; then the entry point
                (experiments/attn_ablate.main, its DTYPE set to the dtype)
                at the 3D synthesis's batch of 64, with the counts set to 0
                just before it and read just after: its four entry
                functions and the v1 kernel each launched at least once,
                every launch on the dtype's route, `full`'s variants (ring
                depth 1, natural layout) equal to it; the stage split its
                modes imply beside torch.profiler's split of
                run(mode="full"); a profiled call of every mode and of v1
                holds the route's own GEMMs and no CUDA-core, library or
                other-route GEMM
 17. timing     each kernel, its plain version and its bound, bf16, CUDA
                events: the forward at B=64, the backward at B=32, v1 at
                B=64; the ablation's entry functions in mode full at B=64
                (kernel ms from the ablation's own timing); the forward's,
                the backward's and v1's device time per stage
                (torch.profiler); then, on the 3xTF32 route, the float32
                forward (with its residuals, as training calls it) and
                backward, v1 at B=64 and the ablation's four entry functions
                in mode full at B=64, every float32 gate held, each with its
                stage split, a profile free of CUDA-core, library and
                other-route GEMMs, and (forward, backward, v1) its peak
                device memory; each float32 line with its float32 bound (67
                TFLOP/s, the CUDA cores) and the 3xTF32 bound (495 / 3
                TFLOP/s)

 18. dist       multi-GPU on the one card (two ranks cannot share a card
                under NCCL: "Duplicate GPU detected"), after the timings so
                that no earlier phase's numbers move: (a) synthesize_volumes
                sharded over make_mesh("data:2", [cuda:0, cuda:0]) and over
                make_mesh("data:2,model:2", [cuda:0] * 4) at batch 64
                bit-equal to mesh=None at batch 32 (each shard the shape of
                an unsharded dispatch; the model axis replicates, so it
                dispatches as data:2 does), one tensor-core launch a
                dispatch, counted from 0 before each call; (b) run_training
                on the float32 recipe (TF32 off), global batch 32, 2 steps,
                as two ranks on cuda:0 over gloo (tests/torch_dist_worker.py)
                on --mesh data:2 (16 a rank) and on data:1,model:2 (32 a
                rank), each against one process at 32: the ranks bit-equal,
                one float32-route forward and backward launch a step on
                each, losses rtol 1e-4, the first step's gradients within
                3e-3 of each network's largest, parameters as SUM_RTOL
                says; (c)
                the train CLI under torchrun --standalone --nproc_per_node 1
                (NCCL at world size 1, the backend the group reports), 3
                steps on a NIfTI cohort, its checkpoint against the same CLI
                without torchrun; one float32 recipe step with remat=True
                against the plain step at the card gate, both peak device
                bytes; each part's ms or s with the card's name and power
                limit (not multi-card speeds: everything shares one card)

then the `profiler` line (for each torch.profiler window, the kernel
launches without a kernel record before its measured range and inside it;
see MEASURED), the `kernels` line (14 rows, each kernel in each dtype it runs, with
its dtype; the float32 launches of #1 and #2 are train_f32's, of #3 and
#4-#7 the float32 ablation entry point's), and last the device line. Any
failed check raises
and the script exits non-zero without the last line. Run from the root of
the repository:  python3 chip_smoke.py
"""

import contextlib
import functools
import json
import re
import subprocess
import sys
import tempfile
import threading
import time
import types
from pathlib import Path

import numpy as np
import torch

from healthivert_tpu_torch.data.synthetic import SyntheticDataset, make_spine_volume
from healthivert_tpu_torch.engine import infer3d
from healthivert_tpu_torch.engine.checkpoint import PRETRAINED_NPZ, load_generator
from healthivert_tpu_torch.engine.train_loop import run_training
from healthivert_tpu_torch.experiments import attn_ablate
from healthivert_tpu_torch.experiments.attn_ablate import (
    LAYOUTS,
    MODES,
    ablate_layout_reference,
    ablate_reference,
    ablate_within,
    attention_v2_ablate,
    run,
    run_auto,
    run_fold,
    run_padded,
    to_phases,
)
from healthivert_tpu_torch.experiments.train_timing import read_recipe
from healthivert_tpu_torch.models import pix2pix
from healthivert_tpu_torch.models.pix2pix import Pix2PixConfig, generator_forward
from healthivert_tpu_torch.ops import attention_cuda
from healthivert_tpu_torch.ops import int8_conv as ic
from healthivert_tpu_torch.ops.attention_cuda import (
    attention_scores_paste,
    attention_scores_paste_reference,
    attention_v2,
    attention_v2_bwd,
    attention_v2_bwd_reference,
    attention_v2_reference,
    v1_patches,
)
from healthivert_tpu_torch.utils.device import float32_exact

RECIPE = Path(__file__).resolve().parent / "checkpoints" / "pretrained_synthetic" / "train_opt.txt"

# H100 SXM published peaks (dense): bf16 tensor cores, float32 CUDA cores,
# HBM3 bandwidth.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12
# a float32 product as three TF32 tensor-core products (hi hi, hi lo, lo hi)
PEAK_3XTF32 = 495e12 / 3

# kernel vs plain tolerances: the same float32 arithmetic in another order
# of sums, and another exp in the softmax; y in bf16 within two bf16 ulps
# (|dy| <= 1e-3 + 1.6e-2 |y|), since both round float32 values to bf16
TOL = {"s": 2e-5, "probs": 1e-4, "nrm_rel": 1e-5,
       "y": {torch.float32: (3e-4, 0.0), torch.bfloat16: (1e-3, 1.6e-2)}}
# card (cuDNN f32 without TF32, the kernel) vs the port's CPU path
FWD_TOL = {"maps": 1e-3, "pred_h": 1e-4}
# backward kernel vs plain version: both compute in float32 from the same
# residuals, so they differ by the order of sums; the errors are held
# against 1e-4 of each output's largest entry (dfd reaches ~2e2 while
# entries near zero come from cancelling sums; seen 3.3e-6 of it on an
# H100). bf16 outputs: two bf16 ulps of the plain value plus that floor
# (seen: within one ulp).
BWD_TOL = 1e-4
# one train step, card vs CPU, float32 (TF32 off): losses rtol 1e-4 (seen
# 5e-7); gradients per tensor |card - cpu| <= GRAD_TOL * (G + |cpu|), G the
# largest gradient of that network. cuDNN and oneDNN sum the convs in other
# orders, and the first conv's weight gradient of D2 (a sum over 2 x 128 x
# 128 output positions of binary-image patches) cancels to far below its
# terms: seen 1.5e-3 there, at most 2.3e-4 in G, D1 and D3.
LOSS_RTOL, GRAD_TOL = 1e-4, 3e-3
# the seg discriminators' running statistics after one step, card vs CPU
STATS_TOL = {"mean_atol": 1e-5, "var_rtol": 1e-4}
# the parameters of the seg discriminator's decoder, which no loss reaches
SEG_DECODER = re.compile(r"(dec\d+(_bn)?|seg_out)\.")
# ablation, each mode vs its plain version: attn_ablate.ablate_within. The
# candidates against full, in the entry point's bf16 run: at most two bf16
# ulps of the largest output (the outputs round to bf16).
CANDIDATE_REL = 1.6e-2


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def emit(phase, **kv):
    print(json.dumps({"phase": phase, **kv}), flush=True)


def max_err(a, b):
    return float((a.float().cpu() - b.float().cpu()).abs().max())


def y_within(y, y_ref, dtype):
    """True when |y - y_ref| <= atol + rtol |y_ref| everywhere."""
    atol, rtol = TOL["y"][dtype]
    excess = (y.float() - y_ref.float()).abs() - (atol + rtol * y_ref.float().abs())
    return float(excess.max()) <= 0.0


def attention_inputs(b, hd, wd, c, band, dtype, seed=0, fscale=0.05):
    """Soft-attention features (the foreground scaled down) and a gate with
    its hole band in the middle, bottom or top rows of the query grid."""
    rng = np.random.default_rng(seed)
    fd = rng.standard_normal((b, hd, wd, c)).astype(np.float32) * fscale
    bd = rng.standard_normal((b, hd, wd, c)).astype(np.float32)
    b_full = rng.standard_normal((b, 2 * hd, 2 * wd, c)).astype(np.float32)
    g = np.ones((b, hd, wd), np.float32)
    rows = {"middle": slice(hd // 3, 2 * hd // 3), "top": slice(0, hd // 3),
            "bottom": slice(hd - hd // 3, hd)}[band]
    g[:, rows] = 0.0
    dev = torch.device("cuda")
    t = lambda a: torch.from_numpy(a).to(device=dev, dtype=dtype)
    return t(fd), t(bd), t(b_full), torch.from_numpy(g.reshape(b, -1)).to(dev)


CARD = []  # the nvidia-smi name and power limit, from phase_device


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    CARD[:] = [smi]
    emit("device", name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
         nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
         tf32="as each CLI sets it (utils.device.float32_exact: cudnn.allow_tf32 and "
              "matmul.allow_tf32 False); phases that call the library directly call it too")


def one_call_build_seconds():
    """Seconds of one nvcc call over the library's .cu files with its flags,
    into a library that is thrown away: what the per-source build is set
    against. It runs after that build, so it finds the toolkit's files in
    the page cache."""
    out = attention_cuda.BUILD_DIR / "one_call.tmp.so"
    cus = [str(attention_cuda.CSRC / n) for n in attention_cuda.SOURCES if n.endswith(".cu")]
    t0 = time.perf_counter()
    subprocess.run([attention_cuda._nvcc(), *attention_cuda.NVCC_FLAGS, "-shared", "-o", str(out),
                    *cus], capture_output=True, check=True, timeout=900)
    seconds = time.perf_counter() - t0
    out.unlink()
    return seconds


# the tensor-core GEMM kernels, by name and template arguments. Each route
# has six (bf16 attention_tc.cu, float32 attention_tf32.cu in 3xTF32; the
# score, lp_gemm<0> and lp_gemm_tf32<0>, also in the route's ablation at
# the forward's ring depth), v1's score and paste (attention_tc_v1.cu,
# attention_tf32_v1.cu), and the ablation's score at ring depth 1 and its
# paste in each variant (0 full, 3 paste_bf16, 4 fold_norm), layout (1
# natural, 2 phase planes) and ring depth (attention_tc_ablate.cu: 4 or 1,
# attention_tf32_ablate.cu: 2 or 1)
TF32_GEMMS = ({"lp_gemm_tf32<0>", "lp_gemm_tf32<1>", "lp_gemm_tf32_sync<0>", "v1_gemm_tf32<0>",
               "v1_gemm_tf32<1>"} | {f"pc_gemm_tf32<{k}>" for k in range(2, 6)}
              | {f"paste_gemm_tf32<{v},{io},{ring}>" for v in (0, 3, 4)
                 for io, ring in ((1, 2), (2, 2), (2, 1))})
TC_GEMMS = ({"lp_gemm<0>", "lp_gemm<1>"} | {f"pc_gemm<{k}>" for k in range(2, 6)}
            | TF32_GEMMS | {"v1_gemm<0>", "v1_gemm<1>", "lp_gemm_sync<0>"}
            | {f"paste_gemm<{v},{io},{ring}>" for v in (0, 3, 4)
               for io, ring in ((1, 4), (2, 4), (2, 1))})
GEMM_MANGLED = re.compile(
    r"(lp_gemm_tf32_sync|lp_gemm_sync|lp_gemm_tf32|lp_gemm|pc_gemm_tf32|pc_gemm|paste_gemm_tf32"
    r"|paste_gemm|v1_gemm_tf32|v1_gemm)I((?:Li\d+E)+)E")


def tc_sass(path):
    """HGMMA and UTMALDG counts in the SASS of each tensor-core GEMM kernel
    (TC_GEMMS), per instantiation and translation unit; each must hold
    both, and every instantiation must be there."""
    cuobjdump = Path(attention_cuda._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(path)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    found = {}
    for body in re.split(r"\n\s*Function : ", sass)[1:]:
        m = GEMM_MANGLED.search(body.split("\n", 1)[0])
        if m is None:
            continue
        args = ",".join(re.findall(r"Li(\d+)E", m.group(2)))
        name = f"{m.group(1)}<{args}>"
        counts = {op: body.count(op) for op in ("HGMMA", "UTMALDG")}
        check(all(counts.values()), f"build: {name} SASS lacks HGMMA or UTMALDG: {counts}")
        if name in TF32_GEMMS:  # the products are TF32 wgmma
            counts["HGMMA_TF32"] = len(re.findall(r"HGMMA\.\S*TF32", body))
            check(counts["HGMMA_TF32"] == counts["HGMMA"], f"build: {name} HGMMA not TF32: {counts}")
        found.setdefault(name, []).append(counts)
    check(set(found) == TC_GEMMS, f"build: GEMM kernels {sorted(found)}, expected "
          f"{sorted(TC_GEMMS)}")
    return found


def phase_build():
    from healthivert_tpu_torch.ops import native_geometry

    _, info = attention_cuda.load_library(force_build=True)
    report = [ln.strip() for ln in info.ptxas.splitlines()
              if "Used" in ln or "spill" in ln or "Compiling entry" in ln or "C7515" in ln]
    t0 = time.perf_counter()
    geometry = native_geometry.build()
    native_geometry.load_library()
    geometry_s = time.perf_counter() - t0
    emit("build", seconds=info.seconds, one_call_seconds=one_call_build_seconds(),
         geometry=dict(library=geometry.name, seconds=geometry_s,
                       flags=native_geometry.CXX_FLAGS),
         flags=list(attention_cuda.NVCC_FLAGS),
         sources=[n for n in attention_cuda.SOURCES if n.endswith(".cu")],
         tc_sass=tc_sass(info.path), ptxas=report)


def route_counts():
    """The launch counters of the forward's and the backward's routes."""
    return [getattr(fn, k) for fn in (attention_v2, attention_v2_bwd)
            for k in ("launches", "tc_launches", "tf32_launches")]


def phase_kernel():
    float32_exact()
    cases = [(4, 32, 32, 64, band, dt) for dt in (torch.float32, torch.bfloat16)
             for band in ("middle", "bottom", "top")]
    cases += [(2, 16, 16, 4, "bottom", torch.float32), (2, 16, 16, 4, "top", torch.bfloat16),
              (1, 6, 10, 20, "middle", torch.bfloat16), (1, 6, 10, 20, "top", torch.float32),
              (64, 32, 32, 64, "middle", torch.float32)]
    worst = {}
    for b, hd, wd, c, band, dt in cases:
        fd, bd, b_full, mm = attention_inputs(b, hd, wd, c, band, dt)
        before = route_counts()
        y, s, probs, nrm = attention_v2(fd, bd, b_full, mm, hd, wd, 10.0, emit_residuals=True)
        torch.cuda.synchronize()
        tf32 = int(dt == torch.float32)
        check([a - n for a, n in zip(route_counts(), before)] == [1, 1 - tf32, tf32, 0, 0, 0],
              f"kernel B{b}_{hd}x{wd}: route by dtype")
        y_r, s_r, p_r, n_r = attention_v2_reference(fd, bd, b_full, mm, hd, wd, 10.0, True)
        torch.cuda.synchronize()
        errs = {"y": max_err(y, y_r), "s": max_err(s, s_r), "probs": max_err(probs, p_r),
                "nrm_rel": float(((nrm - n_r).abs() / n_r.abs().clamp_min(1e-6)).max())}
        name = f"B{b}_{hd}x{wd}_C{c}_{band}_{str(dt).split('.')[-1]}"
        check(y.dtype == dt and tuple(y.shape) == (b, 2 * hd, 2 * wd, c), f"{name}: y {y.dtype} {tuple(y.shape)}")
        check(y_within(y, y_r, dt), f"{name}: y err {errs['y']}")
        for k in ("s", "probs", "nrm_rel"):
            check(errs[k] <= TOL[k], f"{name}: {k} err {errs[k]}")
        check(float(p_r.amax(dim=1).min()) < 0.9, f"{name}: attention is one-hot")
        worst[name] = errs
    emit("kernel", cases=worst, tolerances={
        "s": TOL["s"], "probs": TOL["probs"], "nrm_rel": TOL["nrm_rel"],
        "y_f32_atol_rtol": TOL["y"][torch.float32],
        "y_bf16_atol_rtol": TOL["y"][torch.bfloat16]})


def bwd_within(got, want, dtype):
    """|got - want| within the backward's tolerance (see BWD_TOL); returns
    (ok, max abs error, max abs of want)."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    scale = float(want.abs().max())
    allowed = BWD_TOL * scale
    if dtype == torch.bfloat16:
        allowed = allowed + 2 * torch.ldexp(torch.ones_like(want),
                                            torch.frexp(want.abs()).exponent - 8)
    return bool((err <= allowed).all()), float(err.max()), scale


def backward_inputs(b, hd, wd, c, band, dtype, seed=0, fscale=0.05):
    """attention_inputs, the forward kernel's residuals and a random
    cotangent: the arguments of attention_v2_bwd."""
    fd, bd, b_full, mm = attention_inputs(b, hd, wd, c, band, dtype, seed, fscale)
    with torch.no_grad():
        _, s, probs, nrm = attention_v2(fd, bd, b_full, mm, hd, wd, 10.0, emit_residuals=True)
    rng = np.random.default_rng(seed + 1)
    dy = torch.from_numpy(rng.standard_normal((b, 2 * hd, 2 * wd, c)).astype(np.float32))
    return fd, bd, b_full, dy.to(device="cuda", dtype=dtype), probs, s, nrm, mm


def phase_kernel_bwd():
    float32_exact()
    cases = [(4, 32, 32, 64, band, dt) for dt in (torch.float32, torch.bfloat16)
             for band in ("middle", "bottom", "top")]
    cases += [(2, 16, 16, 4, "bottom", torch.float32), (2, 16, 16, 4, "top", torch.bfloat16),
              (1, 6, 10, 20, "middle", torch.float32), (1, 6, 10, 20, "bottom", torch.bfloat16),
              (64, 32, 32, 64, "middle", torch.bfloat16),  # B * L = 65536 rows
              (32, 32, 32, 64, "middle", torch.float32)]  # the recipe's batch
    worst = {}
    for b, hd, wd, c, band, dt in cases:
        args = backward_inputs(b, hd, wd, c, band, dt)
        before = route_counts()
        got = attention_v2_bwd(*args, hd, wd, 10.0)
        torch.cuda.synchronize()
        tf32 = int(dt == torch.float32)
        check([a - n for a, n in zip(route_counts(), before)] == [0, 0, 0, 1, 1 - tf32, tf32],
              f"kernel_bwd B{b}_{hd}x{wd}: route by dtype")
        want = attention_v2_bwd_reference(*args, hd, wd, 10.0)
        torch.cuda.synchronize()
        name = f"B{b}_{hd}x{wd}_C{c}_{band}_{str(dt).split('.')[-1]}"
        errs = {}
        for key, g, w, like in zip(("dfd", "dbd", "db_full"), got, want, args[:3]):
            check(g.dtype == dt and g.shape == like.shape, f"{name}: {key} {g.dtype} {tuple(g.shape)}")
            ok, err, scale = bwd_within(g, w, dt)
            errs[key] = {"max_abs_err": err, "max_abs": scale}
            check(ok, f"{name}: {key} err {err} (max |ref| {scale})")
        check(float(args[4].amax(dim=1).min()) < 0.9, f"{name}: attention is one-hot")
        worst[name] = errs
    emit("kernel_bwd", cases=worst, tolerance=f"f32: {BWD_TOL} * max|ref|; bf16: 2 ulps + "
         f"{BWD_TOL} * max|ref|")


def v1_counts():
    """The launch counters of v1's routes."""
    return [getattr(attention_scores_paste, k) for k in ("launches", "tc_launches", "tf32_launches")]


def phase_kernel_v1():
    float32_exact()
    cases = [(4, 32, 32, 64, band, dt) for dt in (torch.float32, torch.bfloat16)
             for band in ("middle", "bottom", "top")]
    cases += [(1, 6, 10, 20, "bottom", torch.float32), (1, 6, 10, 20, "top", torch.bfloat16),
              (64, 32, 32, 64, "middle", torch.bfloat16), (64, 32, 32, 64, "middle", torch.float32)]
    worst = {}
    for b, hd, wd, c, band, dt in cases:
        fd, bd, b_full, mm = attention_inputs(b, hd, wd, c, band, dt)
        patches = v1_patches(fd, bd, b_full)
        before = v1_counts()
        vals = attention_scores_paste(*patches, mm, hd, wd, 10.0)
        torch.cuda.synchronize()
        tc = int(dt == torch.bfloat16)
        check([a - n for a, n in zip(v1_counts(), before)] == [1, tc, 1 - tc],
              f"kernel_v1 B{b}_{hd}x{wd}_C{c}: route by dtype")
        want = attention_scores_paste_reference(*patches, mm, hd, wd, 10.0)
        _, _, p_r, _ = attention_v2_reference(fd, bd, b_full, mm, hd, wd, 10.0, True)
        name = f"B{b}_{hd}x{wd}_C{c}_{band}_{str(dt).split('.')[-1]}"
        check(vals.dtype == dt and tuple(vals.shape) == (b, hd * wd, 16 * c),
              f"{name}: vals {vals.dtype} {tuple(vals.shape)}")
        worst[name] = max_err(vals, want)
        check(y_within(vals, want, dt), f"{name}: vals err {worst[name]}")
        check(float(p_r.amax(dim=1).min()) < 0.9, f"{name}: attention is one-hot")
    emit("kernel_v1", cases=worst, tolerances={
        "f32_atol_rtol": TOL["y"][torch.float32], "bf16_atol_rtol": TOL["y"][torch.bfloat16]})


ABLATE_COUNTED = (attention_scores_paste, run, run_padded, run_auto, run_fold)
# the counter of each dtype's route, on every wrapper that has both
ROUTE_COUNTER = {torch.bfloat16: "tc_launches", torch.float32: "tf32_launches"}


def dtype_name(dtype):
    return str(dtype).split(".")[-1]


def ablate_cases(batch, dtype):
    """(name, hd, wd, inputs, soft) of phase ablate's comparisons: soft
    attention (attention_inputs) at three shapes, one of them the entry
    point's, and, in bf16, the entry point's own inputs (near one-hot
    attention, whose float32 outputs the 3e-4 gate was not set for: the
    float32 timings use soft attention too)."""
    cases = {torch.bfloat16: [(batch, 32, 32, 64, "top"), (1, 6, 10, 20, "top")],
             torch.float32: [(2, 32, 32, 64, "bottom"), (1, 6, 10, 20, "bottom"),
                             (batch, 32, 32, 64, "top")]}[dtype]
    for b, hd, wd, c, band in cases:
        yield (f"B{b}_{hd}x{wd}_C{c}_{band}_{dtype_name(dtype)}", hd, wd,
               attention_inputs(b, hd, wd, c, band, dtype), True)
    if dtype == torch.bfloat16:
        g, c = attn_ablate.GRID, attn_ablate.CHANNELS
        yield (f"main_B{batch}_{g}x{g}_C{c}_{dtype_name(dtype)}", g, g,
               attn_ablate.make_inputs(batch, g, g, c, dtype, torch.device("cuda"),
                                       attn_ablate.SEED), False)


# stages of the ablation's tensor-core kernels, by a part of each kernel's
# name (fills stand in for dropped stages; `split` is the float32 route's
# split of fd and bd); the rest is the wrapper's
ABLATE_STAGES = (("split", "split_kernel"), ("norm", "patch_norm"), ("score", "lp_gemm"),
                 ("fuse_softmax", "fuse_softmax_tc"), ("paste", "paste_gemm"),
                 ("fill", "fill_kernel"))
# the first ablation's and v1's CUDA-core kernels, which no call may launch
CUDA_CORE_KERNELS = ("score_kernel", "paste_kernel", "fuse_softmax_kernel")


def mode_gemms(mode, dtype, ring_1=False):
    """The GEMM kernels (a part of each name) a call of `mode` launches."""
    tf32 = "_tf32" if dtype == torch.float32 else ""
    score = f"lp_gemm{tf32}_sync<" if ring_1 else f"lp_gemm{tf32}<"
    return ([score] if mode not in ("floor", "no_score") else []) + (
        [f"paste_gemm{tf32}<"] if mode not in ("floor", "no_paste") else [])


def route_clean(names, gemms, what, dtype):
    """A profiled call in `dtype` launched each of `gemms` (a part of each
    name) and no GEMM but its route's own tensor-core ones: no CUDA-core
    GEMM of the first kernels, no library GEMM, no GEMM of the other
    route."""
    own = re.compile(r"(lp|pc|paste|v1)_gemm" + ("_tf32" if dtype == torch.float32 else "")
                     + r"(_sync)?<")
    bad = [k for k in names if NOT_ON_A_ROUTE.search(k) and not own.search(k)]
    check(not bad, f"{what}: launched {bad}")
    missing = [g for g in gemms if not any(g in k for k in names)]
    check(not missing, f"{what}: no {missing} in {names}")


@contextlib.contextmanager
def ablation_dtype(dtype):
    """attn_ablate.main's setting for one run: the dtype its inputs take,
    set the way the tests set its GRID, CHANNELS and REPS."""
    saved, attn_ablate.DTYPE = attn_ablate.DTYPE, dtype
    try:
        yield
    finally:
        attn_ablate.DTYPE = saved


def phase_ablate(batch=64, dtype=torch.bfloat16):
    """Every mode in both layouts against its plain version, each launch on
    the dtype's route; run(mode="full") bit-equal to attention_v2; then the
    ablation's entry point in the dtype with the launch counts set to 0 just
    before it and read just after, then its stage split beside the
    profiler's, and the kernels of a profiled call of every mode and of v1.
    Returns the entry point's result and those counts."""
    float32_exact()
    worst, ab = {}, attn_ablate.attention_v2_ablate
    counter = ROUTE_COUNTER[dtype]
    for case, hd, wd, (fd, bd, b_full, mm), soft in ablate_cases(batch, dtype):
        _, _, probs, _ = attention_v2_reference(fd, bd, b_full, mm, hd, wd, 10.0, True)
        pmax, rmax = float(probs.max()), float(b_full.float().abs().max())
        if soft:
            check(float(probs.amax(dim=1).min()) < 0.9, f"ablate {case}: attention is one-hot")
        del probs
        for layout in LAYOUTS:
            b_in = b_full if layout == "natural" else to_phases(b_full, hd, wd)
            for mode in MODES:
                before = (ab.tc_launches, ab.tf32_launches)
                got = attention_v2_ablate(fd, bd, b_in, mm, hd, wd, 10.0, mode, layout)
                torch.cuda.synchronize()
                name = f"{case}_{layout}_{mode}"
                tc = int(dtype == torch.bfloat16)
                check((ab.tc_launches - before[0], ab.tf32_launches - before[1]) == (tc, 1 - tc),
                      f"{name}: route by dtype")
                want = ablate_layout_reference(fd, bd, b_in, mm, hd, wd, 10.0, mode, layout)
                check(got.dtype == fd.dtype and got.shape == b_in.shape,
                      f"{name}: {got.dtype} {tuple(got.shape)}")
                ok, worst[name] = ablate_within(got, want, mode, pmax, rmax)
                check(ok, f"{name}: err {worst[name]}")
        if hd == 32 and soft:
            with torch.no_grad():
                full = run(fd, bd, b_full, mm, hd, wd)
                check(torch.equal(full, attention_v2(fd, bd, b_full, mm, hd, wd)),
                      f"ablate {case}: run(mode='full') differs from attention_v2")
                for fn in (run_auto, run_fold):
                    check(torch.equal(fn(fd, bd, b_full, mm, hd, wd), full),
                          f"ablate {case}: {fn.__name__} differs from run")
    g, c = attn_ablate.GRID, attn_ablate.CHANNELS
    fd, bd, bf, mm = attn_ablate.make_inputs(batch, g, g, c, dtype, torch.device("cuda"),
                                             attn_ablate.SEED)
    with torch.no_grad():
        check(torch.equal(run(fd, bd, bf, mm, g, g), attention_v2(fd, bd, bf, mm, g, g)),
              f"ablate: {dtype_name(dtype)} run(mode='full') differs from attention_v2")
    torch.cuda.synchronize()
    for fn in ABLATE_COUNTED:
        fn.launches = 0
    for fn in (ab, attention_scores_paste):
        fn.tc_launches = fn.tf32_launches = 0
    with ablation_dtype(dtype):
        result = attn_ablate.main([str(batch)])
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in ABLATE_COUNTED}
    route_launches = getattr(ab, counter)
    v1_route_launches = getattr(attention_scores_paste, counter)
    check(result["dtype"] == dtype_name(dtype), f"ablate: the entry point ran {result['dtype']}")
    check(all(n > 0 for n in launches.values()), f"ablate: a kernel was not launched: {launches}")
    entry = sum(n for name, n in launches.items() if name != "attention_scores_paste")
    check(route_launches == entry and ab.tc_launches + ab.tf32_launches == entry,
          f"ablate: {route_launches} launches on the {dtype_name(dtype)} route of {entry}")
    check(v1_route_launches == launches["attention_scores_paste"],
          f"ablate: {v1_route_launches} v1 launches on the {dtype_name(dtype)} route of "
          f"{launches['attention_scores_paste']}")
    ms, errs = result["ms"], result["rel_err_vs_full"]
    check(all(np.isfinite(v) and v > 0 for v in ms.values()), f"ablate: times {ms}")
    check(errs["auto-full"] == 0.0 and errs["fold-full"] == 0.0, f"ablate: layouts differ {errs}")
    for mode in ("paste_bf16", "fold_norm"):
        check(errs[mode] <= CANDIDATE_REL, f"ablate: {mode} rel err {errs[mode]}")
    calls = {mode: functools.partial(run, fd, bd, bf, mm, g, g, mode=mode) for mode in MODES}
    calls["auto-full"] = functools.partial(run_auto, fd, bd, bf, mm, g, g)
    calls["fold-full"] = functools.partial(run_fold, fd, bd, bf, mm, g, g)
    prof_split, kernels_of = {}, {}
    with torch.no_grad():
        for name, fn in calls.items():
            times = profile_ms(fn)
            prof_split[name] = by_stage(times, ABLATE_STAGES)
            kernels_of[name] = sorted(times)
            mode = {"auto-full": "full", "fold-full": "full"}.get(name, name)
            route_clean(kernels_of[name], mode_gemms(mode, dtype, ring_1=name == "auto-full"),
                        f"ablate {dtype_name(dtype)} {name}", dtype)
        patches = v1_patches(fd, bd, bf)
        v1_kernels = sorted(profile_ms(lambda: attention_scores_paste(*patches, mm, g, g)))
    v1_gemm = "v1_gemm_tf32<" if dtype == torch.float32 else "v1_gemm<"
    route_clean(v1_kernels, [v1_gemm + "0>", v1_gemm + "1>"], f"ablate {dtype_name(dtype)} v1",
                dtype)
    seen = {k for names in kernels_of.values() for k in names} | set(v1_kernels)
    cuda_core = [k for k in seen if any(n in k for n in CUDA_CORE_KERNELS)]
    check(not cuda_core, f"ablate: a {dtype_name(dtype)} call launched CUDA-core kernels {cuda_core}")
    emit("ablate", kernel_vs_plain_max_abs_err=worst, batch=batch, dtype=result["dtype"],
         launches=launches, route_launches={counter: route_launches},
         v1_route_launches={counter: v1_route_launches}, ms=ms,
         saves_ms={m: ms["full"] - ms[m] for m in MODES},
         stage_ms={"ablation (full minus mode, CUDA events)": result["stage_ms"],
                   "profiler (device ms per run(mode='full'), mean of 5)": prof_split["full"]},
         profiler_stage_ms_per_mode=prof_split,
         ring_depth_1_minus_forward_ms=ms["auto-full"] - ms["full"],
         natural_minus_phases_ms={"vs run": ms["fold-full"] - ms["full"],
                                  "vs run_padded": ms["fold-full"] - ms["padded-full"]},
         kernels_of_calls={k: [n[:80] for n in v] for k, v in kernels_of.items()},
         kernels_of_v1_call=[k[:80] for k in v1_kernels],
         rel_err_vs_full=errs, tolerances={"kernel_vs_plain": "y's (f32 atol, bf16 atol "
         f"and rtol {attn_ablate.Y_TOL[torch.float32][0]}, {attn_ablate.Y_TOL[torch.bfloat16]}) "
         f"+ {attn_ablate.ABLATE_REL} * max|ref|, + 2 bf16 straddles for paste_bf16",
         "candidates_vs_full": CANDIDATE_REL})
    return result, launches


def to_device(batch, dev):
    return {k: torch.from_numpy(np.asarray(v)).to(dev) for k, v in batch.items()}


def phase_fwd_f32():
    float32_exact()
    cfg = Pix2PixConfig(ngf=16, image_size=256, compute_dtype="float32")
    batch = SyntheticDataset(batch_size=2, seed=0, n_volumes=2).sample_batch()
    gen_gpu = load_generator(PRETRAINED_NPZ, cfg, device="cuda")
    gen_cpu = load_generator(PRETRAINED_NPZ, cfg, device="cpu")
    before = route_counts()
    with torch.no_grad():
        got = generator_forward(gen_gpu, to_device(batch, "cuda"), cfg)
        torch.cuda.synchronize()
        check([a - n for a, n in zip(route_counts(), before)] == [1, 0, 1, 0, 0, 0],
              "f32 forward did not launch the 3xTF32 kernel once")
        want = generator_forward(gen_cpu, to_device(batch, "cpu"), cfg)
    errs = {}
    for name in ("coarse_seg", "fine_seg", "x_stage1", "x_stage2"):
        errs[name] = max_err(getattr(got["gen"], name), getattr(want["gen"], name))
        check(errs[name] <= FWD_TOL["maps"], f"fwd_f32 {name} err {errs[name]}")
    for name in ("pred1_h", "pred2_h"):
        errs[name] = max_err(getattr(got["gen"], name), getattr(want["gen"], name))
        check(errs[name] <= FWD_TOL["pred_h"], f"fwd_f32 {name} err {errs[name]}")
    errs["fake_b"] = max_err(got["fake_b"], want["fake_b"])
    check(errs["fake_b"] <= FWD_TOL["maps"], f"fwd_f32 fake_b err {errs['fake_b']}")
    emit("fwd_f32", batch=2, max_abs_err=errs, tolerances=FWD_TOL)


def phase_grad_f32(net_d="basic", phase="grad_f32"):
    """One train_step at lr=0 on the card and on the CPU from the same
    weights (shipped generator, seeded discriminators of --netD `net_d`) and
    batch. D2 and the edge loss read the binarised fine seg map, so the
    check first requires card and CPU to put every pixel on the same side
    of 0.5. At net_d="seg" the discriminators' running statistics are held
    too (STATS_TOL)."""
    float32_exact()
    cfg = Pix2PixConfig(ngf=16, ndf=64, image_size=256, compute_dtype="float32", net_d=net_d)
    batch = SyntheticDataset(batch_size=2, seed=0, n_volumes=2).sample_batch()
    runs, seg, stats = {}, {}, {}
    for dev in ("cuda", "cpu"):
        state = pix2pix.init_state(cfg, seed=0, device=dev, gen_npz=PRETRAINED_NPZ)
        with torch.no_grad():
            seg[dev] = generator_forward(state.gen, to_device(batch, dev), cfg)["gen"].fine_seg.cpu()
        before = route_counts()
        state, losses = pix2pix.train_step(state, to_device(batch, dev), 0.0, cfg)
        if dev == "cuda":
            torch.cuda.synchronize()
            check([a - n for a, n in zip(route_counts(), before)] == [1, 0, 1, 1, 0, 1],
                  "grad_f32: not one forward and one backward launch on the 3xTF32 route")
        nets = {"G": state.gen, "D1": state.d1, "D2": state.d2, "D3": state.d3}
        grads = {n: {k: p.grad.detach().cpu() for k, p in m.named_parameters()}
                 for n, m in nets.items()}
        runs[dev] = ({k: float(v) for k, v in losses.items()}, grads)
        stats[dev] = {f"{n}.{k}": v.detach().cpu() for n, m in nets.items() if n != "G"
                      for k, v in m.state_dict().items() if ".running_" in k}
    flips = int(((seg["cuda"] > 0.5) != (seg["cpu"] > 0.5)).sum())
    (l_gpu, g_gpu), (l_cpu, g_cpu) = runs["cuda"], runs["cpu"]
    loss_err = {k: abs(l_gpu[k] - v) / max(abs(v), 1e-12) for k, v in l_cpu.items()}
    worst = {}
    for net in g_cpu:
        scale = max(float(w.abs().max()) for w in g_cpu[net].values())
        ratios = {k: float(((g_gpu[net][k] - w).abs() / (scale + w.abs())).max())
                  for k, w in g_cpu[net].items()}
        name = max(ratios, key=ratios.get)
        worst[net] = {"max_err_over_scale": ratios[name], "worst_tensor": name,
                      "its_max_abs": float(g_cpu[net][name].abs().max()), "scale": scale,
                      "tensors": len(g_cpu[net])}
    extra = {}
    if net_d == "seg":
        mean_err = max(max_err(v, stats["cpu"][k]) for k, v in stats["cuda"].items()
                       if k.endswith("mean"))
        var_rel = max(float(((v - stats["cpu"][k]).abs() / stats["cpu"][k].abs()).max())
                      for k, v in stats["cuda"].items() if k.endswith("var"))
        extra = dict(running_mean_max_abs_err=mean_err, running_var_max_rel_err=var_rel,
                     stats_tensors=len(stats["cuda"]), stats_tolerances=STATS_TOL)
    emit(phase, batch=2, net_d=net_d, losses_cuda=l_gpu, loss_rel_err=loss_err, grads=worst,
         seg_pixels_across_half=flips, tolerances={"loss_rtol": LOSS_RTOL, "grad": GRAD_TOL},
         **extra)
    check(flips == 0, f"{phase}: card and CPU binarise {flips} fine-seg pixels differently")
    for k, e in loss_err.items():
        check(e <= LOSS_RTOL, f"{phase}: loss {k} rel err {e}")
    for net, w in worst.items():
        check(w["scale"] > 0, f"{phase}: {net} has no gradient")
        check(w["max_err_over_scale"] <= GRAD_TOL, f"{phase}: {net} gradient err {w}")
    if extra:
        check(extra["running_mean_max_abs_err"] <= STATS_TOL["mean_atol"]
              and extra["running_var_max_rel_err"] <= STATS_TOL["var_rtol"],
              f"{phase}: running statistics {extra}")


def phase_fwd_bf16(gen, cfg, batch_size=64, reps=5):
    batch = to_device(
        SyntheticDataset(batch_size=batch_size, seed=0, n_volumes=2).sample_batch(), "cuda"
    )
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        for _ in range(2):  # warm-up: cuDNN algorithm choice
            before = attention_v2.launches
            out = generator_forward(gen, batch, cfg)
            check(attention_v2.launches == before + 1, "bf16 forward: launches != 1")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            before = attention_v2.tc_launches
            out = generator_forward(gen, batch, cfg)
            check(attention_v2.tc_launches == before + 1, "bf16 forward: tensor-core launches != 1")
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    for key in ("fake_b", "fine_seg_bin", "pred2_h"):
        check(bool(torch.isfinite(out[key].float()).all()), f"bf16 forward: {key} not finite")
    check(out["fake_b"].dtype == torch.bfloat16, "bf16 forward left bf16")
    emit("fwd_bf16", batch=batch_size, reps=reps, ms_per_forward=dt / reps * 1e3,
         slices_per_s=batch_size * reps / dt,
         max_memory_allocated_bytes=torch.cuda.max_memory_allocated())
    return dt / reps * 1e3


def phase_profile_fwd(gen, cfg, batch_size=64):
    """The top ten device kernels of one bf16 forward at batch 64. It runs
    after train_bf16, so that the profiler is never on in the process before
    that phase's timed steps."""
    batch = to_device(
        SyntheticDataset(batch_size=batch_size, seed=0, n_volumes=2).sample_batch(), "cuda"
    )
    with torch.no_grad():
        top = top_kernels(lambda: generator_forward(gen, batch, cfg))
    emit("profile", of=f"one bf16 generator_forward at batch {batch_size}", **top)


def phase_synth3d(gen, cfg, vert_ids=(19, 20, 21), batch_size=64):
    ct, labels, cam = make_spine_volume(np.random.default_rng(0), fractured={20: 0.6})
    volumes = [(ct, labels, v, cam) for v in vert_ids]
    torch.cuda.synchronize()
    attention_v2.launches = attention_v2.tc_launches = 0
    infer3d._forward.dispatches = 0
    t0 = time.perf_counter()
    results = infer3d.synthesize_volumes(gen, cfg, volumes, batch_size=batch_size,
                                         use_bf16=True, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, dispatches = attention_v2.tc_launches, infer3d._forward.dispatches
    check(launches > 0, "main path launched the attention kernel no time")
    check(launches == dispatches == attention_v2.launches,
          f"tensor-core launches {launches}, all launches {attention_v2.launches}, "
          f"dispatches {dispatches}")
    labels_ok = {}
    for (ct_fake, lb_fake), v in zip(results, vert_ids):
        check(ct_fake.shape == ct.shape and lb_fake.shape == ct.shape, f"vertebra {v}: shape")
        check(bool(np.isfinite(ct_fake).all()), f"vertebra {v}: CT not finite")
        zs = np.nonzero((labels == v).any(axis=(0, 1)))[0]
        z_mid = int((zs.min() + zs.max()) // 2)
        labels_ok[v] = bool((lb_fake[:, :, z_mid] == v).any())
        check(labels_ok[v], f"vertebra {v}: label missing on its central slice {z_mid}")
    emit("synth3d", volume=list(ct.shape), vertebrae=list(vert_ids), batch=batch_size,
         wall_s=wall, dispatches=dispatches, launches=launches,
         target_label_on_central_slice=labels_ok)
    return launches


# the cli phase's cohort: eight patients of five vertebrae (256 x 256 x 64,
# the straightening pipeline's output), one fractured vertebra each; the
# train split holds patients 0-3, the test split patients 4-7
CLI_PATIENTS, CLI_VERTS = 8, (18, 19, 20, 21, 22)


def write_cli_cohort(root, patients=CLI_PATIENTS, phase_of=None, fracture_of=None, cams=True):
    """The cohort as NIfTI (CT uint8, labels int16, CAM float32 under CAM/
    with the _0 suffix when `cams`) and its vertebra_data.json. A patient's
    vertebrae share one volume, written once and copied. phase_of(p) names
    a patient's split (default: the first half train, the rest test);
    fracture_of(p) gives its fractured vertebra's (height ratio, grade)
    (default: 0.6, grade 2 or 3 by the patient's parity)."""
    import shutil
    from concurrent.futures import ThreadPoolExecutor

    from healthivert_tpu_torch.utils import nifti

    phase_of = phase_of or (lambda p: "train" if p < patients // 2 else "test")
    fracture_of = fracture_of or (lambda p: (0.6, 2 + p % 2))
    for d in ("CT", "label") + (("CAM",) if cams else ()):
        (root / d).mkdir(parents=True, exist_ok=True)
    split = {}

    def patient(p):
        frac = CLI_VERTS[1 + p % 3]
        ratio, grade = fracture_of(p)
        ct, labels, cam = make_spine_volume(np.random.default_rng(100 + p),
                                            fractured={frac: ratio})
        first = None
        for v in CLI_VERTS:
            names = [root / "CT" / f"p{p}_{v}.nii.gz", root / "label" / f"p{p}_{v}.nii.gz"]
            arrs = [ct.astype(np.uint8), labels.astype(np.int16)]
            if cams:
                names.append(root / "CAM" / f"p{p}_{v}_0.nii.gz")
                arrs.append(cam.astype(np.float32))
            if first is None:
                for arr, path in zip(arrs, names):
                    nifti.save(nifti.Nifti1Image(arr), path)
                first = names
            else:
                for a, b in zip(first, names):
                    shutil.copyfile(a, b)
        return {f"p{p}_{v}": (grade if v == frac else 0) for v in CLI_VERTS}

    with ThreadPoolExecutor(8) as pool:
        for p, grades in enumerate(pool.map(patient, range(patients))):
            split.setdefault(phase_of(p), {}).update(grades)
    (root / "vertebra_data.json").write_text(json.dumps(split))
    return split


def _counting_steps(train_loop, record, counter="tc_launches"):
    """Wrap the training loop's train_step so that each step records its
    launches on the route of `counter` (bf16: tc_launches, float32:
    tf32_launches) and the host clock, after a synchronise, before and
    after it."""
    step_fn = train_loop.train_step

    def wrapped(state, batch, lr, cfg):
        f0, b0 = getattr(attention_v2, counter), getattr(attention_v2_bwd, counter)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step_fn(state, batch, lr, cfg)
        torch.cuda.synchronize()
        record.append((getattr(attention_v2, counter) - f0, getattr(attention_v2_bwd, counter) - b0,
                       time.perf_counter(), int(batch["full"].shape[0]), t0))
        return out

    return wrapped


def in_scratch(phase):
    """Run `phase(tmp, quiet)`: tmp a new temporary directory, quiet a
    redirect of stdout into tmp/phase.log. The log's tail goes to stderr if
    the phase fails; the directory, with all the phase wrote there, is
    removed after it either way."""

    @functools.wraps(phase)
    def run():
        with tempfile.TemporaryDirectory(prefix=f"chip_smoke_{phase.__name__}_") as tmp:
            tmp = Path(tmp)
            with open(tmp / "phase.log", "a") as log:
                try:
                    return phase(tmp, contextlib.redirect_stdout(log))
                except Exception:
                    log.flush()
                    print((tmp / "phase.log").read_text()[-4000:], file=sys.stderr)
                    raise

    return run


def tf32_defaults():
    """PyTorch's own float32 settings, as a process has them before a CLI's
    main runs: cuDNN convolutions in TF32, CUDA matmuls in float32."""
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False


def check_exact(what):
    """The precision a CLI leaves: TF32 off (utils.device.float32_exact)."""
    check(torch.backends.cudnn.allow_tf32 is False
          and torch.backends.cuda.matmul.allow_tf32 is False, f"{what}: TF32 left on")


# bf16 and int8 forwards, card vs the port's CPU path, on a batch of 4 of
# the shipped weights at 256 x 256, one gate for both: each map's mean abs
# error, the binarised seg maps' disagreeing pixels (as a share), the
# height fractions. The largest error is reported, not gated: cuDNN's bf16
# convs, the elementwise kernels and the bf16 attention round otherwise
# than the CPU, the trained coarse CT head amplifies that, and under int8 an
# activation near a boundary of the int8 grid then quantizes one step apart
# (seen on an H100: bf16 x_stage1 mean 9.9e-3, max 0.115; int8 x_stage1
# mean 2.1e-2, x_stage2 max 0.29)
CARD_CPU_TOL = {"maps_mean": 2.5e-2, "seg_disagree": 1e-4, "pred_h": 1e-3}
INT8_CONVS = 43  # int8 convs of one generator forward (the 1-channel heads run bf16)
INT8_CLI_PATIENTS = 3


def int8_conv_shapes(gen):
    """{(C, H, W, O, k, stride, padding, dilation): convs} of the int8
    convs of one forward of `gen` at 256 x 256."""
    from healthivert_tpu_torch.models.layers import SNConv

    shapes, hooks = {}, []

    def record(mod, args):
        _, c, h, w = args[0].shape
        o, _, k, _ = mod.weight.shape
        key = (c, h, w, o, k, mod.stride, mod.padding, mod.dilation)
        shapes[key] = shapes.get(key, 0) + 1

    for m in gen.modules():
        if isinstance(m, SNConv) and m.weight.shape[0] >= 8:
            hooks.append(m.register_forward_pre_hook(record))
    x = torch.zeros((1, 256, 256, 1), device="cuda", dtype=torch.bfloat16)
    try:
        with torch.no_grad():
            gen(x, x, x, torch.zeros(1, device="cuda"))
    finally:
        for h in hooks:
            h.remove()
    return shapes


def int8_products(gen, batch=64, reps=10):
    """The card route of every distinct int8 conv shape at `batch`: bit-equal
    to the plain version on the card; its ms, its im2col's, cuDNN's bf16
    conv's."""
    g = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for (c, h, w, o, k, st, pd, dl), n in int8_conv_shapes(gen).items():
        qx = torch.randint(-127, 128, (batch, c, h, w), generator=g, device="cuda",
                           dtype=torch.int8).contiguous(memory_format=torch.channels_last)
        qw = torch.randint(-127, 128, (o, c, k, k), generator=g, device="cuda", dtype=torch.int8)
        got = ic.int8_conv2d(qx, qw, st, pd, dl)
        want = ic.int8_conv2d_reference(qx, qw, st, pd, dl)
        check(torch.equal(got, want), f"int8 product {(c, h, w, o, k, st, pd, dl)}: card route "
                                      "differs from its plain version")
        del got, want
        kp = ic._round_up(k * k * c, 8)
        xb = qx.to(torch.bfloat16)
        wb = qw.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
        fns = {"ms": lambda: ic.int8_conv2d_im2col(qx, qw, st, pd, dl),
               "im2col_ms": lambda: ic.im2col(qx, k, st, pd, dl, kp),
               "cudnn_bf16_ms": lambda: torch.nn.functional.conv2d(xb, wb, None, st, pd, dl)}
        for fn in fns.values():
            fn()
        times = {name: time_events(fn, reps) for name, fn in fns.items()}
        rows.append(dict(c=c, h=h, w=w, o=o, k=k, stride=st, padding=pd, dilation=dl, convs=n,
                         im2col_bytes=batch * ic.out_size(h, k, st, pd, dl)
                         * ic.out_size(w, k, st, pd, dl) * kp,
                         im2col_share=times["im2col_ms"] / times["ms"], **times))
        del qx, qw, xb, wb
    return rows


def _iou(a, b):
    a, b = a > 0.5, b > 0.5
    return float((a & b).sum()) / max(1, int((a | b).sum()))


def phase_int8(gen_bf16, cfg_bf16, bf16_ms, batch_size=64, reps=5):
    """int8 inference: the product at every shape, the forward (dynamic and
    static scales) with its gates, and the 3D synthesis through the scale
    store; then the CLIs (phase_int8_cli)."""
    from healthivert_tpu_torch.models.pix2pix import INT8_CALIB_PERCENTILE, calibrate_int8

    t_phase = time.perf_counter()
    float32_exact()
    cfg = Pix2PixConfig(ngf=16, image_size=256, compute_dtype="int8")
    gen = load_generator(PRETRAINED_NPZ, cfg, device="cuda")
    products = int8_products(gen, batch_size)
    per_forward = {k: sum(r[k] * r["convs"] for r in products)
                   for k in ("ms", "im2col_ms", "cudnn_bf16_ms")}

    host = SyntheticDataset(batch_size=batch_size, seed=0, n_volumes=2).sample_batch()
    batch = to_device(host, "cuda")
    t0 = time.perf_counter()
    quant = calibrate_int8(gen, [batch], cfg, percentile=INT8_CALIB_PERCENTILE)
    torch.cuda.synchronize()
    calib_ms = (time.perf_counter() - t0) * 1e3
    check(len(quant) == INT8_CONVS, f"int8: {len(quant)} calibrated convs")
    fwd = {}
    with torch.no_grad():
        for mode, q in (("dynamic", None), ("static", quant)):
            for _ in range(2):  # warm-up
                generator_forward(gen, batch, cfg, g_quant=q)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            a0, c0 = attention_v2.tc_launches, ic.int8_conv2d.launches
            t0 = time.perf_counter()
            for _ in range(reps):
                out = generator_forward(gen, batch, cfg, g_quant=q)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            check(attention_v2.tc_launches - a0 == reps,
                  f"int8 {mode} forward: {attention_v2.tc_launches - a0} tensor-core attention "
                  f"launches for {reps} forwards")
            check(ic.int8_conv2d.launches - c0 == INT8_CONVS * reps,
                  f"int8 {mode} forward: {ic.int8_conv2d.launches - c0} int8 convs")
            for key in ("fake_b", "fine_seg_bin", "pred2_h"):
                check(bool(torch.isfinite(out[key].float()).all()), f"int8 {mode}: {key} not finite")
            fwd[mode] = dict(ms_per_forward=dt / reps * 1e3, slices_per_s=batch_size * reps / dt,
                             max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
                             out=out)
        ref = generator_forward(gen_bf16, batch, cfg_bf16)
    vs_bf16 = {mode: dict(
        mean_abs_dx_stage2=float((f["out"]["gen"].x_stage2.float()
                                  - ref["gen"].x_stage2.float()).abs().mean()),
        fine_seg_iou=_iou(f["out"]["gen"].fine_seg, ref["gen"].fine_seg))
        for mode, f in fwd.items()}
    for f in fwd.values():
        del f["out"]
    del ref, out

    # card vs the port's CPU path on a batch of 4, bf16 and int8 with the
    # same scales on both
    small = {k: v[:4] for k, v in host.items()}
    card_cpu = {}
    for mode, g, c, q in (("bf16", gen_bf16, cfg_bf16, None), ("int8_dynamic", gen, cfg, None),
                          ("int8_static", gen, cfg, quant)):
        card_cpu[mode] = card_vs_cpu(g, c, small, q)
    del small
    synth = int8_synth3d(gen, cfg, batch_size)
    cli = phase_int8_cli()
    emit("int8", batch=batch_size, convs_per_forward=INT8_CONVS,
         products=products, per_forward_ms=per_forward,
         im2col_share=per_forward["im2col_ms"] / per_forward["ms"],
         int8_convs_vs_cudnn_bf16=per_forward["ms"] / per_forward["cudnn_bf16_ms"],
         calibrate_ms=calib_ms, forward=fwd, fwd_bf16_ms=bf16_ms,
         int8_over_bf16={m: f["ms_per_forward"] / bf16_ms for m, f in fwd.items()},
         card_vs_cpu_batch4=card_cpu, tolerances=CARD_CPU_TOL, vs_bf16_not_gated=vs_bf16,
         synth3d=synth, cli=cli, phase_s=time.perf_counter() - t_phase)


def card_vs_cpu(gen, cfg, host, quant=None):
    """The forward of `gen` on the card against the same weights on the
    CPU, on the numpy batch `host`, under CARD_CPU_TOL."""
    cpu = load_generator(PRETRAINED_NPZ, cfg, device="cpu")
    with torch.no_grad():
        got = generator_forward(gen, to_device(host, "cuda"), cfg, g_quant=quant)
        want = generator_forward(cpu, to_device(host, "cpu"), cfg,
                                 g_quant=None if quant is None else
                                 {k: v.cpu() for k, v in quant.items()})
    what = f"{cfg.compute_dtype}{'' if quant is None else ' static'} card vs CPU"
    errs = {}
    for name in ("coarse_seg", "fine_seg", "x_stage1", "x_stage2"):
        a, b = getattr(got["gen"], name).float().cpu(), getattr(want["gen"], name).float()
        e = (a - b).abs()
        errs[name] = {"mean": float(e.mean()), "max": float(e.max()),
                      "pixels_over_3e-2": int((e > 3e-2).sum())}
        check(errs[name]["mean"] <= CARD_CPU_TOL["maps_mean"], f"{what} {name}: {errs[name]}")
        if "seg" in name:
            errs[name]["disagree"] = float(((a > 0.5) != (b > 0.5)).float().mean())
            check(errs[name]["disagree"] <= CARD_CPU_TOL["seg_disagree"],
                  f"{what} {name}: {errs[name]}")
    for name in ("pred1_h", "pred2_h"):
        errs[name] = max_err(getattr(got["gen"], name), getattr(want["gen"], name))
        check(errs[name] <= CARD_CPU_TOL["pred_h"], f"{what} {name}: {errs[name]}")
    return errs


def int8_synth3d(gen, cfg, batch_size, vert_ids=(19, 20, 21)):
    """synthesize_volumes(quant="auto") at batch_size writing the scale
    store, then at batch 16 reading it: bit-equal volumes."""
    ct, labels, cam = make_spine_volume(np.random.default_rng(0), fractured={20: 0.6})
    volumes = [(ct, labels, v, cam) for v in vert_ids]
    runs = []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_int8_") as tmp:
        store = Path(tmp) / "int8_quant.pt"
        for b in (batch_size, 16):
            attention_v2.launches = attention_v2.tc_launches = 0
            infer3d._forward.dispatches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = infer3d.synthesize_volumes(gen, cfg, volumes, batch_size=b, quant="auto",
                                             quant_store=str(store), device="cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches, dispatches = attention_v2.tc_launches, infer3d._forward.dispatches
            check(launches > 0 and launches == dispatches == attention_v2.launches,
                  f"int8 synthesis at batch {b}: tensor-core launches {launches}, all "
                  f"{attention_v2.launches}, dispatches {dispatches}")
            check(store.is_file(), "int8 synthesis wrote no scale store")
            runs.append(dict(batch=b, wall_s=wall, dispatches=dispatches, launches=launches,
                             store_mtime_ns=store.stat().st_mtime_ns, results=res))
    first, second = runs
    check(first["store_mtime_ns"] == second["store_mtime_ns"], "int8 store rewritten")
    for (a_ct, a_lb), (b_ct, b_lb), v in zip(first["results"], second["results"], vert_ids):
        check(np.array_equal(a_ct, b_ct) and np.array_equal(a_lb, b_lb),
              f"int8 synthesis: vertebra {v} differs between batch {batch_size} and 16")
        check(bool(np.isfinite(a_ct).all()), f"int8 synthesis: vertebra {v} not finite")
    return [{k: r[k] for k in ("batch", "wall_s", "dispatches", "launches")} for r in runs]


@in_scratch
def phase_int8_cli(tmp, quiet):
    """The 3D CLI at --compute_dtype int8 (shipped weights, --slice_batch
    64, static scales through the store) on INT8_CLI_PATIENTS patients and
    the test CLI at int8 on 4 images, each with PyTorch's TF32 defaults
    before it and the counts set to 0 just before it and read just after."""
    from healthivert_tpu_torch.cli import eval_3d_sagittal_twostage as e3_cli
    from healthivert_tpu_torch.cli import test as test_cli
    from healthivert_tpu_torch.utils import nifti

    data = tmp / "cohort"
    write_cli_cohort(data, patients=INT8_CLI_PATIENTS)
    common = ["--dataroot", str(data), "--cam_dir", str(data / "CAM"), "--checkpoints_dir",
              str(tmp / "ck"), "--load_npz", str(PRETRAINED_NPZ), "--compute_dtype", "int8"]
    attention_v2.launches = attention_v2.tc_launches = 0
    infer3d._forward.dispatches = 0
    ic.int8_conv2d.launches = 0
    tf32_defaults()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with quiet:
        stats = e3_cli.main(common + ["--name", "e3", "--results_dir", str(tmp / "out3d"),
                                      "--slice_batch", "64"])
    torch.cuda.synchronize()
    e3_wall = time.perf_counter() - t0
    check_exact("int8 3D CLI")
    launches, dispatches = attention_v2.tc_launches, infer3d._forward.dispatches
    check(launches > 0 and launches == dispatches == attention_v2.launches
          and ic.int8_conv2d.launches == INT8_CONVS * dispatches,
          f"int8 3D CLI: tensor-core launches {launches}, dispatches {dispatches}, int8 convs "
          f"{ic.int8_conv2d.launches}")
    check((tmp / "ck" / "e3" / "int8_quant.pt").is_file(), "int8 3D CLI wrote no scale store")
    check(len(stats["patients"]) == INT8_CLI_PATIENTS, f"int8 3D CLI: {stats['patients']}")
    for f in sorted((tmp / "out3d" / "CT_fake").iterdir()):
        check(bool(np.isfinite(nifti.load(f).data).all()), f"int8 3D CLI {f.name}: not finite")

    attention_v2.launches = attention_v2.tc_launches = 0
    ic.int8_conv2d.launches = 0
    tf32_defaults()
    t0 = time.perf_counter()
    with quiet:
        test_cli.main(common + ["--name", "t8", "--results_dir", str(tmp / "res"),
                                "--num_test", "4"])
    torch.cuda.synchronize()
    test_wall = time.perf_counter() - t0
    check_exact("int8 test CLI")
    # four images and the calibration forward on the first
    check(attention_v2.tc_launches == attention_v2.launches == 5
          and ic.int8_conv2d.launches == 5 * INT8_CONVS,
          f"int8 test CLI: {attention_v2.tc_launches} attention launches, "
          f"{ic.int8_conv2d.launches} int8 convs")
    pngs = list((tmp / "res" / "t8" / "test_latest" / "images").glob("*.png"))
    check(len(pngs) == 4 * 7, f"int8 test CLI: {len(pngs)} PNGs")
    return dict(eval_3d=dict(patients=INT8_CLI_PATIENTS, vertebrae=len(CLI_VERTS), wall_s=e3_wall,
                             patient_s=stats["patients"], dispatches=dispatches,
                             launches=launches),
                test=dict(images=4, wall_s=test_wall, launches=attention_v2.tc_launches))


# the train CLI at its default dtype, float32: steps, and the --profile_steps
# window whose trace must hold a kernel record for every launch
F32_CLI_STEPS, F32_CLI_PROFILE = 10, (7, 9)


@in_scratch
def phase_cli(tmp, quiet):
    """The port's three CLIs on a straightened cohort written as NIfTI: 3D
    synthesis on every patient (shipped weights through --load_npz, bf16,
    --slice_batch 64) bit-equal to synthesize_volumes called directly; the
    train CLI on the shipped recipe's flags (batch 32, bf16) for 4 steps with
    a checkpoint at step 2, evaluated every epoch, then resumed from that
    checkpoint for 2 more steps; the train CLI at its default dtype, float32,
    for F32_CLI_STEPS steps with a --profile_steps window, whose trace holds
    a kernel record for every launch; the test CLI's gallery of 4 images on
    the run's latest checkpoint. Each CLI runs with the counts set to 0 just
    before it and read just after, and with PyTorch's TF32 defaults before
    it: each must leave float32 exact."""
    from healthivert_tpu_torch.cli import eval_3d_sagittal_twostage as e3_cli
    from healthivert_tpu_torch.cli import test as test_cli
    from healthivert_tpu_torch.cli import train as train_cli
    from healthivert_tpu_torch.data.aligned import AlignedDataset
    from healthivert_tpu_torch.engine import train_loop
    from healthivert_tpu_torch.engine.train_loop import trace_kernel_records
    from healthivert_tpu_torch.engine.visualizer import read_png
    from healthivert_tpu_torch.utils import nifti

    t_phase = time.perf_counter()
    data = tmp / "cohort"
    t0 = time.perf_counter()
    split = write_cli_cohort(data)
    write_s = time.perf_counter() - t0

    # 3D synthesis CLI
    for fn in (attention_v2, attention_v2_bwd):
        fn.launches = fn.tc_launches = fn.tf32_launches = 0
    infer3d._forward.dispatches = 0
    tf32_defaults()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with quiet:
        stats = e3_cli.main(["--dataroot", str(data), "--name", "e3", "--checkpoints_dir",
                             str(tmp / "ck"), "--results_dir", str(tmp / "out3d"),
                             "--load_npz", str(PRETRAINED_NPZ), "--slice_batch", "64",
                             "--cam_dir", str(data / "CAM")])
    torch.cuda.synchronize()
    e3_wall = time.perf_counter() - t0
    check_exact("3D CLI")
    launches, dispatches = attention_v2.tc_launches, infer3d._forward.dispatches
    check(launches > 0 and launches == dispatches == attention_v2.launches,
          f"3D CLI: tensor-core launches {launches}, all {attention_v2.launches}, "
          f"dispatches {dispatches}")
    check(len(stats["patients"]) == CLI_PATIENTS, f"3D CLI: {len(stats['patients'])} patients")
    cfg = Pix2PixConfig(ngf=16, image_size=256, compute_dtype="bfloat16")
    gen = load_generator(PRETRAINED_NPZ, cfg, device="cuda")
    for p in range(CLI_PATIENTS):
        names = [f"p{p}_{v}.nii.gz" for v in CLI_VERTS]
        imgs = [nifti.load(data / "CT" / n) for n in names]
        vols = [(img.get_fdata(), nifti.load(data / "label" / n).get_fdata(), v,
                 nifti.load(data / "CAM" / n.replace(".nii", "_0.nii")).get_fdata()
                 .astype(np.float32)) for img, n, v in zip(imgs, names, CLI_VERTS)]
        direct = infer3d.synthesize_volumes(gen, cfg, vols, batch_size=64, use_bf16=True,
                                            device="cuda")
        for n, img, (ct_d, lb_d) in zip(names, imgs, direct):
            for sub, want in (("CT_fake", ct_d), ("label_fake", lb_d)):
                out = nifti.load(tmp / "out3d" / sub / n)
                check(out.data.shape == img.data.shape and np.array_equal(out.affine, img.affine),
                      f"3D CLI {sub}/{n}: shape or affine")
                check(bool(np.isfinite(out.data).all()), f"3D CLI {sub}/{n}: not finite")
                check(np.array_equal(out.data, want.astype(np.float32)),
                      f"3D CLI {sub}/{n}: differs from synthesize_volumes")
    del gen

    # train CLI on the recipe's flags, 4 steps, a checkpoint at step 2
    recipe = read_recipe()
    flags = ["--dataroot", str(data), "--cam_dir", str(data / "CAM"), "--name", "smoke",
             "--checkpoints_dir", str(tmp / "ck"), "--batch_size", str(recipe.batch_size),
             "--compute_dtype", recipe.compute_dtype, "--seed", str(recipe.seed),
             "--direction", recipe.direction, "--print_freq", str(recipe.batch_size),
             "--display_freq", str(recipe.display_freq), "--save_epoch_freq", "100",
             "--save_latest_freq", str(2 * recipe.batch_size), "--save_by_iter",
             "--eval_freq", "1", "--max_steps", "4"]
    record = []
    orig = train_loop.train_step
    train_loop.train_step = _counting_steps(train_loop, record)
    try:
        for fn in (attention_v2, attention_v2_bwd):
            fn.launches = fn.tc_launches = fn.tf32_launches = 0
        tf32_defaults()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with quiet:
            state, tcfg = train_cli.main(flags)
        torch.cuda.synchronize()
        train_wall = time.perf_counter() - t0
        check_exact("train CLI")
        fwd_all, bwd_all = attention_v2.tc_launches, attention_v2_bwd.tc_launches
        first = list(record)
        record.clear()
        tf32_defaults()
        with quiet:
            resumed, _ = train_cli.main(flags + ["--continue_train", "--load_iter",
                                                 str(2 * recipe.batch_size)])
        check_exact("train CLI, resumed")
        resumed_steps = list(record)
    finally:
        train_loop.train_step = orig

    # the train CLI at its default dtype (float32) with a profiled window
    f32_flags = ["--dataroot", str(data), "--cam_dir", str(data / "CAM"),
                 "--checkpoints_dir", str(tmp / "ck"), "--batch_size", str(recipe.batch_size),
                 "--seed", str(recipe.seed), "--direction", recipe.direction,
                 "--print_freq", str(recipe.batch_size), "--display_freq", "0",
                 "--save_epoch_freq", "1000", "--save_latest_freq", "1000000",
                 "--eval_freq", "1000", "--max_steps", str(F32_CLI_STEPS),
                 "--profile_steps", ",".join(map(str, F32_CLI_PROFILE))]
    f32_record = []
    train_loop.train_step = _counting_steps(train_loop, f32_record, "tf32_launches")
    try:
        for fn in (attention_v2, attention_v2_bwd):
            fn.launches = fn.tc_launches = fn.tf32_launches = 0
        tf32_defaults()
        with quiet:
            f32_state, f32_cfg = train_cli.main(f32_flags + ["--name", "smoke_f32"])
        check_exact("float32 train CLI")
    finally:
        train_loop.train_step = orig
    check(f32_cfg.compute_dtype == "float32" and f32_state.step == F32_CLI_STEPS
          and [r[:2] for r in f32_record] == [(1, 1)] * F32_CLI_STEPS,
          f"float32 train CLI: dtype {f32_cfg.compute_dtype}, steps {f32_state.step}, "
          f"float32-route launches per step {[r[:2] for r in f32_record]}")
    # the trace of that window, in this process after the earlier phases'
    # profiler sessions; then the same CLI as a user starts it, in a process
    # of its own, whose trace must hold every kernel's record
    in_process = trace_kernel_records(tmp / "ck" / "smoke_f32" / "profile" / "trace.json")
    t0 = time.perf_counter()
    with open(tmp / "train_f32_process.log", "w") as log:
        subprocess.run([sys.executable, "-m", "healthivert_tpu_torch.cli.train", *f32_flags,
                        "--name", "smoke_f32_process"], stdout=log, stderr=subprocess.STDOUT,
                       cwd=Path(__file__).resolve().parent, timeout=600, check=True)
    process_s = time.perf_counter() - t0
    trace_launches, trace_lost = trace_kernel_records(
        tmp / "ck" / "smoke_f32_process" / "profile" / "trace.json")
    check(trace_launches > 0 and trace_lost == 0,
          f"float32 train CLI --profile_steps trace: {trace_lost} of {trace_launches} "
          "kernel launches without a kernel record")
    f32_step_ms = [(r[2] - r[4]) * 1e3 for r in f32_record]
    # the steps before the profiled window, less the first
    f32_timed = f32_step_ms[1:F32_CLI_PROFILE[0]]
    run_dir = tmp / "ck" / "smoke"
    check(tcfg.compute_dtype == "bfloat16" and state.step == 4, f"train CLI: {state.step} steps")
    check([r[:2] for r in first] == [(1, 1)] * 4 and [r[3] for r in first] == [32] * 4,
          f"train CLI: launches and batch per step {[(r[0], r[1], r[3]) for r in first]}")
    check(bwd_all == 4 and fwd_all >= 4, f"train CLI: launches {fwd_all}, {bwd_all}")
    check(resumed.step == 4 and [r[:2] for r in resumed_steps] == [(1, 1)] * 2,
          f"resume: step {resumed.step}, steps run {len(resumed_steps)}")
    for tag in ("iter_64", "iter_128", "latest", "4"):
        check((run_dir / f"{tag}.pt").is_file(), f"train CLI: checkpoint {tag}.pt missing")
    recs = [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]
    evals = [r for r in recs if r["tag"] == "eval"]
    losses = [r for r in recs if r["tag"] == "train"]
    check(len(evals) == 6 and all(np.isfinite([r[k] for k in ("ssim", "psnr", "dice", "iou")]).all()
                                  for r in evals), f"train CLI: eval records {evals}")
    check(len(losses) == 6 and all(np.isfinite([v for k, v in r.items() if k not in
                                                ("tag", "step", "time")]).all() for r in losses),
          "train CLI: non-finite or missing losses")
    step_ms = [(r[2] - r[4]) * 1e3 for r in first]
    # between one step's end and the next one's start: the next epoch's
    # batch (its loader), the epoch's evaluation and checkpoints
    gap_ms = [(b[4] - a[2]) * 1e3 for a, b in zip(first, first[1:])]
    opt = types.SimpleNamespace(batch_size=recipe.batch_size, seed=recipe.seed,
                                dataroot=str(data), phase="train", vert_class="normal",
                                num_threads=recipe.num_threads, serial_batches=False,
                                cam_dir=str(data / "CAM"), data_cache_gb=4.0)
    loader = AlignedDataset(opt)
    rates = []
    for _ in range(2):  # cold, then from the volume cache
        t0 = time.perf_counter()
        n = sum(len(b["full"]) for b in loader)
        rates.append(n / (time.perf_counter() - t0))

    # test CLI on the run's latest checkpoint
    for fn in (attention_v2, attention_v2_bwd):
        fn.launches = fn.tc_launches = fn.tf32_launches = 0
    tf32_defaults()
    t0 = time.perf_counter()
    with quiet:
        test_cli.main(["--dataroot", str(data), "--cam_dir", str(data / "CAM"), "--name", "smoke",
                       "--checkpoints_dir", str(tmp / "ck"), "--results_dir", str(tmp / "res"),
                       "--num_test", "4"])
    torch.cuda.synchronize()
    test_wall = time.perf_counter() - t0
    check_exact("test CLI")
    check(attention_v2.tc_launches == attention_v2.launches == 4,
          f"test CLI: {attention_v2.tc_launches} tensor-core launches for 4 images")
    web = tmp / "res" / "smoke" / "test_latest"
    html = (web / "index.html").read_text()
    pngs = sorted((web / "images").glob("*.png"))
    check(len(pngs) == 4 * 7 and all(p.name in html for p in pngs),
          f"test CLI: {len(pngs)} PNGs")
    check(sum("offset_flow" in p.name for p in pngs) == 4, "test CLI: offset_flow missing")
    for p in pngs:
        img = read_png(p)
        check(img.shape[:2] == (256, 256), f"test CLI: {p.name} {img.shape}")
    emit("cli", cohort=dict(patients=CLI_PATIENTS, vertebrae=len(CLI_VERTS) * CLI_PATIENTS,
                            volume=[256, 256, 64], train=len(split["train"]),
                            test=len(split["test"]), write_s=write_s),
         eval_3d=dict(wall_s=e3_wall, patient_s=stats["patients"], total_s=stats["total_s"],
                      io_read_s=stats["io_read_s"], io_write_thread_s=stats["io_write_s"],
                      io_read_share=stats["io_read_s"] / stats["total_s"],
                      dispatches=dispatches, launches=launches),
         train=dict(wall_s=train_wall, steps=4, batch=recipe.batch_size,
                    step_ms=step_ms, between_steps_ms=gap_ms,
                    ms_per_step_with_data=(first[-1][2] - first[0][4]) * 1e3 / len(first),
                    fwd_launches=fwd_all, bwd_launches=bwd_all,
                    loader_examples_per_s_cold_cached=rates,
                    eval=[{k: r[k] for k in ("step", "ssim", "psnr", "dice", "iou", "diff_h")}
                          for r in evals[:4]],
                    resumed_at=2, resumed_to=resumed.step),
         train_f32=dict(steps=F32_CLI_STEPS, batch=recipe.batch_size, precision="float32_exact",
                        step_ms=f32_step_ms, timed_steps=[2, F32_CLI_PROFILE[0]],
                        ms_per_step_timed=float(np.mean(f32_timed)),
                        profile_steps=list(F32_CLI_PROFILE),
                        trace_in_process_launches_without_record=list(in_process),
                        process_wall_s=process_s, trace_kernel_launches=trace_launches,
                        trace_launches_without_kernel_record=trace_lost),
         test=dict(wall_s=test_wall, images=4, pngs=len(pngs),
                   launches=attention_v2.tc_launches),
         phase_s=time.perf_counter() - t_phase)


# the classifier CLI's training steps in phases hgam and grade, cut from its
# default of 500; its other flags stay at their defaults (width 32, batch
# 16, band 128, z_context 2, lr 1e-3)
HGAM_STEPS = 60
# Grad-CAM++ on the card against the port's CPU path, TF32 off
CAM_TOL = 1e-4


@in_scratch
def phase_hgam(tmp, quiet):
    """The classifier CLI on the cli phase's cohort (8 patients x 5
    vertebrae): `train` for HGAM_STEPS steps, then `generate` for every
    vertebra; finite losses, every CAM volume finite and in [0, 1]; each CAM
    volume that `generate` wrote on the card held to Grad-CAM++ on the
    port's CPU path from the same checkpoint, pasted at the vertebra's band
    rows and slices, and its class to the CPU's vote."""
    from healthivert_tpu_torch.cli import grad_cam_3d_sagittal as gc
    from healthivert_tpu_torch.engine.checkpoint import restore_classifier
    from healthivert_tpu_torch.models.hgam import grad_cam_pp
    from healthivert_tpu_torch.utils import nifti

    t_phase = time.perf_counter()
    data = tmp / "cohort"
    write_cli_cohort(data, cams=False)
    flags = ["--dataroot", str(data), "--split", str(data / "vertebra_data.json")]
    train_flags = ["train", *flags, "--out", str(tmp / "cls"), "--steps", str(HGAM_STEPS)]
    args = gc.parse_args(train_flags)
    tf32_defaults()
    t0 = time.perf_counter()
    with quiet:
        stats = gc.main(train_flags)
    train_wall = time.perf_counter() - t0
    check_exact("classifier CLI train")
    check(len(stats["loss"]) == HGAM_STEPS and np.isfinite(stats["loss"]).all(),
          f"hgam: losses {stats['loss'][:3]}...")
    tf32_defaults()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with quiet:
        gen = gc.main(["generate", *flags, "--ckpt", str(tmp / "cls"), "--out", str(tmp / "cam")])
    gen_wall = time.perf_counter() - t0
    check_exact("classifier CLI generate")
    n_verts = CLI_PATIENTS * len(CLI_VERTS)
    check(len(gen["classes"]) == n_verts, f"hgam: {len(gen['classes'])} CAM volumes")

    cpu = gc.new_classifier(2 * args.z_context + 1, args.seed, "cpu")
    restore_classifier(cpu, tmp / "cls")
    cpu.eval()
    cache = gc.VolumeCache(args.dataroot)
    cam_err, slices = 0.0, 0
    for pv, cls in gen["classes"].items():
        vol = nifti.load(tmp / "cam" / f"{pv}_{cls}.nii.gz").data
        check(bool(np.isfinite(vol).all()) and vol.min() >= 0 and vol.max() <= 1 + 1e-6,
              f"hgam: CAM {pv} not finite or out of [0, 1]")
        sl, idx, r0, _, _ = gc._vert_slices(args, cache, pv)
        x = torch.from_numpy(sl)
        cams = grad_cam_pp(cpu, x).numpy()
        ref = np.zeros_like(vol)
        for k, z in enumerate(idx):
            ref[r0:r0 + cams.shape[1], :, z] = cams[k, :, :, 0]
        cam_err = max(cam_err, float(np.abs(vol - ref).max()))
        vote_cpu = int(gc.slice_preds(cpu, x).mean() > 0.5)
        check(vote_cpu == cls, f"hgam: {pv} votes {cls} on the card, {vote_cpu} on the CPU")
        slices += len(sl)
    check(cam_err <= CAM_TOL, f"hgam: Grad-CAM++ card vs CPU {cam_err:.3g} > {CAM_TOL}")
    emit("hgam", cohort=dict(patients=CLI_PATIENTS, vertebrae=n_verts, volume=[256, 256, 64]),
         flags=dict(steps=args.steps, batch=args.batch, band=args.band,
                    z_context=args.z_context, lr=args.lr, width=32),
         train=dict(wall_s=train_wall,
                    step_ms_mean=1e3 * float(np.mean(np.add(stats["host_s"], stats["device_s"]))),
                    host_ms_median=1e3 * float(np.median(stats["host_s"])),
                    device_ms_median=1e3 * float(np.median(stats["device_s"])),
                    host_ms_first=1e3 * stats["host_s"][0],
                    loss_first_last=[stats["loss"][0], stats["loss"][-1]],
                    vote_accuracy=stats["vote_accuracy"]),
         generate=dict(wall_s=gen_wall, s_per_vertebra=gen_wall / n_verts,
                       s_per_vertebra_median=float(np.median(list(gen["seconds"].values()))),
                       fractured_votes=sum(gen["classes"].values()), slices=slices),
         cam_max_abs_err_card_vs_cpu=cam_err, votes_equal=True,
         phase_s=time.perf_counter() - t_phase)


# the grade phase's cohort: 13 patients of five vertebrae, one fractured
# each (height ratio 0.7, grade 2, for even patients; 0.5, grade 3, for odd
# ones), patients 0-5 train, 6-9 test, 10-12 val (cut from 10-14: with five
# val patients the phase took 132 s on an H100, over its ~120 s)
GRADE_PATIENTS = 13
GRADE_RTOL = 1e-4  # generation metrics, card vs --gpu_ids -1


def grade_phase_of(p):
    return "train" if p < 6 else ("test" if p < 10 else "val")


@in_scratch
def phase_grade(tmp, quiet):
    """The grading chain through the user's CLIs on a cohort with train,
    test and val splits: the classifier CLI (train, generate), the 3D CLI on
    its CAMs (shipped generator, bf16, batch 64; bf16 tensor-core launches
    equal to its dispatches), generation_eval_sagittal on the val split on
    the card and with --gpu_ids -1 (every average within GRADE_RTOL),
    rhlv_quantification sagittal and coronal, svm_grading and
    svm_grading_2_5d; every report present and finite."""
    from healthivert_tpu_torch.cli import eval_3d_sagittal_twostage as e3_cli
    from healthivert_tpu_torch.cli import (
        generation_eval_sagittal,
        grad_cam_3d_sagittal,
        rhlv_quantification,
        rhlv_quantification_coronal,
        svm_grading,
        svm_grading_2_5d,
    )

    t_phase = time.perf_counter()
    data = tmp / "cohort"
    t0 = time.perf_counter()
    split = write_cli_cohort(data, GRADE_PATIENTS, grade_phase_of,
                             lambda p: (0.7, 2) if p % 2 == 0 else (0.5, 3), cams=False)
    wall = {"write": time.perf_counter() - t0}
    split_file = str(data / "vertebra_data.json")

    def stage(name, fn, *argv):
        tf32_defaults()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with quiet:
            out = fn(list(argv))
        torch.cuda.synchronize()
        wall[name] = time.perf_counter() - t0
        check_exact(f"grade: {name}")
        return out

    cls_flags = ["--dataroot", str(data), "--split", split_file]
    stage("classifier_train", grad_cam_3d_sagittal.main, "train", *cls_flags,
          "--out", str(tmp / "cls"), "--steps", str(HGAM_STEPS))
    gen = stage("classifier_generate", grad_cam_3d_sagittal.main, "generate", *cls_flags,
                "--ckpt", str(tmp / "cls"), "--out", str(tmp / "cam"))
    n_verts = GRADE_PATIENTS * len(CLI_VERTS)
    check(len(gen["classes"]) == n_verts, f"grade: {len(gen['classes'])} CAM volumes")

    for fn in (attention_v2, attention_v2_bwd):
        fn.launches = fn.tc_launches = fn.tf32_launches = 0
    infer3d._forward.dispatches = 0
    out3d = tmp / "output_3d"
    stats = stage("eval_3d", e3_cli.main, "--dataroot", str(data), "--name", "grade",
                  "--checkpoints_dir", str(tmp / "ck"), "--results_dir", str(out3d / "healthivert"),
                  "--load_npz", str(PRETRAINED_NPZ), "--slice_batch", "64",
                  "--cam_dir", str(tmp / "cam"))
    launches, dispatches = attention_v2.tc_launches, infer3d._forward.dispatches
    check(launches > 0 and launches == dispatches == attention_v2.launches,
          f"grade 3D CLI: tensor-core launches {launches}, all {attention_v2.launches}, "
          f"dispatches {dispatches}")
    check(len(stats["patients"]) == GRADE_PATIENTS, f"grade 3D CLI: {len(stats['patients'])}")

    geneval = ["--split", split_file, "--phase", "val", "--ct_folder", str(data / "CT"),
               "--label_folder", str(data / "label"), "--output_folder", str(out3d)]
    card = stage("generation_eval_card", generation_eval_sagittal.main, *geneval,
                 "--result_folder", str(tmp / "geneval_card"))
    cpu = stage("generation_eval_cpu", generation_eval_sagittal.main, *geneval,
                "--result_folder", str(tmp / "geneval_cpu"), "--gpu_ids", "-1")
    (card_avg,), (cpu_avg,) = card.values(), cpu.values()
    check(card_avg["count"] == cpu_avg["count"] > 0, f"grade: generation counts {card_avg}")
    gen_err = max(abs(card_avg[k] - cpu_avg[k]) / max(abs(cpu_avg[k]), 1e-30) for k in cpu_avg)
    check(gen_err <= GRADE_RTOL and all(np.isfinite(v) for v in card_avg.values()),
          f"grade: generation metrics card vs CPU rel {gen_err:.3g}")

    rhlv = ["--split", split_file, "--label_folder", str(data / "label"),
            "--output_folder", str(out3d)]
    sag = stage("rhlv_sagittal", rhlv_quantification.main, *rhlv,
                "--result_folder", str(tmp / "rhlv_sag"))
    cor = stage("rhlv_coronal", rhlv_quantification_coronal.main, *rhlv,
                "--result_folder", str(tmp / "rhlv_cor"))
    for tables in (sag, cor):
        (rows,) = tables.values()
        check(len(rows) == n_verts and all(np.isfinite(list(r.values())[3:]).all() for r in rows),
              f"grade: RHLV rows {len(rows)}")
    grades = stage("svm_grading", svm_grading.main, "--result_folder", str(tmp / "rhlv_sag"),
                   "--grading_folder", str(tmp / "grades"))
    (report, summary), = grades.items()
    g25 = stage("svm_grading_2_5d", svm_grading_2_5d.main, "--sagittal", next(iter(sag)),
                "--coronal", next(iter(cor)), "--output", str(tmp / "grades_25d.txt"))
    for path, summ in ((report, summary), (str(tmp / "grades_25d.txt"), g25)):
        check(Path(path).is_file() and Path(path).read_text().startswith("Fold 1:"),
              f"grade: report {path}")
        check(all(np.isfinite([v["mean"], v["var"]]).all() for v in summ.values()),
              f"grade: report {path} not finite")
    emit("grade", cohort=dict(patients=GRADE_PATIENTS, vertebrae=n_verts,
                              volume=[256, 256, 64], **{k: len(v) for k, v in split.items()}),
         wall_s=wall, eval_3d=dict(dispatches=dispatches, launches=launches,
                                   patient_s=stats["patients"]),
         classifier_fractured_votes=sum(gen["classes"].values()),
         generation_val=card_avg, generation_card_vs_cpu_rel=gen_err,
         sagittal=dict(f1=summary["f1"]["mean"], accuracy=summary["accuracy"]["mean"]),
         grading_25d=dict(f1=g25["f1"]["mean"], accuracy=g25["accuracy"]["mean"]),
         phase_s=time.perf_counter() - t_phase)


# the straightening phase's raw cohort: two patients of a CT's full size,
# 512 x 512 x 400 voxels (0.8 x 0.8 x 1 mm), twelve vertebrae each (labels
# 13-24), p1 stored R, P, I (flipped along axis 1, the sagittal normal,
# about which the spine is symmetric: location_json_local's centroids of
# the stored mask then hold after --reorient RAI too)
RAW_SHAPE, RAW_VERTS = (512, 512, 400), tuple(range(13, 25))
# the order-1 CT resample, card vs --gpu_ids -1, on the window's 0-255 scale
STRAIGHT_CT_ATOL = 1e-3
# the crops straighten_mask_3d writes by default (--size)
STRAIGHT_SIZE = (256, 256, 64)


@contextlib.contextmanager
def straighten_timers(acc):
    """Time the straightening pipeline's steps: each call of process_mask3d
    appends a patient's record to acc, and each step inside it adds its
    seconds (after a synchronise) there: NIfTI reads, the HU window, the two
    resamples (host clock; the gather itself by CUDA events on the card,
    with its knots, grid points and peak device memory), the label cleanup
    and the de-pedicle masks; `rest` is the patient's wall time less those.
    The crops' writes run on the pipeline's thread pool, beside the rest:
    `write_thread_s` sums their seconds over the threads."""
    from unittest import mock

    from healthivert_tpu_torch.cli import straighten_mask_3d as cli
    from healthivert_tpu_torch.straighten import curve, pipeline
    from healthivert_tpu_torch.utils import nifti

    lock = threading.Lock()

    def step(key, fn):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            with lock:
                acc[-1][key] = acc[-1].get(key, 0.0) + time.perf_counter() - t0
            return out
        return run

    def patient(fn):
        def run(*args, **kwargs):
            acc.append({})
            out = step("patient", fn)(*args, **kwargs)
            rec = acc[-1]
            rec["rest"] = rec["patient"] - sum(
                v for k, v in rec.items()
                if k not in ("patient", "write_thread_s") and isinstance(v, float))
            return out
        return run

    def resample(fn):
        def run(self, array, shape, fill_value=0, order=1, device="cuda"):
            torch.cuda.reset_peak_memory_stats()
            out = step("resample", fn)(self, array, shape, fill_value, order, device)
            acc[-1].setdefault("peak_device_bytes", []).append(torch.cuda.max_memory_allocated())
            return out
        return run

    def gather(fn):
        def run(volume, coords, order=1, cval=0.0):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            out = fn(volume, coords, order, cval)
            end.record()
            end.synchronize()
            rec = acc[-1].setdefault("gather", [])
            rec.append(dict(order=order, device=volume.device.type, knots=int(coords.shape[1]),
                            points=coords[0].numel(),
                            ms=start.elapsed_time(end) if volume.is_cuda
                            else (time.perf_counter() - t0) * 1e3))
            return out
        return run

    with contextlib.ExitStack() as stack:
        for obj, name, wrap in (
                (cli, "process_mask3d", patient), (pipeline, "process_mask3d", patient),
                (nifti, "load", lambda fn: step("read", fn)),
                (nifti, "save", lambda fn: step("write_thread_s", fn)),
                (pipeline, "window", lambda fn: step("window", fn)),
                (pipeline, "remove_spine_labels_after_split",
                 lambda fn: step("label_cleanup", fn)),
                (curve.Interpolator, "interpolate_along", resample),
                (curve, "map_coordinates_3d", gather)):
            stack.enter_context(mock.patch.object(obj, name, wrap(getattr(obj, name))))
        stack.enter_context(mock.patch.dict(pipeline._MASK_STRATEGIES, {
            "rect": step("masks", pipeline._MASK_STRATEGIES["rect"])}))
        yield acc


@in_scratch
def phase_straighten(tmp, quiet):
    """The first step of the user's chain on raw CTs of a scan's full size:
    location_json_local, then straighten_mask_3d --reorient RAI on the card
    for both patients and with --gpu_ids -1 for p1 (through --split); every
    label/ and mask_2d/ crop bit-equal between card and CPU, every CT/ crop
    within STRAIGHT_CT_ATOL; every crop of the default size with the
    reoriented CT's affine and holding its vertebra; then the 3D CLI (bf16,
    --slice_batch 64) on p0's crops, its tensor-core launches equal to its
    dispatches. Each CLI runs with PyTorch's TF32 defaults before it and
    must leave float32 exact."""
    from concurrent.futures import ThreadPoolExecutor

    from healthivert_tpu_torch.cli import eval_3d_sagittal_twostage as e3_cli
    from healthivert_tpu_torch.cli import location_json_local, straighten_mask_3d
    from healthivert_tpu_torch.data.raw_spine import make_raw_spine, raw_affine, write_raw_patient
    from healthivert_tpu_torch.utils import nifti

    t_phase = time.perf_counter()
    raw = tmp / "raw"
    patients = ("p0", "p1")

    def write(p):
        ct, labels = make_raw_spine(np.random.default_rng(200 + p), RAW_SHAPE, RAW_VERTS,
                                    bend=(40.0, -30.0)[p])
        if p == 1:
            ct, labels = ct[:, ::-1], labels[:, ::-1]
        write_raw_patient(raw, patients[p], ct, labels, raw_affine(RAW_SHAPE, flip_axis1=p == 1),
                          ("msk", "seg")[p])

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(patients)) as pool:
        list(pool.map(write, range(len(patients))))
    wall = {"write_raw": time.perf_counter() - t0}

    tf32_defaults()
    t0 = time.perf_counter()
    with quiet:
        cents = location_json_local.main(["--root", str(raw)])
    wall["location_json_local"] = time.perf_counter() - t0
    check_exact("location_json_local")
    check({p: [e["label"] for e in cents[p]] for p in cents} == {p: list(RAW_VERTS)
                                                                 for p in patients},
          f"straighten: centroids of {cents.keys()}")

    card, cpu = [], []
    tf32_defaults()
    t0 = time.perf_counter()
    with straighten_timers(card), quiet:
        done = straighten_mask_3d.main(["--root", str(raw), "--out", str(tmp / "card"),
                                        "--reorient", "RAI"])
    wall["straighten_card"] = time.perf_counter() - t0
    check_exact("straighten_mask_3d")
    split = tmp / "split.json"
    split.write_text(json.dumps({"cpu": {"p1": list(RAW_VERTS)}}))
    tf32_defaults()
    t0 = time.perf_counter()
    with straighten_timers(cpu), quiet:
        done_cpu = straighten_mask_3d.main(["--root", str(raw), "--out", str(tmp / "cpu"),
                                            "--reorient", "RAI", "--split", str(split),
                                            "--gpu_ids", "-1"])
    wall["straighten_cpu_p1"] = time.perf_counter() - t0
    check_exact("straighten_mask_3d --gpu_ids -1")
    check(sorted(done) == sorted(f"{p}_{v}" for p in patients for v in RAW_VERTS)
          and done_cpu == [f"p1_{v}" for v in RAW_VERTS], f"straighten: crops {done} {done_cpu}")
    check(all(r["gather"][0]["device"] == "cuda" for r in card)
          and all(r["gather"][0]["device"] == "cpu" for r in cpu),
          "straighten: resample devices")

    t0 = time.perf_counter()
    # the reoriented CT's affine, as a NIfTI header stores it (float32)
    affine = {p: nifti.reorient_to(nifti.load(raw / p / f"{p}_{suffix}.nii.gz"),
                                   ("R", "A", "I")).affine.astype(np.float32).astype(np.float64)
              for p, suffix in zip(patients, ("msk", "seg"))}
    ct_err, held = 0.0, []
    kinds = ("CT", "label", "mask_2d")
    keys = ([("card", k, n) for k in kinds for n in done]
            + [("cpu", k, n) for k in kinds for n in done_cpu])
    with ThreadPoolExecutor(8) as pool:  # zlib releases the GIL
        files = dict(zip(keys, pool.map(
            lambda key: nifti.load(tmp.joinpath(*key[:2], f"{key[2]}.nii.gz")), keys)))
    for name in done:
        p, v = name.split("_")
        crops = {k: files[("card", k, name)] for k in kinds}
        for k, img in crops.items():
            check(img.data.shape == STRAIGHT_SIZE and np.array_equal(img.affine, affine[p]),
                  f"straighten: {k}/{name} shape {img.data.shape} or affine")
            check(bool(np.isfinite(img.data).all()), f"straighten: {k}/{name} not finite")
        held.append(int((crops["label"].data == int(v)).sum()))
        check(held[-1] > 0, f"straighten: label/{name} does not hold vertebra {v}")
        if name in done_cpu:
            for k, img in crops.items():
                ref = files[("cpu", k, name)].data
                if k == "CT":
                    ct_err = max(ct_err, float(np.abs(img.data - ref).max()))
                else:
                    check(np.array_equal(img.data, ref), f"straighten: {k}/{name} card != CPU")
    check(ct_err <= STRAIGHT_CT_ATOL, f"straighten: CT card vs CPU {ct_err:.3g}")
    wall["checks"] = time.perf_counter() - t0

    # the chain's next step on the card: the 3D CLI on p0's straightened crops
    one = tmp / "p0_straightened"
    for k in ("CT", "label"):
        (one / k).mkdir(parents=True)
        for v in RAW_VERTS:
            (one / k / f"p0_{v}.nii.gz").symlink_to(tmp / "card" / k / f"p0_{v}.nii.gz")
    for fn in (attention_v2, attention_v2_bwd):
        fn.launches = fn.tc_launches = fn.tf32_launches = 0
    infer3d._forward.dispatches = 0
    tf32_defaults()
    t0 = time.perf_counter()
    with quiet:
        stats = e3_cli.main(["--dataroot", str(one), "--name", "e3s", "--checkpoints_dir",
                             str(tmp / "ck"), "--results_dir", str(tmp / "out3d"),
                             "--load_npz", str(PRETRAINED_NPZ), "--slice_batch", "64"])
    torch.cuda.synchronize()
    wall["eval_3d_p0"] = time.perf_counter() - t0
    check_exact("3D CLI on straightened crops")
    launches, dispatches = attention_v2.tc_launches, infer3d._forward.dispatches
    check(launches > 0 and launches == dispatches == attention_v2.launches,
          f"straighten 3D CLI: tensor-core launches {launches}, all {attention_v2.launches}, "
          f"dispatches {dispatches}")
    for v in RAW_VERTS:
        out = nifti.load(tmp / "out3d" / "CT_fake" / f"p0_{v}.nii.gz")
        check(out.data.shape == STRAIGHT_SIZE and bool(np.isfinite(out.data).all()),
              f"straighten 3D CLI: CT_fake/p0_{v}")

    def split_s(recs):
        keys = ("patient", "read", "window", "resample", "label_cleanup", "masks", "rest",
                "write_thread_s")
        return [{k: r.get(k, 0.0) for k in keys} | {"gather": r["gather"],
                                                    "peak_device_bytes": r["peak_device_bytes"]}
                for r in recs]

    emit("straighten", cohort=dict(patients=len(patients), volume=list(RAW_SHAPE),
                                   vertebrae=len(RAW_VERTS), stored=["RAI", "RPI"],
                                   size=list(STRAIGHT_SIZE)),
         wall_s=wall, card=split_s(card), cpu=split_s(cpu),
         ct_max_abs_err_card_vs_cpu=ct_err, label_voxels_min=min(held),
         eval_3d=dict(dispatches=dispatches, launches=launches, patient_s=stats["patients"]),
         phase_s=time.perf_counter() - t_phase)


# the names of the float32 route's kernels (the attention's share of a
# float32 train step)
TF32_KERNELS = ("lp_gemm_tf32", "pc_gemm_tf32", "split_kernel", "patch_norm", "fuse_softmax_tc",
                "split_rows", "softmax_bwd", "fuse_adj_tc", "dn2_kernel")


def phase_train(dtype="bfloat16", warmup=2, timed=20, net_d="basic", profile=True, cache=None):
    """run_training on the shipped recipe (its own dtype bf16, or float32,
    the train CLI's default; its discriminators, or --netD `net_d`); counts
    read per step. With `profile`, two more steps after the timed ones run
    under torch.profiler, the first unmeasured (see MEASURED). `cache`: the
    synthetic examples built ahead (the recipe's own when None). The launch
    counts are set to 0 just before run_training and read just after.
    Returns the emitted record (with the backward's launches on the dtype's
    route)."""
    from torch.profiler import record_function

    float32_exact()
    opt = read_recipe()
    check(opt.batch_size == 32 and opt.compute_dtype == "bfloat16" and opt.netD == "basic",
          f"recipe: {opt.batch_size} {opt.compute_dtype} {opt.netD}")
    opt.compute_dtype, opt.netD = dtype, net_d
    if cache is not None:
        opt.synthetic_cache = cache
    counter = ROUTE_COUNTER[getattr(torch, dtype)]
    extra = 2 if profile else 0
    per_step, marks, losses_seen = [], [], []
    prof, measured = kernel_profiler(), record_function(MEASURED)

    def on_step(step, losses):
        per_step.append((getattr(attention_v2, counter), getattr(attention_v2_bwd, counter)))
        torch.cuda.synchronize()  # the step's pageable batch copy waits for the card anyway
        marks.append(time.perf_counter())
        losses_seen.append(torch.stack([v.detach().float() for v in losses.values()]))
        if not profile:
            return
        if step == warmup + timed:
            prof.start()
        elif step == warmup + timed + 1:
            measured.__enter__()
        elif step == warmup + timed + 2:
            measured.__exit__(None, None, None)
            prof.stop()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in (attention_v2, attention_v2_bwd):
        fn.launches = fn.tc_launches = fn.tf32_launches = 0
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as ckdir:
        opt.checkpoints_dir = ckdir  # logs, checkpoints
        state, cfg = run_training(opt, max_steps=warmup + timed + extra, device="cuda",
                                  on_step=on_step)
    torch.cuda.synchronize()
    fwd, bwd = getattr(attention_v2, counter), getattr(attention_v2_bwd, counter)
    peak = torch.cuda.max_memory_allocated()
    steps = [(f1 - f0, b1 - b0) for (f0, b0), (f1, b1) in zip([(0, 0)] + per_step, per_step)]
    name = ("train_" if profile else f"legacy_{net_d}_") + {"bfloat16": "bf16",
                                                            "float32": "f32"}[dtype]
    check(cfg.compute_dtype == dtype and cfg.net_d == net_d,
          f"{name}: config {cfg.compute_dtype} {cfg.net_d}")
    check(state.step == warmup + timed + extra, f"{name}: {state.step} steps")
    finite = torch.isfinite(torch.stack(losses_seen)).all(dim=1).tolist()
    check(all(finite), f"{name}: non-finite losses at steps {[i + 1 for i, f in enumerate(finite) if not f]}")
    check(all(d == (1, 1) for d in steps), f"{name}: {counter} per step {steps}")
    check(bwd > 0 and (fwd, bwd) == (state.step, state.step)
          and (attention_v2.launches, attention_v2_bwd.launches) == (fwd, bwd),
          f"launches {fwd}, {bwd}; both routes {attention_v2.launches}, "
          f"{attention_v2_bwd.launches}")
    start = pix2pix.init_state(cfg, seed=opt.seed, device="cuda")
    for net in ("gen", "d1", "d2", "d3"):
        a, b = getattr(start, net), getattr(state, net)
        for (k, p0), p1 in zip(a.named_parameters(), b.parameters()):
            if SEG_DECODER.match(k) and net_d == "seg":
                # no loss reaches the seg decoder: Adam steps it by exactly 0
                check(torch.equal(p0, p1), f"{name}: the seg decoder's {net}.{k} moved")
            else:
                check(not torch.equal(p0, p1), f"{name}: {net}.{k} did not move")
    seconds = marks[warmup + timed - 1] - marks[warmup - 1]
    step_ms = [(b - a) * 1e3 for a, b in zip(marks[warmup - 1:warmup + timed - 1],
                                              marks[warmup:warmup + timed])]
    record = dict(recipe=str(RECIPE.relative_to(RECIPE.parents[2])), net_d=net_d,
                  batch=opt.batch_size, dtype=cfg.compute_dtype, warmup_steps=warmup,
                  timed_steps=timed, synthetic_cache=opt.synthetic_cache,
                  ms_per_step=seconds / timed * 1e3,
                  slices_per_s=opt.batch_size * timed / seconds, step_ms=step_ms,
                  step_ms_min_median_max=[min(step_ms), float(np.median(step_ms)), max(step_ms)],
                  max_memory_allocated_bytes=peak,
                  fwd_launches=fwd, bwd_launches=bwd, launches_per_step=steps)
    emit(name, **record)
    if not profile:
        return record
    times, missing = measured_kernels(prof)
    summary = kernel_summary(times)
    summary.update(launches_without_kernel_record=missing)
    if dtype == "float32":
        attn = sum(ms for k, ms in times.items() if any(n in k for n in TF32_KERNELS))
        summary.update(attention_device_ms=attn, attention_share=attn / summary["device_ms"])
    emit("profile", of=f"one train step of the recipe, {dtype} (step {warmup + timed + 2}, batch "
         f"{opt.batch_size})", **summary)
    return record


# ------------------------------------------------------------------ legacy

LEGACY_CACHE = 64  # synthetic examples built ahead for phase legacy's runs
LEGACY_BATCH = 8
LEGACY_TOL = 1e-4  # legacy generators, card vs CPU, of the largest |output|
EDGE_ATOL = 1e-5
CANNY_BOUNDARY = 1e-4  # |orientation / 45 - (k + 0.5)| of an allowed exception
GP_RTOL = 1e-4
S2D_TOL = 1e-5  # a transformed conv against the dense one, of the largest |output|


def legacy_seg_recipe():
    """(a) the shipped recipe with --netD seg: bf16 at batch 32 (2 + 10
    steps) beside the recipe's basic discriminators run the same way in the
    same process, float32 (2 + 5 steps), every step one launch of #1 and of
    #2 on the dtype's route; then one float32 step at lr 0, batch 2, card
    against CPU (phase_grad_f32's gates and the running statistics)."""
    runs = {}
    for key, dtype, net_d, timed in (("basic_bf16", "bfloat16", "basic", 10),
                                     ("seg_bf16", "bfloat16", "seg", 10),
                                     ("seg_f32", "float32", "seg", 5)):
        runs[key] = phase_train(dtype, timed=timed, net_d=net_d, profile=False,
                                cache=LEGACY_CACHE)
    phase_grad_f32(net_d="seg", phase="legacy_grad_f32_seg")
    keep = ("ms_per_step", "step_ms_min_median_max", "max_memory_allocated_bytes",
            "launches_per_step")
    return {k: {f: r[f] for f in keep} for k, r in runs.items()}


def _time_forward(net, x, reps=5):
    with torch.no_grad():
        net(x)
        return time_events(lambda: net(x), reps)


def legacy_networks():
    """(b) the legacy generators at their published widths, batch 8, 256 x
    256, float32, random weights from a seed: card against CPU in training
    mode (batch statistics, which update the running ones) and then in eval
    mode (the running statistics), within LEGACY_TOL of the largest
    |output|; ms per forward on the card."""
    from healthivert_tpu_torch.models import legacy

    nets = {"unet_256": lambda: legacy.UnetGenerator(1, 1, num_downs=8, ngf=64),
            "resnet_9blocks": lambda: legacy.ResnetGenerator(1, 1, ngf=64, n_blocks=9),
            "dualhead_unet": lambda: legacy.DualHeadUNet(1, 1, num_downs=5, ngf=64)}
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (LEGACY_BATCH, 256, 256, 1)).astype(np.float32))
    out = {}
    for name, make in nets.items():
        cpu = make().init_weights(torch.Generator().manual_seed(0))
        card = make()
        card.load_state_dict(cpu.state_dict())
        card.cuda()
        rec = {}
        for mode in ("train", "eval"):
            for m in (cpu, card):
                m.train(mode == "train")
            with torch.no_grad():
                want, got = cpu(x), card(x.cuda())
            want = want if isinstance(want, tuple) else (want,)
            got = got if isinstance(got, tuple) else (got,)
            scale = max(float(w.abs().max()) for w in want)
            err = max(max_err(g, w) for g, w in zip(got, want))
            check(all(torch.isfinite(g).all() for g in got), f"legacy {name} {mode}: not finite")
            check(err <= LEGACY_TOL * scale, f"legacy {name} {mode}: err {err}, scale {scale}")
            rec[mode] = {"max_abs_err": err, "max_abs_output": scale}
        for mode in ("train", "eval"):  # after the checks: a training forward updates statistics
            card.train(mode == "train")
            rec[mode]["ms_per_forward"] = _time_forward(card, x.cuda())
        rec["params"] = sum(p.numel() for p in cpu.parameters())
        out[name] = rec
        del card
    return out


def _edge_images(b, h, w, seed=0):
    """Noise plus a bright disc and a bar: edges in every direction."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    disc = ((yy - h / 2) ** 2 + (xx - w / 3) ** 2 < (h / 4) ** 2).astype(np.float32)
    bar = ((xx > 3 * w // 4) & (yy > h // 4)).astype(np.float32)
    x = 0.2 * rng.random((b, h, w, 1)).astype(np.float32)
    x += (4.0 * disc + 2.0 * bar)[None, :, :, None]
    x *= rng.uniform(0.2, 1.0, (b, 1, 1, 1)).astype(np.float32)
    return torch.from_numpy(x)


def legacy_ops():
    """(c) the edge operators at batch 64, 256 x 256 (atol EDGE_ATOL; a
    Canny pixel may differ only where its orientation sits on a 45 degree
    rounding boundary, counted), gradient_penalty through a basic PatchGAN
    at ndf 64, batch 8 (GP_RTOL, alpha drawn once and given to both), and
    the s2d transforms at the generator's 256 x 256 shapes (kernels
    bit-equal card vs CPU, transformed convs against the dense convs on the
    card within S2D_TOL), each on the card against the CPU."""
    import torch.nn.functional as F

    from healthivert_tpu_torch.models.discriminator import NLayerDiscriminator
    from healthivert_tpu_torch.models.legacy import gradient_penalty
    from healthivert_tpu_torch.ops import edges, s2d

    rec = {}
    x = _edge_images(64, 256, 256)
    xc = x.cuda()
    want, got = edges.prewitt_edges(x), edges.prewitt_edges(xc)
    rec["prewitt_max_abs_err"] = max_err(got, want)
    check(rec["prewitt_max_abs_err"] <= EDGE_ATOL, f"prewitt err {rec['prewitt_max_abs_err']}")
    rec["prewitt_ms"] = time_events(lambda: edges.prewitt_edges(xc), 5)
    want, got = edges.canny_edges(x), edges.canny_edges(xc).cpu()
    q = edges.canny_orientation(x)[1] / 45.0
    boundary = (q - q.floor() - 0.5).abs() < CANNY_BOUNDARY
    off = (got - want).abs() > EDGE_ATOL
    rec.update(canny_pixels=off.numel(), canny_pixels_off=int(off.sum()),
               canny_off_on_boundary=int((off & boundary).sum()),
               canny_boundary_pixels=int(boundary.sum()),
               canny_edge_pixels=int((want > 0).sum()),
               canny_max_abs_err_off_boundary=float(((got - want).abs() * ~boundary).max()))
    print(f"canny: {rec['canny_pixels_off']} of {rec['canny_pixels']} pixels differ card vs "
          f"CPU, all on an orientation boundary ({rec['canny_boundary_pixels']} such pixels)",
          flush=True)
    check(not (off & ~boundary).any(), f"canny: pixels off a boundary differ: {rec}")
    check(rec["canny_edge_pixels"] > 0, "canny: no edge")
    rec["canny_ms"] = time_events(lambda: edges.canny_edges(xc), 5)

    d = NLayerDiscriminator(1, 64, 3).init_weights(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    real, fake = (torch.from_numpy(rng.standard_normal((LEGACY_BATCH, 256, 256, 1))
                                   .astype(np.float32)) for _ in range(2))
    alpha = torch.rand((LEGACY_BATCH, 1, 1, 1), generator=torch.Generator().manual_seed(2))
    want = float(gradient_penalty(d, real, fake, alpha=alpha).detach())
    d.cuda()
    got = float(gradient_penalty(d, real.cuda(), fake.cuda(), alpha=alpha).detach())
    rec["gradient_penalty"] = {"cuda": got, "cpu": want, "rel_err": abs(got - want) / abs(want)}
    check(rec["gradient_penalty"]["rel_err"] <= GP_RTOL, f"gradient_penalty {rec}")

    gen = torch.Generator().manual_seed(3)
    xs = torch.randn((LEGACY_BATCH, 256, 256, 33), generator=gen).cuda()
    conv = lambda x, w, stride, pads: F.conv2d(
        F.pad(x.permute(0, 3, 1, 2), (pads[1][0], pads[1][1], pads[0][0], pads[0][1])),
        w.permute(3, 2, 0, 1), stride=stride).permute(0, 2, 3, 1)
    s2d_rec = {}
    for k, c, f in ((3, 33, 16), (5, 16, 16), (3, 16, 32)):
        w = torch.randn((k, k, c, f), generator=gen)
        ws = s2d.kernel_s2d_s2d(w.cuda())
        check(torch.equal(ws.cpu(), s2d.kernel_s2d_s2d(w)), f"kernel_s2d_s2d {k} {c} {f}")
        p = (k - 1) // 2
        dense = conv(xs[..., :c], w.cuda(), 1, ((p, p), (p, p)))
        got = s2d.depth_to_space(conv(s2d.space_to_depth(xs[..., :c]), ws, 1, ((1, 1), (1, 1))))
        err = max_err(got, dense) / float(dense.abs().max())
        s2d_rec[f"s2d_s2d_k{k}_c{c}_f{f}"] = err
        check(err <= S2D_TOL, f"s2d conv k{k} c{c} f{f}: {err}")
    w = torch.randn((3, 3, 16, 32), generator=gen)
    wd = s2d.kernel_s2d_down(w.cuda())
    check(torch.equal(wd.cpu(), s2d.kernel_s2d_down(w)), "kernel_s2d_down")
    dense = conv(xs[..., :16], w.cuda(), 2, ((1, 1), (1, 1)))
    got = conv(s2d.space_to_depth(xs[..., :16]), wd, 1, ((1, 0), (1, 0)))
    s2d_rec["s2d_down_c16_f32"] = max_err(got, dense) / float(dense.abs().max())
    check(s2d_rec["s2d_down_c16_f32"] <= S2D_TOL, f"s2d down: {s2d_rec}")
    b = torch.randn(16, generator=gen)
    check(torch.equal(s2d.bias_s2d(b.cuda()).cpu(), s2d.bias_s2d(b)), "bias_s2d")
    z = xs[:, :128, :128, :4]
    check(torch.equal(s2d.upsample2x_as_s2d(z).cpu(), s2d.upsample2x_as_s2d(z.cpu())),
          "upsample2x_as_s2d")
    rec["s2d_rel_err"] = s2d_rec
    return rec


def phase_legacy():
    """The legacy networks and the rest of the package on the card: (a)
    the --netD seg recipe, (b) the legacy generators, (c) the edges, the
    gradient penalty and the s2d transforms; each time beside the card's
    name and power limit."""
    float32_exact()
    t0 = time.perf_counter()
    parts = {"seg_recipe": legacy_seg_recipe(), "generators": legacy_networks(),
             "ops": legacy_ops()}
    emit("legacy", card=CARD[0], seconds=time.perf_counter() - t0, **parts,
         tolerances={"generators_of_max_output": LEGACY_TOL, "edges_atol": EDGE_ATOL,
                     "canny_boundary": CANNY_BOUNDARY, "gradient_penalty_rtol": GP_RTOL,
                     "s2d_of_max_output": S2D_TOL, "stats": STATS_TOL,
                     "loss_rtol": LOSS_RTOL, "grad": GRAD_TOL})


def kernel_profiler():
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


# The profiler's records on the card's machine can lack kernels that a
# window ran first, though their launches are recorded; the older the
# process, the more (none at the start of a run of this script). So a
# profiled window first runs its work unmeasured for PROFILE_WARM_S, counts
# only the kernels launched inside its MEASURED range, and is taken again,
# up to PROFILE_TRIES times, until every launch in that range has its
# kernel's record. PROFILE_LOST holds, for each window, the launches without
# a record before that range and inside it (phase profiler prints them).
PROFILE_WARM_S = 0.1
PROFILE_TRIES = 5
MEASURED = "chip_smoke.measured"
PROFILE_LOST = []


def measured_kernels(prof, calls=1):
    """(device ms per call of each kernel and copy launched inside the
    profile's MEASURED range, largest first; the kernel launches without a
    kernel record before that range and inside it)."""
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    events = prof.profiler.kineto_results.events()
    span = next(e for e in events if e.device_type() == cpu and e.name() == MEASURED)
    runtime = {e.correlation_id(): e for e in events
               if e.device_type() == cpu and e.name().startswith("cu")
               and e.start_ns() <= span.end_ns()}
    inside = {c for c, e in runtime.items() if e.start_ns() >= span.start_ns()}
    times, recorded = {}, set()
    for e in events:
        if e.device_type() == cuda and not e.is_user_annotation():
            recorded.add(e.correlation_id())
            if e.correlation_id() in inside:
                times[e.name()] = times.get(e.name(), 0.0) + e.duration_ns() / 1e6 / calls
    lost = [c for c, e in runtime.items() if "Launch" in e.name() and c not in recorded]
    lost_inside = sum(c in inside for c in lost)
    PROFILE_LOST.append((len(lost) - lost_inside, lost_inside))
    return dict(sorted(times.items(), key=lambda kv: -kv[1])), lost_inside


def kernel_summary(times, top=10):
    total = sum(times.values())
    return {"device_ms": total, "kernels": len(times),
            "top": [{"kernel": k[:160], "ms": v, "share": v / total if total else None}
                    for k, v in list(times.items())[:top]]}


def top_kernels(fn):
    """The top ten device kernels of one call of fn."""
    return kernel_summary(profile_ms(fn, calls=1))


# stages of the tensor-core route, by a part of each kernel's name; the
# rest is the wrapper's channel pad and phase split, fills and allocations
FWD_STAGES = (("norm", "patch_norm"), ("score", "lp_gemm<0>"),
              ("fuse_softmax", "fuse_softmax_tc"), ("paste", "pc_gemm<2>"))
BWD_STAGES = (("dprobs", "lp_gemm<1>"), ("split_probs", "split_rows"), ("db_full", "pc_gemm<3>"),
              ("softmax_bwd", "softmax_bwd"), ("fuse_adj", "fuse_adj_tc"), ("dn2", "dn2_kernel"),
              ("dfd", "pc_gemm<4>"), ("dbd", "pc_gemm<5>"))
V1_STAGES = (("score", "v1_gemm<0>"), ("fuse_softmax", "fuse_softmax_tc"), ("paste", "v1_gemm<1>"))
# the float32 (3xTF32) route's stages: the same, plus the split of the
# feature maps (v1: of fpat and wnorm) into TF32 halves
FWD_STAGES_TF32 = (("split", "split_kernel"), ("norm", "patch_norm"), ("score", "lp_gemm_tf32<0>"),
                   ("fuse_softmax", "fuse_softmax_tc"), ("paste", "pc_gemm_tf32<2>"))
BWD_STAGES_TF32 = (("split", "split_kernel"), ("dprobs", "lp_gemm_tf32<1>"),
                   ("split_probs", "split_rows"), ("db_full", "pc_gemm_tf32<3>"),
                   ("softmax_bwd", "softmax_bwd"), ("fuse_adj", "fuse_adj_tc"),
                   ("dn2", "dn2_kernel"), ("dfd", "pc_gemm_tf32<4>"), ("dbd", "pc_gemm_tf32<5>"))
V1_STAGES_TF32 = (("split", "split_kernel"), ("score", "v1_gemm_tf32<0>"),
                  ("fuse_softmax", "fuse_softmax_tc"), ("paste", "v1_gemm_tf32<1>"))
STAGES = {("fwd", torch.bfloat16): FWD_STAGES, ("bwd", torch.bfloat16): BWD_STAGES,
          ("v1", torch.bfloat16): V1_STAGES, ("fwd", torch.float32): FWD_STAGES_TF32,
          ("bwd", torch.float32): BWD_STAGES_TF32, ("v1", torch.float32): V1_STAGES_TF32,
          ("ablate", torch.bfloat16): ABLATE_STAGES, ("ablate", torch.float32): ABLATE_STAGES}
# kernels no attention call may launch (`route_clean`): the first, CUDA-core
# kernels' GEMMs, and any GEMM but the routes' own (library GEMMs included)
NOT_ON_A_ROUTE = re.compile(r"score_kernel|paste_kernel|fuse_softmax_kernel|dprobs_kernel|"
                            r"dbfull_kernel|score_bwd_kernel|fuse_adj_norm|gemm|xmma|cublas|"
                            r"cutlass", re.I)


def profile_ms(fn, calls=5):
    """Device ms per call of each kernel over `calls` calls of fn, from a
    window in which each of their launches has its kernel's record."""
    from torch.profiler import record_function

    for _ in range(PROFILE_TRIES):
        torch.cuda.synchronize()
        with kernel_profiler() as prof:
            start = time.perf_counter()
            while True:  # unmeasured: the records the profiler may lack
                fn()
                torch.cuda.synchronize()
                if time.perf_counter() - start >= PROFILE_WARM_S:
                    break
            with record_function(MEASURED):
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
        times, missing = measured_kernels(prof, calls)
        if not missing:
            return times
    check(False, f"profile: launches without a kernel record in each of {PROFILE_TRIES} "
          f"windows: {PROFILE_LOST[-PROFILE_TRIES:]}")


def by_stage(times, stages):
    """Kernel times summed into `stages` (a part of each kernel's name) and
    the rest (`wrapper`)."""
    split = {name: 0.0 for name, _ in stages}
    split["wrapper"] = 0.0
    for name, ms in times.items():
        stage = next((st for st, part in stages if part in name), "wrapper")
        split[stage] += ms
    return split


def _bound(flops, nbytes, peak):
    """(least ms, what bounds it) for `flops` operations at `peak` and
    `nbytes` moved at the memory rate."""
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def bound_ms(b, hd, wd, c, dtype):
    """Least time for the work of one forward call: operations at the peak
    rate of the input type, bytes moved once (inputs read, output written)."""
    num_l = hd * wd
    flops = b * (9 * 2 * num_l * num_l * c + 16 * 2 * num_l * num_l * c)
    esize = torch.tensor([], dtype=dtype).element_size()
    nbytes = b * (2 * num_l * c * esize + 4 * num_l * c * esize + num_l * 4
                  + 4 * num_l * c * esize)
    return (*_bound(flops, nbytes, PEAK_FLOPS[dtype]), flops, nbytes)


def bwd_bound_ms(b, hd, wd, c, dtype):
    """The same for one backward call: the two paste adjoints (16 shifted
    products each) and the two score adjoints (9 each), 100 L P C per
    sample; bytes: fd, bd, b_full, dy and the three outputs in the input
    type, s and probs (L, P) and nrm_raw and mm (L) in float32."""
    num_l = hd * wd
    flops = b * 2 * (16 + 16 + 9 + 9) * num_l * num_l * c
    esize = torch.tensor([], dtype=dtype).element_size()
    nbytes = b * ((2 + 8 + 2 + 4) * num_l * c * esize + 2 * num_l * num_l * 4
                  + 2 * num_l * 4)
    return (*_bound(flops, nbytes, PEAK_FLOPS[dtype]), flops, nbytes)


def v1_bound_ms(b, num_l, k, rc, dtype):
    """Least time for one v1 call: the score product (K deep) and the paste
    (L deep) at the peak rate of the input type; bytes: fpat, wnorm, raw
    and vals in the input type, mm in float32, each moved once."""
    flops = b * 2 * num_l * num_l * (k + rc)
    esize = torch.tensor([], dtype=dtype).element_size()
    nbytes = b * ((2 * num_l * k + 2 * num_l * rc) * esize + num_l * 4)
    return (*_bound(flops, nbytes, PEAK_FLOPS[dtype]), flops, nbytes)


def time_events(fn, reps):
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def timed(kernel, plain, reps, plain_reps):
    """Warm-up, then CUDA-event windows in the order plain, kernel, kernel,
    plain: ([k1, k2], [p1, p2])."""
    for _ in range(3):
        kernel()
        plain()
    torch.cuda.synchronize()
    p1 = time_events(plain, plain_reps)
    k1 = time_events(kernel, reps)
    k2 = time_events(kernel, reps)
    p2 = time_events(plain, plain_reps)
    return [k1, k2], [p1, p2]


def emit_timing(name, shape, dtype, kernel_ms, plain_ms, bound, err, device_ms, **extra):
    """One `timing` line; returns the kernels-line row (the faster window of
    each). device_ms: device ms per stage (tensor-core routes) or per kernel
    (CUDA-core ones). float32 also gets its 3xTF32 bound, which its row
    carries as bound_ms."""
    bms, bound_by, flops, nbytes = bound
    ms = min(kernel_ms)
    row = dict(ms=ms, plain_ms=min(plain_ms), bound_ms=bms, bound_by=bound_by, max_abs_err=err,
               dtype=str(dtype).split(".")[-1])
    if dtype == torch.float32:
        tf32_ms, tf32_by = _bound(flops, nbytes, PEAK_3XTF32)
        extra.update(bound_3xtf32_ms=tf32_ms, bound_3xtf32_by=tf32_by,
                     roofline_share_3xtf32=tf32_ms / ms)
        row.update(bound_ms=tf32_ms, bound_by=tf32_by)
    emit("timing", kernel=name, shape=shape, dtype=str(dtype), kernel_ms=kernel_ms,
         plain_ms=plain_ms, bound_ms=bms, bound_by=bound_by, flops=flops, bytes=nbytes,
         roofline_share=bms / ms, max_abs_err=err, device_ms=device_ms, **extra)
    return row


def device_ms(kernel, which, dtype):
    """The stage split of a tensor-core route (STAGES) and the names of the
    kernels launched."""
    times = profile_ms(kernel)
    return by_stage(times, STAGES[(which, dtype)]), sorted(times)


def peak_bytes(fn):
    """Device memory fn allocates at its peak, above what was allocated
    before it."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    del out
    return torch.cuda.max_memory_allocated() - base


# Inputs of the timing phases: fd unscaled for bf16 (near one-hot
# attention), scaled by 0.05 for float32, whose y gate (atol 3e-4) holds
# for soft attention (phase kernel); the work does not depend on the data.
def timing_fscale(dtype):
    return 1.0 if dtype == torch.bfloat16 else 0.05


def phase_timing(b=64, hd=32, wd=32, c=64, dtype=torch.bfloat16):
    """The forward: bf16 as serving calls it, float32 with its residuals,
    as training calls it (the route's every output then held at its
    gate)."""
    float32_exact()
    fd, bd, b_full, mm = attention_inputs(b, hd, wd, c, "middle", dtype, seed=1,
                                          fscale=timing_fscale(dtype))
    f32 = dtype == torch.float32
    kernel = lambda: attention_v2(fd, bd, b_full, mm, hd, wd, emit_residuals=f32)
    plain = lambda: attention_v2_reference(fd, bd, b_full, mm, hd, wd, emit_residuals=f32)
    extra = {}
    with torch.no_grad():
        got, want = kernel(), plain()
        y, y_ref = (got[0], want[0]) if f32 else (got, want)
        err = max_err(y, y_ref)
        check(y_within(y, y_ref, dtype), f"timing shape: y err {err}")
        if f32:
            errs = {"s": max_err(got[1], want[1]), "probs": max_err(got[2], want[2]),
                    "nrm_rel": float(((got[3] - want[3]).abs() / want[3].abs().clamp_min(1e-6)).max())}
            for k, e in errs.items():
                check(e <= TOL[k], f"timing shape: {k} err {e}")
            extra.update(residual_errs=errs, peak_bytes_above_inputs=peak_bytes(kernel))
        del got, want, y, y_ref
        kernel_ms, plain_ms = timed(kernel, plain, 20, 5)
        stages, names = device_ms(kernel, "fwd", dtype)
    if f32:
        route_clean(names, ("lp_gemm_tf32<", "pc_gemm_tf32<"), "timing attention_v2", dtype)
    return emit_timing("attention_v2", [b, hd, wd, c], dtype, kernel_ms, plain_ms,
                       bound_ms(b, hd, wd, c, dtype), err, stages, kernels=names, **extra)


def phase_timing_bwd(b=32, hd=32, wd=32, c=64, dtype=torch.bfloat16):
    float32_exact()
    args = backward_inputs(b, hd, wd, c, "middle", dtype, seed=1, fscale=timing_fscale(dtype))
    kernel = lambda: attention_v2_bwd(*args, hd, wd)
    plain = lambda: attention_v2_bwd_reference(*args, hd, wd)
    got, want = kernel(), plain()
    results = [bwd_within(g, w, dtype) for g, w in zip(got, want)]
    err = max(r[1] for r in results)
    check(all(r[0] for r in results), f"timing shape: backward errs {results}")
    del got, want
    extra = {}
    if dtype == torch.float32:
        extra["peak_bytes_above_inputs"] = peak_bytes(kernel)
    kernel_ms, plain_ms = timed(kernel, plain, 10, 3)
    stages, names = device_ms(kernel, "bwd", dtype)
    if dtype == torch.float32:
        route_clean(names, ("lp_gemm_tf32<", "pc_gemm_tf32<"), "timing attention_v2_bwd", dtype)
    return emit_timing("attention_v2_bwd", [b, hd, wd, c], dtype, kernel_ms, plain_ms,
                       bwd_bound_ms(b, hd, wd, c, dtype), err, stages, kernels=names, **extra)


def phase_timing_v1(b=64, hd=32, wd=32, c=64, dtype=torch.bfloat16):
    """v1 on patch tensors built beforehand; float32 also with its peak
    device memory and the kernels of a profiled call held to its route."""
    float32_exact()
    fd, bd, b_full, mm = attention_inputs(b, hd, wd, c, "middle", dtype, seed=1,
                                          fscale=timing_fscale(dtype))
    patches = v1_patches(fd, bd, b_full)
    kernel = lambda: attention_scores_paste(*patches, mm, hd, wd)
    plain = lambda: attention_scores_paste_reference(*patches, mm, hd, wd)
    got, want = kernel(), plain()
    err = max_err(got, want)
    check(y_within(got, want, dtype), f"timing shape: v1 vals err {err}")
    del got, want
    extra = {}
    if dtype == torch.float32:
        extra["peak_bytes_above_inputs"] = peak_bytes(kernel)
    kernel_ms, plain_ms = timed(kernel, plain, 20, 5)
    stages, names = device_ms(kernel, "v1", dtype)
    if dtype == torch.float32:
        route_clean(names, ("v1_gemm_tf32<0>", "v1_gemm_tf32<1>"), "timing v1", dtype)
    return emit_timing("attention_scores_paste", [b, hd * wd, 9 * c, 16 * c], dtype, kernel_ms,
                       plain_ms, v1_bound_ms(b, hd * wd, 9 * c, 16 * c, dtype), err, stages,
                       kernels=names, **extra)


def phase_timing_ablate(result, b=64, hd=32, wd=32, c=64, dtype=torch.bfloat16):
    """The ablation's entry functions in mode full on the entry point's own
    inputs: each against its plain version (error, and the plain version's
    time), beside the kernel time the entry point measured."""
    float32_exact()
    fd, bd, b_full, mm = attn_ablate.make_inputs(b, hd, wd, c, dtype, torch.device("cuda"))
    bph = to_phases(b_full, hd, wd)
    plain = {
        "natural": lambda: ablate_reference(fd, bd, b_full, mm, hd, wd),
        "phases": lambda: ablate_layout_reference(fd, bd, bph, mm, hd, wd, layout="phases"),
    }
    calls = {"run": (lambda: run(fd, bd, b_full, mm, hd, wd), "natural", "full"),
             "run_padded": (lambda: run_padded(fd, bd, bph, mm, hd, wd), "phases", "padded-full"),
             "run_auto": (lambda: run_auto(fd, bd, b_full, mm, hd, wd), "natural", "auto-full"),
             "run_fold": (lambda: run_fold(fd, bd, b_full, mm, hd, wd), "natural", "fold-full")}
    with torch.no_grad():
        want = {layout: fn() for layout, fn in plain.items()}
        errs = {}
        for name, (fn, layout, _) in calls.items():
            got = fn()
            errs[name] = max_err(got, want[layout])
            check(y_within(got, want[layout], dtype), f"timing shape: {name} err {errs[name]}")
        torch.cuda.synchronize()
        # plain, plain (each layout), then again
        first = {layout: time_events(fn, 3) for layout, fn in plain.items()}
        second = {layout: time_events(fn, 3) for layout, fn in plain.items()}
    bms, bound_by, flops, nbytes = bound_ms(b, hd, wd, c, dtype)
    rows = {}
    for name, (_, layout, key) in calls.items():
        plain_ms = min(first[layout], second[layout])
        rows[name] = dict(ms=result["ms"][key], plain_ms=plain_ms, bound_ms=bms,
                          bound_by=bound_by, max_abs_err=errs[name], dtype="bfloat16")
        emit("timing", kernel=f"attn_ablate.{name}", mode="full", shape=[b, hd, wd, c],
             dtype=str(dtype), kernel_ms=result["ms"][key], plain_ms=[first[layout], second[layout]],
             bound_ms=bms, bound_by=bound_by, flops=flops, bytes=nbytes,
             roofline_share=bms / result["ms"][key], max_abs_err=errs[name])
    return rows


def phase_timing_ablate_f32(b=64, hd=32, wd=32, c=64):
    """The four float32 entry functions in mode full on soft-attention
    inputs, as the other float32 timings: each against its plain version
    (CUDA events, plain, kernel, kernel, plain), with both bounds and its
    stage split, and the kernels of a profiled call held to the route."""
    float32_exact()
    dtype = torch.float32
    fd, bd, b_full, mm = attention_inputs(b, hd, wd, c, "middle", dtype, seed=1,
                                          fscale=timing_fscale(dtype))
    bph = to_phases(b_full, hd, wd)
    natural = lambda: ablate_reference(fd, bd, b_full, mm, hd, wd)
    phases = lambda: ablate_layout_reference(fd, bd, bph, mm, hd, wd, layout="phases")
    calls = {"run": (lambda: run(fd, bd, b_full, mm, hd, wd), natural),
             "run_padded": (lambda: run_padded(fd, bd, bph, mm, hd, wd), phases),
             "run_auto": (lambda: run_auto(fd, bd, b_full, mm, hd, wd), natural),
             "run_fold": (lambda: run_fold(fd, bd, b_full, mm, hd, wd), natural)}
    rows = {}
    with torch.no_grad():
        for name, (kernel, plain) in calls.items():
            got, want = kernel(), plain()
            err = max_err(got, want)
            check(y_within(got, want, dtype), f"timing shape: f32 {name} err {err}")
            del got, want
            kernel_ms, plain_ms = timed(kernel, plain, 10, 3)
            stages, names = device_ms(kernel, "ablate", dtype)
            route_clean(names, mode_gemms("full", dtype, ring_1=name == "run_auto"),
                        f"timing f32 {name}", dtype)
            rows[name] = emit_timing(f"attn_ablate.{name}", [b, hd, wd, c], dtype, kernel_ms,
                                     plain_ms, bound_ms(b, hd, wd, c, dtype), err, stages,
                                     mode="full", kernels=names)
    return rows


# phase dist: two ranks share the one card over gloo (NCCL refuses two ranks
# on one card: "Duplicate GPU detected"); NCCL runs at world size 1 through
# torchrun. DIST_STEPS optimizer steps of the float32 recipe each.
DIST_STEPS = 2
DIST_CACHE = 64  # synthetic examples built ahead per process (the recipe: 384)
# parameters of two runs after a few Adam steps from one state. Adam's first
# step moves an element by +-lr whatever the gradient's size, so where a
# gradient sits at its rounding floor the two runs' updates may differ in
# sign (tests/test_torch_train_step.py); those elements then change the next
# step's gradients by ~1e-3 of themselves (seen on an H100: two ranks
# against one process, 326 of D1's 2.76 M elements apart after step 1, the
# step-2 gradients 1.0e-3 apart at the median element, 475 k elements more
# than 1e-3 lr apart after step 2; one process twice, 8 and 824). So each
# element is held within 2.2 lr a step (an Adam step of beta1 0.5 moves it
# by at most ~1.05 lr) and each network's sum of |w| within SUM_RTOL, the
# measure the JAX package holds its 1-vs-8-device and two-process steps to
# (tests/test_parallel.py, tests/test_multiprocess.py)
SUM_RTOL = 1e-5
def grads_within(got, want):
    """Per network, the largest |got - want| / (G + |want|) over its tensors
    (G: the network's largest |want|), and that tensor's name."""
    worst = {}
    for net, tensors in want.items():
        scale = max(float(w.abs().max()) for w in tensors.values())
        ratios = {k: float(((got[net][k] - w).abs() / (scale + w.abs())).max())
                  for k, w in tensors.items()}
        name = max(ratios, key=ratios.get)
        worst[net] = {"max_err_over_scale": ratios[name], "worst_tensor": name, "scale": scale}
        check(scale > 0, f"dist: {net} has no gradient")
    return worst


def params_within(got, want, lr, steps, what):
    """Parameters of two runs after `steps` Adam steps from one state, held
    as SUM_RTOL says. Returns {net: {elements more than 1e-3 lr apart,
    elements, relative difference of the sums of |w|}}."""
    report = {}
    for net, tensors in want.items():
        far = total = 0
        sums = [0.0, 0.0]
        for k, w in tensors.items():
            d = (got[net][k] - w).abs()
            check(float(d.max()) <= 2.2 * steps * lr, f"{what}: {net}.{k} moved apart")
            far += int((d > 1e-3 * lr).sum())
            total += d.numel()
            sums[0] += float(got[net][k].double().abs().sum())
            sums[1] += float(w.double().abs().sum())
        rel = abs(sums[0] - sums[1]) / sums[1]
        report[net] = {"past_1e-3_lr": far, "elements": total, "abs_sum_rel_err": rel}
        check(rel <= SUM_RTOL, f"{what}: {net} sum of |w| rel err {rel}")
    return report


def dist_synthesis():
    """(a) synthesize_volumes sharded over make_mesh("data:2", [cuda:0,
    cuda:0]) at batch 64 against mesh=None at batch 32 (each shard the shape
    of an unsharded dispatch): bit-equal volumes; every dispatch one
    tensor-core attention launch, counted from 0 just before each call."""
    from healthivert_tpu_torch.parallel.mesh import make_mesh

    cfg = Pix2PixConfig(ngf=16, image_size=256, compute_dtype="bfloat16")
    gen = load_generator(PRETRAINED_NPZ, cfg, device="cuda")
    ct, labels, cam = make_spine_volume(np.random.default_rng(0), fractured={20: 0.6})
    volumes = [(ct, labels, v, cam) for v in (19, 20, 21)]
    mesh = make_mesh("data:2", devices=["cuda:0", "cuda:0"])
    model = make_mesh("data:2,model:2", devices=["cuda:0"] * 4)
    runs = {}
    for name, batch, m in (("unsharded", 32, None), ("sharded", 64, mesh),
                           ("model_axis", 64, model), ("unsharded_again", 32, None)):
        attention_v2.launches = attention_v2.tc_launches = 0
        infer3d._forward.dispatches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = infer3d.synthesize_volumes(gen, cfg, volumes, batch_size=batch, use_bf16=True,
                                         mesh=m, device="cuda")
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches, dispatches = attention_v2.tc_launches, infer3d._forward.dispatches
        check(launches > 0 and launches == dispatches == attention_v2.launches,
              f"dist {name} synthesis: tensor-core launches {launches}, all "
              f"{attention_v2.launches}, dispatches {dispatches}")
        runs[name] = (out, ms, dispatches)
    for sharded in ("sharded", "model_axis"):
        for (a_ct, a_lb), (b_ct, b_lb) in zip(runs[sharded][0], runs["unsharded"][0]):
            check(np.array_equal(a_ct, b_ct) and np.array_equal(a_lb, b_lb),
                  f"dist: the {sharded} synthesis differs from the unsharded one")
    # a model axis replicates: each data shard runs once, as on data:2
    check(runs["model_axis"][2] == runs["sharded"][2],
          f"dist: data:2,model:2 dispatched {runs['model_axis'][2]}, data:2 "
          f"{runs['sharded'][2]}")
    return {"mesh": dict(mesh.shape), "devices": [str(d) for d in mesh.devices],
            "model_mesh": dict(model.shape), "model_mesh_devices": len(model.devices),
            "bit_equal": True,
            **{f"{k}_ms": v[1] for k, v in runs.items()},
            **{f"{k}_dispatches": v[2] for k, v in runs.items()}}


def dist_recipe(tmp, name):
    opt = read_recipe()
    check(opt.batch_size == 32 and opt.dataset_mode == "synthetic",
          f"recipe: {opt.batch_size} {opt.dataset_mode}")
    opt.compute_dtype, opt.synthetic_cache = "float32", DIST_CACHE
    opt.checkpoints_dir, opt.name = str(tmp / name), name
    return opt


def two_ranks(tmp, name, mesh):
    """run_training on the float32 recipe, global batch 32, as two ranks on
    cuda:0 over gloo on --mesh `mesh`: the ranks bit-equal, one
    float32-route launch of #1 and of #2 a step on each. Returns rank 0's
    result and the wall seconds."""
    from torch_dist_worker import Ranks

    (tmp / name).mkdir()
    opt = dist_recipe(tmp, name)
    opt.mesh = mesh
    t0 = time.perf_counter()
    ranks = Ranks(tmp / name, [("train", "train", dict(opt=vars(opt), max_steps=DIST_STEPS))],
                  device="cuda:0", backend="gloo", timeout=600).results()
    ranks_s = time.perf_counter() - t0
    r0, r1 = (r["train"] for r in ranks)
    check([r["world"] for r in ranks] == [2, 2], f"dist {mesh}: world")
    for net in r0["after"]:
        for k, v in r0["after"][net].items():
            check(torch.equal(v, r1["after"][net][k]), f"dist {mesh}: ranks differ at {net}.{k}")
    for r in (r0, r1):
        counts = [(0, 0)] + [s["launches"] for s in r["steps"]]
        per = [(b[0] - a[0], b[1] - a[1]) for a, b in zip(counts, counts[1:])]
        check(per == [(1, 1)] * DIST_STEPS, f"dist {mesh}: a rank's float32-route launches {per}")
        check(r["steps"] and r["steps"][-1]["losses"] == r0["steps"][-1]["losses"],
              f"dist {mesh}: ranks returned different losses")
    return r0, ranks_s


def dist_training(tmp, quiet):
    """(b) run_training on the float32 recipe, global batch 32: two ranks on
    cuda:0 over gloo on `data:2` (16 a rank) and on `data:1,model:2` (the
    replicated model axis: 32 a rank), each against one process at 32.
    Returns the part's record."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    from torch_dist_worker import run_training_first_grads

    runs = {mesh: two_ranks(tmp, name, mesh)
            for name, mesh in (("ranks", "data:2"), ("model", "data:1,model:2"))}
    opt = dist_recipe(tmp, "ranks")

    # one process at the global batch, on the same recipe
    steps, marks = [], []

    def on_step(step, losses):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        steps.append({k: float(v) for k, v in losses.items()})

    float32_exact()
    with quiet:
        state, _, want_g = run_training_first_grads(dist_recipe(tmp, "one"), max_steps=DIST_STEPS,
                                                    device="cuda", on_step=on_step)
    nets = dict(zip(("g", "d1", "d2", "d3"), (state.gen, state.d1, state.d2, state.d3)))
    want = {n: {k: v.detach().cpu() for k, v in m.state_dict().items()} for n, m in nets.items()}
    params = {n: {k: v for k, v in t.items() if k in want_g[n]} for n, t in want.items()}
    record = {"backend": "gloo", "device": "cuda:0", "ranks": 2, "global_batch": opt.batch_size,
              "steps": DIST_STEPS, "ranks_bit_equal": True,
              "one_process_step2_ms": [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]}
    for mesh, (r0, ranks_s) in runs.items():
        loss_err = max(abs(g[k] - w[k]) / max(abs(w[k]), 1e-12)
                       for g, w in zip((s["losses"] for s in r0["steps"]), steps) for k in w)
        check(loss_err <= LOSS_RTOL, f"dist {mesh}: losses rel err {loss_err}")
        # the first step's gradients, from one state in both runs; later
        # steps start from states Adam's sign flips have moved apart
        # (SUM_RTOL)
        grads = grads_within(r0["first_grads"], want_g)
        for net, w in grads.items():
            check(w["max_err_over_scale"] <= GRAD_TOL, f"dist {mesh}: {net} gradient err {w}")
        apart = params_within(r0["after"], params, opt.lr, DIST_STEPS, f"dist {mesh}")
        rank_ms = [(b["t"] - a["t"]) * 1e3 for a, b in zip(r0["steps"], r0["steps"][1:])]
        record[mesh] = {"losses_rel_err": loss_err, "first_step_grads": grads, "params": apart,
                        "ranks_wall_s": ranks_s, "rank_step2_ms": rank_ms}
    return record


def dist_nccl(tmp, quiet):
    """(c) the train CLI under torchrun --standalone --nproc_per_node 1 (NCCL
    at world size 1), 3 steps of the float32 recipe's flags on a NIfTI
    cohort, against the same CLI without torchrun in this process: the
    checkpoints' parameters as in (b), their Adam first moments (a sum of
    the steps' gradients) at the gradient gate."""
    from healthivert_tpu_torch.cli import train as train_cli

    data = tmp / "cohort"
    write_cli_cohort(data, patients=2)
    recipe = read_recipe()
    steps = 3
    flags = ["--dataroot", str(data), "--cam_dir", str(data / "CAM"),
             "--checkpoints_dir", str(tmp / "ck"), "--batch_size", str(recipe.batch_size),
             "--seed", str(recipe.seed), "--direction", recipe.direction,
             "--print_freq", str(recipe.batch_size), "--display_freq", "0",
             "--save_epoch_freq", "1000", "--save_latest_freq", "1000000",
             "--eval_freq", "1000", "--max_steps", str(steps)]
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "1",
           "-m", "healthivert_tpu_torch.cli.train", *flags, "--name", "torchrun"]
    t0 = time.perf_counter()
    run = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                         cwd=Path(__file__).resolve().parent)
    torchrun_s = time.perf_counter() - t0
    (tmp / "torchrun.log").write_text(run.stdout + run.stderr)
    check(run.returncode == 0, f"torchrun train CLI exited {run.returncode}:\n"
          f"{(run.stdout + run.stderr)[-3000:]}")
    backend = re.findall(r"process group: backend (\w+), rank 0 of 1", run.stdout)
    check(backend == ["nccl"], f"torchrun train CLI: process group {backend}")
    tf32_defaults()
    t0 = time.perf_counter()
    with quiet:
        state, _ = train_cli.main(flags + ["--name", "plain"])
    plain_s = time.perf_counter() - t0
    check_exact("train CLI (phase dist)")
    got = torch.load(tmp / "ck" / "torchrun" / "latest.pt", map_location="cpu", weights_only=True)
    want = torch.load(tmp / "ck" / "plain" / "latest.pt", map_location="cpu", weights_only=True)
    check(got["step"] == want["step"] == steps, f"torchrun: steps {got['step']}, {want['step']}")
    nets = ("gen", "d1", "d2", "d3")
    names = {n: [k for k, _ in getattr(state, n).named_parameters()] for n in nets}
    pick = lambda ck: {n: {k: ck[n][k] for k in names[n]} for n in nets}
    apart = params_within(pick(got), pick(want), recipe.lr, steps, "torchrun")
    # Adam's state is indexed by the parameters' order
    moment = lambda ck: {n: {k: ck[o]["state"][i]["exp_avg"] for i, k in enumerate(names[n])}
                         for n, o in zip(nets, ("opt_g", "opt_d1", "opt_d2", "opt_d3"))}
    m = grads_within(moment(got), moment(want))
    for net, w in m.items():
        check(w["max_err_over_scale"] <= GRAD_TOL, f"torchrun: {net} Adam moment err {w}")
    return {"launcher": "torchrun --standalone --nproc_per_node 1", "backend": backend[0],
            "steps": steps, "params": apart, "adam_first_moment": m,
            "torchrun_wall_s": torchrun_s, "in_process_wall_s": plain_s}


def dist_remat():
    """One float32 train_step of the recipe at full width, batch 32, plain
    and with remat=True from one state and batch: losses and gradients at
    the card gate, each step's peak device bytes and float32-route launches
    (remat runs the forward again in the backward)."""
    float32_exact()
    opt = read_recipe()
    batch = to_device(SyntheticDataset(batch_size=opt.batch_size, seed=0,
                                       n_volumes=2).sample_batch(), "cuda")
    runs = {}
    for remat in (False, True):
        cfg = Pix2PixConfig(ngf=16, ndf=opt.ndf, image_size=opt.crop_size,
                            compute_dtype="float32", remat=remat)
        state = pix2pix.init_state(cfg, seed=opt.seed, device="cuda", gen_npz=PRETRAINED_NPZ)
        before = route_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        state, losses = pix2pix.train_step(state, batch, opt.lr, cfg)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        delta = [a - n for a, n in zip(route_counts(), before)]
        nets = {"G": state.gen, "D1": state.d1, "D2": state.d2, "D3": state.d3}
        grads = {n: {k: p.grad.detach().cpu() for k, p in m.named_parameters()}
                 for n, m in nets.items()}
        runs[remat] = ({k: float(v) for k, v in losses.items()}, grads, peak, delta)
        del state
    (l0, g0, p0, d0), (l1, g1, p1, d1) = runs[False], runs[True]
    # route_counts: forward all, tc, tf32; backward all, tc, tf32
    check(d0 == [1, 0, 1, 1, 0, 1] and d1 == [2, 0, 2, 1, 0, 1],
          f"remat: float32-route launches plain {d0}, remat {d1}")
    loss_err = max(abs(l1[k] - v) / max(abs(v), 1e-12) for k, v in l0.items())
    check(loss_err <= LOSS_RTOL, f"remat: losses rel err {loss_err}")
    grads = grads_within(g1, g0)
    for net, w in grads.items():
        check(w["max_err_over_scale"] <= GRAD_TOL, f"remat: {net} gradient err {w}")
    return {"batch": opt.batch_size, "losses_rel_err": loss_err, "grads": grads,
            "peak_bytes_plain": p0, "peak_bytes_remat": p1}


@in_scratch
def phase_dist(tmp, quiet):
    """Multi-GPU on the one card: (a) the sharded 3D synthesis (data:2 and
    data:2,model:2), (b) two-rank training over gloo (data:2 and
    data:1,model:2), (c) the train CLI under torchrun with
    NCCL at world size 1, and one float32 step with remat; each part's ms
    beside the card's name and power limit. These are not multi-card speeds:
    the shards and ranks share one card."""
    float32_exact()
    t0 = time.perf_counter()
    parts = {"synthesis": dist_synthesis()}
    parts["training_2_ranks"] = dist_training(tmp, quiet)
    parts["torchrun_nccl"] = dist_nccl(tmp, quiet)
    parts["remat"] = dist_remat()
    emit("dist", card=CARD[0], one_card=True, seconds=time.perf_counter() - t0, **parts,
         tolerances={"loss_rtol": LOSS_RTOL, "grad": GRAD_TOL, "param_abs_sum_rtol": SUM_RTOL})


ABLATE_REPLACES = {"run": 247, "run_padded": 289, "run_auto": 466, "run_fold": 657}


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    phase_device()
    phase_build()
    phase_kernel()
    phase_kernel_bwd()
    phase_kernel_v1()
    phase_fwd_f32()
    phase_grad_f32()
    cfg = Pix2PixConfig(ngf=16, image_size=256, compute_dtype="bfloat16")
    gen = load_generator(PRETRAINED_NPZ, cfg, device="cuda")
    bf16_ms = phase_fwd_bf16(gen, cfg)
    launches = phase_synth3d(gen, cfg)
    phase_int8(gen, cfg, bf16_ms)
    bwd_launches = phase_train("bfloat16", timed=20)["bwd_launches"]
    f32_launches = phase_train("float32", timed=10)["bwd_launches"]
    phase_legacy()
    phase_cli()
    phase_hgam()
    phase_grade()
    phase_straighten()
    phase_profile_fwd(gen, cfg)
    del gen
    ablation, ablate_launches = phase_ablate()
    _, ablate_launches_f32 = phase_ablate(dtype=torch.float32)
    t = phase_timing()
    tb = phase_timing_bwd()
    t1 = phase_timing_v1()
    ta = phase_timing_ablate(ablation)
    tf = phase_timing(dtype=torch.float32)
    tfb = phase_timing_bwd(dtype=torch.float32)
    t1f = phase_timing_v1(dtype=torch.float32)
    taf = phase_timing_ablate_f32()
    phase_dist()
    src = "healthivert_tpu_torch/csrc/"
    pallas = "healthivert_tpu/ops/attention_pallas.py"
    rows = [dict(name="attention_v2", source=src + "attention_tc.cu", replaces=f"{pallas}:476",
                 launches=launches, **t),
            dict(name="attention_v2_bwd", source=src + "attention_tc.cu", replaces=f"{pallas}:772",
                 launches=bwd_launches, **tb),
            dict(name="attention_v2", source=src + "attention_tf32.cu", replaces=f"{pallas}:476",
                 launches=f32_launches, **tf),
            dict(name="attention_v2_bwd", source=src + "attention_tf32.cu",
                 replaces=f"{pallas}:772", launches=f32_launches, **tfb),
            dict(name="attention_scores_paste", source=src + "attention_tc_v1.cu",
                 replaces=f"{pallas}:199", launches=ablate_launches["attention_scores_paste"],
                 **t1),
            dict(name="attention_scores_paste", source=src + "attention_tf32_v1.cu",
                 replaces=f"{pallas}:199",
                 launches=ablate_launches_f32["attention_scores_paste"], **t1f)]
    for source, timing, counts in (("attention_tc_ablate.cu", ta, ablate_launches),
                                   ("attention_tf32_ablate.cu", taf, ablate_launches_f32)):
        rows += [dict(name=f"attn_ablate.{name}", source=src + source,
                      replaces=f"experiments/attn_ablate.py:{line}",
                      launches=counts[name], **timing[name])
                 for name, line in ABLATE_REPLACES.items()]
    emit("profiler", windows=len(PROFILE_LOST),
         windows_taken_again=sum(inside > 0 for _, inside in PROFILE_LOST),
         launches_without_kernel_record_before_and_inside=PROFILE_LOST)
    check(len(rows) == 14, f"kernels line: {len(rows)} rows")
    print(json.dumps({"kernels": [{
        "name": r["name"], "dtype": r["dtype"], "route": "cuda", "source": r["source"],
        "replaces": r["replaces"], "launches": r["launches"], "max_abs_err": r["max_abs_err"],
        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": None,
    } for r in rows]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
