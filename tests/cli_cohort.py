"""A small straightened cohort on disk for the CLI parity tests
(tests/test_torch_cli*.py): four patients whose (64, 64, 16) spines hold
vertebrae 19-21, with files for vertebrae 20 and 21 (vertebra 19 sits too
close to the top row for the synthesis's band), CT uint8 and labels int16
as NIfTI, and a split with patient 1's vertebra 20 fractured (grade 3);
and a cohort for the evaluation CLIs (`write_eval_cohort`).
Written with the port's copies of the synthetic spine and the NIfTI writer
(held equal to the JAX package's by tests/test_torch_infer3d.py and
tests/test_torch_nifti.py), so that the card-only tests, on a machine
without JAX, can use it too."""

import json
import os

import numpy as np

from healthivert_tpu_torch.data.synthetic import make_spine_volume
from healthivert_tpu_torch.utils import nifti

SPLIT = {"train": {"p0_20": 0, "p0_21": 0, "p1_20": 3, "p1_21": 0, "p2_20": 0, "p2_21": 1},
         "test": {"p3_20": 0, "p3_21": 0}}
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHIPPED = os.path.join(ROOT, "checkpoints", "pretrained_synthetic")
NPZ = os.path.join(ROOT, "healthivert_tpu_torch", "weights", "pretrained_synthetic_generator.npz")


def write_cohort(root):
    rng = np.random.default_rng(0)
    for d in ("CT", "label"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    for p in range(4):
        ct, labels, _ = make_spine_volume(rng, shape=(64, 64, 16), vert_ids=(19, 20, 21),
                                          vert_height=12, gap=5,
                                          fractured={20: 0.6} if p == 1 else None)
        aff = np.diag([0.8, 0.9, 1.5, 1.0])
        aff[:3, 3] = (p, -2.0, 3.0)
        for v in (20, 21):
            nifti.save(nifti.Nifti1Image(ct.astype(np.uint8), aff),
                       os.path.join(root, "CT", f"p{p}_{v}.nii.gz"))
            nifti.save(nifti.Nifti1Image(labels.astype(np.int16), aff),
                       os.path.join(root, "label", f"p{p}_{v}.nii.gz"))
    with open(os.path.join(root, "vertebra_data_local.json"), "w") as f:
        json.dump(SPLIT, f)
    return root


def write_eval_cohort(root):
    """CT/ (uint8), label/ (int16) and a split.json of 12 train/test and 4
    val vertebrae (128 x 128 x 32, vertebra 20 graded 0, 2 or 3 by its
    compression), and output_3d/{exp_sag, exp_coronal}/ with CT_fake/ and
    label_fake/ (a healthy spine, the CT with noise): the input of the
    RHLV, grading and generation-quality CLIs. Returns root."""
    from pathlib import Path

    root = Path(root)
    exps = ("exp_sag", "exp_coronal")
    for d in ["CT", "label"] + [f"output_3d/{e}/{s}" for e in exps
                                for s in ("CT_fake", "label_fake")]:
        (root / d).mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(0)
    kw = dict(shape=(128, 128, 32), vert_ids=(19, 20, 21), vert_height=18, gap=8)
    split = {"train": {}, "test": {}, "val": {}}
    fracs = (1.0, 0.5, 1.0, 0.7, 1.0, 0.55, 1.0, 0.75, 1.0, 0.6, 1.0, 0.72, 1.0, 0.5, 0.7, 1.0)
    for i, frac in enumerate(fracs):
        pv = f"p{i:02d}_20"
        ct, lb, _ = make_spine_volume(rng, fractured={20: frac}, **kw)
        fct, flb, _ = make_spine_volume(rng, **kw)
        fct = np.clip(fct + rng.normal(0, 5, fct.shape), 0, 255)
        nifti.save(nifti.Nifti1Image(ct.astype(np.uint8)), str(root / "CT" / f"{pv}.nii.gz"))
        nifti.save(nifti.Nifti1Image(lb), str(root / "label" / f"{pv}.nii.gz"))
        for e in exps:
            nifti.save(nifti.Nifti1Image(fct.astype(np.float32)),
                       str(root / "output_3d" / e / "CT_fake" / f"{pv}.nii.gz"))
            nifti.save(nifti.Nifti1Image(flb.astype(np.float32)),
                       str(root / "output_3d" / e / "label_fake" / f"{pv}.nii.gz"))
        phase = "train" if i < 8 else ("test" if i < 12 else "val")
        split[phase][pv] = 0 if frac == 1.0 else (3 if frac <= 0.6 else 2)
    (root / "split.json").write_text(json.dumps(split))
    return root


def shipped_run_dir(tmp):
    """A checkpoints dir whose run 'pretrained_synthetic' links the shipped
    orbax generator, so that the JAX CLIs write their opt.txt there and
    not into the repository."""
    ck = os.path.join(tmp, "ck_jax")
    os.makedirs(os.path.join(ck, "pretrained_synthetic"), exist_ok=True)
    link = os.path.join(ck, "pretrained_synthetic", "generator")
    if not os.path.exists(link):
        os.symlink(os.path.join(SHIPPED, "generator"), link)
    return ck


def skip_jax_init(monkeypatch, *modules):
    """Give the JAX package's CLIs in `modules` a TrainState of zeros in
    init_state's shapes (jax.eval_shape, no compile) in place of its eager
    initialisation (a few hundred small CPU compiles, ~35 s here). Every
    test that uses it loads a checkpoint that replaces each of those zeros
    the networks read: the shipped generator, or a .pth with G, D_1-D_3 and
    their statistics; Adam's states and the step start at zero as they
    would."""
    import jax
    import numpy as np

    from healthivert_tpu.models import pix2pix as jpix

    def zeros(rng, cfg, batch_size=1):
        shapes = jax.eval_shape(lambda r: jpix.init_state(r, cfg, batch_size), rng)
        return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)

    for mod in modules:
        monkeypatch.setattr(mod, "init_state", zeros)
