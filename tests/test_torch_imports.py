"""Guards: the port and chip_smoke.py import nothing of JAX or of the JAX
package (nor the repository's root `experiments` and `bench` modules, which
are JAX code), nor PIL, scikit-learn (`sklearn`), pandas, nibabel,
scikit-image (`skimage`) or openpyxl, which the machine with the card
lacks; and importing the port leaves them unloaded."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "healthivert_tpu_torch"
BANNED = {"jax", "jaxlib", "flax", "optax", "orbax", "healthivert_tpu", "experiments", "bench",
          "PIL", "sklearn", "pandas", "nibabel", "skimage", "openpyxl"}
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_nothing_of_jax(path):
    bad = sorted(set(_imported_roots(path)) & BANNED)
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_guard_sees_the_whole_package():
    names = {p.relative_to(PORT).as_posix() for p in SOURCES if PORT in p.parents}
    assert {"ops/attention_cuda.py", "engine/infer3d.py", "models/generator.py",
            "utils/weights.py", "data/sampler.py", "experiments/attn_ablate.py",
            "cli/train.py", "cli/test.py", "cli/eval_3d_sagittal_twostage.py",
            "config/options.py", "engine/visualizer.py", "utils/nifti.py",
            "models/hgam.py", "cli/grad_cam_3d_sagittal.py", "evaluation/svm.py",
            "evaluation/grading.py", "evaluation/rhlv.py", "evaluation/generation.py",
            "utils/table.py", "cli/svm_grading_2_5d.py", "straighten/curve.py",
            "straighten/pipeline.py", "straighten/axial.py", "ops/native_geometry.py",
            "cli/location_json_local.py", "cli/straighten_mask_3d.py",
            "data/raw_spine.py", "ops/int8_conv.py", "parallel/__init__.py",
            "parallel/mesh.py", "parallel/distributed.py", "models/legacy.py",
            "ops/edges.py", "ops/s2d.py", "ops/resample.py", "utils/image_pool.py",
            "utils/get_data.py", "data/transforms.py", "data/image_folder.py"} <= names


def test_importing_the_port_loads_no_jax():
    mods = sorted(
        "healthivert_tpu_torch." + ".".join(p.relative_to(PORT).with_suffix("").parts)
        for p in PORT.rglob("*.py") if p.name != "__init__.py"
    )
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{sorted(BANNED)!r})\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
