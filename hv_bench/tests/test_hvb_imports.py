"""Nothing of the benchmark loads JAX or the JAX package: an AST scan of
every file of hv_bench/ (whole top-level names: the system's package name
begins with the JAX package's), the reference free of the system, and a
run of the harness's CPU pieces in a fresh process."""

import ast
import json
import subprocess
import sys

import pytest

from hv_bench.run import FORBIDDEN
from hv_bench.tests.conftest import REPO

HV = REPO / "hv_bench"
SOURCES = sorted(p for p in HV.rglob("*.py") if "__pycache__" not in p.parts)


def imported(path):
    """Top-level names of a file's absolute imports, and its relative
    imports as (level, module)."""
    names, rel = set(), []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                rel.append((node.level, node.module or ""))
            else:
                names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                names.add(str(node.args[0].value).split(".")[0])
    return names, rel


def test_prefix_is_not_enough():
    assert "healthivert_tpu_torch".startswith("healthivert_tpu")
    assert "healthivert_tpu_torch".split(".")[0] not in FORBIDDEN


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HV)))
def test_no_forbidden_import(path):
    names, _ = imported(path)
    assert not names & set(FORBIDDEN), names & set(FORBIDDEN)


@pytest.mark.parametrize("path", sorted((HV / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_is_plain(path):
    names, rel = imported(path)
    assert names <= {"__future__", "typing", "math", "numpy", "torch", "scipy"}, names
    assert all(level == 1 for level, _ in rel), rel


def test_harness_cpu_run_loads_nothing_forbidden(tiny_root):
    code = (
        "import json, sys\n"
        "from hv_bench import run\n"
        f"run.main(['--workload', 'synth3d-bf16', '--seed', '7', '--seconds', '0.5',"
        f" '--trace', '1'], device='cpu', root={str(tiny_root)!r})\n"
        "print(json.dumps(run.forbidden_modules()))\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    result, loaded = p.stdout.strip().splitlines()[-2:]
    assert json.loads(loaded) == []
    assert set(json.loads(result)) >= {"correct", "attempted", "failed", "metrics", "device"}
