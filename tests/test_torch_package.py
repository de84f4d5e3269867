"""The port's package boundary: torch only, no JAX, mirrored module paths."""

import pathlib
import re
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "hamiltorch_tpu_torch"
# modules of the port with no JAX counterpart
PORT_ONLY = {"utils/convert.py", "kernels/_build.py"}


def test_imports_with_jax_blocked():
    """Every module of the port imports while ``import jax`` fails."""
    code = (
        "import sys, importlib, pkgutil\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['hamiltorch_tpu'] = None\n"
        "import hamiltorch_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.mark.parametrize("path", sorted(str(p.relative_to(REPO)) for p in PORT.rglob("*.py"))
                         + ["chip_smoke.py", "scripts/profile_bnn_hmc_torch.py"])
def test_no_jax_import(path):
    src = (REPO / path).read_text()
    assert not re.search(r"^\s*(import jax|from jax\b|import hamiltorch_tpu\b|from hamiltorch_tpu\b)",
                         src, re.MULTILINE), path


def test_module_paths_mirror_the_jax_package():
    for p in PORT.rglob("*.py"):
        rel = p.relative_to(PORT).as_posix()
        if rel in PORT_ONLY:
            continue
        assert (REPO / "hamiltorch_tpu" / rel).exists(), rel
    for src in (PORT / "kernels" / "csrc").glob("*.cu"):
        assert (REPO / "hamiltorch_tpu" / "kernels" / f"{src.stem}.py").exists(), src.name
