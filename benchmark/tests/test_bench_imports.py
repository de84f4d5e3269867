"""No run loads JAX or the JAX package, and the reference loads nothing of
the port.  Top-level module names are compared whole: the port's name
begins with the JAX package's."""

import subprocess
import sys
import textwrap

import pytest
from bench_tiny import ROOT

from benchmark.core import BANNED, banned_modules


def _modules_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code)], cwd=ROOT,
                         capture_output=True, text=True, timeout=300, check=True)
    return set(out.stdout.split())


def test_dry_run_of_the_harness_with_the_port_loads_no_jax(tmp_path):
    """A whole run of a tiny cell on the CPU through the port's own entry."""
    loaded = _modules_after(f"""
        import sys
        sys.path.insert(0, {str(ROOT)!r}); sys.path.insert(0, {str(ROOT / 'benchmark/tests')!r})
        from pathlib import Path
        from bench_chains import CELL, chains_copy
        from bench_tiny import run_tiny
        bench = chains_copy(Path({str(tmp_path)!r}))
        for cell in ("bnn_tiny.hmc_tiny", "gauss_tiny.gauss_tiny", CELL):
            for trace in (False, True):
                run_tiny(bench, cell, None, trace=trace)
        print(*sys.modules)
    """)
    assert {"hamiltorch_tpu_torch.kernels.bnn_hmc", "hamiltorch_tpu_torch.samplers.hmc",
            "hamiltorch_tpu_torch.models.bnn"} <= loaded
    assert not {m for m in loaded if m.split(".")[0] in BANNED}


REFERENCE = sorted((ROOT / "benchmark/reference").glob("*.py"))


def test_reference_loads_nothing_of_either_package():
    names = [f"benchmark.reference.{p.stem}" for p in REFERENCE if p.stem != "__init__"]
    assert {"benchmark.reference.streams", "benchmark.reference.hmc_chains"} <= set(names)
    loaded = _modules_after(f"""
        import importlib, sys
        sys.path.insert(0, {str(ROOT)!r})
        for name in {names!r}:
            importlib.import_module(name)
        print(*sys.modules)
    """)
    tops = {m.split(".")[0] for m in loaded}
    assert not tops & {"jax", "jaxlib", "flax", "hamiltorch_tpu", "hamiltorch_tpu_torch"}


@pytest.mark.parametrize("path", REFERENCE, ids=lambda p: p.name)
def test_reference_sources_name_neither_package(path):
    text = path.read_text()
    assert "hamiltorch_tpu" not in text and "import jax" not in text


def test_banned_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "hamiltorch_tpu_torch_probe", sys)
    assert "hamiltorch_tpu_torch_probe" not in banned_modules()
    monkeypatch.setitem(sys.modules, "hamiltorch_tpu.probe", sys)
    assert "hamiltorch_tpu.probe" in banned_modules()
