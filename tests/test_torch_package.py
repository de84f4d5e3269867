"""The port's package boundary: torch only, no JAX, mirrored module paths."""

import pathlib
import re
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "hamiltorch_tpu_torch"
# modules of the port with no JAX counterpart
PORT_ONLY = {"utils/convert.py", "kernels/_build.py", "kernels/bnn_grad.py", "utils/precision.py",
             "models/resnet_frn.py", "kernels/frn_tlu.py", "kernels/conv3x3.py",
             "models/cnn_lstm.py"}
# CUDA sources with no Pallas counterpart: the gradient alone, for tests and
# timing; FRN with TLU and the same-width 3x3 convolution, for the port's
# ResNet-20-FRN (the JAX package has no FRN and leaves convolutions to XLA)
CSRC_ONLY = {"bnn_grad.cu", "frn_tlu.cu", "conv3x3.cu"}


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
                         + ["chip_smoke.py", "scripts/profile_bnn_hmc_torch.py",
                            "scripts/profile_mclmc_torch.py", "scripts/kernel_anatomy_torch.py",
                            "scripts/resnet20_conv_split_torch.py",
                            "scripts/gaussian_sum_order_torch.py",
                            "scripts/rmhmc_designs_torch.py", "scripts/psum_overhead_torch.py",
                            "scripts/bnn_backward_sass.py"])
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
        if src.name in CSRC_ONLY:
            continue
        assert (REPO / "hamiltorch_tpu" / "kernels" / f"{src.stem}.py").exists(), src.name


def test_entry_points_default_to_the_card():
    """With no device given, the factories put their tensors on the card,
    and without one they raise instead of falling back to the CPU."""
    import numpy as np
    import torch

    from hamiltorch_tpu_torch.models import flagship
    from hamiltorch_tpu_torch.utils.convert import from_jax_params

    calls = [
        lambda: flagship.make_flagship_potential(8, 4, 16)[1],
        lambda: flagship.make_flagship_potential_tree(8, 4, 16)[1]["w1"],
        lambda: flagship.make_tiny_potential()[4],
        lambda: from_jax_params(np.zeros(3, np.float32))[0],
    ]
    for call in calls:
        if torch.cuda.is_available():
            assert call().device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                call()
    assert from_jax_params(np.zeros(3, np.float32), device="cpu")[0].device.type == "cpu"


def test_library_name_hashes_every_included_header(tmp_path, monkeypatch):
    from hamiltorch_tpu_torch.kernels import _build

    (tmp_path / "k.cu").write_text('#include "a.cuh"\n#include <cuda_runtime.h>\nint k;\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("int b = 1;\n")
    (tmp_path / "unused.cuh").write_text("int u;\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    assert sorted(p.name for p in _build.sources("k")) == ["a.cuh", "b.cuh", "k.cu"]
    before = _build.library_path("k")
    (tmp_path / "unused.cuh").write_text("int u = 2;\n")
    assert _build.library_path("k") == before
    (tmp_path / "b.cuh").write_text("int b = 2;\n")  # a header included through another
    assert _build.library_path("k") != before


@pytest.mark.parametrize("module", ["samplers", ""])
def test_exports_mirror_the_jax_package(module):
    """``__all__`` of ``samplers`` lists the JAX package's names that the
    port has, in the JAX package's order, and nothing else; the top level
    exports MAMS, ChEES, SG-MCMC, PT, TI, SMC, Barker, the stretch move,
    elliptical slice and ``optim`` as the JAX package does.  Every name
    resolves."""
    import importlib

    suffix = f".{module}" if module else ""
    jax_mod = importlib.import_module(f"hamiltorch_tpu{suffix}")
    port = importlib.import_module(f"hamiltorch_tpu_torch{suffix}")
    for name in port.__all__:
        assert getattr(port, name) is not None, name
    if module == "samplers":
        assert port.__all__ == [n for n in jax_mod.__all__ if n in set(port.__all__)]
        assert set(port.__all__) >= {"ChainState", "run_mcmc", "hmc_transition",
                                     "DualAveragingState", "da_init", "da_update",
                                     "MAMSConfig", "MAMSResult", "MAMSStats", "run_mams",
                                     "run_mams_chains", "ChEESConfig", "ChEESResult",
                                     "run_chees", "SGLDConfig", "SGHMCConfig", "SGMCMCResult",
                                     "run_sgld", "run_sgld_chains", "run_sghmc",
                                     "run_sghmc_chains", "PTConfig", "PTResult",
                                     "run_parallel_tempering", "run_pt_chains", "TIConfig",
                                     "TIResult", "evidence_from_loglik_draws", "run_ti",
                                     "SMCConfig", "SMCResult", "run_smc",
                                     "smc_posterior_sample", "StretchConfig", "StretchResult",
                                     "StretchStats", "run_stretch", "EllipticalConfig",
                                     "EllipticalResult", "EllipticalStats", "run_elliptical",
                                     "run_elliptical_chains"}
    else:
        assert {"MAMSConfig", "MAMSResult", "run_mams", "run_mams_chains", "ChEESConfig",
                "ChEESResult", "run_chees", "SGLDConfig", "SGHMCConfig", "CSGMCMCConfig",
                "run_csgmcmc", "run_csgmcmc_chains", "run_sgld", "run_sgld_chains",
                "run_sghmc", "run_sghmc_chains", "PTConfig", "run_parallel_tempering",
                "run_pt_chains", "SMCConfig", "run_smc", "smc_posterior_sample", "TIConfig",
                "run_ti", "BarkerConfig", "BarkerResult", "run_barker", "run_barker_chains",
                "StretchConfig", "StretchResult", "run_stretch", "EllipticalConfig",
                "EllipticalResult", "run_elliptical", "run_elliptical_chains", "map_estimate",
                "MAPResult", "laplace_approx", "laplace_sample", "LaplaceResult", "advi",
                "advi_cov", "advi_sample", "ADVIResult"} <= set(port.__all__)
        # the top level lacks no name of the JAX package's
        assert set(jax_mod.__all__) - set(port.__all__) == set()
        assert {"SVGDConfig", "SVGDResult", "run_svgd"} <= set(port.__all__)
    assert set(port.__all__) <= set(jax_mod.__all__) | {"next_key"}
    if module == "":  # the checkpoint module has every driver of the JAX module
        import hamiltorch_tpu.checkpoint as jck
        import hamiltorch_tpu_torch.checkpoint as tck

        drivers = {n for n in dir(jck) if n.startswith("run_") and n.endswith("_checkpointed")}
        assert len(drivers) == 15
        assert all(callable(getattr(tck, n, None)) for n in drivers), drivers - set(dir(tck))


# this slice's entry points: (module, name)
SIGNATURES = [("samplers.barker", "run_barker"), ("samplers.barker", "run_barker_chains"),
              ("samplers.stretch", "run_stretch"), ("samplers.elliptical", "run_elliptical"),
              ("samplers.elliptical", "run_elliptical_chains"),
              ("checkpoint", "run_barker_checkpointed"), ("checkpoint", "run_stretch_checkpointed"),
              ("optim", "map_estimate"), ("optim", "laplace_approx"), ("optim", "laplace_sample"),
              ("optim", "advi"), ("optim", "advi_cov"), ("optim", "advi_sample"),
              ("svgd", "run_svgd"), ("parallel.sharding", "make_mesh"),
              ("parallel.sharding", "make_psum_log_prob"),
              ("parallel.sharding", "sample_chains_sharded"),
              ("parallel.sharding", "run_hmc_chains_sharded"),
              ("parallel.sharding", "run_nuts_chains_sharded"),
              ("parallel.sharding", "sample_nuts_chains_sharded"),
              ("parallel.sharding", "run_rmhmc_chains_sharded"),
              ("parallel.sharding", "run_nuts_ensemble_sharded"),
              ("parallel.sharding", "sample_nuts_ensemble_sharded"),
              ("parallel.sharding", "run_chees_sharded"),
              ("parallel.sharding", "sample_chees_sharded"),
              ("parallel.sharding", "run_pt_sharded"), ("parallel.sharding", "sample_pt_sharded"),
              ("parallel.sharding", "run_ti_sharded"), ("parallel.sharding", "run_sgld_sharded"),
              ("parallel.sharding", "run_sghmc_sharded"),
              ("parallel.sharding", "run_csgmcmc_sharded"),
              ("parallel.sharding", "run_svgd_sharded"),
              ("parallel.sharding", "run_mclmc_sharded"),
              ("parallel.sharding", "sample_mclmc_sharded"),
              ("parallel.sharding", "run_mams_sharded"),
              ("parallel.sharding", "sample_mams_sharded"),
              ("parallel.sharding", "run_barker_sharded"),
              ("parallel.sharding", "run_stretch_sharded"),
              ("parallel.sharding", "mesh_chain_layout"),
              ("parallel.sharding", "derive_chain_keys"),
              ("parallel.multihost", "initialize_multihost"),
              ("parallel.multihost", "global_chain_mesh"),
              ("parallel.multihost", "run_cluster_selftest"),
              ("parallel.multihost", "launch_localhost_cluster"),
              ("checkpoint", "run_nuts_ensemble_checkpointed"),
              ("checkpoint", "run_chees_checkpointed"), ("checkpoint", "run_pt_checkpointed")]


@pytest.mark.parametrize("module,name", SIGNATURES, ids=[n for _, n in SIGNATURES])
def test_signatures_keep_the_jax_parameters(module, name):
    """Every JAX parameter, in its order and with its default; the port adds
    only its test hooks (``_noise``, ``_margins``) and ``device``."""
    import importlib
    import inspect

    jax_params = inspect.signature(getattr(importlib.import_module(f"hamiltorch_tpu.{module}"),
                                           name)).parameters
    port_params = inspect.signature(getattr(importlib.import_module(
        f"hamiltorch_tpu_torch.{module}"), name)).parameters
    assert [k for k in port_params if k in jax_params] == list(jax_params)
    for k, p in jax_params.items():
        assert port_params[k].default == p.default, k
    assert set(port_params) - set(jax_params) <= {"_noise", "_margins", "device"}
