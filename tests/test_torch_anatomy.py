"""scripts/kernel_anatomy_torch.py's ablations, checked against the package's
current kernel sources on the CPU (no nvcc, no build): each text an ablation
replaces must be found exactly the stated number of times, so that an edit
of the kernels that moves such a text fails here and not on the card."""

import importlib.util
import pathlib

import pytest

SCRIPT = pathlib.Path(__file__).resolve().parents[1] / "scripts" / "kernel_anatomy_torch.py"


def _script():
    spec = importlib.util.spec_from_file_location("kernel_anatomy_torch", SCRIPT)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


anatomy = _script()


@pytest.mark.parametrize("name", sorted(anatomy.ABLATIONS))
def test_ablation_applies_to_the_package_source(name):
    source, header, edits = anatomy.ABLATIONS[name]
    assert (anatomy._build.CSRC / f"{source}.cu").exists()
    original = (anatomy._build.CSRC / header).read_text()
    for old, _, times in edits:
        assert original.count(old) == times, (name, old)
    ablated = anatomy.ablated_text(name)
    assert ablated != original
    for old, new, _ in edits:
        assert new in ablated
