"""scripts/bnn_backward_sass.py's readers of ptxas's log and of cuobjdump's
listing, on text shaped as those tools print it (the tools themselves run
only where the CUDA toolkit is)."""

import importlib.util
import pathlib

import pytest

SCRIPT = pathlib.Path(__file__).resolve().parents[1] / "scripts" / "bnn_backward_sass.py"


@pytest.fixture(scope="module")
def sass():
    spec = importlib.util.spec_from_file_location("bnn_backward_sass", SCRIPT)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


LISTING = """
\tcode for sm_90a
\t\tFunction : _ZN12_GLOBAL__N_115backward_kernelILb0ELb1EEEv14CUtensorMap_stS1_PfS2_S2_PdS3_PKfS3_NS_7BnnDimsEffiPx
\t.headerflags\t@"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                      /* 0x00000a00ff017b82 */
        /*0010*/                   LDG.E.64 R8, desc[UR4][R2.64] ;             /* 0x0000000402087981 */
        /*0020*/                   HGMMA.64x112x8.F32.TF32 R24, R16, gdesc[UR8], R24 ;
        /*0030*/                   LDG.E.64 R4, desc[UR4][R2.64] ;
        /*0040*/                   LDG.E.64 R6, desc[UR4][R10.64] ;
        /*0050*/              @!P0 BRA 0x90 ;
        /*0060*/                   STG.E.64 desc[UR4][R12.64], R4 ;
        /*0070*/                   LDG.E R6, desc[UR4][R14.64] ;
        /*0080*/                   STG.E desc[UR4][R12.64], R6 ;
        /*0090*/                   SHFL.BFLY PT, R4, R4, 0x10, 0x1f ;
        /*00a0*/                   STG.E.64 desc[UR4][R16.64], R4 ;
\t\tFunction : _ZN12_GLOBAL__N_112small_kernelILb0EEEvPfS1_S1_
        /*0000*/                   LDG.E R4, desc[UR4][R2.64] ;
"""

LOG = """ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_115backward_kernelILb1ELb0EEEv14CUtensorMap' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_115backward_kernelILb1ELb0EEEv14CUtensorMap
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 16 barriers, 736 bytes smem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_114forward_kernelE14CUtensorMap' for 'sm_90a'
ptxas info    : Used 168 registers, used 2 barriers, 8256 bytes smem
"""


def test_listing_is_split_into_the_backward_kernels(sass):
    funcs = sass.functions(LISTING)
    assert list(funcs) == [("0", "1")]
    assert len(funcs[("0", "1")]) == 11


def test_epilogue_runs_from_the_last_product_to_the_sums(sass):
    epi = sass.epilogue(sass.functions(LISTING)[("0", "1")])
    assert "LDG.E.64 R4" in epi[0] and "STG.E desc" in epi[-1]
    assert sass.pattern(epi) == "LL|SLS"
    assert sass.epilogue(["/*0000*/ LDG.E R4, desc[UR4][R2.64] ;"]) == []


def test_ptxas_lines_are_kept_per_instantiation(sass):
    regs = sass.ptxas_lines(LOG)
    assert list(regs) == [("1", "0")]
    assert "0 bytes spill stores" in regs[("1", "0")] and "Used 168 registers" in regs[("1", "0")]


def test_checkout_names_the_tree_a_source_lies_in(sass):
    src = pathlib.Path("/work/parent/hamiltorch_tpu_torch/kernels/csrc/bnn_hmc.cu")
    assert sass.checkout(src) == "parent"
