"""How the BNN backward's epilogue orders its global loads and stores (SASS).

Builds a source that includes ``csrc/bnn_grad.cuh`` (``bnn_hmc`` by default,
or a ``.cu`` file given by path, such as an earlier checkout's), disassembles
the library with ``cuobjdump -sass`` and, for each ``backward_kernel``
instantiation, takes the epilogue: from the last ``HGMMA`` (the products'
end) to the first ``SHFL`` after it (the tile's sums).  It prints

  - the registers and spills ``-Xptxas -v`` reported for the instantiation;
  - the epilogue's global memory operations in program order as one string,
    ``L`` a load (``LDG``) and ``S`` a store (``STG``), ``|`` a branch;
  - the number of load runs (maximal runs of loads with no store between
    them), and the loads issued before the first store.

A load that follows a store the compiler cannot prove apart from it waits
for nothing in hardware, but it cannot be moved above that store, so a
string like ``LSLSLS...`` is one memory round trip a step, and ``LLLL...SSSS``
one a run.  The whole listing of each epilogue goes to
``<out>/<checkout>.<source>.<DOTS><PHASES>.sass`` (``--out``, by default
``sass/`` in the package's git-ignored build directory).  Run from the root
of a checkout on a machine with the CUDA toolkit:

    python3 scripts/bnn_backward_sass.py [--out DIR] [SOURCE.cu ...]
"""

from __future__ import annotations

import argparse
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from hamiltorch_tpu_torch.kernels import _build  # noqa: E402

KERNEL = re.compile(r"backward_kernelILb([01])ELb([01])E")


def cuobjdump() -> str:
    found = shutil.which("cuobjdump")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    return str(Path(cuda_home) / "bin" / "cuobjdump")


def ptxas_lines(log: str) -> dict:
    """{(DOTS, PHASES): 'registers ..., spills ...'} from an -Xptxas -v log."""
    out, kernel = {}, None
    for line in log.splitlines():
        if "Compiling entry" in line or "Function properties" in line:
            m = KERNEL.search(line)
            kernel = (m.group(1), m.group(2)) if m else None
        elif kernel and ("registers" in line or "spill" in line):
            out[kernel] = (out.get(kernel, "") + " " + line.split(":", 1)[-1].strip()).strip()
    return out


def functions(sass: str) -> dict:
    """{(DOTS, PHASES): [instruction lines]} of the backward kernels."""
    out, name, body = {}, None, []
    for line in sass.splitlines():
        if "Function :" in line:
            if name:
                out[name] = body
            m = KERNEL.search(line)
            name, body = ((m.group(1), m.group(2)) if m else None), []
        elif name and re.search(r"/\*[0-9a-f]{4,}\*/", line):
            body.append(line.strip())
    if name:
        out[name] = body
    return out


def epilogue(body: list) -> list:
    last = max((i for i, line in enumerate(body) if "HGMMA" in line), default=-1)
    if last < 0:
        return []
    end = next((i for i in range(last, len(body)) if "SHFL" in body[i]), len(body))
    return body[last + 1:end]


def pattern(lines: list) -> str:
    out = []
    for line in lines:
        if re.search(r"\bLDG\b|\bLDG\.", line):
            out.append("L")
        elif re.search(r"\bSTG\b|\bSTG\.", line):
            out.append("S")
        elif re.search(r"\bBRA\b", line):
            out.append("|")
    return "".join(out)


def checkout(src: Path) -> str:
    """The name of the checkout a source under <checkout>/hamiltorch_tpu_torch/kernels/csrc lies in."""
    return src.parents[3].name if len(src.parents) > 3 else src.parent.name


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("sources", nargs="*", help=".cu files that include bnn_grad.cuh "
                        "(default: the package's bnn_hmc.cu)")
    parser.add_argument("--out", type=Path, default=_build.BUILD_DIR / "sass",
                        help="directory for the epilogues' listings")
    opts = parser.parse_args()
    sources = [Path(s).resolve() for s in opts.sources] or [_build.CSRC / "bnn_hmc.cu"]
    opts.out.mkdir(parents=True, exist_ok=True)
    for src in sources:
        lib = _build.library_path(src)
        if lib.exists():
            lib.unlink()  # rebuilt, so that -Xptxas -v reports it
        log = _build.build_all([src])[src]
        regs = ptxas_lines(log)
        sass = subprocess.run([cuobjdump(), "-sass", str(lib)], capture_output=True, text=True,
                              check=True).stdout
        tag = f"{checkout(src)}/{src.name}"
        for (dots, phases), body in sorted(functions(sass).items()):
            epi = epilogue(body)
            pat = pattern(epi)
            mem = pat.replace("|", "")
            runs = len(re.findall(r"L+", mem))
            before = len(mem) - len(mem.lstrip("L"))
            name = f"backward_kernel<{bool(int(dots))}, {bool(int(phases))}>"
            print(f"{tag} {name}: {regs.get((dots, phases), 'no ptxas line')}")
            print(f"  epilogue: {len(epi)} instructions, {mem.count('L')} loads, "
                  f"{mem.count('S')} stores, {runs} load runs, {before} loads before the "
                  f"first store")
            print(f"  {pat}")
            (opts.out / f"{checkout(src)}.{src.stem}.{dots}{phases}.sass").write_text("\n".join(epi) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
