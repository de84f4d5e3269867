"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface.  (A ``Path`` in place of a
name is a source elsewhere in the checkout, such as the probe kernels that
``chip_smoke.py`` builds.)  It is compiled with
``nvcc`` for Hopper (``sm_90a``) into a shared library under ``build/``
beside this file (the directory is git-ignored) at first use, and loaded
with ``ctypes``.  The library's file name carries a hash of its source, of every
header under ``csrc/`` that the source includes (directly or through
another header), and of the flags, so an edited source or header is rebuilt
and a built one is reused.  Nothing
here runs at import time: this module is imported on machines without
``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")
    return str(path)


def _source(name) -> Path:
    return name if isinstance(name, Path) else CSRC / f"{name}.cu"


def sources(name) -> list:
    """``csrc/<name>.cu`` and every header it includes by a relative path."""
    found, todo = [], [_source(name)]
    while todo:
        path = todo.pop()
        if path in found:
            continue
        found.append(path)
        for inc in _INCLUDE.findall(path.read_text()):
            header = (path.parent / inc).resolve()
            if header.exists():
                todo.append(header)
    return found


def library_path(name) -> Path:
    """Where the library of ``csrc/<name>.cu`` is (or will be) built."""
    digest = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for path in sources(name):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"lib{_source(name).stem}-{digest.hexdigest()[:12]}.so"


def build_all(names) -> dict:
    """Compile every named source that is not built yet, all at once.

    One ``nvcc`` process per source, started together.  Returns
    ``{name: compiler log}`` (``-Xptxas -v`` reports each kernel's
    registers and shared memory) and raises with the log if one fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, outs = {}, set()
    for name in names:
        out = library_path(name)
        if out.exists() or out in outs:  # built, or the same sources named twice
            continue
        outs.add(out)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_source(name))]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, out)
    logs = {}
    try:
        for name, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            logs[name] = log
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {_source(name).name}:\n{log}")
            os.replace(tmp, out)
    finally:  # a failed build leaves no compiler running
        for proc, _, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return logs


@functools.lru_cache(maxsize=None)
def load(name) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    build_all([name])
    return ctypes.CDLL(str(library_path(name)))
