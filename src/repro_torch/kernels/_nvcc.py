"""Build the port's CUDA sources with ``nvcc`` into shared libraries.

Every kernel under ``csrc/`` has a plain C interface and is compiled on
its first CUDA call by hand (no PyTorch headers, so a build takes
seconds) for ``sm_90a`` into ``build/`` at the root of the checkout.  A
library is named by the hash of its source, the headers beside it and
the flags, so a changed source or header builds anew.  Each build writes
a temporary file and moves it into place, so processes that build the
same source at once never load a half-written library.  :func:`build_all` starts one ``nvcc`` per source, all at once.
"""

from __future__ import annotations

import hashlib
import os
import pathlib
import subprocess
import tempfile
from typing import Dict, Sequence, Tuple

BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: the port's kernels build from "
                           "kernels/csrc/*.cu with the CUDA toolkit")
    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError(f"nvcc not found at {nvcc}")
    return nvcc


def library_path(source: pathlib.Path) -> pathlib.Path:
    """The library of ``source``, named by the hash of the source, the
    headers beside it (``*.cuh``, which it may include) and the flags."""
    text = source.read_bytes()
    for header in sorted(source.parent.glob("*.cuh")):
        text += header.read_bytes()
    tag = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{source.stem}-{tag[:16]}.so"


def build_all(sources: Sequence[pathlib.Path]
              ) -> Dict[pathlib.Path, Tuple[pathlib.Path, str]]:
    """Compile every source whose library is not in ``build/`` yet, one
    ``nvcc`` process per source, all running at once.  Returns source ->
    (library path, the compiler's output: the ptxas register and
    shared-memory report, empty when nothing was built)."""
    out: Dict[pathlib.Path, Tuple[pathlib.Path, str]] = {}
    running = []
    for src in sources:
        lib = library_path(src)
        if lib.exists():
            out[src] = (lib, "")
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running.append((src, lib, tmp, proc))
    errors = []
    for src, lib, tmp, proc in running:
        log, _ = proc.communicate()
        try:
            if proc.returncode != 0:
                errors.append(f"nvcc failed on {src.name}:\n{log}")
            else:
                os.replace(tmp, lib)
                out[src] = (lib, log)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


def build(source: pathlib.Path) -> Tuple[pathlib.Path, str]:
    """:func:`build_all` for one source."""
    return build_all([source])[source]
