"""Build the port's CUDA kernels from the repository's sources, at first use.

Each kernel is one ``.cu`` file with a plain C interface, compiled by
``nvcc`` for ``sm_90a`` into a shared library and loaded with ``ctypes``
(no PyTorch headers: a build takes seconds, not minutes).  Libraries go
to ``build/repro_torch_kernels/`` at the repository root (listed in
``.gitignore``), in a directory keyed by a hash of the source, the
headers it includes with quotes (``common/tf32_mma.cuh``) and the flags,
so an edited source or header rebuilds.  A failed build raises with the
compiler's output; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Tuple

REPO_ROOT = Path(__file__).resolve().parents[3]
BUILD_ROOT = REPO_ROOT / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[Path, ctypes.CDLL] = {}
_INCLUDE = re.compile(r'^[ \t]*#[ \t]*include[ \t]+"([^"]+)"', re.M)


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                       "port's CUDA kernels are built from source with it")


def sources_of(source: Path) -> List[Path]:
    """``source`` and every header it includes with quotes, recursively
    (paths relative to the including file, as the compiler reads them)."""
    found: List[Path] = []
    todo = [source.resolve()]
    while todo:
        path = todo.pop()
        if path not in found:
            found.append(path)
            todo += [(path.parent / name).resolve()
                     for name in _INCLUDE.findall(path.read_text())]
    return found


def library_path(source: Path) -> Path:
    h = hashlib.sha256()
    for path in sources_of(source):
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()
    return BUILD_ROOT / f"{source.stem}-{digest[:16]}" / f"lib{source.stem}.so"


def compile_source(source: Path) -> Tuple[Path, str]:
    """Compile ``source`` unless its library is already built.  Returns
    the library path and the compiler's output (``-Xptxas -v``: each
    kernel's registers, shared memory and spills); empty when cached."""
    lib = library_path(source)
    if lib.exists():
        return lib, ""
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}) on {source}:\n"
                           f"{' '.join(cmd)}\n{log}")
    os.replace(tmp, lib)     # atomic: concurrent builders never see half
    (lib.parent / "build.log").write_text(log)
    return lib, log


def load(source: Path) -> ctypes.CDLL:
    """The loaded library of ``source``, building it first if needed."""
    lib = library_path(source)
    if lib not in _loaded:
        compile_source(source)
        _loaded[lib] = ctypes.CDLL(str(lib))
    return _loaded[lib]
