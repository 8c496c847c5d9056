"""Builds the CUDA sources under ``csrc/`` and loads them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and becomes one shared
library ``build/lib<name>_<hash>.so``, compiled by ``nvcc`` for ``sm_90a``
at first use (``csrc/*.cuh`` are headers the sources share). The hash covers
the source, the headers and the flags, so an edited source
is rebuilt and a stale library is never loaded. All missing libraries are
compiled at once, one ``nvcc`` process each. A build or load failure raises
with the compiler's output; nothing falls back.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: dict[str, ctypes.CDLL] = {}


def on_device(t):
    """The CUDA runtime's current device set to ``t``'s around a launch:
    a library launches on the current device, and sets its kernels'
    attributes and reads its SM count there, whatever stream it is given.
    Nothing for a CPU tensor (the g++ rehearsal drives the launch functions
    with CPU tensors)."""
    if not t.is_cuda:
        return contextlib.nullcontext()
    import torch

    return torch.cuda.device(t.device)


def kernel_names() -> list[str]:
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found (looked on PATH, $CUDA_HOME, $CUDA_PATH and "
        "/usr/local/cuda): the CUDA kernels cannot be built"
    )


def library_path(name: str) -> Path:
    """The library's path; its hash covers the source, the headers of
    ``csrc/`` it may include and the flags."""
    src = CSRC_DIR / f"{name}.cu"
    headers = b"".join(p.read_bytes() for p in sorted(CSRC_DIR.glob("*.cuh")))
    h = hashlib.sha256(src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(names=None) -> dict[str, Path]:
    """Compile every library of ``names`` (default: all) that is missing;
    the compilers run side by side. Returns {name: path}."""
    names = kernel_names() if names is None else list(names)
    paths = {n: library_path(n) for n in names}
    todo = [n for n in names if not paths[n].exists()]
    if not todo:
        return paths
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for n in todo:
        tmp = paths[n].with_suffix(f".tmp{os.getpid()}.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{n}.cu")]
        procs.append((n, tmp, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )))
    failures = []
    for n, tmp, cmd, proc in procs:
        log, _ = proc.communicate()
        (BUILD_DIR / f"{n}.nvcc.log").write_text(" ".join(cmd) + "\n" + log)
        if proc.returncode != 0:
            failures.append(f"{' '.join(cmd)}\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, paths[n])
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu``, built first if need be."""
    lib = _loaded.get(name)
    if lib is None:
        path = build([name])[name]
        lib = ctypes.CDLL(str(path))
        _loaded[name] = lib
    return lib


def use_library(name: str, path=None) -> None:
    """Make ``load(name)`` return the library at ``path`` (or a
    ``ctypes.CDLL`` already loaded) instead of the one built from
    ``csrc/<name>.cu`` (for timing a variant of a source); ``path=None``
    goes back to the one built from ``csrc/``."""
    if path is None:
        _loaded.pop(name, None)
    else:
        _loaded[name] = path if isinstance(path, ctypes.CDLL) else ctypes.CDLL(str(path))


def in_use(name: str):
    """The library ``load(name)`` returns now, or None where it would build
    ``csrc/<name>.cu`` first."""
    return _loaded.get(name)


def build_log(name: str) -> str:
    """What nvcc printed for the last build of ``name`` (registers, shared
    memory and spills of each kernel: ``-Xptxas -v``)."""
    p = BUILD_DIR / f"{name}.nvcc.log"
    return p.read_text() if p.exists() else ""
