"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for Hopper (``sm_90a``)
into a shared library with a plain C interface, loaded through
``ctypes``. The build runs at first use, into ``build/repro_torch_kernels/``
at the repository root (listed in ``.gitignore``), and the library's file
name carries a hash of its source and flags, so an edited source is
rebuilt and a stale library is never loaded. ``build_all`` starts one
``nvcc`` per source at once and waits for all of them.

Nothing here runs at import time: the CPU test suite imports every
module on a machine without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" \
    / "repro_torch_kernels"
SOURCES = ("hash_join", "segment_reduce", "flash_attention",
           "flash_attention_wgmma", "rglru_scan", "rwkv6_scan",
           "rwkv6_scan_tc", "moe_gmm", "moe_gmm_wgmma")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LIBS: dict[str, ctypes.CDLL] = {}


def cuda_tool(name: str) -> str | None:
    """Path of a CUDA toolkit program (``nvcc``, ``cuobjdump``), or None."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = pathlib.Path(home) / "bin" / name
    return str(path) if path.exists() else shutil.which(name)


def _nvcc() -> str:
    found = cuda_tool("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch "
                           "build only on a machine with the CUDA toolkit")
    return found


def library_path(name: str) -> pathlib.Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build_all(names=SOURCES) -> dict[str, dict]:
    """Compile every named source whose library is missing, all ``nvcc``
    processes at once. Returns ``{name: {"seconds", "log"}}`` for the
    sources it built (``log`` holds ptxas' register and shared-memory
    report). Raises with the compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for name in todo:
        tmp = library_path(name).with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    report, failed = {}, []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {name}.cu (nvcc exit {proc.returncode})\n"
                          f"{log}")
            continue
        os.replace(tmp, library_path(name))   # atomic: no torn library
        report[name] = {"seconds": time.perf_counter() - t0, "log": log}
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all((name,))
        lib = _LIBS[name] = ctypes.CDLL(str(library_path(name)))
    return lib


def check(rc: int, what: str) -> None:
    """Raise when a C entry point reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
