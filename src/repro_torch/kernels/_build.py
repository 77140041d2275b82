"""Build the CUDA kernels into one shared library and load it.

Route: ``nvcc`` by hand into a shared library with a plain C interface,
loaded with ``ctypes`` (no PyTorch headers, so a build takes seconds).
Each ``csrc/*.cu`` is compiled to an object by its own ``nvcc``, all
started together, and the objects are linked into one ``.so`` whose name
carries a hash of the sources, headers and flags. The build happens at
first use, into ``kernels/build/`` (listed in ``.gitignore``); nothing is
built when this module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
BUILD = _HERE / "build"

# -fmad=false: no multiply may be contracted into an FMA, so the f32
# verdict arithmetic (u*c < N, floor(u*N)) rounds exactly as the
# reference's does.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class KernelBuildError(RuntimeError):
    """``nvcc`` is missing, or a source failed to compile or link."""


class _Library:
    """The loaded library and what its build printed."""

    def __init__(self, lib: ctypes.CDLL, path: Path, seconds: float,
                 log: str):
        self.lib = lib
        self.path = path
        self.build_seconds = seconds
        self.log = log


_loaded: Optional[_Library] = None


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise KernelBuildError(
        "nvcc not found on PATH, under $CUDA_HOME or /usr/local/cuda; "
        "the CUDA kernels cannot be built")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _tag(sources: list[Path]) -> str:
    """Hash of the flags, the sources and the headers they include."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> _Library:
    """Compile (if needed) and load the kernel library; cached per process."""
    global _loaded
    if _loaded is not None:
        return _loaded
    sources = _sources()
    so = BUILD / f"libstreamapprox_{_tag(sources)}.so"
    t0 = time.perf_counter()
    log = ""
    if not so.is_file():
        nvcc = nvcc_path()
        work = BUILD / f"tmp_{os.getpid()}"
        work.mkdir(parents=True, exist_ok=True)
        procs = []
        for src in sources:
            obj = work / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs = []
        failed = []
        for src, _, p in procs:
            out, _ = p.communicate()
            logs.append(f"== {src.name}\n{out}")
            if p.returncode != 0:
                failed.append(src.name)
        log = "\n".join(logs)
        if failed:
            raise KernelBuildError(f"nvcc failed on {failed}:\n{log}")
        tmp_so = work / so.name
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp_so),
             *[str(obj) for _, obj, _ in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise KernelBuildError(f"link failed:\n{link.stdout}")
        os.replace(tmp_so, so)
        shutil.rmtree(work, ignore_errors=True)
    lib = ctypes.CDLL(str(so))
    _declare(lib)
    _loaded = _Library(lib, so, time.perf_counter() - t0, log)
    return _loaded


def _declare(lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.sa_fold_tile_items.argtypes = []
    lib.sa_fold_tile_items.restype = i
    lib.sa_fold_tile_lists.argtypes = []
    lib.sa_fold_tile_lists.restype = i
    lib.sa_parted_plan_ok.argtypes = [p, ll, i]
    lib.sa_parted_plan_ok.restype = i
    lib.sa_reservoir_fold.argtypes = [p] * 16 + [i] * 5 + [p]
    lib.sa_reservoir_fold.restype = i
    lib.sa_reservoir_fold_rows.argtypes = [p] * 17 + [i] * 6 + [p]
    lib.sa_reservoir_fold_rows.restype = i
    lib.sa_stratified_stats.argtypes = [p, p, p, ll, i] + [p] * 7
    lib.sa_stratified_stats.restype = i
    lib.sa_stats_partition.argtypes = [p] * 5 + [ll, i, i] + [p] * 3
    lib.sa_stats_partition.restype = i
    lib.sa_stats_scratch_words.argtypes = [ll, i]
    lib.sa_stats_scratch_words.restype = ll
    lib.sa_one_shot_ingest.argtypes = ([p] * 27 + [i] * 6
                                       + [ctypes.c_float] * 2 + [p])
    lib.sa_one_shot_ingest.restype = i
    lib.sa_whist_scratch_words.argtypes = [ll, i]
    lib.sa_whist_scratch_words.restype = ll
    lib.sa_reduce_zeroed.argtypes = [i]
    lib.sa_reduce_zeroed.restype = i
    lib.sa_weighted_hist.argtypes = [p] * 5 + [ll, i, i] + [p] * 7
    lib.sa_weighted_hist.restype = i
    lib.sa_stats_rows.argtypes = [p, p, ll, ll, p, p, p, p, p]
    lib.sa_stats_rows.restype = i
    lib.sa_stats_rows_part_words.argtypes = [ll, ll]
    lib.sa_stats_rows_part_words.restype = ll
    lib.sa_stats_rows_zeroed.argtypes = [ll, ll]
    lib.sa_stats_rows_zeroed.restype = ll
    lib.sa_whist_rows.argtypes = [p] * 4 + [ll, ll, i] + [p] * 4
    lib.sa_whist_rows.restype = i
    lib.sa_whist_rows_zeroed.argtypes = [ll, ll, i]
    lib.sa_whist_rows_zeroed.restype = ll


def check(status: int, name: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if status != 0:
        raise RuntimeError(f"{name}: CUDA error {status} at launch")
