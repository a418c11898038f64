"""Build and load the hand-written Hopper kernels (csrc/*.cu).

Each source is compiled by `nvcc` for `sm_90a` into its own shared
library with a plain C interface and loaded with `ctypes` — no PyTorch
headers, so a build takes seconds.  Libraries land in `_build/` beside
this module (listed in .gitignore), named by a hash of the source and
the flags, so an edited source is never served a stale build.  Nothing
is built at import: the first wrapper call builds its own library, and
`build_all()` starts one `nvcc` per source at once.

The sources are compiled without `--use_fast_math` and with
`--fmad=false`: the float islands of both attention kernels must round
exactly like their plain PyTorch versions (no contracted multiply-adds,
IEEE `expf` and division).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("int8_matmul", "requant", "paged_attention", "quant_attention")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _LL, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_float)
# argument types of each C entry point `<name>_launch`, which returns a
# cudaError_t; each lives in csrc/<name>.cu, or in the source ENTRIES
# names
SIGNATURES = {
    "int8_matmul": [_P] * 9 + [_I] * 3 + [_P] + [_I] * 4 + [_LL]
    + [_I] * 5 + [_P] * 3,
    "requant": [_P] * 7 + [_I] * 3 + [_P] + [_I] * 8 + [_P],
    "requant_add": [_P, _I] + [_P] * 7 + [_I] + [_P] * 8 + [_I, _P]
    + [_I] * 5 + [_P],
    "requant_gate": [_P] * 10 + [_I, _P] + [_I] * 5 + [_P],
    "paged_attention": [_P] * 10 + [_I] * 9 + [_LL] + [_I] * 3 + [_P],
    "quant_attention": [_P] * 4 + [_F] * 3 + [_I] * 14 + [_LL, _P],
}
ENTRIES = {"requant_add": "requant", "requant_gate": "requant"}

_LOCK = threading.Lock()
_LAUNCHERS: Dict[str, ctypes._CFuncPtr] = {}


def nvcc_path() -> str:
    for cand in (
        os.environ.get("CUDA_HOME", "") and
        os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA "
        "kernels are built from csrc/ at first use")


def _target(name: str) -> Tuple[Path, Path]:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return src, BUILD_DIR / f"lib{name}_{digest}.so"


def _start(name: str):
    """Spawn nvcc for one source; None when the library exists."""
    src, lib = _target(name)
    if lib.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, lib


def _finish(name: str, started) -> None:
    if started is None:
        return
    proc, tmp, lib = started
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{out}")
    lib.with_suffix(".log").write_text(out)
    os.replace(tmp, lib)


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every listed source, one nvcc each, all in parallel.
    Returns the ptxas report (registers, shared memory, spills) of the
    libraries built by this call."""
    names = list(names)
    with _LOCK:
        started = {n: _start(n) for n in names}
        for n in names:
            _finish(n, started[n])
    reports = {}
    for n in names:
        log = _target(n)[1].with_suffix(".log")
        reports[n] = log.read_text() if log.exists() else ""
    return reports


def launcher(name: str) -> ctypes._CFuncPtr:
    """The C entry point `<name>_launch` of its source (csrc/<name>.cu,
    or the one ENTRIES names), the library built and loaded on first
    use."""
    with _LOCK:
        fn = _LAUNCHERS.get(name)
        if fn is None:
            src = ENTRIES.get(name, name)
            _finish(src, _start(src))
            lib = ctypes.CDLL(str(_target(src)[1]))
            fn = getattr(lib, f"{name}_launch")
            fn.restype = ctypes.c_int
            fn.argtypes = SIGNATURES[name]
            _LAUNCHERS[name] = fn
    return fn


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
