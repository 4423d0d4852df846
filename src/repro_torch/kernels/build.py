"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each source under ``csrc/`` is compiled on its own into a shared library
with a plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o <lib>.so csrc/<name>.cu

Libraries go to ``build/repro_torch/`` at the repo root (ignored by git),
named by a hash of the source and the flags, so an edited source is rebuilt
and an unchanged one is reused.  The ptxas report (registers, shared memory,
spills) is kept beside each library.  Nothing is built at import: the first
call that needs a kernel builds it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("flash_attention_fwd", "ssd_scan_fwd", "wkv6_fwd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}


@dataclass(frozen=True)
class Built:
    name: str
    path: Path
    ptxas: str          # nvcc/ptxas -v report
    seconds: float      # nvcc wall time; 0.0 when the library was reused
    cached: bool


def find_nvcc() -> str:
    cands = [shutil.which("nvcc")]
    if os.environ.get("CUDA_HOME"):
        cands.append(str(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if c and Path(c).is_file():
            return c
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin); "
                       "the port's kernels are built from source on the card's host")


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"{name}-{tag}.so"


def build(names: tuple[str, ...] = SOURCES) -> dict[str, Built]:
    """Compile every named source that has no up-to-date library, one nvcc
    process per source, all started together."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out: dict[str, Built] = {}
    running = {}
    for name in names:
        path = _lib_path(name)
        if path.exists():
            log = path.with_suffix(".log")
            out[name] = Built(name, path, log.read_text() if log.exists() else "",
                              0.0, True)
            continue
        tmp = path.with_name(f".{path.name}.{os.getpid()}.tmp")
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)
        running[name] = (proc, path, tmp, time.perf_counter())
    for name, (proc, path, tmp, t0) in running.items():
        log, _ = proc.communicate()
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed for {name}.cu "
                               f"(rc={proc.returncode}):\n{log}")
        path.with_suffix(".log").write_text(log)
        os.replace(tmp, path)
        out[name] = Built(name, path, log, secs, False)
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for one source, built first if needed."""
    if name not in _LIBS:
        _LIBS[name] = ctypes.CDLL(str(build((name,))[name].path))
    return _LIBS[name]
