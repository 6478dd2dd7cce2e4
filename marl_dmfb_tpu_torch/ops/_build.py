"""Build the CUDA sources in ``csrc/`` with ``nvcc`` and load them with
``ctypes``.

Each ``csrc/<name>.cu`` exposes plain ``extern "C"`` functions and includes
no PyTorch header, so one build takes seconds.  The library lands in
``build/marl_dmfb_tpu_torch/`` beside the package, under a name that carries
a hash of the source and the flags: a changed source builds anew, an
unchanged one is loaded as it is.  Nothing is built when this module is
imported.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PACKAGE = Path(__file__).resolve().parents[1]
CSRC = _PACKAGE / "csrc"
BUILD_DIR = _PACKAGE.parent / "build" / "marl_dmfb_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


@dataclasses.dataclass
class Built:
    lib: ctypes.CDLL
    path: Path
    seconds: float   # compile time; 0.0 when an up-to-date library was found
    log: str         # nvcc's output (ptxas registers, spills)


_loaded: dict[str, Built] = {}


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``/usr/local/cuda/bin``,
    then ``PATH``.  Raises if there is none."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels cannot be built")
    return found


def build(name: str) -> Built:
    """Compile ``csrc/<name>.cu`` if its library is missing or stale, load
    it, and return it.  Raises ``RuntimeError`` with the compiler's output
    when the build fails."""
    if name in _loaded:
        return _loaded[name]
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    so = BUILD_DIR / f"lib{name}-{digest}.so"
    log_path = so.with_suffix(".log")
    seconds = 0.0
    if not so.exists():
        compiler = nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [compiler, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        output = proc.stdout + proc.stderr
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"nvcc failed (exit {proc.returncode}) building {src}:\n"
                f"{' '.join(cmd)}\n{output}")
        log_path.write_text(output)
        os.replace(tmp, so)   # atomic: a concurrent loader sees all or none
    built = Built(lib=ctypes.CDLL(str(so)), path=so, seconds=seconds,
                  log=log_path.read_text() if log_path.exists() else "")
    _loaded[name] = built
    return built
