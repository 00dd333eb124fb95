"""Build and load the port's CUDA kernels: ``nvcc`` into shared libraries
with a plain C interface, loaded with ``ctypes``.

Each ``csrc/<name>.cu`` becomes ``_build/lib<name>-<hash>.so``, keyed on
a hash of the source, the headers beside it (``csrc/*.cuh``) and the
compile command, so a changed source or header is rebuilt and an
unchanged one is built once per checkout. Nothing is built
at import: ``load`` builds on first use, and ``build`` starts one ``nvcc``
per missing library, all at once, and waits for every one.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
SOURCES = ("sha256", "rs_extend")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


class KernelError(Exception):
    """An error of a kernel wrapper: arguments it cannot launch on, or a
    launch that failed. Each is raised as the builtin kind it is
    (ValueError, TypeError, RuntimeError), so callers that catch those
    still do; a caller that turns untrusted input's ValueErrors into a
    verdict re-raises this class first, since a wrapper's error is no
    verdict (chain/light.LightClient.submit_fraud_proof)."""


class KernelValueError(KernelError, ValueError):
    pass


class KernelTypeError(KernelError, TypeError):
    pass


class KernelLaunchError(KernelError, RuntimeError):
    pass


def nvcc() -> str:
    """Path of the CUDA compiler: $CUDA_HOME/bin/nvcc, the toolkit's
    default install, or ``nvcc`` on PATH."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.isfile(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is required to build the kernels")
    return found


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: tuple[str, ...] = SOURCES) -> dict[str, str]:
    """Compile each named source whose library is missing, one ``nvcc``
    process per source, all started together. Returns the compiler's
    output (``-Xptxas -v`` register and spill report) per source built;
    raises RuntimeError naming every source that failed."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    compiler = nvcc()
    jobs = []
    try:
        for name in names:
            out = library_path(name)
            if out.exists():
                continue
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            log_path = out.with_name(f"{out.name}.log")
            with open(log_path, "wb") as log:
                proc = subprocess.Popen(
                    [compiler, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")],
                    stdout=log, stderr=subprocess.STDOUT,
                )
            jobs.append((name, proc, tmp, out, log_path))
        logs, failed = {}, []
        for name, proc, tmp, out, log_path in jobs:
            proc.wait()
            logs[name] = log_path.read_text(errors="replace")
            if proc.returncode != 0:
                failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{logs[name]}")
            else:
                os.replace(tmp, out)
    finally:
        for _, proc, *_ in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if missing."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                build((name,))
            lib = ctypes.CDLL(str(path))
            _LIBS[name] = lib
        return lib


_COUNT_LOCK = threading.Lock()


def count_launch(wrapper) -> None:
    """Add one to ``wrapper.launches``. The wrappers launch from many
    threads at once (HTTP handlers, reactors, warmers), and ``+= 1`` on an
    attribute is a read, an add and a write that another thread can
    interleave, so the add holds a lock."""
    with _COUNT_LOCK:
        wrapper.launches += 1
