"""Build and load the hand-written CUDA kernels.

The sources in ``csrc/*.cu`` have a plain C interface and share headers
``csrc/*.cuh``. At first use they are compiled by ``nvcc`` for ``sm_90a``
(one process per source, all started together), linked into one shared
library and loaded with ``ctypes``. The library is cached under
``build/stheno_torch/<hash>/`` at the root of the checkout, keyed by a
hash of the sources, the headers and the flags, so an edited source or
header is rebuilt and an unchanged one is not.

Nothing here runs at import: the CPU tests import every module, and there
is no ``nvcc`` without the CUDA toolkit.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

__all__ = ["library", "check"]

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "stheno_torch"
_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
]

_lock = threading.Lock()
_lib = None


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc was not found (PATH or /usr/local/cuda/bin): the CUDA kernels "
        "of stheno_torch cannot be built."
    )


def _sources(csrc=_CSRC):
    return sorted(csrc.glob("*.cu"))


def _digest(csrc=_CSRC):
    """Hash of the flags and of every source and header in ``csrc``: an
    edited ``.cuh`` rebuilds the kernels that include it."""
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for src in sorted([*csrc.glob("*.cu"), *csrc.glob("*.cuh")]):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds):
    """Run the commands concurrently; raise with the compiler's output if
    any fails."""
    procs = [
        subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for c in cmds
    ]
    failed = []
    for cmd, proc in zip(cmds, procs):
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"$ {' '.join(cmd)}\n{out.decode(errors='replace')}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))


def _build(target, sources):
    nvcc = _nvcc()
    target.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=target.parent) as tmp:
        objs = [Path(tmp) / (s.stem + ".o") for s in sources]
        _run_all(
            [[nvcc, *_FLAGS, "-c", str(s), "-o", str(o)] for s, o in zip(sources, objs)]
        )
        lib = Path(tmp) / target.name
        _run_all([[nvcc, *_FLAGS, "-shared", *map(str, objs), "-o", str(lib)]])
        os.replace(lib, target)  # Atomic: a concurrent loader sees all or nothing.


def _declare(lib):
    p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib.stheno_gram.argtypes = [i, i, p, p, p, i, i, i, d, p]
    lib.stheno_gram.restype = i
    lib.stheno_chol_tile.argtypes = [p, p, p, p, p, i, p]
    lib.stheno_chol_tile.restype = i
    lib.stheno_gram_matvec.argtypes = [i, p, p, p, p, p, i, i, i, i, i, i, i, d, p]
    lib.stheno_gram_matvec.restype = i
    lib.stheno_gram_matvec_dmma.argtypes = [i, p, p, p, p, p, i, i, i, i, i, i, i, d, p]
    lib.stheno_gram_matvec_dmma.restype = i
    lib.stheno_gram_matvec_mma.argtypes = [i, p, p, p, p, p, p, i, i, i, i, i, i, i, d, p]
    lib.stheno_gram_matvec_mma.restype = i
    lib.stheno_gram_matvec_vjp.argtypes = [i, i, p, p, p, p, p, p, i, i, i, i, i, i, i, i, d, i, i,
                                           i, p]
    lib.stheno_gram_matvec_vjp.restype = i
    return lib


def library():
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            target = _BUILD_ROOT / _digest() / "libstheno_kernels.so"
            if not target.exists():
                _build(target, _sources())
            _lib = _declare(ctypes.CDLL(str(target)))
        return _lib


def check(code, name):
    """Raise if a launch returned a CUDA error code."""
    if code != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError_t {code}")
