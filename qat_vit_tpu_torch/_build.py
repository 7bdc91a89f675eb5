"""Build and load the package's CUDA kernels.

Each ``csrc/*.cu`` source is compiled by its own ``nvcc``, all started
together, and the objects are linked into ONE shared library with a plain C
interface, loaded with ``ctypes`` (no PyTorch headers: that build takes
minutes, this one seconds). The library is built at the first
kernel launch and again whenever a source, a header or the flags change:
its file name carries a hash of all of them. Builds land in
``qat_vit_tpu_torch/_build/`` (ignored by git).

Nothing here runs at import time, and nothing falls back: a missing
``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-lineinfo",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures of the entry points (all return a cudaError_t as int)
_SIGNATURES = {
    "qvt_int8_gemm": [_P] * 7 + [_I] * 7 + [_F, _F, _I, _F, _F, _F, _I, _P],
    "qvt_int8_gemm_resid_ln": [_P] * 10 + [_I] * 7 + [_F, _F, _I, _F, _F, _F, _F, _P],
    "qvt_ln_quantize": [_P] * 4 + [_I] * 3 + [_F] * 4 + [_P],
    "qvt_attention_q_mma": [_P, _P] + [_I] * 5 + [_F] * 4 + [_P],
    "qvt_attention_fwd_mma": [_P] * 3 + [_I] * 5 + [_F, _I, _F, _F, _P],
    "qvt_attention_fwd": [_P] * 3 + [_I] * 5 + [_F, _I, _F, _F, _P],
    "qvt_attention_bwd_rows": [_P] * 5 + [_I] * 5 + [_F, _I, _F, _F, _P],
    "qvt_attention_bwd_keys": [_P] * 5 + [_I] * 5 + [_F, _I, _F, _F, _P],
    "qvt_attention_bwd_mma": [_P] * 5 + [_I] * 5 + [_F, _I, _F, _F, _P],
    "qvt_attention_long": [_P, _P] + [_I] * 5 + [_F, _P],
    "qvt_attention_long_mma": [_P] * 3 + [_I] * 5 + [_F, _P],
    "qvt_attention_long_q_mma": [_P, _P] + [_I] * 5 + [_F] * 4 + [_P],
    "qvt_attention_long_q8_mma": [_P] * 3 + [_I] * 5 + [_F, _I, _F, _F, _F, _P],
    "qvt_attention_long_bwd": [_P] * 4 + [_I] * 5 + [_F, _F, _P],
    "qvt_attention_long_bwd_mma": [_P] * 7 + [_I] * 5 + [_F, _F, _P],
    "qvt_quantize_gemm": [_P] * 6 + [_I] * 6 + [_F, _F, _I, _F, _F, _F, _P],
    "qvt_flash_attention": [_P, _P] + [_I] * 5 + [_F, _I, _P],
    "qvt_megablock": [_P, _I] + [_P] * 9 + [_I] * 8 + [_F] * 3 + [_P],
    "qvt_megablock_residency": [_I] * 5 + [_P],
}


class KernelLibrary:
    """The loaded kernel library; :attr:`build_seconds` is what building
    (or finding) it took in this process."""

    def __init__(self, path: Path, build_seconds: float):
        self.path = path
        self.build_seconds = build_seconds
        self._lib = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(self._lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        self._lib.qvt_error_string.argtypes = [ctypes.c_int]
        self._lib.qvt_error_string.restype = ctypes.c_char_p

    def call(self, name: str, *args) -> None:
        """Launch through entry point ``name``; raise on a nonzero cudaError_t."""
        err = getattr(self._lib, name)(*args)
        if err != 0:
            msg = self._lib.qvt_error_string(err).decode()
            raise RuntimeError(f"{name} failed to launch: cudaError {err} ({msg})")


_lock = threading.Lock()
_library: Optional[KernelLibrary] = None


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    for cand in (
        os.environ.get("NVCC"),
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set NVCC or CUDA_HOME): the CUDA kernels of "
        "qat_vit_tpu_torch are built from csrc/ at first use"
    )


def library_path() -> Path:
    h = hashlib.sha256()
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libqvt_kernels_{h.hexdigest()[:16]}.so"


def _run(cmds):
    """Run the commands in parallel; raise with the first failure's output."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                    text=True)) for cmd in cmds]
    failed = []
    for cmd, proc in procs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"kernel build failed ({' '.join(cmd)}):\n{out}\n{err}")
    if failed:
        raise RuntimeError("\n".join(failed))


def build() -> Path:
    """Compile ``csrc/*.cu`` into the library unless it is already built."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, p.stem + ".o") for p in sorted(CSRC.glob("*.cu"))]
        _run([[nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src), "-o", obj]
              for src, obj in zip(sorted(CSRC.glob("*.cu")), objs)])
        lib = os.path.join(tmp, "lib.so")
        _run([[nvcc, *NVCC_FLAGS, "-shared", "-o", lib, *objs]])
        os.replace(lib, out)
    return out


def load() -> KernelLibrary:
    """The kernel library, built on first call (thread-safe)."""
    global _library
    with _lock:
        if _library is None:
            t0 = time.perf_counter()
            path = build()
            _library = KernelLibrary(path, time.perf_counter() - t0)
        return _library
