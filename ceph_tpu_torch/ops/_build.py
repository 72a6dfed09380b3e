"""Build and load the port's CUDA kernels at first use.

All ``csrc/*.cu`` sources go to one ``torch.utils.cpp_extension.load``
call, compiled for ``sm_90a`` into ``ceph_tpu_torch/_build/`` (listed in
``.gitignore``).  The sources export a plain C interface and include no
PyTorch header, so the build takes seconds, not the minutes a file
including ``torch/extension.h`` costs; the library is loaded with
``ctypes`` and every entry point returns the ``cudaError_t`` of its
launch, which the wrapper turns into an exception.  Without ``ninja``
the same sources go through one ``nvcc -shared`` call instead.

Nothing here runs at import: the CPU tests import every module of the
package on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("gf256.cu", "crc32c.cu", "gf2_matmul.cu", "crush.cu", "meshio.cu")
CUDA_FLAGS = ["-O3", "-gencode=arch=compute_90a,code=sm_90a"]
LIB_NAME = "ceph_tpu_torch_kernels"

_lock = threading.Lock()
_lib = None
build_seconds = None  # wall time of this process's build, once done
# monotonic stamps of the build: build_t0 set as it starts, build_t1 as
# it ends (None while it runs); the device watch blames a queue job
# whose wait overlapped them (the queue's ``compile_wait``)
build_t0 = None
build_t1 = None
# whether this process's build loaded a library already in BUILD_DIR
# without compiling it (its file's modification time unchanged across the
# build), None before the build; the device watch's persist hit or miss
build_hit = None
# called as fn(t0, t1, hit) after the build, outside the build's lock
BUILD_LISTENERS: list = []
COUNTS: list = []     # every LaunchCount, in creation order


class LaunchCount:
    """Launches of one kernel: the wrapper adds one where it launches
    the kernel and nowhere else (a run reads it to show which kernels
    its path went through).  Every count registers itself in
    :data:`COUNTS`, which the device watch reads."""

    def __init__(self, name: str) -> None:
        self.name = name
        self._lock = threading.Lock()
        self._n = 0
        COUNTS.append(self)

    def inc(self) -> None:
        with self._lock:
            self._n += 1

    def reset(self) -> None:
        with self._lock:
            self._n = 0

    @property
    def value(self) -> int:
        with self._lock:
            return self._n


_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I32 = ctypes.c_int
_U32 = ctypes.c_uint32
_SIGNATURES = {
    # (x, x_row_bytes, out, out_row_bytes, words, k, R, seed, masks,
    #  masks_bytes, mul_shift, stream)
    "gf256_matmul_launch": [_P, _I64, _P, _I64, _I64, _I32, _I32, _U32,
                            _P, _I64, _I32, _P],
    # (x, out, T, k, R, r0, rows, seed, masks, masks_bytes, mul_shift,
    #  stream)
    "gf256_interleaved_launch": [_P, _P, _I64, _I32, _I32, _I32, _I32,
                                 _U32, _P, _I64, _I32, _P],
    # (base, row_stride, S, meta[3, J], J, partial, max_q, out, stream)
    "crc32c_rows_launch": [_P, _I64, _I32, _P, _I64, _P, _I64, _P, _P],
    # (x, x_row_bytes, out, out_row_bytes, offs, widths, J, w, K, R,
    #  frags, kw, stream)
    "gf2_matmul_launch": [_P, _I64, _P, _I64, _P, _P, _I32, _I32, _I32,
                          _I32, _P, _I32, _P],
    # (x, x_row_bytes, out, out_row_bytes, offs, widths, J, w, K, R,
    #  rowptr, idx, stream)
    "gf2_xor_packets_launch": [_P, _I64, _P, _I64, _P, _P, _I32, _I32,
                               _I32, _I32, _P, _P, _P],
    # (args: RuleArgs*, stream)
    "crush_rule_launch": [_P, _P],
    "crush_rule_args_size": [],
    # (x, row_bytes, rows, n, out, stream)
    "mesh_digest_launch": [_P, _I64, _I64, _I64, _P, _P],
}


def cuda_bin(tool: str) -> str:
    """Path of a CUDA toolkit program (``nvcc``, ``cuobjdump``)."""
    from torch.utils.cpp_extension import CUDA_HOME

    for cand in (os.path.join(CUDA_HOME or "", "bin", tool),
                 f"/usr/local/cuda/bin/{tool}", shutil.which(tool) or ""):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(f"{tool} not found in the CUDA toolkit")


def _compile() -> str:
    from torch.utils import cpp_extension

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    sources = [str(CSRC / s) for s in SOURCES]
    if cpp_extension.is_ninja_available():
        return cpp_extension.load(
            name=LIB_NAME, sources=sources, extra_cuda_cflags=CUDA_FLAGS,
            build_directory=str(BUILD_DIR), is_python_module=False,
            verbose=False)
    path = BUILD_DIR / f"lib{LIB_NAME}.so"
    subprocess.run(
        [cuda_bin("nvcc"), *CUDA_FLAGS, "-std=c++17", "-shared", "-Xcompiler",
         "-fPIC", "-o", str(path), *sources], check=True)
    return str(path)


def _libraries() -> dict:
    """Modification time of each built library now in BUILD_DIR."""
    if not BUILD_DIR.is_dir():
        return {}
    return {str(p.resolve()): p.stat().st_mtime_ns
            for p in BUILD_DIR.glob("*.so")}


def lib() -> ctypes.CDLL:
    """The kernel library, built on first call (raises if the build
    fails; there is no fallback)."""
    global _lib, build_seconds, build_t0, build_t1, build_hit
    built = None
    with _lock:
        if _lib is None:
            before = _libraries()
            t0 = build_t0 = time.monotonic()
            build_t1 = None
            try:
                path = _compile()
                dll = ctypes.CDLL(path)
            finally:
                build_t1 = time.monotonic()
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(dll, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            dll.crc32c_max_segments.argtypes = [_I64]
            dll.crc32c_max_segments.restype = _I64
            dll.kernels_error_string.argtypes = [ctypes.c_int]
            dll.kernels_error_string.restype = ctypes.c_char_p
            build_seconds = time.monotonic() - t0
            key = str(Path(path).resolve())
            build_hit = (key in before
                         and before[key] == _libraries().get(key))
            built = (t0, build_t1, build_hit)
            _lib = dll
        dll = _lib
    if built is not None:
        for fn in list(BUILD_LISTENERS):
            fn(*built)
    return dll


def check(err: int, what: str) -> None:
    """Raise on a launch whose cudaGetLastError() was not cudaSuccess."""
    if err != 0:
        msg = lib().kernels_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: cudaError {err} ({msg})")
