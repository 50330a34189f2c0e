"""Builds and loads the port's CUDA kernels (``otter_tpu_torch/csrc/*.cu``).

The sources have a plain C interface, so ``nvcc`` compiles them for
``sm_90a`` (seconds, where a build against PyTorch's headers takes minutes;
one ``nvcc`` per source, all started together) and links them into one
shared library, which ``ctypes`` loads. The library is
content-addressed: its name carries a hash of the sources, so an edit builds
a new one and a long-lived process never keeps a stale image. It is built at
first use into ``build/otter_tpu_torch/`` at the repository root. A build
that fails raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "otter_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_P = ctypes.c_void_p
_I = ctypes.c_int


def sources() -> list:
    """The CUDA translation units (the host library otter_native.cpp is
    built by ``native.py``)."""
    return sorted(glob.glob(os.path.join(_SRC_DIR, "*.cu")))


def _lib_path() -> str:
    h = hashlib.sha1()
    for path in sources() + sorted(glob.glob(os.path.join(_SRC_DIR,
                                                          "*.cuh"))):
        with open(path, "rb") as fh:
            h.update(os.path.basename(path).encode() + b"\0" + fh.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libotter_kernels.{h.hexdigest()[:12]}.so")


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        nvcc = shutil.which("nvcc", path=os.path.join(home, "bin"))
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


def build() -> str:
    """Compile the kernels unless the library for these sources exists;
    returns its path. The compiler's output (``-Xptxas -v``: registers,
    shared memory and spills per kernel) is kept beside it as ``.log``."""
    lib = _lib_path()
    if os.path.exists(lib):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.tmp{os.getpid()}"
    nvcc = _nvcc()
    objs = [f"{tmp}.{os.path.basename(src)}.o" for src in sources()]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", obj, src],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(sources(), objs)]
    logs = [p.communicate()[0] for p in procs]
    link = subprocess.run([nvcc, "-shared", "-o", tmp, *objs],
                          capture_output=True, text=True)
    for obj in objs:
        if os.path.exists(obj):
            os.remove(obj)
    codes = [p.returncode for p in procs] + [link.returncode]
    log = "".join(logs) + link.stdout + link.stderr
    if any(codes):
        raise RuntimeError(f"nvcc failed ({codes}):\n{log}")
    with open(lib[:-3] + ".log", "w") as fh:
        fh.write(log)
    os.replace(tmp, lib)  # atomic against a concurrent build
    return lib


def build_log() -> str:
    """The compiler output kept by the build of the current sources."""
    with open(_lib_path()[:-3] + ".log") as fh:
        return fh.read()


def load() -> ctypes.CDLL:
    """The kernel library, built at first use, with every entry typed."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            lib.otter_myers_pool.restype = _I
            lib.otter_myers_pool.argtypes = [_P, _I, _P, _P, _P, _P, _P,
                                             _I, _I, _I, _P]
            lib.otter_myers_striped.restype = _I
            lib.otter_myers_striped.argtypes = [_P, _I, _P, _P, _P, _P, _P,
                                                _P, _P, _I, _I, _I, _I, _I,
                                                _P, _P]
            lib.otter_myers_banded.restype = _I
            lib.otter_myers_banded.argtypes = [_P, _I, _P, _P, _P, _P, _I,
                                               _P, _I, _I, _I, _I, _I, _P,
                                               _P]
            lib.otter_myers_banded_ef.restype = _I
            lib.otter_myers_banded_ef.argtypes = [_P, _I, _P, _P, _P, _P, _P,
                                                  _P, _I, _P, _I, _I, _I, _I,
                                                  _I, _P, _P]
            lib.otter_edit_banded.restype = _I
            lib.otter_edit_banded.argtypes = [_P, _P, _P, _I, _I, _P, _I, _P,
                                              _P]
            lib.otter_edit_banded_ends_free.restype = _I
            lib.otter_edit_banded_ends_free.argtypes = [_P, _P, _P, _I, _I,
                                                        _I, _P, _I, _P, _P]
            lib.otter_edit_banded_ends_free_shape.restype = _I
            lib.otter_edit_banded_ends_free_shape.argtypes = [_I, _P]
            lib.otter_affine_tb.restype = _I
            lib.otter_affine_tb.argtypes = [_P, _I, _P, _I, _P, _I, _I, _P,
                                            _P, _I, _P, _P, _I, _P]
            lib.otter_affine_tb_ckpt.restype = _I
            lib.otter_affine_tb_ckpt.argtypes = [_P, _I, _P, _I, _P, _I, _I,
                                                 _P, _P, _I, _P, _P, _I, _P]
            lib.otter_kde_scaled.restype = _I
            lib.otter_kde_scaled.argtypes = [_P, _I, _P, _P, _P, _I, _I, _I,
                                             _P, _P, _P]
            lib.otter_kde_scaled_launch.restype = _I
            lib.otter_kde_scaled_launch.argtypes = [_P, _I, _P, _P, _P, _I,
                                                    _I, _I, _I, _I, _P, _P,
                                                    _P]
            lib.otter_kde_tree.restype = _I
            lib.otter_kde_tree.argtypes = [_P, _I, _P, _P, _P, _I, _I, _I,
                                           _I, _I, _P, _P, _P, _P]
            lib.otter_kde_pairs.restype = _I
            lib.otter_kde_pairs.argtypes = [_P, _P, _P, _P, _P, _P, _P, _I,
                                            _I, _I, _P, _P, _P, _P]
            lib.otter_kde_scaled_geometry.restype = _I
            lib.otter_kde_scaled_geometry.argtypes = [_I, _I, _I, _I, _P]
            lib.otter_kmer_counts.restype = _I
            lib.otter_kmer_counts.argtypes = [_P, _P, _I, _I, _P, _P]
            lib.otter_linkage.restype = _I
            lib.otter_linkage.argtypes = [_P, _I, _I, _P, _P, _P, _P]
            lib.otter_linkage_plan.restype = _I
            lib.otter_linkage_plan.argtypes = [_I, _P, _P, _P]
            lib.otter_linkage_route.restype = _I
            lib.otter_linkage_route.argtypes = [_P, _I, _I, _P, _P, _P, _I,
                                                _I, _P]
            lib.otter_poa_heaviest.restype = _I
            lib.otter_poa_heaviest.argtypes = [_P, _P, _P, _P, _P, _I, _I,
                                               _P, _P, _P, _P]
            lib.otter_poa_heaviest_stream.restype = _I
            lib.otter_poa_heaviest_stream.argtypes = [_P, _P, _P, _P] + [
                _I] * 7 + [_P, _P, _P]
            lib.otter_cuda_error_string.restype = ctypes.c_char_p
            lib.otter_cuda_error_string.argtypes = [_I]
            _lib = lib
        return _lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch entry point reported a CUDA error."""
    if err != 0:
        msg = lib.otter_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
