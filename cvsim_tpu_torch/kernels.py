"""Builds and loads the port's CUDA kernels.

At first use, `nvcc` compiles every `csrc/*.cu` for Hopper (sm_90a), one
process per source, all started together, and links the objects into one
shared library with a plain C interface, in `_build/<hash>/` inside the
package (listed in .gitignore). The hash covers the sources and the flags,
so an edit rebuilds. The library is loaded with ctypes, with argtypes set
for every entry point. A missing nvcc or a failed build raises; nothing
falls back.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_DIR, "csrc")
_BUILD = os.path.join(_DIR, "_build")
_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              # the float math mirrors the JAX kernel op for op; only the
              # explicit fmaf calls of the block products may fuse
              "-fmad=false", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib = None
BUILD_LOG = ""   # nvcc's output of the build that produced the library


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(_CSRC, "*.cu"))
                  + glob.glob(os.path.join(_CSRC, "*.cuh")))


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(_BUILD, h.hexdigest()[:16], "libcvsim_kernels.so")


def build() -> str:
    """Compile csrc/*.cu if the library for these sources is missing;
    returns its path."""
    global BUILD_LOG
    lib = library_path()
    if os.path.exists(lib):
        return lib
    out_dir = os.path.dirname(lib)
    os.makedirs(out_dir, exist_ok=True)
    nvcc = _nvcc()
    tag = f"tmp.{os.getpid()}"
    objs, procs = [], []
    for src in (s for s in _sources() if s.endswith(".cu")):
        obj = os.path.join(out_dir, f"{os.path.basename(src)}.{tag}.o")
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = [], []
    for proc in procs:
        logs.append(proc.communicate()[0])
        if proc.returncode != 0:
            failed.append(proc.returncode)
    tmp = f"{lib}.{tag}"
    if not failed:
        link = subprocess.run([nvcc, *_ARCH, "-shared", "-o", tmp, *objs],
                              capture_output=True, text=True)
        logs.append(link.stdout + link.stderr)
        if link.returncode != 0:
            failed.append(link.returncode)
    for obj in objs:
        if os.path.exists(obj):
            os.remove(obj)
    BUILD_LOG = "".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed ({failed}):\n{BUILD_LOG}")
    os.replace(tmp, lib)   # atomic: no process loads a half-written library
    return lib


def load():
    """The kernel library, built at first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            ptr = ctypes.c_void_p
            # every argument of the kernel entry points is a pointer (or
            # the stream)
            for name, n_args in (("cvsim_yiq_chain", 15), ("cvsim_yiq_a", 11),
                                 ("cvsim_yiq_b1", 14), ("cvsim_yiq_b2", 13),
                                 ("cvsim_yuv_chain", 19), ("cvsim_yuv_a", 13),
                                 ("cvsim_yuv_b1", 14), ("cvsim_yuv_b2", 15),
                                 ("cvsim_fused_iir", 6),
                                 ("cvsim_field_streams", 10)):
                fn = getattr(lib, name)
                fn.argtypes = [ptr] * n_args
                fn.restype = ctypes.c_int
            # rows a CTA of the multi-row kernels on the current device:
            # #9, #2, #3 and #4 at a padded width, #6, #7 and #8 at the
            # padded luma and chroma widths
            for name, n_args in (("cvsim_fused_iir_rows_per_cta", 1),
                                 ("cvsim_yiq_a_rows_per_cta", 1),
                                 ("cvsim_yiq_b1_rows_per_cta", 1),
                                 ("cvsim_yiq_b2_rows_per_cta", 1),
                                 ("cvsim_yuv_a_rows_per_cta", 2),
                                 ("cvsim_yuv_b1_rows_per_cta", 2),
                                 ("cvsim_yuv_b2_rows_per_cta", 2)):
                fn = getattr(lib, name)
                fn.argtypes = [ctypes.c_int] * n_args
                fn.restype = ctypes.c_int
            # the raw decoder's line-tail chain: six pointers, the line
            # count, the stream
            lib.cvsim_raw28_tails.argtypes = [ptr] * 6 + [ctypes.c_int, ptr]
            lib.cvsim_raw28_tails.restype = ctypes.c_int
            # the Y4M payloads: two pointers, five sizes, the stream
            lib.cvsim_y4m_payload.argtypes = ([ptr] * 2 + [ctypes.c_int] * 5
                                              + [ptr])
            lib.cvsim_y4m_payload.restype = ctypes.c_int
            lib.cvsim_error_string.argtypes = [ctypes.c_int]
            lib.cvsim_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def error_string(err: int) -> str:
    return f"{err} ({load().cvsim_error_string(err).decode()})"
