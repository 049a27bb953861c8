"""Builds and loads the port's CUDA kernels, and launches them.

At first use, `nvcc` compiles every `csrc/*.cu` for Hopper (sm_90a), one
process per source, all started together, and links the objects into one
shared library with a plain C interface, in `_build/<hash>/` inside the
package (listed in .gitignore). The hash covers the sources and the flags,
so an edit rebuilds. The library is loaded with ctypes. A missing nvcc or
a failed build raises; nothing falls back.

This is the only module that talks to the library. A kernel wrapper asks
`device_of` whether its tensor runs the plain version (CPU), the kernel
(CUDA) or neither, and calls `launch(name, *args, device=...)`, which
calls `cvsim_<name>` with the arguments in the order of the C entry point
and the current stream last. Each argument is passed as an explicit ctypes
value (`c_args`), so the entry points need no argtypes and no pointer is
ever cut to a C int; the CPU tests hold each wrapper's arguments to its
entry point's signature in csrc/.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

from cvsim_tpu_torch.utils import log

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
            lib.cvsim_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def error_string(err: int) -> str:
    return f"{err} ({load().cvsim_error_string(err).decode()})"


_INT_MIN, _INT_MAX = -2 ** 31, 2 ** 31 - 1


def c_args(args) -> list:
    """args as explicit ctypes values: a tensor as its data pointer, None
    as a null pointer, a ctypes.Structure by reference, a Python int as a
    C int. An int outside the int32 range raises: it is most likely a
    pointer passed where its tensor belongs."""
    import torch

    out = []
    for k, a in enumerate(args):
        if isinstance(a, torch.Tensor):
            out.append(ctypes.c_void_p(a.data_ptr()))
        elif a is None:
            out.append(ctypes.c_void_p())
        elif isinstance(a, ctypes.Structure):
            out.append(ctypes.byref(a))
        elif isinstance(a, int):
            if not _INT_MIN <= a <= _INT_MAX:
                raise ValueError(f"argument {k}: {a} is outside a C int")
            out.append(ctypes.c_int(a))
        else:
            raise TypeError(f"argument {k}: no C form for {type(a).__name__}")
    return out


def device_of(t, what: str):
    """None for a CPU tensor (the wrapper runs its plain version), the
    device for a CUDA tensor; raises for any other device."""
    if t.device.type == "cpu":
        return None
    if t.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {t.device}")
    return t.device


def launch(name: str, *args, device) -> None:
    """Call `cvsim_<name>(*args, stream)` on device's current stream (no
    sync); raise on a refused launch and count `launches.<name>`."""
    import torch

    c = c_args(args)
    fn = getattr(load(), f"cvsim_{name}")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*c, ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: {error_string(rc)}")
    log.count(f"launches.{name}")
