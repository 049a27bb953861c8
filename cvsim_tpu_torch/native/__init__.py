"""Native host code of the port: the container-I/O tool `cvsim-av`
(avio.cpp + hostpix.cpp), the frame scaler binding (hostpix.py), and
the raw decoder's hsync DC tracker (hostio.cpp, `HsyncDcTracker`) and
sync-pulse scan (hostio.cpp, `sync_hunt` and `sync_walk_lines`).

The port's copies of cvsim_tpu/native's sources, built from this
directory with g++ on first use (the outputs are listed in .gitignore).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
_AV_SRC = os.path.join(_DIR, "avio.cpp")
# the pixel kernels, compiled into cvsim-av as well so that its tool loops
# and the Python binding (hostpix.py, libhostpix.so) share one
# implementation
_AV_PIX_SRC = os.path.join(_DIR, "hostpix.cpp")
_AV_PIX_HDR = os.path.join(_DIR, os.pardir, "csrc", "yuv601.cuh")
_AV_BIN = os.path.join(_DIR, "cvsim-av")
_AV_LIBS = ["-lavformat", "-lavcodec", "-lavutil", "-lswscale",
            "-lswresample"]
_av_lock = threading.Lock()
_av_state: list = []  # [path | None] once resolved


def build_av_tool() -> str | None:
    """Path to the cvsim-av container-I/O binary (native/avio.cpp), built
    on first use against the system FFmpeg libraries.  None when g++ or
    the libav* dev libraries are unavailable (the framework then falls
    back to an `ffmpeg` binary on PATH, or native Y4M/WAV only)."""
    with _av_lock:
        if _av_state:
            return _av_state[0]
        path = None
        try:
            if (not os.path.exists(_AV_BIN) or os.path.getmtime(_AV_BIN)
                    < max(os.path.getmtime(_AV_SRC),
                          os.path.getmtime(_AV_PIX_SRC),
                          os.path.getmtime(_AV_PIX_HDR))):
                # build to a private temp name, then atomically rename:
                # concurrent processes (parallel CLI runs, daemon + client)
                # must never exec a half-linked binary or collide on the
                # shared output path.  hostpix.cpp's flags are load-bearing
                # (-ffp-contract=off: FMA would change the f32 results vs
                # numpy; see hostpix.py _load); -march=native vectorizes
                # rintf, with a portable fallback.
                tmp = f"{_AV_BIN}.tmp.{os.getpid()}"
                base = ["g++", "-O3", "-ffp-contract=off",
                        "-fno-math-errno", "-o", tmp, _AV_SRC,
                        _AV_PIX_SRC] + _AV_LIBS
                try:
                    subprocess.run(base[:1] + ["-march=native"] + base[1:],
                                   check=True, capture_output=True)
                except subprocess.CalledProcessError:
                    subprocess.run(base, check=True, capture_output=True)
                os.replace(tmp, _AV_BIN)
            path = _AV_BIN
        except subprocess.CalledProcessError as e:
            print("cvsim: cvsim-av build failed (container I/O limited to "
                  "Y4M/WAV + ffmpeg-on-PATH):\n"
                  + e.stderr.decode(errors="replace")[-800:],
                  file=sys.stderr)
            path = None
        except OSError:
            path = None
        _av_state.append(path)
        return path


# ------------------------------------------------ hsync DC tracker (hostio)

_IO_SRC = os.path.join(_DIR, "hostio.cpp")
# in a directory of its own, as libhostpix.so
_IO_LIB = os.path.join(_DIR, "_build", "libhostio.so")
_io_lock = threading.Lock()
_io_lib = None


class _HsyncDcStateStruct(ctypes.Structure):
    _fields_ = [
        ("filt_prev", ctypes.c_double * 3),
        ("alpha", ctypes.c_double),
        ("dc_level", ctypes.c_double),
        ("a_fast", ctypes.c_double),
        ("a_slow", ctypes.c_double),
        ("delay_len", ctypes.c_int),
        ("delay_pos", ctypes.c_int),
        ("delay", ctypes.c_uint8 * 4096),
    ]


def _load():
    """libhostio, built with g++ at first use; raises FileNotFoundError
    without g++, CalledProcessError if the build fails, OSError if the
    library does not load."""
    global _io_lib
    with _io_lock:
        if _io_lib is not None:
            return _io_lib
        if (not os.path.exists(_IO_LIB)
                or os.path.getmtime(_IO_LIB) < os.path.getmtime(_IO_SRC)):
            # private temp name + atomic rename: concurrent processes
            # must never dlopen a half-linked library
            os.makedirs(os.path.dirname(_IO_LIB), exist_ok=True)
            tmp = f"{_IO_LIB}.tmp.{os.getpid()}"
            subprocess.run(
                ["g++", "-O2", "-shared", "-fPIC", "-o", tmp, _IO_SRC],
                check=True, capture_output=True)
            os.replace(tmp, _IO_LIB)
        lib = ctypes.CDLL(_IO_LIB)
        lib.hsync_dc_init.argtypes = [
            ctypes.POINTER(_HsyncDcStateStruct), ctypes.c_double,
            ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_int,
            ctypes.c_double, ctypes.c_long]
        lib.hsync_dc_process.argtypes = [
            ctypes.POINTER(_HsyncDcStateStruct), ctypes.c_void_p,
            ctypes.c_long, ctypes.c_void_p, ctypes.c_void_p]
        L = ctypes.c_long
        lib.sync_hunt.restype = L
        lib.sync_hunt.argtypes = [ctypes.c_void_p, L, ctypes.c_int, L, L, L,
                                  ctypes.c_void_p, L, ctypes.c_void_p,
                                  ctypes.c_void_p]
        lib.sync_walk_lines.restype = L
        lib.sync_walk_lines.argtypes = [
            ctypes.c_void_p, L, L, L, L, ctypes.c_int, ctypes.c_int, L, L, L,
            L, ctypes.c_void_p, ctypes.c_void_p]
        _io_lib = lib
        return lib


def hostio():
    """libhostio, or None where g++ is missing; a build or load that
    fails for any other reason raises."""
    try:
        return _load()
    except FileNotFoundError:
        if shutil.which("g++") is not None:
            raise
        return None


def sync_hunt(lib, dc, threshold: int, pulses: tuple):
    """The vsync hunt's scan of hostio.cpp over dc (uint8 [N]) from sample
    0, with the pulse lengths `pulses` (vsync, hsync, equalization):
    (the lock or None, int64 starts of the equalization pulses counted
    before it, in order, samples examined)."""
    import numpy as np

    dc = np.ascontiguousarray(dc, np.uint8)
    n = len(dc)
    # counted pulses lie a vsync length apart or more
    starts = np.empty(n // max(pulses[0], 1) + 2, np.int64)
    found = ctypes.c_long()
    read = ctypes.c_long()
    lock = lib.sync_hunt(dc.ctypes.data, n, threshold, *pulses,
                         starts.ctypes.data, len(starts), ctypes.byref(found),
                         ctypes.byref(read))
    return (None if lock < 0 else lock), starts[:found.value], read.value


def sync_walk_lines(lib, dc, pos: int, raw_len: int, height: int, sync: bool,
                    threshold: int, pulses: tuple, window_back: int):
    """The line walk of hostio.cpp over dc (uint8 [N]) from pos:
    (int64 line starts, final position, hit_vsync, re-locks, samples
    examined)."""
    import numpy as np

    dc = np.ascontiguousarray(dc, np.uint8)
    starts = np.empty(max(height, 0), np.int64)
    out = np.zeros(4, np.int64)
    lines = lib.sync_walk_lines(dc.ctypes.data, len(dc), int(pos), raw_len,
                                height, int(sync), threshold, *pulses,
                                window_back, starts.ctypes.data,
                                out.ctypes.data)
    p, hit, relocks, read = (int(v) for v in out)
    return starts[:lines], p, bool(hit), relocks, read


class HsyncDcTracker:
    """Streaming hsync DC normalizer (ffmpeg_raw28ntsc.cpp:556-598): the
    native library, or its numpy twin where g++ is missing (slower, same
    results; a warning on stderr says so). A build or load of the library
    that fails for any other reason raises."""

    def __init__(self, sample_rate: float, one_scanline_time: float,
                 one_frame_time: float):
        cutoff = sample_rate / (one_scanline_time * 0.075 * 0.75)
        self._native = None
        self._params = (sample_rate, cutoff,
                        1.0 / (one_scanline_time * 0.07 * 0.75),
                        1.0 / (one_frame_time * 0.6),
                        int((one_scanline_time * 0.075 * 0.75) * 0.5),
                        128.0, int(one_frame_time))
        lib = hostio()
        if lib is None:
            print("cvsim: g++ not found: the hsync DC tracker and the sync "
                  "walk run their numpy twins (far slower)", file=sys.stderr)
            self._init_python()
            return
        st = _HsyncDcStateStruct()
        lib.hsync_dc_init(ctypes.byref(st), *[
            ctypes.c_double(self._params[0]),
            ctypes.c_double(self._params[1]),
            ctypes.c_double(self._params[2]),
            ctypes.c_double(self._params[3]),
            ctypes.c_int(self._params[4]),
            ctypes.c_double(self._params[5]),
            ctypes.c_long(self._params[6]),
        ])
        self._native = (lib, st)

    # ---------------------------------------------------------------- python
    def _init_python(self):
        import math

        import numpy as np
        rate, cutoff, a_fast, a_slow, dlen, pre, pre_n = self._params
        dt = 1.0 / rate
        tau = 1.0 / (cutoff * 2 * math.pi)
        self._alpha = dt / (tau + dt)
        self._prev = [0.0, 0.0, 0.0]
        for _ in range(pre_n):
            lv = pre
            for i in range(3):
                self._prev[i] = lv * self._alpha + (
                    self._prev[i] - self._prev[i] * self._alpha)
                lv = self._prev[i]
        self._dc = 128.0
        self._af, self._as = a_fast, a_slow
        self._delay = np.zeros(dlen, np.uint8)
        self._dpos = 0

    def state(self) -> dict:
        """The tracker's registers between two `process` calls: the three
        lowpass outputs `filters`, the tracked sync-tip level `dc_level`
        and the raw delay line `delay` (uint8, oldest sample first)."""
        import numpy as np

        if self._native is not None:
            st = self._native[1]
            filters = list(st.filt_prev)
            dc_level, pos = st.dc_level, st.delay_pos
            line = np.frombuffer(bytes(st.delay), np.uint8)[:st.delay_len]
        else:
            filters, dc_level = list(self._prev), self._dc
            pos, line = self._dpos, self._delay
        return {"filters": filters, "dc_level": dc_level,
                "delay": np.roll(line, -pos)}

    def process(self, raw):
        """raw: uint8 [N]. Returns (delayed_raw uint8 [N], dc uint8 [N])."""
        import numpy as np

        raw = np.ascontiguousarray(raw, np.uint8)
        n = len(raw)
        out_raw = np.empty(n, np.uint8)
        out_dc = np.empty(n, np.uint8)
        if self._native is not None:
            lib, st = self._native
            lib.hsync_dc_process(
                ctypes.byref(st), raw.ctypes.data, ctypes.c_long(n),
                out_raw.ctypes.data, out_dc.ctypes.data)
            return out_raw, out_dc
        # slow path
        a = self._alpha
        dlen = len(self._delay)
        for k in range(n):
            lv = float(raw[k])
            for i in range(3):
                self._prev[i] = lv * a + (self._prev[i] - self._prev[i] * a)
                lv = self._prev[i]
            r = self._af if self._dc > lv else self._as
            self._dc = self._dc * (1 - r) + lv * r
            if dlen:
                out_raw[k] = self._delay[self._dpos]
                self._delay[self._dpos] = raw[k]
                self._dpos = (self._dpos + 1) % dlen
            else:
                out_raw[k] = raw[k]
            out_dc[k] = min(255, max(0, int(lv - self._dc)))
        return out_raw, out_dc
