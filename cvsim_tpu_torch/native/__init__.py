"""Native host code of the port: the container-I/O tool `cvsim-av`
(avio.cpp + hostpix.cpp) and the frame scaler binding (hostpix.py).

The port's copies of cvsim_tpu/native's sources, built from this
directory with g++ on first use (the outputs are listed in .gitignore).
"""

from __future__ import annotations

import os
import subprocess
import sys
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
_AV_SRC = os.path.join(_DIR, "avio.cpp")
# the pixel kernels, compiled into cvsim-av as well so that its tool loops
# and the Python binding (hostpix.py, libhostpix.so) share one
# implementation
_AV_PIX_SRC = os.path.join(_DIR, "hostpix.cpp")
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
                          os.path.getmtime(_AV_PIX_SRC))):
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
