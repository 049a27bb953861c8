"""ctypes binding for the native host-pixel kernels (libhostpix).

The port's copy of cvsim_tpu/native/hostpix.py: `scale_frame_to`, the
sibling tools' per-frame ingest, and its uint8 form `scale_frame_to_u8`,
the gen-2 pipeline's,
`rgb_to_yuv_planes`, the sibling tools' output conversion, and the
restore tools' pixel maps (`vhsled_dejitter`, `frameblend_mix`,
`filmac_measure`, `filmac_rescale`). The C++ kernels (hostpix.cpp, the
reference package's with the lerp clamped to 0..255) are bit-exact with
colorconv.scale_frame_to_np, rgb_to_yuv601_np and models/tools_np.py
(same float32 operation order, numpy rounding and floor division); they
are built with g++ on first use into _build/ here, and each wrapper
falls back to its numpy twin when g++ is unavailable.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "hostpix.cpp")
# the per-pixel RGB->YUV it shares with the card's payload kernel
_HDR = os.path.join(_DIR, os.pardir, "csrc", "yuv601.cuh")
# in a directory of its own: a .so beside the package's modules would be
# listed as an importable module by pkgutil
_LIB = os.path.join(_DIR, "_build", "libhostpix.so")
_lock = threading.Lock()
_state: list = []   # [lib | None] once resolved

_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_L = ctypes.c_long
_i64 = ctypes.c_int64


def _load():
    """The shared library, or None (no compiler). Never raises."""
    with _lock:
        if _state:
            return _state[0]
        lib = None
        try:
            if (not os.path.exists(_LIB)
                    or os.path.getmtime(_LIB) < max(
                        os.path.getmtime(_SRC), os.path.getmtime(_HDR))):
                # private temp name + atomic rename: concurrent processes
                # must never dlopen a half-linked library
                os.makedirs(os.path.dirname(_LIB), exist_ok=True)
                tmp = f"{_LIB}.tmp.{os.getpid()}"
                # -ffp-contract=off: FMA contraction would change the f32
                # results vs numpy (see hostpix.cpp header). -march=native
                # (the library is a self-built per-host cache) vectorizes
                # rintf to a round instruction instead of a libm call —
                # ~4x on the scale kernel; fall back to baseline codegen
                # on compilers/hosts where it fails.
                base = ["g++", "-O3", "-shared", "-fPIC",
                        "-ffp-contract=off", "-fno-math-errno",
                        "-o", tmp, _SRC]
                try:
                    subprocess.run(base[:1] + ["-march=native"] + base[1:],
                                   check=True, capture_output=True)
                except subprocess.CalledProcessError:
                    subprocess.run(base, check=True, capture_output=True)
                os.replace(tmp, _LIB)
            lib = ctypes.CDLL(_LIB)
            lib.cvsim_scale_frame.argtypes = [
                _u8p, _u8p, _u8p, _L, _L, _L, _L, _L, _L,
                _i64p, _i64p, _f32p, ctypes.c_int,
                _i64p, _i64p, _f32p, ctypes.c_int, _i32p]
            lib.cvsim_scale_frame_u8.argtypes = [
                _u8p, _u8p, _u8p, _L, _L, _L, _L, _L, _L,
                _i64p, _i64p, _f32p, ctypes.c_int,
                _i64p, _i64p, _f32p, ctypes.c_int, _u8p]
            lib.cvsim_scale_frame_bc.argtypes = [
                _u8p, _u8p, _u8p, _L, _L, _L, _L, _L, _L,
                _i64p, _i64p, _f32p, ctypes.c_int,
                _i64p, _i64p, _f32p, ctypes.c_int,
                _i64p, _i64p, _f32p, ctypes.c_int,
                _i64p, _i64p, _f32p, ctypes.c_int, _i32p]
            lib.cvsim_rgb_to_yuv.argtypes = [_i32p, _L, _L, _u8p, _u8p, _u8p]
            lib.cvsim_vhsled_dejitter.argtypes = [_i32p, _L, _L, _i32p]
            lib.cvsim_frameblend_mix.argtypes = [
                ctypes.POINTER(ctypes.c_void_p), _L, _L, _L, _i64p,
                ctypes.c_void_p, ctypes.c_void_p, _i32p]
            lib.cvsim_filmac_measure.argtypes = [
                _i32p, _L, _L, ctypes.c_void_p,
                ctypes.POINTER(_i64), ctypes.POINTER(_i64)]
            lib.cvsim_filmac_rescale.argtypes = [
                _i32p, _L, _L, _i64, _i64, _i64, ctypes.c_void_p,
                ctypes.c_void_p, _i32p]
        except Exception:
            lib = None
        _state.append(lib)
        return lib


_ID = np.zeros(0, np.int64)
_IDF = np.zeros(0, np.float32)


def _scale_args(y, u, v, width: int, height: int) -> tuple:
    """The arguments of the cvsim_scale_frame* entries before their chroma
    constants and `out`: the planes, the sizes, the resampling constants."""
    from cvsim_tpu_torch.host.batching import hscale_consts

    y = np.ascontiguousarray(y, np.uint8)
    u = np.ascontiguousarray(u, np.uint8)
    v = np.ascontiguousarray(v, np.uint8)
    sh, sw = y.shape
    ch, cw = u.shape
    hc = hscale_consts(sw, width)
    vc = hscale_consts(sh, height)
    hx0, hx1, hf = (hc if hc is not None else (_ID, _ID, _IDF))
    vx0, vx1, vf = (vc if vc is not None else (_ID, _ID, _IDF))
    return (y, u, v, sh, sw, ch, cw, height, width,
            np.ascontiguousarray(hx0, np.int64),
            np.ascontiguousarray(hx1, np.int64),
            np.ascontiguousarray(hf, np.float32), int(hc is not None),
            np.ascontiguousarray(vx0, np.int64),
            np.ascontiguousarray(vx1, np.int64),
            np.ascontiguousarray(vf, np.float32), int(vc is not None))


def scale_frame_to(y, u, v, width: int, height: int,
                   chroma: str = "repeat"):
    """colorconv.scale_frame_to_np, native when available. chroma="bilinear"
    interpolates chroma up to luma resolution (the restore tools' ingest —
    the reference converts through an SWS_BILINEAR resampler,
    ffmpeg_vhsled.cpp:318-323); "repeat" replicates (the engines')."""
    lib = _load()
    if lib is None:
        from cvsim_tpu_torch.host.colorconv import scale_frame_to_np
        return scale_frame_to_np(y, u, v, width, height, chroma)
    from cvsim_tpu_torch.host.batching import hscale_consts

    common = _scale_args(y, u, v, width, height)
    out = np.empty((height, width, 3), np.int32)
    if chroma == "bilinear":
        (sh, sw), (ch, cw) = np.shape(y), np.shape(u)
        cu = hscale_consts(cw, sw)
        cv = hscale_consts(ch, sh)
        cux0, cux1, cuf = (cu if cu is not None else (_ID, _ID, _IDF))
        cvx0, cvx1, cvf = (cv if cv is not None else (_ID, _ID, _IDF))
        lib.cvsim_scale_frame_bc(
            *common,
            np.ascontiguousarray(cux0, np.int64),
            np.ascontiguousarray(cux1, np.int64),
            np.ascontiguousarray(cuf, np.float32), int(cu is not None),
            np.ascontiguousarray(cvx0, np.int64),
            np.ascontiguousarray(cvx1, np.int64),
            np.ascontiguousarray(cvf, np.float32), int(cv is not None),
            out)
    else:
        lib.cvsim_scale_frame(*common, out)
    return out


def scale_frame_to_u8(y, u, v, width: int, height: int):
    """scale_frame_to(..., chroma="repeat") as uint8 [height, width, 3]:
    the same values (every one is clipped to 0..255), a quarter of the
    bytes. The gen-2 pipeline's ingest: its GOP goes to the card as
    uint8."""
    lib = _load()
    if lib is None:
        from cvsim_tpu_torch.host.colorconv import scale_frame_to_np
        return scale_frame_to_np(y, u, v, width, height).astype(np.uint8)
    out = np.empty((height, width, 3), np.uint8)
    lib.cvsim_scale_frame_u8(*_scale_args(y, u, v, width, height), out)
    return out


def rgb_to_yuv_planes(rgb):
    """(y, u, v) full-resolution uint8 planes from an int32 RGB frame
    (colorconv.rgb_to_yuv601_np + uint8 cast), native when available."""
    lib = _load()
    rgb = np.ascontiguousarray(rgb, np.int32)
    h, w = rgb.shape[:2]
    if lib is None:
        from cvsim_tpu_torch.host.colorconv import rgb_to_yuv601_np
        y, u, v = rgb_to_yuv601_np(rgb[..., 0], rgb[..., 1], rgb[..., 2])
        return (y.astype(np.uint8), u.astype(np.uint8), v.astype(np.uint8))
    y = np.empty((h, w), np.uint8)
    u = np.empty((h, w), np.uint8)
    v = np.empty((h, w), np.uint8)
    lib.cvsim_rgb_to_yuv(rgb, h, w, y, u, v)
    return y, u, v


def vhsled_dejitter(rgb):
    """tools_np.vhsled_dejitter, native when available."""
    lib = _load()
    if lib is None:
        from cvsim_tpu_torch.models import tools_np
        return tools_np.vhsled_dejitter(rgb)
    f = np.ascontiguousarray(rgb, np.int32)
    h, w = f.shape[:2]
    out = np.empty_like(f)
    lib.cvsim_vhsled_dejitter(f, h, w, out)
    return out


def frameblend_mix(frames, w16, gamma_dec=None, gamma_enc=None):
    """tools_np.frameblend_mix, native when available. `frames` may be a
    stacked [K, H, W, 3] array or a list of [H, W, 3] frames — the list
    form avoids the per-output-frame stacked copy (a ~10-frame lookahead
    at SD is ~40 MB of memcpy per blend)."""
    lib = _load()
    if lib is None:
        from cvsim_tpu_torch.models import tools_np
        return tools_np.frameblend_mix(np.stack([np.asarray(f)
                                                 for f in frames])
                                       if isinstance(frames, (list, tuple))
                                       else frames,
                                       w16, gamma_dec, gamma_enc)
    fl = [np.ascontiguousarray(f, np.int32) for f in frames]
    k = len(fl)
    h, w = fl[0].shape[:2]
    ptrs = (ctypes.c_void_p * k)(*[f.ctypes.data for f in fl])
    wv = np.ascontiguousarray([wt for _, wt in w16], np.int64)
    gd = None if gamma_dec is None else np.ascontiguousarray(gamma_dec,
                                                             np.int64)
    ge = None if gamma_enc is None else np.ascontiguousarray(gamma_enc,
                                                             np.int64)
    out = np.empty((h, w, 3), np.int32)
    lib.cvsim_frameblend_mix(
        ptrs, k, h, w, wv,
        None if gd is None else gd.ctypes.data,
        None if ge is None else ge.ctypes.data, out)
    return out


def filmac_measure(rgb, gamma_dec=None):
    """tools_np.filmac_measure, native when available."""
    lib = _load()
    if lib is None:
        from cvsim_tpu_torch.models import tools_np
        return tools_np.filmac_measure(rgb, gamma_dec)
    f = np.ascontiguousarray(rgb, np.int32)
    h, w = f.shape[:2]
    gd = None if gamma_dec is None else np.ascontiguousarray(gamma_dec,
                                                             np.int64)
    scaleto = 0x10000 * (8192 if gamma_dec is not None else 256)
    mn, mx = _i64(), _i64()
    lib.cvsim_filmac_measure(
        f, h, w, None if gd is None else gd.ctypes.data,
        ctypes.byref(mn), ctypes.byref(mx))
    return int(mn.value), int(mx.value), scaleto


def filmac_rescale(rgb, state, scaleto: int, gamma_dec=None, gamma_enc=None):
    """tools_np.filmac_rescale, native when available."""
    lib = _load()
    if lib is None:
        from cvsim_tpu_torch.models import tools_np
        return tools_np.filmac_rescale(rgb, state, scaleto, gamma_dec,
                                       gamma_enc)
    f = np.ascontiguousarray(rgb, np.int32)
    h, w = f.shape[:2]
    gd = None if gamma_dec is None else np.ascontiguousarray(gamma_dec,
                                                             np.int64)
    ge = None if gamma_enc is None else np.ascontiguousarray(gamma_enc,
                                                             np.int64)
    out = np.empty_like(f)
    lib.cvsim_filmac_rescale(
        f, h, w, int(state.minv), int(state.maxv), int(scaleto),
        None if gd is None else gd.ctypes.data,
        None if ge is None else ge.ctypes.data, out)
    return out
