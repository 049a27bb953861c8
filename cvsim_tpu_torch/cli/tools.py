"""The port's sibling tools: `cassette`, `scanimate` and `raw28ntsc`
(twins of cvsim_tpu.cli.tools.run_cassette, run_scanimate and
run_raw28ntsc), and the shared Y4M-in/Y4M-out scaffold of the sibling
tools, copied from cvsim_tpu/cli/tools.py: frames -> RGB at the output
field rate -> device op -> RGB -> Y4M. The other sibling tools are not
ported yet.
"""

from __future__ import annotations

import contextlib
import sys

import numpy as np
import torch

from cvsim_tpu_torch.cli.toolargs import ToolArgs as _ToolArgs
from cvsim_tpu_torch.host import timing, wavio, y4m
from cvsim_tpu_torch.native import hostpix

# frame scaling dispatches to the native library (bit-exact numpy
# fallback inside hostpix)
_scale_frame_to = hostpix.scale_frame_to


def _open_video_inputs(paths):
    """(readers, cleanups) for a list of video paths: native Y4M, or any
    container through the cvsim-av / ffmpeg backend (the reference's tools
    all demux through libav; ffmpeg_posterize.cpp:789-813 cost class)."""
    from cvsim_tpu_torch.host import ffmpeg_pipe

    if not paths:
        raise ValueError("needs at least one -i <input>")
    readers, cleanups = [], []
    for p in paths:
        r, c = ffmpeg_pipe.resolve_video_input(p)
        readers.append(r)
        cleanups.append(c)
    return readers, cleanups


def _open_video_output(path, enc: dict | None = None):
    """(stream, finalize) for a video output path: plain Y4M file, or an
    H.264 container encode through the backend."""
    from cvsim_tpu_torch.host import ffmpeg_pipe

    if not path:
        raise ValueError("needs -o <output>")
    return ffmpeg_pipe.resolve_video_output(path, **(enc or {}))


class _AsyncWriter:
    """Feeds writer.write(y, u, v) from a worker thread: the container
    encode rides a pipe whose write blocks on x264 backpressure, which
    would otherwise serialize per-frame compute with the encoder (the
    reference tools have the same serialization — beating them is the
    point). Bounded queue; close() flushes and re-raises any writer
    error. Use as a context manager: on error exit, its own secondary
    failure is suppressed (same rationale as _finalizing)."""

    def __init__(self, writer, depth: int = 8):
        import queue
        import threading

        self._w = writer
        self._q = queue.Queue(maxsize=depth)
        self._err = None
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            if self._err is None:
                try:
                    self._w.write(*item)
                except BaseException as e:  # keep draining: no producer hang
                    self._err = e

    def write(self, y, u, v):
        if self._err is not None:
            raise self._err
        self._q.put((y, u, v))

    def close(self):
        self._q.put(None)
        self._t.join()
        if self._err is not None:
            raise self._err

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self.close()
        else:
            try:
                self.close()
            except Exception:
                pass
        return False


@contextlib.contextmanager
def _finalizing(out_finalize):
    """Finalize the encoder on every exit (no live subprocess left behind
    in the resident daemon), but on an exception suppress finalize's OWN
    secondary error — closing a half-fed encoder exits nonzero on the
    truncated stream, and that must not mask the root cause (same guard as
    main._run_common's video stage)."""
    try:
        yield
    except BaseException:
        try:
            out_finalize()
        except Exception:
            pass
        raise
    else:
        out_finalize()


def _advance_fields(args: _ToolArgs, multi: bool):
    """Generator over (frames, fieldno) at the output field rate — the
    reference's layered InputFile advance loop (each input held for its
    own frame duration, all advancing in lockstep). Closes the input
    backends on exhaustion or caller abandonment."""
    paths = args.inputs if multi else args.inputs[:1]
    readers, in_cleanups = _open_video_inputs(paths)
    try:
        fpss = [r.header.fps for r in readers]
        n = len(readers)
        current = 0
        frame_idx = [0] * n
        frames = [None] * n
        next_at = [0] * n
        its = [iter(r) for r in readers]
        eof = [False] * n
        while True:
            for k in range(n):
                while not eof[k] and next_at[k] <= current:
                    try:
                        yf, uf, vf = next(its[k])
                    except StopIteration:
                        eof[k] = True
                        break
                    if uf is None:
                        uf = np.full_like(yf, 128)
                        vf = uf
                    frames[k] = _scale_underscan(
                        yf, uf, vf, args.width, args.height,
                        args.extra.get("underscan", 0))
                    frame_idx[k] += 1
                    next_at[k] = timing.frame_pts_to_field(
                        frame_idx[k], fpss[k], args.field_rate)
            if any(f is None for f in frames) or (
                    all(eof) and current >= max(next_at)):
                return
            yield frames, current
            current += 1
    finally:
        for c in in_cleanups:
            c()


def _open_tool_writer(args: _ToolArgs):
    out_hdr = y4m.Y4MHeader(
        width=args.width, height=args.height, fps=args.field_rate,
        interlacing="p", aspect="4:3",
        colorspace="422" if args.use_422 else "420jpeg")
    out_stream, out_finalize = _open_video_output(args.output)
    return y4m.Y4MWriter(out_stream, out_hdr), out_finalize


def _frame_loop_batched(args: _ToolArgs, per_batch, batch: int,
                        multi: bool = False):
    """Like _frame_loop, but fields are collected into batches of up to
    `batch` and handed to per_batch(frames [n,H,W,3] np, fieldnos [n]) ->
    list of RGB output frames. One device dispatch per batch instead of per
    field — the gen-1 GOP treatment for the compute-heavy sibling tools
    (VERDICT r2 #2)."""
    writer, out_finalize = _open_tool_writer(args)
    wslot = [None]

    def flush(buf_frames, buf_fields):
        outs = per_batch(np.stack(buf_frames), buf_fields)
        for out_rgb, fieldno in zip(outs, buf_fields):
            _write_rgb(wslot[0], out_rgb, args.use_422)
            print(f"\x0dOutput field {fieldno} ", end="", file=sys.stderr)

    with _finalizing(out_finalize), _AsyncWriter(writer) as aw:
        wslot[0] = aw
        buf_frames, buf_fields = [], []
        for frames, current in _advance_fields(args, multi):
            buf_frames.append(_last_frame(frames))
            buf_fields.append(current)
            if len(buf_frames) >= batch:
                flush(buf_frames, buf_fields)
                buf_frames, buf_fields = [], []
        if buf_frames:
            flush(buf_frames, buf_fields)
        print("", file=sys.stderr)
    return 0


def _last_frame(frames):
    """Reference multi-input semantics for the full-frame tools: every
    input's composite_layer overwrites the output, so the last input with a
    current frame wins (ffmpeg_posterize.cpp:1035-1061 loop shape)."""
    for f in reversed(frames):
        if f is not None:
            return f
    return frames[0]

def run_scanimate(argv, device: torch.device, batch: int = 16):
    """ffmpeg_scanimate flags (:653-698): -inntsc (source is interlaced NTSC),
    plus raster presets 720p60/1080p60 set width/height.

    One device call per `batch` fields (two with -inntsc, one per source-
    row parity), each field's phosphor splat an integer scatter-add on
    `device` (models/tools.scanimate_field); the frames cross as uint8
    RGB and only the uint8 gray raster crosses back (the RGB expansion is
    a host stack)."""
    args = _ToolArgs(argv, extra={"inntsc": ("flag", "inntsc")})
    input_ntsc = bool(args.extra.get("inntsc", False))

    from cvsim_tpu_torch.models import tools as ops

    def gray_of(frames, fieldnos, fld):
        src = torch.from_numpy(frames.astype(np.uint8)).to(device)
        r = ops.scanimate_field(src, args.height, args.width, fld, fieldnos,
                                input_ntsc=input_ntsc)
        return r.clamp(0, 255).to(torch.uint8).cpu().numpy()

    prev = {"frame": None}

    def per_batch(frames, fieldnos):
        if input_ntsc:
            # the source-row start is the field parity: split the batch by
            # parity, one call each, re-interleave
            par = np.asarray([(f & 1) ^ 1 for f in fieldnos])
            gray = np.empty((len(fieldnos), args.height, args.width),
                            np.uint8)
            for p in (0, 1):
                sel = np.nonzero(par == p)[0]
                if sel.size:
                    gray[sel] = gray_of(frames[sel],
                                        [fieldnos[i] for i in sel], p)
        else:
            gray = gray_of(frames, fieldnos, 0)
        outs = []
        for k, fieldno in enumerate(fieldnos):
            out = np.repeat(gray[k].astype(np.int32)[..., None], 3, axis=-1)
            parity = (fieldno & 1) ^ 1
            if parity == 1 and prev["frame"] is not None:
                # the copy-to-screen loop starts at y=field (:965): on odd
                # fields output row 0 keeps the persistent canvas's content
                out[0] = prev["frame"][0]
            prev["frame"] = out
            outs.append(out)
        return outs

    return _frame_loop_batched(args, per_batch, batch, multi=True)




def run_cassette(argv, device: torch.device):
    """ffmpeg_cassette flags (:420-560): -low -high -headalign
    -headalignwaver -mono -preset 0..4 -audio-hiss -preemphasis -deemphasis.
    Audio-only: -i in.wav -o out.wav. The chain runs on `device` in
    1M-sample chunks with a carried state."""
    from cvsim_tpu_torch.audio.cassette import (CASSETTE_PRESETS,
                                                CassetteConfig)
    from cvsim_tpu_torch.interop import key32_from_seed

    kw = dict()
    in_path = out_path = ""
    ss = se = dur = -1.0
    i = 0
    while i < len(argv):
        a = argv[i].lstrip("-"); i += 1
        if a in ("h", "help"):
            print("flags: -i <in.wav> -o <out.wav> -preset <0..4> -mono "
                  "-low <hz> -high <hz> -headalign <n> -headalignwaver <n> "
                  "-audio-hiss <dB> -preemphasis <0|1> -deemphasis <0|1> "
                  "-a <idx> -an -ss <s> -se <s> -t <s>", file=sys.stderr)
            return 1
        if a == "i":
            in_path = argv[i]; i += 1
        elif a == "o":
            out_path = argv[i]; i += 1
        elif a == "mono":
            kw["mono_downmix"] = True
        elif a == "headalign":
            kw["head_tilt"] = float(int(float(argv[i]))); i += 1  # atoi in ref
        elif a == "headalignwaver":
            kw["head_tilt_waver"] = float(int(float(argv[i]))); i += 1
        elif a == "low":
            kw["lowpass_hz"] = float(argv[i]); i += 1
        elif a == "high":
            kw["highpass_hz"] = float(argv[i]); i += 1
        elif a == "audio-hiss":
            kw["hiss_db"] = float(argv[i]); i += 1
        elif a == "preemphasis":
            kw["emulating_preemphasis"] = int(argv[i]) > 0; i += 1
        elif a == "deemphasis":
            kw["emulating_deemphasis"] = int(argv[i]) > 0; i += 1
        elif a == "preset":
            kw.update(CASSETTE_PRESETS[int(argv[i])]); i += 1
        elif a == "ss":
            ss = float(argv[i]); i += 1
        elif a == "se":
            se = float(argv[i]); i += 1
        elif a == "t":
            dur = float(argv[i]); i += 1
        elif a in ("a", "an"):
            if a == "a":
                i += 1
        else:
            print(f"Unknown switch '{a}'", file=sys.stderr)
            return 1
    if not in_path or not out_path:
        print("cassette needs -i in.wav -o out.wav", file=sys.stderr)
        return 1

    # preset values may be overridden by later flags: _ToolArgs-style ordering
    # is already handled because we apply dict.update in argv order.
    cfg = CassetteConfig(**{k: v for k, v in kw.items()
                            if k in CassetteConfig._fields})
    from cvsim_tpu_torch.host import ffmpeg_pipe

    # WAV natively; any other container/codec through the backend (the
    # reference decodes via libav, ffmpeg_cassette.cpp input loop)
    samples, rate = ffmpeg_pipe.resolve_audio_input(in_path, cfg.rate, 2)
    if rate != cfg.rate:
        from cvsim_tpu_torch.host.pipeline import _resample_sinc
        samples = _resample_sinc(samples, rate, cfg.rate)
    if ss >= 0 or se >= 0 or dur >= 0:
        if se < 0 and dur >= 0:
            se = max(ss, 0) + dur
        s0 = int(max(ss, 0) * cfg.rate)
        s1 = int(se * cfg.rate) if se >= 0 else len(samples)
        samples = samples[s0:s1]
    if samples.shape[1] != cfg.channels:
        if cfg.channels == 2 and samples.shape[1] == 1:
            samples = np.repeat(samples, 2, axis=1)
        else:
            samples = samples[:, :cfg.channels]

    out = cassette_chain(samples, cfg, key32_from_seed(0), device)
    wavio.write_wav(out_path, out.astype(np.int16), cfg.rate)
    return 0


def run_raw28ntsc(argv, device: torch.device):
    """Software composite-signal decoder (ffmpeg_raw28ntsc)."""
    from cvsim_tpu_torch.cli.raw28 import run as run_raw
    return run_raw(argv, device)


def cassette_chain(samples: np.ndarray, cfg, key32: int,
                   device: torch.device, chunk: int = 1 << 20) -> np.ndarray:
    """The cassette chain over a whole stream [N, C] (int16 range), in
    `chunk`-sample steps on `device` with a carried state (float32);
    returns int32 [N, C]."""
    from cvsim_tpu_torch.audio.cassette import (cassette_audio_process,
                                                init_cassette_state)

    state = init_cassette_state(cfg, torch.float32, device)
    outs = []
    for pos in range(0, len(samples), chunk):
        part = np.ascontiguousarray(samples[pos:pos + chunk], np.int32)
        out, state = cassette_audio_process(
            torch.from_numpy(part).to(device), state, key32, cfg=cfg)
        outs.append(out.cpu().numpy())
    return np.concatenate(outs)


def _scale_underscan(yf, uf, vf, w, h, underscan, chroma="repeat"):
    """Frame scale with the InputFile tools' -underscan: the image renders
    at (100-u)% size centered on a black canvas (ffmpeg_vhsled.cpp:307-331,
    same block in frameblend.cpp/filmac.cpp). The restore tools pass
    chroma="bilinear": the reference's InputFile ingest interpolates chroma
    up through an SWS_BILINEAR resampler (ffmpeg_vhsled.cpp:318-323)."""
    if underscan <= 0:
        return _scale_frame_to(yf, uf, vf, w, h, chroma)
    u = min(99, underscan)
    fw = max(1, (w * (100 - u)) // 100)
    fh = max(1, (h * (100 - u)) // 100)
    img = np.asarray(_scale_frame_to(yf, uf, vf, fw, fh, chroma))
    canvas = np.zeros((h, w, 3), img.dtype)
    x0, y0 = (w - fw) // 2, (h - fh) // 2
    canvas[y0:y0 + fh, x0:x0 + fw] = img
    return canvas


def _write_rgb(writer, rgb, use_422: bool):
    y, u, v = hostpix.rgb_to_yuv_planes(np.asarray(rgb))
    if use_422:
        writer.write(y, u[:, 0::2], v[:, 0::2])
    else:
        writer.write(y, u[0::2, 0::2], v[0::2, 0::2])
