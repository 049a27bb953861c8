"""Container I/O backends: native cvsim-av (libav*), or an ffmpeg binary.

The reference links libav* in-process (ffmpeg_to_composite.cpp:34-53);
here the container layer lives in a native subprocess tool speaking Y4M /
raw PCM over pipes: `cvsim-av` (cvsim_tpu_torch/native/avio.cpp), built on first
use against the system FFmpeg libraries, handles demux/decode/encode/mux
including the reference's one-container H.264+PCM output shape
(ffmpeg_to_composite.cpp:2034-2106) and emits real container timestamps
(in-band VFR durations, packet logs for normalize-ts, audio packet logs
for the A/V master clock).  When the libraries are absent, an `ffmpeg`
binary on PATH serves the same pipes; with neither, the framework speaks
native Y4M/WAV only.
"""

from __future__ import annotations

import os
import shutil
import subprocess

from cvsim_tpu_torch.host import y4m


def av_tool() -> str | None:
    """Path to the native cvsim-av binary, building it on first use.
    None when the FFmpeg dev libraries / compiler are unavailable."""
    from cvsim_tpu_torch import native

    return native.build_av_tool()


def have_ffmpeg() -> bool:
    return shutil.which("ffmpeg") is not None


def have_backend() -> bool:
    return av_tool() is not None or have_ffmpeg()


def open_video_reader(path: str, *, frame_log: str | None = None,
                      pkt_log: str | None = None,
                      audio_pkt_log: str | None = None):
    """Decode any container to a Y4M pipe. Returns (Y4MReader, Popen).

    With the native backend, frames carry in-band Xt=<pts>:<dur>
    timestamps (Y4MReader.frame_params) and the optional sidecar logs are
    written in the CLI's -pts-in / -audio-pts-in formats."""
    tool = av_tool()
    if tool is not None:
        cmd = [tool, "decode", "-i", path, "-ts"]
        if frame_log:
            cmd += ["-frame-log", frame_log]
        if pkt_log:
            cmd += ["-pkt-log", pkt_log]
        if audio_pkt_log:
            cmd += ["-audio-pkt-log", audio_pkt_log]
    else:
        cmd = ["ffmpeg", "-nostdin", "-v", "error", "-i", path,
               "-f", "yuv4mpegpipe", "-pix_fmt", "yuv420p", "-"]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE)
    return y4m.Y4MReader(proc.stdout), proc


def open_video_writer(path: str, header: y4m.Y4MHeader, crf: int = 18):
    """Encode a Y4M pipe to H.264 with the reference's encoder shape."""
    tool = av_tool()
    if tool is not None:
        cmd = [tool, "encode", "-o", path, "-crf", str(crf)]
    else:
        cmd = ["ffmpeg", "-nostdin", "-v", "error", "-y",
               "-f", "yuv4mpegpipe", "-i", "-",
               "-c:v", "libx264", "-g", "15", "-bf", "0", "-crf", str(crf),
               "-aspect", "4:3", path]
    proc = subprocess.Popen(cmd, stdin=subprocess.PIPE)
    return y4m.Y4MWriter(proc.stdin, header), proc


def read_audio(path: str, rate: int, channels: int,
               pkt_log: str | None = None):
    """Decode + resample any audio to int16 [N, C]."""
    import numpy as np

    tool = av_tool()
    if tool is not None:
        cmd = [tool, "decode-audio", "-i", path, "-rate", str(rate),
               "-ch", str(channels)]
        if pkt_log:
            cmd += ["-audio-pkt-log", pkt_log]
    else:
        cmd = ["ffmpeg", "-nostdin", "-v", "error", "-i", path,
               "-f", "s16le", "-ac", str(channels), "-ar", str(rate), "-"]
    out = subprocess.run(cmd, stdout=subprocess.PIPE, check=True)
    data = np.frombuffer(out.stdout, "<i2")
    return data.reshape(-1, channels)


def probe(path: str) -> dict | None:
    """Stream info for a container (native backend only)."""
    import json

    tool = av_tool()
    if tool is None:
        return None
    out = subprocess.run([tool, "probe", "-i", path],
                         stdout=subprocess.PIPE, check=True)
    return json.loads(out.stdout)


def resolve_video_input(path: str):
    """Return (reader, cleanup) for a video path: native Y4M, or any
    container via the cvsim-av / ffmpeg backend."""
    if path.endswith(".y4m") or not have_backend():
        f = open(path, "rb")
        return y4m.Y4MReader(f), f.close
    reader, proc = open_video_reader(path)

    def cleanup():
        proc.stdout.close()
        proc.wait()

    return reader, cleanup


def resolve_video_output(path: str, *, mux_wav: str | None = None,
                         interlaced: bool = False, crf: int = 18,
                         crf_max: int | None = None,
                         preset: str | None = None,
                         bit_rate: int | None = None):
    """Return (out_stream, finalize) for a video output path.

    `.y4m` (or no backend): a plain file the pipeline writes Y4M into.
    Anything else: an encode process shaped like the reference's output
    setup (H.264 gop 15, no B-frames, 4:3 SAR, optional interlaced DCT;
    ffmpeg_to_composite.cpp:2067-2106), optionally muxing a processed WAV
    as PCM S16LE alongside (:2034-2065) so the tool emits ONE container
    with both streams, like every reference video tool.

    crf/crf_max/preset/bit_rate select the per-tool x264 profile: the
    restore tools encode superfast crf 16 (ffmpeg_vhsled.cpp:752-754,
    filmac.cpp:740-742), frameblend uses 25 Mbps ABR (frameblend.cpp:794);
    bit_rate, when given, replaces crf."""
    if path.endswith(".y4m") or not have_backend():
        f = open(path, "wb")
        return f, f.close
    tool = av_tool()
    if tool is not None:
        cmd = [tool, "encode", "-o", path]
        if bit_rate is not None:
            cmd += ["-vb", str(bit_rate)]
        else:
            cmd += ["-crf", str(crf)]
            if crf_max is not None:
                cmd += ["-crf-max", str(crf_max)]
        if preset is not None:
            cmd += ["-preset", preset]
        if mux_wav is not None:
            cmd += ["-wav", mux_wav]
        if interlaced:
            cmd += ["-interlaced"]
    else:
        cmd = ["ffmpeg", "-nostdin", "-v", "error", "-y",
               "-f", "yuv4mpegpipe", "-i", "-"]
        if mux_wav is not None:
            cmd += ["-i", mux_wav, "-c:a", "pcm_s16le", "-shortest"]
        cmd += ["-c:v", "libx264", "-g", "15", "-bf", "0", "-aspect", "4:3"]
        if bit_rate is not None:
            cmd += ["-b:v", str(bit_rate)]
        else:
            cmd += ["-crf", str(crf)]
            if crf_max is not None:
                cmd += ["-x264-params", f"crf-max={crf_max}"]
        if preset is not None:
            cmd += ["-preset", preset]
        if interlaced:
            cmd += ["-flags", "+ildct"]
        cmd += [path]
    proc = subprocess.Popen(cmd, stdin=subprocess.PIPE)

    def finalize():
        proc.stdin.close()
        rc = proc.wait()
        if rc:
            raise RuntimeError(f"container encoder exited with {rc}")

    return proc.stdin, finalize


def resolve_audio_input(path: str, rate: int, channels: int,
                        pkt_log: str | None = None):
    """Return (int16 samples [N, C], rate): native WAV (any rate/layout,
    resampled downstream), or any container via the backend.  pkt_log
    (native backend) captures the container's audio packet timestamps in
    the -audio-pts-in format for A/V master-clock gap fill."""
    if path.endswith(".wav") or not have_backend():
        from cvsim_tpu_torch.host import wavio

        return wavio.read_wav(path)
    return read_audio(path, rate, channels, pkt_log=pkt_log), rate
