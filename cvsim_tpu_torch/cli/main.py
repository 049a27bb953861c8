"""cvsim_tpu_torch command line: `python -m cvsim_tpu_torch [--device
cuda|cpu] <command> <flags>`, or `python -m cvsim_tpu_torch -via <socket>
<command> <flags>` to run it in a resident `serve` process.

The twin of cvsim_tpu.cli.main, with all 17 of its commands. Flags are
the reference's, parsed by the port's copies of cvsim_tpu.presets and the
tools' parsers. The device commands (DEVICE_COMMANDS: the gen-2 `ntsc`
and gen-1 `to-composite` engines, `cassette`, `raw28ntsc`, `scanimate`,
and `serve`, whose `-prime` runs the gen-1 engine) run on the device
that `--device` names, cuda by default; without a GPU they fail unless
`--device cpu` is given, and never carry on on the CPU quietly. Both
video tools take `-audio-in`: the audio runs first (audio/chains.py), and
its WAV goes to `-audio-out` or is muxed into a container `-o`.
`-devices n` splits each GOP's fields over n devices of that kind: n
GPUs (fewer visible is an error), or n shards on the CPU.

The other eleven commands (the pixel tools `posterize`, `colormap`,
`colorkey`, `average-delay`, the restore tools `frameblend`, `filmac`,
`vhsled`, and `normalize-ts`, `vaporwave`, `repo-update-all`,
`repo-source-pickup`) do no device work, in the JAX package either:
they parse `--device` and ignore it, and never import torch.
CVSIM_PROFILE=<dir> writes a torch.profiler trace of the whole command
there (utils/log.profile_trace); CVSIM_PHASES=1 prints phase lines;
CVSIM_TRACE=<dir> writes the program's spans and counters of the command
there (`spans-<pid>-<n>.json`: spans by GOP and call, each thread's
busy, blocked and idle shares, counter totals; utils/log.py). A `serve`
writes one of each file per command it runs.
"""

from __future__ import annotations

import contextlib
import os
import signal
import sys
import tempfile
from typing import TYPE_CHECKING

from cvsim_tpu_torch import presets
from cvsim_tpu_torch.utils.log import phase, profile_trace

if TYPE_CHECKING:   # device commands import torch when they run
    import torch


def _soft_sigint():
    """Soft Ctrl-C: finish the current batch and write the trailer; abort
    after 20 signals (reference DIE counter, ffmpeg_to_composite.cpp:62-66)."""
    state = {"die": 0}

    def handler(sig, frame):
        state["die"] += 1
        if state["die"] >= 20:
            raise SystemExit(130)

    for s in (signal.SIGINT, signal.SIGTERM, signal.SIGHUP):
        try:
            signal.signal(s, handler)
        except (ValueError, OSError):
            pass   # not the main thread
    return state


def _run_audio_stage(st, audio_pipe, will_encode_video: bool,
                     resuming: bool, gen1: bool):
    """The audio side, run before the video so that its WAV can be muxed
    into the video container in the same encode (reference: one file
    with H.264 + PCM, ffmpeg_to_composite.cpp:2034-2106). Returns
    (mux_wav, temp file to delete); -audio-out wins when given.
    `audio_pipe()` gives the CompositePipeline whose run_audio runs."""
    from cvsim_tpu_torch.host import ffmpeg_pipe

    if not (st.audio_in and st.audio_stream_index >= 0):
        return None, None
    audio_dst = st.audio_out
    # muxing needs the video stage to run (the container is written by
    # the video encoder); without it the WAV would land in a temp file
    want_mux = (not audio_dst and will_encode_video
                and not st.output_file.endswith(".y4m")
                and ffmpeg_pipe.have_backend())
    audio_tmp = None
    if want_mux:
        fd, audio_tmp = tempfile.mkstemp(suffix=".wav", prefix="cvsim_mux_")
        os.close(fd)
        audio_dst = audio_tmp
    if not audio_dst:
        print("audio input given but no -audio-out and no container "
              "video output to mux into; skipping audio", file=sys.stderr)
        return None, None
    if resuming and os.path.exists(audio_dst) and audio_dst != audio_tmp:
        print("Resume: audio output already complete; skipping",
              file=sys.stderr)
    else:
        pts_packets = None
        if gen1 and st.audio_pts_in:
            from cvsim_tpu_torch.host import timing as _timing

            pts_packets = _timing.read_audio_pts_log(st.audio_pts_in)
        try:
            audio_pipe().run_audio(st.audio_in, audio_dst,
                                   pts_packets=pts_packets)
        except BaseException:
            _unlink(audio_tmp)
            raise
    return (audio_dst if want_mux else None), audio_tmp


def _unlink(path):
    if path:
        try:
            os.unlink(path)
        except OSError:
            pass


def _run_video(run, finalize, cleanups):
    """run() then finalize(); a failing finalize after a failed run (a
    half-fed encoder exits nonzero) never masks the root cause."""
    try:
        fields = run()
    except BaseException:
        try:
            finalize()
        except Exception:
            pass
        raise
    else:
        finalize()
    finally:
        for c in cleanups:
            c()
    return fields


def _frame_log(st):
    if not st.video_pts_in:
        return None, 90000
    from cvsim_tpu_torch.host import timing as _timing

    return _timing.read_frame_pts_log(st.video_pts_in)


def _open_output(st, resuming: bool, **kw):
    from cvsim_tpu_torch.host import ffmpeg_pipe

    if resuming:
        out_stream = open(st.output_file, "r+b")
        return out_stream, out_stream.close
    return ffmpeg_pipe.resolve_video_output(st.output_file, **kw)


def cmd_ntsc(argv, device: torch.device):
    """Gen-2 YIQ engine tool (ffmpeg_ntsc)."""
    from cvsim_tpu_torch.host import ffmpeg_pipe
    from cvsim_tpu_torch.host.pipeline import CompositePipeline
    from cvsim_tpu_torch.host.pipeline_yiq import YIQPipeline

    st = presets.parse_composite_flags(argv, gen2=True)
    if not st.output_file and not st.audio_out:
        print("No output file specified", file=sys.stderr)
        return 1
    die = _soft_sigint()
    cfg = st.to_run_config(gen1=False)
    ckpt_path, resuming = _checkpoint_path(st, cfg)
    pipe = YIQPipeline(cfg, frame_delay=st.frame_delay, die=die,
                       device=device, devices=st.devices)
    will_encode_video = bool(st.input_files and st.video_stream_index >= 0
                             and st.output_file)
    fields = 0
    mux_wav, audio_tmp = None, None
    try:
        mux_wav, audio_tmp = _run_audio_stage(
            st, lambda: CompositePipeline(cfg, device=device),
            will_encode_video, resuming, gen1=False)
        if will_encode_video:
            readers, cleanups = [], []
            for path in st.input_files:
                r, c = ffmpeg_pipe.resolve_video_input(path)
                readers.append(r)
                cleanups.append(c)
            out_stream, finalize = _open_output(st, resuming,
                                                mux_wav=mux_wav)
            frame_log, log_rate = _frame_log(st)
            fields = _run_video(
                lambda: pipe.run_video(readers, out_stream,
                                       ckpt_path=ckpt_path,
                                       frame_log=frame_log,
                                       frame_log_rate=log_rate),
                finalize, cleanups)
    finally:
        _unlink(audio_tmp)
    print(f"\n{fields} fields", file=sys.stderr)
    return 0


def cmd_to_composite(argv, device: torch.device):
    """Flagship gen-1 tool (ffmpeg_to_composite): audio first, then the
    video if there is any (the JAX package's `_run_common` order)."""
    st = presets.parse_composite_flags(argv, gen2=False)
    if ((not st.input_files and not st.audio_in)
            or (st.input_files and not st.output_file)):
        print("You must specify an input and output file (-i and -o).",
              file=sys.stderr)
        return 1
    from cvsim_tpu_torch.host import ffmpeg_pipe
    from cvsim_tpu_torch.host.pipeline import CompositePipeline

    die = _soft_sigint()
    cfg = st.to_run_config(gen1=True)
    print(f"Transcoding from {max(0.0, st.transcode_start):.2f} to "
          f"{st.transcode_end:.2f}", file=sys.stderr)
    print(f"VHS head switching point: {st.vhs_head_switching_point:.6f}",
          file=sys.stderr)
    print(f"VHS head switching noise: {st.vhs_head_switching_phase_noise:.6f}",
          file=sys.stderr)
    pipe = CompositePipeline(cfg, die=die, device=device, devices=st.devices)
    ckpt_path, resuming = _checkpoint_path(st, cfg)
    will_encode_video = bool(st.input_files and st.video_stream_index >= 0
                             and st.output_file)
    mux_wav, audio_tmp = None, None
    try:
        mux_wav, audio_tmp = _run_audio_stage(
            st, lambda: pipe, will_encode_video, resuming, gen1=True)
        if will_encode_video:
            reader, rclean = ffmpeg_pipe.resolve_video_input(
                st.input_files[0])
            out_stream, finalize = _open_output(
                st, resuming, mux_wav=mux_wav,
                interlaced=cfg.output.interlaced_output)
            frame_log, log_rate = _frame_log(st)
            _run_video(
                lambda: pipe.run_video(reader, out_stream,
                                       ckpt_path=ckpt_path,
                                       frame_log=frame_log,
                                       frame_log_rate=log_rate),
                finalize, [rclean])
    finally:
        _unlink(audio_tmp)
    return 0


def cmd_cassette(argv, device: torch.device):
    """Audio-cassette tool (ffmpeg_cassette)."""
    from cvsim_tpu_torch.cli.tools import run_cassette

    return run_cassette(argv, device)


def _checkpoint_path(st, cfg):
    """(ckpt_path, resuming) for -checkpoint. Only a native Y4M output can
    be truncated-and-appended; encoder pipes cannot."""
    if not (st.checkpoint and st.output_file):
        return None, False
    if not st.output_file.endswith(".y4m"):
        print("-checkpoint requires a .y4m output; ignoring",
              file=sys.stderr)
        return None, False
    from cvsim_tpu_torch.host import checkpoint as _ckpt

    ckpt_path = st.output_file + ".ckpt"
    loaded = _ckpt.load(ckpt_path)
    resuming = bool(loaded
                    and loaded[0].get("cfg_hash") == _ckpt.config_hash(cfg)
                    and os.path.exists(st.output_file))
    return ckpt_path, resuming


def cmd_raw28ntsc(argv, device: torch.device):
    """Software composite-signal decoder (ffmpeg_raw28ntsc)."""
    from cvsim_tpu_torch.cli.tools import run_raw28ntsc

    return run_raw28ntsc(argv, device)


def cmd_scanimate(argv, device: torch.device):
    """CRT phosphor-dot re-render (ffmpeg_scanimate)."""
    from cvsim_tpu_torch.cli.tools import run_scanimate

    return run_scanimate(argv, device)


def _tool(name):
    def run(argv):
        from cvsim_tpu_torch.cli import tools
        return getattr(tools, f"run_{name}")(argv)
    return run


def _restore_tool(name):
    """vhsled/frameblend/filmac: the numpy-free native fast path first
    (cli/toolargs.fast_restore: the whole loop runs inside cvsim-av);
    the full cli/tools loop for anything it declines."""
    def run(argv):
        from cvsim_tpu_torch.cli import toolargs
        rc = toolargs.fast_restore(name, argv)
        if rc is not None:
            return rc
        from cvsim_tpu_torch.cli import tools
        return getattr(tools, f"run_{name}")(argv)
    return run


def _cmd_vaporwave(argv):
    """text2vaporwave.pl: ASCII -> fullwidth unicode (args or stdin)."""
    from cvsim_tpu_torch.utils import vaporwave

    return vaporwave.main(argv)


def _cmd_repo_update_all(argv):
    """git-update-all[-wo-push]: commit the whole tree, push + fetch."""
    from cvsim_tpu_torch.utils import repo_maint

    return repo_maint.main_update_all(argv)


def _cmd_repo_source_pickup(argv):
    """git-source-pickup.pl: dated commit-stamped source .tar.xz."""
    from cvsim_tpu_torch.utils import repo_maint

    return repo_maint.main_source_pickup(argv)


def cmd_serve(argv, device):
    """Daemon mode (cli/serve.py): a resident process that keeps the CUDA
    context and the built kernels loaded across commands."""
    from cvsim_tpu_torch.cli import serve

    return serve.run_serve(argv, device)


COMMANDS = {
    "to-composite": cmd_to_composite,
    "ntsc": cmd_ntsc,
    "cassette": cmd_cassette,
    "colorkey": _tool("colorkey"),
    "colormap": _tool("colormap"),
    "posterize": _tool("posterize"),
    "scanimate": cmd_scanimate,
    "average-delay": _tool("average_delay"),
    "frameblend": _restore_tool("frameblend"),
    "filmac": _restore_tool("filmac"),
    "vhsled": _restore_tool("vhsled"),
    "raw28ntsc": cmd_raw28ntsc,
    "normalize-ts": _tool("normalize_ts"),
    "vaporwave": _cmd_vaporwave,
    "repo-update-all": _cmd_repo_update_all,
    "repo-source-pickup": _cmd_repo_source_pickup,
    "serve": cmd_serve,
}

# Commands whose work runs on the device: they take (argv, device). The
# rest run on the host alone, take (argv), and never import torch.
DEVICE_COMMANDS = {"to-composite", "ntsc", "cassette", "scanimate",
                   "raw28ntsc", "serve"}

USAGE = ("usage: python -m cvsim_tpu_torch [--device cuda|cpu] "
         "[-via <socket>] <command> [flags]\ncommands: "
         + " ".join(sorted(COMMANDS)))


def _split_device(argv):
    """(device name, rest) from a leading `--device X`."""
    if argv and argv[0] == "--device":
        if len(argv) < 2:
            raise ValueError("--device needs a value (cuda or cpu)")
        return argv[1], argv[2:]
    return "cuda", argv


def _device(name: str):
    """The torch device of a device command (phase lines
    `torch_imported`, `backend_ready`); None, with the reason on stderr,
    when there is no such device."""
    import torch

    phase("torch_imported")
    if name == "cuda" and not torch.cuda.is_available():
        print("cvsim_tpu_torch: no CUDA device; pass --device cpu to run "
              "the plain PyTorch path on the CPU", file=sys.stderr)
        return None
    device = torch.device(name)
    if device.type == "cuda" and os.environ.get("CVSIM_PHASES") == "1":
        # the stamp marks the first round trip; without phase lines the
        # command's own first copy makes it
        torch.zeros(1, device=device).cpu()
    phase("backend_ready")
    return device


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) >= 2 and argv[0] == "-via":
        # forward to a running `serve` (no torch in this process)
        from cvsim_tpu_torch.cli import serve

        return serve.run_via(argv[1], argv[2:])
    try:
        device_name, argv = _split_device(argv)
    except ValueError as e:
        print(f"cvsim_tpu_torch: {e}", file=sys.stderr)
        return 1
    if not argv or argv[0] in ("-h", "--help", "help"):
        print(USAGE, file=sys.stderr)
        return 0 if argv else 1
    if device_name not in ("cuda", "cpu"):
        print(f"cvsim_tpu_torch: unknown device '{device_name}'",
              file=sys.stderr)
        return 1
    cmd = argv[0]
    if cmd not in COMMANDS:
        print(f"cvsim_tpu_torch: unknown command '{cmd}'", file=sys.stderr)
        return 1
    # a server's commands each come through here and trace themselves
    # (CVSIM_PROFILE, CVSIM_TRACE)
    trace = profile_trace() if cmd != "serve" else contextlib.nullcontext()
    with trace:
        try:
            if cmd not in DEVICE_COMMANDS:
                return COMMANDS[cmd](argv[1:])
            phase("cli_entry")
            device = _device(device_name)
            if device is None:
                return 1
            return COMMANDS[cmd](argv[1:], device)
        except ValueError as e:
            print(f"cvsim_tpu_torch {cmd}: {e}", file=sys.stderr)
            return 1


if __name__ == "__main__":
    raise SystemExit(main())
