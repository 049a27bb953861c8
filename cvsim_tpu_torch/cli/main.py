"""cvsim_tpu_torch command line: `python -m cvsim_tpu_torch [--device
cuda|cpu] ntsc|to-composite <flags>`.

The twin of cvsim_tpu.cli.main's `ntsc` tool (the gen-2 engine) and of its
`to-composite` tool (the gen-1 engine, video side). Flags are the
reference's, parsed by cvsim_tpu.presets as in the JAX package. The
device defaults to cuda; without a GPU the command fails unless
`--device cpu` is given, and it never carries on on the CPU quietly.
`-devices n` splits each GOP's fields over n devices of that kind: n GPUs
(fewer visible is an error), or n shards on the CPU. Not yet ported:
audio (-audio-in) and the other tools.
"""

from __future__ import annotations

import os
import signal
import sys

import torch

from cvsim_tpu_torch import presets

USAGE = ("usage: python -m cvsim_tpu_torch [--device cuda|cpu] "
         "ntsc|to-composite -i in.y4m -o out.y4m [flags]")


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


def cmd_ntsc(argv, device: torch.device):
    """Gen-2 YIQ engine tool (ffmpeg_ntsc)."""
    from cvsim_tpu_torch.host import ffmpeg_pipe
    from cvsim_tpu_torch.host.pipeline_yiq import YIQPipeline

    st = presets.parse_composite_flags(argv, gen2=True)
    if st.audio_in:
        raise ValueError("-audio-in: audio is not yet ported to "
                         "cvsim_tpu_torch")
    if not st.output_file:
        print("No output file specified", file=sys.stderr)
        return 1
    die = _soft_sigint()
    cfg = st.to_run_config(gen1=False)
    ckpt_path, resuming = _checkpoint_path(st, cfg)
    pipe = YIQPipeline(cfg, frame_delay=st.frame_delay, die=die,
                       device=device, devices=st.devices)
    fields = 0
    if st.input_files and st.video_stream_index >= 0:
        readers, cleanups = [], []
        for path in st.input_files:
            r, c = ffmpeg_pipe.resolve_video_input(path)
            readers.append(r)
            cleanups.append(c)
        if resuming:
            out_stream = open(st.output_file, "r+b")
            finalize = out_stream.close
        else:
            out_stream, finalize = ffmpeg_pipe.resolve_video_output(
                st.output_file)
        frame_log, log_rate = None, 90000
        if st.video_pts_in:
            from cvsim_tpu_torch.host import timing as _timing

            frame_log, log_rate = _timing.read_frame_pts_log(st.video_pts_in)
        try:
            fields = pipe.run_video(readers, out_stream,
                                    ckpt_path=ckpt_path,
                                    frame_log=frame_log,
                                    frame_log_rate=log_rate)
        except BaseException:
            try:
                finalize()   # never mask the root cause
            except Exception:
                pass
            raise
        else:
            finalize()
        finally:
            for c in cleanups:
                c()
    print(f"\n{fields} fields", file=sys.stderr)
    return 0


def cmd_to_composite(argv, device: torch.device):
    """Flagship gen-1 tool (ffmpeg_to_composite), video side."""
    st = presets.parse_composite_flags(argv, gen2=False)
    if ((not st.input_files and not st.audio_in)
            or (st.input_files and not st.output_file)):
        print("You must specify an input and output file (-i and -o).",
              file=sys.stderr)
        return 1
    if st.audio_in:
        raise ValueError("-audio-in: audio is not yet ported to "
                         "cvsim_tpu_torch")
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
    if st.video_stream_index < 0:
        return 0
    reader, rclean = ffmpeg_pipe.resolve_video_input(st.input_files[0])
    if resuming:
        out_stream = open(st.output_file, "r+b")
        finalize = out_stream.close
    else:
        out_stream, finalize = ffmpeg_pipe.resolve_video_output(
            st.output_file, interlaced=cfg.output.interlaced_output)
    frame_log, log_rate = None, 90000
    if st.video_pts_in:
        from cvsim_tpu_torch.host import timing as _timing

        frame_log, log_rate = _timing.read_frame_pts_log(st.video_pts_in)
    try:
        pipe.run_video(reader, out_stream, ckpt_path=ckpt_path,
                       frame_log=frame_log, frame_log_rate=log_rate)
    except BaseException:
        try:
            finalize()   # never mask the root cause
        except Exception:
            pass
        raise
    else:
        finalize()
    finally:
        rclean()
    return 0


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


COMMANDS = {"ntsc": cmd_ntsc, "to-composite": cmd_to_composite}


def _split_device(argv):
    """(device name, rest) from a leading `--device X`."""
    if argv and argv[0] == "--device":
        if len(argv) < 2:
            raise ValueError("--device needs a value (cuda or cpu)")
        return argv[1], argv[2:]
    return "cuda", argv


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
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
    if device_name == "cuda" and not torch.cuda.is_available():
        print("cvsim_tpu_torch: no CUDA device; pass --device cpu to run "
              "the plain PyTorch path on the CPU", file=sys.stderr)
        return 1
    cmd = argv[0]
    if cmd not in COMMANDS:
        print(f"cvsim_tpu_torch: '{cmd}' is not ported yet (ported: "
              f"{', '.join(COMMANDS)})", file=sys.stderr)
        return 1
    try:
        return COMMANDS[cmd](argv[1:], torch.device(device_name))
    except ValueError as e:
        print(f"cvsim_tpu_torch {cmd}: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    raise SystemExit(main())
