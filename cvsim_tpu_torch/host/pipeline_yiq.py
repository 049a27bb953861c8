"""Gen-2 (ffmpeg_ntsc) pipeline: RGB frames -> YIQ chain per field -> bobbed
progressive output (master loop, ffmpeg_ntsc.cpp:2146-2283). Twin of
cvsim_tpu.host.pipeline_yiq.

The host loop (`run_video`, `_emit`: field clock, multi-input layering,
-video-pts-in, checkpoint/resume) is the JAX package's, unchanged. Source
frames are scaled to uint8 RGB, and each GOP's field lines are copied
into one uint8 [gop, L, W, 3] staging buffer, made once and refilled every
GOP (`_stack`). On a CUDA pipeline the buffer is pinned, and the GOP goes
to the device in one asynchronous copy from it, through
models/yiq.composite_layer_rgb_auto and csrc/y4m_payload.cu (bob and
RGB->YUV), and comes back as the fields' Y4M frame payloads, which `_emit`
writes (host/payload.py); `-nocomp` makes the payloads from the buffer in
numpy and pins nothing. With
`-devices n` the GOP's fields split over an n-device mesh
(parallel.map_fields), each device running the same chain and payload
kernel on its block. Overlapping the copies with compute is later work.
"""

from __future__ import annotations

import sys
from fractions import Fraction

import numpy as np
import torch

from cvsim_tpu_torch.config import RunConfig
from cvsim_tpu_torch.host import payload, timing, y4m
# per-frame host scaling to uint8 dispatches to the native kernel (bit-exact
# twin of colorconv.scale_frame_to_np; numpy fallback inside hostpix)
from cvsim_tpu_torch.native.hostpix import scale_frame_to_u8 as _scale_frame_to
from cvsim_tpu_torch.host import resume
from cvsim_tpu_torch.interop import key32_from_seed
from cvsim_tpu_torch.models import yiq
from cvsim_tpu_torch.parallel import make_mesh, map_fields
from cvsim_tpu_torch.utils import log


class YIQPipeline:
    def __init__(self, cfg: RunConfig, frame_delay: int = 1, gop: int = 64,
                 die=None, progress: bool = True,
                 device: torch.device | str = "cuda", devices: int = 0):
        self.device = torch.device(device)
        # -devices n: an n-device mesh of the device's kind (fails loud if
        # fewer CUDA devices are visible); 0 runs on `device` alone
        self.mesh = (make_mesh(devices, kind=self.device.type)
                     if devices else None)
        if self.mesh is not None and gop % self.mesh.size:
            raise ValueError(f"mesh size {self.mesh.size} must divide the "
                             f"GOP batch {gop}")
        self.cfg = cfg
        self.gop = gop
        self.die = die or {"die": 0}
        self.progress = progress
        self.key = key32_from_seed(cfg.seed)
        self.frame_delay = frame_delay
        out = cfg.output
        self._field_rate = Fraction(out.field_rate_num, out.field_rate_den)
        self._ckpt_save = None   # set per run_video when -checkpoint is on
        self._stage = None       # the GOP staging buffer (_stack)

    def process_batch(self, rgb_fields: np.ndarray, fieldnos,
                      parities) -> np.ndarray:
        """uint8 [gop, L, W, 3] fields through the chain on the device (a
        batch that is not in pinned memory is pinned for its copy to a
        card); uint8 numpy [gop, frame_bytes] out, each row the Y4M payload
        of a field's bobbed frame (host/payload.py): made on the card, by
        one kernel, where the chain's output lies there, else in numpy."""
        out = self.cfg.output
        args = (out.height, out.use_422_colorspace)
        if not self.cfg.enable_composite_emulation:
            return payload.payloads_np(rgb_fields, *args)
        rgb = torch.from_numpy(rgb_fields)
        if self.device.type == "cuda" and not rgb.is_pinned():
            with log.span("gen2.pin"):
                rgb = log.pin(rgb)
        fn = torch.tensor(fieldnos, dtype=torch.int32)
        pa = torch.tensor(parities, dtype=torch.int32)
        if self.mesh is not None:
            # each device copies its block from the pinned batch and makes
            # its fields' payloads, which come back to the host
            cfg, key = self.cfg.composite, self.key
            return map_fields(
                self.mesh, lambda r, f, p: payload.payloads(
                    yiq.composite_layer_rgb_auto(r, f, p, key, cfg=cfg),
                    *args), rgb, fn, pa).numpy()
        dev = self.device
        rgb = log.to_device(rgb, dev, non_blocking=True)
        rgb = yiq.composite_layer_rgb_auto(rgb, log.to_device(fn, dev),
                                           log.to_device(pa, dev), self.key,
                                           cfg=self.cfg.composite)
        frames = payload.payloads(rgb, *args)
        # waits for the chain, the payloads and the copy
        with log.span("gen2.wait"):
            return log.to_host(frames).numpy()

    def _flush(self, batch, writer, gop: int, snapshot=None):
        """Run one GOP (the run's `gop`-th) and write its fields.
        `snapshot` is the resume cursor captured when `batch` was formed
        (host/checkpoint.py): it is saved only after that batch's fields
        are written, so a crash resumes exactly at the batch boundary the
        output file reached."""
        if not batch:
            return
        with log.span("gen2.flush", gop=gop):
            # pad short (final) batches to the GOP size
            padded = batch + [batch[-1]] * (self.gop - len(batch))
            out = self.process_batch(self._stack(batch),
                                     [b[1] for b in padded],
                                     [b[2] for b in padded])
            for k, b in enumerate(batch):
                self._emit(out[k], int(b[1]), writer)
            if snapshot is not None and self._ckpt_save is not None:
                with log.span("gen2.checkpoint"):
                    self._ckpt_save(snapshot, writer)

    def _stack(self, fields) -> np.ndarray:
        """The GOP's fields, the last one repeated up to the GOP size, in
        the staging buffer: uint8 [gop, L, W, 3], made at the first flush
        (so a warm-up pays for it) and refilled every GOP. On a CUDA
        pipeline with the chain on it is pinned, so process_batch copies
        from it asynchronously and pins nothing.

        Refilling it is safe because every GOP's H2D has completed when
        process_batch returns: it ends in a blocking copy back (`gen2.wait`;
        with -devices n, map_fields' copy back from every device), which
        waits for the chain, which waits for its H2D. A path that returned
        before its H2D completed would have to record an event there and
        wait on it here."""
        with log.span("gen2.stack"):
            if self._stage is None:
                shape = (self.gop, *fields[0][0].shape)
                if (self.device.type == "cuda"
                        and self.cfg.enable_composite_emulation):
                    self._stage = log.pin(
                        torch.empty(shape, dtype=torch.uint8)).numpy()
                else:
                    self._stage = np.empty(shape, np.uint8)
            stage = self._stage
            for k, f in enumerate(fields):
                stage[k] = f[0]
            stage[len(fields):] = stage[len(fields) - 1]
            return stage

    def _emit(self, frame, fieldno, writer):
        """Write one field's bobbed frame: its payload row from
        process_batch."""
        out = self.cfg.output
        with log.span("gen2.emit"):
            with log.span("gen2.emit.convert"):
                y, u, v = payload.planes(frame, out.height, out.width,
                                         out.use_422_colorspace)
            with log.span("gen2.emit.write"):
                writer.write(y, u, v)
            if self.progress:
                print(f"\x0dOutput field {fieldno} ", end="",
                      file=sys.stderr)

    def run_video(self, readers: list, out_stream,
                  ckpt_path: str | None = None, ckpt_every: int = 4,
                  frame_log=None, frame_log_rate: int = 90000,
                  _fail_after_gops: int | None = None):
        """Drive the multi-input field loop through the batched chain.

        ckpt_path enables checkpoint/resume (host/checkpoint.py, same
        contract as CompositePipeline.run_video): a resume cursor
        {next_field, frames_written, per-reader consumed/eof/next_at} is
        saved every `ckpt_every` GOPs after the GOP's fields are durably
        written — the gen-2 chain carries no cross-field device state, so
        the cursor alone makes resume byte-identical (content-addressed
        noise + pure-function field clock).

        frame_log/frame_log_rate (-video-pts-in) drive a timing.FrameClock
        for the FIRST input: VFR/telecine sources render each frame for its
        own duration (3:2 pulldown cadence etc.); additional inputs keep
        their container CFR cadence. _fail_after_gops is a test hook that
        injects a crash after N GOPs are written."""
        from cvsim_tpu_torch.host import checkpoint

        cfg = self.cfg
        out = cfg.output
        whdr = y4m.Y4MHeader(
            width=out.width, height=out.height, fps=self._field_rate,
            interlacing="p", aspect="4:3",
            colorspace="422" if out.use_422_colorspace else "420jpeg")

        iters = [iter(r) for r in readers]
        fps = [r.header.fps for r in readers]
        frames = [None] * len(readers)      # current scaled RGB frame
        next_at = [0] * len(readers)        # field index when next frame due
        frame_idx = [0] * len(readers)
        eof = [False] * len(readers)
        clock = timing.FrameClock(fps[0], self._field_rate,
                                  log=frame_log or None,
                                  log_rate=frame_log_rate)

        def due_field(k: int) -> int:
            # field index at which reader k's NEXT frame (frame_idx[k])
            # becomes current; input 0 rides the FrameClock (CFR mode is
            # identical to frame_pts_to_field by construction)
            if k == 0:
                return clock.fields(frame_idx[0], 0)[0]
            return timing.frame_pts_to_field(frame_idx[k], fps[k],
                                             self._field_rate)

        run_hash = checkpoint.config_hash(
            cfg, [r.header for r in readers], self.gop, self.frame_delay,
            (frame_log, frame_log_rate) if frame_log else None)
        resume_field = 0
        frames_written = 0
        if ckpt_path:
            loaded = checkpoint.load(ckpt_path)
            if loaded and loaded[0].get("hash") == run_hash:
                meta, _ = loaded
                resume_field = int(meta["next_field"])
                frames_written = int(meta["frames_written"])
                frame_idx = [int(n) for n in meta["consumed"]]
                next_at = [int(n) for n in meta["next_at"]]
                eof = [bool(e) for e in meta["eof"]]
                if self.progress:
                    print(f"Resuming at field {resume_field} "
                          f"({frames_written} frames already written)",
                          file=sys.stderr)
            elif loaded:
                print("Checkpoint exists but flags/input changed; "
                      "starting over", file=sys.stderr)

        if resume_field:
            hdr_line = whdr.header_line()
            fsize = 6 + whdr.frame_bytes()   # b"FRAME\n" + payload
            end = len(hdr_line) + frames_written * fsize
            resume.check_output_size(out_stream, end)
            out_stream.seek(0)
            if out_stream.read(len(hdr_line)) != hdr_line:
                raise ValueError(
                    "resume: existing output header does not match")
            out_stream.seek(end)
            out_stream.truncate()
            writer = y4m.Y4MWriter(out_stream, whdr, write_header=False)
            writer.frames_written = frames_written
            # re-materialize each reader's CURRENT frame: skip the consumed
            # prefix, read+scale the last consumed frame
            for k in range(len(readers)):
                if frame_idx[k] <= 0:
                    continue
                checkpoint.skip_y4m_frames(readers[k], frame_idx[k] - 1)
                try:
                    yf, uf, vf = next(iters[k])
                except StopIteration:
                    raise EOFError("resume: input shorter than checkpoint")
                if uf is None:
                    uf = np.full((yf.shape[0], yf.shape[1]), 128, np.uint8)
                    vf = uf
                frames[k] = _scale_frame_to(yf, uf, vf, out.width,
                                            out.height)
        else:
            try:
                # a reused output stream (resume attempted, hash mismatch)
                # must restart from zero bytes; pipes reject this harmlessly
                out_stream.seek(0)
                out_stream.truncate()
            except (OSError, AttributeError, ValueError):
                pass
            writer = y4m.Y4MWriter(out_stream, whdr)

        wrote = {"gops": 0}

        def ckpt_save(snapshot, wr):
            wrote["gops"] += 1
            if wrote["gops"] % ckpt_every == 0:
                resume.sync_output(out_stream)
                checkpoint.save(ckpt_path, dict(
                    snapshot, hash=run_hash,
                    cfg_hash=checkpoint.config_hash(cfg),
                    frames_written=wr.frames_written), {})
            if (_fail_after_gops is not None
                    and wrote["gops"] >= _fail_after_gops):
                raise RuntimeError("injected checkpoint-test crash")

        self._ckpt_save = ckpt_save if ckpt_path else None

        # -ss/-se/-t extension (the gen-2 reference has no transcode window;
        # gen-1 semantics, pipeline.py read_loop: skip until start, rebase
        # the field clock to zero at the first accepted field, stop at end).
        rate = float(self._field_rate)
        start_f = (int(np.ceil(cfg.transcode_start * rate))
                   if cfg.transcode_start > 0 else 0)
        end_f = (int(np.ceil(cfg.transcode_end * rate))
                 if cfg.transcode_end >= 0 else None)

        def snapshot():
            return {"next_field": current, "consumed": list(frame_idx),
                    "next_at": list(next_at), "eof": list(eof)}

        current = resume_field
        batch = []
        gops = 0        # GOPs flushed: the span unit of this run's work
        while True:
            if self.die["die"]:
                break
            if end_f is not None and current >= end_f:
                break
            # advance inputs whose next frame is due
            for k in range(len(readers)):
                while not eof[k] and next_at[k] <= current:
                    with log.span("gen2.read", gop=gops):
                        try:
                            yf, uf, vf = next(iters[k])
                        except StopIteration:
                            eof[k] = True
                            break
                        if uf is None:
                            uf = np.full((yf.shape[0], yf.shape[1]), 128,
                                         np.uint8)
                            vf = uf
                        frames[k] = _scale_frame_to(yf, uf, vf, out.width,
                                                    out.height)
                    frame_idx[k] += 1
                    next_at[k] = due_field(k)
            if all(eof) and all(next_at[k] <= current for k in range(len(readers))):
                break
            # last input with a frame wins (see the JAX twin's docstring)
            src = None
            for k in reversed(range(len(readers))):
                if frames[k] is not None:
                    src = frames[k]
                    break
            if src is None or current < start_f:
                current += 1
                continue
            vf = current - start_f     # rebased output field counter
            parity = (vf & 1) ^ 1
            field_rgb = src[parity::2]
            batch.append((field_rgb, vf, parity))
            current += 1
            if len(batch) >= self.gop:
                snap = snapshot()
                self._flush(batch, writer, gops, snapshot=snap)
                gops += 1
                batch = []
            if all(eof):
                # drain remaining scheduled fields up to the last frame's due
                if current >= max(next_at):
                    break
        self._flush(batch, writer, gops,
                    snapshot=snapshot() if batch else None)
        self._ckpt_save = None
        if ckpt_path and not self.die["die"]:
            checkpoint.clear(ckpt_path)
        if self.progress:
            print("", file=sys.stderr)
        return max(0, current - start_f)
