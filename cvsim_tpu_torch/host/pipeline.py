"""Gen-1 streaming pipeline: demux -> field clock -> one device step per GOP
-> pack -> mux (ffmpeg_to_composite.cpp main :1957-2340). Twin of the
video side of cvsim_tpu.host.pipeline.

Three threads, as in the JAX package:

- **reader**: Y4M demux, field-clock targeting and GOP batch assembly
  (host/batching.py): raw uint8 frames plus row-gather codes. On a GPU it
  also copies each GOP's flat buffer into its own pinned host tensor.
- **main**: per GOP, the asynchronous H2D copy and `gop_step` on the
  device: unpack the flat wire buffer, horizontal scale, the 8-bit field
  render, the sequential black-key scan (its filter planes carried across
  GOPs), the chain (models/yuv422.composite_video_process_auto), the
  uint8 pack; then an asynchronous D2H copy and an event.
- **writer**: waits for the event, packs bob/interlaced frames with numpy
  row gathers, writes Y4M, saves checkpoints.

With `-devices n` the chain's field batch splits over an n-device mesh
(parallel.map_fields), with kernel #5 on each device; the rest of the GOP
step stays on the primary device, because the black-key scan carries
sequential state from field to field.

Audio (`run_audio`, -audio-in) is decoded whole on the host, gap-filled
on the packet log, resampled and remixed there (numpy, copied from the
JAX package), then runs through audio/chains.py on the device in
1M-sample chunks with a carried state.
"""

from __future__ import annotations

import io
import os
import queue
import sys
import tempfile
import threading
from fractions import Fraction

import numpy as np
import torch

from cvsim_tpu_torch.audio import (
    buzz_pulse_counts,
    composite_audio_process,
    init_audio_state,
)
from cvsim_tpu_torch.config import RunConfig
from cvsim_tpu_torch.host import fieldops, timing, wavio, y4m
from cvsim_tpu_torch.host.batching import (
    FieldBatcher,
    hscale_consts,
    render_index_tables,
)
from cvsim_tpu_torch.host import resume
from cvsim_tpu_torch.interop import key32_from_seed
from cvsim_tpu_torch.models import yuv422
from cvsim_tpu_torch.parallel import make_mesh, map_fields
from cvsim_tpu_torch.utils import log


def _interleave_np(top: np.ndarray, bottom: np.ndarray) -> np.ndarray:
    out = np.empty((top.shape[0] * 2, top.shape[1]), top.dtype)
    out[0::2] = top
    out[1::2] = bottom
    return out


def _bkey_scan(y, u, v, fy, fu, fv, level: int, valid):
    """Sequential black-key feedback over the batch axis. `valid` (host
    ints, one per field) freezes the carried filter planes on padded batch
    slots: padding repeats the last real field, and letting duplicates
    advance the frame-sequential feedback would corrupt every later field
    and the checkpointed carry."""
    oy, ou, ov = [], [], []
    for k in range(y.shape[0]):
        (py, pu, pv), new = yuv422.black_key_feedback(
            y[k], u[k], v[k], fy, fu, fv, level)
        if valid[k]:
            fy, fu, fv = new
        oy.append(py)
        ou.append(pu)
        ov.append(pv)
    return (torch.stack(oy), torch.stack(ou), torch.stack(ov)), (fy, fu, fv)


class CompositePipeline:
    """Gen-1 flagship pipeline (ffmpeg_to_composite equivalent), video
    side."""

    def __init__(self, cfg: RunConfig, gop: int = 64, progress: bool = True,
                 die=None, device: torch.device | str = "cuda",
                 devices: int = 0):
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
        out = cfg.output
        self._field_rate = Fraction(out.field_rate_num, out.field_rate_den)
        l = out.height // 2
        w2 = out.width // 2
        full = lambda shape, v: torch.full(shape, v, dtype=torch.int32,
                                           device=self.device)
        self._filter_planes = (full((l, out.width), 16), full((l, w2), 128),
                               full((l, w2), 128))
        self._programs = {}
        self._bob_map_cache = {}

    # ----------------------------------------------------------- device step

    def _gop_program(self, src_h: int, src_w: int, chroma_h: int,
                     chroma_w: int, src_interlaced: bool, src_tff: bool):
        """The device step for one source geometry: flat-buffer unpack +
        hscale + field render + black-key + chain + uint8 pack. Inputs are
        the GOP's two wire arrays (pix uint8, meta int32, on the device),
        the host `valid` flags and the carried filter planes."""
        cache_key = (src_h, src_w, chroma_h, chroma_w, src_interlaced,
                     src_tff)
        prog = self._programs.get(cache_key)
        if prog is not None:
            return prog
        cfg = self.cfg
        out = cfg.output
        ccfg = cfg.composite
        bkey = cfg.black_key_level_feedback
        gop = self.gop
        dev = self.device
        max_frames = gop // 2 + 2
        t = lambda a: log.to_device(torch.from_numpy(np.ascontiguousarray(a)),
                                    dev)

        def consts(src, dst):
            c = hscale_consts(src, dst)
            return None if c is None else tuple(t(a) for a in c)

        luma_consts = consts(src_w, out.width)
        chroma_consts = consts(chroma_w, out.width // 2)
        # [4, L] row/frac tables for every (parity, interlace-flip) code;
        # rows past the source's last line (read with frac 0) are clamped
        # to it, as jax's gather clamps them
        yt1, yt2, ytf, ct1, ct2, ctf = render_index_tables(
            out.height, src_h, chroma_h, src_interlaced, src_tff)
        yt1, yt2 = (t(np.clip(a, 0, src_h - 1)).long() for a in (yt1, yt2))
        ct1, ct2 = (t(np.clip(a, 0, chroma_h - 1)).long() for a in (ct1, ct2))
        ytf, ctf = t(ytf), t(ctf)
        ny = max_frames * src_h * src_w
        nu = max_frames * chroma_h * chroma_w

        def hscale(p, c):
            # bit-identical to colorconv.hscale_bilinear_np: f32 lerp,
            # round half to even, clamp to 0..255 (an upscale's first
            # samples extrapolate)
            p = p.to(torch.int32)
            if c is None:
                return p
            x0, x1, f = c
            pf = p.to(torch.float32)
            s0 = pf[..., x0]
            s1 = pf[..., x1]
            return torch.round(s0 + (s1 - s0) * f).clamp(0, 255).to(
                torch.int32)

        def gop_step(pix, meta, valid, filter_planes):
            fy = pix[:ny].view(max_frames, src_h, src_w)
            fu = pix[ny:ny + nu].view(max_frames, chroma_h, chroma_w)
            fv = pix[ny + nu:ny + 2 * nu].view(max_frames, chroma_h, chroma_w)
            src_idx = meta[:gop].long()
            code = meta[gop:2 * gop].long()
            fieldno = meta[2 * gop:3 * gop]
            parity = meta[3 * gop:4 * gop]

            sy = hscale(fy, luma_consts)
            su = hscale(fu, chroma_consts)
            sv = hscale(fv, chroma_consts)

            def render(p, t1, t2, tf):
                # d = s1 + ((s2 - s1) * frac >> 8), render_field's 8-bit
                # interpolation (ffmpeg_to_composite.cpp:1098-1099)
                s1 = p[src_idx[:, None], t1[code]]
                s2 = p[src_idx[:, None], t2[code]]
                fr = tf[code]
                return s1 + (((s2 - s1) * fr[..., None]) >> 8)

            y = render(sy, yt1, yt2, ytf)
            u = render(su, ct1, ct2, ctf)
            v = render(sv, ct1, ct2, ctf)
            if bkey >= 0:
                (y, u, v), filter_planes = _bkey_scan(
                    y, u, v, *filter_planes, bkey, valid)
            if cfg.enable_composite_emulation:
                def chain(y_, u_, v_, fn_, pa_):
                    return yuv422.composite_video_process_auto(
                        y_, u_, v_, fn_, pa_, self.key, cfg=ccfg)

                if self.mesh is not None:
                    # the chain's fields split over the mesh; the results
                    # come back to this device
                    y, u, v = map_fields(self.mesh, chain, y, u, v, fieldno,
                                         parity)
                else:
                    y, u, v = chain(y, u, v, fieldno, parity)
            packed = torch.cat([p.to(torch.uint8) for p in (y, u, v)], dim=2)
            return packed, filter_planes

        self._programs[cache_key] = gop_step
        return gop_step

    def _dummy_batch(self, src_h: int, src_w: int, chroma_h: int,
                     chroma_w: int):
        """One all-zeros GOP with the real wire layout (for priming)."""
        b = FieldBatcher(gop=self.gop, src_height=src_h,
                         chroma_height=chroma_h, luma_w=src_w,
                         chroma_w=chroma_w)
        z = np.zeros((src_h, src_w), np.uint8)
        zc = np.zeros((chroma_h, chroma_w), np.uint8)
        fld, batch = 0, None
        while batch is None:
            b.add_frame(z, zc, zc)
            for _ in range(2):
                r = b.add_field(fld, (fld & 1) ^ 1, 0)
                if r is not None:
                    batch = r
                fld += 1
        return batch

    def prime(self, src_h: int, src_w: int, chroma_h: int, chroma_w: int,
              src_interlaced: bool = False, src_tff: bool = True):
        """Run the GOP step once on a dummy GOP of this source geometry on
        the pipeline's device and wait for it: the kernels are built or
        loaded, the CUDA context and the allocator warmed, before the
        first real GOP. The carried black-key planes are left as they
        were. Unlike the JAX package's best-effort priming, a failure
        raises: a kernel that cannot build or launch must not pass
        unseen."""
        gop_step = self._gop_program(src_h, src_w, chroma_h, chroma_w,
                                     src_interlaced, src_tff)
        b = self._dummy_batch(src_h, src_w, chroma_h, chroma_w)
        gop = self.gop
        packed, _ = gop_step(log.to_device(torch.from_numpy(b.pix),
                                           self.device),
                             log.to_device(torch.from_numpy(b.meta),
                                           self.device),
                             b.meta[4 * gop:5 * gop].tolist(),
                             self._filter_planes)
        log.to_host(packed)

    # ------------------------------------------------------------- emit side

    def _bob_maps(self, parity: int):
        """Field-line gather maps for bob packing: output row j of the bob
        frame reads field line map[j] (output_frame, :1178-1235)."""
        maps = self._bob_map_cache.get(parity)
        if maps is None:
            h = self.cfg.output.height
            rows = fieldops.bob_rows(h, parity)
            luma = ((rows - parity) >> 1).astype(np.int64)
            chroma = ((rows[0::2] - parity) >> 1).astype(np.int64)
            maps = (luma, chroma)
            self._bob_map_cache[parity] = maps
        return maps

    def _emit_field(self, y, u, v, fieldno, parity, writer, pending):
        """Pack one processed uint8 field into the output stream (numpy row
        gathers only)."""
        out = self.cfg.output
        if out.interlaced_output:
            pending[parity] = (y, u, v)
            if parity == 0 and 1 in pending and 0 in pending:
                # field pair complete: bottom field first (parity of field k
                # is (k & 1) ^ 1, so even field counters are bottom lines)
                top, bottom = pending[0], pending[1]
                fy = _interleave_np(top[0], bottom[0])
                fu = _interleave_np(top[1], bottom[1])
                fv = _interleave_np(top[2], bottom[2])
                self._write_frame(writer, fy, fu, fv)
                pending.clear()
        else:
            luma_map, chroma_map = self._bob_maps(parity)
            if out.use_422_colorspace:
                writer.write(y[luma_map], u[luma_map], v[luma_map])
            else:
                writer.write(y[luma_map], u[chroma_map], v[chroma_map])
        if self.progress:
            print(f"\x0dOutput field {fieldno} ", end="", file=sys.stderr)

    def _write_frame(self, writer, y, u, v):
        if self.cfg.output.use_422_colorspace:
            writer.write(y.astype(np.uint8), u.astype(np.uint8),
                         v.astype(np.uint8))
        elif self.cfg.output.interlaced_output:
            # interlaced 4:2:0 chroma interleaves the two fields' chroma rows
            # (output_frame, ffmpeg_to_composite.cpp:1215-1224)
            h = y.shape[0]
            sel = np.arange(h)[(np.arange(h) & 2) == 0]
            cy = (sel & 1) + ((sel & ~3) >> 1)
            cu = np.zeros((h // 2, u.shape[1]), u.dtype)
            cv = np.zeros((h // 2, v.shape[1]), v.dtype)
            cu[cy] = u[sel]
            cv[cy] = v[sel]
            writer.write(y.astype(np.uint8), cu.astype(np.uint8),
                         cv.astype(np.uint8))
        else:
            writer.write(y.astype(np.uint8),
                         u[0::2].astype(np.uint8), v[0::2].astype(np.uint8))

    # ------------------------------------------------------------ video side

    def run_video(self, reader: y4m.Y4MReader, out_stream,
                  ckpt_path: str | None = None, ckpt_every: int = 4,
                  frame_log=None, frame_log_rate: int = 90000,
                  _fail_after_gops: int | None = None):
        """Drive video frames from a Y4M reader through the chain with
        reader / device / writer work overlapped in threads.

        ckpt_path enables checkpoint/resume (host/checkpoint.py, the JAX
        package's contract and file format): the writer thread saves a
        resumable cursor plus the black-key carry every `ckpt_every` GOPs,
        and a matching existing checkpoint resumes the run (output
        truncated to the recorded frame boundary, reader moved past the
        consumed source frames). _fail_after_gops is a test hook that
        injects a crash after N GOPs are written."""
        from cvsim_tpu_torch.host import checkpoint

        cfg = self.cfg
        out = cfg.output
        dev = self.device
        on_gpu = dev.type == "cuda"
        hdr = reader.header
        src_interlaced = hdr.interlacing in ("t", "b")
        src_tff = hdr.interlacing != "b"

        clock = timing.FrameClock(hdr.fps, self._field_rate,
                                  log=frame_log or None,
                                  log_rate=frame_log_rate)
        # In-band VFR: a FRAME marker may carry the container's (pts,
        # duration) at 90 kHz ("Xt=p:d", y4m.Y4MReader.frame_params).
        # Disabled under checkpointing: a resumed run cannot recover the
        # skipped frames' timestamps.
        use_inband_ts = frame_log is None and ckpt_path is None

        def push_inband_ts(params):
            xt = params.get("Xt")
            if xt is None:
                return
            p, _, d = xt.partition(":")
            dur = max(1, int(d))
            if clock.log is None:
                clock.log = []
            if p in ("n", "-1"):   # no container pts: extend by cadence
                pts = (clock.log[-1][0] + clock.log[-1][1]
                       if clock.log else 0)
            else:
                pts = int(p)
            clock.log.append((pts, dur))

        out_fps = (self._field_rate / 2 if out.interlaced_output
                   else self._field_rate)
        whdr = y4m.Y4MHeader(
            width=out.width, height=out.height, fps=out_fps,
            # bottom field first: field k's parity is (k & 1) ^ 1
            interlacing=("b" if out.interlaced_output else "p"),
            aspect="4:3",
            colorspace="422" if out.use_422_colorspace else "420jpeg")

        run_hash = checkpoint.config_hash(
            cfg, hdr, self.gop,
            (frame_log, frame_log_rate) if frame_log else None)
        resume_field = 0
        frames_written = 0
        ckpt_base_idx = None
        if ckpt_path:
            loaded = checkpoint.load(ckpt_path)
            if loaded and loaded[0].get("hash") == run_hash:
                meta, arrs = loaded
                resume_field = int(meta["next_field"])
                frames_written = int(meta["frames_written"])
                ckpt_base_idx = meta["base_idx"]
                self._filter_planes = tuple(
                    torch.from_numpy(np.asarray(arrs[k], np.int32)).to(dev)
                    for k in ("fy", "fu", "fv"))
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
            # skip source frames that only feed fields < resume_field
            base0 = ckpt_base_idx or 0
            rel0 = 0
            while clock.fields(base0 + rel0, base0)[1] <= resume_field:
                rel0 += 1
            skip_n = base0 + rel0
            checkpoint.skip_y4m_frames(reader, skip_n)
        else:
            try:
                # a reused output stream (resume attempted, hash mismatch)
                # must restart from zero bytes; pipes reject this harmlessly
                out_stream.seek(0)
                out_stream.truncate()
            except (OSError, io.UnsupportedOperation, AttributeError):
                pass
            writer = y4m.Y4MWriter(out_stream, whdr)
            skip_n = 0

        ch, cw = hdr.chroma_shape
        chroma_h = ch or hdr.height
        chroma_w = cw or hdr.width // 2
        gop_step = self._gop_program(hdr.height, hdr.width, chroma_h,
                                     chroma_w, src_interlaced, src_tff)
        batcher = FieldBatcher(
            gop=self.gop, src_height=hdr.height, chroma_height=chroma_h,
            luma_w=hdr.width, chroma_w=chroma_w)

        q_in: queue.Queue = queue.Queue(maxsize=2)
        q_out: queue.Queue = queue.Queue(maxsize=2)
        errors: list[BaseException] = []
        fields_done = {"n": 0}
        base_idx_box = {"v": ckpt_base_idx}
        log.phase("run_video_start")

        def put_batch(b):
            # each GOP gets its own pinned host tensor, so that a refill
            # can never race an asynchronous H2D copy still reading it
            b.pix = torch.from_numpy(b.pix)
            b.meta = torch.from_numpy(b.meta)
            if on_gpu:
                with log.span("gen1.pin", gop=b.gop):
                    b.pix = log.pin(b.pix)
                    b.meta = log.pin(b.meta)
            with log.span("gen1.put.wait", gop=b.gop):
                q_in.put(b)

        def read_loop():
            video_field = resume_field
            # the first accepted frame rebases the clock to zero (the
            # reference's adj_time, :2264-2265)
            base_idx = ckpt_base_idx if resume_field else None
            frames = enumerate(reader)
            try:
                while True:
                    # one source frame: its demux, and its fields into the
                    # GOP being formed (packing it when it fills)
                    with log.span("gen1.read", gop=batcher.formed):
                        nxt = next(frames, None)
                        if nxt is None:
                            break
                        local_idx, (ysrc, usrc, vsrc) = nxt
                        if self.die["die"]:
                            # soft stop: finish queued batches, write the
                            # trailer (reference soft-SIGINT,
                            # :62-66,2120-2124)
                            break
                        if use_inband_ts:
                            push_inband_ts(reader.frame_params)
                        frame_idx = local_idx + skip_n
                        t = clock.seconds(frame_idx)
                        if (cfg.transcode_end >= 0
                                and t >= cfg.transcode_end):
                            break
                        if t < cfg.transcode_start:
                            continue
                        if base_idx is None:
                            base_idx = frame_idx
                            base_idx_box["v"] = base_idx
                        frame_pts, tgt = clock.fields(frame_idx, base_idx)
                        tgt = timing.video_target_field(tgt, video_field)
                        batcher.add_frame(ysrc, usrc, vsrc)
                        while video_field < tgt:
                            # bottom field first (:1784)
                            parity = (video_field & 1) ^ 1
                            b = batcher.add_field(
                                video_field, parity,
                                max(0, video_field - frame_pts))
                            if b is not None:
                                put_batch(b)
                            video_field += 1
                b = batcher.finish()
                if b is not None:
                    put_batch(b)
                fields_done["n"] = video_field
            except BaseException as e:   # propagate to the main thread
                errors.append(e)
            finally:
                q_in.put(None)

        pending: dict = {}
        w = out.width
        wc = w // 2
        wrote = {"gops": 0}

        def write_loop():
            first_fetch = True
            try:
                while True:
                    # the GOPs arrive in order: the next is the
                    # wrote["gops"]-th
                    with log.span("gen1.fetch.wait", gop=wrote["gops"]):
                        item = q_out.get()
                        if item is not None and item[1] is not None:
                            item[1].synchronize()
                            log.count("syncs")
                    if item is None:
                        return
                    packed, _, fieldnos, parities, n_real, planes = item
                    buf = packed.numpy()
                    if first_fetch:
                        first_fetch = False
                        log.phase("first_fetch_done", fields=n_real)
                    for k in range(n_real):
                        row = buf[k]
                        with log.span("gen1.emit", gop=wrote["gops"]):
                            self._emit_field(
                                row[:, :w], row[:, w:w + wc],
                                row[:, w + wc:], int(fieldnos[k]),
                                int(parities[k]), writer, pending)
                    wrote["gops"] += 1
                    if (ckpt_path and not pending
                            and wrote["gops"] % ckpt_every == 0):
                        with log.span("gen1.checkpoint",
                                      gop=wrote["gops"] - 1):
                            resume.sync_output(out_stream)
                            fy, fu, fv = (p.numpy() for p in planes)
                            checkpoint.save(
                                ckpt_path,
                                {"hash": run_hash,
                                 "cfg_hash": checkpoint.config_hash(cfg),
                                 "next_field": int(fieldnos[n_real - 1]) + 1,
                                 "frames_written": writer.frames_written,
                                 "base_idx": base_idx_box["v"]},
                                {"fy": fy, "fu": fu, "fv": fv})
                    if (_fail_after_gops is not None
                            and wrote["gops"] >= _fail_after_gops):
                        raise RuntimeError("injected checkpoint-test crash")
            except BaseException as e:
                errors.append(e)
                while q_out.get() is not None:   # drain; main never blocks
                    pass

        rt = threading.Thread(target=read_loop, name="cvsim-read", daemon=True)
        wt = threading.Thread(target=write_loop, name="cvsim-write", daemon=True)
        rt.start()
        wt.start()
        first_dispatch = True
        stepped = 0     # GOPs taken: the batches arrive in order
        try:
            while True:
                with log.span("gen1.get.wait", gop=stepped):
                    b = q_in.get()
                if b is None:
                    break
                stepped += 1
                if first_dispatch:
                    first_dispatch = False
                    log.phase("first_dispatch")
                gop = self.gop
                valid = b.meta[4 * gop:5 * gop].tolist()
                with log.span("gen1.h2d", gop=b.gop):
                    pix = log.to_device(b.pix, dev, non_blocking=True)
                    meta = log.to_device(b.meta, dev, non_blocking=True)
                # noise is content-addressed per (seed, fieldno, stage): the
                # base key passes straight through, so output is GOP- and
                # restart-invariant
                with log.span("gen1.step", gop=b.gop):
                    packed, self._filter_planes = gop_step(
                        pix, meta, valid, self._filter_planes)
                done = None
                if on_gpu:
                    with log.span("gen1.d2h", gop=b.gop):
                        # D2H into pinned memory; the writer waits on `done`
                        packed = log.to_host(packed, non_blocking=True)
                        planes = tuple(log.to_host(p, non_blocking=True)
                                       for p in self._filter_planes)
                        done = torch.cuda.Event()
                        done.record()
                else:
                    planes = self._filter_planes
                with log.span("gen1.out.wait", gop=b.gop):
                    q_out.put((packed, done, b.fieldno, b.parity, b.n_real,
                               planes))
        finally:
            # always unwind the threads, also when gop_step raised: the
            # writer needs its sentinel, and the reader may be blocked on a
            # full q_in; drain until it exits so no thread outlives us
            q_out.put(None)
            while rt.is_alive():
                try:
                    while True:
                        q_in.get_nowait()
                except queue.Empty:
                    pass
                rt.join(timeout=0.1)
            wt.join()
        if errors:
            raise errors[0]
        if ckpt_path:
            checkpoint.clear(ckpt_path)
        log.phase("run_video_done", fields=fields_done["n"])
        if self.progress:
            print("", file=sys.stderr)
        return fields_done["n"]

    # ----------------------------------------------------------- audio side

    def run_audio(self, in_path: str, out_path: str, chunk: int = 1 << 20,
                  pts_packets=None):
        """Audio file in, processed WAV out; returns the sample count.

        The whole stream is decoded up front, so the chunk size only sets
        the device step: chunks run one after another through the carried
        AudioState with one hiss key for the stream (chunked == whole:
        tests/test_torch_audio.py). A container input without a packet log
        gets the demuxer's own (cvsim-av -audio-pkt-log), so PTS gaps are
        silence-filled on the A/V master clock (ffmpeg_to_composite.cpp:
        1892-1915)."""
        cfg = self.cfg
        acfg = cfg.audio
        from cvsim_tpu_torch.host import ffmpeg_pipe

        auto_log = None
        if (pts_packets is None and not in_path.endswith(".wav")
                and ffmpeg_pipe.av_tool() is not None):
            fd, auto_log = tempfile.mkstemp(prefix="cvsim_apts_",
                                            suffix=".log")
            os.close(fd)
        try:
            samples, rate = ffmpeg_pipe.resolve_audio_input(
                in_path, acfg.rate, acfg.channels, pkt_log=auto_log)
            if auto_log is not None:
                log_rate, pkts = timing.read_audio_pts_log(auto_log)
                if pkts:
                    # rebase to the stream's own start (the video side
                    # rebases to its first frame too): keep the gaps
                    # without leading silence for the container's offset
                    base = next((p for p, _ in pkts if p is not None), 0)
                    if base:
                        pkts = [(None if p is None else p - base, n)
                                for p, n in pkts]
                    pts_packets = (log_rate, pkts)
        finally:
            if auto_log is not None:
                os.unlink(auto_log)
        if pts_packets:
            log_rate, pkts = pts_packets
            samples = _audio_pad_fill(samples, pkts, rate,
                                      log_rate=log_rate)
        if rate != acfg.rate:
            samples = _resample_sinc(samples, rate, acfg.rate)
        if samples.shape[1] != acfg.channels:
            samples = _remix(samples, acfg.channels)
        if cfg.transcode_start > 0 or cfg.transcode_end >= 0:
            s0 = int(cfg.transcode_start * acfg.rate)
            s1 = (int(cfg.transcode_end * acfg.rate)
                  if cfg.transcode_end >= 0 else len(samples))
            samples = samples[s0:s1]
        if not cfg.enable_audio_emulation:
            # the sinc resampler's overshoot can exceed full scale: clip
            # instead of letting astype wrap to the opposite rail
            wavio.write_wav(out_path,
                            np.clip(samples, -32768, 32767).astype(np.int16),
                            acfg.rate)
            return len(samples)

        result = audio_chain(samples, acfg, key32_from_seed(cfg.seed + 1),
                             self.device, chunk)
        wavio.write_wav(out_path, result.astype(np.int16), acfg.rate)
        return len(result)


def audio_chain(samples: np.ndarray, acfg, key32: int,
                device: torch.device, chunk: int = 1 << 20) -> np.ndarray:
    """The VHS audio chain over a whole stream [N, C] (int16 range), in
    `chunk`-sample steps on `device` with a carried state and one hiss key
    (float32); returns int32 [N, C]."""
    state = init_audio_state(acfg, torch.float32, device)
    outs = []
    for pos in range(0, len(samples), chunk):
        part = samples[pos:pos + chunk]
        pulses = (buzz_pulse_counts(acfg, pos, len(part))
                  if not acfg.vhs_hifi else None)
        out, state = composite_audio_process(
            torch.from_numpy(np.ascontiguousarray(part, np.int32)).to(device),
            state, key32, cfg=acfg, pulses=pulses, dtype=torch.float32)
        outs.append(out.cpu().numpy())
    return (np.concatenate(outs) if outs
            else np.zeros((0, acfg.channels), np.int32))


def _audio_pad_fill(samples: np.ndarray, packets, rate: int,
                    log_rate: int | None = None) -> np.ndarray:
    """Close audio PTS gaps with silence so audio stays on the video master
    clock (ffmpeg_to_composite.cpp:1892-1915: when a packet's target sample
    runs ahead of the running counter, silence is written first; small
    backward jitter is held via the rate/30 slack of audio_target_sample).

    packets: [(pts_in_samples, n_samples), ...] in stream order, pts in
    samples at the rate the log was authored against — by default the rate
    of the DELIVERED stream (`rate`; the ffmpeg ingest path delivers the
    output rate, not the container's). A log authored at the container's
    native rate declares it with a `rate <hz>` first line and both pts and
    n are rescaled here. Samples beyond the log's coverage pass through
    unchanged."""
    if log_rate and log_rate != rate:
        packets = [(None if p is None else round(p * rate / log_rate),
                    round(n * rate / log_rate)) for p, n in packets]
    if len(samples) and packets and not any(n for _, n in packets):
        # a log with no usable durations at all (container carries none and
        # the logger couldn't attribute decoded samples): consuming 0 per
        # packet would push the WHOLE stream behind pts-worth of silence —
        # skip gap fill rather than corrupt
        print("audio packet log carries no durations; skipping PTS gap fill",
              file=sys.stderr)
        return samples
    out = []
    cur = 0          # master-clock sample counter (output position)
    pos = 0          # consumed source samples
    width = samples.shape[1:]
    for pts, n in packets:
        tgt = timing.audio_target_sample(pts, cur, rate)
        if tgt > cur:
            out.append(np.zeros((tgt - cur,) + width, samples.dtype))
            cur = tgt
        part = samples[pos:pos + n]
        out.append(part)
        pos += len(part)
        cur += len(part)
    if pos < len(samples):
        out.append(samples[pos:])
    return np.concatenate(out) if out else samples


def _resample_linear(samples: np.ndarray, src_rate: int, dst_rate: int):
    """Host-side linear resampler (kept for tiny inputs and as a reference
    point; _resample_sinc is the production path for the swr role,
    ffmpeg_to_composite.cpp:1839-1866)."""
    n = samples.shape[0]
    m = int(round(n * dst_rate / src_rate))
    xs = np.arange(m) * (n - 1) / max(1, m - 1)
    x0 = np.floor(xs).astype(np.int64)
    x1 = np.minimum(x0 + 1, n - 1)
    f = (xs - x0)[:, None]
    out = samples[x0] * (1 - f) + samples[x1] * f
    return np.round(out).astype(np.int64)


def _resample_sinc(samples: np.ndarray, src_rate: int, dst_rate: int,
                   taps: int = 32, beta: float = 8.6):
    """Windowed-sinc (Kaiser) resampler — the quality tier of the swr role
    (ffmpeg_to_composite.cpp:1839-1866). Direct per-output-sample evaluation,
    vectorized in blocks: out[j] = sum_k x[k] * w(k - t_j) with
    w = sinc(fc u) * kaiser(beta), fc = min(1, dst/src) for anti-aliased
    downsampling; weights are renormalized per output sample so DC is exact
    even at the edges. ~80 dB stopband at taps=32, beta=8.6."""
    if src_rate == dst_rate:
        return samples.astype(np.int64)
    n = samples.shape[0]
    m = int(round(n * dst_rate / src_rate))
    if n < 2 * taps or m < 2:
        return _resample_linear(samples, src_rate, dst_rate)
    fc = min(1.0, dst_rate / src_rate)
    half = taps // 2
    x = samples.astype(np.float64)
    i0 = np.i0(beta)
    out = np.empty((m,) + samples.shape[1:], np.float64)
    block = 1 << 16
    ks = np.arange(-half + 1, half + 1, dtype=np.float64)   # [taps]
    for j0 in range(0, m, block):
        j1 = min(j0 + block, m)
        t = np.arange(j0, j1, dtype=np.float64) * (src_rate / dst_rate)
        base = np.floor(t).astype(np.int64)
        frac = t - base
        u = ks[None, :] - frac[:, None]                     # [J, taps]
        w = np.sinc(fc * u) * fc
        arg = 1.0 - (u / half) ** 2
        w *= np.where(arg > 0, np.i0(beta * np.sqrt(np.maximum(arg, 0.0))), 0.0) / i0
        w /= w.sum(axis=1, keepdims=True)
        idx = np.clip(base[:, None] + ks.astype(np.int64)[None, :], 0, n - 1)
        out[j0:j1] = np.einsum("jt,jt...->j...", w, x[idx])
    return np.round(out).astype(np.int64)


def _remix(samples: np.ndarray, channels: int):
    if channels == 1:
        return np.round(samples.mean(axis=1)).astype(np.int64)[:, None]
    if samples.shape[1] >= channels:
        return samples[:, :channels]
    # upmix by cycling source channels (stereo -> quad duplicates pairs)
    idx = np.arange(channels) % samples.shape[1]
    return samples[:, idx]
