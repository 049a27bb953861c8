"""The render cells: an endless Y4M stream through a pipeline's
`run_video`, as the CLI runs it, into an in-memory sink.

The stream cycles a pool of seeded frames at the source rate; at the
window's end it returns EOF at the next frame boundary, and the window
closes when `run_video` returns, so the drain of the last GOP is inside
it. The sink keeps a reservoir sample of whole GOPs; after the window the
reference renders the same fields from the same source frames."""

from __future__ import annotations

import time

from harness import program
from harness.core import Window
from harness.judge import Tally
from harness.spec import fraction
from harness.stream import GopSink, SyntheticY4M, y4m_header
from harness.textures import frame_pool
from reference import host
from reference.config import chain_config


def small(spec, name: str) -> dict:
    """The CPU tests' size of a render cell on a chain: `-width 64`, GOPs
    of 4 fields, a stream 64 samples wide from a pool of 3 frames."""
    cfg = spec.config(spec.cell(name)["config"])
    return {**program.at_width(cfg, 64), "gop": 4,
            "stream": {"width": 64, "pool_frames": 3}, "warmup_frames": 2,
            "sample_gops": 2}


class RenderDriver:
    """The base of a render driver (render_gen2): a subclass makes `self.pipe`
    and defines `_run_video`, `traced` and `_reference_frames`."""

    def __init__(self, cell):
        self.cell = cell
        st = cell.workload["stream"]
        self.width, self.height = st["width"], st["height"]
        self.fps = fraction(st["fps"])
        self.colorspace = st["colorspace"]
        ch, cw = {"420jpeg": (self.height // 2, self.width // 2),
                  "422": (self.height, self.width // 2)}[self.colorspace]
        self.pool = frame_pool(cell.seed, st["pool_frames"], self.width,
                               self.height, ch, cw)
        self.pool_bytes = [y.tobytes() + u.tobytes() + v.tobytes()
                           for y, u, v in self.pool]
        self.header = y4m_header(self.width, self.height, self.fps,
                                 self.colorspace)
        out = cell.config["output"]
        self.field_rate = fraction(
            f"{out['field_rate_num']}/{out['field_rate_den']}")
        self.out_w, self.out_h = out["width"], out["height"]
        if out["interlaced_output"]:
            raise ValueError("the render drivers read bobbed output: one "
                             "output frame a field")
        self.chroma_bytes = (self.out_w // 2) * (
            self.out_h if out["use_422_colorspace"] else self.out_h // 2)
        self.gop = cell.config["gop"]
        self.sink = None
        self.returned = 0

    def _reader(self, stream):
        from cvsim_tpu_torch.host import y4m

        return y4m.Y4MReader(stream)

    def warm_up(self):
        """Two GOPs' worth of frames through the same pipeline object."""
        n = self.cell.workload["warmup_frames"]
        reader = self._reader(SyntheticY4M(self.header, self.pool_bytes,
                                           limit=n))
        self._run_video(reader, GopSink(self._frame_bytes(), self.gop, 0,
                                        self.cell.rng))

    def _frame_bytes(self) -> int:
        return self.out_w * self.out_h + 2 * self.chroma_bytes

    def window(self, seconds: float) -> Window:
        stream = SyntheticY4M(self.header, self.pool_bytes)
        reader = self._reader(stream)
        self.sink = GopSink(self._frame_bytes(), self.gop,
                            self.cell.workload["sample_gops"], self.cell.rng)
        t0 = time.perf_counter()
        stream.deadline = t0 + seconds
        self.returned = self._run_video(reader, self.sink)
        t1 = time.perf_counter()
        frames = self.sink.frames
        return Window(fields=frames, units=-(-frames // self.gop),
                      seconds=t1 - t0)

    def samples(self):
        return self.sink.kept_frames()

    def release(self):
        self.pipe = None

    # ------------------------------------------------------------ check

    def check(self, kept: dict) -> Tally:
        """Every kept output frame against the reference's; fields the
        pipeline reported but never wrote count as missing."""
        tally = Tally()
        tally.missing += abs(self.returned - self.sink.frames)
        cfg = chain_config(self.cell.config["composite"])
        sources = host.field_frames(self.sink.frames, self.fps,
                                    self.field_rate)
        by_gop: dict[int, list[int]] = {}
        for n in sorted(kept):
            by_gop.setdefault(n // self.gop, []).append(n)
        ysz, csz = self.out_w * self.out_h, self.chroma_bytes
        for fields in by_gop.values():
            want = self._reference_frames(cfg, fields, sources)
            for n, w in zip(fields, want):
                got = kept[n]
                tally.add((got[:ysz], got[ysz:ysz + csz],
                           got[ysz + csz:]), w)
        return tally

    def _source(self, frame: int):
        return self.pool[frame % len(self.pool)]
