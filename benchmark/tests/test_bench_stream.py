"""The synthetic Y4M stream: the port's Y4MReader parses it, the same
seed gives the same bytes, it ends at its deadline on a frame boundary;
the sink counts frames and keeps whole GOPs."""

import io
import time
from fractions import Fraction

import numpy as np

from cvsim_tpu_torch.host import y4m
from harness.stream import GopSink, SyntheticY4M, y4m_header
from harness.textures import device_pool, frame_pool


def _stream(seed, **kw):
    pool = frame_pool(seed, 3, 64, 48, 24, 32)
    frames = [y.tobytes() + u.tobytes() + v.tobytes() for y, u, v in pool]
    hdr = y4m_header(64, 48, Fraction(30000, 1001), "420jpeg")
    return pool, SyntheticY4M(hdr, frames, **kw)


def test_reader_parses_the_stream_and_the_pool_cycles():
    pool, stream = _stream(7, limit=7)
    reader = y4m.Y4MReader(stream)
    assert (reader.header.width, reader.header.height) == (64, 48)
    assert reader.header.fps == Fraction(30000, 1001)
    got = list(reader)
    assert len(got) == 7
    for k, (y, u, v) in enumerate(got):
        py, pu, pv = pool[k % 3]
        assert (y == py).all() and (u == pu).all() and (v == pv).all()


def test_same_seed_same_bytes():
    a = _stream(2 ** 31 + 11, limit=4)[1].read()
    b = _stream(2 ** 31 + 11, limit=4)[1].read()
    c = _stream(2 ** 31 + 12, limit=4)[1].read()
    assert a == b and a != c
    pool = frame_pool(3, 4, 64, 48, 24, 32)
    assert len({p[0].tobytes() for p in pool}) == 4     # frames differ
    d1 = device_pool(5, (2, 3, 16, 24, 3), 3, "cpu")
    d2 = device_pool(5, (2, 3, 16, 24, 3), 3, "cpu")
    assert d1.dtype.is_floating_point is False and (d1 == d2).all()
    assert d1.shape == (2, 3, 16, 24, 3)


def test_stream_ends_at_its_deadline_on_a_frame_boundary():
    _, stream = _stream(1)
    reader = y4m.Y4MReader(stream)
    stream.deadline = time.perf_counter() + 0.05
    n = sum(1 for _ in reader)
    assert n >= 1 and stream.ended
    assert stream.read(6) == b""


def test_sink_counts_and_keeps_whole_gops():
    hdr = y4m.Y4MHeader(width=8, height=4)
    sink = GopSink(hdr.frame_bytes(), gop=4, keep=2,
                   rng=np.random.default_rng(0))
    w = y4m.Y4MWriter(sink, hdr)
    for k in range(22):
        y = np.full((4, 8), k, np.uint8)
        c = np.full((2, 4), 255 - k, np.uint8)
        w.write(y, c, c)
    assert sink.frames == 22
    kept = sink.kept_frames()
    gops = {n // 4 for n in kept}
    assert len(gops) == 2
    for n, data in kept.items():
        assert data[:32] == bytes([n]) * 32
    for g in gops:          # whole GOPs (the last one may be short)
        assert {n for n in kept if n // 4 == g} == set(
            range(4 * g, min(4 * g + 4, 22)))
