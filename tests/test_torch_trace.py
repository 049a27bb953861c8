"""The port's recorder (utils/log.py): spans and counters inside both
engines' host loops, `prepare`, the library entries and the copies, on
the profiler's clock, and the CVSIM_TRACE spans file of a CLI command.

Imports torch and the port only (no jax), so that on a GPU host the
`cuda`-marked test runs without jax's CPU setup in tests/conftest.py:

    python -m pytest --noconftest -m cuda tests/test_torch_trace.py -q

The renders here run on the CPU at 64-sample lines with GOPs of 2 fields.
"""

import io
import json
import sys
import threading
import warnings
from fractions import Fraction

import numpy as np
import pytest
import torch

from cvsim_tpu_torch import presets
from cvsim_tpu_torch.cli.main import main
from cvsim_tpu_torch.host import y4m
from cvsim_tpu_torch.host.pipeline import CompositePipeline
from cvsim_tpu_torch.host.pipeline_yiq import YIQPipeline
from cvsim_tpu_torch.models import yiq, yuv422
from cvsim_tpu_torch.utils import log

W, H, FRAMES, GOP = 64, 48, 3, 2
FLAGS = ["-width", str(W), "-vhs", "-vhs-speed", "ep", "-vhs-head-switching",
         "1", "-seed", "7"]


def _clip(frames: int = FRAMES) -> bytes:
    """A 4:2:0 Y4M clip at 29.97 fps: a moving bar over noise."""
    rng = np.random.default_rng(3)
    hdr = y4m.Y4MHeader(width=W, height=H, fps=Fraction(30000, 1001))
    f = io.BytesIO()
    wr = y4m.Y4MWriter(f, hdr)
    for k in range(frames):
        y = rng.integers(16, 235, (H, W), dtype=np.uint8)
        y[:, (8 * k) % W:(8 * k) % W + 8] = 200
        u, v = (rng.integers(90, 166, (H // 2, W // 2), dtype=np.uint8)
                for _ in range(2))
        wr.write(y, u, v)
    return f.getvalue()


def _render(gen: str) -> tuple[int, bytes]:
    """(fields, output bytes) of a render of _clip() on the CPU."""
    gen2 = gen == "gen2"
    st = presets.parse_composite_flags(FLAGS, gen2=gen2)
    cfg = st.to_run_config(gen1=not gen2)
    out = io.BytesIO()
    reader = y4m.Y4MReader(io.BytesIO(_clip()))
    if gen2:
        pipe = YIQPipeline(cfg, gop=GOP, progress=False, device="cpu")
        fields = pipe.run_video([reader], out)
    else:
        pipe = CompositePipeline(cfg, gop=GOP, progress=False, device="cpu")
        fields = pipe.run_video(reader, out)
    return fields, out.getvalue()


@pytest.fixture
def tracing():
    """Tracing on for the test, from an empty recorder; off after."""
    log.reset()
    log.tracing(True)
    try:
        yield
    finally:
        log.tracing(False)
        log.reset()


def _by_name(snap: dict) -> dict:
    out: dict = {}
    for s in snap["spans"]:
        out.setdefault(s["name"], []).append(s)
    return out


def _check_nesting(snap: dict):
    """Each child lies inside its parent in time, on its thread, and
    carries its parent's unit unless it names its own GOP."""
    by_id = {s["id"]: s for s in snap["spans"]}
    for s in snap["spans"]:
        if s["parent"] is None:
            continue
        p = by_id[s["parent"]]
        assert p["start_ns"] <= s["start_ns"] <= s["end_ns"] <= p["end_ns"]
        assert p["thread"] == s["thread"]
        if p["unit"] is not None:
            assert s["unit"] == p["unit"], (s, p)


def test_gen2_render_spans(tracing):
    fields, _ = _render("gen2")
    assert fields == 3 * GOP
    snap = log.snapshot()
    spans = _by_name(snap)
    assert len(spans["gen2.flush"]) == 3
    assert [s["unit"] for s in spans["gen2.flush"]] == [
        "gop=0", "gop=1", "gop=2"]
    assert len(spans["gen2.emit"]) == fields
    assert len(spans["gen2.emit.convert"]) == fields
    assert len(spans["gen2.emit.write"]) == fields
    # one read a source frame, and the read that finds the end
    assert len(spans["gen2.read"]) == FRAMES + 1
    for name in ("gen2.stack", "gen2.call", "gen2.prepare",
                 "gen2.prepare.streams", "gen2.prepare.tables",
                 "gen2.launch", "gen2.wait"):
        assert len(spans[name]) == 3, name
    assert len(spans["gen2.prepare.copy"]) == 6     # field numbers, tables
    by_id = {s["id"]: s for s in snap["spans"]}
    for name, parent in (("gen2.emit", "gen2.flush"),
                         ("gen2.emit.convert", "gen2.emit"),
                         ("gen2.call", "gen2.flush"),
                         ("gen2.prepare", "gen2.call"),
                         ("gen2.prepare.streams", "gen2.prepare"),
                         ("gen2.launch", "gen2.call"),
                         ("gen2.wait", "gen2.flush")):
        for s in spans[name]:
            assert by_id[s["parent"]]["name"] == parent, name
    assert all(s["unit"].startswith("gop=") for s in snap["spans"])
    _check_nesting(snap)
    agg = snap["aggregates"]["gen2.flush"]
    assert agg["count"] == 3 and 0 <= agg["self_ns"] <= agg["total_ns"]


def test_gen1_render_spans_by_thread(tracing):
    fields, _ = _render("gen1")
    assert fields == 3 * GOP
    snap = log.snapshot()
    threads: dict = {}
    for s in snap["spans"]:
        threads.setdefault(s["thread"], set()).add(s["name"])
    assert {"gen1.read", "gen1.put.wait"} <= threads["cvsim-read"]
    assert {"gen1.get.wait", "gen1.h2d", "gen1.step", "gen1.call",
            "gen1.prepare", "gen1.out.wait"} <= threads["MainThread"]
    assert {"gen1.fetch.wait", "gen1.emit"} <= threads["cvsim-write"]
    spans = _by_name(snap)
    assert len(spans["gen1.emit"]) == fields
    assert sorted(s["unit"] for s in spans["gen1.step"]) == [
        "gop=0", "gop=1", "gop=2"]
    for s in spans["gen1.call"]:
        assert s["unit"].startswith("gop=")
    _check_nesting(snap)
    wall = max(s["end_ns"] for s in snap["spans"]) - min(
        s["start_ns"] for s in snap["spans"])
    shares = log.summary(snap, wall)["threads"]
    assert set(shares) == {"cvsim-read", "MainThread", "cvsim-write"}
    for name, sh in shares.items():
        assert min(sh.values()) >= 0, name
        assert sh["busy"] + sh["blocked"] <= 1 + 1e-9, name
        assert sh["blocked"] > 0, name


def test_counters_lose_no_count_across_threads():
    n_threads, n = 16, 2000
    before = log.snapshot()["counters"].get("test.stress", 0)
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        go = threading.Event()

        def work():
            go.wait(10)
            for _ in range(n):
                log.count("test.stress")
                log.count("test.stress", 2)

        ts = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in ts:
            t.start()
        go.set()
        for t in ts:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(switch)
    got = log.snapshot()["counters"]["test.stress"] - before
    assert got == 3 * n * n_threads


@pytest.mark.parametrize("gen", ["gen2", "gen1"])
def test_output_bytes_equal_with_tracing_on(gen):
    """Off, a render records nothing and `span` is one shared no-op; on,
    it writes the same bytes."""
    log.tracing(False)
    log.reset()
    assert log.span("gen2.flush", gop=1) is log.span("gen1.emit")
    want = _render(gen)
    snap = log.snapshot()
    assert snap["spans"] == [] and snap["aggregates"] == {}
    log.tracing(True)
    try:
        got = _render(gen)
    finally:
        log.tracing(False)
        log.reset()
    assert got == want


def test_profiler_ranges_share_the_recorders_clock():
    """Under torch.profiler the spans are recorded (and only while it
    runs), each as a cvsim.<name> range starting within 1 ms of the
    span; a library entry called directly is its own call unit."""
    from torch.profiler import ProfilerActivity, profile

    from cvsim_tpu_torch.config import CompositeConfig

    log.tracing(False)
    log.reset()
    cfg = CompositeConfig(emulating_vhs=True, video_chroma_phase_noise=4)
    rgb = torch.from_numpy(np.random.default_rng(1).integers(
        0, 256, (2, 16, W, 3)).astype(np.uint8))
    fn = torch.tensor([4, 5], dtype=torch.int32)
    y = rgb[..., 0].contiguous()
    u = v = y[..., ::2].contiguous()

    def calls():
        yiq.composite_layer_rgb_auto(rgb, fn, fn % 2, 7, cfg=cfg)
        yuv422.composite_video_process_auto(y, u, v, fn, fn % 2, 7, cfg=cfg)

    calls()
    assert log.snapshot()["spans"] == []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        calls()
    calls()
    spans = log.snapshot()["spans"]
    log.reset()
    names = {s["name"] for s in spans}
    assert {"gen2.call", "gen2.prepare", "gen2.launch", "gen1.call",
            "gen1.prepare.streams"} <= names
    calls_ = [s for s in spans if s["name"].endswith(".call")]
    assert len(calls_) == 2
    assert len({s["unit"] for s in calls_}) == 2
    assert all(s["unit"].startswith("call=") for s in spans)
    ranges: dict = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("cvsim."):
            ranges.setdefault(e.name()[len("cvsim."):], []).append(
                e.start_ns())
    for s in spans:
        starts = ranges[s["name"]]
        assert min(abs(t - s["start_ns"]) for t in starts) < 1_000_000, s


@pytest.mark.parametrize("tool", ["ntsc", "to-composite"])
def test_cli_writes_one_spans_file(tool, tmp_path, monkeypatch):
    src = tmp_path / "in.y4m"
    src.write_bytes(_clip(2))
    out_dir = tmp_path / "spans"
    monkeypatch.setenv("CVSIM_TRACE", str(out_dir))
    assert main(["--device", "cpu", tool, "-i", str(src), "-o",
                 str(tmp_path / "out.y4m"), "-width", str(W), "-vhs"]) == 0
    files = list(out_dir.iterdir())
    assert len(files) == 1 and files[0].name.startswith("spans-")
    doc = json.loads(files[0].read_text())
    gen = "gen2" if tool == "ntsc" else "gen1"
    xs = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert {e["name"] for e in xs} >= {f"{gen}.call", f"{gen}.prepare",
                                       f"{gen}.emit"}
    assert all(e["dur"] >= 0 and "unit" in e["args"] for e in xs)
    assert any(e["ph"] == "i" for e in doc["traceEvents"])  # phases
    summary = doc["summary"]
    assert summary["spans"][f"{gen}.call"]["count"] >= 1
    assert summary["wall_ms"] > 0 and summary["threads"]
    for sh in summary["threads"].values():
        assert sh["busy"] + sh["blocked"] + sh["idle"] <= 1 + 1e-9
    assert not log._REC.on


@pytest.mark.cuda
@pytest.mark.parametrize("gen", ["gen2", "gen1"])
def test_syncs_counted_equal_sync_warnings(gen):
    """One call of each library entry on the card: the `syncs` it counts
    equal the synchronisations torch's sync debug mode warns of."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    from cvsim_tpu_torch.testing import BENCH_GEN1_EP, BENCH_VHS_EP

    dev = torch.device("cuda", 0)
    gen_ = np.random.default_rng(2)
    fn = torch.arange(100, 108, dtype=torch.int32, device=dev)
    pa = (fn & 1) ^ 1
    if gen == "gen2":
        rgb = torch.from_numpy(gen_.integers(0, 256, (8, 240, 720, 3)).astype(
            np.uint8)).to(dev)

        def call():
            return yiq.composite_layer_rgb_auto(rgb, fn, pa, 7,
                                                cfg=BENCH_VHS_EP)
    else:
        y = torch.from_numpy(gen_.integers(16, 236, (8, 240, 720)).astype(
            np.uint8)).to(dev)
        u = v = y[..., ::2].contiguous()

        def call():
            return yuv422.composite_video_process_auto(y, u, v, fn, pa, 7,
                                                       cfg=BENCH_GEN1_EP)
    call()
    torch.cuda.synchronize()
    before = log.snapshot()["counters"].get("syncs", 0)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            call()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    counted = log.snapshot()["counters"].get("syncs", 0) - before
    # (the mode's first use also warns that it is a prototype)
    warned = [w for w in caught
              if "called a synchronizing CUDA operation" in str(w.message)]
    assert counted == len(warned) > 0, [str(w.message) for w in warned]
