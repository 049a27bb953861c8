"""The raw decoder's stream loop (`cli/raw28.decode_stream`) held to the
benchmark's plain reference (`benchmark/reference/raw28.py`), on the CPU.

On captures made by the `raw28ntsc-capture` cell's generator
(`benchmark/drivers/capture_raw28.py`), at the cell's 8fsc rate and
1820-sample lines, each with a seed of its own:

- from a fresh decoder, the Y4M frames the stream loop writes equal the
  reference's decode of the same chunks from a fresh state, its tracker
  included;
- from a mid-stream state (the samples buffered, the levels, the chroma
  carry, the tracker's registers) the reference goes on as the program
  does;
- `cli/raw28.parse` gives the configuration file's settings for
  `-s ntsc28`, each flag its setting and the others their defaults;
- the decoder's spans lie inside `raw28.field` in the counts expected,
  with a re-lock a line and under 0.3 M sync samples a field counted
  inside them, a decode that finds no line closes as `raw28.nofield`,
  and nothing is recorded untraced;
- the cell's check, through a whole run at the driver's small size,
  reads correct for the program and not correct for its control and
  each of its faults.
"""

import io
import json
import os
import sys

import pytest

from cvsim_tpu_torch.cli import raw28 as cli
from cvsim_tpu_torch.host import y4m
from cvsim_tpu_torch.models.raw28 import RawTiming
from cvsim_tpu_torch.utils import log

BENCH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmark")
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)

from drivers import capture_raw28  # noqa: E402
from harness import core, spec as spec_mod  # noqa: E402
from reference import raw28 as ref  # noqa: E402

CELL, CONFIG = "raw28ntsc-capture", "raw28ntsc-ntsc28"
RATE = ref.NTSC28
RL = RawTiming(RATE).raw_length
CHUNK = 1 << 18


def _load(kind, name):
    with open(os.path.join(BENCH, kind, f"{name}.json")) as f:
        return json.load(f)


def _capture(seed: int, fields: int) -> bytes:
    cap = {**_load("workloads", CELL)["capture"], "pool_fields": fields}
    pool, _ = capture_raw28.capture_pool(seed, cap, RL)
    return pool.tobytes()


def _chunks(data: bytes, chunk: int):
    return [data[k:k + chunk] for k in range(0, len(data), chunk)]


def _program_frames(data: bytes, chunk: int = 1 << 20) -> list[bytes]:
    """The frames (planes, FRAME markers stripped) the CLI's stream loop
    writes for `data`, on the CPU."""
    args = cli.parse(["-s", "ntsc28"])
    buf = io.BytesIO()
    writer = y4m.Y4MWriter(buf, args.header())
    n = cli.decode_stream(args.decoder("cpu"), io.BytesIO(data), writer,
                          chunk)
    out = buf.getvalue()
    body = out[out.index(b"\n") + 1:]
    size = 6 + args.header().frame_bytes()
    assert len(body) == n * size
    return [body[k * size + 6:(k + 1) * size] for k in range(n)]


def _reference_frames(dec: ref.Decoder, chunks) -> list[bytes]:
    frames = []
    for data in chunks:
        if data is not None:
            dec.feed(data)
        while (field := dec.decode_field()) is not None:
            frames.append(ref.frame_bytes(field))
    return frames


def test_stream_loop_equals_reference_from_a_fresh_state():
    """Three fields of capture in the CLI's 1 MiB reads: the frames out
    of the stream loop equal the reference's, tracker included."""
    data = _capture(2 ** 33 + 5, 3)
    got = _program_frames(data)
    want = _reference_frames(ref.Decoder(RATE, RL, 262),
                             _chunks(data, 1 << 20))
    assert len(got) == len(want) >= 2
    for k, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"field {k}"


def test_stream_continued_from_a_mid_stream_state():
    """The program decodes a capture in 256 KiB reads; after its first
    field, the reference takes its state (the samples buffered, the
    levels, the chroma carry, the tracker's registers) and decodes the
    rest of the stream as the program does."""
    data = _capture(2 ** 31 + 77, 4)
    chunks = _chunks(data, CHUNK)
    args = cli.parse(["-s", "ntsc28"])
    dec = args.decoder("cpu")
    got = []
    state = None
    for k, chunk in enumerate(chunks):
        if state is None and got:
            raw, dc = dec.buffered()
            st = dec.state
            state = {"raw": raw, "dc": dc, "blank": st.agc.blank_level,
                     "white": st.agc.white_level,
                     "tail": st.chroma_tail.numpy(),
                     "tracker": dec.tracker.state()}
            rest = chunks[k:]
            first = len(got)
        dec.feed(chunk)
        while (field := dec.decode_field()) is not None:
            got.append(ref.frame_bytes(field))
    assert state is not None and state["tail"].shape == (16,)
    want = _reference_frames(ref.Decoder(RATE, RL, 262, state),
                             [None] + rest)
    assert len(want) == len(got) - first >= 2
    assert got[first:] == want


# ---------------------------------------------------------- the parser

def test_parser_gives_the_configuration_s_settings():
    config = _load("configs", CONFIG)
    args, dec = capture_raw28.run_config(config, "cpu")
    assert (args.rate, args.width, args.height, args.use_422) == (
        config["decoder"]["sample_rate"], 1820, 262, True)
    assert (args.decoder_kw, args.inputs, args.output) == ({}, [], "")
    assert args.header().fps == cli.FIELD_RATE
    assert ref.timing(args.rate)[2] == dec.t.raw_length == 1820


DEFAULTS = dict(rate=RATE, width=1820, height=262, use_422=True,
                decoder_kw={}, inputs=[], output="")
FLAGS = {
    "-marksig": {"decoder_kw": {"mark_sync": True}},
    "-nosig": {"decoder_kw": {"disable_sync": True}},
    "-noequ": {"decoder_kw": {"equalize": False}},
    "-nowequ": {"decoder_kw": {"wp_equalize": False}},
    "-nosc": {"decoder_kw": {"separate_chroma": False}},
    "-showsc": {"decoder_kw": {"show_subcarrier": True}},
    "-color": {"decoder_kw": {"decode_color": True}},
    "-sat 3.5": {"decoder_kw": {"saturation": 3.5}},
    "-420": {"use_422": False},
    "-422": {},
    "-inntsc": {},
    "-width 720": {"width": 720},
    "-s 40mhz": {"rate": 40000000.0,
                 "width": (RawTiming(40000000.0).raw_length + 1) & ~1},
    "-i a.raw -i - -o tv.y4m": {"inputs": ["a.raw", "-"],
                                "output": "tv.y4m"},
}


@pytest.mark.parametrize("flags", list(FLAGS))
def test_each_flag_sets_its_setting_and_leaves_the_rest(flags):
    got = cli.parse(["-s", "ntsc28"] + flags.split())
    assert got._asdict() == {**DEFAULTS, **FLAGS[flags]}


@pytest.mark.parametrize("argv,answer", [
    (["-h"], cli.HELP), (["-i", "a.raw", "-bogus"], "Unknown switch 'bogus'")],
    ids=["help", "unknown-switch"])
def test_usage_answers_before_any_file(argv, answer, capsys):
    with pytest.raises(cli.UsageError) as e:
        cli.parse(argv)
    assert str(e.value) == answer
    assert cli.run(argv, "cpu") == 1
    assert capsys.readouterr().err == answer + "\n"


# ---------------------------------------------------------- the spans

@pytest.fixture
def tracing():
    log.tracing(False)
    log.reset()
    log.tracing(True)
    try:
        yield
    finally:
        log.tracing(False)
        log.reset()


def test_spans_lie_inside_each_field(tracing):
    data = _capture(2 ** 32 + 9, 3)
    args = cli.parse(["-s", "ntsc28"])
    dec = args.decoder("cpu")
    n = cli.decode_stream(dec, io.BytesIO(data),
                          y4m.Y4MWriter(io.BytesIO(), args.header()), CHUNK)
    snap = log.snapshot()
    aggs = snap["aggregates"]
    chunks = -(-len(data) // CHUNK)
    assert n >= 2 and dec.fields == n
    assert {k: a["count"] for k, a in aggs.items()} == {
        "raw28.field": n, "raw28.hunt": n, "raw28.lines": n,
        "raw28.decode": n, "raw28.feed": chunks, "raw28.write": n}
    by_id = {s["id"]: s for s in snap["spans"]}
    fields = [s for s in snap["spans"] if s["name"] == "raw28.field"]
    assert [s["unit"] for s in fields] == [f"field={k}" for k in range(n)]
    for s in snap["spans"]:
        parent = by_id.get(s["parent"])
        if s["name"] in ("raw28.hunt", "raw28.lines", "raw28.decode"):
            assert parent["name"] == "raw28.field"
            assert s["unit"] == parent["unit"]
        else:       # raw28.field, raw28.feed, raw28.write
            assert parent is None
    # a re-lock a line, counted inside raw28.lines, so inside raw28.field
    scans = aggs["raw28.lines"]["counts"]["raw28.relock_scans"]
    assert scans >= 250 * n
    assert aggs["raw28.field"]["counts"]["raw28.relock_scans"] == scans
    # the samples the hunt and the walk examine, counted inside them, and
    # the scans stop at the pulse they need: under 0.3 M a field
    samples = {k: aggs[k]["counts"]["raw28.sync_samples"]
               for k in ("raw28.hunt", "raw28.lines")}
    assert min(samples.values()) > 0
    assert (aggs["raw28.field"]["counts"]["raw28.sync_samples"]
            == sum(samples.values()) < 300_000 * n)
    # the CPU decoder copies nothing to a card
    assert not any(k.endswith(".raw28") for k in snap["counters"])


def test_a_decode_without_a_line_is_no_field(tracing, monkeypatch):
    # a lock in the buffer's last two lines leaves no line to decode
    from cvsim_tpu_torch.models import raw28

    dec = cli.parse(["-s", "ntsc28"]).decoder("cpu")
    dec.feed(_capture(2 ** 32 + 13, 2))
    monkeypatch.setattr(raw28, "hunt_vsync",
                        lambda dc, raw, rl, agc: len(dc) - rl)
    assert dec.decode_field() is None and dec.fields == 0
    snap = log.snapshot()
    assert {k: a["count"] for k, a in snap["aggregates"].items()} == {
        "raw28.feed": 1, "raw28.nofield": 1, "raw28.hunt": 1,
        "raw28.lines": 1}
    (top,) = [s for s in snap["spans"]
              if s["parent"] is None and s["name"] != "raw28.feed"]
    assert top["name"] == "raw28.nofield" and top["unit"] == "field=0"


def test_nothing_is_recorded_untraced():
    log.tracing(False)
    log.reset()
    scans = log.snapshot()["counters"].get("raw28.relock_scans", 0)
    assert _program_frames(_capture(2 ** 32 + 11, 3), CHUNK)
    snap = log.snapshot()
    assert snap["spans"] == [] and snap["aggregates"] == {}
    # counters always count
    assert snap["counters"]["raw28.relock_scans"] > scans


# ----------------------------------------------------------- the check

@pytest.fixture(scope="module")
def spec():
    return spec_mod.Spec.load(os.path.dirname(BENCH))


def _run(spec, entry=None):
    return core.run_cell(spec, CELL, 2 ** 31 + 1001, 0.3, False,
                         core.Clock(), {}, device="cpu",
                         overrides=capture_raw28.small(spec, CELL),
                         entry=entry)


def test_the_check_reads_the_program_correct(spec):
    r = _run(spec)
    assert r["correct"], r["check"]
    # 4 drawn fields and the two drawn chunks' tracker outputs
    assert r["_sampled_fields"] == 4 + capture_raw28.TRACKED_CHUNKS
    assert r["failed"] == 0


@pytest.mark.parametrize("name", ["control"] + sorted(capture_raw28.FAULTS))
def test_the_check_reads_control_and_faults_not_correct(spec, name):
    entry = (capture_raw28.control(spec.config(CONFIG)) if name == "control"
             else capture_raw28.FAULTS[name])
    r = _run(spec, entry)
    assert not r["correct"], r["check"]
    assert r["check"]["worst_field_mismatch_pct"]["value"] > 0
