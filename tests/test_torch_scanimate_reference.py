"""scanimate's render loop (`cli/tools.render_scanimate`) held to the
benchmark's plain reference (`benchmark/reference/scanimate.py`), on the
CPU, at a small raster (128x72 over 48x32 frames of the
`scanimate-1080p60-render` cell's seeded textures, scaled up to it as
the CLI scales them):

- the loop's Y4M frames equal the reference's, in each warp effect and
  both parities, with the cell's rotated field numbers and with the
  CLI's count from 0 (a short last batch, the row-0 rule across
  batches);
- `parse_scanimate` gives the configuration file's settings for
  `-tvstd 1080p60 -inntsc`, each flag its setting, and -h its answer;
- the loop's spans nest as documented, in the counts expected, with the
  stamp cells (dots x 36 at 1080p's dot radius, dots x the stamp's area
  here) counted inside them, and nothing is recorded untraced;
- the cell's check, through a whole run at the driver's small size,
  reads correct for the program and not correct for its control and
  each of its faults.
"""

import io
import json
import os
import sys
from fractions import Fraction

import numpy as np
import pytest
import torch

from cvsim_tpu_torch.cli import tools as cli
from cvsim_tpu_torch.host import y4m
from cvsim_tpu_torch.models import tools
from cvsim_tpu_torch.utils import log

BENCH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmark")
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)

from drivers import render_scanimate as drv  # noqa: E402
from harness import core, spec as spec_mod  # noqa: E402
from harness.stream import y4m_header  # noqa: E402
from harness.textures import frame_pool  # noqa: E402
from reference import host  # noqa: E402
from reference import scanimate as ref  # noqa: E402

CELL, CONFIG = "scanimate-1080p60-render", "scanimate-1080p60-inntsc"
W, H = 128, 72                  # the raster
SW, SH = 48, 32                 # the source frames
FPS = Fraction(30000, 1001)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Many small ops: one torch thread, as tests/test_torch_scanimate.py
    runs them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _load(kind, name):
    with open(os.path.join(BENCH, kind, f"{name}.json")) as f:
        return json.load(f)


def _args(**kw):
    args = cli.parse_scanimate(["-tvstd", "1080p60", "-inntsc"])
    return args._replace(width=W, height=H, **kw)


def _pool(seed: int, n: int):
    return frame_pool(seed, n, SW, SH, SH // 2, SW // 2)


def _source(pool, frames: int) -> bytes:
    out = [y4m_header(SW, SH, FPS, "420jpeg", "b")]
    for k in range(frames):
        out += [b"FRAME\n"] + [p.tobytes() for p in pool[k % len(pool)]]
    return b"".join(out)


def _render(args, pool, frames: int, fields=None):
    """The loop's output frames (Y, U, V bytes each) over `frames` source
    frames, and the fields it reported."""
    hdr = y4m.Y4MHeader(width=args.width, height=args.height,
                        fps=args.field_rate, interlacing="p", aspect="4:3",
                        colorspace="422" if args.use_422 else "420jpeg")
    buf = io.BytesIO()
    reader = y4m.Y4MReader(io.BytesIO(_source(pool, frames)))
    n = cli.render_scanimate(args, [reader], y4m.Y4MWriter(buf, hdr), "cpu",
                             fields=fields)
    got = list(y4m.Y4MReader(io.BytesIO(buf.getvalue())))
    assert len(got) == n
    return got, n


def _reference(args, pool, fieldnos):
    """The reference's frames of the stream's fields, field i from source
    frame i // 2 and numbered fieldnos[i]; each batch of 16 after the
    first starts from the field before it."""
    rgb = [host.frame_to_rgb(*p, W, H).astype(np.uint8) for p in pool]
    src = [rgb[(i // 2) % len(pool)] for i in range(len(fieldnos))]
    out = []
    for b in range(0, len(fieldnos), 16):
        prev = None if b == 0 else (src[b - 1], fieldnos[b - 1])
        out += ref.render(src[b:b + 16], fieldnos[b:b + 16], H, W, True,
                          args.use_422, prev)
    return out


def _assert_frames_equal(got, want):
    assert len(got) == len(want)
    for k, (g, w) in enumerate(zip(got, want)):
        for plane, (gp, wp) in enumerate(zip(g, w)):
            np.testing.assert_array_equal(gp, wp,
                                          err_msg=f"field {k} plane {plane}")


def test_rotated_batches_equal_the_reference():
    """Four batches, one of each effect at the cell's rotation (steps 0-3
    of the walk through each effect), both parities in each."""
    pool = _pool(2 ** 33 + 17, 5)
    args = _args()
    starts = [drv.FIELDS_PER_EFFECT * e + 16 * e for e in range(4)]
    got, n = _render(args, pool, 32, fields=iter(starts))
    assert n == 64
    fieldnos = [s + j for s in starts for j in range(16)]
    assert {f // 180 for f in fieldnos} == {0, 1, 2, 3}
    _assert_frames_equal(got, _reference(args, pool, fieldnos))


@pytest.mark.parametrize("use_422", [False, True], ids=["420", "422"])
def test_the_cli_count_equals_the_reference(use_422):
    """Field numbers from 0, as the CLI counts them: 40 fields in batches
    of 16, 16 and 8, the row-0 rule across each batch's start."""
    pool = _pool(2 ** 31 + 5, 4)
    args = _args(use_422=use_422)
    got, n = _render(args, pool, 20)
    assert n == 40
    _assert_frames_equal(got, _reference(args, pool, list(range(40))))


def test_the_reference_visits_the_whole_stamp():
    """The reference's stamp is upstream's, offsets -r..r+1; the program's
    tight one, -(r-1)..r, gives the same raster on the same dots."""
    rng = np.random.default_rng(8)
    n = 500
    px = torch.from_numpy(rng.uniform(-3, W + 3, n).astype(np.float32))
    py = torch.from_numpy(rng.uniform(-3, H + 3, n).astype(np.float32))
    sig = torch.from_numpy(rng.uniform(0, 16, n).astype(np.float32))
    rad, r = ref.radius(1080, 1080, True)
    assert (float(rad), r) == (float(np.float32(2.05)), 3)
    want = ref.splat(px, py, sig, rad, r, H, W)
    got = tools.splat(px[None], py[None], sig[None], torch.tensor(rad), r,
                      H, W)
    assert want.max() > 0
    np.testing.assert_array_equal(got[0].reshape(-1).numpy(), want.numpy())


# ---------------------------------------------------------- the parser

def test_parser_gives_the_configuration_s_settings():
    config = _load("configs", CONFIG)
    args = drv.run_config(config)
    assert args == cli.ScanimateArgs(1920, 1080, Fraction(60000, 1001),
                                     True, False, [], "")
    assert config["render"]["precision"] == drv.PRECISION == 1


DEFAULTS = dict(width=720, height=480, field_rate=Fraction(60000, 1001),
                inntsc=False, use_422=False, inputs=[], output="")
FLAGS = {
    "-tvstd 1080p60": {"width": 1920, "height": 1080},
    "-tvstd 720p60": {"width": 1280, "height": 720},
    "-tvstd pal": {"height": 576, "field_rate": Fraction(50)},
    "-inntsc": {"inntsc": True},
    "-422": {"use_422": True},
    "-width 640": {"width": 640},
    "-i a.y4m -i b.y4m -o c.y4m": {"inputs": ["a.y4m", "b.y4m"],
                                   "output": "c.y4m"},
}


@pytest.mark.parametrize("flags", list(FLAGS))
def test_each_flag_sets_its_setting_and_leaves_the_rest(flags):
    got = cli.parse_scanimate(flags.split())
    assert got._asdict() == {**DEFAULTS, **FLAGS[flags]}


@pytest.mark.parametrize("argv,answer", [
    (["-h"], "flags: -i <in> -o <out> -width <n> -d <n> -422 -420 "
             "-tvstd <ntsc|pal|720p60|1080p60> -inntsc"),
    (["-i", "a.y4m", "-bogus"], "Unknown switch 'bogus'")],
    ids=["help", "unknown-switch"])
def test_usage_answers(argv, answer):
    with pytest.raises(ValueError) as e:
        cli.parse_scanimate(argv)
    assert str(e.value) == answer


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


def test_spans_nest_and_count(tracing):
    pool = _pool(2 ** 32 + 3, 3)
    args = _args()
    c0 = log.snapshot()["counters"]
    _, n = _render(args, pool, 20)
    snap = log.snapshot()
    aggs = snap["aggregates"]
    assert n == 40
    assert {k: a["count"] for k, a in aggs.items()} == {
        "scanimate.read": 21, "scanimate.batch": 3, "scanimate.call": 6,
        "scanimate.upload": 6, "scanimate.warp": 6, "scanimate.splat": 6,
        "scanimate.fetch": 6, "scanimate.pack": 40, "scanimate.write": 40}
    by_id = {s["id"]: s for s in snap["spans"]}
    parents = {"scanimate.call": "scanimate.batch",
               "scanimate.pack": "scanimate.batch",
               "scanimate.upload": "scanimate.call",
               "scanimate.warp": "scanimate.call",
               "scanimate.splat": "scanimate.call",
               "scanimate.fetch": "scanimate.call"}
    for s in snap["spans"]:
        parent = by_id.get(s["parent"])
        if s["name"] in parents:
            assert parent["name"] == parents[s["name"]]
            assert s["unit"] == parent["unit"]
        else:       # read, batch, and write on the writer thread
            assert parent is None
    batches = [s for s in snap["spans"] if s["name"] == "scanimate.batch"]
    assert [s["unit"] for s in batches] == ["gop=0", "gop=1", "gop=2"]
    assert {s["thread"] for s in snap["spans"]
            if s["name"] == "scanimate.write"} != {batches[0]["thread"]}
    # the dots of 40 fields, each the rows of its parity, two dots a
    # source pixel across, and a stamp of 6 x 6 at the dot radius 2.05
    dots = 40 * (H // 2) * (W << 1)
    cells = dots * 36
    radius, r_int = tools.stamp_radius(1080, 1080, True)
    assert (2 * r_int) ** 2 == 36 and tools.stamp_radius(H, H, True)[1] == 3
    counts = aggs["scanimate.batch"]["counts"]
    assert counts["scanimate.dots"] == dots
    assert counts["scanimate.stamp_cells"] == cells
    assert aggs["scanimate.splat"]["counts"]["scanimate.stamp_cells"] == cells
    diff = {k: v - c0.get(k, 0) for k, v in snap["counters"].items()}
    assert diff["scanimate.stamp_cells"] == cells
    # nothing crosses to a card on the CPU
    assert not any(k.endswith(".scanimate") for k in diff if diff[k])


def test_nothing_is_recorded_untraced():
    log.tracing(False)
    log.reset()
    cells = log.snapshot()["counters"].get("scanimate.stamp_cells", 0)
    _render(_args(), _pool(2 ** 32 + 7, 2), 8)
    snap = log.snapshot()
    assert snap["spans"] == [] and snap["aggregates"] == {}
    # counters always count
    assert snap["counters"]["scanimate.stamp_cells"] > cells


# ----------------------------------------------------------- the check

@pytest.fixture(scope="module")
def spec():
    return spec_mod.Spec.load(os.path.dirname(BENCH))


def _run(spec, entry=None):
    return core.run_cell(spec, CELL, 2 ** 31 + 1001, 0.3, False,
                         core.Clock(), {}, device="cpu",
                         overrides=drv.small(spec, CELL), entry=entry)


def test_the_check_reads_the_program_correct(spec):
    r = _run(spec)
    assert r["correct"], r["check"]
    # a batch of 8 fields of each of the 4 effects
    assert r["_sampled_fields"] == 32 and r["failed"] == 0


@pytest.mark.parametrize("name", ["control"] + sorted(drv.FAULTS))
def test_the_check_reads_control_and_faults_not_correct(spec, name):
    entry = (drv.control(spec.config(CONFIG)) if name == "control"
             else drv.FAULTS[name])
    r = _run(spec, entry)
    assert not r["correct"], r["check"]
    assert r["check"]["worst_field_mismatch_pct"]["value"] > 0
