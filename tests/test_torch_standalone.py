"""The port stands alone: no module of cvsim_tpu_torch (and not
chip_smoke.py) imports jax or the JAX package, and the port's copies of
the JAX package's device-free modules (config, presets, host I/O, the
native frame scaler) behave byte for byte as the originals.

- An AST scan of every source file for `jax` / `cvsim_tpu` imports.
- A subprocess with sys.modules["cvsim_tpu"] = sys.modules["jax"] = None
  imports every module of the port and runs its CLI with --device cpu:
  both video tools, `cassette`, `to-composite -audio-in`, `raw28ntsc`,
  `scanimate`, `posterize`, `frameblend`, `normalize-ts`, and a command
  served by `serve -prime`.
- A subprocess with sys.modules["torch"] = None runs every host-only
  command (the JAX package's own split: those tools do no device work).
- The copies against the originals on the same inputs: flag parsing,
  config reprs and checkpoint hashes, Y4M bytes, the frame scaler, the
  render and hscale tables, the field-row math and the colour matrices,
  the audio host helpers (buzz counts, pad fill, resamplers, remix), the
  cassette presets and `cassette`'s flag parser, the raw decoder's host
  half (the numpy twins of the sync scan under docstrings of their own)
  and DC tracker (the original native/hostio.cpp byte for byte, the
  port's sync scan after it), the sibling
  tools' flag parser and frame loops, and the RGB->YUV output
  conversion; the host tools' modules (ops/noise_np, models/tools_np,
  the numpy half of models/restore, utils/vaporwave, utils/repo_maint,
  utils/log's host half, the rest of cli/tools.py, hostpix's four
  restore wrappers), function by function with the package name
  normalized. All exact.
"""

import ast
import dataclasses
import inspect
import io
import subprocess
import sys
import time
from fractions import Fraction
from pathlib import Path

import numpy as np
import pytest

from cvsim_tpu import config as jconfig
from cvsim_tpu import presets as jpresets
from cvsim_tpu.audio import cassette as jcassette
from cvsim_tpu.audio import chains as jchains
from cvsim_tpu.cli import toolargs as jtoolargs
from cvsim_tpu.cli import tools as jtools
from cvsim_tpu.host import batching as jbatching
from cvsim_tpu.host import checkpoint as jcheckpoint
from cvsim_tpu.host import colorconv as jcolorconv
from cvsim_tpu.host import fieldops as jfieldops
from cvsim_tpu.host import pipeline as jpipeline
from cvsim_tpu.host import timing as jtiming
from cvsim_tpu.host import y4m as jy4m
from cvsim_tpu.host import wavio as jwavio
from cvsim_tpu.models import raw28 as jraw28
from cvsim_tpu import native as jnative
from cvsim_tpu.native import hostpix as jhostpix
from cvsim_tpu_torch import config, interop, native, presets
from cvsim_tpu_torch.audio import cassette, chains
from cvsim_tpu_torch.cli import toolargs, tools
from cvsim_tpu_torch.host import (batching, checkpoint, colorconv, fieldops,
                                  pipeline, timing, y4m)
from cvsim_tpu_torch.models import raw28
from cvsim_tpu_torch.native import hostpix
from cvsim_tpu_torch.testing import (BENCH_GEN1_EP, GEN1_CHAIN_CONFIGS,
                                     reference_config)
from tests.test_cli import W, make_clip, read_all

ROOT = Path(__file__).resolve().parent.parent
SOURCES = sorted(str(p.relative_to(ROOT))
                 for p in (ROOT / "cvsim_tpu_torch").rglob("*.py")) + [
    "chip_smoke.py"]
FORBIDDEN = ("jax", "cvsim_tpu")


def _imported_roots(path):
    tree = ast.parse((ROOT / path).read_text(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0], node.lineno


@pytest.mark.parametrize("path", SOURCES)
def test_source_imports_neither_jax_nor_the_jax_package(path):
    bad = [(root, line) for root, line in _imported_roots(path)
           if root in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_port_runs_with_jax_package_unimportable(tmp_path):
    """Every module imports, and the CLI runs (gen-1 through the split-
    route raster check and the debug-tap route, `cassette`,
    `to-composite -audio-in` beside its video, `raw28ntsc`,
    `scanimate -inntsc`, `posterize`, `frameblend`, `normalize-ts`, and
    `to-composite` served by `serve -prime`), with jax and cvsim_tpu made
    unimportable."""
    from tests.test_raw28 import synth_capture

    src = make_clip(str(tmp_path / "in.y4m"))
    raw = str(tmp_path / "cap.raw")
    synth_capture(2).tofile(raw)
    outs = [str(tmp_path / f"out{k}.y4m") for k in range(10)]
    sock = str(tmp_path / "cvsim.sock")
    wavs = [str(tmp_path / f"{name}.wav") for name in ("in", "cas", "vhs")]
    tone = (9000 * np.sin(np.arange(3000) * 0.06)).astype(np.int16)
    jwavio.write_wav(wavs[0], np.stack([tone, tone], -1), 44100)
    code = f"""
import importlib, pkgutil, sys
for name in [m for m in sys.modules
             if m.split(".")[0] in ("jax", "cvsim_tpu")]:
    del sys.modules[name]
sys.modules["jax"] = None
sys.modules["cvsim_tpu"] = None
import cvsim_tpu_torch
names = [m.name for m in pkgutil.walk_packages(cvsim_tpu_torch.__path__,
                                                "cvsim_tpu_torch.")]
for name in names:
    importlib.import_module(name)
from cvsim_tpu_torch.cli.main import main
common = ["-i", {src!r}, "-width", "{W}"]
rcs = [main(["--device", "cpu", "ntsc", *common, "-o", {outs[0]!r}]),
       main(["--device", "cpu", "to-composite", *common, "-o", {outs[1]!r},
             "-tvstd", "pal", "-vhs"]),
       main(["--device", "cpu", "to-composite", *common, "-o", {outs[2]!r},
             "-nocolor-subcarrier"]),
       main(["--device", "cpu", "cassette", "-i", {wavs[0]!r}, "-o",
             {wavs[1]!r}, "-preset", "2"]),
       main(["--device", "cpu", "to-composite", *common, "-o", {outs[3]!r},
             "-vhs", "-audio-in", {wavs[0]!r}, "-audio-out", {wavs[2]!r}]),
       main(["--device", "cpu", "raw28ntsc", "-i", {raw!r}, "-o",
             {outs[4]!r}, "-color"]),
       main(["--device", "cpu", "scanimate", "-i", {src!r}, "-o",
             {outs[5]!r}, "-width", "32", "-inntsc"]),
       main(["--device", "cpu", "posterize", "-i", {src!r}, "-o",
             {outs[6]!r}, "-width", "64"]),
       main(["frameblend", "-i", {src!r}, "-o", {outs[7]!r}, "-or", "24"]),
       main(["normalize-ts", "-i", {src!r}, "-o", {outs[8]!r}])]
import threading
from cvsim_tpu_torch.cli import serve
ready = threading.Event()
t = threading.Thread(target=serve.run_serve, args=(
    ["-socket", {sock!r}, "-one-shot", "-prime"], "cpu", ready))
t.start()
ready.wait(300)
rcs.append(main(["-via", {sock!r}, "--device", "cpu", "to-composite",
                 *common, "-o", {outs[9]!r}, "-vhs"]))
t.join()
assert sys.modules["jax"] is None and sys.modules["cvsim_tpu"] is None
print("MODULES", len(names), "RCS", rcs)
sys.exit(max(rcs))
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "RCS [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0]" in proc.stdout
    n_modules = int(proc.stdout.split("MODULES")[1].split()[0])
    assert n_modules >= len([s for s in SOURCES if s.endswith(".py")]) - 2
    for out in outs:
        assert len(read_all(out)[1]) > 0
    for wav in wavs[1:]:
        assert jwavio.read_wav(wav)[0].shape == (3000, 2)


def test_import_scan_covers_the_audio_slice():
    for path in ("cvsim_tpu_torch/audio/__init__.py",
                 "cvsim_tpu_torch/audio/chains.py",
                 "cvsim_tpu_torch/audio/cassette.py",
                 "cvsim_tpu_torch/cli/tools.py"):
        assert path in SOURCES


ARGVS = [
    [],
    ["-tvstd", "pal"],
    ["-vhs", "-vhs-speed", "ep"],
    ["-tvstd", "pal", "-vhs", "-vhs-speed", "lp", "-width", "640"],
    ["-vhs", "-vhs-speed", "ep", "-vhs-head-switching", "1",
     "-chroma-noise", "16", "-chroma-phase-noise", "4",
     "-chroma-dropout", "4", "-seed", "7"],
    ["-comp-catv2", "-yc-recomb", "2", "-out-composite-lowpass", "1", "-vi"],
    ["-vhs", "-vhs-svideo", "1", "-vhs-chroma-vblend", "0",
     "-bkey-feedback", "20", "-nocolor-subcarrier-after-yc-sep"],
    ["-vhs-speed", "sp", "-vhs", "-vhs-hifi", "0", "-tvstd", "ntsc"],
]


@pytest.mark.parametrize("gen2", [False, True], ids=["gen1", "gen2"])
@pytest.mark.parametrize("argv", ARGVS, ids=[" ".join(a) or "defaults"
                                             for a in ARGVS])
def test_flags_configs_and_hashes_equal_originals(argv, gen2):
    st = presets.parse_composite_flags(argv, gen2=gen2)
    st_j = jpresets.parse_composite_flags(argv, gen2=gen2)
    assert repr(st) == repr(st_j)
    run = st.to_run_config(gen1=not gen2)
    run_j = st_j.to_run_config(gen1=not gen2)
    assert repr(run) == repr(run_j)
    assert checkpoint.config_hash(run, "x") == jcheckpoint.config_hash(
        run_j, "x")
    # the state carried across: either package's config maps onto the
    # other's by field and member name
    assert interop.config_from_reference(run_j.composite) == run.composite
    assert reference_config(run.composite, jconfig) == run_j.composite
    audio = interop.config_from_reference(run_j.audio)
    assert audio == run.audio
    for f in dataclasses.fields(run_j.audio):
        assert getattr(audio, f.name) == getattr(run_j.audio, f.name)


def test_config_module_constants_equal_originals():
    for name in ("NTSC_RATE", "NTSC_RATE_422"):
        assert getattr(config, name) == getattr(jconfig, name)
    assert [(m.name, m.value) for m in config.VHSSpeed] == [
        (m.name, m.value) for m in jconfig.VHSSpeed]
    for rate, cut in ((config.NTSC_RATE, 1.4e6), (config.NTSC_RATE_422, 6e5)):
        assert float(config.iir_alpha(rate, cut)) == float(
            jconfig.iir_alpha(rate, cut))
    for cfg in list(GEN1_CHAIN_CONFIGS.values()) + [BENCH_GEN1_EP]:
        assert repr(reference_config(cfg, jconfig)) == repr(cfg)


@pytest.mark.parametrize("colorspace", ["420jpeg", "422", "444"])
def test_y4m_bytes_equal_originals(colorspace):
    rng = np.random.default_rng(len(colorspace))
    w, h = 48, 20
    hdr, hdr_j = (mod.Y4MHeader(width=w, height=h,
                                fps=Fraction(30000, 1001),
                                colorspace=colorspace)
                  for mod in (y4m, jy4m))
    ch, cw = hdr.chroma_shape
    frames = [(rng.integers(0, 256, (h, w), dtype=np.uint8),
               rng.integers(0, 256, (ch, cw), dtype=np.uint8),
               rng.integers(0, 256, (ch, cw), dtype=np.uint8))
              for _ in range(3)]
    bufs = []
    for mod, hd in ((y4m, hdr), (jy4m, hdr_j)):
        buf = io.BytesIO()
        wr = mod.Y4MWriter(buf, hd)
        for f in frames:
            wr.write(*f)
        bufs.append(buf.getvalue())
    assert bufs[0] == bufs[1]
    for mod in (y4m, jy4m):
        r = mod.Y4MReader(io.BytesIO(bufs[0]))
        got = list(r)
        assert repr(r.header) == repr(hdr)
        for g, f in zip(got, frames):
            for a, b in zip(g, f):
                np.testing.assert_array_equal(a, b)


def _unclamped(n_src: int, n_dst: int, src_ok=None):
    """Mask of the n_dst samples of a bilinear resize from n_src whose
    lerps all have weights >= 0 (the port clamps only the others), given
    the source samples that are themselves unclamped."""
    src_ok = np.ones(n_src, bool) if src_ok is None else src_ok
    c = batching.hscale_consts(n_src, n_dst)
    if c is None:
        return src_ok
    x0, x1, f = c
    return (f >= 0) & src_ok[x0] & src_ok[x1]


@pytest.mark.parametrize("src,dst,chroma", [
    ((96, 128, "420"), (480, 704), "repeat"),
    ((480, 720, "420"), (480, 704), "repeat"),
    ((64, 90, "422"), (40, 200), "bilinear"),
    ((50, 50, "444"), (50, 50), "repeat"),
])
def test_frame_scaler_equals_original(src, dst, chroma):
    """The native scaler equals its numpy twin, stays in 0..255, and
    equals the original wherever no lerp weight is negative (an upscale's
    first rows and columns extrapolate: there the port clamps)."""
    h, w, cs = src
    ch, cw = {"420": (h // 2, w // 2), "422": (h, w // 2), "444": (h, w)}[cs]
    rng = np.random.default_rng(h * w)
    y = rng.integers(0, 256, (h, w), dtype=np.uint8)
    u = rng.integers(0, 256, (ch, cw), dtype=np.uint8)
    v = rng.integers(0, 256, (ch, cw), dtype=np.uint8)
    got = hostpix.scale_frame_to(y, u, v, dst[1], dst[0], chroma)
    want = jhostpix.scale_frame_to(y, u, v, dst[1], dst[0], chroma)
    np.testing.assert_array_equal(
        colorconv.scale_frame_to_np(y, u, v, dst[1], dst[0], chroma), got)
    assert got.min() >= 0 and got.max() <= 255
    up = chroma == "bilinear" and cs != "444"
    rows = _unclamped(h, dst[0], _unclamped(ch, h) if up else None)
    cols = _unclamped(w, dst[1], _unclamped(cw, w) if up else None)
    assert rows.mean() > 0.9 and cols.mean() > 0.9
    np.testing.assert_array_equal(got[rows][:, cols], want[rows][:, cols])


def test_frame_scaler_upscale_stays_in_range():
    """A hard edge at the first column (white, then black), upscaled: the
    original's lerp extrapolates past 255 (which wraps, or indexes past a
    256-entry table, downstream); the port's clamps. Every column is
    constant, so the vertical pass keeps each value and the port equals
    the original clipped to 0..255."""
    h, w = 48, 64
    y = np.full((h, w), 16, np.uint8)
    y[:, 0] = 235
    u = np.full((h // 2, w // 2), 128, np.uint8)
    got = hostpix.scale_frame_to(y, u, u, 2 * w, 2 * h)
    want = jhostpix.scale_frame_to(y, u, u, 2 * w, 2 * h)
    assert want.max() > 255
    assert got.min() >= 0 and got.max() <= 255
    np.testing.assert_array_equal(got, np.clip(want, 0, 255))
    np.testing.assert_array_equal(
        colorconv.scale_frame_to_np(y, u, u, 2 * w, 2 * h), got)


@pytest.mark.parametrize("dst,src_h,chroma_h,interlaced,tff,tpf", [
    (240, 480, 240, False, True, 2),
    (288, 576, 576, True, True, 2),
    (240, 96, 48, True, False, 2),
    (540, 1080, 540, True, True, 4),
])
def test_render_tables_equal_originals(dst, src_h, chroma_h, interlaced,
                                       tff, tpf):
    got = batching.render_index_tables(dst, src_h, chroma_h, interlaced, tff,
                                       tpf)
    want = jbatching.render_index_tables(dst, src_h, chroma_h, interlaced,
                                         tff, tpf)
    for g, wnt in zip(got, want):
        assert g.dtype == wnt.dtype
        np.testing.assert_array_equal(g, wnt)
    for parity in (0, 1):
        for a, b in zip(fieldops.render_field_indices(dst, src_h, chroma_h,
                                                      parity),
                        jfieldops.render_field_indices(dst, src_h, chroma_h,
                                                       parity)):
            np.testing.assert_array_equal(a, b)
        for io_ in (False, True):
            np.testing.assert_array_equal(
                fieldops.bob_rows(2 * dst, parity, io_),
                jfieldops.bob_rows(2 * dst, parity, io_))


@pytest.mark.parametrize("src_w,dst_w", [(720, 704), (704, 720), (128, 128),
                                         (1920, 1888), (96, 640)])
def test_hscale_and_colour_equal_originals(src_w, dst_w):
    got = batching.hscale_consts(src_w, dst_w)
    want = jbatching.hscale_consts(src_w, dst_w)
    if want is None:
        assert got is None
    else:
        for g, wnt in zip(got, want):
            assert g.dtype == wnt.dtype
            np.testing.assert_array_equal(g, wnt)
    rng = np.random.default_rng(src_w)
    planes = [rng.integers(0, 256, (6, src_w)).astype(np.int32)
              for _ in range(3)]
    # equal wherever the lerp does not extrapolate; the port clamps there
    got_p = colorconv.hscale_bilinear_np(planes[0], dst_w)
    want_p = jcolorconv.hscale_bilinear_np(planes[0], dst_w)
    cols = _unclamped(src_w, dst_w)
    np.testing.assert_array_equal(got_p[:, cols], want_p[:, cols])
    np.testing.assert_array_equal(got_p, np.clip(want_p, 0, 255))
    for fn in ("rgb_to_yuv601_np", "yuv_to_rgb601_np"):
        for a, b in zip(getattr(colorconv, fn)(*planes),
                        getattr(jcolorconv, fn)(*planes)):
            np.testing.assert_array_equal(a, b)


def test_field_clock_equals_original():
    fps, rate = Fraction(24000, 1001), Fraction(60000, 1001)
    clocks = [mod.FrameClock(fps, rate) for mod in (timing, jtiming)]
    for idx in range(0, 40, 3):
        assert clocks[0].seconds(idx) == clocks[1].seconds(idx)
        assert clocks[0].fields(idx, 0) == clocks[1].fields(idx, 0)
        assert (timing.frame_pts_to_field(idx, fps, rate)
                == jtiming.frame_pts_to_field(idx, fps, rate))


# the audio host helpers, copied from the JAX package (numpy, float64)
AUDIO_COPIES = [
    (chains.buzz_pulse_counts, jchains.buzz_pulse_counts),
    (pipeline._audio_pad_fill, jpipeline._audio_pad_fill),
    (pipeline._resample_linear, jpipeline._resample_linear),
    (pipeline._resample_sinc, jpipeline._resample_sinc),
    (pipeline._remix, jpipeline._remix),
]


@pytest.mark.parametrize("copy,original", AUDIO_COPIES,
                         ids=[c.__name__ for c, _ in AUDIO_COPIES])
def test_audio_helper_sources_equal_originals(copy, original):
    assert inspect.getsource(copy) == inspect.getsource(original)


def _audio_samples(n, c, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(-32768, 32768, (n, c)).astype(np.int64)


AUDIO_CASES = {
    "buzz-ntsc": lambda m: m[0](config.AudioConfig(), 7, 3000),
    "buzz-pal-48k-late": lambda m: m[0](
        config.AudioConfig(ntsc=False, rate=48000), 2 ** 33 + 5, 3000),
    "pad-fill": lambda m: m[1](_audio_samples(5000, 2, 1),
                               [(0, 2000), (3000, 1000), (3900, 1000),
                                (None, 500), (9000, 700)], 44100),
    "pad-fill-log-rate": lambda m: m[1](_audio_samples(5000, 2, 2),
                                        [(0, 1920), (2880, 960)], 44100,
                                        log_rate=48000),
    "linear-up": lambda m: m[2](_audio_samples(700, 2, 3), 32000, 44100),
    "sinc-48k-44k": lambda m: m[3](_audio_samples(4800, 2, 4), 48000, 44100),
    "sinc-32k-44k-mono": lambda m: m[3](_audio_samples(3200, 1, 5), 32000,
                                        44100),
    "sinc-short": lambda m: m[3](_audio_samples(40, 2, 6), 48000, 44100),
    "sinc-big-block": lambda m: m[3](_audio_samples(72000, 2, 7), 48000,
                                     44100),
    "remix-mono": lambda m: m[4](_audio_samples(100, 2, 8), 1),
    "remix-quad": lambda m: m[4](_audio_samples(100, 2, 9), 4),
    "remix-cut": lambda m: m[4](_audio_samples(100, 6, 10), 2),
}


@pytest.mark.parametrize("case", list(AUDIO_CASES))
def test_audio_helpers_equal_originals(case):
    got = AUDIO_CASES[case]([c for c, _ in AUDIO_COPIES])
    want = AUDIO_CASES[case]([o for _, o in AUDIO_COPIES])
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_cassette_config_and_presets_equal_originals():
    assert cassette.CASSETTE_PRESETS == jcassette.CASSETTE_PRESETS
    assert (cassette.CassetteConfig._field_defaults
            == jcassette.CassetteConfig._field_defaults)
    for p, kw in jcassette.CASSETTE_PRESETS.items():
        cfg_j = jcassette.CassetteConfig(**kw)
        cfg = interop.cassette_config_from_reference(cfg_j)
        assert tuple(cfg) == tuple(cfg_j)
        assert (cfg.kernel_len, cfg.hiss_level) == (cfg_j.kernel_len,
                                                    cfg_j.hiss_level)


def _flag_loop(fn):
    src = inspect.getsource(fn)
    return src[src.index("    kw = dict()"):src.index("    cfg = CassetteConfig(")]


@pytest.mark.parametrize("argv", [
    ["-h"], ["-i", "a.wav"], ["-o", "b.wav", "-bogus"],
    ["-i", "a.wav", "-preset", "9", "-o", "b.wav"]],
    ids=["help", "no-output", "unknown-switch", "bad-preset"])
def test_cassette_flag_parser_equals_original(argv, capsys):
    """run_cassette's flag loop is the original's text, and both answer a
    bad command line alike before touching any file."""
    assert _flag_loop(tools.run_cassette) == _flag_loop(jtools.run_cassette)
    results = []
    for run in (lambda a: tools.run_cassette(a, "cpu"),
                jtools.run_cassette):
        try:
            rc = run(list(argv))
        except KeyError as e:
            rc = f"KeyError {e}"
        results.append((rc, capsys.readouterr().err))
    assert results[0] == results[1]


def test_import_scan_covers_the_raw28_and_scanimate_slice():
    for path in ("cvsim_tpu_torch/models/raw28.py",
                 "cvsim_tpu_torch/models/tools.py",
                 "cvsim_tpu_torch/cli/raw28.py",
                 "cvsim_tpu_torch/cli/toolargs.py",
                 "cvsim_tpu_torch/native/__init__.py"):
        assert path in SOURCES


def test_hostio_source_equals_original():
    """The port's hostio.cpp is the original's bytes (the DC tracker),
    then the sync scan the original has not."""
    for name in ("hostio.cpp",):
        port = (ROOT / "cvsim_tpu_torch" / "native" / name).read_bytes()
        orig = (ROOT / "cvsim_tpu" / "native" / name).read_bytes()
        assert port.startswith(orig)
        assert b"hsync_dc" not in port[len(orig):]


def test_dc_tracker_equals_original():
    """The port's HsyncDcTracker (its own build of hostio.cpp) against
    the original on one field of capture fed in two chunks."""
    from tests.test_raw28 import RL, synth_capture

    t = raw28.RawTiming(raw28.rate_preset("ntsc28"))
    args = (t.sample_rate, t.one_scanline_time, t.one_frame_time)
    port, orig = native.HsyncDcTracker(*args), jnative.HsyncDcTracker(*args)
    assert port._native is not None
    sig = synth_capture(1)
    for part in (sig[:RL * 100], sig[RL * 100:]):
        for a, b in zip(port.process(part), orig.process(part)):
            np.testing.assert_array_equal(a, b)


# the raw decoder's host half, copied from the JAX package (numpy)
RAW28_COPIES = ["RawTiming", "rate_preset", "runs_below", "AGCState",
                "hunt_vsync", "relock_hsync", "equalize_lut"]
# the numpy twins of the native sync scan: the originals' code, under a
# docstring (and for the hunt a name) of their own
RAW28_TWINS = {"hunt_vsync": "hunt_vsync_numpy",
               "relock_hsync": "relock_hsync"}


def _code(fn) -> str:
    """fn's syntax tree without its name and docstring."""
    tree = ast.parse(inspect.getsource(fn)).body[0]
    tree.name = "_"
    body = tree.body
    if (isinstance(body[0], ast.Expr) and isinstance(body[0].value,
                                                     ast.Constant)):
        tree.body = body[1:]
    return ast.dump(tree)


@pytest.mark.parametrize("name", RAW28_COPIES)
def test_raw28_host_sources_equal_originals(name):
    if name in RAW28_TWINS:
        assert (_code(getattr(raw28, RAW28_TWINS[name]))
                == _code(getattr(jraw28, name)))
    else:
        assert (inspect.getsource(getattr(raw28, name))
                == inspect.getsource(getattr(jraw28, name)))


# the sibling tools' scaffold, copied from cvsim_tpu/cli/tools.py
TOOL_COPIES = ["_AsyncWriter", "_finalizing", "_open_tool_writer",
               "_last_frame", "_scale_underscan", "_write_rgb"]


@pytest.mark.parametrize("name", TOOL_COPIES)
def test_tool_scaffold_sources_equal_originals(name):
    assert (inspect.getsource(getattr(tools, name))
            == inspect.getsource(getattr(jtools, name)))


@pytest.mark.parametrize("multi", [False, True], ids=["first", "multi"])
def test_advance_fields_yields_as_original(multi, tmp_path):
    """The port's _advance_fields (its loop in _advance_readers, over
    readers a caller may also hand in) yields the original's (frames,
    field number) sequence: two inputs at their own rates and sizes,
    one of them mono, in lockstep at the output field rate, scaled down
    and underscanned (upscaled, the port's scaler clamps at the edges
    where the original's extrapolates)."""
    rng = np.random.default_rng(12)
    paths = []
    for k, (w, h, fps, cs, n) in enumerate([
            (8, 480, Fraction(30000, 1001), "420jpeg", 5),
            (10, 480, Fraction(25, 1), "mono", 3)]):
        path = str(tmp_path / f"in{k}.y4m")
        with open(path, "wb") as f:
            hdr = y4m.Y4MHeader(width=w, height=h, fps=fps, colorspace=cs)
            wr = y4m.Y4MWriter(f, hdr)
            ch, cw = hdr.chroma_shape
            for _ in range(n):
                planes = [rng.integers(0, 256, (h, w), dtype=np.uint8)]
                if ch:
                    planes += [rng.integers(0, 256, (ch, cw), dtype=np.uint8)
                               for _ in range(2)]
                wr.write(*planes)
        paths.append(path)
    argv = ["-i", paths[0], "-i", paths[1], "-width", "8"]
    extra = {"underscan": (int, "underscan")}
    runs = []
    for targs, mod in ((toolargs, tools), (jtoolargs, jtools)):
        args = targs.ToolArgs(argv + ["-underscan", "25"], extra=extra)
        runs.append([([None if f is None else np.array(f) for f in frames],
                      cur) for frames, cur in mod._advance_fields(args,
                                                                  multi)])
    got, want = runs
    assert len(got) == len(want) >= 8
    for (gf, gc), (wf, wc) in zip(got, want):
        assert gc == wc and len(gf) == len(wf)
        for g, w in zip(gf, wf):
            np.testing.assert_array_equal(g, w)


TOOL_ARGVS = [
    [],
    ["-i", "a.y4m", "-o", "b.y4m", "-width", "64", "-422"],
    ["-i", "a.y4m", "-inntsc", "-tvstd", "1080p60", "-o", "b.mp4"],
    ["-tvstd", "720p60", "-i", "a", "-i", "b", "-d", "3", "-420"],
    ["-tvstd", "pal", "-width", "640", "-i", "x"],
    ["-i", "a", "-bogus"],
    ["-d", "0"],
    ["-tvstd", "secam"],
    ["-h"],
    ["positional"],
]


@pytest.mark.parametrize("argv", TOOL_ARGVS,
                         ids=[" ".join(a) or "none" for a in TOOL_ARGVS])
def test_tool_args_parse_like_original(argv):
    """ToolArgs (with scanimate's -inntsc) parses, or refuses, every
    command line as the original does; parse_gamma and parse_rate too."""
    extra = {"inntsc": ("flag", "inntsc")}
    results = []
    for mod in (toolargs, jtoolargs):
        try:
            a = mod.ToolArgs(list(argv), extra=extra)
            results.append(("ok", a.inputs, a.output, a.width, a.height,
                            a.width_set, a.height_set, a.field_rate,
                            a.use_422, a.delay, a.per_input, a.extra))
        except (ValueError, IndexError) as e:
            results.append((type(e).__name__, str(e)))
    assert results[0] == results[1]
    for v in ("vga", "1.8"):
        assert toolargs.parse_gamma(v) == jtoolargs.parse_gamma(v)
    for v in ("30000:1001", "24/1", "2", "59.94"):
        assert toolargs.parse_rate(v) == jtoolargs.parse_rate(v)


def test_rgb_to_yuv_planes_equals_original():
    rng = np.random.default_rng(4)
    rgb = rng.integers(0, 256, (31, 45, 3)).astype(np.int32)
    for a, b in zip(hostpix.rgb_to_yuv_planes(rgb),
                    jhostpix.rgb_to_yuv_planes(rgb)):
        assert a.dtype == b.dtype == np.uint8
        np.testing.assert_array_equal(a, b)


def test_import_scan_covers_the_host_tools_slice():
    for path in ("cvsim_tpu_torch/ops/noise_np.py",
                 "cvsim_tpu_torch/models/tools_np.py",
                 "cvsim_tpu_torch/models/restore.py",
                 "cvsim_tpu_torch/cli/serve.py",
                 "cvsim_tpu_torch/utils/log.py",
                 "cvsim_tpu_torch/utils/vaporwave.py",
                 "cvsim_tpu_torch/utils/repo_maint.py",
                 "cvsim_tpu_torch/__main__.py"):
        assert path in SOURCES


def test_host_commands_run_with_torch_unimportable(tmp_path):
    """Every host-only command, with torch made unimportable (and jax and
    cvsim_tpu too), `--device cuda` given and ignored: the restore tools
    through cvsim-av and through the Python loops."""
    from tests.test_repo_maint import _make_repo

    src = make_clip(str(tmp_path / "in.y4m"), frames=2)
    repo = _make_repo(tmp_path)
    (repo / "new.txt").write_text("x\n")
    out = lambda k: str(tmp_path / f"o{k}.y4m")
    code = f"""
import os, sys
for name in [m for m in sys.modules
             if m.split(".")[0] in ("jax", "cvsim_tpu", "torch")]:
    del sys.modules[name]
sys.modules["jax"] = sys.modules["cvsim_tpu"] = sys.modules["torch"] = None
from cvsim_tpu_torch.cli.main import main
src = {src!r}
tools = [
    ["posterize", "-i", src, "-o", {out(1)!r}],
    ["colormap", "-i", src, "-i", src, "-o", {out(2)!r}],
    ["colorkey", "-i", src, "-o", {out(3)!r}, "-color", "0x101010",
     "-noise", "500"],
    ["average-delay", "-i", src, "-o", {out(4)!r}, "-d", "2"],
    ["frameblend", "-i", src, "-o", {out(5)!r}, "-or", "24"],
    ["filmac", "-i", src, "-o", {out(6)!r}, "-gamma", "vga"],
    ["vhsled", "-i", src, "-o", {out(7)!r}],
    ["normalize-ts", "-i", src, "-o", {out(8)!r}],
    ["vaporwave", "abc"],
    ["repo-update-all", "-no-push", "-C", {str(repo)!r}],
    ["repo-source-pickup", "-C", {str(repo)!r}, "-o", {str(tmp_path)!r}],
]
rcs = [main(["--device", "cuda", *argv]) for argv in tools]
os.environ["CVSIM_NO_NATIVE_TOOL"] = "1"
rcs += [main(["--device", "cuda", *argv]) for argv in tools[4:7]]
assert sys.modules["torch"] is None
print("RCS", rcs)
sys.exit(max(rcs))
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "RCS " + str([0] * 14) in proc.stdout
    for k in range(1, 9):
        assert len(read_all(out(k))[1]) > 0


def _normalized_source(obj):
    """The source of obj with the port's package name written as the
    original's."""
    return inspect.getsource(obj).replace("cvsim_tpu_torch", "cvsim_tpu")


def _code_of(fn):
    """fn's source parsed, its docstring dropped (the copies keep the
    code and say what they are in their own words)."""
    tree = ast.parse(_normalized_source(fn)).body[0]
    if ast.get_docstring(tree) is not None:
        tree.body = tree.body[1:]
    return ast.dump(tree)


from cvsim_tpu.cli import serve as jserve  # noqa: E402
from cvsim_tpu.models import restore as jrestore  # noqa: E402
from cvsim_tpu.models import tools_np as jtools_np  # noqa: E402
from cvsim_tpu.ops import noise_np as jnoise_np  # noqa: E402
from cvsim_tpu.utils import log as jlog  # noqa: E402
from cvsim_tpu.utils import repo_maint as jrepo_maint  # noqa: E402
from cvsim_tpu.utils import vaporwave as jvaporwave  # noqa: E402
from cvsim_tpu_torch.cli import serve as serve_mod  # noqa: E402
from cvsim_tpu_torch.models import restore, tools_np  # noqa: E402
from cvsim_tpu_torch.ops import noise_np  # noqa: E402
from cvsim_tpu_torch.utils import log, repo_maint, vaporwave  # noqa: E402

HOST_COPIES = (
    [(noise_np, jnoise_np, n) for n in ("mix32", "bits", "randint_bits",
                                        "randint_stream",
                                        "field_stage_key")]
    + [(tools_np, jtools_np, n) for n in (
        "posterize", "take_colormap", "colormap_apply", "colorkey_apply",
        "average_delay_blend", "frameblend_mix", "filmac_measure",
        "filmac_rescale", "vhsled_dejitter")]
    + [(restore, jrestore, n) for n in ("gamma_tables",
                                        "frameblend_weights", "FilmacState",
                                        "filmac_update_levels")]
    + [(vaporwave, jvaporwave, n) for n in ("to_vaporwave", "main")]
    + [(repo_maint, jrepo_maint, n) for n in (
        "_git", "current_branch", "_clean_build_tree", "update_all",
        "source_pickup", "main_update_all", "main_source_pickup")]
    + [(log, jlog, "get_logger")]
    + [(tools, jtools, n) for n in (
        "_frame_loop", "_frame_loop_1to1", "run_posterize", "run_colormap",
        "run_colorkey", "run_average_delay", "run_frameblend",
        "_run_frameblend_loop", "run_filmac", "run_vhsled",
        "run_normalize_ts", "_open_video_inputs", "_open_video_output")]
    + [(hostpix, jhostpix, n) for n in (
        "vhsled_dejitter", "frameblend_mix", "filmac_measure",
        "filmac_rescale")]
    + [(serve_mod, jserve, "_TeeErr")])


@pytest.mark.parametrize("copy,original,name", HOST_COPIES,
                         ids=[f"{c.__name__.split('.')[-1]}.{n}"
                              for c, _, n in HOST_COPIES])
def test_host_tool_sources_equal_originals(copy, original, name):
    assert (_normalized_source(getattr(copy, name))
            == _normalized_source(getattr(original, name)))


@pytest.mark.parametrize("name", ["proc_age", "phase", "stream_id"])
def test_host_tool_code_equals_original_but_for_docstrings(name, monkeypatch,
                                                           capsys):
    copy, original = ((noise_np, jnoise_np) if name == "stream_id"
                      else (log, jlog))
    if name == "stream_id":
        # the copy takes raw key words only: no jax key to unwrap
        for key in (7, np.asarray([3, 11], np.uint32), np.uint32(2**32 - 1)):
            assert copy.stream_id(key) == original.stream_id(key)
        return
    if name == "phase":
        # the copy is also an event of the port's recorder; the line it
        # prints is the original's, byte for byte
        monkeypatch.setenv("CVSIM_PHASES", "1")
        monkeypatch.setattr(time, "time", lambda: 1234.5678)
        lines = []
        for mod in (copy, original):
            monkeypatch.setattr(mod, "proc_age", lambda: 2.25)
            mod.phase("first_fetch_done", fields=64, gop=3)
            lines.append(capsys.readouterr().err)
        assert lines[0] == lines[1] == ("[phase] first_fetch_done t=1234.568"
                                        " proc_age=2.250 fields=64 gop=3\n")
        return
    assert _code_of(getattr(copy, name)) == _code_of(getattr(original,
                                                             name))
