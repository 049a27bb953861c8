"""The port's CLI and pipeline on the CPU: `python -m cvsim_tpu_torch
--device cpu ntsc` against the JAX package's `cvsim ntsc` on the same
clip, -video-pts-in, the no-jax import contract, the device and
not-yet-ported errors, and checkpoint/resume."""

import os
import subprocess
import sys
from fractions import Fraction

import numpy as np
import pytest
import torch

from cvsim_tpu.cli.main import main as jax_main
from cvsim_tpu.host import wavio, y4m
from cvsim_tpu.presets import parse_composite_flags
from cvsim_tpu_torch.cli.main import main
from cvsim_tpu_torch.host.pipeline_yiq import YIQPipeline
from cvsim_tpu_torch.testing import assert_chain_equal
from tests.test_cli import W, make_clip, read_all

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGS = ["-width", str(W), "-vhs", "-vhs-speed", "ep",
         "-vhs-head-switching", "1", "-chroma-noise", "16",
         "-chroma-phase-noise", "4", "-chroma-dropout", "4000", "-seed", "7"]


def test_cli_matches_jax(tmp_path):
    """Same clip and flags through both packages: every output plane
    within the chain tolerance (assert_chain_equal: at most 1 LSB on at
    most 0.1% of samples — float32 products and sin/cos round differently
    in the two frameworks)."""
    src = make_clip(str(tmp_path / "in.y4m"))
    out_t = str(tmp_path / "torch.y4m")
    out_j = str(tmp_path / "jax.y4m")
    assert main(["--device", "cpu", "ntsc", "-i", src, "-o", out_t,
                 *FLAGS]) == 0
    assert jax_main(["ntsc", "-i", src, "-o", out_j, *FLAGS]) == 0
    hdr_t, frames_t = read_all(out_t)
    hdr_j, frames_j = read_all(out_j)
    assert hdr_t == hdr_j
    assert len(frames_t) == len(frames_j) == 8
    for k, (ft, fj) in enumerate(zip(frames_t, frames_j)):
        for pt, pj in zip(ft, fj):
            assert_chain_equal(pt, pj, err_msg=f"field {k}")


def test_video_pts_in_matches_jax(tmp_path):
    """-video-pts-in (a 3:2 pulldown frame log) drives the shared host
    loop's field clock: with the chain off (-nocomp) both packages write
    the same bytes."""
    durs = [2002, 3003] * 4                      # 8 film frames -> 20 fields
    hdr = y4m.Y4MHeader(width=64, height=48, fps=Fraction(24000, 1001))
    src = str(tmp_path / "in.y4m")
    with open(src, "wb") as f:
        wr = y4m.Y4MWriter(f, hdr)
        for k in range(len(durs)):
            wr.write(np.full((48, 64), 20 + 10 * k, np.uint8),
                     np.full((24, 32), 128, np.uint8),
                     np.full((24, 32), 128, np.uint8))
    log = tmp_path / "frames.pts"
    starts = np.cumsum([0] + durs[:-1])
    log.write_text("rate 60000\n" + "".join(
        f"{p} {d}\n" for p, d in zip(starts, durs)))
    args = ["ntsc", "-i", src, "-nocomp", "-video-pts-in", str(log),
            "-width", "64"]
    out_t, out_j = str(tmp_path / "t.y4m"), str(tmp_path / "j.y4m")
    assert main(["--device", "cpu", *args, "-o", out_t]) == 0
    assert jax_main([*args, "-o", out_j]) == 0
    assert len(read_all(out_t)[1]) == 20
    with open(out_t, "rb") as a, open(out_j, "rb") as b:
        assert a.read() == b.read()


def test_no_jax_import_and_cli(tmp_path):
    """Every module of the port imports, and the CLI runs, with jax made
    unimportable."""
    src = make_clip(str(tmp_path / "in.y4m"))
    out = str(tmp_path / "out.y4m")
    code = f"""
import sys
for name in [m for m in sys.modules if m == "jax" or m.startswith("jax.")]:
    del sys.modules[name]
sys.modules["jax"] = None
import importlib, pkgutil
import cvsim_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(cvsim_tpu_torch.__path__,
                                                "cvsim_tpu_torch.")
        if m.name != "cvsim_tpu_torch.__main__"]
for m in mods:
    importlib.import_module(m)
import chip_smoke
from cvsim_tpu_torch.cli.main import main
rc = main(["--device", "cpu", "ntsc", "-i", {src!r}, "-o", {out!r},
           "-width", "{W}"])
assert sys.modules["jax"] is None
print("MODULES", len(mods), "RC", rc)
sys.exit(rc)
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "RC 0" in proc.stdout
    assert int(proc.stdout.split("MODULES")[1].split()[0]) >= 12
    assert len(read_all(out)[1]) == 8


def test_cuda_default_without_gpu_fails(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device works")
    src = make_clip(str(tmp_path / "in.y4m"))
    out = str(tmp_path / "out.y4m")
    assert main(["ntsc", "-i", src, "-o", out]) == 1
    assert "no CUDA device" in capsys.readouterr().err
    assert not os.path.exists(out)


@pytest.mark.parametrize("flag,msg", [
    (["-devices", "2"], "not yet ported"),
    (["-audio-in", "x.wav", "-audio-out", "y.wav"], "not yet ported"),
])
def test_not_yet_ported_errors(tmp_path, capsys, monkeypatch, flag, msg):
    """-devices and -audio-in were once not ported; both are now and run:
    -devices here over a 2-device CPU mesh, -audio-in beside the video
    (relative WAV paths, in the test's directory)."""
    monkeypatch.chdir(tmp_path)
    if flag[0] == "-audio-in":
        tone = (9000 * np.sin(np.arange(3000) * 0.06)).astype(np.int16)
        wavio.write_wav("x.wav", np.stack([tone, tone], -1), 44100)
    src = make_clip(str(tmp_path / "in.y4m"))
    out = str(tmp_path / "out.y4m")
    rc = main(["--device", "cpu", "ntsc", "-i", src, "-o", out, *flag])
    err = capsys.readouterr().err
    assert rc == 0 and msg not in err
    assert len(read_all(out)[1]) == 8
    if flag[0] == "-audio-in":
        assert wavio.read_wav("y.wav")[0].shape == (3000, 2)


def _run(src, out, ckpt_path=None, fail_after=None, mode="wb"):
    st = parse_composite_flags(["-width", str(W), "-vhs", "-seed", "3"],
                               gen2=True)
    pipe = YIQPipeline(st.to_run_config(gen1=False), gop=4, progress=False,
                       device="cpu")
    with open(src, "rb") as fin, open(out, mode) as fout:
        return pipe.run_video([y4m.Y4MReader(fin)], fout,
                              ckpt_path=ckpt_path, ckpt_every=1,
                              _fail_after_gops=fail_after)


def test_crash_resume_bit_identical(tmp_path):
    """Kill after two GOPs, rerun: the output equals an uninterrupted run
    byte for byte (content-addressed noise + pure-function field clock)."""
    src = make_clip(str(tmp_path / "in.y4m"), frames=6)
    golden = str(tmp_path / "golden.y4m")
    assert _run(src, golden) == 12
    out = str(tmp_path / "out.y4m")
    ck = out + ".ckpt"
    with pytest.raises(RuntimeError, match="injected"):
        _run(src, out, ckpt_path=ck, fail_after=2)
    assert len(read_all(out)[1]) == 8
    assert _run(src, out, ckpt_path=ck, mode="r+b") == 12
    assert not os.path.exists(ck)
    with open(golden, "rb") as a, open(out, "rb") as b:
        assert a.read() == b.read()


def test_resume_refuses_a_short_output(tmp_path):
    """An output that lost frames after its checkpoint was saved (a write
    the disk never kept) is refused on resume instead of being padded with
    zeros; the checkpoint stays for the user to delete."""
    src = make_clip(str(tmp_path / "in.y4m"), frames=6)
    out = str(tmp_path / "out.y4m")
    ck = out + ".ckpt"
    with pytest.raises(RuntimeError, match="injected"):
        _run(src, out, ckpt_path=ck, fail_after=2)
    size = os.path.getsize(out)
    with open(out, "r+b") as f:
        f.truncate(size - 100)
    with pytest.raises(ValueError, match="lost frames"):
        _run(src, out, ckpt_path=ck, mode="r+b")
    assert os.path.getsize(out) == size - 100
    assert os.path.exists(ck)
