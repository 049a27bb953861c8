"""The port's eleven host-only commands against the JAX CLI on the same
input: posterize, colormap, colorkey, average-delay, frameblend, filmac,
vhsled, normalize-ts, vaporwave, repo-update-all and repo-source-pickup.

- The eight video tools on tests/test_cli.make_clip: Y4M bytes equal to
  the JAX CLI's, through the native cvsim-av loop (the restore tools'
  default) and with CVSIM_NO_NATIVE_TOOL=1 (the Python loops), with
  `--device` given to the port and ignored.
- Upscales: the port's frame scaler clamps the lerp to 0..255 where a
  weight is negative (every tool inherits the clamp), so a hard
  edge at the first column of an upscaled clip leaves the JAX package's
  range; the outputs are equal wherever no lerp weight is negative.
- normalize-ts's `-pts-out` log and vaporwave's stdout, byte for byte;
  every tool's `-h` answer.
- The repo tools on a temporary git repo, as tests/test_repo_maint.py.
"""

import io
import os
import subprocess
import sys

import numpy as np
import pytest

from cvsim_tpu.cli.main import main as jmain
from cvsim_tpu.host import ffmpeg_pipe as jffmpeg_pipe
from cvsim_tpu_torch.cli.main import main
from cvsim_tpu_torch.host import batching, ffmpeg_pipe, y4m
from tests.test_cli import H, W, make_clip, read_all
from tests.test_repo_maint import _make_repo

VIDEO_TOOLS = {
    "posterize": ["-width", str(W), "-threshhold", "3"],
    "colormap": ["-width", str(W)],
    "colorkey": ["-width", str(W), "-color", "0x101010", "-threshhold", "40",
                 "-f", "16", "-d", "4", "-noise", "3000", "-xd", "3",
                 "-i", "SRC", "-color", "0xc8c8c8", "-inv", "1"],
    "average-delay": ["-width", str(W), "-d", "2", "-n", "64"],
    "frameblend": ["-or", "24", "-sqnr", "-gamma", "2.2"],
    "filmac": ["-gamma", "vga"],
    "vhsled": ["-underscan", "10"],
    "normalize-ts": [],
}


def _run_both(tmp_path, argv, name):
    """(port bytes, JAX bytes) of one command whose output is -o."""
    outs = []
    for run, tag in ((lambda a: main(["--device", "cpu", *a]), "port"),
                     (jmain, "jax")):
        out = str(tmp_path / f"{name}-{tag}.y4m")
        assert run(argv + ["-o", out]) == 0
        with open(out, "rb") as f:
            outs.append(f.read())
    return outs


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    d = tmp_path_factory.mktemp("clips")
    return (make_clip(str(d / "in.y4m")),
            make_clip(str(d / "map.y4m"), frames=1, seed=5))


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
@pytest.mark.parametrize("tool", list(VIDEO_TOOLS))
def test_video_tool_bytes_equal_jax(tool, native, clips, tmp_path,
                                    monkeypatch):
    if not native:
        monkeypatch.setenv("CVSIM_NO_NATIVE_TOOL", "1")
    elif tool in ("frameblend", "filmac", "vhsled"):
        assert ffmpeg_pipe.av_tool() is not None
        assert jffmpeg_pipe.av_tool() is not None
    src, mp = clips
    inputs = ["-i", mp, "-i", src] if tool == "colormap" else ["-i", src]
    flags = [src if f == "SRC" else f for f in VIDEO_TOOLS[tool]]
    port, jax_ = _run_both(tmp_path, [tool, *inputs, *flags], tool)
    assert len(port) > 1000 and port == jax_


def _edge_clip(path, frames=2):
    """White first column on black: an upscale's first samples
    extrapolate past 255 (weight < 0 on the edge)."""
    from fractions import Fraction

    hdr = y4m.Y4MHeader(width=W, height=H, fps=Fraction(30000, 1001))
    rng = np.random.default_rng(3)
    with open(path, "wb") as f:
        wr = y4m.Y4MWriter(f, hdr)
        for _ in range(frames):
            yp = np.full((H, W), 16, np.uint8)
            yp[:, 0] = 235
            yp[:, W // 2:] = rng.integers(16, 236, (H, W - W // 2))
            uv = rng.integers(100, 156, (H // 2, W // 2), dtype=np.uint8)
            wr.write(yp, uv, uv)
    return path


@pytest.mark.parametrize("argv", [
    ["posterize", "-width", "300", "-threshhold", "2"],
    ["average-delay", "-width", "300", "-d", "2", "-n", "100"],
    ["frameblend", "-width", "300", "-height", "200", "-or", "24"]],
    ids=["posterize", "average-delay", "frameblend"])
def test_upscaled_tool_equal_jax_where_no_weight_is_negative(argv,
                                                             tmp_path):
    """Equal on every row and column whose lerps have no negative weight;
    on the first column and row, where the original's luma leaves 0..255,
    the outputs differ."""
    src = _edge_clip(str(tmp_path / "edge.y4m"))
    port, jax_ = (read_all(p)[1] for p in (
        _out_of(main, ["--device", "cpu", *argv], src, tmp_path, "port"),
        _out_of(jmain, argv, src, tmp_path, "jax")))
    assert len(port) == len(jax_) > 0
    h, w = port[0][0].shape
    cols = batching.hscale_consts(W, w)[2] >= 0
    rows = batching.hscale_consts(H, h)[2] >= 0
    assert not cols.all() and not rows.all()
    differs = False
    for (py, _, _), (jy, _, _) in zip(port, jax_):
        np.testing.assert_array_equal(py[rows][:, cols], jy[rows][:, cols])
        differs |= bool((py != jy).any())
    assert differs


def _out_of(run, argv, src, tmp_path, tag):
    out = str(tmp_path / f"up-{tag}.y4m")
    assert run([*argv, "-i", src, "-o", out]) == 0
    return out


PTS_LOG = ("0 1000\n1 10\n0 2000\n1 20\n0 3000\n1 5\n0 1500\n0 2500\n"
           "0 103000\n0 104000\n1 30\n0 none\n")


def test_normalize_ts_pts_log_equal_jax(clips, tmp_path):
    src, _ = clips
    log = tmp_path / "pts.txt"
    log.write_text(PTS_LOG)
    norms = []
    for run, tag in ((lambda a: main(["--device", "cuda", *a]), "port"),
                     (jmain, "jax")):
        norm = tmp_path / f"norm-{tag}.txt"
        assert run(["normalize-ts", "-i", src, "-o",
                    str(tmp_path / f"o-{tag}.y4m"), "-pts-in", str(log),
                    "-pts-out", str(norm), "-maxfwd", "4000"]) == 0
        norms.append(norm.read_bytes())
    assert norms[0] == norms[1]
    assert b"0 4000\n" in norms[0]


def test_vaporwave_stdout_equal_jax(capsys, monkeypatch):
    outs = []
    for run in (main, jmain):
        assert run(["vaporwave", "Hello,", "world! 123"]) == 0
        monkeypatch.setattr(sys, "stdin", io.StringIO("a b\n~{}\n"))
        assert run(["vaporwave"]) == 0
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] and "Ｈｅｌｌｏ" in outs[0]


@pytest.mark.parametrize("tool", [*VIDEO_TOOLS, "cassette", "scanimate",
                                  "raw28ntsc"])
def test_help_equal_jax(tool, capsys):
    answers = []
    for run in (lambda a: main(["--device", "cpu", *a]), jmain):
        try:
            rc = run([tool, "-h"])
        except SystemExit as e:
            rc = e.code
        cap = capsys.readouterr()
        # the two CLIs name themselves differently in their error lines
        answers.append((rc, cap.out, cap.err.replace("cvsim_tpu_torch ",
                                                     "cvsim ")))
    assert answers[0][0] == answers[1][0] == 1
    assert answers[0] == answers[1]


def test_repo_tools(tmp_path, capsys):
    repo = _make_repo(tmp_path)
    (repo / "x.txt").write_text("x\n")
    assert main(["repo-update-all", "-no-push", "-C", str(repo), "-m",
                 "via the port"]) == 0
    log = subprocess.run(["git", "-C", str(repo), "log", "-1",
                          "--format=%s"], capture_output=True,
                         text=True).stdout.strip()
    assert log == "via the port"
    assert "updated branch main (no push)" in capsys.readouterr().out
    if not any(os.access(os.path.join(p, "xz"), os.X_OK)
               for p in os.environ.get("PATH", "").split(os.pathsep) if p):
        return
    dest = tmp_path / "dest"
    dest.mkdir()
    assert main(["repo-source-pickup", "-C", str(repo), "-o",
                 str(dest)]) == 0
    packed = capsys.readouterr().out
    assert "packed: " in packed
    # the JAX tool names the same archive, so it skips
    assert jmain(["repo-source-pickup", "-C", str(repo), "-o",
                  str(dest)]) == 0
    assert "already exists" in capsys.readouterr().out
    assert main(["repo-update-all", "-bogus"]) == 1
