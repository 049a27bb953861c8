"""The port's gen-1 `to-composite` tool on the CPU: `python -m
cvsim_tpu_torch --device cpu to-composite` against the JAX package's
`cvsim to-composite` on the same clip, the black-key carry across GOPs,
checkpoint/resume (and its refusal of an output shorter than the
checkpoint), the device and not-yet-ported errors, and the no-jax import
contract.

Tolerance for output planes: assert_chain_equal (at most 1 LSB on at most
0.1% of samples): float32 products and sin/cos round differently in the
two frameworks. Checkpoint resume is held to byte equality.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from cvsim_tpu.cli.main import main as jax_main
from cvsim_tpu.host import wavio, y4m
from cvsim_tpu.host.pipeline import CompositePipeline as JaxPipeline
from cvsim_tpu.presets import parse_composite_flags
from cvsim_tpu_torch.cli.main import main
from cvsim_tpu_torch.host.pipeline import CompositePipeline
from cvsim_tpu_torch.testing import assert_chain_equal
from tests.test_cli import W, make_clip, read_all

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VHS = ["-vhs", "-vhs-speed", "ep", "-vhs-head-switching", "1",
       "-chroma-noise", "16", "-seed", "7"]
BKEY = ["-vhs", "-vhs-speed", "ep", "-seed", "3", "-bkey-feedback", "20"]


def _assert_outputs_match(out_t, out_j, n_frames):
    hdr_t, frames_t = read_all(out_t)
    hdr_j, frames_j = read_all(out_j)
    assert hdr_t == hdr_j
    assert len(frames_t) == len(frames_j) == n_frames
    for k, (ft, fj) in enumerate(zip(frames_t, frames_j)):
        for pt, pj in zip(ft, fj):
            assert_chain_equal(pt, pj, err_msg=f"frame {k}")


@pytest.mark.parametrize("flags,n_frames", [
    ([], 8),                       # defaults: 4 frames -> 8 bobbed fields
    (VHS, 8),                      # VHS-EP, head switching, chroma noise
    (VHS + ["-vi"], 4),            # interlaced output: one frame per pair
], ids=["defaults", "vhs-ep", "interlaced"])
def test_to_composite_matches_jax(tmp_path, flags, n_frames):
    src = make_clip(str(tmp_path / "in.y4m"))
    out_t = str(tmp_path / "torch.y4m")
    out_j = str(tmp_path / "jax.y4m")
    args = ["-i", src, "-width", str(W), *flags]
    assert main(["--device", "cpu", "to-composite", *args, "-o", out_t]) == 0
    assert jax_main(["to-composite", *args, "-o", out_j]) == 0
    _assert_outputs_match(out_t, out_j, n_frames)


def _flags(extra=()):
    return parse_composite_flags(["-width", str(W), *BKEY, *extra])


def _run(src, out, ckpt_path=None, fail_after=None, mode="wb", jax=False):
    """The gen-1 pipeline with 4-field GOPs (the black-key carry crosses
    every GOP boundary)."""
    cfg = _flags().to_run_config(gen1=True)
    pipe = (JaxPipeline(cfg, gop=4, progress=False) if jax else
            CompositePipeline(cfg, gop=4, progress=False, device="cpu"))
    with open(src, "rb") as fin, open(out, mode) as fout:
        return pipe.run_video(y4m.Y4MReader(fin), fout,
                              ckpt_path=ckpt_path, ckpt_every=1,
                              _fail_after_gops=fail_after)


def test_bkey_feedback_across_gops_matches_jax(tmp_path):
    """-bkey-feedback 20: the filter planes carried over 5 GOPs of 4
    fields, against the JAX pipeline's lax.scan carry."""
    src = make_clip(str(tmp_path / "in.y4m"), frames=10)
    out_t = str(tmp_path / "torch.y4m")
    out_j = str(tmp_path / "jax.y4m")
    assert _run(src, out_t) == _run(src, out_j, jax=True) == 20
    _assert_outputs_match(out_t, out_j, 20)


def test_bkey_feedback_cli_matches_jax(tmp_path):
    src = make_clip(str(tmp_path / "in.y4m"))
    out_t = str(tmp_path / "torch.y4m")
    out_j = str(tmp_path / "jax.y4m")
    args = ["-i", src, "-width", str(W), *BKEY]
    assert main(["--device", "cpu", "to-composite", *args, "-o", out_t]) == 0
    assert jax_main(["to-composite", *args, "-o", out_j]) == 0
    _assert_outputs_match(out_t, out_j, 8)


def test_crash_resume_with_bkey_carry_bit_identical(tmp_path):
    """Kill after two GOPs, rerun: the output equals an uninterrupted run
    byte for byte; the black-key carry comes back from the checkpoint."""
    src = make_clip(str(tmp_path / "in.y4m"), frames=10)
    golden = str(tmp_path / "golden.y4m")
    assert _run(src, golden) == 20
    out = str(tmp_path / "out.y4m")
    ck = out + ".ckpt"
    with pytest.raises(RuntimeError, match="injected"):
        _run(src, out, ckpt_path=ck, fail_after=2)
    assert len(read_all(out)[1]) == 8
    assert _run(src, out, ckpt_path=ck, mode="r+b") == 20
    assert not os.path.exists(ck)
    with open(golden, "rb") as a, open(out, "rb") as b:
        assert a.read() == b.read()


def test_resume_refuses_a_short_output(tmp_path):
    """An output that lost frames after its checkpoint was saved is
    refused on resume instead of being padded with zeros."""
    src = make_clip(str(tmp_path / "in.y4m"), frames=10)
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


def test_cuda_default_without_gpu_fails(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device works")
    src = make_clip(str(tmp_path / "in.y4m"))
    out = str(tmp_path / "out.y4m")
    assert main(["--device", "cuda", "to-composite", "-i", src,
                 "-o", out]) == 1
    assert "no CUDA device" in capsys.readouterr().err
    assert not os.path.exists(out)


@pytest.mark.parametrize("flag", [
    ["-devices", "2"],
    ["-audio-in", "x.wav", "-audio-out", "y.wav"],
], ids=["devices", "audio-in"])
def test_not_yet_ported_errors(tmp_path, capsys, monkeypatch, flag):
    """-devices and -audio-in were once not ported; both are now and run:
    -devices here over a 2-device CPU mesh, -audio-in beside the video
    (relative WAV paths, in the test's directory)."""
    monkeypatch.chdir(tmp_path)
    if flag[0] == "-audio-in":
        tone = (9000 * np.sin(np.arange(3000) * 0.06)).astype(np.int16)
        wavio.write_wav("x.wav", np.stack([tone, tone], -1), 44100)
    src = make_clip(str(tmp_path / "in.y4m"))
    out = str(tmp_path / "out.y4m")
    rc = main(["--device", "cpu", "to-composite", "-i", src, "-o", out,
               *flag])
    err = capsys.readouterr().err
    assert rc == 0 and "not yet ported" not in err
    assert len(read_all(out)[1]) == 8
    if flag[0] == "-audio-in":
        assert wavio.read_wav("y.wav")[0].shape == (3000, 2)


def test_to_composite_imports_no_jax(tmp_path):
    """The port's to-composite path runs with jax made unimportable."""
    src = make_clip(str(tmp_path / "in.y4m"))
    out = str(tmp_path / "out.y4m")
    code = f"""
import sys
for name in [m for m in sys.modules if m == "jax" or m.startswith("jax.")]:
    del sys.modules[name]
sys.modules["jax"] = None
from cvsim_tpu_torch.cli.main import main
rc = main(["--device", "cpu", "to-composite", "-i", {src!r}, "-o", {out!r},
           "-width", "{W}", "-vhs", "-bkey-feedback", "20"])
assert sys.modules["jax"] is None
print("RC", rc)
sys.exit(rc)
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "RC 0" in proc.stdout
    assert len(read_all(out)[1]) == 8
