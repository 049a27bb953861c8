"""The port's audio commands on the CPU: `python -m cvsim_tpu_torch --device
cpu cassette|to-composite|ntsc -audio-in ...` against the JAX package's
CLI on the same WAVs (the audio twins of tests/test_cli.py), the packet-log
gap fill, the "nowhere to write it" skip, resume skipping a finished WAV,
and video and audio in one `to-composite -vhs` call.

Tolerance for WAV samples and video planes: `assert_chain_equal` (at most
1 LSB on at most 0.1% of samples; float32 in both frameworks). Pad fill
is exact.
"""

import os
import tempfile

import numpy as np
import pytest

from cvsim_tpu.cli.main import main as jax_main
from cvsim_tpu.host import pipeline as jpipeline
from cvsim_tpu.host import wavio
from cvsim_tpu_torch.cli.main import main
from cvsim_tpu_torch.host import checkpoint, pipeline, y4m
from cvsim_tpu_torch.presets import parse_composite_flags
from cvsim_tpu_torch.testing import assert_chain_equal
from tests.test_cli import W, make_clip, read_all


def _tone(n, rate=44100, hz=440.0, channels=2):
    t = np.arange(n)
    sine = (9000 * np.sin(2 * np.pi * hz * t / rate)).astype(np.int16)
    return np.stack([sine, sine[::-1]][:channels], -1)


def _wav(path, n, rate=44100, channels=2):
    wavio.write_wav(str(path), _tone(n, rate, channels=channels), rate)
    return str(path)


def _both(tmp_path, argv, out_flag="-audio-out"):
    """Runs argv through the port (--device cpu) and the JAX CLI, each
    writing its own WAV; returns ((samples, rate) port, (samples, rate)
    JAX)."""
    outs = []
    for name, run in (("torch", lambda a: main(["--device", "cpu", *a])),
                      ("jax", jax_main)):
        out = str(tmp_path / f"{name}.wav")
        assert run([*argv, out_flag, out]) == 0
        outs.append(wavio.read_wav(out))
    return outs


def _assert_wavs_match(got, want):
    assert got[1] == want[1]
    assert got[0].shape == want[0].shape
    assert_chain_equal(got[0], want[0], err_msg="wav")


@pytest.mark.parametrize("flags,n_in,channels", [
    (["-preset", "2", "-mono"], 8000, 2),
    # a preset, then flags that override it; -ss/-t cut the input
    (["-preset", "3", "-headalign", "4", "-low", "9000", "-ss", "0.05",
      "-t", "0.1"], 8000, 2),
    # a mono input repeats to stereo
    (["-preset", "2", "-audio-hiss", "-50", "-preemphasis", "0"], 8000, 1),
], ids=["preset2-mono", "preset-override-window", "mono-input"])
def test_cassette_cli(tmp_path, flags, n_in, channels):
    src = _wav(tmp_path / "in.wav", n_in, channels=channels)
    got, want = _both(tmp_path, ["cassette", "-i", src, *flags], "-o")
    _assert_wavs_match(got, want)
    assert np.abs(got[0]).max() > 100   # signal survived
    if "-mono" in flags:
        np.testing.assert_array_equal(got[0][:, 0], got[0][:, 1])


def test_audio_pts_gap_pad_fill(tmp_path):
    """-audio-pts-in fills a 1000-sample PTS gap with silence and holds a
    small backward jitter; the pad fill equals the JAX package's."""
    ain = _wav(tmp_path / "a.wav", 4000)
    log = tmp_path / "apts.txt"
    log.write_text("0 2000\n3000 1000\n3900 1000\n")
    got, want = _both(tmp_path, ["to-composite", "-audio-in", ain,
                                 "-audio-pts-in", str(log), "-vhs-hifi",
                                 "0"])
    assert len(got[0]) == 5000
    _assert_wavs_match(got, want)
    src = _tone(4000).astype(np.int64)
    pkts = [(0, 2000), (3000, 1000), (3900, 1000)]
    padded = pipeline._audio_pad_fill(src, pkts, 44100)
    np.testing.assert_array_equal(padded[2000:3000], 0)
    np.testing.assert_array_equal(
        padded, jpipeline._audio_pad_fill(src, pkts, 44100))


def test_to_composite_audio_sidecar(tmp_path):
    """Linear VHS audio goes mono; audio only, no -i."""
    ain = _wav(tmp_path / "a.wav", 6000)
    got, want = _both(tmp_path, ["to-composite", "-audio-in", ain,
                                 "-vhs-hifi", "0"])
    assert got[0].shape == (6000, 1)
    _assert_wavs_match(got, want)


def test_ntsc_audio_only_without_output(tmp_path):
    """ntsc with -audio-in and -audio-out but no -o: audio only. The input
    is 48 kHz, so it runs the sinc resampler to 44.1 kHz."""
    ain = _wav(tmp_path / "a.wav", 4800, rate=48000)
    got, want = _both(tmp_path, ["ntsc", "-audio-in", ain])
    assert got[1] == 44100 and len(got[0]) == 4410
    _assert_wavs_match(got, want)


def test_audio_without_mux_target_skips(tmp_path, capfd):
    """-audio-in with a container -o but no video stage: say so and write
    nothing."""
    ain = _wav(tmp_path / "a.wav", 2000)
    out = str(tmp_path / "out.mp4")
    assert main(["--device", "cpu", "to-composite", "-audio-in", ain,
                 "-o", out]) == 0
    assert not os.path.exists(out)
    assert "skipping audio" in capfd.readouterr().err


def test_failed_audio_stage_removes_mux_wav(tmp_path, monkeypatch):
    """The temp WAV made for muxing into a container -o is deleted when
    the audio chain raises."""
    from cvsim_tpu_torch.cli import main as cli
    from cvsim_tpu_torch.host import ffmpeg_pipe

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    monkeypatch.setattr(ffmpeg_pipe, "have_backend", lambda: True)

    class Failing:
        def run_audio(self, *a, **kw):
            raise RuntimeError("decode failed")

    st = parse_composite_flags(["-audio-in", _wav(tmp_path / "a.wav", 100),
                                "-o", str(tmp_path / "out.mp4")])
    st.audio_stream_index = 0
    with pytest.raises(RuntimeError, match="decode failed"):
        cli._run_audio_stage(st, Failing, True, False, True)
    assert not list(tmp_path.glob("cvsim_mux_*"))


def test_audio_pad_fill_skips_durationless_log(capfd):
    s = np.arange(4000, dtype=np.int64)[:, None]
    pkts = [(0, 0), (2000, 0), (3900, 0)]
    out = pipeline._audio_pad_fill(s, pkts, 44100)
    np.testing.assert_array_equal(out, s)
    assert "skipping PTS gap fill" in capfd.readouterr().err


def test_resume_skips_finished_audio(tmp_path, capfd):
    """A resumed -checkpoint run leaves an existing -audio-out alone and
    finishes the video."""
    flags = ["-width", str(W), "-vhs", "-seed", "3"]
    src = make_clip(str(tmp_path / "in.y4m"), frames=10)
    out = str(tmp_path / "out.y4m")
    cfg = parse_composite_flags(list(flags)).to_run_config(gen1=True)
    pipe = pipeline.CompositePipeline(cfg, gop=4, progress=False,
                                      device="cpu")
    with pytest.raises(RuntimeError, match="injected"):
        with open(src, "rb") as fin, open(out, "wb") as fout:
            pipe.run_video(y4m.Y4MReader(fin), fout, ckpt_path=out + ".ckpt",
                           ckpt_every=1, _fail_after_gops=2)
    assert checkpoint.load(out + ".ckpt")
    done = _wav(tmp_path / "done.wav", 100)
    before = open(done, "rb").read()
    ain = _wav(tmp_path / "a.wav", 3000)
    assert main(["--device", "cpu", "to-composite", "-i", src, "-o", out,
                 "-checkpoint", "-audio-in", ain, "-audio-out", done,
                 *flags]) == 0
    assert "audio output already complete; skipping" in capfd.readouterr().err
    assert open(done, "rb").read() == before
    assert not os.path.exists(out + ".ckpt")
    assert len(read_all(out)[1]) == 20


def test_to_composite_vhs_video_and_audio(tmp_path):
    """Video and audio in one `to-composite -vhs` call, both against the
    JAX CLI's."""
    src = make_clip(str(tmp_path / "in.y4m"))
    ain = _wav(tmp_path / "a.wav", 5000)
    outs = {}
    for name, run in (("torch", lambda a: main(["--device", "cpu", *a])),
                      ("jax", jax_main)):
        vout, aout = (str(tmp_path / f"{name}.y4m"),
                      str(tmp_path / f"{name}.wav"))
        assert run(["to-composite", "-i", src, "-o", vout, "-width", str(W),
                    "-vhs", "-seed", "7", "-audio-in", ain, "-audio-out",
                    aout]) == 0
        outs[name] = (read_all(vout), wavio.read_wav(aout))
    (hdr_t, frames_t), wav_t = outs["torch"]
    (hdr_j, frames_j), wav_j = outs["jax"]
    assert hdr_t == hdr_j and len(frames_t) == len(frames_j) == 8
    for k, (ft, fj) in enumerate(zip(frames_t, frames_j)):
        for pt, pj in zip(ft, fj):
            assert_chain_equal(pt, pj, err_msg=f"frame {k}")
    _assert_wavs_match(wav_t, wav_j)
