"""Daemon mode of the port: `serve` + `-via <sock>`, the twins of the five
tests of tests/test_serve.py, and `serve -prime` on the CPU.

- A served command writes the same bytes as the direct run (a host tool,
  and `--device cpu ntsc -devices 4`, against the direct run without
  -devices).
- `python -S -m cvsim_tpu_torch -via` needs only the standard library.
- A missing server and an unknown command answer rc 1.
- `serve -prime` runs the gen-1 GOP step once before it serves; a prime
  that raises ends `serve` with a non-zero rc, the error on stderr.
"""

import os
import subprocess
import sys
import threading

import pytest

from cvsim_tpu_torch.cli import serve
from cvsim_tpu_torch.cli.main import main
from cvsim_tpu_torch.host.pipeline import CompositePipeline
from cvsim_tpu_torch.models import fused_yuv
from tests.test_cli import make_clip, read_all


def _start(sock, argv=(), device="cpu"):
    """A one-shot server on `sock` in a thread; returns (thread, result
    box) once it accepts commands."""
    ready = threading.Event()
    box = {}

    def run():
        box["rc"] = serve.run_serve(["-socket", sock, "-one-shot", *argv],
                                    device, ready)
        ready.set()

    t = threading.Thread(target=run, daemon=True)
    t.start()
    assert ready.wait(120)
    return t, box


def _same_files(a, b):
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read() == fb.read()


def test_serve_roundtrip(tmp_path):
    sock = str(tmp_path / "cvsim.sock")
    src = make_clip(str(tmp_path / "in.y4m"))
    argv = ["posterize", "-i", src, "-width", "64", "-threshhold", "2"]
    t, box = _start(sock)
    assert os.path.exists(sock)
    assert os.stat(sock).st_mode & 0o777 == 0o600
    assert main(["-via", sock, *argv, "-o", str(tmp_path / "s.y4m")]) == 0
    t.join(timeout=30)
    assert box["rc"] == 0 and not os.path.exists(sock)
    assert main([*argv, "-o", str(tmp_path / "d.y4m")]) == 0
    assert len(read_all(str(tmp_path / "s.y4m"))[1]) == 8
    assert _same_files(tmp_path / "s.y4m", tmp_path / "d.y4m")


def test_via_thin_client_no_site(tmp_path):
    """__main__ dispatches -via before any heavy import: `python -S`
    (no site-packages, so no numpy and no torch) reaches the server."""
    sock = str(tmp_path / "cvsim.sock")
    src = make_clip(str(tmp_path / "in.y4m"))
    out = str(tmp_path / "out.y4m")
    t, _ = _start(sock)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run(
        [sys.executable, "-S", "-m", "cvsim_tpu_torch", "-via", sock,
         "posterize", "-i", src, "-o", out, "-width", "64"],
        cwd=repo, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    t.join(timeout=30)
    assert len(read_all(out)[1]) > 0


def test_via_connect_error_is_friendly(tmp_path, capsys):
    assert main(["-via", str(tmp_path / "nope.sock"), "posterize"]) == 1
    assert "cannot reach server" in capsys.readouterr().err


def test_via_reports_unknown_command(tmp_path):
    sock = str(tmp_path / "cvsim.sock")
    t, _ = _start(sock)
    assert main(["-via", sock, "definitely-not-a-command"]) == 1
    t.join(timeout=30)


def test_serve_devices_flag(tmp_path):
    """-devices through the daemon: `--device cpu ntsc -devices 4` splits
    the fields over 4 CPU shards in the server and matches the direct run
    without -devices byte for byte."""
    sock = str(tmp_path / "cvsim.sock")
    src = make_clip(str(tmp_path / "in.y4m"))
    argv = ["--device", "cpu", "ntsc", "-i", src, "-width", "128", "-seed",
            "3"]
    t, _ = _start(sock)
    assert main(["-via", sock, *argv, "-o", str(tmp_path / "s.y4m"),
                 "-devices", "4"]) == 0
    t.join(timeout=60)
    assert main([*argv, "-o", str(tmp_path / "d.y4m")]) == 0
    assert _same_files(tmp_path / "s.y4m", tmp_path / "d.y4m")


def test_serve_prime_on_cpu(tmp_path, capsys):
    """`--device cpu serve -prime`: the gen-1 GOP step runs once (the
    chain's wrapper is called for its one GOP) before the server accepts
    the first command, which then writes the direct run's bytes."""
    sock = str(tmp_path / "cvsim.sock")
    src = make_clip(str(tmp_path / "in.y4m"))
    calls = []
    real = fused_yuv.composite_video_process_fused

    def counted(*args, **kw):
        calls.append(args[0].shape)
        return real(*args, **kw)

    argv = ["--device", "cpu", "to-composite", "-i", src, "-width", "128",
            "-vhs"]
    mp = pytest.MonkeyPatch()
    mp.setattr(fused_yuv, "composite_video_process_fused", counted)
    try:
        t, box = _start(sock, ["-prime"])
        assert calls and calls[0][0] == 64       # one dummy GOP
        assert "primed in" in capsys.readouterr().err
        assert main(["-via", sock, *argv, "-o",
                     str(tmp_path / "s.y4m")]) == 0
        t.join(timeout=60)
    finally:
        mp.undo()
    assert box["rc"] == 0
    assert main([*argv, "-o", str(tmp_path / "d.y4m")]) == 0
    assert _same_files(tmp_path / "s.y4m", tmp_path / "d.y4m")


def test_serve_prime_failure_ends_serve(tmp_path, capsys, monkeypatch):
    """No swallowed prime: a kernel that cannot build or launch ends
    `serve` with rc 1, the error on stderr, the socket removed."""
    def broken(self, *args, **kw):
        raise RuntimeError("kernel build failed (injected)")

    monkeypatch.setattr(CompositePipeline, "prime", broken)
    sock = str(tmp_path / "cvsim.sock")
    rc = main(["--device", "cpu", "serve", "-socket", sock, "-prime"])
    assert rc == 1
    err = capsys.readouterr().err
    assert "-prime failed: RuntimeError: kernel build failed" in err
    assert not os.path.exists(sock)


def test_default_socket_is_private(tmp_path, monkeypatch):
    """Without XDG_RUNTIME_DIR the socket lives in a 0700 per-uid
    directory under the temp directory (TMPDIR), not in a fixed path."""
    monkeypatch.delenv("XDG_RUNTIME_DIR", raising=False)
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", None)
    path = serve.default_socket()
    run_dir = os.path.dirname(path)
    assert run_dir == str(tmp_path / f"cvsim-{os.getuid()}")
    assert os.stat(run_dir).st_mode & 0o777 == 0o700
    monkeypatch.setenv("XDG_RUNTIME_DIR", str(tmp_path / "xdg"))
    assert serve.default_socket() == str(tmp_path / "xdg" / "cvsim.sock")
