"""The port's multi-device paths on the CPU (twin of tests/test_parallel.py).

A CPU mesh holds n references to the CPU device, the twin of the JAX
tests' 8 virtual CPU devices: the programs split, run and reassemble
their batches and row shards exactly as over n GPUs. Every multi-device
output is held byte-identical to the port's unsharded chain, as the JAX
package holds its own (content-addressed noise, row-addressed streams).
"""

import os
import subprocess
import sys
import zlib

import numpy as np
import pytest
import torch

from cvsim_tpu.presets import parse_composite_flags
from cvsim_tpu_torch.cli.main import main
from cvsim_tpu_torch.host.pipeline import CompositePipeline
from cvsim_tpu_torch.host.pipeline_yiq import YIQPipeline
from cvsim_tpu_torch.models import yiq
from cvsim_tpu_torch.parallel import (make_mesh, run_sharded_chain_fused,
                                      run_sharded_chain_fused_lines)
from cvsim_tpu_torch.parallel.mesh import _factor_2d
from cvsim_tpu_torch.testing import CHAIN_CONFIGS
from tests.test_cli import W, make_clip, read_all

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _batch(b, l, w, name):
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    rgb = torch.from_numpy(rng.integers(0, 256, (b, l, w, 3)).astype(np.uint8))
    fn = torch.arange(b, dtype=torch.int32)
    return rgb, fn, fn % 2


def test_factor_2d():
    assert _factor_2d(8) == (4, 2)
    assert _factor_2d(4) == (2, 2)
    assert _factor_2d(1) == (1, 1)
    assert _factor_2d(6) == (3, 2)


def test_make_mesh_shapes():
    m = make_mesh(8, "cpu")
    assert (m.dp, m.sp, m.size) == (4, 2, 8)
    assert all(d == torch.device("cpu") for d in m.flat)
    assert (make_mesh(8, "cpu", dp=2).sp, make_mesh(1, "cpu").size) == (4, 1)
    with pytest.raises(ValueError, match="must divide"):
        make_mesh(8, "cpu", dp=3)


def test_make_mesh_cuda_fails_loud_on_too_few_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="only 1 CUDA device"):
        make_mesh(2, "cuda")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    m = make_mesh(4, "cuda")
    assert m.flat == [torch.device("cuda", k) for k in range(4)]


@pytest.mark.parametrize("name", ["vhs-ep-stochastic", "vhs-hs-phase-noise",
                                  "yc-recomb"])
def test_sharded_chain_fused_matches_single_device(name):
    """Fields over all 8 devices: byte-identical to the one-device batch,
    noise included."""
    cfg = CHAIN_CONFIGS[name]
    rgb, fn, par = _batch(16, 16, 128, name)
    single = yiq.composite_layer_rgb_auto(rgb, fn, par, 9, cfg=cfg)
    got = run_sharded_chain_fused(make_mesh(8, "cpu"), cfg, rgb, fn, par, 9)
    assert torch.equal(got, single)
    with pytest.raises(ValueError, match="must divide"):
        run_sharded_chain_fused(make_mesh(8, "cpu"), cfg, rgb[:6], fn[:6],
                                par[:6], 9)


@pytest.mark.parametrize("name", ["vhs-ep-stochastic", "vhs-hs-phase-noise",
                                  "preemph", "bare"])
def test_line_sharded_fused_bit_identical(name):
    """Fields over dp=2 and lines over sp=4 (16 lines a shard): byte-
    identical to the unsharded chain, with the noise walks, the head
    switch and the blend's halo crossing shard boundaries."""
    cfg = CHAIN_CONFIGS[name]
    rgb, fn, par = _batch(2, 64, 128, name)
    mesh = make_mesh(8, "cpu", dp=2)
    single = yiq.composite_layer_rgb_auto(rgb, fn, par, 11, cfg=cfg)
    got = run_sharded_chain_fused_lines(mesh, cfg, rgb, fn, par, 11)
    assert torch.equal(got, single)
    with pytest.raises(ValueError, match="must divide"):
        run_sharded_chain_fused_lines(mesh, cfg, rgb[:, :61], fn, par, 11)


def test_devices_flag_pipelines_bit_identical(tmp_path):
    """`--device cpu <tool> ... -devices 8` is byte-identical to the run
    without it, for ntsc and for to-composite with -bkey-feedback 20 (the
    black-key scan carries sequential state on the primary device while
    the chain's fields split over the mesh)."""
    src = make_clip(str(tmp_path / "in.y4m"))
    for tool, extra in (("to-composite", ["-bkey-feedback", "20"]),
                        ("ntsc", [])):
        a = str(tmp_path / f"{tool}-1.y4m")
        b = str(tmp_path / f"{tool}-8.y4m")
        args = (["--device", "cpu", tool, "-i", src, "-width", str(W),
                 "-vhs", "-seed", "7"] + extra)
        assert main(args + ["-o", a]) == 0
        assert main(args + ["-o", b, "-devices", "8"]) == 0
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read(), tool


@pytest.mark.parametrize("gen1", [False, True], ids=["ntsc", "to-composite"])
def test_devices_flag_must_divide_gop(gen1):
    st = parse_composite_flags([], gen2=not gen1)
    cfg = st.to_run_config(gen1=gen1)
    pipeline = CompositePipeline if gen1 else YIQPipeline
    with pytest.raises(ValueError, match="must divide the GOP"):
        pipeline(cfg, gop=64, device="cpu", devices=6)


@pytest.mark.parametrize("tool", ["ntsc", "to-composite"])
def test_devices_flag_too_many_gpus_fails(tmp_path, capsys, monkeypatch,
                                          tool):
    """-devices n with fewer GPUs visible exits 1 and names the count."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    src = make_clip(str(tmp_path / "in.y4m"))
    out = str(tmp_path / "out.y4m")
    assert main(["--device", "cuda", tool, "-i", src, "-o", out,
                 "-devices", "2"]) == 1
    assert "only 1 CUDA device" in capsys.readouterr().err


def test_multi_device_paths_import_no_jax(tmp_path):
    """parallel.mesh and both pipelines with -devices run with jax made
    unimportable."""
    src = make_clip(str(tmp_path / "in.y4m"))
    outs = [str(tmp_path / f"{t}.y4m") for t in ("ntsc", "to-composite")]
    code = f"""
import sys
for name in [m for m in sys.modules if m == "jax" or m.startswith("jax.")]:
    del sys.modules[name]
sys.modules["jax"] = None
import torch
import cvsim_tpu_torch.parallel.mesh as mesh
from cvsim_tpu_torch.cli.main import main
from cvsim_tpu_torch.testing import CHAIN_CONFIGS
rgb = torch.zeros((2, 8, 128, 3), dtype=torch.uint8)
fn = torch.arange(2, dtype=torch.int32)
out = mesh.run_sharded_chain_fused_lines(
    mesh.make_mesh(4, "cpu", dp=2), CHAIN_CONFIGS["vhs-sp"], rgb, fn, fn, 7)
assert out.shape == rgb.shape
for tool, path in zip(("ntsc", "to-composite"), {outs!r}):
    rc = main(["--device", "cpu", tool, "-i", {src!r}, "-o", path,
               "-width", "{W}", "-vhs", "-devices", "2"])
    assert rc == 0, tool
assert sys.modules["jax"] is None
print("OK")
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "OK" in proc.stdout
    for path in outs:
        assert len(read_all(path)[1]) == 8
