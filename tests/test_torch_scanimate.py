"""The port's scanimate (cvsim_tpu_torch.models.tools and the `scanimate`
CLI) against the JAX package's, on the CPU, with inputs made from numpy
seeds.

- scanimate_field, batched over fields, against JAX's per field at
  tests/test_scanimate_splat.py's 64x96 -> 144x192, in each of the 4 warp
  effects at 3 phases, with and without input_ntsc.
- The port's splat against JAX's scatter oracle (`_splat_scatter`) on the
  same dots.
- The CLI against the JAX CLI on clips already at the output raster (no
  frame scaling: the port's scaler clamps where JAX's extrapolates), with
  and without -inntsc, over 375 fields: a short last batch, the odd-field
  row-0 rule, and field numbers in the vstretch effect (360..374).

Bound: at most 1 on at most 1e-4 of pixels, the bound tests/
test_scanimate_splat.py holds JAX's two splats to; the port's fields in
fact equal JAX's eager scanimate_field bit for bit. The JAX CLI runs
scanimate_field under jit and vmap, where XLA contracts and orders the
float32 math otherwise; there it differs from JAX's own eager fields by
at most 1, on 6.4e-4 of the luma samples of 375 fields at 8x480
progressive and on 9.2e-5 with -inntsc (up to 1.6% of one field's, in the
vstretch effect; ROADMAP queue 3). So the CLIs are held to at most 1 on
at most 1e-3 of luma samples (chroma exact), and the port's CLI rasters
to JAX's eager fields exactly.
"""

from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvsim_tpu.cli.main import main as jax_main
from cvsim_tpu.host import y4m
from cvsim_tpu.models import tools as jtools
from cvsim_tpu_torch.cli.main import main
from cvsim_tpu_torch.models import tools
from tests.test_cli import read_all
from tests.test_scanimate_splat import DST_H, DST_W, SRC_H, SRC_W, _dots

FIELDNOS = [effect * 180 + phase for effect in range(4)
            for phase in (0, 41, 140)]
MAX_FRAC = 1e-4
CLI_MAX_FRAC = 1e-3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU ops here are many and small: with the test workers
    sharing the cores, torch's intra-op threads oversubscribe them and
    spin (an 8x480 CLI run went from 1 s to minutes); one thread runs
    the same ops, with the same results."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _src(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, size=(SRC_H, SRC_W, 3)).astype(np.int32)


def _assert_close(got, want, max_frac, what):
    d = np.abs(np.asarray(got).astype(np.int64)
               - np.asarray(want).astype(np.int64))
    assert d.max() <= 1, f"{what}: max diff {d.max()}"
    assert (d != 0).mean() <= max_frac, f"{what}: {(d != 0).mean():.2e} differ"


@pytest.fixture(scope="module")
def port_fields():
    """The port's rasters of FIELDNOS, one batched call per source-row
    parity: {(input_ntsc, fieldno): raster}."""
    out = {}
    for ntsc in (False, True):
        for field in ((0, 1) if ntsc else (0,)):
            fns = [f for f in FIELDNOS
                   if not ntsc or (f & 1) ^ 1 == field]
            assert fns
            src = torch.from_numpy(np.stack([_src(f) for f in fns]))
            got = tools.scanimate_field(src, DST_H, DST_W, field, fns,
                                        input_ntsc=ntsc)
            assert got.shape == (len(fns), DST_H, DST_W)
            assert got.dtype == torch.int32
            out.update(((ntsc, f), g.numpy()) for f, g in zip(fns, got))
    return out


@pytest.mark.parametrize("ntsc", [False, True], ids=["progressive", "inntsc"])
@pytest.mark.parametrize("fieldno", FIELDNOS)
def test_scanimate_field_equals_jax(port_fields, fieldno, ntsc):
    field = (fieldno & 1) ^ 1 if ntsc else 0
    want = np.asarray(jtools.scanimate_field(
        jnp.asarray(_src(fieldno)), DST_H, DST_W, field,
        jnp.int32(fieldno), input_ntsc=ntsc))
    got = port_fields[(ntsc, fieldno)]
    assert got.max() > 0
    _assert_close(got, want, MAX_FRAC, f"field {fieldno}")


def test_scanimate_pack_equals_jax(port_fields):
    raster = port_fields[(True, 581)]   # the diffuse effect exceeds 255
    assert raster.max() > 255
    np.testing.assert_array_equal(
        tools.scanimate_pack(torch.from_numpy(raster)).numpy(),
        np.asarray(jtools.scanimate_pack(jnp.asarray(raster))))


@pytest.mark.parametrize("fieldno", [40, 220, 400, 580])
def test_splat_equals_jax_scatter(fieldno):
    """The port's splat on JAX's dots == JAX's _splat_scatter: each stamp
    value is truncated to an integer before any sum."""
    px, py, sig, radius, r_int, p = _dots(jnp.asarray(_src(fieldno)), fieldno,
                                          0)
    want = np.asarray(jtools._splat_scatter(px, py, sig, radius, r_int,
                                            DST_H, DST_W))
    as_t = lambda a: torch.from_numpy(np.array(a))[None]
    got = tools.splat(as_t(px), as_t(py), as_t(sig),
                      torch.tensor(np.asarray(radius)), r_int, DST_H, DST_W)
    np.testing.assert_array_equal(got[0].numpy(), want)
    assert (want >> p).max() > 0


# ------------------------------------------------------------- the CLIs

CLI_W, CLI_H = 8, 480
# 4 frames at 0.64 fps: 375 output fields at 59.94 (23 batches of 16 and
# one of 7), the last 15 of them in the vstretch effect
CLI_FPS = Fraction(16, 25)


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    d = tmp_path_factory.mktemp("scanimate")
    path = str(d / "in.y4m")
    rng = np.random.default_rng(21)
    with open(path, "wb") as f:
        wr = y4m.Y4MWriter(f, y4m.Y4MHeader(width=CLI_W, height=CLI_H,
                                            fps=CLI_FPS, colorspace="444"))
        for _ in range(4):
            wr.write(*(rng.integers(16, 236, (CLI_H, CLI_W)).astype(np.uint8)
                       for _ in range(3)))
    return d, path


@pytest.mark.parametrize("flags", [[], ["-inntsc"]],
                         ids=["progressive", "inntsc"])
def test_cli_equals_jax(clip, flags, monkeypatch):
    d, src = clip
    tag = "".join(flags) or "progressive"
    outs = [str(d / f"{tag}-{who}.y4m") for who in ("jax", "port")]
    common = ["-i", src, "-width", str(CLI_W), *flags]
    assert jax_main(["scanimate", "-o", outs[0], *common]) == 0
    calls = []
    run = tools.scanimate_field

    def record(src_rgb, dst_h, dst_w, field, fieldnos, input_ntsc):
        out = run(src_rgb, dst_h, dst_w, field, fieldnos,
                  input_ntsc=input_ntsc)
        calls.append((src_rgb.numpy().copy(), field, list(fieldnos),
                      out.numpy().copy()))
        return out

    monkeypatch.setattr(tools, "scanimate_field", record)
    assert main(["--device", "cpu", "scanimate", "-o", outs[1], *common]) == 0
    (hdr_j, want), (hdr, got) = read_all(outs[0]), read_all(outs[1])
    assert (hdr.width, hdr.height, hdr.fps) == (hdr_j.width, hdr_j.height,
                                                hdr_j.fps)
    assert len(got) == len(want) == 375
    fieldnos = [f for _, _, fns, _ in calls for f in fns]
    assert sorted(fieldnos) == list(range(375))
    # batches of 16 fields (8 a parity under -inntsc), the last one short
    assert len(calls[-1][2]) < (8 if flags else 16)
    assert max(fieldnos) >= 360
    for k, (g, w) in enumerate(zip(got, want)):
        _assert_close(g[0], w[0], 1.0, f"luma field {k}")
        for plane in (1, 2):
            np.testing.assert_array_equal(g[plane], w[plane])
    _assert_close(np.stack([g[0] for g in got]),
                  np.stack([w[0] for w in want]), CLI_MAX_FRAC, "luma")
    # the port's rasters are JAX's eager fields, on a field of each
    # effect that ran and on the short last batch
    checks = {min(i for i, (_, _, fns, _) in enumerate(calls)
                  if any(f // 180 == e for f in fns)) for e in range(3)}
    for i in sorted(checks | {len(calls) - 1}):
        src_b, field, fns, out = calls[i]
        want_f = np.asarray(jtools.scanimate_field(
            jnp.asarray(src_b[0], jnp.int32), CLI_H, CLI_W, field,
            jnp.int32(fns[0]), input_ntsc=bool(flags)))
        np.testing.assert_array_equal(out[0], want_f,
                                      err_msg=f"field {fns[0]}")
