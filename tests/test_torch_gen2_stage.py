"""The gen-2 render's GOP input (host/pipeline_yiq.py): source frames
scaled to uint8 (native/hostpix.scale_frame_to_u8), each GOP's field lines
copied into one staging buffer that the pipeline makes once and refills.

On the CPU: the uint8 scaler equals the int32 one cast to uint8, native
and numpy; a render of three GOPs and a short one refills one buffer,
pads it with the last field, and writes the bytes of a pipeline that
stacks int32 frames into a fresh array each GOP (the oracle, kept here),
with the chain on and off, on a 2-device mesh, and across a checkpoint
and a resume. On the card (`cuda` marker, no jax):

    python -m pytest --noconftest -m cuda tests/test_torch_gen2_stage.py -q

a 720x480 render pins one buffer in all (the oracle one a GOP), and
writes the oracle's bytes.
"""

import numpy as np
import pytest
import torch

from cvsim_tpu_torch import presets
from cvsim_tpu_torch.host import pipeline_yiq, y4m
from cvsim_tpu_torch.native import hostpix
from cvsim_tpu_torch.utils import log

GOP = 4
FRAMES = 7          # 14 fields: three GOPs of 4 and one of 2


class _OldStack(pipeline_yiq.YIQPipeline):
    """The GOP input before the staging buffer: int32 frames (run with
    hostpix.scale_frame_to in place of the uint8 scaler), stacked into a
    fresh array and cast each GOP."""

    def _stack(self, fields):
        padded = fields + [fields[-1]] * (self.gop - len(fields))
        return np.stack([f[0] for f in padded]).astype(np.uint8)


class _Recorded(pipeline_yiq.YIQPipeline):
    """Records each GOP's staging buffer (kept, so that no later array can
    take its address), the fields it holds, and whether it equals the old
    stack of the same fields."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.gops = []

    def _stack(self, fields):
        stage = super()._stack(fields)
        padded = fields + [fields[-1]] * (self.gop - len(fields))
        want = np.stack([f[0] for f in padded]).astype(np.uint8)
        self.gops.append((stage, len(fields),
                          stage.dtype == np.uint8
                          and np.array_equal(stage, want)))
        return stage


def _clip(path, frames, w=64, h=48):
    from fractions import Fraction

    rng = np.random.default_rng(frames)
    hdr = y4m.Y4MHeader(width=w, height=h, fps=Fraction(30000, 1001))
    with open(path, "wb") as f:
        wr = y4m.Y4MWriter(f, hdr)
        for _ in range(frames):
            wr.write(rng.integers(0, 256, (h, w), dtype=np.uint8),
                     rng.integers(0, 256, (h // 2, w // 2), dtype=np.uint8),
                     rng.integers(0, 256, (h // 2, w // 2), dtype=np.uint8))
    return path


def _pipe(cls, flags, devices=0, device="cpu", gop=GOP):
    st = presets.parse_composite_flags(
        ["-vhs", "-seed", "5", *flags], gen2=True)
    return cls(st.to_run_config(gen1=False), gop=gop, progress=False,
               device=device, devices=devices)


def _render(pipe, src, out, mode="wb", **kw) -> int:
    with open(src, "rb") as fin, open(out, mode) as fout:
        return pipe.run_video([y4m.Y4MReader(fin)], fout, **kw)


def _read(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


# --------------------------------------------------------- the scaler

@pytest.mark.parametrize("form", ["native", "numpy"])
@pytest.mark.parametrize("sub", ["420", "422"])
@pytest.mark.parametrize("src", [(480, 720), (360, 640)],
                         ids=["same-size", "rescaled"])
def test_scale_frame_to_u8_is_the_int32_frame(form, sub, src, monkeypatch):
    """scale_frame_to_u8 == scale_frame_to(...).astype(uint8) at 720x480,
    and every int32 value lies in 0..255, so the cast keeps it."""
    if form == "native" and hostpix._load() is None:
        pytest.skip("no compiler for libhostpix")
    if form == "numpy":
        monkeypatch.setattr(hostpix, "_load", lambda: None)
    sh, sw = src
    ch = sh // 2 if sub == "420" else sh
    rng = np.random.default_rng(sh + len(sub))
    y = rng.integers(0, 256, (sh, sw), np.uint8)
    u, v = (rng.integers(0, 256, (ch, sw // 2), np.uint8) for _ in range(2))
    wide = hostpix.scale_frame_to(y, u, v, 720, 480)
    got = hostpix.scale_frame_to_u8(y, u, v, 720, 480)
    assert wide.dtype == np.int32 and got.dtype == np.uint8
    assert got.shape == wide.shape == (480, 720, 3)
    assert wide.min() == 0 and wide.max() == 255
    np.testing.assert_array_equal(got, wide.astype(np.uint8))


# --------------------------------------------------------- the render

@pytest.mark.parametrize("flags,devices", [([], 0), (["-nocomp"], 0),
                                           ([], 2)],
                         ids=["chain", "nocomp", "devices-2"])
def test_one_staging_buffer_writes_old_bytes(tmp_path, flags, devices,
                                             monkeypatch):
    """Three GOPs and a short one: every GOP fills the same buffer, the
    short one's padding holds its last field, and the file equals the old
    stack's."""
    src = _clip(str(tmp_path / "in.y4m"), FRAMES)
    want, got = str(tmp_path / "want.y4m"), str(tmp_path / "got.y4m")
    pipe = _pipe(_Recorded, flags, devices)
    assert _render(pipe, src, got) == 2 * FRAMES
    assert [n for _, n, _ in pipe.gops] == [GOP, GOP, GOP, 2]
    assert len({stage.ctypes.data for stage, _, _ in pipe.gops}) == 1
    assert all(same for _, _, same in pipe.gops)
    monkeypatch.setattr(pipeline_yiq, "_scale_frame_to",
                        hostpix.scale_frame_to)
    assert _render(_pipe(_OldStack, flags, devices), src, want) == 2 * FRAMES
    assert _read(got) == _read(want)


def test_resume_from_the_staging_buffer_writes_old_bytes(tmp_path,
                                                         monkeypatch):
    """A render cut after two GOPs and resumed from its checkpoint (the
    resumed pipeline re-scales its current frame to uint8) writes the old
    stack's uninterrupted file."""
    src = _clip(str(tmp_path / "in.y4m"), FRAMES)
    got = str(tmp_path / "got.y4m")
    ck = got + ".ckpt"
    with pytest.raises(RuntimeError, match="injected"):
        _render(_pipe(pipeline_yiq.YIQPipeline, []), src, got, ckpt_path=ck,
                ckpt_every=1, _fail_after_gops=2)
    resumed = _pipe(_Recorded, [])
    assert _render(resumed, src, got, mode="r+b", ckpt_path=ck,
                   ckpt_every=1) == 2 * FRAMES
    assert [n for _, n, _ in resumed.gops] == [GOP, 2]
    assert all(same for _, _, same in resumed.gops)
    want = str(tmp_path / "want.y4m")
    monkeypatch.setattr(pipeline_yiq, "_scale_frame_to",
                        hostpix.scale_frame_to)
    assert _render(_pipe(_OldStack, []), src, want) == 2 * FRAMES
    assert _read(got) == _read(want)


# --------------------------------------------------------- on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_one_pinned_buffer_a_render_on_card(cuda_device, tmp_path,
                                            monkeypatch):
    """A 720x480 render of three GOPs of 64 and a short one pins one
    buffer (the old stack one a GOP), copies every GOP to the card from
    pinned memory, and writes the old stack's bytes."""
    src = _clip(str(tmp_path / "in.y4m"), frames=100, w=720, h=480)
    flags = ["-vhs-speed", "ep", "-vhs-head-switching", "1"]

    def render(cls, out):
        pipe = _pipe(cls, flags, device=cuda_device, gop=64)
        counters0 = log.snapshot()["counters"]
        n = _render(pipe, src, out)
        counters = log.snapshot()["counters"]
        return n, {k: counters.get(k, 0) - counters0.get(k, 0)
                   for k in ("pinned_allocs", "h2d_bytes.pinned")}

    got, want = str(tmp_path / "got.y4m"), str(tmp_path / "want.y4m")
    n, counts = render(pipeline_yiq.YIQPipeline, got)
    gops = -(-n // 64)
    assert n == 200 and gops == 4
    assert counts == {"pinned_allocs": 1,
                      "h2d_bytes.pinned": gops * 64 * 240 * 720 * 3}
    monkeypatch.setattr(pipeline_yiq, "_scale_frame_to",
                        hostpix.scale_frame_to)
    n, counts = render(_OldStack, want)
    assert n == 200 and counts == {
        "pinned_allocs": gops, "h2d_bytes.pinned": gops * 64 * 240 * 720 * 3}
    assert _read(got) == _read(want)
