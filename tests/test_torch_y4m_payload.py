"""The gen-2 render's Y4M payloads (host/payload.py and its kernel,
csrc/y4m_payload.cu with csrc/yuv601.cuh) against the bob and RGB->YUV
that YIQPipeline._emit once ran per field in numpy.

On the CPU: yuv601.cuh, built with g++ -ffp-contract=off and inside
native/hostpix.cpp's library, equals colorconv.rgb_to_yuv601_np on all
2^24 RGB triples; the kernel's source,
run under tests/pole_model.cpp's shim, equals payload.payloads_np byte for
byte at 4:2:0 and 4:2:2, at even and odd widths and heights; payloads_np
equals the planes the old `_emit` wrote; and run_video on the CPU device
(the chain on and off, both layouts, a 2-device mesh, a checkpoint and a
resume) writes the file the old pipeline wrote. On the card (`cuda`
marker, no jax):

    python -m pytest --noconftest -m cuda tests/test_torch_y4m_payload.py -q

the kernel equals rgb_to_yuv601_np on all 2^24 triples and payloads_np on
64-field GOPs at 720x480 in both layouts; a render through the card
writes the bytes of the same render with the payloads made on the host;
and the card path takes one `y4m_payload` launch a GOP (the host path
none) and copies back as many bytes as the RGB fields it replaced.
"""

import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from cvsim_tpu_torch import presets
from cvsim_tpu_torch.host import payload, pipeline_yiq, y4m
from cvsim_tpu_torch.host.colorconv import rgb_to_yuv601_np
from cvsim_tpu_torch.models import yiq
from cvsim_tpu_torch.native import hostpix
from cvsim_tpu_torch.parallel import run_sharded_chain_fused
from cvsim_tpu_torch.testing import launches
from cvsim_tpu_torch.utils import log

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(HERE, os.pardir, "cvsim_tpu_torch", "csrc")
N_TRIPLES = 1 << 24
CHUNK = 1 << 20

# (fields, lines, width, frame height): even and odd widths and heights; a
# height below 2 * lines - 1 leaves the field's last lines unread; 20 x 27
# spans three CTAs a field, the last one ragged
SIZES = [(3, 5, 8, 10), (2, 5, 7, 9), (2, 6, 9, 12), (3, 5, 10, 9),
         (2, 6, 7, 9), (1, 1, 1, 1), (2, 20, 27, 39)]
SIZE_IDS = ["even", "odd-w-odd-h", "odd-w", "odd-h", "short-h", "one-pixel",
            "ctas"]


def _fields(b, l, w, seed=0) -> np.ndarray:
    """uint8 [b, l, w, 3]: random, with 0 and 255 in every channel."""
    rng = np.random.default_rng(seed)
    f = rng.integers(0, 256, (b, l, w, 3), dtype=np.uint8)
    f[0, 0, 0] = 0
    f[-1, -1, -1] = 255
    return f


def _emit_planes(field: np.ndarray, height: int, is422: bool):
    """The planes the old YIQPipeline._emit handed to Y4MWriter.write for
    one uint8 RGB field: the bob, rgb_to_yuv601_np, the chroma slices."""
    frame = np.repeat(field, 2, axis=0)[:height]
    y, u, v = rgb_to_yuv601_np(frame[..., 0].astype(np.int32),
                               frame[..., 1].astype(np.int32),
                               frame[..., 2].astype(np.int32))
    y, u, v = (p.astype(np.uint8) for p in (y, u, v))
    if is422:
        return y, u[:, 0::2], v[:, 0::2]
    return y, u[0::2, 0::2], v[0::2, 0::2]


def _triples(start: int, n: int):
    i = np.arange(start, start + n, dtype=np.int32)
    return i >> 16, (i >> 8) & 255, i & 255


# ------------------------------------------------------------ on the CPU

@pytest.mark.parametrize("is422", [False, True], ids=["420", "422"])
@pytest.mark.parametrize("b,l,w,h", SIZES, ids=SIZE_IDS)
def test_payloads_np_equals_old_emit(b, l, w, h, is422):
    """Each payload row is the old `_emit`'s Y, U and V bytes one after
    another, and `planes` gives them back as views of the row."""
    fields = _fields(b, l, w)
    got = payload.payloads_np(fields, h, is422)
    assert got.shape == (b, payload.frame_bytes(h, w, is422))
    for k in range(b):
        want = _emit_planes(fields[k], h, is422)
        assert got[k].tobytes() == b"".join(p.tobytes() for p in want)
        for view, plane in zip(payload.planes(got[k], h, w, is422), want):
            assert np.shares_memory(view, got[k])
            np.testing.assert_array_equal(view, plane)


def test_wrapper_on_cpu_runs_plain_version():
    """A CPU tensor takes payloads_np and launches nothing; heights a
    bobbed field cannot give, and other dtypes, raise."""
    fields = _fields(2, 5, 7)
    before = launches("y4m_payload")
    got = payload.payloads(torch.from_numpy(fields), 9, False)
    assert launches("y4m_payload") == before
    np.testing.assert_array_equal(got.numpy(),
                                  payload.payloads_np(fields, 9, False))
    with pytest.raises(ValueError, match="height 11"):
        payload.payloads(torch.from_numpy(fields), 11, False)
    with pytest.raises(ValueError, match="uint8"):
        payload.payloads(torch.from_numpy(fields).int(), 9, False)


def _model_source(d) -> str:
    """csrc/y4m_payload.cu with its launch rewritten to run CTA after CTA
    on the model's threads (tests/pole_model.cpp)."""
    with open(os.path.join(CSRC, "y4m_payload.cu")) as f:
        src = f.read().replace("#include <cuda_runtime.h>\n", "")
    src, n = re.subn(r"(\w+)<<<(.*?),.*?>>>\((.*?)\);",
                     r"cvsim_launch(\2, [&] { \1(\3); });", src, flags=re.S)
    assert n == 1
    (d / "y4m_payload_cpu.cu").write_text(src)
    return str(d)


@pytest.fixture(scope="module")
def payload_model(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the CPU model of csrc/y4m_payload.cu")
    d = tmp_path_factory.mktemp("payload_model")
    exe = str(d / "payload_model")
    subprocess.run([gxx, "-std=c++20", "-O1", "-ffp-contract=off",
                    "-fno-strict-aliasing", "-pthread", "-DPAYLOAD_KERNEL",
                    "-I", CSRC, "-I", _model_source(d),
                    os.path.join(HERE, "pole_model.cpp"), "-o", exe],
                   check=True, capture_output=True, text=True)
    return exe


def test_conversion_equals_numpy_on_every_triple(payload_model, tmp_path):
    """csrc/yuv601.cuh built with g++ (no contraction): Y, U and V of
    every RGB triple equal rgb_to_yuv601_np's."""
    out = tmp_path / "yuv"
    res = subprocess.run([payload_model, "yuv601", str(out)],
                         capture_output=True, text=True)
    assert res.returncode == 0, res.stdout + res.stderr
    got = np.fromfile(out, np.uint8)
    assert got.size == 3 * N_TRIPLES
    got = got.reshape(3, N_TRIPLES)
    for start in range(0, N_TRIPLES, CHUNK):
        want = rgb_to_yuv601_np(*_triples(start, CHUNK))
        for name, g, w in zip("yuv", got[:, start:start + CHUNK], want):
            bad = np.flatnonzero(g != w)
            assert bad.size == 0, (name, start + bad[:5])


def test_host_library_conversion_equals_numpy_on_every_triple():
    """native/hostpix.cpp converts through yuv601.cuh too, built with its
    own flags (-O3, -march=native where it builds): its rgb_to_yuv_planes
    gives rgb_to_yuv601_np's Y, U and V for every RGB triple."""
    if hostpix._load() is None:
        pytest.skip("needs g++ to build native/hostpix.cpp")
    for start in range(0, N_TRIPLES, CHUNK):
        r, g, b = _triples(start, CHUNK)
        got = hostpix.rgb_to_yuv_planes(
            np.stack([r, g, b], -1).reshape(1024, CHUNK // 1024, 3))
        want = rgb_to_yuv601_np(r, g, b)
        for name, gp, w in zip("yuv", got, want):
            bad = np.flatnonzero(gp.reshape(-1) != w)
            assert bad.size == 0, (name, start + bad[:5])


@pytest.mark.parametrize("is422", [False, True], ids=["420", "422"])
@pytest.mark.parametrize("b,l,w,h", SIZES, ids=SIZE_IDS)
def test_kernel_source_equals_payloads_np(payload_model, tmp_path, b, l, w,
                                          h, is422):
    """cvsim_y4m_payload, built for the CPU, writes payloads_np's bytes:
    every plane at its place, the bob, the chroma rows and columns, the
    ragged last CTA of each field."""
    fields = _fields(b, l, w, seed=b * 1000 + w * 10 + h)
    (tmp_path / "rgb").write_bytes(fields.tobytes())
    out = tmp_path / "out"
    res = subprocess.run([payload_model, "payload", str(tmp_path), str(b),
                          str(l), str(w), str(h), str(int(is422)), str(out)],
                         capture_output=True, text=True)
    assert res.returncode == 0, res.stdout + res.stderr
    got = np.frombuffer(out.read_bytes(), np.uint8)
    want = payload.payloads_np(fields, h, is422)
    assert got.size == want.size
    bad = np.flatnonzero(got != want.reshape(-1))
    assert bad.size == 0, bad[:10]


class _OldPipeline(pipeline_yiq.YIQPipeline):
    """The pipeline before the payloads: the chain's RGB fields come back,
    and `_emit` bobs and converts each one."""

    def process_batch(self, rgb_fields, fieldnos, parities):
        if not self.cfg.enable_composite_emulation:
            return rgb_fields
        rgb = torch.from_numpy(rgb_fields)
        fn = torch.tensor(fieldnos, dtype=torch.int32)
        pa = torch.tensor(parities, dtype=torch.int32)
        if self.mesh is not None:
            return run_sharded_chain_fused(
                self.mesh, self.cfg.composite, rgb, fn, pa, self.key).numpy()
        return yiq.composite_layer_rgb_auto(rgb, fn, pa, self.key,
                                            cfg=self.cfg.composite).numpy()

    def _emit(self, rgb_field, fieldno, writer):
        out = self.cfg.output
        writer.write(*_emit_planes(rgb_field, out.height,
                                   out.use_422_colorspace))


def _clip(path, frames, w=64, h=48):
    from fractions import Fraction

    rng = np.random.default_rng(frames)
    hdr = y4m.Y4MHeader(width=w, height=h, fps=Fraction(30000, 1001))
    with open(path, "wb") as f:
        wr = y4m.Y4MWriter(f, hdr)
        for _ in range(frames):
            wr.write(rng.integers(16, 236, (h, w), dtype=np.uint8),
                     rng.integers(40, 216, (h // 2, w // 2), dtype=np.uint8),
                     rng.integers(40, 216, (h // 2, w // 2), dtype=np.uint8))
    return path


def _render(cls, src, out, flags, devices=0, mode="wb", **kw) -> int:
    st = presets.parse_composite_flags(
        ["-vhs", "-seed", "5", *flags], gen2=True)
    pipe = cls(st.to_run_config(gen1=False), gop=4, progress=False,
               device="cpu", devices=devices)
    with open(src, "rb") as fin, open(out, mode) as fout:
        return pipe.run_video([y4m.Y4MReader(fin)], fout, **kw)


RENDERS = [
    ([], 0), (["-422"], 0), (["-nocomp"], 0), (["-nocomp", "-422"], 0),
    ([], 2), (["-width", "37"], 0), (["-422", "-width", "37"], 0),
]
RENDER_IDS = ["420", "422", "nocomp", "nocomp-422", "devices-2", "odd-w",
              "odd-w-422"]


@pytest.mark.parametrize("flags,devices", RENDERS, ids=RENDER_IDS)
def test_run_video_on_cpu_writes_old_bytes(tmp_path, flags, devices):
    """run_video on the CPU device (the chain's output on the host, so the
    payloads come from payloads_np) writes the old pipeline's file, with
    the chain on and off, at both layouts, on a 2-device mesh and at an
    odd width; with a short last GOP."""
    src = _clip(str(tmp_path / "in.y4m"), frames=5)
    want, got = str(tmp_path / "want.y4m"), str(tmp_path / "got.y4m")
    n = _render(_OldPipeline, src, want, ["-width", "64", *flags], devices)
    before = launches("y4m_payload")
    assert _render(pipeline_yiq.YIQPipeline, src, got,
                   ["-width", "64", *flags], devices) == n == 10
    assert launches("y4m_payload") == before
    with open(want, "rb") as a, open(got, "rb") as b:
        assert a.read() == b.read()


def test_resume_writes_old_bytes(tmp_path):
    """A render cut after two GOPs and resumed from its checkpoint writes
    the old pipeline's uninterrupted file."""
    src = _clip(str(tmp_path / "in.y4m"), frames=6)
    want, got = str(tmp_path / "want.y4m"), str(tmp_path / "got.y4m")
    assert _render(_OldPipeline, src, want, []) == 12
    ck = got + ".ckpt"
    with pytest.raises(RuntimeError, match="injected"):
        _render(pipeline_yiq.YIQPipeline, src, got, [], ckpt_path=ck,
                ckpt_every=1, _fail_after_gops=2)
    assert _render(pipeline_yiq.YIQPipeline, src, got, [], mode="r+b",
                   ckpt_path=ck, ckpt_every=1) == 12
    assert not os.path.exists(ck)
    with open(want, "rb") as a, open(got, "rb") as b:
        assert a.read() == b.read()


# ------------------------------------------------------------ on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_kernel_equals_numpy_on_every_triple_on_card(cuda_device):
    """All 2^24 triples through the kernel at 4:2:2: a field of 4096 rows
    of 8192 pixels holds triple 4096 s + c at columns 2c and 2c + 1 of row
    s, so frame row 2s holds its Y twice and U, V once; row 2s + 1 is the
    bob's copy."""
    i = torch.arange(N_TRIPLES, dtype=torch.int32, device=cuda_device)
    rgb = torch.stack([i >> 16, (i >> 8) & 255, i & 255], -1).to(torch.uint8)
    rgb = rgb.reshape(1, 4096, 4096, 1, 3).expand(1, 4096, 4096, 2, 3)
    rgb = rgb.reshape(1, 4096, 8192, 3)
    out = payload.payloads(rgb, 8192, True)
    torch.cuda.synchronize()
    y, u, v = (torch.from_numpy(p.copy()) for p in
               payload.planes(out[0].cpu().numpy(), 8192, 8192, True))
    assert torch.equal(y[0::2], y[1::2]) and torch.equal(u[0::2], u[1::2])
    assert torch.equal(v[0::2], v[1::2])
    got = (y[0::2, 0::2].reshape(-1), y[0::2, 1::2].reshape(-1),
           u[0::2].reshape(-1), v[0::2].reshape(-1))
    for start in range(0, N_TRIPLES, CHUNK):
        want_y, want_u, want_v = (torch.from_numpy(p.astype(np.uint8)) for p
                                  in rgb_to_yuv601_np(*_triples(start, CHUNK)))
        sl = slice(start, start + CHUNK)
        for name, g, w in zip(("y even", "y odd", "u", "v"), got,
                              (want_y, want_y, want_u, want_v)):
            bad = (g[sl] != w).nonzero()
            assert bad.numel() == 0, (name, start + bad[:5].reshape(-1))


@pytest.mark.cuda
@pytest.mark.parametrize("is422", [False, True], ids=["420", "422"])
def test_kernel_equals_payloads_np_on_a_gop(cuda_device, is422):
    """A 64-field GOP at 720x480, and the small sizes of the CPU tests:
    the card's payloads equal payloads_np byte for byte, one launch a
    call."""
    for b, l, w, h in [(64, 240, 720, 480), *SIZES]:
        fields = _fields(b, l, w, seed=w + h)
        before = launches("y4m_payload")
        got = payload.payloads(torch.from_numpy(fields).to(cuda_device), h,
                               is422)
        assert launches("y4m_payload") == before + 1
        want = payload.payloads_np(fields, h, is422)
        bad = np.flatnonzero(got.cpu().numpy() != want)
        assert bad.size == 0, ((b, l, w, h), bad[:10])


@pytest.mark.cuda
@pytest.mark.parametrize("is422", [False, True], ids=["420", "422"])
def test_render_on_card_equals_host_payloads(cuda_device, tmp_path,
                                             monkeypatch, is422):
    """A 720x480 render of 3 GOPs and a short one through the card writes
    the bytes of the same render with each GOP's payloads made on the host
    from the same chain output; the card path takes one y4m_payload launch
    a GOP and copies back the bytes the RGB fields took at 4:2:0, the host
    path launches none."""
    src = _clip(str(tmp_path / "in.y4m"), frames=100, w=720, h=480)
    flags = ["-vhs", "-vhs-speed", "ep", "-vhs-head-switching", "1",
             "-seed", "7", *(["-422"] if is422 else [])]
    cfg = presets.parse_composite_flags(flags, gen2=True).to_run_config(
        gen1=False)

    def render(out):
        pipe = pipeline_yiq.YIQPipeline(cfg, progress=False,
                                        device=cuda_device)
        counters0 = log.snapshot()["counters"]
        with open(src, "rb") as fin, open(out, "wb") as fout:
            n = pipe.run_video([y4m.Y4MReader(fin)], fout)
        counters = log.snapshot()["counters"]
        return n, {k: counters.get(k, 0) - counters0.get(k, 0)
                   for k in ("launches.y4m_payload", "d2h_bytes.pageable")}

    card = str(tmp_path / "card.y4m")
    n, counts = render(card)
    gops = -(-n // 64)
    assert n == 200 and counts["launches.y4m_payload"] == gops
    if not is422:
        assert counts["d2h_bytes.pageable"] == gops * 64 * 240 * 720 * 3

    on_card = payload.payloads
    monkeypatch.setattr(payload, "payloads",
                        lambda rgb, *a: on_card(rgb.cpu(), *a))
    host = str(tmp_path / "host.y4m")
    n, counts = render(host)
    assert n == 200 and counts["launches.y4m_payload"] == 0
    with open(card, "rb") as a, open(host, "rb") as b:
        assert a.read() == b.read()
