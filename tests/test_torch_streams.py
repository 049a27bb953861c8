"""The per-line inputs' kernel (csrc/streams.cu, `cvsim_field_streams`,
wrapped by models/chain_prep.field_streams_fused) against its plain version
yiq.field_streams.

On the CPU: the wrapper returns yiq.field_streams' outputs; the kernel's
source, built with g++ under tests/pole_model.cpp's shim, equals
yiq.field_streams on every branch (gen-1 and gen-2, NTSC and PAL, each
phase shift with offsets, head switching off, on and with phase noise,
chroma phase noise 0, 6 and 60, chroma loss 0, 8 and 50000, field numbers
up to 2^31 - 1, and some whose walk lies within rounding of an integer);
and a numpy model of the kernel's chroma-phase walk equals the plain
version's blocked walk in every bit. On the card (`cuda` marker, no jax):

    python -m pytest --noconftest -m cuda tests/test_torch_streams.py -q

the kernel equals yiq.field_streams on the card bit for bit (sin and cos
compared as int32 bits, so that -0.0 counts) and on the CPU (where torch's
sin and cos differ between the devices, as the same angle), and each
library entry takes one launch of it and five syncs a call.
"""

import os
import re
import shutil
import subprocess
import warnings

import numpy as np
import pytest
import torch

from cvsim_tpu_torch.config import CompositeConfig, VHSSpeed
from cvsim_tpu_torch.interop import key32_from_seed
from cvsim_tpu_torch.models import chain_prep, fused_yiq, yiq, yuv422
from cvsim_tpu_torch.ops.noise import (field_stage_keys, randint_per_field,
                                       random_walk_per_field)
from cvsim_tpu_torch.testing import bench_cli_configs, launches
from cvsim_tpu_torch.utils import log

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(HERE, os.pardir, "cvsim_tpu_torch", "csrc")

KEY = key32_from_seed(7)
EP = dict(emulating_vhs=True, vhs_tape_speed=VHSSpeed.EP, video_noise=6,
          video_chroma_noise=22)


BENCH_GEN2, _ = bench_cli_configs()["ntsc-vhs-ep"]
BENCH_GEN1, _ = bench_cli_configs()["composite-vhs-ep"]

# (name, config, gen1, lines, luma width): every branch of the kernel
CASES = [
    ("bench-gen2", BENCH_GEN2, False, 240, 720),
    ("bench-gen1", BENCH_GEN1, True, 240, 720),
    ("bench-gen1-pal", BENCH_GEN1.with_(ntsc=False), True, 288, 720),
    ("bench-gen2-pal", BENCH_GEN2.with_(ntsc=False), False, 288, 720),
    ("bench-gen2-1080i", BENCH_GEN2, False, 540, 1888),
    ("phase0-off3", CompositeConfig(
        video_scanline_phase_shift=0, video_scanline_phase_shift_offset=3,
        video_chroma_phase_noise=60, **EP), False, 240, 720),
    ("phase0-gen1", CompositeConfig(
        video_scanline_phase_shift=0, video_scanline_phase_shift_offset=3,
        video_chroma_loss=50000, **EP), True, 240, 720),
    ("phase90-off1", CompositeConfig(
        video_scanline_phase_shift=90, video_scanline_phase_shift_offset=1,
        video_chroma_phase_noise=6, video_chroma_loss=8, **EP),
     False, 240, 720),
    ("phase90-off-5-gen1", CompositeConfig(
        video_scanline_phase_shift=90, video_scanline_phase_shift_offset=-5,
        vhs_head_switching=True, video_chroma_phase_noise=60, **EP),
     True, 240, 720),
    ("phase180-off2", CompositeConfig(
        video_scanline_phase_shift=180, video_scanline_phase_shift_offset=2,
        vhs_head_switching=True, vhs_head_switching_phase_noise=0.0,
        video_chroma_loss=50000, **EP), False, 288, 720),
    ("phase270-off1", CompositeConfig(
        video_scanline_phase_shift=270, video_scanline_phase_shift_offset=1,
        vhs_head_switching=True, vhs_head_switching_point=0.52,
        vhs_head_switching_phase=0.1, vhs_head_switching_phase_noise=0.08,
        video_chroma_phase_noise=6, **EP), False, 240, 704),
    ("phase270-off7-gen1-pal", CompositeConfig(
        video_scanline_phase_shift=270, video_scanline_phase_shift_offset=7,
        ntsc=False, vhs_head_switching=True,
        vhs_head_switching_phase_noise=0.08, video_chroma_phase_noise=6,
        video_chroma_loss=8, **EP), True, 288, 720),
    ("noise-off", CompositeConfig(video_noise=0), False, 240, 720),
    # a negative phase noise draws from a negative span (torch's floored %)
    ("phase-noise-negative", CompositeConfig(
        video_chroma_phase_noise=-5, **EP), False, 240, 720),
    ("hs-only-small", CompositeConfig(
        video_noise=0, vhs_head_switching=True,
        vhs_head_switching_phase_noise=0.08), False, 16, 176),
]
CASE_IDS = [c[0] for c in CASES]

# field numbers near 0, in the middle and up to 2^31 - 1, both parities;
# then some whose walk at phase noise 60 and 240 lines (KEY) lies within
# float32 rounding of an integer or of 0 on some line, where a walk that
# rounds otherwise than the blocked one truncates otherwise (one
# sequential over the whole field does, on these)
FIELDNOS = [0, 1, 2, 3, 4242, 99999, 2 ** 31 - 2, 2 ** 31 - 1,
            5923, 101125, 177340, 268621832, 536888548, 1342279583]


# the benchmark's batch: FIELDNOS and 50 more field numbers
BATCH_FIELDNOS = FIELDNOS + [(k * 42_949_673 + 17) % 2 ** 31
                             for k in range(50)]


def _fields(dtype=torch.int32, device="cpu", fieldnos=FIELDNOS):
    fn = torch.tensor(fieldnos, dtype=dtype, device=device)
    return fn, (fn & 1) ^ 1


def _bits(s: yiq.FieldStreams) -> list:
    """Every output as integers on the CPU; floats as their int32 bits."""
    out = []
    for t in s:
        t = t.cpu().contiguous()
        out.append(t.view(torch.int32) if t.dtype == torch.float32 else t)
    return out


def _assert_streams_equal(got: yiq.FieldStreams, want: yiq.FieldStreams,
                          what: str):
    for name, g, w in zip(yiq.FieldStreams._fields, _bits(got), _bits(want)):
        assert g.dtype == w.dtype and g.shape == w.shape, (what, name)
        bad = (g != w).nonzero()
        assert bad.numel() == 0, (f"{what} {name}: {bad.shape[0]} differ, "
                                  f"first at {bad[0].tolist()}")


# ------------------------------------------------------------ on the CPU

@pytest.mark.parametrize("name,cfg,gen1,l,w", CASES[:6], ids=CASE_IDS[:6])
def test_wrapper_on_cpu_returns_plain_version(name, cfg, gen1, l, w):
    """A CPU tensor takes yiq.field_streams itself and launches nothing."""
    fn, par = _fields()
    before = launches("field_streams")
    got = chain_prep.field_streams_fused(cfg, fn, par, l, w, KEY, gen1=gen1)
    want = yiq.field_streams(cfg, fn, par, l, w, KEY, gen1=gen1)
    _assert_streams_equal(got, want, name)
    assert launches("field_streams") == before


def _blocked_walk(u: np.ndarray) -> np.ndarray:
    """The kernel's walk (csrc/streams.cu): n = (n + u) * 0.5 in float32
    from 0 within each 128-line block, then 2^-(t+1) times the carry into
    the block added, the carries c' = e + 2^-128 c over the blocks' last
    zero-carry values e."""
    b, l = u.shape
    half = np.float32(0.5)
    out = np.empty(u.shape, np.float32)
    c = np.zeros(b, np.float32)
    for t0 in range(0, l, 128):
        n = np.zeros(b, np.float32)
        for t in range(t0, min(t0 + 128, l)):
            n = (n + u[:, t]) * half
            out[:, t] = n + np.float32(2.0 ** -(t - t0 + 1)) * c
        c = n + np.float32(2.0 ** -128) * c
    return out


WALK_FIELDS = 20000


@pytest.mark.parametrize("name,cfg,l", [
    ("bench-gen2", BENCH_GEN2, 240), ("bench-gen1", BENCH_GEN1, 240),
    ("mag60", CompositeConfig(video_chroma_phase_noise=60), 240),
    ("bench-gen1-pal", BENCH_GEN1, 288),
    ("mag60-1080i", CompositeConfig(video_chroma_phase_noise=60), 540)])
def test_sequential_walk_truncates_as_blocked_walk(name, cfg, l):
    """The property the kernel's sin and cos rest on: on 20,000 fields, the
    kernel's walk (a sequential float32 walk within each 128-line block,
    the carries added as the plain version adds them) equals the blocked
    walk that field_streams runs in every float32 bit, so its truncation
    is the same, -0.0 included. The steps are integers and the blocked
    form's triangle holds powers of two, so its products are exact, and a
    sum over the block ascending rounds as the sequential walk does."""
    mag = cfg.video_chroma_phase_noise
    fn = (torch.arange(WALK_FIELDS, dtype=torch.int64) * 104729
          + 12345) % (2 ** 31)
    keys = field_stage_keys(KEY, fn, 3)
    u = randint_per_field(keys, (l,), -mag, mag + 1).to(torch.float32)
    want = random_walk_per_field(keys, l, mag).numpy()
    got = _blocked_walk(u.numpy())
    bad = got.view(np.int32) != want.view(np.int32)
    assert not bad.any(), np.argwhere(bad)[:5]


def _model_source(d) -> str:
    """csrc/streams.cu with its launch rewritten to run CTA after CTA on
    the model's threads (tests/pole_model.cpp)."""
    with open(os.path.join(CSRC, "streams.cu")) as f:
        src = f.read().replace("#include <cuda_runtime.h>\n", "")
    src, n = re.subn(r"(\w+)<<<(.*?),.*?>>>\((.*?)\);",
                     r"cvsim_launch(\2, [&] { \1(\3); });", src, flags=re.S)
    assert n == 1
    (d / "streams_cpu.cu").write_text(src)
    return str(d)


@pytest.fixture(scope="module")
def streams_model(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the CPU model of csrc/streams.cu")
    d = tmp_path_factory.mktemp("streams_model")
    exe = str(d / "streams_model")
    subprocess.run([gxx, "-std=c++20", "-O1", "-ffp-contract=off",
                    "-fno-strict-aliasing", "-pthread", "-DSTREAMS_KERNEL",
                    "-I", CSRC, "-I", _model_source(d),
                    os.path.join(HERE, "pole_model.cpp"), "-o", exe],
                   check=True, capture_output=True, text=True)
    return exe


def _run_model(model, d, cfg, fn, par, l, w, gen1) -> yiq.FieldStreams:
    """cvsim_field_streams through the CPU model, on the wrapper's own
    parameters and phase table."""
    b = fn.shape[0]
    params = chain_prep._streams_params(cfg, b, l, w, KEY, gen1,
                                        fn.element_size(),
                                        par.element_size())
    mag = cfg.video_chroma_phase_noise
    table = (chain_prep._phase_table(abs(mag), torch.device("cpu")) if mag
             else torch.zeros((2, 2)))
    files = {"params": bytes(params), "fieldno": fn.numpy().tobytes(),
             "parity": par.numpy().tobytes(),
             "table": table.numpy().tobytes()}
    for name, data in files.items():
        (d / name).write_bytes(data)
    out = d / "out"
    res = subprocess.run([model, "streams", str(d), str(out)],
                         capture_output=True, text=True)
    assert res.returncode == 0, res.stdout + res.stderr
    raw = out.read_bytes()
    shapes = ((torch.int32, (b, l)), (torch.int64, (b, 2)),
              (torch.float32, (b, l, 2)), (torch.float32, (b, l)),
              (torch.int32, (b, l)))
    parts, at = [], 0
    for dtype, shape in shapes:
        n = int(np.prod(shape)) * torch.tensor([], dtype=dtype).element_size()
        parts.append(torch.frombuffer(bytearray(raw[at:at + n]),
                                      dtype=dtype).reshape(shape))
        at += n
    assert at == len(raw)
    return yiq.FieldStreams(*parts)


@pytest.mark.parametrize("name,cfg,gen1,l,w", CASES, ids=CASE_IDS)
def test_kernel_source_equals_plain_version(streams_model, tmp_path, name,
                                            cfg, gen1, l, w):
    """csrc/streams.cu, built for the CPU, equals yiq.field_streams bit
    for bit; the field numbers come as int32 and as int64."""
    for dtype in (torch.int32, torch.int64):
        fn, par = _fields(dtype)
        got = _run_model(streams_model, tmp_path, cfg, fn, par, l, w, gen1)
        want = yiq.field_streams(cfg, fn, par, l, w, KEY, gen1=gen1)
        _assert_streams_equal(got, want, f"{name} {dtype}")


# ------------------------------------------------------------ on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _phase_rows(sincos: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """The row of the phase table that each line's (sin, cos) is, bit for
    bit (int64 [B, L]); every line has to be one."""
    pairs = sincos.cpu().contiguous().view(torch.int64)[..., None]
    hit = pairs == table.cpu().contiguous().view(torch.int64)[:, 0]
    assert hit.any(-1).all()
    return hit.int().argmax(-1)


def _assert_equal_to_cpu(got, cpu, cfg, dev, what: str):
    """Every output equal to the CPU's plain version. sin and cos are
    torch's own on each device, and the card's differ from the CPU's by an
    ULP at some angles (at |k| > 6 of k * pi/100): there the lines have to
    hold the same angle, the same row of each device's phase table."""
    mag = cfg.video_chroma_phase_noise
    if mag == 0:
        return _assert_streams_equal(got, cpu, what)
    _assert_streams_equal(got._replace(sincos=cpu.sincos.new_zeros(1)),
                          cpu._replace(sincos=cpu.sincos.new_zeros(1)), what)
    rows = _phase_rows(got.sincos, chain_prep._phase_table(abs(mag), dev))
    want = _phase_rows(cpu.sincos,
                       chain_prep._phase_table(abs(mag), torch.device("cpu")))
    assert torch.equal(rows, want), what


@pytest.mark.cuda
@pytest.mark.parametrize("name,cfg,gen1,l,w", CASES, ids=CASE_IDS)
def test_kernel_equals_plain_version_on_card_and_cpu(cuda_device, name, cfg,
                                                     gen1, l, w):
    """One launch; every output equal to yiq.field_streams on the card (sin
    and cos as int32 bits, so that -0.0 counts) and on the CPU (the same
    angle where the devices' sin and cos differ), at the benchmark's 64
    fields. Below 64 fields (128 rows of its blocked walk's matmul) cuBLAS
    sums the card's plain walk in another order than at 64 and more, where
    it equals the CPU's in every float: at FIELDNOS' 14 fields hundreds of
    its floats differ from the CPU's, and one truncation (field 268621832,
    line 184, at phase noise 60). The kernel's walk is the same at every
    batch, the CPU's order, so the card's plain version is taken at 64."""
    for dtype in (torch.int32, torch.int64):
        fn, par = _fields(dtype, fieldnos=BATCH_FIELDNOS)
        before = launches("field_streams")
        got = chain_prep.field_streams_fused(cfg, fn.to(cuda_device),
                                            par.to(cuda_device), l, w, KEY,
                                            gen1=gen1)
        torch.cuda.synchronize()
        assert launches("field_streams") == before + 1
        card = yiq.field_streams(cfg, fn.to(cuda_device), par.to(cuda_device),
                                 l, w, KEY, gen1=gen1)
        cpu = yiq.field_streams(cfg, fn, par, l, w, KEY, gen1=gen1)
        _assert_streams_equal(got, card, f"{name} {dtype} vs the card's")
        _assert_equal_to_cpu(got, cpu, cfg, cuda_device,
                             f"{name} {dtype} vs the CPU's")


@pytest.mark.cuda
@pytest.mark.parametrize("row0,rows", [(0, 60), (60, 60), (180, 60),
                                       (100, 37)])
def test_row_shard_prepare_equals_cpu(cuda_device, row0, rows):
    """A row shard's prepare (streams at the field's height, then its
    rows) on the card equals the CPU's."""
    fn, par = _fields()
    rgb = torch.zeros((fn.shape[0], rows, 720, 3), dtype=torch.uint8)
    got = fused_yiq.prepare(BENCH_GEN2, rgb.to(cuda_device), fn, par, KEY,
                            row0=row0, l_glob=240)
    want = fused_yiq.prepare(BENCH_GEN2, rgb, fn, par, KEY, row0=row0,
                             l_glob=240)
    _assert_streams_equal(chain_prep.streams(got),
                          chain_prep.streams(want),
                          f"rows {row0}..{row0 + rows - 1}")


@pytest.mark.cuda
@pytest.mark.parametrize("gen", ["gen2", "gen1"])
def test_library_call_takes_one_launch_and_five_syncs(cuda_device, gen):
    """One call of each library entry: one field_streams launch and the
    five syncs of the IIR tables' copies, as many as torch's sync debug
    mode warns of."""
    rng = np.random.default_rng(5)
    fn = torch.arange(100, 108, dtype=torch.int32, device=cuda_device)
    pa = (fn & 1) ^ 1
    if gen == "gen2":
        rgb = torch.from_numpy(rng.integers(0, 256, (8, 240, 720, 3)).astype(
            np.uint8)).to(cuda_device)

        def call():
            return yiq.composite_layer_rgb_auto(rgb, fn, pa, KEY,
                                                cfg=BENCH_GEN2)
    else:
        y = torch.from_numpy(rng.integers(16, 236, (8, 240, 720)).astype(
            np.uint8)).to(cuda_device)
        u = v = y[..., ::2].contiguous()

        def call():
            return yuv422.composite_video_process_auto(y, u, v, fn, pa, KEY,
                                                       cfg=BENCH_GEN1)
    call()
    torch.cuda.synchronize()
    counters = log.snapshot()["counters"]
    syncs, runs = counters.get("syncs", 0), launches("field_streams")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            call()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    counters = log.snapshot()["counters"]
    warned = [w for w in caught
              if "called a synchronizing CUDA operation" in str(w.message)]
    assert counters.get("syncs", 0) - syncs == 5 == len(warned)
    assert launches("field_streams") - runs == 1
