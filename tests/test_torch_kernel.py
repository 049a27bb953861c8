"""The CUDA kernels of the gen-2 chain (csrc/yiq_chain.cu: #1 the whole
chain, #2-#4 its split stage groups for row shards), of the gen-1 chain
(csrc/yuv_chain.cu: #5 the whole chain, #6-#8 its split stage groups for
rasters above the reference's single-tile budget) and the standalone pole
cascade (csrc/fused_iir.cu, #9) against their plain PyTorch versions, and
the wrappers' contracts; the raw decoder's line-tail chain
(csrc/raw28.cu, raw28_tails) exactly against its plain loop, with
decode_lines, scanimate_field and cmath.sqrt_rn on the card exactly
against the CPU; #1 and #5 also against the CRC32s of their
outputs pinned in testing.PINNED_CHAIN_CRC32, and #2, #3, #9, #6, #7 and
#8 (several rows a CTA) against those in testing.PINNED_CASE_CRC32 and
against themselves at other rows a CTA.

Imports torch and the port only (no jax), so that on a GPU host the
`cuda`-marked tests run without jax's CPU setup in tests/conftest.py:

    python -m pytest --noconftest -m cuda tests/test_torch_kernel.py -q

Without a card they skip. Tolerance: assert_chain_equal (at most 1 LSB on at most 0.1% of
samples): the kernel and the plain chain run the same float32 math, but
the plain chain's products go through cuBLAS with another summation order.
The split kernels' float planes are held by testing.check_split_kernels
(assert_plane_close on the plane, assert_chain_equal once carried to 8-bit
output). #9 is held to testing.iir_bound (8 float32 ULPs of max|x|, times
1 + |gain|).
"""

import ctypes
import zlib

import numpy as np
import pytest
import torch

from cvsim_tpu_torch import kernels
from cvsim_tpu_torch.config import CompositeConfig, NTSC_RATE, iir_alpha
from cvsim_tpu_torch.models import fused_yiq, fused_yuv, raw28, tools, yuv422
from cvsim_tpu_torch.ops import cmath, fused_iir
from cvsim_tpu_torch.parallel import run_fused_lines_local
from cvsim_tpu_torch.testing import (BENCH_CONFIGS, BENCH_GEN1_EP,
                                     BENCH_VHS_EP, CHAIN_CONFIGS,
                                     GEN1_CHAIN_CONFIGS, PINNED_CASE_CRC32,
                                     PINNED_CHAIN_CRC32, assert_chain_equal,
                                     case_crc32, chain_crc32, chain_inputs,
                                     check_gen1_split_kernels,
                                     check_split_kernels, iir_bound,
                                     launches, timed_cases)

SHAPES = [(2, 32, 128), (1, 16, 176)]
CASES = [(n, s) for n in sorted(CHAIN_CONFIGS) for s in SHAPES]
GEN1_CASES = [(n, s) for n in sorted(GEN1_CHAIN_CONFIGS) for s in SHAPES]


def _batch(name, shape, device):
    b, l, w = shape
    rng = np.random.default_rng(zlib.crc32(f"{name}/{shape}".encode()))
    rgb = torch.from_numpy(
        rng.integers(0, 256, (b, l, w, 3)).astype(np.uint8)).to(device)
    fn = torch.arange(b, dtype=torch.int32) + 4
    return rgb, fn, fn % 2


def test_cpu_wrapper_runs_plain_version():
    """On a CPU tensor the wrapper runs chain_reference and counts no
    launch."""
    cfg = CHAIN_CONFIGS["vhs-ep-stochastic"]
    rgb, fn, par = _batch("cpu", (2, 32, 128), "cpu")
    before = launches("yiq_chain")
    prep = fused_yiq.prepare(cfg, rgb, fn, par, 7)
    out = fused_yiq.composite_layer_rgb_fused(rgb, prep, cfg=cfg)
    assert torch.equal(out, fused_yiq.chain_reference(rgb, prep, cfg=cfg))
    assert launches("yiq_chain") == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name,shape", CASES)
def test_kernel_matches_plain(cuda_device, name, shape):
    cfg = CHAIN_CONFIGS[name]
    rgb, fn, par = _batch(name, shape, cuda_device)
    prep = fused_yiq.prepare(cfg, rgb, fn, par, 5)
    before = launches("yiq_chain")
    got = fused_yiq.composite_layer_rgb_fused(rgb, prep, cfg=cfg)
    torch.cuda.synchronize()
    assert launches("yiq_chain") == before + 1
    want = fused_yiq.chain_reference(rgb, prep, cfg=cfg)
    assert_chain_equal(got.cpu().numpy(), want.cpu().numpy(), err_msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 240, 704), (2, 540, 1888)])
def test_kernel_matches_plain_full_width(cuda_device, shape):
    rgb, fn, par = _batch("bench", shape, cuda_device)
    prep = fused_yiq.prepare(BENCH_VHS_EP, rgb, fn, par, 7)
    got = fused_yiq.composite_layer_rgb_fused(rgb, prep, cfg=BENCH_VHS_EP)
    want = fused_yiq.chain_reference(rgb, prep, cfg=BENCH_VHS_EP)
    assert_chain_equal(got.cpu().numpy(), want.cpu().numpy(),
                       err_msg=str(shape))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,name,shape", list(PINNED_CHAIN_CRC32))
def test_chain_kernels_keep_pinned_bits(cuda_device, kernel, name, shape):
    """#1 and #5 on chip_smoke.py's bench inputs: the same bytes as the
    kernels of commit b8c5917, before the pole primitives were rewritten."""
    cfg = BENCH_CONFIGS[name]
    planes, prep = chain_inputs(kernel, name, cfg, shape, cuda_device)
    assert (chain_crc32(kernel, cfg, planes, prep)
            == PINNED_CHAIN_CRC32[(kernel, name, shape)])


@pytest.mark.cuda
def test_prepare_on_card_equals_cpu(cuda_device):
    cfg = BENCH_VHS_EP
    rgb, fn, par = _batch("prep", (4, 240, 704), cuda_device)
    gpu = fused_yiq.prepare(cfg, rgb, fn, par, 7)
    cpu = fused_yiq.prepare(cfg, rgb.cpu(), fn, par, 7)
    for field in ("xi", "keys_ab", "keep", "shifts"):
        assert torch.equal(getattr(gpu, field).cpu(), getattr(cpu, field))


@pytest.mark.cuda
def test_wrapper_rejects_bad_inputs(cuda_device):
    cfg = CHAIN_CONFIGS["vhs-sp"]
    rgb, fn, par = _batch("bad", (2, 32, 128), cuda_device)
    prep = fused_yiq.prepare(cfg, rgb, fn, par, 7)
    with pytest.raises(ValueError, match="dtype"):
        fused_yiq.composite_layer_rgb_fused(rgb.to(torch.int32), prep,
                                            cfg=cfg)
    with pytest.raises(ValueError, match="contiguous"):
        fused_yiq.composite_layer_rgb_fused(
            rgb.transpose(1, 2).contiguous().transpose(1, 2), prep, cfg=cfg)
    with pytest.raises(ValueError, match="on cpu"):
        fused_yiq.composite_layer_rgb_fused(
            rgb, prep._replace(keep=prep.keep.cpu()), cfg=cfg)


# ------------------------------------------------------------ split kernels

SPLIT_CASES = [(n, s, r) for n in sorted(CHAIN_CONFIGS)
               for s, r in (((2, 64, 128), 0), ((2, 64, 128), 48),
                            ((1, 64, 176), 16))]


def _shard(name, shape, row0, device, rows=16):
    """Rows row0 .. row0+rows-1 of a batch of fields and their prepare()."""
    rgb, fn, par = _batch(name, shape, device)
    rgb = rgb[:, row0:row0 + rows].contiguous()
    return rgb, fused_yiq.prepare(CHAIN_CONFIGS[name], rgb, fn, par, 5,
                                  row0=row0, l_glob=shape[1])


def test_split_cpu_wrappers_run_plain_versions():
    """On CPU tensors the split wrappers run their plain versions and count
    no launch."""
    cfg = CHAIN_CONFIGS["vhs-ep-stochastic"]
    rgb, prep = _shard("vhs-ep-stochastic", (2, 64, 128), 48, "cpu")
    counts = (launches("yiq_a"), launches("yiq_b1"), launches("yiq_b2"))
    y = fused_yiq.stage_a(rgb, prep, cfg=cfg)
    assert torch.equal(y, fused_yiq.stage_a_reference(rgb, prep, cfg=cfg))
    planes = fused_yiq.stage_b1(y, prep, cfg=cfg, w=128)
    for g, w in zip(planes, fused_yiq.stage_b1_reference(y, prep, cfg=cfg,
                                                         w=128)):
        assert torch.equal(g, w)
    out = fused_yiq.stage_b2(*planes, prep, cfg=cfg, w=128)
    assert torch.equal(out, fused_yiq.stage_b2_reference(*planes, prep,
                                                         cfg=cfg, w=128))
    diffs = check_split_kernels(cfg, rgb, prep)
    assert all(d["rgb"] == (0, 0.0) for d in diffs.values())
    assert counts == (launches("yiq_a"), launches("yiq_b1"),
                      launches("yiq_b2"))


@pytest.mark.cuda
@pytest.mark.parametrize("name,shape,row0", SPLIT_CASES)
def test_split_kernels_match_plain(cuda_device, name, shape, row0):
    rgb, prep = _shard(name, shape, row0, cuda_device)
    before = (launches("yiq_a"), launches("yiq_b1"), launches("yiq_b2"))
    check_split_kernels(CHAIN_CONFIGS[name], rgb, prep, err_msg=name)
    after = (launches("yiq_a"), launches("yiq_b1"), launches("yiq_b2"))
    assert all(a > b for a, b in zip(after, before))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 240, 704), (2, 540, 1888)])
def test_split_program_matches_whole_chain_kernel(cuda_device, shape):
    """The line-split program over 4 row shards on one card (kernels
    #2-#4 with the seams) against kernel #1 on the whole field."""
    rgb, fn, par = _batch("split", shape, cuda_device)
    prep = fused_yiq.prepare(BENCH_VHS_EP, rgb, fn, par, 7)
    want = fused_yiq.composite_layer_rgb_fused(rgb, prep, cfg=BENCH_VHS_EP)
    got = run_fused_lines_local(BENCH_VHS_EP, rgb, fn, par, 7, sp=4)
    assert_chain_equal(got.cpu().numpy(), want.cpu().numpy(),
                       err_msg=str(shape))


@pytest.mark.cuda
def test_split_wrappers_reject_bad_inputs(cuda_device):
    cfg = CHAIN_CONFIGS["vhs-sp"]
    rgb, prep = _shard("vhs-sp", (2, 64, 128), 16, cuda_device)
    with pytest.raises(ValueError, match="dtype"):
        fused_yiq.stage_a(rgb.to(torch.int32), prep, cfg=cfg)
    y = fused_yiq.stage_a(rgb, prep, cfg=cfg)
    with pytest.raises(ValueError, match="shape"):
        fused_yiq.stage_b1(y[..., :100], prep, cfg=cfg, w=128)
    planes = fused_yiq.stage_b1(y, prep, cfg=cfg, w=128)
    with pytest.raises(ValueError, match="on cpu"):
        fused_yiq.stage_b2(*planes, prep._replace(keep=prep.keep.cpu()),
                           cfg=cfg, w=128)
    with pytest.raises(ValueError, match="whole fields"):
        fused_yiq.composite_layer_rgb_fused(rgb, prep, cfg=cfg)


# ------------------------------------------------------------ gen-1 kernel

def _planes(name, shape, device):
    b, l, w = shape
    rng = np.random.default_rng(zlib.crc32(f"g1/{name}/{shape}".encode()))
    y, u, v = (torch.from_numpy(rng.integers(0, 256, s).astype(np.uint8))
               .to(device) for s in ((b, l, w), (b, l, w // 2),
                                     (b, l, w // 2)))
    fn = torch.arange(b, dtype=torch.int32) + 4
    return y, u, v, fn, fn % 2


def test_gen1_cpu_wrapper_runs_plain_version():
    """On CPU tensors the gen-1 wrapper runs chain_reference and counts no
    launch."""
    cfg = GEN1_CHAIN_CONFIGS["full-ep-stochastic"]
    y, u, v, fn, par = _planes("cpu", (2, 32, 128), "cpu")
    before = launches("yuv_chain")
    prep = fused_yuv.prepare(cfg, y, fn, par, 7)
    got = fused_yuv.composite_video_process_fused(y, u, v, prep, cfg=cfg)
    want = fused_yuv.chain_reference(y, u, v, prep, cfg=cfg)
    for g, w in zip(got, want):
        assert g.dtype == torch.uint8 and torch.equal(g, w)
    assert launches("yuv_chain") == before


@pytest.mark.cuda
@pytest.mark.parametrize("name,shape", GEN1_CASES)
def test_gen1_kernel_matches_plain(cuda_device, name, shape):
    cfg = GEN1_CHAIN_CONFIGS[name]
    y, u, v, fn, par = _planes(name, shape, cuda_device)
    prep = fused_yuv.prepare(cfg, y, fn, par, 5)
    before = launches("yuv_chain")
    got = fused_yuv.composite_video_process_fused(y, u, v, prep, cfg=cfg)
    torch.cuda.synchronize()
    assert launches("yuv_chain") == before + 1
    want = fused_yuv.chain_reference(y, u, v, prep, cfg=cfg)
    for k, (g, w) in enumerate(zip(got, want)):
        assert_chain_equal(g.cpu().numpy(), w.cpu().numpy(),
                           err_msg=f"{name} plane {k}")


@pytest.mark.cuda
@pytest.mark.parametrize("shape,ntsc", [((8, 240, 720), True),
                                        ((8, 288, 720), False),
                                        ((2, 540, 1888), True)])
def test_gen1_kernel_matches_plain_full_width(cuda_device, shape, ntsc):
    cfg = BENCH_GEN1_EP.with_(ntsc=ntsc)
    y, u, v, fn, par = _planes("bench", shape, cuda_device)
    prep = fused_yuv.prepare(cfg, y, fn, par, 7)
    got = fused_yuv.composite_video_process_fused(y, u, v, prep, cfg=cfg)
    want = fused_yuv.chain_reference(y, u, v, prep, cfg=cfg)
    for k, (g, w) in enumerate(zip(got, want)):
        assert_chain_equal(g.cpu().numpy(), w.cpu().numpy(),
                           err_msg=f"{shape} plane {k}")


@pytest.mark.cuda
def test_gen1_prepare_on_card_equals_cpu(cuda_device):
    y, u, v, fn, par = _planes("prep", (4, 240, 720), cuda_device)
    gpu = fused_yuv.prepare(BENCH_GEN1_EP, y, fn, par, 7)
    cpu = fused_yuv.prepare(BENCH_GEN1_EP, y.cpu(), fn, par, 7)
    for field in ("xi", "keys_ab", "keep", "shifts"):
        assert torch.equal(getattr(gpu, field).cpu(), getattr(cpu, field))


@pytest.mark.cuda
def test_gen1_wrapper_rejects_bad_inputs(cuda_device):
    cfg = GEN1_CHAIN_CONFIGS["vhs-sp"]
    y, u, v, fn, par = _planes("bad", (2, 32, 128), cuda_device)
    prep = fused_yuv.prepare(cfg, y, fn, par, 7)
    with pytest.raises(ValueError, match="dtype"):
        fused_yuv.composite_video_process_fused(y.to(torch.int32), u, v,
                                                prep, cfg=cfg)
    with pytest.raises(ValueError, match="shape"):
        fused_yuv.composite_video_process_fused(y, u[..., :-1], v, prep,
                                                cfg=cfg)
    with pytest.raises(ValueError, match="on cpu"):
        fused_yuv.composite_video_process_fused(
            y, u, v, prep._replace(keep=prep.keep.cpu()), cfg=cfg)


# ------------------------------------------------------- gen-1 split kernels

def _gen1_launches():
    return (launches("yuv_a"), launches("yuv_b1"), launches("yuv_b2"))


def test_gen1_split_check_on_cpu_is_exact():
    """On CPU tensors check_gen1_split_kernels compares each plain version
    with itself (and the split route with the whole plain chain): all
    exact, no launch counted."""
    cfg = GEN1_CHAIN_CONFIGS["full-ep-stochastic"]
    y, u, v, fn, par = _planes("split-cpu", (2, 32, 128), "cpu")
    prep = fused_yuv.prepare(cfg, y, fn, par, 7)
    before = _gen1_launches()
    diffs = check_gen1_split_kernels(cfg, y, u, v, prep)
    assert all(d == (0, 0.0) for d in diffs.values())
    assert _gen1_launches() == before


@pytest.mark.cuda
@pytest.mark.parametrize("name,shape", GEN1_CASES)
def test_gen1_split_kernels_match_plain(cuda_device, name, shape):
    cfg = GEN1_CHAIN_CONFIGS[name]
    y, u, v, fn, par = _planes(f"split/{name}", shape, cuda_device)
    prep = fused_yuv.prepare(cfg, y, fn, par, 5)
    before = _gen1_launches()
    check_gen1_split_kernels(cfg, y, u, v, prep, err_msg=name)
    assert all(a > b for a, b in zip(_gen1_launches(), before))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,ntsc", [((8, 288, 720), False),
                                        ((2, 540, 1888), True)])
def test_gen1_split_kernels_match_plain_full_width(cuda_device, shape, ntsc):
    cfg = BENCH_GEN1_EP.with_(ntsc=ntsc)
    y, u, v, fn, par = _planes("split-bench", shape, cuda_device)
    prep = fused_yuv.prepare(cfg, y, fn, par, 7)
    check_gen1_split_kernels(cfg, y, u, v, prep, err_msg=str(shape))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,split", [((2, 240, 720), False),
                                         ((2, 288, 720), True)])
def test_gen1_route_on_card(cuda_device, shape, split):
    """composite_video_process_fused launches #6-#8 above the reference's
    single-tile budget (576i PAL) and #5 below it (480i)."""
    cfg = BENCH_GEN1_EP.with_(ntsc=not split)
    y, u, v, fn, par = _planes("route", shape, cuda_device)
    prep = fused_yuv.prepare(cfg, y, fn, par, 7)
    merged, splits = launches("yuv_chain"), _gen1_launches()
    fused_yuv.composite_video_process_fused(y, u, v, prep, cfg=cfg)
    torch.cuda.synchronize()
    assert launches("yuv_chain") == merged + (0 if split else 1)
    assert _gen1_launches() == tuple(n + int(split) for n in splits)


@pytest.mark.cuda
def test_gen1_split_wrappers_reject_bad_inputs(cuda_device):
    cfg = GEN1_CHAIN_CONFIGS["vhs-sp"]
    y, u, v, fn, par = _planes("bad-split", (2, 32, 128), cuda_device)
    prep = fused_yuv.prepare(cfg, y, fn, par, 7)
    with pytest.raises(ValueError, match="dtype"):
        fused_yuv.stage_a(y.to(torch.int32), u, v, prep, cfg=cfg)
    y_a = fused_yuv.stage_a(y, u, v, prep, cfg=cfg)
    with pytest.raises(ValueError, match="shape"):
        fused_yuv.stage_b1(y_a[:, :16].contiguous(), prep, cfg=cfg)
    p1 = fused_yuv.stage_b1(y_a, prep, cfg=cfg)
    with pytest.raises(ValueError, match="shape"):
        fused_yuv.stage_b2(p1[0], p1[1][..., :-1].contiguous(), p1[2], prep,
                           cfg=cfg)
    with pytest.raises(ValueError, match="on cpu"):
        fused_yuv.stage_b2(*p1, prep._replace(keep=prep.keep.cpu()), cfg=cfg)
    with pytest.raises(ValueError, match="debug taps"):
        fused_yuv.stage_a(y, u, v, prep,
                          cfg=cfg.with_(nocolor_subcarrier=True))


# ------------------------------------------------------ the pole cascade #9

IIR_GAINS = {"none": 0.0, "emph": 7.0, "unsharp": 1.5}


@pytest.mark.cuda
@pytest.mark.parametrize("mode", sorted(IIR_GAINS))
@pytest.mark.parametrize("w", [128, 176, 720, 1888])
def test_fused_iir_matches_plain(cuda_device, mode, w):
    rng = np.random.default_rng(w + len(mode))
    x = torch.from_numpy(rng.integers(0, 256, (3, 100, w)).astype(
        np.float32)).to(cuda_device)
    for k in (1, 2, 3, 4):
        kw = dict(alphas=tuple(float(iir_alpha(NTSC_RATE, c))
                               for c in (1.4e6, 2.4e6, 6e5, 2.8e6)[:k]),
                  y0s=(16.0, 128.0, 0.0, 16.0)[:k], mode=mode,
                  gain=IIR_GAINS[mode])
        before = launches("fused_iir")
        got = fused_iir.fused_iir(x, **kw)
        torch.cuda.synchronize()
        assert launches("fused_iir") == before + 1
        want = fused_iir.fused_iir_reference(x, **kw)
        d = float((got - want).abs().max())
        assert d <= iir_bound(255.0, IIR_GAINS[mode]), (k, d)


@pytest.mark.cuda
def test_fused_iir_rejects_bad_inputs(cuda_device):
    x = torch.zeros(4, 128, device=cuda_device)
    with pytest.raises(ValueError, match="dtype"):
        fused_iir.fused_iir(x.double(), alphas=(0.5,), y0s=(0.0,))
    with pytest.raises(ValueError, match="mode"):
        fused_iir.fused_iir(x, alphas=(0.5,), y0s=(0.0,), mode="x")


@pytest.mark.cuda
@pytest.mark.parametrize("tap", ["nocolor_subcarrier",
                                 "nocolor_subcarrier_after_yc_sep"])
def test_debug_tap_route_runs_fused_iir(cuda_device, tap):
    """The gen-1 debug taps take the stage path with its pole cascades on
    kernel #9; the card's output against the CPU run's (plain versions)."""
    cfg = CompositeConfig(video_noise=3, emulating_vhs=True, **{tap: True})
    y, u, v, fn, par = _planes(tap, (2, 48, 720), cuda_device)
    before = launches("fused_iir")
    got = yuv422.composite_video_process_auto(y, u, v, fn, par, 7, cfg=cfg)
    torch.cuda.synchronize()
    assert launches("fused_iir") > before
    want = yuv422.composite_video_process_auto(
        y.cpu(), u.cpu(), v.cpu(), fn, par, 7, cfg=cfg)
    for k, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == torch.uint8
        assert_chain_equal(g.cpu().numpy(), w.numpy(), err_msg=f"plane {k}")


# ----------------------- several rows a CTA (#2, #3, #4, #9, #6, #7, #8)

@pytest.fixture(scope="module")
def timed():
    """testing.timed_cases on the card, by "kernel label"."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return {f"{c.kernel} {c.label}": c
            for c in timed_cases(torch.device("cuda", 0))}


@pytest.mark.cuda
@pytest.mark.parametrize("label", sorted(PINNED_CASE_CRC32))
def test_multi_row_kernels_keep_pinned_bits(timed, label):
    """#3 and #9 on their timed cases: the same bytes as the kernels of
    commit 6f83bf8, which took one row a CTA; #7 and #8 as those of commit
    3552a33; #6 and #2 as those of commit a7f4f68; #4 as those of commit
    f9f71a9."""
    assert case_crc32(timed[label]) == PINNED_CASE_CRC32[label]


def _rows_override():
    """The kernel library's cvsim_rows_per_cta_override (0: each
    multi-row kernel chooses its rows a CTA)."""
    return ctypes.c_int.in_dll(kernels.load(), "cvsim_rows_per_cta_override")


@pytest.mark.cuda
@pytest.mark.parametrize("rows_per_cta", [1, 3, 4, 7])
def test_multi_row_kernels_at_any_rows_per_cta(cuda_device, rows_per_cta):
    """#9 at three widths, #2, #3 and #4 on a row shard of 37 rows (CTAs
    that hold rows of two fields) and #6, #7, #8 on 39 gen-1 rows give the
    same bytes at any rows a CTA (set through cvsim_rows_per_cta_override)
    as at the count the kernels choose, rows across rounds of 16 blocks
    and a short last CTA included."""
    cfg = CHAIN_CONFIGS["vhs-ep-stochastic"]
    rgb, prep = _shard("vhs-ep-stochastic", (3, 64, 720), 16, cuda_device,
                       rows=37)
    y = fused_yiq.head_switch_rows(fused_yiq.stage_a(rgb, prep, cfg=cfg),
                                   prep.shifts, 720)
    planes = fused_yiq.stage_b1(y, prep, cfg=cfg, w=720)
    cfg1 = GEN1_CHAIN_CONFIGS["full-ep-stochastic"]
    y1, u1, v1, fn, par = _planes("rows-a-cta", (3, 13, 720), cuda_device)
    prep1 = fused_yuv.prepare(cfg1, y1, fn, par, 5)
    rng = np.random.default_rng(rows_per_cta)
    xs = [torch.from_numpy(rng.integers(0, 256, (37, w)).astype(np.float32))
          .to(cuda_device) for w in (360, 720, 1888)]
    kw = dict(alphas=(0.3, 0.2, 0.25), y0s=(16.0, 128.0, 0.0), mode="emph",
              gain=1.6)

    def run():
        return ([fused_iir.fused_iir(x, **kw) for x in xs]
                + [fused_yiq.stage_a(rgb, prep, cfg=cfg)]
                + list(fused_yiq.stage_b1(y, prep, cfg=cfg, w=720))
                + [fused_yiq.stage_b2(*planes, prep, cfg=cfg, w=720)]
                + [fused_yuv.stage_a(y1, u1, v1, prep1, cfg=cfg1)]
                + list(fused_yuv.stage_b1(y1, prep1, cfg=cfg1))
                + list(fused_yuv.stage_b2(y1, u1, v1, prep1, cfg=cfg1)))

    want = run()
    lib = kernels.load()
    override = _rows_override()
    override.value = rows_per_cta
    try:
        assert lib.cvsim_fused_iir_rows_per_cta(768) == rows_per_cta
        assert lib.cvsim_yiq_a_rows_per_cta(768) == rows_per_cta
        assert lib.cvsim_yiq_b1_rows_per_cta(768) == rows_per_cta
        assert lib.cvsim_yiq_b2_rows_per_cta(768) == rows_per_cta
        assert lib.cvsim_yuv_a_rows_per_cta(768, 384) == rows_per_cta
        assert lib.cvsim_yuv_b1_rows_per_cta(768, 384) == rows_per_cta
        assert lib.cvsim_yuv_b2_rows_per_cta(768, 384) == rows_per_cta
        got = run()
    finally:
        override.value = 0
    for g, w in zip(got, want, strict=True):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("rows_per_cta", [1, 3, 4])
def test_gen1_multi_row_kernels_keep_pinned_bits_at_any_rows_per_cta(
        timed, rows_per_cta):
    """#7 and #8 on their timed cases (576i PAL B=64, 1080i B=16) at 1, 3
    and 4 rows a CTA: the bytes of the one-row kernels of commit 3552a33."""
    labels = [k for k in sorted(PINNED_CASE_CRC32)
              if k.startswith(("yuv_b1 ", "yuv_b2 "))]
    assert len(labels) == 4
    override = _rows_override()
    override.value = rows_per_cta
    try:
        crcs = {k: case_crc32(timed[k]) for k in labels}
    finally:
        override.value = 0
    assert crcs == {k: PINNED_CASE_CRC32[k] for k in labels}


@pytest.mark.cuda
@pytest.mark.parametrize("rows_per_cta", [1, 2, 3, 4])
def test_stage_a_kernels_keep_pinned_bits_at_any_rows_per_cta(
        timed, rows_per_cta):
    """#6 (576i PAL B=64, 1080i B=16) and #2 (480i B=64, 1080i B=16) on
    their timed cases at 1 to 4 rows a CTA: the bytes of the one-row
    kernels of commit a7f4f68."""
    labels = [k for k in sorted(PINNED_CASE_CRC32)
              if k.startswith(("yuv_a ", "yiq_a "))]
    assert len(labels) == 4
    override = _rows_override()
    override.value = rows_per_cta
    try:
        crcs = {k: case_crc32(timed[k]) for k in labels}
    finally:
        override.value = 0
    assert crcs == {k: PINNED_CASE_CRC32[k] for k in labels}


@pytest.mark.cuda
@pytest.mark.parametrize("rows_per_cta", [1, 2, 3, 4])
def test_yiq_b2_keeps_pinned_bits_at_any_rows_per_cta(timed, rows_per_cta):
    """#4 on its timed cases (480i B=64, 1080i B=16) at 1 to 4 rows a CTA:
    the bytes of the one-row kernel of commit f9f71a9."""
    labels = [k for k in sorted(PINNED_CASE_CRC32) if k.startswith("yiq_b2 ")]
    assert len(labels) == 2
    override = _rows_override()
    override.value = rows_per_cta
    try:
        crcs = {k: case_crc32(timed[k]) for k in labels}
    finally:
        override.value = 0
    assert crcs == {k: PINNED_CASE_CRC32[k] for k in labels}


def _raw28_tail_inputs(n: int, device):
    rng = np.random.default_rng(n)
    as_t = lambda a: torch.from_numpy(a.astype(np.int32)).to(device)
    return (as_t(rng.integers(-255, 256, (n, raw28.TAIL_COLS))),
            as_t(rng.integers(-300, 300, (n, raw28.OUT_COLS))),
            as_t(rng.integers(-200, 200, raw28.CARRY)))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 1, 262, 300])
def test_raw28_tails_matches_plain(cuda_device, n):
    """raw28_tails == tail_chain_reference exactly (integers only), one
    launch for all lines: none, one (the kernel's two-line prefetch past
    the last line), a field and more."""
    args = _raw28_tail_inputs(n, cuda_device)
    before = launches("raw28_tails")
    got = raw28.raw28_tails(*args)
    torch.cuda.synchronize()
    assert launches("raw28_tails") == before + 1
    want = raw28.tail_chain_reference(*(a.cpu() for a in args))
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and torch.equal(g.cpu(), w)


@pytest.mark.cuda
@pytest.mark.parametrize("flags", [{}, {"show_subcarrier": True},
                                   {"equalize": False, "full_chroma": True}])
def test_decode_lines_card_equals_cpu(cuda_device, flags):
    rng = np.random.default_rng(len(flags))
    rl = 1820
    lines = torch.from_numpy(
        rng.integers(0, 256, (262, rl + 24)).astype(np.uint8))
    carry = torch.from_numpy(rng.integers(-90, 90, 16).astype(np.int32))
    kw = dict(raw_len=rl, width=rl, **flags)
    got = raw28.decode_lines(lines.to(cuda_device), 21.0, 199.5,
                             chroma_carry=carry.to(cuda_device), **kw)
    want = raw28.decode_lines(lines, 21.0, 199.5, chroma_carry=carry, **kw)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
@pytest.mark.parametrize("ntsc", [False, True])
def test_scanimate_field_card_equals_cpu(cuda_device, ntsc):
    rng = np.random.default_rng(int(ntsc))
    fns = [e * 180 + p for e in range(4) for p in (1, 41, 141)]
    src = torch.from_numpy(
        rng.integers(0, 256, (len(fns), 64, 96, 3)).astype(np.uint8))
    got = tools.scanimate_field(src.to(cuda_device), 144, 192, 1, fns,
                                input_ntsc=ntsc)
    want = tools.scanimate_field(src, 144, 192, 1, fns, input_ntsc=ntsc)
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


@pytest.mark.cuda
def test_sqrt_rn_card_equals_cpu(cuda_device):
    """cmath.sqrt_rn on the card == numpy's correctly rounded float32
    root, where torch.sqrt on the card is one ULP off for some inputs."""
    rng = np.random.default_rng(3)
    x = rng.uniform(0, 32, 1 << 20).astype(np.float32)
    got = cmath.sqrt_rn(torch.from_numpy(x).to(cuda_device)).cpu().numpy()
    np.testing.assert_array_equal(got.view(np.int32),
                                  np.sqrt(x).view(np.int32))
