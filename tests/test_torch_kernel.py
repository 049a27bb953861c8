"""The CUDA kernels of the gen-2 chain (csrc/yiq_chain.cu: #1 the whole
chain, #2-#4 its split stage groups for row shards) and of the gen-1 chain
(csrc/yuv_chain.cu, #5) against their plain PyTorch versions, and the
wrappers' contracts.

Imports torch and the port only (no jax), so that on a GPU host the
`cuda`-marked tests run without jax's CPU setup in tests/conftest.py:

    python -m pytest --noconftest -m cuda tests/test_torch_kernel.py -q

Without a card they skip. Tolerance: assert_chain_equal (at most 1 LSB on at most 0.1% of
samples): the kernel and the plain chain run the same float32 math, but
the plain chain's products go through cuBLAS with another summation order.
The split kernels' float planes are held by testing.check_split_kernels
(assert_plane_close on the plane, assert_chain_equal once carried to 8-bit
output).
"""

import zlib

import numpy as np
import pytest
import torch

from cvsim_tpu_torch.models import fused_yiq, fused_yuv
from cvsim_tpu_torch.parallel import run_fused_lines_local
from cvsim_tpu_torch.testing import (BENCH_GEN1_EP, BENCH_VHS_EP,
                                     CHAIN_CONFIGS, GEN1_CHAIN_CONFIGS,
                                     assert_chain_equal, check_split_kernels)

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
    before = fused_yiq.KERNEL_LAUNCHES
    prep = fused_yiq.prepare(cfg, rgb, fn, par, 7)
    out = fused_yiq.composite_layer_rgb_fused(rgb, prep, cfg=cfg)
    assert torch.equal(out, fused_yiq.chain_reference(rgb, prep, cfg=cfg))
    assert fused_yiq.KERNEL_LAUNCHES == before


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
    before = fused_yiq.KERNEL_LAUNCHES
    got = fused_yiq.composite_layer_rgb_fused(rgb, prep, cfg=cfg)
    torch.cuda.synchronize()
    assert fused_yiq.KERNEL_LAUNCHES == before + 1
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
    counts = (fused_yiq.A_LAUNCHES, fused_yiq.B1_LAUNCHES,
              fused_yiq.B2_LAUNCHES)
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
    assert counts == (fused_yiq.A_LAUNCHES, fused_yiq.B1_LAUNCHES,
                      fused_yiq.B2_LAUNCHES)


@pytest.mark.cuda
@pytest.mark.parametrize("name,shape,row0", SPLIT_CASES)
def test_split_kernels_match_plain(cuda_device, name, shape, row0):
    rgb, prep = _shard(name, shape, row0, cuda_device)
    before = (fused_yiq.A_LAUNCHES, fused_yiq.B1_LAUNCHES,
              fused_yiq.B2_LAUNCHES)
    check_split_kernels(CHAIN_CONFIGS[name], rgb, prep, err_msg=name)
    after = (fused_yiq.A_LAUNCHES, fused_yiq.B1_LAUNCHES,
             fused_yiq.B2_LAUNCHES)
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
    before = fused_yuv.KERNEL_LAUNCHES
    prep = fused_yuv.prepare(cfg, y, fn, par, 7)
    got = fused_yuv.composite_video_process_fused(y, u, v, prep, cfg=cfg)
    want = fused_yuv.chain_reference(y, u, v, prep, cfg=cfg)
    for g, w in zip(got, want):
        assert g.dtype == torch.uint8 and torch.equal(g, w)
    assert fused_yuv.KERNEL_LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("name,shape", GEN1_CASES)
def test_gen1_kernel_matches_plain(cuda_device, name, shape):
    cfg = GEN1_CHAIN_CONFIGS[name]
    y, u, v, fn, par = _planes(name, shape, cuda_device)
    prep = fused_yuv.prepare(cfg, y, fn, par, 5)
    before = fused_yuv.KERNEL_LAUNCHES
    got = fused_yuv.composite_video_process_fused(y, u, v, prep, cfg=cfg)
    torch.cuda.synchronize()
    assert fused_yuv.KERNEL_LAUNCHES == before + 1
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
