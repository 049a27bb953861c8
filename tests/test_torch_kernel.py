"""The CUDA kernels of the gen-2 chain (csrc/yiq_chain.cu) and of the gen-1
chain (csrc/yuv_chain.cu) against their plain PyTorch versions, and the
wrappers' contracts.

Imports torch and the port only (no jax), so that on a GPU host the
`cuda`-marked tests run without jax's CPU setup in tests/conftest.py:

    python -m pytest --noconftest -m cuda tests/test_torch_kernel.py -q

Without a card they skip. Tolerance: assert_chain_equal (at most 1 LSB on at most 0.1% of
samples): the kernel and the plain chain run the same float32 math, but
the plain chain's products go through cuBLAS with another summation order.
"""

import zlib

import numpy as np
import pytest
import torch

from cvsim_tpu_torch.models import fused_yiq, fused_yuv
from cvsim_tpu_torch.testing import (BENCH_GEN1_EP, BENCH_VHS_EP,
                                     CHAIN_CONFIGS, GEN1_CHAIN_CONFIGS,
                                     assert_chain_equal)

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
