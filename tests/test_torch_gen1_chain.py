"""The port's gen-1 chain against the JAX package.

The port's stage path (yuv422.composite_video_process) and its main-path
entry (yuv422.composite_video_process_auto: fused_yuv.prepare +
chain_reference on a CPU tensor) vs the JAX stage path
yuv422.composite_video_process (jitted) and the JAX fused kernel in
interpret mode,
on every configuration of tests/test_fused_chain.py's GEN1_CONFIGS at
(2,32,128) and (1,16,176), on its L=96 windowed head-switch cases, and a
debug tap through the stage path. Tolerance: assert_chain_equal (at most
1 LSB on at most 0.1% of samples per plane): both sides run the same
float32 math, but the matrix products and the sin/cos of the chroma
phase round differently in the two frameworks, so a value that lands
exactly on an integer can truncate one LSB apart.

The kernel itself is tested in tests/test_torch_kernel.py.
"""

import zlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cvsim_tpu.config import CompositeConfig
from cvsim_tpu.models import yuv422 as jyuv
from cvsim_tpu.models.fused_yuv import composite_video_process_fused as jfused
from cvsim_tpu_torch import interop
from cvsim_tpu_torch.models import yuv422
from cvsim_tpu_torch.testing import GEN1_CHAIN_CONFIGS, assert_chain_equal

SHAPES = {"2x32x128": ((2, 32, 128), [0, 1], [0, 1]),
          "1x16x176": ((1, 16, 176), [2], [1])}
CASES = [(n, s) for n in sorted(GEN1_CHAIN_CONFIGS) for s in sorted(SHAPES)]


def _planes(tag, b, l, w):
    rng = np.random.default_rng(zlib.crc32(tag.encode()))
    return (rng.integers(16, 236, (b, l, w)).astype(np.int32),
            rng.integers(16, 241, (b, l, w // 2)).astype(np.int32),
            rng.integers(16, 241, (b, l, w // 2)).astype(np.int32))


def _check_against_jax(cfg, planes, fn, par, seed, tag, fused=True):
    key = jax.random.PRNGKey(seed)
    k32 = interop.key32_from_key_data(np.asarray(jax.random.key_data(key)))
    jp = [jnp.asarray(p) for p in planes]
    jfn, jpar = jnp.asarray(fn, jnp.int32), jnp.asarray(par, jnp.int32)
    want_stage = jyuv.composite_video_process_jit(*jp, jfn, jpar, key,
                                                  cfg=cfg)
    tp = [torch.from_numpy(p) for p in planes]
    tfn = torch.tensor(fn, dtype=torch.int32)
    tpar = torch.tensor(par, dtype=torch.int32)
    got_stage = yuv422.composite_video_process(*tp, tfn, tpar, k32, cfg=cfg)
    got_main = yuv422.composite_video_process_auto(*tp, tfn, tpar, k32,
                                                   cfg=cfg)
    for k, (gs, gm, ws) in enumerate(zip(got_stage, got_main, want_stage)):
        gs, gm = gs.numpy(), gm.numpy()
        assert gm.dtype == np.uint8 and gm.shape == planes[k].shape
        np.testing.assert_array_equal(gm, gs, err_msg=f"{tag} plane {k}")
        assert_chain_equal(gs, np.asarray(ws), err_msg=f"{tag} plane {k} "
                                                       "vs jax stage")
    if fused:
        want_fused = jfused(*jp, jfn, jpar, key, cfg=cfg, interpret=True)
        for k, (gs, wf) in enumerate(zip(got_stage, want_fused)):
            assert_chain_equal(gs.numpy(), np.asarray(wf),
                               err_msg=f"{tag} plane {k} vs jax fused")


@pytest.mark.parametrize("name,shape_name", CASES)
def test_gen1_chain_matches_jax(name, shape_name):
    (b, l, w), fn, par = SHAPES[shape_name]
    planes = _planes(f"{name}/{shape_name}", b, l, w)
    _check_against_jax(GEN1_CHAIN_CONFIGS[name], planes, fn, par, 5, name)


@pytest.mark.parametrize("point", [0.02, 0.983])
def test_gen1_windowed_head_switch_matches_jax(point):
    """L=96 fields, taller than the TPU kernel's 72-row head-switch
    window, at a switch point near the top (l_start < 0) and near the
    bottom (window start clipped)."""
    cfg = CompositeConfig(
        video_noise=0, emulating_vhs=True, vhs_head_switching=True,
        vhs_head_switching_point=point,
        vhs_head_switching_phase_noise=0.04)
    planes = _planes(f"g1win-{point}", 2, 96, 128)
    _check_against_jax(cfg, planes, [0, 3], [0, 1], 11, f"point={point}")


@pytest.mark.parametrize("tap", ["nocolor_subcarrier",
                                 "nocolor_subcarrier_after_yc_sep"])
def test_gen1_debug_tap_stage_path(tap):
    """The debug taps run on the stage path (the kernel does not carry
    them, as in the JAX package)."""
    cfg = CompositeConfig(video_noise=3, emulating_vhs=True, **{tap: True})
    planes = _planes(tap, 2, 32, 128)
    _check_against_jax(cfg, planes, [0, 1], [0, 1], 5, tap, fused=False)
