"""The port's gen-1 chain against the JAX package.

The port's stage path (yuv422.composite_video_process) and its main-path
entry (yuv422.composite_video_process_auto: fused_yuv.prepare +
chain_reference on a CPU tensor) vs the JAX stage path
yuv422.composite_video_process (jitted) and the JAX fused kernel in
interpret mode,
on every configuration of tests/test_fused_chain.py's GEN1_CONFIGS at
(2,32,128) and (1,16,176), on its L=96 windowed head-switch cases, and
the debug taps (the stage path with kernel #9's cascades, against JAX's
stage path under CVSIM_PALLAS=1). Tolerance: assert_chain_equal (at most
1 LSB on at most 0.1% of samples per plane): both sides run the same
float32 math, but the matrix products and the sin/cos of the chroma
phase round differently in the two frameworks, so a value that lands
exactly on an integer can truncate one LSB apart.

The kernel itself is tested in tests/test_torch_kernel.py.
"""

import functools
import zlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cvsim_tpu import config as jconfig
from cvsim_tpu.models import yuv422 as jyuv
from cvsim_tpu.models.fused_yuv import composite_video_process_fused as jfused
from cvsim_tpu.ops import iir as jiir
from cvsim_tpu.ops.pallas import fused_iir as jfused_iir
from cvsim_tpu_torch import interop
from cvsim_tpu_torch.config import CompositeConfig
from cvsim_tpu_torch.models import yuv422
from cvsim_tpu_torch.testing import (GEN1_CHAIN_CONFIGS, assert_chain_equal,
                                     reference_config)

SHAPES = {"2x32x128": ((2, 32, 128), [0, 1], [0, 1]),
          "1x16x176": ((1, 16, 176), [2], [1])}
CASES = [(n, s) for n in sorted(GEN1_CHAIN_CONFIGS) for s in sorted(SHAPES)]


def _planes(tag, b, l, w):
    rng = np.random.default_rng(zlib.crc32(tag.encode()))
    return (rng.integers(16, 236, (b, l, w)).astype(np.int32),
            rng.integers(16, 241, (b, l, w // 2)).astype(np.int32),
            rng.integers(16, 241, (b, l, w // 2)).astype(np.int32))


def _check_against_jax(cfg, planes, fn, par, seed, tag, fused=True):
    """The port's stage path against JAX's, and (fused) the main path ==
    the stage path exactly and against JAX's fused kernel. Returns the
    main path's planes and JAX's stage-path arguments."""
    key = jax.random.PRNGKey(seed)
    k32 = interop.key32_from_key_data(np.asarray(jax.random.key_data(key)))
    jcfg = reference_config(cfg, jconfig)
    jp = [jnp.asarray(p) for p in planes]
    jfn, jpar = jnp.asarray(fn, jnp.int32), jnp.asarray(par, jnp.int32)
    want_stage = jyuv.composite_video_process_jit(*jp, jfn, jpar, key,
                                                  cfg=jcfg)
    tp = [torch.from_numpy(p) for p in planes]
    tfn = torch.tensor(fn, dtype=torch.int32)
    tpar = torch.tensor(par, dtype=torch.int32)
    got_stage = yuv422.composite_video_process(*tp, tfn, tpar, k32, cfg=cfg)
    got_main = yuv422.composite_video_process_auto(*tp, tfn, tpar, k32,
                                                   cfg=cfg)
    for k, (gs, gm, ws) in enumerate(zip(got_stage, got_main, want_stage)):
        gs, gm = gs.numpy(), gm.numpy()
        assert gm.dtype == np.uint8 and gm.shape == planes[k].shape
        if fused:
            np.testing.assert_array_equal(gm, gs, err_msg=f"{tag} plane {k}")
        assert_chain_equal(gs, np.asarray(ws), err_msg=f"{tag} plane {k} "
                                                       "vs jax stage")
    if fused:
        want_fused = jfused(*jp, jfn, jpar, key, cfg=jcfg, interpret=True)
        for k, (gs, wf) in enumerate(zip(got_stage, want_fused)):
            assert_chain_equal(gs.numpy(), np.asarray(wf),
                               err_msg=f"{tag} plane {k} vs jax fused")
    return [p.numpy() for p in got_main], (jp, jfn, jpar, key, jcfg)


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
def test_gen1_debug_tap_stage_path(tap, monkeypatch):
    """The debug taps run on the stage path (kernels #5-#8 do not carry
    them, as in the JAX package): the port's plain stage path against
    JAX's, and the route, whose pole cascades run on kernel #9 (its plain
    version on the CPU), against JAX's stage path with its cascades on the
    fused-IIR kernel (CVSIM_PALLAS=1; interpret mode here)."""
    cfg = CompositeConfig(video_noise=3, emulating_vhs=True, **{tap: True})
    planes = _planes(tap, 2, 32, 128)
    got_main, (jp, jfn, jpar, key, jcfg) = _check_against_jax(
        cfg, planes, [0, 1], [0, 1], 5, tap, fused=False)
    monkeypatch.setattr(jiir, "_pallas_ok", lambda x: True)
    monkeypatch.setattr(jfused_iir, "fused_iir", functools.partial(
        jfused_iir.fused_iir, interpret=True))
    # not jitted, so the cascades dispatch now, under the patch
    want = jyuv.composite_video_process(*jp, cfg=jcfg, fieldno=jfn,
                                        field_parity=jpar, key=key)
    for k, (gm, w) in enumerate(zip(got_main, want)):
        assert_chain_equal(gm, np.asarray(w),
                           err_msg=f"{tap} plane {k} vs jax CVSIM_PALLAS=1")
