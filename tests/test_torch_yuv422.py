"""The port's gen-1 stages (cvsim_tpu_torch.models.yuv422) and gen-1
per-line inputs against the JAX package's, on the same numpy inputs.

Integer stages, tables and streams must match exactly. The float32 IIR
stages (the chroma lowpasses) are held to assert_chain_equal (at most
1 LSB on at most 0.1% of samples): the two packages' matrix products
accumulate in different orders, so a value that lands exactly on an
integer can truncate one LSB apart.
"""

import zlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cvsim_tpu import config as jconfig
from cvsim_tpu.models import fused_yuv as jfused_yuv
from cvsim_tpu.models import yiq as jyiq
from cvsim_tpu.models import yuv422 as jyuv
from cvsim_tpu.ops import noise as jnoise
from cvsim_tpu.ops.phase import scanline_phase_xi as j_xi
from cvsim_tpu_torch import interop
from cvsim_tpu_torch.config import CompositeConfig
from cvsim_tpu_torch.models import fused_yuv, yiq, yuv422
from cvsim_tpu_torch.testing import (GEN1_CHAIN_CONFIGS, assert_chain_equal,
                                     reference_config)

B, L, W = 3, 12, 176


def _planes(tag, lo=16, hi=236):
    rng = np.random.default_rng(zlib.crc32(tag.encode()))
    return (rng.integers(lo, hi, (B, L, W)).astype(np.int32),
            rng.integers(lo, 241, (B, L, W // 2)).astype(np.int32),
            rng.integers(lo, 241, (B, L, W // 2)).astype(np.int32))


def _xi(tag, gen1=True):
    fn = np.arange(B, dtype=np.int32) * 5 + len(tag)
    par = fn & 1
    return np.asarray(j_xi(jnp.asarray(fn), jnp.asarray(par), L, 90, 1,
                           True, gen1=gen1)).astype(np.int32)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("ntsc", [True, False])
def test_chroma_lowpass(ntsc):
    _, u, v = _planes(f"lp{ntsc}")
    want = jyuv.chroma_lowpass(*_j(u, v), ntsc=ntsc)
    got = yuv422.chroma_lowpass(*_t(u, v), ntsc=ntsc)
    for g, wnt in zip(got, want):
        assert_chain_equal(g.numpy(), np.asarray(wnt), err_msg=f"ntsc={ntsc}")


def test_chroma_lowpass_lite():
    _, u, v = _planes("lite")
    for g, wnt in zip(yuv422.chroma_lowpass_lite(*_t(u, v)),
                      jyuv.chroma_lowpass_lite(*_j(u, v))):
        assert_chain_equal(g.numpy(), np.asarray(wnt), err_msg="lite")


@pytest.mark.parametrize("nocolor", [False, True])
def test_yuv_to_ntsc_exact(nocolor):
    y, u, v = _planes(f"enc{nocolor}")
    xi = _xi("enc")
    want = jyuv.yuv_to_ntsc(*_j(y, u, v, xi), 37, nocolor)
    got = yuv422.yuv_to_ntsc(*_t(y, u, v, xi), 37, nocolor)
    for g, wnt in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wnt))


@pytest.mark.parametrize("after_yc_sep", [False, True])
def test_ntsc_to_yuv_exact(after_yc_sep):
    y, u, v = _planes(f"dec{after_yc_sep}", lo=0, hi=256)
    xi = _xi("dec")
    for amp_back in (50, 68):
        want = jyuv.ntsc_to_yuv(*_j(y, u, v, xi), amp_back, after_yc_sep)
        got = yuv422.ntsc_to_yuv(*_t(y, u, v, xi), amp_back, after_yc_sep)
        for g, wnt in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(wnt))


def test_black_key_feedback_exact():
    rng = np.random.default_rng(21)
    # dark luma and near-neutral chroma, so that many pairs key
    y = rng.integers(16, 60, (B, L, W)).astype(np.int32)
    u = rng.integers(110, 146, (B, L, W // 2)).astype(np.int32)
    v = rng.integers(110, 146, (B, L, W // 2)).astype(np.int32)
    fy, fu, fv = _planes("filter", lo=0, hi=256)
    for level in (0, 20, 40):
        want = jyuv.black_key_feedback(*_j(y, u, v, fy, fu, fv), level)
        got = yuv422.black_key_feedback(*_t(y, u, v, fy, fu, fv), level)
        for gp, wp in zip(got, want):
            for g, wnt in zip(gp, wp):
                np.testing.assert_array_equal(g.numpy(), np.asarray(wnt))


@pytest.mark.parametrize("w", [7, 128, 176, 720])
def test_flip_tables_exact(w):
    np.testing.assert_array_equal(
        yiq._flip_table(w, "cpu", guard_x3=False).numpy(),
        jyiq._flip_table(w, guard_x3=False) != 0)
    # gen-2's table (the default) is unchanged
    np.testing.assert_array_equal(yiq._flip_table(w, "cpu").numpy(),
                                  jyiq._flip_table(w, guard_x3=True) != 0)


@pytest.mark.parametrize("name", sorted(GEN1_CHAIN_CONFIGS))
def test_gen1_streams_exact(name):
    """The gen-1 xi table and per-line streams of field_streams(gen1=True)
    equal the JAX package's: xi from scanline_phase_xi(gen1=True), the
    stream ids, the dropout keep mask."""
    cfg = GEN1_CHAIN_CONFIGS[name].with_(
        video_scanline_phase_shift=270, video_chroma_loss=50000)
    fn = np.arange(5, dtype=np.int32) * 3 + 1
    par = fn & 1
    s = yiq.field_streams(cfg, *_t(fn, par), 40, 128,
                          interop.key32_from_seed(9), gen1=True)
    want_xi = j_xi(jnp.asarray(fn), jnp.asarray(par), 40,
                   cfg.video_scanline_phase_shift,
                   cfg.video_scanline_phase_shift_offset, cfg.ntsc, gen1=True)
    np.testing.assert_array_equal(s.xi.numpy(), np.asarray(want_xi))
    key = jax.random.PRNGKey(9)
    keys = [np.asarray(jnoise.field_stage_keys(key, jnp.asarray(fn), k))
            .astype(np.int64) & 0xFFFFFFFF for k in range(5)]
    np.testing.assert_array_equal(s.keys_ab.numpy(),
                                  np.stack([keys[0], keys[2]], -1))
    rr = np.asarray(jnoise.randint_per_field(jnp.asarray(keys[4], jnp.uint32),
                                             (40,), 0, 100000))
    np.testing.assert_array_equal(s.keep.numpy(),
                                  (rr >= cfg.video_chroma_loss))


@pytest.mark.parametrize("point,pn,l,ntsc", [
    (0.15, 0.0, 32, True),
    (0.02, 0.04, 96, True),
    (0.983, 0.04, 96, True),
    (1.0 - 4.51 / 262.5, (1 / 300) / 262.5, 240, True),
    (1.0 - 4.51 / 262.5, (1 / 300) / 262.5, 288, False),
])
def test_gen1_head_switch_exact(point, pn, l, ntsc):
    """Gen-1 head switch: the port's full shift table (both axes from the
    switch point) applied with luma-black fill equals JAX's
    head_switching_stage output exactly."""
    cfg = CompositeConfig(vhs_head_switching=True, ntsc=ntsc,
                          vhs_head_switching_point=point,
                          vhs_head_switching_phase=0.4,   # unused by gen-1
                          vhs_head_switching_phase_noise=pn)
    w = 128
    fn = np.arange(4, dtype=np.int32) + 7
    par = (fn & 1).astype(np.int32)
    rng = np.random.default_rng(l)
    y = rng.integers(0, 256, (4, l, w)).astype(np.int32)
    s = yiq.field_streams(cfg, *_t(fn, par), l, w,
                          interop.key32_from_seed(3), gen1=True)
    got = yiq.head_switching_stage(torch.from_numpy(y), s.shifts, fill=16)
    jkeys = jnoise.field_stage_keys(jax.random.PRNGKey(3), jnp.asarray(fn), 1)
    want = jyiq.head_switching_stage(
        jnp.asarray(y), jnp.asarray(par), jkeys, point=point, phase=point,
        phase_noise=pn, ntsc=ntsc, fill=16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (s.shifts.numpy() != 0).any()


def test_alpha_consts_gen1_bitwise():
    for cfg in list(GEN1_CHAIN_CONFIGS.values()) + [
            CompositeConfig(composite_preemphasis_cut=0.0, ntsc=False)]:
        for a, b in zip(fused_yuv._alpha_consts_gen1(cfg),
                        jfused_yuv._alpha_consts_gen1(
                            reference_config(cfg, jconfig))):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert a.shape[0] == fused_yuv.N_TABLES
            np.testing.assert_array_equal(a.view(np.uint32),
                                          b.view(np.uint32))
