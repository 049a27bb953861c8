"""The port's primitives (cvsim_tpu_torch.ops and the per-line inputs of
models) against the JAX package on the same numpy inputs.

Integer tables and noise words must match exactly; float32 IIR outputs
are held to the tolerance tests/test_iir.py uses for float32 blocked-vs-
scan agreement (rtol 2e-5, atol 0.25 on plane-scale values): the two
packages' matrix products accumulate in different orders.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cvsim_tpu import config as jconfig
from cvsim_tpu.models import fused_yiq as jfused
from cvsim_tpu.models import yiq as jyiq
from cvsim_tpu.ops import blocked_iir as jbiir
from cvsim_tpu.ops import cmath as jcmath
from cvsim_tpu.ops import iir as jiir
from cvsim_tpu.ops import noise as jnoise
from cvsim_tpu.ops.phase import scanline_phase_xi as j_xi
from cvsim_tpu_torch import interop
from cvsim_tpu_torch.config import CompositeConfig, NTSC_RATE, iir_alpha
from cvsim_tpu_torch.models import fused_yiq, yiq
from cvsim_tpu_torch.ops import blocked_iir, cmath, iir, noise
from cvsim_tpu_torch.ops.phase import scanline_phase_xi
from cvsim_tpu_torch.testing import CHAIN_CONFIGS, reference_config


def test_cmath_exact():
    rng = np.random.default_rng(1)
    f = np.concatenate([rng.uniform(-400, 400, 1000),
                        [-1.5, -0.5, 0.5, 255.9, 256.0]]).astype(np.float32)
    i = rng.integers(-100000, 100000, 1000).astype(np.int32)
    np.testing.assert_array_equal(cmath.clampu8(torch.from_numpy(f)).numpy(),
                                  np.asarray(jcmath.clampu8(jnp.asarray(f))))
    np.testing.assert_array_equal(cmath.c_int(torch.from_numpy(f)).numpy(),
                                  np.asarray(jcmath.c_int(jnp.asarray(f))))
    for d in (4, 8, 50, -7):
        np.testing.assert_array_equal(
            cmath.c_div(torch.from_numpy(i), d).numpy(),
            np.asarray(jcmath.c_div(jnp.asarray(i), d)))


def test_sqrt_rn_correctly_rounded():
    """cmath.sqrt_rn == the correctly rounded float32 root (numpy's and
    XLA's), over a wide range of normal magnitudes and the scanimate
    stamp's (XLA flushes subnormals to zero, so none is drawn)."""
    rng = np.random.default_rng(2)
    x = np.concatenate([
        np.float32(2.0) ** rng.uniform(-60, 60, 20000).astype(np.float32),
        rng.uniform(0, 32, 20000).astype(np.float32),
        [0.0, 1.0, 2.0, 4.0, np.finfo(np.float32).tiny, 3.4e38]]
    ).astype(np.float32)
    got = cmath.sqrt_rn(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32),
                                  np.sqrt(x).view(np.int32))
    np.testing.assert_array_equal(
        got.view(np.int32), np.asarray(jnp.sqrt(jnp.asarray(x))).view(np.int32))


def _u32(t):
    return np.asarray(t).astype(np.int64) & 0xFFFFFFFF


def test_mix32_exact():
    x = np.random.default_rng(0).integers(0, 2 ** 32, 4096, dtype=np.uint64)
    x = np.concatenate([x, [0, 1, 2 ** 31, 2 ** 32 - 1]]).astype(np.uint32)
    want = np.asarray(jnoise.mix32(jnp.asarray(x)))
    got = noise.mix32(torch.from_numpy(x.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("seed", [0, 5, 7, 12345, 2 ** 31 + 9])
def test_key32_from_seed_matches_jax(seed):
    kd = np.asarray(jax.random.key_data(jax.random.PRNGKey(seed)))
    want = int(jnoise._key32(jax.random.PRNGKey(seed)))
    assert interop.key32_from_key_data(kd) == want
    assert interop.key32_from_seed(seed) == want


def test_key32_seed7_is_not_noise_np_stream():
    # the engine's stream for seed 7; ops/noise_np.stream_id(7) is another
    assert interop.key32_from_seed(7) == 1733237950


@pytest.mark.parametrize("stage", range(5))
def test_field_stage_keys_exact(stage):
    fn = np.array([0, 1, 2, 63, 64, 1000, 2 ** 20], np.int32)
    key = jax.random.PRNGKey(7)
    want = _u32(jnoise.field_stage_keys(key, jnp.asarray(fn), stage))
    got = noise.field_stage_keys(interop.key32_from_seed(7),
                                 torch.from_numpy(fn), stage).numpy()
    np.testing.assert_array_equal(got, want)


def test_randint_per_field_exact():
    keys = np.array([1, 2 ** 32 - 1, 1733237950], np.uint32)
    for shape, lo, hi in (((37,), 0, 100000), ((3, 50), -6, 7),
                          ((2, 4, 9), -22, 23)):
        want = np.asarray(jnoise.randint_per_field(jnp.asarray(keys), shape,
                                                   lo, hi))
        got = noise.randint_per_field(
            torch.from_numpy(keys.astype(np.int64)), shape, lo, hi).numpy()
        np.testing.assert_array_equal(got, want)


def test_uniform_pm1_exact():
    keys = np.array([0, 9, 2 ** 31, 2 ** 32 - 1], np.uint32)
    want = np.asarray(jnoise.uniform_pm1_per_field(jnp.asarray(keys)))
    got = noise.uniform_pm1_per_field(
        torch.from_numpy(keys.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shift", [0, 90, 180, 270])
@pytest.mark.parametrize("ntsc", [True, False])
@pytest.mark.parametrize("gen1", [False, True])
def test_scanline_phase_xi_exact(shift, ntsc, gen1):
    fn = np.array([0, 1, 2, 3, 7, 100], np.int32)
    par = fn & 1
    for offset in (0, 1, 3):
        want = np.asarray(j_xi(jnp.asarray(fn), jnp.asarray(par), 21, shift,
                               offset, ntsc, gen1=gen1))
        got = scanline_phase_xi(torch.from_numpy(fn), torch.from_numpy(par),
                                21, shift, offset, ntsc, gen1=gen1).numpy()
        np.testing.assert_array_equal(got, want)


def test_delay_writeback_exact():
    rng = np.random.default_rng(3)
    orig = rng.integers(-500, 500, (3, 40)).astype(np.int32)
    filt = rng.integers(-500, 500, (3, 40)).astype(np.int32)
    for delay in (0, 1, 2, 4, 9, 14):
        want = np.asarray(jiir.delay_writeback(jnp.asarray(orig),
                                               jnp.asarray(filt), delay))
        got = iir.delay_writeback(torch.from_numpy(orig),
                                  torch.from_numpy(filt), delay).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("w", [100, 704, 1888, 2300])   # nb 1, 6, 15, 19
@pytest.mark.parametrize("three", [False, True])
def test_blocked_iir_f32(w, three):
    rng = np.random.default_rng(w)
    x = rng.uniform(-32768, 65280, size=(3, w)).astype(np.float32)
    alpha = iir_alpha(NTSC_RATE, 600000.0)
    jf = jbiir.iir_lowpass3_blocked if three else jbiir.iir_lowpass_blocked
    tf = (blocked_iir.iir_lowpass3_blocked if three
          else blocked_iir.iir_lowpass_blocked)
    for y0 in (0.0, 16.0):
        want = np.asarray(jf(jnp.asarray(x), alpha, y0))
        got = tf(torch.from_numpy(x), alpha, y0).numpy()
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=0.25)


def test_alpha_consts_bitwise():
    for cfg in list(CHAIN_CONFIGS.values()) + [
            CompositeConfig(composite_preemphasis_cut=0.0)]:
        for a, b in zip(interop.alpha_consts(cfg),
                        jfused._alpha_consts(reference_config(cfg, jconfig))):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a.view(np.uint32),
                                          b.view(np.uint32))


HS_CASES = [  # (point, phase, phase_noise, l, ntsc)
    (0.15, 0.15, 0.0, 32, True),
    (0.52, 0.1, 0.08, 96, True),
    (0.02, 0.02, 0.04, 96, True),
    (0.983, 0.983, 0.04, 96, True),
    (1.0 - 4.51 / 262.5, 0.99 / 262.5, (1 / 500) / 262.5, 240, True),
    (1.0 - 4.51 / 262.5, 0.99 / 262.5, (1 / 500) / 262.5, 288, False),
    (-0.3, -0.7, 0.02, 540, True),
]


@pytest.mark.parametrize("case", range(len(HS_CASES)))
def test_head_switch_shift_table_exact(case):
    point, phase, pn, l, ntsc = HS_CASES[case]
    w = 176
    twidth = w + w // 10
    fn = np.arange(6, dtype=np.int32) + 11
    par = (fn & 1).astype(np.int32)
    jkeys = jnoise.field_stage_keys(jax.random.PRNGKey(3), jnp.asarray(fn), 1)
    tkeys = noise.field_stage_keys(interop.key32_from_seed(3),
                                   torch.from_numpy(fn), 1)
    got = yiq.head_switch_shifts(l, torch.from_numpy(par), tkeys,
                                 point=point, phase=phase, phase_noise=pn,
                                 twidth=twidth, ntsc=ntsc).numpy()
    # the stage path's schedule, field by field
    ishif, l_start = jyiq._head_switch_geometry(
        jnp.asarray(par), jkeys, point=point, phase=phase, phase_noise=pn,
        twidth=twidth, ntsc=ntsc, dtype=jnp.float32)
    for b in range(len(fn)):
        want = np.asarray(jyiq._head_switch_shift_schedule(
            ishif[b], l_start[b], l))
        np.testing.assert_array_equal(got[b], want)
    # the fused path's 8-aligned window, placed at rows w0a..w0a+win
    win = jfused._hs_window_rows(l)
    wsh, w0a = jyiq.head_switch_window_shifts(
        l, jnp.asarray(par), jkeys, point=point, phase=phase,
        phase_noise=pn, twidth=twidth, ntsc=ntsc, win=win)
    wsh, w0a = np.asarray(wsh), np.asarray(w0a)
    for b in range(len(fn)):
        placed = np.zeros(l, np.int32)
        placed[w0a[b]:w0a[b] + win] = wsh[b]
        np.testing.assert_array_equal(got[b], placed)


@pytest.mark.parametrize("loss", [0, 4, 100, 50000])
def test_keep_mask_exact(loss):
    cfg = CompositeConfig(video_chroma_loss=loss)
    fn = np.arange(5, dtype=np.int32) * 7
    l, w = 240, 128
    rgb = torch.zeros((5, l, w, 3), dtype=torch.uint8)
    prep = fused_yiq.prepare(cfg, rgb, torch.from_numpy(fn),
                             torch.from_numpy(fn & 1),
                             interop.key32_from_seed(9))
    ctx = jfused._fused_prepare(
        reference_config(cfg, jconfig), jnp.zeros((5, l, w, 3), jnp.int32), jnp.asarray(fn),
        jnp.asarray(fn & 1), jax.random.PRNGKey(9), row0=0, noise_l=l,
        interpret=True, sharded=False)
    np.testing.assert_array_equal(prep.keep.numpy(),
                                  np.asarray(ctx.keep_p)[..., 0])
    np.testing.assert_array_equal(
        _u32(prep.keys_ab.numpy()), _u32(np.asarray(ctx.keys_ab)[:, 0, :]))
    np.testing.assert_array_equal(prep.xi.numpy(),
                                  np.asarray(ctx.xi_col)[..., 0])
