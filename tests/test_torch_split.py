"""Kernels #2-#4 of the port (the gen-2 chain split into its row-local
stage groups for row shards) against the JAX package, on the CPU.

- The port's stage_a/stage_b1/stage_b2 (their plain versions on a CPU
  tensor) against JAX's _fused_stage_a/_b1/_b2 run in interpret mode on
  _fused_prepare(sharded=True) rows, at row0 0, 16 and 48 of a 64-line
  field. Each stage gets the same input on both sides: the rows of RGB,
  then JAX's A output, then JAX's B1 output.
- The sharded prepare against the rows of the global prepare, and the
  row-addressed noise walks against rows of the global walks.
- The port's line-split program (run_fused_lines_local, sp=4) against
  JAX's run_fused_lines_local and JAX's stage chain.

Tolerances: 8-bit outputs within assert_chain_equal (at most 1 LSB on at
most 0.1% of samples: both sides run the same float32 math, but matrix
products round differently in the two frameworks). #2's encoded-luma plane
is compared within assert_plane_close (see testing.PLANE_MAX_DIFF: a
plane at x256 luma scale, where one float32 ULP of the chroma lowpass
truncates one integer apart), and is then carried through the same plain
B1 and B2 on both sides, where the chain tolerance applies. Integer
streams and noise words exactly.
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvsim_tpu import config as jconfig
from cvsim_tpu.models import fused_yiq as jfused
from cvsim_tpu.models import yiq as jyiq
from cvsim_tpu.parallel.mesh import run_fused_lines_local as jlines_local
from cvsim_tpu_torch import interop
from cvsim_tpu_torch.models import fused_yiq
from cvsim_tpu_torch.ops import noise
from cvsim_tpu_torch.parallel import run_fused_lines_local
from cvsim_tpu_torch.testing import (CHAIN_CONFIGS, assert_chain_equal,
                                     assert_plane_close, reference_config)

B, L, W, LS = 2, 64, 128, 16
SPLIT_CONFIGS = ["defaults-noise-off", "preemph", "svideo",
                 "vhs-ep-stochastic"]
KEY = jax.random.PRNGKey(5)
K32 = interop.key32_from_key_data(np.asarray(jax.random.key_data(KEY)))


def _inputs(name):
    rng = np.random.default_rng(zlib.crc32(f"split/{name}".encode()))
    rgb = rng.integers(0, 256, (B, L, W, 3)).astype(np.uint8)
    fn = np.array([4, 5], np.int32)
    return rgb, fn, fn % 2


def _t(a):
    return torch.from_numpy(np.array(a))


def _port_prep(cfg, rgb_rows, fn, par, row0, l_glob=L):
    return fused_yiq.prepare(cfg, _t(rgb_rows), _t(fn), _t(par), K32,
                             row0=row0, l_glob=l_glob)


def _downstream(y, prep, cfg):
    """The plain B1 and B2 on a luma plane: the chain's 8-bit output."""
    y2, i2, q2 = fused_yiq.stage_b1(y, prep, cfg=cfg, w=W)
    return fused_yiq.stage_b2(y2, i2, q2, prep, cfg=cfg, w=W).numpy()


@pytest.mark.parametrize("row0", [0, 16, 48])
@pytest.mark.parametrize("name", SPLIT_CONFIGS)
def test_split_stages_match_jax(name, row0):
    cfg = CHAIN_CONFIGS[name]
    rgb, fn, par = _inputs(name)
    rows = rgb[:, row0:row0 + LS]
    ctx = jfused._fused_prepare(
        reference_config(cfg, jconfig), jnp.asarray(rows, jnp.int32),
        jnp.asarray(fn), jnp.asarray(par),
        KEY, row0=row0, noise_l=L, interpret=True, sharded=True)
    ja = jfused._fused_stage_a(ctx)
    jb1 = jfused._fused_stage_b1(ctx, ja)
    jout = np.asarray(jfused._crop_stack_rgb(
        ctx, *jfused._fused_stage_b2(ctx, *jb1)))
    ja, jb1 = _t(ja), [_t(p) for p in jb1]

    prep = _port_prep(cfg, rows, fn, par, row0)
    got_a = fused_yiq.stage_a(_t(rows), prep, cfg=cfg)
    assert got_a.shape == ja.shape and got_a.dtype == torch.float32
    assert_plane_close(got_a.numpy(), ja.numpy(), err_msg=f"{name} A")
    assert_chain_equal(_downstream(got_a, prep, cfg),
                       _downstream(ja, prep, cfg), err_msg=f"{name} A->RGB")

    got_b1 = fused_yiq.stage_b1(ja, prep, cfg=cfg, w=W)
    for k, (g, j) in enumerate(zip(got_b1, jb1)):
        assert_chain_equal(g[..., :W].numpy(), j[..., :W].numpy(),
                           err_msg=f"{name} B1 plane {k}")
        assert not g[..., W:].any()

    got = fused_yiq.stage_b2(*jb1, prep, cfg=cfg, w=W).numpy()
    assert got.dtype == np.uint8 and got.shape == (B, LS, W, 3)
    assert_chain_equal(got, jout, err_msg=f"{name} B2")


@pytest.mark.parametrize("name", sorted(CHAIN_CONFIGS))
def test_sharded_prepare_is_global_rows(name):
    """A shard's per-line streams are its rows of the whole field's:
    xi, keys, shifts, keep and sincos exactly (same backend); xi, keys and
    keep also equal JAX's sharded prepare."""
    cfg = CHAIN_CONFIGS[name]
    rgb, fn, par = _inputs(name)
    whole = _port_prep(cfg, rgb, fn, par, 0)
    assert whole.row0 == 0 and whole.l_glob == L
    for row0 in (0, 16, 48):
        rows = rgb[:, row0:row0 + LS]
        shard = _port_prep(cfg, rows, fn, par, row0)
        sl = slice(row0, row0 + LS)
        for field in ("xi", "sincos", "keep", "shifts"):
            assert torch.equal(getattr(shard, field),
                               getattr(whole, field)[:, sl]), field
        assert torch.equal(shard.keys_ab, whole.keys_ab)
        ctx = jfused._fused_prepare(
            reference_config(cfg, jconfig), jnp.asarray(rows, jnp.int32),
            jnp.asarray(fn),
            jnp.asarray(par), KEY, row0=row0, noise_l=L, interpret=True,
            sharded=True)
        assert np.array_equal(np.asarray(ctx.xi_col)[..., 0],
                              shard.xi.numpy())
        assert np.array_equal(np.asarray(ctx.keep_p)[..., 0],
                              shard.keep.numpy())
        jkeys = np.asarray(ctx.keys_ab)[:, 0].astype(np.int64) & 0xFFFFFFFF
        assert np.array_equal(jkeys, shard.keys_ab.numpy())
    with pytest.raises(ValueError, match="outside a field"):
        _port_prep(cfg, rgb[:, :LS], fn, par, 56)


@pytest.mark.parametrize("row0", [0, 16, 48])
def test_noise_walk_rows_are_global_rows(row0):
    """The row0 / plane-offset walks are row slices of the whole field's
    walks, exactly; row0 0 with the defaults is the unsharded walk."""
    keys = torch.tensor([1733237950, 2 ** 32 - 1, 7], dtype=torch.int64)
    w, mag = 176, 22
    sl = slice(row0, row0 + LS)
    luma = noise.smoothed_noise_walk_rows(keys, L, w, mag)
    assert torch.equal(
        noise.smoothed_noise_walk_rows(keys, LS, w, mag, row0=row0),
        luma[:, sl])
    chroma = noise.chroma_noise_walk_rows(keys, L, w, mag)
    assert torch.equal(
        noise.chroma_noise_walk_rows(keys, LS, w, mag, row0=row0, l_glob=L),
        chroma[:, :, sl])
    # the Q plane is the luma-style walk at plane offset l_glob * w
    assert torch.equal(
        noise.smoothed_noise_walk_rows(keys, LS, w, mag, row0=row0,
                                       plane_off=L * w),
        chroma[:, 1, sl])


def test_vblend_rows_matches_jax():
    """The blend seam over a whole field equals JAX's _vblend_xla; a shard
    with its halo row equals the same rows of the whole field."""
    rng = np.random.default_rng(3)
    p = rng.integers(-3000, 3000, (B, L, W)).astype(np.float32)
    want = np.asarray(jfused._vblend_xla(jnp.asarray(p), L, lambda a: a))
    got = fused_yiq.vblend_rows(_t(p))
    assert np.array_equal(got.numpy(), want)
    for row0 in (16, 48):
        shard = fused_yiq.vblend_rows(_t(p[:, row0:row0 + LS]), row0,
                                      halo=_t(p[:, row0 - 1:row0]))
        assert np.array_equal(shard.numpy(), want[:, row0:row0 + LS])
    with pytest.raises(ValueError, match="halo"):
        fused_yiq.vblend_rows(_t(p[:, 16:32]), 16)


def test_fused_lines_local_matches_jax():
    """The line-split program over 4 row shards: the port against JAX's
    same program (interpret mode) and JAX's stage chain, on the
    configuration of JAX's own line-sharding test (noise, head switching
    across shard boundaries, the blend's halo)."""
    cfg = CHAIN_CONFIGS["vhs-ep-stochastic"]
    rgb, fn, par = _inputs("lines")
    jcfg = reference_config(cfg, jconfig)
    want_lines = np.asarray(jlines_local(jcfg, jnp.asarray(rgb, jnp.int32),
                                         fn, par, KEY, sp=4, interpret=True))
    want_stage = np.asarray(jyiq.composite_layer_rgb(
        jnp.asarray(rgb, jnp.int32), jnp.asarray(fn), jnp.asarray(par), KEY,
        cfg=jcfg))
    got = run_fused_lines_local(cfg, _t(rgb), _t(fn), _t(par), K32,
                                sp=4).numpy()
    assert got.dtype == np.uint8 and got.shape == rgb.shape
    assert_chain_equal(got, want_lines, err_msg="vs jax line-split program")
    assert_chain_equal(got, want_stage, err_msg="vs jax stage chain")
    with pytest.raises(ValueError, match="must divide"):
        run_fused_lines_local(cfg, _t(rgb[:, :61]), _t(fn), _t(par), K32,
                              sp=4)
