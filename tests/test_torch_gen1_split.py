"""The gen-1 split route (kernels #6-#8: stage A, the head switch, B1, the
2-line blend, B2) on the CPU, where each wrapper runs its plain version:

- the route's choice against the JAX dispatcher's, traced with
  jax.eval_shape at the 240/243/288/540-line rasters (and at w = 1888,
  where the two packages' padded widths differ);
- the uint8 planes between the stages carry every value exactly, and the
  split route equals the whole plain chain exactly, on every gen-1
  configuration;
- the split route against JAX's tiled program (its kernels A, B1, B2 in
  interpret mode, the tile budget cut to 16 x 128 as
  tests/test_fused_chain.py does), tolerance assert_chain_equal (at most
  1 LSB on at most 0.1% of samples: float32 products and sin/cos round
  differently in the two frameworks).

The kernels are tested on the card in tests/test_torch_kernel.py.
"""

import functools
import zlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cvsim_tpu import config as jconfig
from cvsim_tpu.models import fused_yuv as jfy
from cvsim_tpu_torch import interop
from cvsim_tpu_torch.config import CompositeConfig
from cvsim_tpu_torch.models import chain_prep, fused_yuv, yiq, yuv422
from cvsim_tpu_torch.testing import (BENCH_GEN1_EP, GEN1_CHAIN_CONFIGS,
                                     assert_chain_equal, launches,
                                     reference_config)

KEY = jax.random.PRNGKey(5)
K32 = interop.key32_from_key_data(np.asarray(jax.random.key_data(KEY)))
JAX_TILED = ["full-ep-stochastic", "defaults-noise-off", "svideo-novblend",
             "pal"]


def _planes(tag, b, l, w):
    rng = np.random.default_rng(zlib.crc32(tag.encode()))
    return (rng.integers(16, 236, (b, l, w)).astype(np.uint8),
            rng.integers(16, 241, (b, l, w // 2)).astype(np.uint8),
            rng.integers(16, 241, (b, l, w // 2)).astype(np.uint8))


def _record_route(monkeypatch):
    """Patches the JAX dispatcher's kernel builders to record which
    program it builds ("merged" or "split")."""
    seen = []

    def record(name, fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            seen.append(name)
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(jfy, "_make_kernel_ab",
                        record("merged", jfy._make_kernel_ab))
    monkeypatch.setattr(jfy, "_make_kernel_a",
                        record("split", jfy._make_kernel_a))
    return seen


@pytest.mark.parametrize("l,w,split", [
    (240, 720, False),    # 480i: the merged kernel #5
    (243, 720, False),
    (288, 720, True),     # 576i PAL: 288 x 768 = 221,184 > 200,000
    (540, 1888, True),    # 1080i
    (98, 1888, True),     # 98 x 2048 > 200,000 (98 x 1920 would not be)
    (97, 1888, False),
])
def test_route_matches_jax_dispatcher(monkeypatch, l, w, split):
    assert fused_yuv.takes_split(l, w) == split
    seen = _record_route(monkeypatch)
    # a configuration of this test only, so no other test's trace of the
    # jitted dispatcher is reused
    cfg = CompositeConfig(video_noise=0, subcarrier_amplitude=49)
    planes = [jax.ShapeDtypeStruct(s, jnp.int32)
              for s in ((1, l, w), (1, l, w // 2), (1, l, w // 2))]
    idx = jax.ShapeDtypeStruct((1,), jnp.int32)
    jax.eval_shape(functools.partial(
        jfy.composite_video_process_fused,
        cfg=reference_config(cfg, jconfig), interpret=True),
        *planes, idx, idx, KEY)
    assert seen == ["split" if split else "merged"]


@pytest.mark.parametrize("name", sorted(GEN1_CHAIN_CONFIGS) + ["bench-pal"])
def test_seams_carry_uint8_and_split_equals_chain(name):
    """Every value handed between the stages is an integer in [0, 255]
    (so the uint8 planes between #6, #7 and #8 are exact), and the split
    route == the whole plain chain (kernel #5's plain version) exactly."""
    cfg = (BENCH_GEN1_EP.with_(ntsc=False) if name == "bench-pal"
           else GEN1_CHAIN_CONFIGS[name])
    y, u, v = (torch.from_numpy(p) for p in _planes(name, 2, 48, 128))
    fn = torch.tensor([0, 1], dtype=torch.int32)
    prep = fused_yuv.prepare(cfg, y, fn, fn % 2, K32)
    st = chain_prep.streams(prep)
    i32 = [p.to(torch.int32) for p in (y, u, v)]
    y_a, _, _ = yuv422.composite_front_a(*i32, cfg=cfg, streams=st)
    if cfg.vhs_head_switching:
        y_a = yiq.head_switching_stage(y_a, st.shifts, fill=16)
    planes_b1 = yuv422.composite_front_b1(y_a, None, None, cfg=cfg,
                                          streams=st)
    u1, v1 = planes_b1[1:]
    if yuv422.does_vblend(cfg):
        u1, v1 = yuv422.vhs_chroma_vert_blend(u1, v1)
    for k, p in enumerate((y_a, *planes_b1, u1, v1)):
        assert p.dtype == torch.int32, k
        assert int(p.min()) >= 0 and int(p.max()) <= 255, (k, p.min(), p.max())
    got = fused_yuv.composite_video_process_split(y, u, v, prep, cfg=cfg)
    want = fused_yuv.chain_reference(y, u, v, prep, cfg=cfg)
    for g, wnt in zip(got, want):
        assert g.dtype == torch.uint8 and torch.equal(g, wnt)


@pytest.mark.parametrize("name", JAX_TILED)
def test_split_matches_jax_tiled_program(monkeypatch, name):
    cfg = GEN1_CHAIN_CONFIGS[name]
    monkeypatch.setattr(jfy, "_TILE_BUDGET", 16 * 128)
    seen = _record_route(monkeypatch)
    planes = _planes(f"tiled/{name}", 2, 48, 128)
    fn = np.array([0, 1], np.int32)
    want = jfy.composite_video_process_fused(
        *(jnp.asarray(p, jnp.int32) for p in planes), jnp.asarray(fn),
        jnp.asarray(fn % 2), KEY, cfg=reference_config(cfg, jconfig),
        interpret=True)
    assert seen == ["split"]
    tp = [torch.from_numpy(p) for p in planes]
    tfn = torch.from_numpy(fn)
    prep = fused_yuv.prepare(cfg, tp[0], tfn, tfn % 2, K32)
    got = fused_yuv.composite_video_process_split(*tp, prep, cfg=cfg)
    for k, (g, wnt) in enumerate(zip(got, want)):
        assert g.shape == planes[k].shape
        assert_chain_equal(g.numpy(), np.asarray(wnt),
                           err_msg=f"{name} plane {k}")


def test_cpu_wrappers_run_plain_versions():
    """On CPU tensors stage_a/_b1/_b2 run their plain versions and count
    no launch."""
    cfg = GEN1_CHAIN_CONFIGS["full-ep-stochastic"]
    y, u, v = (torch.from_numpy(p) for p in _planes("wrap", 2, 32, 128))
    fn = torch.tensor([4, 5], dtype=torch.int32)
    prep = fused_yuv.prepare(cfg, y, fn, fn % 2, K32)
    counts = (launches("yuv_a"), launches("yuv_b1"), launches("yuv_b2"))
    y_a = fused_yuv.stage_a(y, u, v, prep, cfg=cfg)
    assert torch.equal(y_a, fused_yuv.stage_a_reference(y, u, v, prep,
                                                        cfg=cfg))
    y_h = fused_yuv.head_switch_rows(y_a, prep.shifts)
    p1 = fused_yuv.stage_b1(y_h, prep, cfg=cfg)
    for g, w in zip(p1, fused_yuv.stage_b1_reference(y_h, prep, cfg=cfg)):
        assert torch.equal(g, w)
    p1 = (p1[0], *fused_yuv.vblend_rows(*p1[1:]))
    out = fused_yuv.stage_b2(*p1, prep, cfg=cfg)
    for g, w in zip(out, fused_yuv.stage_b2_reference(*p1, prep, cfg=cfg)):
        assert g.dtype == torch.uint8 and torch.equal(g, w)
    assert counts == (launches("yuv_a"), launches("yuv_b1"),
                      launches("yuv_b2"))


def test_main_path_takes_split_on_pal_raster(monkeypatch):
    """The main entry point at a 576i PAL field runs the split route (its
    plain versions here) and equals the whole plain chain."""
    cfg = BENCH_GEN1_EP.with_(ntsc=False)
    y, u, v = (torch.from_numpy(p) for p in _planes("pal576", 1, 288, 720))
    fn = torch.tensor([3], dtype=torch.int32)
    calls = []
    split = fused_yuv.composite_video_process_split
    monkeypatch.setattr(fused_yuv, "composite_video_process_split",
                        lambda *a, **k: calls.append(1) or split(*a, **k))
    got = yuv422.composite_video_process_auto(y, u, v, fn, fn % 2, K32,
                                              cfg=cfg)
    assert calls == [1]
    prep = fused_yuv.prepare(cfg, y, fn, fn % 2, K32)
    want = fused_yuv.chain_reference(y, u, v, prep, cfg=cfg)
    for g, w in zip(got, want):
        assert g.dtype == torch.uint8 and torch.equal(g, w)
