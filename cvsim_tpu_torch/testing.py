"""Comparison helpers shared by the tests and chip_smoke.py."""

from __future__ import annotations

import numpy as np

from cvsim_tpu_torch.config import CompositeConfig, VHSSpeed
from cvsim_tpu_torch.interop import convert_config

# the configurations of the JAX package's fused-vs-stage chain tests
# (tests/test_fused_chain.py CONFIGS), shared by the port's tests and
# chip_smoke.py
CHAIN_CONFIGS = {
    "bare": CompositeConfig(
        video_noise=0, composite_in_chroma_lowpass=False,
        composite_out_chroma_lowpass=False,
        composite_out_chroma_lowpass_lite=False),
    "defaults-noise-off": CompositeConfig(video_noise=0),
    "full-lowpass-out": CompositeConfig(
        video_noise=0, composite_out_chroma_lowpass_lite=False),
    "preemph": CompositeConfig(
        video_noise=0, composite_preemphasis=7.0,
        composite_preemphasis_cut=315000000 / 88,
        subcarrier_amplitude_back=50 + int(50 * 7 * (315000000 / 88)
                                           / (2 * (315000000 / 88)))),
    "vhs-sp": CompositeConfig(video_noise=0, emulating_vhs=True),
    "vhs-ep-stochastic": CompositeConfig(
        video_noise=6, emulating_vhs=True, vhs_tape_speed=VHSSpeed.EP,
        vhs_head_switching=True, vhs_head_switching_point=0.15,
        vhs_head_switching_phase=0.15, vhs_head_switching_phase_noise=0.0,
        video_chroma_noise=22, video_chroma_phase_noise=6,
        video_chroma_loss=100),
    "vhs-hs-phase-noise": CompositeConfig(
        video_noise=0, emulating_vhs=True, vhs_head_switching=True,
        vhs_head_switching_point=0.52, vhs_head_switching_phase=0.1,
        vhs_head_switching_phase_noise=0.08),
    "yc-recomb": CompositeConfig(video_noise=0, video_yc_recombine=2),
    "svideo": CompositeConfig(video_noise=0, emulating_vhs=True,
                              vhs_svideo_out=True),
}

# the JAX bench's stochastic VHS configuration (bench.py:250-252) at EP
BENCH_VHS_EP = CompositeConfig(
    emulating_vhs=True, vhs_head_switching=True, video_noise=4,
    video_chroma_noise=16, video_chroma_phase_noise=4, video_chroma_loss=4,
    vhs_tape_speed=VHSSpeed.EP)

# the gen-1 configurations of the JAX package's fused-vs-stage chain tests
# (tests/test_fused_chain.py GEN1_CONFIGS)
GEN1_CHAIN_CONFIGS = {
    "defaults-noise-off": CompositeConfig(video_noise=0),
    "noise": CompositeConfig(video_noise=6),
    "vhs-sp": CompositeConfig(video_noise=0, emulating_vhs=True),
    "pal": CompositeConfig(video_noise=0, ntsc=False),
    "full-ep-stochastic": CompositeConfig(
        video_noise=6, emulating_vhs=True, vhs_tape_speed=VHSSpeed.EP,
        vhs_head_switching=True, vhs_head_switching_point=0.15,
        vhs_head_switching_phase_noise=0.0, video_chroma_noise=22,
        video_chroma_phase_noise=6, video_chroma_loss=100),
    "out-full-recomb": CompositeConfig(
        video_noise=0, composite_out_chroma_lowpass=True,
        composite_out_chroma_lowpass_lite=False, video_yc_recombine=2),
    "preemph-catv": CompositeConfig(
        video_noise=0, composite_preemphasis=1.5,
        composite_preemphasis_cut=315000000 / 88 / 2,
        subcarrier_amplitude_back=68),
    "svideo-novblend": CompositeConfig(
        video_noise=0, emulating_vhs=True, vhs_svideo_out=True,
        vhs_chroma_vert_blend=False),
}

# the JAX bench's gen-1 VHS-EP configuration (bench.py:349-352)
BENCH_GEN1_EP = CompositeConfig(
    emulating_vhs=True, vhs_tape_speed=VHSSpeed.EP, vhs_head_switching=True,
    video_noise=6, video_chroma_noise=22, video_chroma_phase_noise=6,
    video_chroma_loss=8)


def reference_config(cfg: CompositeConfig, config_module):
    """The JAX package's twin of a port config: `config_module` is
    cvsim_tpu.config, handed in by the test (the port itself imports
    nothing of the JAX package)."""
    return convert_config(cfg, config_module.CompositeConfig,
                          config_module.VHSSpeed)


def chain_diff(a, b) -> tuple[int, float]:
    """(max abs difference, fraction of samples that differ) of two
    integer arrays."""
    d = np.abs(np.asarray(a).astype(np.int64) - np.asarray(b).astype(np.int64))
    return int(d.max()) if d.size else 0, float((d > 0).mean()) if d.size else 0.0


def assert_chain_equal(a, b, err_msg: str = "") -> None:
    """The chain tolerance of the JAX package (tests/test_fused_chain.py):
    equal except at most 1 LSB on at most 0.1% of samples. Two runs of
    the same float32 math can differ by one ULP where the compilers
    contract or order operations differently, and a value that lands
    exactly on an integer then truncates one LSB apart."""
    dmax, frac = chain_diff(a, b)
    if dmax == 0:
        return
    if not (dmax <= 1 and frac <= 1e-3):
        raise AssertionError(f"{err_msg}: max diff {dmax}, frac {frac:.2e}")


# The tolerance for a plane between the split kernels (#2's encoded luma):
# its values are luma x256 plus the lowpassed chroma, so a float32 pole
# product one ULP apart truncates the chroma one integer apart, and the
# preemphasis gain (7 in the "preemph" configuration) multiplies that. The
# JAX package's own stage path and its kernel A differ by up to 4 on 1.4%
# of the samples of that configuration. The chain tolerance applies where
# the planes become 8-bit output.
PLANE_MAX_DIFF = 16
PLANE_MAX_FRAC = 0.02


def assert_plane_close(a, b, err_msg: str = "") -> None:
    """An intermediate plane of the split chain within PLANE_MAX_DIFF on at
    most PLANE_MAX_FRAC of samples."""
    dmax, frac = chain_diff(a, b)
    if not (dmax <= PLANE_MAX_DIFF and frac <= PLANE_MAX_FRAC):
        raise AssertionError(f"{err_msg}: plane max diff {dmax}, "
                             f"frac {frac:.2e}")


def iir_bound(x_absmax: float, gain: float) -> float:
    """Kernel #9's tolerance (ops/fused_iir) against its plain version or
    the JAX kernel: |diff| <= 8 * eps_f32 * (1 + |gain|) * max|x|. Both
    run the same per-pole blocked products, but summed in another order;
    the mode's gain scales the rounding."""
    return 8 * float(np.finfo(np.float32).eps) * (1 + abs(gain)) * x_absmax


def check_gen1_split_kernels(cfg: CompositeConfig, y, u, v, prep,
                             err_msg: str = "") -> dict:
    """Kernels #6-#8 (models/fused_yuv.stage_a/_b1/_b2) each against its
    plain version on the same inputs (uint8 planes y [B, L, W], u, v
    [B, L, W//2] and their prepare()): #6 on the planes, #7 on #6's
    head-switched output, #8 on #7's blended output; every output held to
    assert_chain_equal. Then the split route against kernel #5 on the
    planes, to assert_chain_equal. Returns {name: (max diff, frac)} for
    yuv_a, yuv_b1, yuv_b2 and "split_vs_chain"."""
    from cvsim_tpu_torch.models import fused_yuv as fy
    from cvsim_tpu_torch.models import yuv422

    def np_(ts):
        return [t.cpu().numpy() for t in ts]

    y_a = fy.stage_a(y, u, v, prep, cfg=cfg)
    y_h = fy.head_switch_rows(y_a, prep.shifts) if cfg.vhs_head_switching else y_a
    p1 = fy.stage_b1(y_h, prep, cfg=cfg)
    p1b = (p1[0], *fy.vblend_rows(*p1[1:])) if yuv422.does_vblend(cfg) else p1
    checks = (
        ("yuv_a", [y_a], [fy.stage_a_reference(y, u, v, prep, cfg=cfg)]),
        ("yuv_b1", p1, fy.stage_b1_reference(y_h, prep, cfg=cfg)),
        ("yuv_b2", fy.stage_b2(*p1b, prep, cfg=cfg),
         fy.stage_b2_reference(*p1b, prep, cfg=cfg)),
        ("split_vs_chain", fy.composite_video_process_split(y, u, v, prep,
                                                            cfg=cfg),
         fy.composite_video_process_merged(y, u, v, prep, cfg=cfg)))
    out = {}
    for name, got, want in checks:
        diffs = []
        for k, (g, w) in enumerate(zip(np_(got), np_(want))):
            assert_chain_equal(g, w, err_msg=f"{err_msg} {name} plane {k}")
            diffs.append(chain_diff(g, w))
        out[name] = (max(d for d, _ in diffs), max(f for _, f in diffs))
    return out


def check_split_kernels(cfg: CompositeConfig, rgb, prep,
                        err_msg: str = "") -> dict:
    """Kernels #2-#4 (models/fused_yiq.stage_a/_b1/_b2) against their
    plain versions on the same inputs: uint8 rows `rgb` [B, L, W, 3] of a
    field and their prepare(). #4's output is held to assert_chain_equal;
    #2's and #3's planes to assert_plane_close, and then each is carried to
    8-bit output through the same kernels downstream and held to
    assert_chain_equal. Returns {kernel: {"plane": (max diff, frac),
    "rgb": (max diff, frac)}} ("plane" is the kernel's own output)."""
    from cvsim_tpu_torch.models import fused_yiq as fy

    w = rgb.shape[2]

    def hs(y):
        return (fy.head_switch_rows(y, prep.shifts, w)
                if cfg.vhs_head_switching else y)

    def b1(y, plain=False):
        fn = fy.stage_b1_reference if plain else fy.stage_b1
        return fn(y, prep, cfg=cfg, w=w)

    def b2(planes, plain=False):
        fn = fy.stage_b2_reference if plain else fy.stage_b2
        return fn(*planes, prep, cfg=cfg, w=w).cpu().numpy()

    def np_(t):
        return t.cpu().numpy()

    out = {}
    a_k = fy.stage_a(rgb, prep, cfg=cfg)
    a_p = fy.stage_a_reference(rgb, prep, cfg=cfg)
    b1_k = b1(hs(a_k))
    b1_p = b1(hs(a_k), plain=True)
    rgb_k = b2(b1_k)
    checks = (
        ("yiq_a", [(np_(a_k), np_(a_p))], rgb_k, b2(b1(hs(a_p)))),
        ("yiq_b1", [(np_(k), np_(p)) for k, p in zip(b1_k, b1_p)],
         rgb_k, b2(b1_p)),
        ("yiq_b2", [], rgb_k, b2(b1_k, plain=True)))
    for name, planes, got, want in checks:
        for k, (pk, pp) in enumerate(planes):
            assert_plane_close(pk, pp, err_msg=f"{err_msg} {name} plane {k}")
        assert_chain_equal(got, want, err_msg=f"{err_msg} {name} to RGB")
        plane = ((max(chain_diff(a, b)[0] for a, b in planes),
                  max(chain_diff(a, b)[1] for a, b in planes))
                 if planes else chain_diff(got, want))
        out[name] = {"plane": plane, "rgb": chain_diff(got, want)}
    return out
