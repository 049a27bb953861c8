"""Comparison and timing helpers shared by the tests, chip_smoke.py and
kernel_ab.py."""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple

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



def bench_cli_configs() -> dict:
    """The two VHS-EP configurations of the port's benchmark as the CLIs
    parse their flags (`ntsc -vhs-speed ep -vhs-head-switching 1` and
    `to-composite -vhs -vhs-speed ep -vhs-head-switching 1`):
    {name: (config, gen1)}."""
    from cvsim_tpu_torch import presets

    out = {}
    for name, argv, gen2 in (
            ("ntsc-vhs-ep", [], True), ("composite-vhs-ep", ["-vhs"], False)):
        st = presets.parse_composite_flags(
            [*argv, "-vhs-speed", "ep", "-vhs-head-switching", "1", "-seed",
             "7"], gen2=gen2)
        out[name] = (st.to_run_config(gen1=not gen2).composite, not gen2)
    return out


BENCH_CONFIGS = {"bench-vhs-ep": BENCH_VHS_EP, "bench-gen1-ep": BENCH_GEN1_EP,
                 "bench-gen1-ep-pal": BENCH_GEN1_EP.with_(ntsc=False)}

# Kernels #1 (yiq_chain) and #5 (yuv_chain, launched directly, whatever
# route the dispatcher would take) on chip_smoke.py [3]'s bench inputs
# (chain_inputs), and the CRC32 of each output (chain_crc32) as the
# kernels of commit b8c5917 computed it on an H100 (kernel_ab.py). The
# pole primitives were rewritten after that commit to keep every output
# bit; the `cuda` tests and chip_smoke.py [3] hold them to these values.
PINNED_CHAIN_CRC32 = {
    ("yiq_chain", "bench-vhs-ep", (8, 240, 704)): 0x678929D5,
    ("yiq_chain", "bench-vhs-ep", (2, 540, 1888)): 0x5C6E4A9B,
    ("yuv_chain", "bench-gen1-ep", (8, 240, 720)): 0xDA2B5F7F,
    ("yuv_chain", "bench-gen1-ep-pal", (8, 288, 720)): 0xDE9909AC,
    ("yuv_chain", "bench-gen1-ep", (2, 540, 1888)): 0x73C0E6BA,
}


def chain_inputs(kernel: str, name: str, cfg: CompositeConfig,
                 shape: tuple, device):
    """chip_smoke.py [3]'s inputs of kernel #1 ("yiq_chain": uint8 RGB
    [B, L, W, 3]) or #5 ("yuv_chain": uint8 y [B, L, W], u, v
    [B, L, W//2]) for the case (name, shape), drawn from a seed of both, on
    `device`, with their prepare() for fields 3.. under
    key32_from_seed(5): (planes, prepare())."""
    import zlib

    import torch

    from cvsim_tpu_torch.interop import key32_from_seed
    from cvsim_tpu_torch.models import fused_yiq, fused_yuv

    b, l, w = shape
    fn = torch.arange(b, dtype=torch.int32) + 3
    key = key32_from_seed(5)
    if kernel == "yiq_chain":
        rng = np.random.default_rng(zlib.crc32(f"{name}{b}{l}{w}".encode()))
        rgb = torch.from_numpy(rng.integers(0, 256, (b, l, w, 3))
                               .astype(np.uint8)).to(device)
        return (rgb,), fused_yiq.prepare(cfg, rgb, fn, fn % 2, key)
    rng = np.random.default_rng(zlib.crc32(f"g1{name}{b}{l}{w}".encode()))
    planes = tuple(torch.from_numpy(rng.integers(0, 256, s).astype(np.uint8))
                   .to(device) for s in ((b, l, w), (b, l, w // 2),
                                         (b, l, w // 2)))
    return planes, fused_yuv.prepare(cfg, planes[0], fn, fn % 2, key)


def chain_crc32(kernel: str, cfg: CompositeConfig, planes, prep) -> int:
    """CRC32 of kernel #1's RGB bytes, or of #5's y, u and v bytes in
    turn, on `planes` (chain_inputs)."""
    from cvsim_tpu_torch.models import fused_yiq, fused_yuv

    if kernel == "yiq_chain":
        outs = (fused_yiq.composite_layer_rgb_fused(*planes, prep, cfg=cfg),)
    else:
        outs = fused_yuv.composite_video_process_merged(*planes, prep,
                                                        cfg=cfg)
    return tensors_crc32(outs)


def tensors_crc32(tensors) -> int:
    """CRC32 of the bytes of each tensor in turn."""
    import zlib

    crc = 0
    for t in tensors:
        crc = zlib.crc32(t.cpu().numpy().tobytes(), crc)
    return crc


def launches(kernel: str) -> int:
    """Launches of `kernel` (yiq_chain, yuv_a, fused_iir, raw28_tails, ...)
    since the process started: the recorder's `launches.<kernel>` counter
    (utils/log.count). Read it before and after the work."""
    from cvsim_tpu_torch.utils import log

    return log.snapshot()["counters"].get(f"launches.{kernel}", 0)


TIMING_REPS = 5


def time_ms(fn, calls: int = 1) -> float:
    """Median of TIMING_REPS CUDA-event timings of fn(), after two
    warm-ups. calls > 1 times that many calls back to back and divides by
    it, so that the host enqueues each call while the card runs the one
    before: a kernel's device time, without its wrapper's host work."""
    import torch

    for _ in range(2):
        fn()
    times = []
    for _ in range(TIMING_REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return sorted(times)[TIMING_REPS // 2]


def iir_shapes() -> list:
    """The pole cascade's (#9) calls on the gen-1 stage path at the VHS-EP
    cuts: (label, alphas, y0s, mode, gain)."""
    from cvsim_tpu_torch.config import (NTSC_RATE, NTSC_RATE_422,
                                        iir_alpha)

    ep = VHSSpeed.EP
    luma = float(iir_alpha(NTSC_RATE, ep.luma_cut))
    chroma = float(iir_alpha(NTSC_RATE_422, ep.chroma_cut))
    sharp = float(iir_alpha(NTSC_RATE, ep.luma_cut * 2))
    pre = float(iir_alpha(NTSC_RATE, 315000000 / 88))
    return [("VHS luma, emph 4 poles", (luma,) * 4, (16.0,) * 4, "emph", 1.6),
            ("VHS chroma, none 3 poles", (chroma,) * 3, (128.0,) * 3, "none",
             0.0),
            ("sharpen, unsharp 3 poles", (sharp,) * 3, (16.0,) * 3,
             "unsharp", 1.5),
            ("preemphasis, emph 1 pole", (pre,), (16.0,), "emph", 7.0)]


def iir_half_shapes() -> list:
    """The pole cascade's calls on the half-width chroma planes of the
    debug-tap route at the VHS-EP cuts (the VHS chroma lowpass and the
    chroma sharpen; the input and output chroma lowpasses are 3-pole
    'none' cascades too): (label, alphas, y0s, mode, gain)."""
    from cvsim_tpu_torch.config import NTSC_RATE_422, iir_alpha

    ep = VHSSpeed.EP
    chroma = float(iir_alpha(NTSC_RATE_422, ep.chroma_cut))
    sharp = float(iir_alpha(NTSC_RATE_422, ep.chroma_cut * 2))
    gain = CompositeConfig().vhs_out_sharpen_chroma
    return [("VHS chroma, none 3 poles", (chroma,) * 3, (128.0,) * 3, "none",
             0.0),
            ("chroma sharpen, unsharp 3 poles", (sharp,) * 3, (128.0,) * 3,
             "unsharp", gain)]


def iir_cases() -> list:
    """#9's checked, timed and pinned calls: (rows, w, label, alphas, y0s,
    mode, gain) for each of iir_shapes() at [64*240, 720], of
    iir_half_shapes() at [64*240, 360] (480i's half-width chroma) and of
    iir_shapes() at [16*540, 1888]."""
    return [(rows, w, *shape)
            for rows, w, shapes in ((64 * 240, 720, iir_shapes()),
                                    (64 * 240, 360, iir_half_shapes()),
                                    (16 * 540, 1888, iir_shapes()))
            for shape in shapes]


def iir_input(device, rows: int, w: int):
    """Rows of random 0..255 float32 samples, [rows, w], on `device`."""
    import torch

    rng = np.random.default_rng(rows + w)
    return torch.from_numpy(rng.integers(0, 256, (rows, w)).astype(
        np.float32)).to(device)


class TimedCase(NamedTuple):
    kernel: str        # "yiq_chain", "yiq_a", ..., "fused_iir"
    label: str         # its shape and configuration
    kern: Callable     # the kernel's wrapper on `inputs`
    plain: Callable    # its plain version on the same inputs
    cfg: object        # the CompositeConfig, or fused_iir's keywords
    shape: tuple       # (B, L, W), or fused_iir's (rows, W)
    inputs: tuple      # what kern reads: tensors, and a prepare()


def timed_cases(device) -> list[TimedCase]:
    """Every kernel's timed launches on `device`, for chip_smoke.py [5]
    and kernel_ab.py: #1-#4 on the bench VHS-EP configuration at 240x704
    B=64 and 540x1888 B=16; #5 on the gen-1 bench configuration at 240x720
    B=64, 288x720 PAL B=64 and 540x1888 B=16, #6-#8 at the last two; #9
    on iir_cases(). Inputs from chain_inputs(kernel, "time", ...) and
    iir_input; #3's and #4's are the outputs of the kernels before them.
    The first case of each kernel is the one its row of the kernel table
    reports."""
    from cvsim_tpu_torch.models import fused_yiq, fused_yuv, yuv422
    from cvsim_tpu_torch.ops import fused_iir

    out = []
    cfg = BENCH_VHS_EP
    for shape in ((64, 240, 704), (16, 540, 1888)):
        (rgb,), prep = chain_inputs("yiq_chain", "time", cfg, shape, device)
        w = shape[2]
        label = f"{shape[1]}x{w} B={shape[0]} bench VHS-EP"
        y_a = fused_yiq.stage_a(rgb, prep, cfg=cfg)
        y_h = fused_yiq.head_switch_rows(y_a, prep.shifts, w)
        p1 = fused_yiq.stage_b1(y_h, prep, cfg=cfg, w=w)
        cases = (
            ("yiq_chain", fused_yiq.composite_layer_rgb_fused,
             fused_yiq.chain_reference, (rgb, prep), {}),
            ("yiq_a", fused_yiq.stage_a, fused_yiq.stage_a_reference,
             (rgb, prep), {}),
            ("yiq_b1", fused_yiq.stage_b1, fused_yiq.stage_b1_reference,
             (y_h, prep), {"w": w}),
            ("yiq_b2", fused_yiq.stage_b2, fused_yiq.stage_b2_reference,
             (*p1, prep), {"w": w}))
        out += [TimedCase(kernel, label,
                          partial(kern, *inputs, cfg=cfg, **kw),
                          partial(plain, *inputs, cfg=cfg, **kw), cfg, shape,
                          inputs)
                for kernel, kern, plain, inputs, kw in cases]
    for name, shape in (("bench-gen1-ep", (64, 240, 720)),
                        ("bench-gen1-ep-pal", (64, 288, 720)),
                        ("bench-gen1-ep", (16, 540, 1888))):
        cfg1 = BENCH_CONFIGS[name]
        planes, prep = chain_inputs("yuv_chain", "time", cfg1, shape, device)
        label = (f"{shape[1]}x{shape[2]} B={shape[0]} gen-1 bench VHS-EP"
                 + (" PAL" if not cfg1.ntsc else ""))
        cases = [("yuv_chain", fused_yuv.composite_video_process_merged,
                  fused_yuv.chain_reference, (*planes, prep))]
        if shape[1] != 240:
            y_a = fused_yuv.stage_a(*planes, prep, cfg=cfg1)
            y_h = fused_yuv.head_switch_rows(y_a, prep.shifts)
            p1 = fused_yuv.stage_b1(y_h, prep, cfg=cfg1)
            if yuv422.does_vblend(cfg1):
                p1 = (p1[0], *fused_yuv.vblend_rows(*p1[1:]))
            cases += [
                ("yuv_a", fused_yuv.stage_a, fused_yuv.stage_a_reference,
                 (*planes, prep)),
                ("yuv_b1", fused_yuv.stage_b1, fused_yuv.stage_b1_reference,
                 (y_h, prep)),
                ("yuv_b2", fused_yuv.stage_b2, fused_yuv.stage_b2_reference,
                 (*p1, prep))]
        out += [TimedCase(kernel, label, partial(kern, *inputs, cfg=cfg1),
                          partial(plain, *inputs, cfg=cfg1), cfg1, shape,
                          inputs)
                for kernel, kern, plain, inputs in cases]
    inputs = {}
    for rows, w, label, alphas, y0s, mode, gain in iir_cases():
        if (rows, w) not in inputs:
            inputs[rows, w] = iir_input(device, rows, w)
        x = inputs[rows, w]
        kw = dict(alphas=alphas, y0s=y0s, mode=mode, gain=gain)
        out.append(TimedCase(
            "fused_iir", f"[{rows}, {w}] {label}",
            partial(fused_iir.fused_iir, x, **kw),
            partial(fused_iir.fused_iir_reference, x, **kw), kw,
            (rows, w), (x,)))
    return out


# Kernels #3 (yiq_b1: its y, i, q planes in turn), #9 (fused_iir), #7
# (yuv_b1: y, u, v), #8 (yuv_b2: y, u, v), #6 (yuv_a: y), #2 (yiq_a: y)
# and #4 (yiq_b2: its uint8 RGB) on every case of their timed_cases, and
# the CRC32 of each output (case_crc32) as the one-row kernels computed it
# on an H100 (kernel_ab.py): #3 and #9 those of commit 6f83bf8, #7 and #8
# those of commit 3552a33, #6 and #2 those of commit a7f4f68, #4 those of
# commit f9f71a9. Each kernel was then rebuilt to take several rows a
# CTA, keeping every output bit; the `cuda` tests, chip_smoke.py [3] and
# kernel_ab.py hold them to these values. Keyed by "kernel label".
PINNED_KERNELS = ("yiq_b1", "fused_iir", "yuv_b1", "yuv_b2", "yuv_a",
                  "yiq_a", "yiq_b2")
PINNED_CASE_CRC32 = {
    "yiq_b1 240x704 B=64 bench VHS-EP":
        0xB34C9CB6,
    "yiq_b1 540x1888 B=16 bench VHS-EP":
        0x63349F23,
    "fused_iir [15360, 720] VHS luma, emph 4 poles":
        0x96BB8C89,
    "fused_iir [15360, 720] VHS chroma, none 3 poles":
        0x4C1F22F2,
    "fused_iir [15360, 720] sharpen, unsharp 3 poles":
        0x9C93F74E,
    "fused_iir [15360, 720] preemphasis, emph 1 pole":
        0x28E43983,
    "fused_iir [15360, 360] VHS chroma, none 3 poles":
        0xED4CD28C,
    "fused_iir [15360, 360] chroma sharpen, unsharp 3 poles":
        0x4D05AC4E,
    "fused_iir [8640, 1888] VHS luma, emph 4 poles":
        0xE5103BC8,
    "fused_iir [8640, 1888] VHS chroma, none 3 poles":
        0x6959C32B,
    "fused_iir [8640, 1888] sharpen, unsharp 3 poles":
        0x60652EBA,
    "fused_iir [8640, 1888] preemphasis, emph 1 pole":
        0x9F9CE573,
    "yuv_b1 288x720 B=64 gen-1 bench VHS-EP PAL":
        0x18BDF134,
    "yuv_b2 288x720 B=64 gen-1 bench VHS-EP PAL":
        0xEE8FD46A,
    "yuv_b1 540x1888 B=16 gen-1 bench VHS-EP":
        0x1C8F1F30,
    "yuv_b2 540x1888 B=16 gen-1 bench VHS-EP":
        0x628D57BB,
    "yuv_a 288x720 B=64 gen-1 bench VHS-EP PAL":
        0xB0DD6F72,
    "yuv_a 540x1888 B=16 gen-1 bench VHS-EP":
        0x4AC9820C,
    "yiq_a 240x704 B=64 bench VHS-EP":
        0x80B8B6DC,
    "yiq_a 540x1888 B=16 bench VHS-EP":
        0x619D3BB2,
    "yiq_b2 240x704 B=64 bench VHS-EP":
        0x87332681,
    "yiq_b2 540x1888 B=16 bench VHS-EP":
        0x7B3742C6,
}


def case_crc32(case: TimedCase) -> int:
    """CRC32 of a timed case's kernel output (each tensor of a tuple in
    turn)."""
    out = case.kern()
    return tensors_crc32(out if isinstance(out, tuple) else (out,))


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


# raw composite captures for the raw28ntsc decoder: the levels of
# tests/test_raw28.py's synthetic captures
RAW28_SYNC_TIP, RAW28_BLANK, RAW28_WHITE = 10, 70, 230


def raw28_capture(n_fields: int, raw_len: int, color: bool = False,
                  u0: float = 20.0, v0: float = -12.0,
                  burst_amp: float = 15.0) -> np.ndarray:
    """A synthetic raw 8x-fsc composite capture, uint8: per field, 12
    serration pulses (equalization-length half lines) then 262 scanlines
    of hsync and a luma ramp, or (color) a colourburst on the -U axis and
    a constant (u0, v0) colour over mid luma. The structure of
    tests/test_raw28.py's synth_capture and synth_color_capture, which it
    equals at the same arguments; pulses are wider than broadcast spec,
    because the detector lowpass erodes them by ~30 samples."""
    rl = raw_len
    hsync_len = int(rl * 0.09)
    half = np.full(rl // 2, RAW28_BLANK, np.float64)
    half[: int(rl * 0.05)] = RAW28_SYNC_TIP
    row = np.full(rl, RAW28_BLANK, np.float64)
    row[:hsync_len] = RAW28_SYNC_TIP
    if color:
        p = np.arange(rl)
        cu = np.cos(2 * np.pi * p / 8)
        sv = np.sin(2 * np.pi * p / 8)
        bs, be = int(rl * 0.095), int(rl * 0.14)
        a0 = int(rl * 0.18)
        row[bs:be] += -burst_amp * cu[bs:be]
        row[a0:rl - 8] = (RAW28_BLANK + 80 + u0 * cu[a0:rl - 8]
                          + v0 * sv[a0:rl - 8])
        row = np.clip(row, 0, 255)
    else:
        active0 = hsync_len + int(rl * 0.06)
        n_active = rl - active0 - 8
        row[active0:active0 + n_active] = np.linspace(
            RAW28_BLANK + 10, RAW28_WHITE, n_active).astype(np.uint8)
    field = np.concatenate([half] * 12 + [row] * 262)
    return np.tile(field.astype(np.uint8), n_fields)


def raw28_capture_jittery(n_fields: int, raw_len: int,
                          seed: int = 3) -> np.ndarray:
    """A synthetic raw capture with a real capture's faults, uint8: per
    field, 12 serration pulses then 262 scanlines whose lengths jitter by
    up to 6 samples, over a slow DC drift (8 levels, a period of two
    fields), with gaussian noise (sigma 2) and a chroma-like ripple of 8
    samples whose phase moves from line to line. It stresses what the
    clean capture leaves idle: the per-line hsync re-lock, the fractional
    line pacing, the DC tracker and the AGC. The capture of
    tests/test_ref_crosscheck.py's `_raw28_capture_jittery`, which it
    equals at the same arguments (raw_len of the ntsc28 preset)."""
    rl = raw_len
    rng = np.random.default_rng(seed)
    out = []
    hsync_len = int(rl * 0.09)
    half = np.full(rl // 2, RAW28_BLANK, np.uint8)
    half[: int(rl * 0.05)] = RAW28_SYNC_TIP
    t = 0
    for _ in range(n_fields):
        out += [half] * 12
        for line in range(262):
            ll = rl + int(rng.integers(-6, 7))
            drift = 8.0 * np.sin(2 * np.pi * (t / (rl * 262 * 2.0)))
            t += ll
            row = np.full(ll, RAW28_BLANK, np.float64)
            row[:hsync_len] = RAW28_SYNC_TIP
            a0 = hsync_len + int(rl * 0.06)
            n = ll - a0 - 8
            x = np.arange(n)
            row[a0:a0 + n] = (80 + 110 * x / n
                              + 14 * np.sin(2 * np.pi * x / 8 + 0.3 * line))
            row += drift + rng.normal(0, 2.0, ll)
            out.append(np.clip(row, 0, 255).astype(np.uint8))
    return np.concatenate(out)
