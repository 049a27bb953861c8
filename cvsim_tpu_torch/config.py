"""Frozen configuration dataclasses for the composite/VHS emulation chains.

Mirrors the mutable-global flag set of the reference tools
(ffmpeg_to_composite.cpp:263-333, ffmpeg_ntsc.cpp:756-809) as immutable,
hashable dataclasses. Preset layering semantics (later flags override preset
side-effects) are implemented in `cvsim_tpu_torch.presets`.

The port's copy of cvsim_tpu/config.py: the class and field names are the
same, so a config of either package built from the same flags has the same
repr and the same checkpoint hash (host/checkpoint.config_hash).
"""

from __future__ import annotations

import dataclasses
import enum
import math
from dataclasses import dataclass

# Composite virtual sample rates (ffmpeg_to_composite.cpp:377,642).
# Luma rate: NTSC 4x colorburst = 315/88 MHz * 4 ~= 14.318 MHz.
NTSC_RATE = (315000000.0 * 4) / 88           # 4fsc luma sample rate
NTSC_RATE_422 = (315000000.0 * 4) / (88 * 2)  # half rate for 4:2:2 chroma


class VHSSpeed(enum.Enum):
    """VHS tape speed, with (luma_cut, chroma_cut, chroma_delay_gen1, chroma_delay_gen2).

    Constants from ffmpeg_to_composite.cpp:789-807 and ffmpeg_ntsc.cpp:1773-1791.
    """

    SP = (2400000.0, 320000.0, 4, 9)
    LP = (1900000.0, 300000.0, 5, 12)
    EP = (1400000.0, 280000.0, 6, 14)

    @property
    def luma_cut(self) -> float:
        return self.value[0]

    @property
    def chroma_cut(self) -> float:
        return self.value[1]

    @property
    def chroma_delay_gen1(self) -> int:
        return self.value[2]

    @property
    def chroma_delay_gen2(self) -> int:
        return self.value[3]


@dataclass(frozen=True)
class CompositeConfig:
    """Video chain knobs shared by both engines.

    Field names keep the reference flag vocabulary so the CLI maps 1:1.
    """

    ntsc: bool = True               # output_ntsc (False => PAL)
    subcarrier_amplitude: int = 50
    subcarrier_amplitude_back: int = 50
    composite_preemphasis: float = 0.0
    composite_preemphasis_cut: float = 1000000.0
    video_scanline_phase_shift: int = 180    # -comp-phase (0|90|180|270)
    video_scanline_phase_shift_offset: int = 0

    composite_in_chroma_lowpass: bool = True
    composite_out_chroma_lowpass: bool = True
    composite_out_chroma_lowpass_lite: bool = True

    video_noise: int = 2
    video_chroma_noise: int = 0
    video_chroma_phase_noise: int = 0
    video_chroma_loss: int = 0       # -chroma-dropout, out of 100000 per scanline
    video_yc_recombine: int = 0

    nocolor_subcarrier: bool = False
    nocolor_subcarrier_after_yc_sep: bool = False

    # gen-1 chroma-phase-noise rotation bug (u' uses u*sin instead of v*sin,
    # ffmpeg_to_composite.cpp:772); gen-2 is correct (ffmpeg_ntsc.cpp:1756).
    chroma_phase_noise_gen1_bug: bool = False

    # VHS block
    emulating_vhs: bool = False
    vhs_tape_speed: VHSSpeed = VHSSpeed.SP
    vhs_head_switching: bool = False
    # 4.51 scanlines up from vsync (ffmpeg_to_composite.cpp:274)
    vhs_head_switching_point: float = 1.0 - ((4.5 + 0.01) / 262.5)
    # gen-2 splits point vs phase (ffmpeg_ntsc.cpp:762-763)
    vhs_head_switching_phase: float = (1.0 - 0.01) / 262.5
    # gen-1 default (ffmpeg_to_composite.cpp:275); gen-2 defaults to
    # (1/500)/262.5 (ffmpeg_ntsc.cpp:764) — presets.parse_composite_flags
    # sets that when parsing gen-2 flags
    vhs_head_switching_phase_noise: float = (1.0 / 300.0) / 262.5
    vhs_chroma_vert_blend: bool = True
    vhs_svideo_out: bool = False
    vhs_out_sharpen: float = 1.5
    vhs_out_sharpen_chroma: float = 0.85   # gen-1 only (ffmpeg_to_composite.cpp:271)

    @property
    def pal(self) -> bool:
        return not self.ntsc

    def with_(self, **kw) -> "CompositeConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class AudioConfig:
    """Audio chain knobs (ffmpeg_to_composite.cpp:297-313, 1591-1629)."""

    ntsc: bool = True
    rate: int = 44100
    channels: int = 2
    hiss_db: float = -72.0
    linear_buzz_db: float = -42.0
    highpass_hz: float = 20.0
    lowpass_hz: float = 20000.0
    linear_high_boost: float = 0.25
    vhs_hifi: bool = True
    vhs_linear_audio: bool = False
    emulating_preemphasis: bool = True
    emulating_deemphasis: bool = True
    preemphasis_cut_hz: float = 16000.0     # 16k hifi / 8k linear (:2142,2147)
    bandpass_passes: int = 6                 # audio_hilopass.setPasses(6) (:2130)

    @property
    def hiss_level(self) -> int:
        # output_audio_hiss_level = dBFS(hiss_db) * 5000 (:1629), C double->int trunc
        return int(10.0 ** (self.hiss_db / 20.0) * 5000)

    def with_(self, **kw) -> "AudioConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class OutputConfig:
    """Raster/timing parameters (ffmpeg_to_composite.cpp:291-296)."""

    ntsc: bool = True
    width: int = 720
    height: int = 480
    field_rate_num: int = 60000
    field_rate_den: int = 1001
    interlaced_output: bool = False   # -vi vs -vp (bob)
    use_422_colorspace: bool = False

    @property
    def field_rate(self) -> float:
        return self.field_rate_num / self.field_rate_den

    def with_(self, **kw) -> "OutputConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class RunConfig:
    """Top-level bundle handed to the pipeline."""

    composite: CompositeConfig = CompositeConfig()
    audio: AudioConfig = AudioConfig()
    output: OutputConfig = OutputConfig()
    enable_composite_emulation: bool = True
    enable_audio_emulation: bool = True
    black_key_level_feedback: int = -1
    transcode_start: float = 0.0
    transcode_end: float = -1.0
    seed: int = 0

    def with_(self, **kw) -> "RunConfig":
        return dataclasses.replace(self, **kw)


def iir_alpha(rate: float, cutoff_hz: float) -> float:
    """One-pole IIR coefficient, LowpassFilter::setFilter semantics
    (ffmpeg_to_composite.cpp:103-111): alpha = dt / (tau + dt), tau = 1/(2*pi*hz)."""
    dt = 1.0 / rate
    tau = 1.0 / (cutoff_hz * 2.0 * math.pi)
    return dt / (tau + dt)
