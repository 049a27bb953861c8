"""Flag parsing and preset layering with reference semantics.

The reference parses argv left-to-right into mutable globals; presets like
-vhs / -vhs-speed / -vhs-hifi / -comp-catv* overwrite several knobs at once,
and later flags override preset side-effects (ffmpeg_to_composite.cpp:
1325-1639). This module reproduces that order-dependence over a mutable
builder, then freezes the result into the config dataclasses, including the
derived-config post-pass (:1577-1629).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

from cvsim_tpu_torch.config import (
    AudioConfig,
    CompositeConfig,
    OutputConfig,
    RunConfig,
    VHSSpeed,
)


@dataclasses.dataclass
class FlagState:
    """Mutable mirror of the reference's globals (defaults from
    ffmpeg_to_composite.cpp:263-333)."""

    input_files: list = dataclasses.field(default_factory=list)
    output_file: str = ""
    audio_in: str = ""
    audio_out: str = ""
    audio_pts_in: str = ""     # sidecar packet log: close PTS gaps with silence
    video_pts_in: str = ""     # sidecar frame log: VFR/telecine durations
    audio_stream_index: int = 0
    video_stream_index: int = 0

    ntsc: bool = True
    width: int = 720
    height: int = 480
    field_rate_num: int = 60000
    field_rate_den: int = 1001
    interlaced_output: bool = False
    use_422_colorspace: bool = False

    composite_preemphasis: float = 0.0
    composite_preemphasis_cut: float = 1000000.0
    video_scanline_phase_shift: int = 180
    video_scanline_phase_shift_offset: int = 0
    subcarrier_amplitude: int = 50
    subcarrier_amplitude_back: int = 50
    composite_in_chroma_lowpass: bool = True
    composite_out_chroma_lowpass: bool = True
    composite_out_chroma_lowpass_lite: bool = True
    video_noise: int = 2
    video_chroma_noise: int = 0
    video_chroma_phase_noise: int = 0
    video_chroma_loss: int = 0
    video_yc_recombine: int = 0
    nocolor_subcarrier: bool = False
    nocolor_subcarrier_after_yc_sep: bool = False

    emulating_vhs: bool = False
    vhs_tape_speed: VHSSpeed = VHSSpeed.SP
    vhs_head_switching: bool = False
    vhs_head_switching_point: float = 1.0 - ((4.5 + 0.01) / 262.5)
    vhs_head_switching_phase: float = (1.0 - 0.01) / 262.5
    vhs_head_switching_phase_noise: float = (1.0 / 300.0) / 262.5
    vhs_chroma_vert_blend: bool = True
    vhs_svideo_out: bool = False
    vhs_out_sharpen: float = 1.5
    vhs_out_sharpen_chroma: float = 0.85

    output_audio_rate: int = 44100
    output_audio_channels: int = 2
    output_audio_hiss_db: float = -72.0
    output_audio_linear_buzz: float = -42.0
    output_audio_highpass: float = 20.0
    output_audio_lowpass: float = 20000.0
    vhs_linear_high_boost: float = 0.25
    output_vhs_hifi: bool = True
    output_vhs_linear_stereo: bool = False
    output_vhs_linear_audio: bool = False
    emulating_preemphasis: bool = True
    emulating_deemphasis: bool = True

    enable_composite_emulation: bool = True
    enable_audio_emulation: bool = True
    black_key_level_feedback: int = -1
    transcode_start: float = -1.0
    transcode_end: float = -1.0
    transcode_dur: float = -1.0
    frame_delay: int = 1           # gen-2 -d ring length
    seed: int = 0
    checkpoint: bool = False       # original extension: resumable runs
    devices: int = 0               # original extension: multi-chip mesh size

    # --- preset mutators (exact side-effect sets from the reference) -------

    def preset_ntsc(self):  # ffmpeg_to_composite.cpp:1262-1270
        self.field_rate_num, self.field_rate_den = 60000, 1001
        self.height, self.width = 480, 720
        self.ntsc = True

    def preset_pal(self):  # :1252-1260
        self.field_rate_num, self.field_rate_den = 50, 1
        self.height, self.width = 576, 720
        self.ntsc = False

    def preset_vhs(self):  # :1483-1493
        self.emulating_vhs = True
        self.vhs_head_switching = True
        self.emulating_preemphasis = False
        self.emulating_deemphasis = False
        self.output_audio_hiss_db = -70
        self.video_chroma_phase_noise = 4
        self.video_chroma_noise = 16
        self.video_chroma_loss = 4
        self.video_noise = 4

    def preset_vhs_speed(self, speed: str):  # :1508-1537
        self.emulating_vhs = True
        table = {
            "ep": (VHSSpeed.EP, 6, 22, 8, 6),
            "lp": (VHSSpeed.LP, 5, 19, 6, 5),
            "sp": (VHSSpeed.SP, 4, 16, 4, 4),
        }
        if speed not in table:
            raise ValueError(f"Unknown vhs tape speed '{speed}'")
        sp, cpn, cn, cl, n = table[speed]
        self.vhs_tape_speed = sp
        self.video_chroma_phase_noise = cpn
        self.video_chroma_noise = cn
        self.video_chroma_loss = cl
        self.video_noise = n

    def preset_vhs_hifi(self, on: bool):  # :1538-1551
        self.output_vhs_hifi = on
        self.output_vhs_linear_audio = not on
        self.emulating_vhs = True
        if on:
            self.emulating_preemphasis = True
            self.emulating_deemphasis = True
            self.output_audio_hiss_db = -70
        else:
            self.output_audio_hiss_db = -42

    def preset_catv(self, n: int, gen2: bool = False):
        # gen-1 :1424-1438; gen-2 (stronger) ffmpeg_ntsc.cpp:1077-1096
        if gen2:
            table = {
                1: (7.0, 315000000 / 88, 2),
                2: (15.0, 315000000 / 88, 4),
                3: (25.0, (315000000 * 2) / 88, 6),
                4: (40.0, (315000000 * 4) / 88, 6),
            }
        else:
            table = {
                1: (1.5, 315000000 / 88 / 2, 2),
                2: (2.5, 315000000 / 88 / 2, 4),
                3: (4.0, 315000000 / 88 / 2, 6),
            }
        pre, cut, cpn = table[n]
        self.composite_preemphasis = pre
        self.composite_preemphasis_cut = cut
        self.video_chroma_phase_noise = cpn

    # --- derived-config post-pass (:1577-1629) ------------------------------

    def finalize(self):
        if self.transcode_start >= 0 and self.transcode_end >= 0:
            self.transcode_dur = self.transcode_end - self.transcode_start
        if self.transcode_start < 0:
            self.transcode_start = 0
        if self.transcode_end < 0 and self.transcode_dur >= 0:
            self.transcode_end = self.transcode_start + self.transcode_dur

        if self.emulating_vhs:
            if self.output_vhs_hifi:
                self.output_audio_highpass = 20
                self.output_audio_lowpass = 20000
                self.output_audio_channels = 2
            elif self.output_vhs_linear_audio:
                self.output_audio_highpass = 100
                self.output_audio_lowpass = {
                    VHSSpeed.SP: 10000, VHSSpeed.LP: 7000, VHSSpeed.EP: 4000,
                }[self.vhs_tape_speed]
                self.output_audio_channels = 2 if self.output_vhs_linear_stereo else 1
        else:
            self.output_audio_highpass = 20
            self.output_audio_lowpass = 20000
            self.output_audio_channels = 2

    def finalize_gen1(self):
        self.finalize()
        # :1626-1627
        if self.composite_preemphasis != 0:
            self.subcarrier_amplitude_back += int(
                (50 * self.composite_preemphasis) / 4)

    def finalize_gen2(self):
        self.finalize()
        # ffmpeg_ntsc.cpp:1264-1265
        if self.composite_preemphasis != 0:
            self.subcarrier_amplitude_back += int(
                (50 * self.composite_preemphasis * (315000000 / 88))
                / (2 * self.composite_preemphasis_cut))

    # --- freeze into dataclasses --------------------------------------------

    def to_run_config(self, gen1: bool = True) -> RunConfig:
        comp = CompositeConfig(
            ntsc=self.ntsc,
            subcarrier_amplitude=self.subcarrier_amplitude,
            subcarrier_amplitude_back=self.subcarrier_amplitude_back,
            composite_preemphasis=self.composite_preemphasis,
            composite_preemphasis_cut=self.composite_preemphasis_cut,
            video_scanline_phase_shift=self.video_scanline_phase_shift,
            video_scanline_phase_shift_offset=self.video_scanline_phase_shift_offset,
            composite_in_chroma_lowpass=self.composite_in_chroma_lowpass,
            composite_out_chroma_lowpass=self.composite_out_chroma_lowpass,
            composite_out_chroma_lowpass_lite=self.composite_out_chroma_lowpass_lite,
            video_noise=self.video_noise,
            video_chroma_noise=self.video_chroma_noise,
            video_chroma_phase_noise=self.video_chroma_phase_noise,
            video_chroma_loss=self.video_chroma_loss,
            video_yc_recombine=self.video_yc_recombine,
            nocolor_subcarrier=self.nocolor_subcarrier,
            nocolor_subcarrier_after_yc_sep=self.nocolor_subcarrier_after_yc_sep,
            chroma_phase_noise_gen1_bug=gen1,
            emulating_vhs=self.emulating_vhs,
            vhs_tape_speed=self.vhs_tape_speed,
            vhs_head_switching=self.vhs_head_switching,
            vhs_head_switching_point=self.vhs_head_switching_point,
            vhs_head_switching_phase=(
                self.vhs_head_switching_point if gen1
                else self.vhs_head_switching_phase),
            vhs_head_switching_phase_noise=self.vhs_head_switching_phase_noise,
            vhs_chroma_vert_blend=self.vhs_chroma_vert_blend,
            vhs_svideo_out=self.vhs_svideo_out,
            vhs_out_sharpen=self.vhs_out_sharpen,
            vhs_out_sharpen_chroma=self.vhs_out_sharpen_chroma,
        )
        audio = AudioConfig(
            ntsc=self.ntsc,
            rate=self.output_audio_rate,
            channels=self.output_audio_channels,
            hiss_db=self.output_audio_hiss_db,
            linear_buzz_db=self.output_audio_linear_buzz,
            highpass_hz=self.output_audio_highpass,
            lowpass_hz=self.output_audio_lowpass,
            linear_high_boost=self.vhs_linear_high_boost,
            vhs_hifi=self.output_vhs_hifi,
            vhs_linear_audio=self.output_vhs_linear_audio,
            emulating_preemphasis=self.emulating_preemphasis,
            emulating_deemphasis=self.emulating_deemphasis,
            preemphasis_cut_hz=16000.0 if self.output_vhs_hifi else 8000.0,
        )
        out = OutputConfig(
            ntsc=self.ntsc, width=self.width, height=self.height,
            field_rate_num=self.field_rate_num,
            field_rate_den=self.field_rate_den,
            interlaced_output=self.interlaced_output,
            use_422_colorspace=self.use_422_colorspace,
        )
        return RunConfig(
            composite=comp, audio=audio, output=out,
            enable_composite_emulation=self.enable_composite_emulation,
            enable_audio_emulation=self.enable_audio_emulation,
            black_key_level_feedback=self.black_key_level_feedback,
            transcode_start=self.transcode_start,
            transcode_end=self.transcode_end,
            seed=self.seed,
        )


COMPOSITE_HELP = """\
-i <input file>              Y4M video in (gen-2 'ntsc': repeatable, layered)
-o <output file>             Y4M video out
-audio-in / -audio-out       sidecar WAV audio in/out
-audio-pts-in <file>         audio packet log '<pts_samples> <nsamples>'
                             per line; silence pad-fills PTS gaps
                             (A/V master-clock repair, reference :1892-1915)
-video-pts-in <file>         frame log: optional 'rate <hz>' line then
                             '<pts> <duration>' ticks per frame; VFR/telecine
                             sources render each frame for its own duration
                             (the duration-map role, reference :1641-1647)
-tvstd <pal|ntsc>            raster/timing preset
-vhs                         VHS artifact emulation preset
-vhs-hifi <0|1>              Hi-Fi vs linear audio track (default on)
-vhs-speed <sp|lp|ep>        tape speed (implies -vhs)
-preemphasis / -deemphasis <0|1>   audio emphasis emulation
-nocolor-subcarrier[-after-yc-sep] debug taps
-subcarrier-amp <0..100>     subcarrier amplitude
-noise <0..100>              luma noise
-chroma-noise <0..100>       chroma AM noise
-chroma-phase-noise <0..100> chroma phase noise
-chroma-dropout <0..10000>   chroma scanline dropouts
-audio-hiss <-120..0>        audio hiss dBFS
-vhs-linear-video-crosstalk <dB>  sync buzz loudness
-vhs-linear-high-boost <x>   linear-track high boost
-vhs-head-switching <0|1> / -vhs-head-switching-point <x>
-vhs-head-switching-noise-level <x>
-vhs-svideo <0|1>            S-Video out of the VCR (skip recombine)
-vhs-chroma-vblend <0|1>     vertical chroma blend
-yc-recomb <n>               extra Y/C recombine cycles
-comp-pre <s> / -comp-cut <f>  composite preemphasis scale/frequency
-comp-catv[2|3|4]            CATV look presets
-comp-phase <0|90|180|270> / -comp-phase-offset <n>
-vi / -vp                    interlaced frame-rate vs bob field-rate output
-422 / -420                  output chroma siting
-nocomp                      transcode only, no emulation
-ss/-se/-t <seconds>         transcode window
-in-composite-lowpass / -out-composite-lowpass[-lite] <0|1>
-bkey-feedback <n>           black-key feedback ("hall of mirrors")
-width <n>                   output width
-seed <n>                    deterministic noise seed
-checkpoint                  resumable run: save a <out>.ckpt cursor; rerun
                             the same command to continue after a crash
-devices <n>                 shard each field batch over an n-device mesh
                             (multi-chip; output bit-identical to 1 device)
-a/-v <n>, -an/-vn           stream selection
"""


def parse_composite_flags(argv: Sequence[str], gen2: bool = False) -> FlagState:
    """Left-to-right flag parser with the reference's exact names and
    preset-layering order (parse_argv, ffmpeg_to_composite.cpp:1325-1639 /
    ffmpeg_ntsc.cpp:972-1282)."""
    st = FlagState()
    if gen2:
        st.video_noise = 2  # same default
        # gen-2 defaults to 1/500th of a scanline of switch-point jitter
        # (ffmpeg_ntsc.cpp:764); gen-1 is the 1/300 tool
        # (ffmpeg_to_composite.cpp:275). Explicit
        # -vhs-head-switching-noise-level below overrides either.
        st.vhs_head_switching_phase_noise = (1.0 / 500.0) / 262.5
    it = iter(range(len(argv)))
    i = 0

    def take():
        nonlocal i
        v = argv[i]
        i += 1
        return v

    while i < len(argv):
        a = take()
        if not a.startswith("-"):
            raise ValueError(f"Unhandled arg '{a}'")
        a = a.lstrip("-")
        if a in ("h", "help"):
            import sys

            print(COMPOSITE_HELP, file=sys.stderr)
            # the reference's parse_argv returns 1 after help()
            # (ffmpeg_to_composite.cpp:1327-1330) and main exits nonzero
            raise SystemExit(1)
        elif a == "width":
            st.width = int(take())
            if st.width < 32:
                raise ValueError("width too small")
        elif a == "comp-phase-offset":
            st.video_scanline_phase_shift_offset = int(take())
        elif a == "comp-phase":
            st.video_scanline_phase_shift = int(take())
            if st.video_scanline_phase_shift not in (0, 90, 180, 270):
                raise ValueError("Invalid phase")
        elif a == "bkey-feedback":
            st.black_key_level_feedback = int(take())
        elif a == "in-composite-lowpass":
            st.composite_in_chroma_lowpass = int(take()) > 0
        elif a == "out-composite-lowpass":
            st.composite_out_chroma_lowpass = int(take()) > 0
        elif a == "out-composite-lowpass-lite":
            st.composite_out_chroma_lowpass_lite = int(take()) > 0
        elif a == "checkpoint":
            st.checkpoint = True
        elif a == "ss":
            st.transcode_start = float(take())
        elif a == "se":
            st.transcode_end = float(take())
        elif a == "t":
            st.transcode_dur = float(take())
        elif a == "nocomp":
            st.enable_composite_emulation = False
            st.enable_audio_emulation = False
        elif a == "422":
            st.use_422_colorspace = True
        elif a == "420":
            st.use_422_colorspace = False
        elif a == "a":
            st.audio_stream_index = int(take())
        elif a == "v":
            st.video_stream_index = int(take())
        elif a == "an":
            st.audio_stream_index = -1
        elif a == "vn":
            st.video_stream_index = -1
        elif a == "vi":
            st.interlaced_output = True
        elif a == "vp":
            st.interlaced_output = False
        elif a == "d" and gen2:
            st.frame_delay = int(take())
            if st.frame_delay == 0 or st.frame_delay > 256:
                raise ValueError("Invalid delay")
        elif a == "vhs-head-switching-point":
            st.vhs_head_switching_point = float(take())
        elif a == "vhs-head-switching-phase" and gen2:
            st.vhs_head_switching_phase = float(take())
        elif a == "vhs-head-switching-noise-level":
            st.vhs_head_switching_phase_noise = float(take())
        elif a == "vhs-head-switching":
            st.vhs_head_switching = int(take()) > 0
        elif a == "vhs-linear-high-boost":
            st.vhs_linear_high_boost = float(take())
        elif a == "comp-pre":
            st.composite_preemphasis = float(take())
        elif a == "comp-cut":
            st.composite_preemphasis_cut = float(take())
        elif a == "comp-catv":
            st.preset_catv(1, gen2)
        elif a == "comp-catv2":
            st.preset_catv(2, gen2)
        elif a == "comp-catv3":
            st.preset_catv(3, gen2)
        elif a == "comp-catv4" and gen2:
            st.preset_catv(4, gen2)
        elif a == "vhs-linear-video-crosstalk":
            st.output_audio_linear_buzz = float(take())
        elif a == "chroma-phase-noise":
            st.video_chroma_phase_noise = int(take())
        elif a == "yc-recomb":
            st.video_yc_recombine = int(float(take()))
        elif a == "audio-hiss":
            st.output_audio_hiss_db = float(take())
        elif a == "vhs-svideo":
            st.vhs_svideo_out = int(take()) > 0
        elif a == "vhs-chroma-vblend":
            st.vhs_chroma_vert_blend = int(take()) > 0
        elif a == "chroma-noise":
            st.video_chroma_noise = int(take())
        elif a == "noise":
            st.video_noise = int(take())
        elif a == "subcarrier-amp":
            x = int(take())
            st.subcarrier_amplitude = x
            st.subcarrier_amplitude_back = x
        elif a == "nocolor-subcarrier":
            st.nocolor_subcarrier = True
        elif a == "nocolor-subcarrier-after-yc-sep":
            st.nocolor_subcarrier_after_yc_sep = True
        elif a == "chroma-dropout":
            st.video_chroma_loss = int(take())
        elif a == "vhs":
            st.preset_vhs()
        elif a == "preemphasis":
            st.emulating_preemphasis = int(take()) > 0
        elif a == "deemphasis":
            st.emulating_deemphasis = int(take()) > 0
        elif a == "i":
            st.input_files.append(take())
        elif a == "o":
            st.output_file = take()
        elif a == "audio-in":
            st.audio_in = take()
        elif a == "audio-out":
            st.audio_out = take()
        elif a == "audio-pts-in":
            st.audio_pts_in = take()
        elif a == "video-pts-in":
            st.video_pts_in = take()
        elif a == "seed":
            st.seed = int(take())
        elif a == "devices":
            st.devices = int(take())
        elif a == "vhs-speed":
            st.preset_vhs_speed(take())
        elif a == "vhs-hifi":
            st.preset_vhs_hifi(int(take()) > 0)
        elif a == "tvstd":
            v = take()
            if v == "pal":
                st.preset_pal()
            elif v == "ntsc":
                st.preset_ntsc()
            else:
                raise ValueError(f"Unknown tv std '{v}'")
        else:
            raise ValueError(f"Unknown switch '{a}'")

    if gen2:
        st.finalize_gen2()
    else:
        st.finalize_gen1()
    return st
