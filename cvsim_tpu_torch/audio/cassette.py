"""Audio-cassette emulation chain (twin of cvsim_tpu.audio.cassette;
ffmpeg_cassette.cpp:334-416).

Per-sample order: bandpass bank -> preemphasis (4 kHz, interleaved-stream
quirk) -> hard clip -> hiss -> time-varying triangular-FIR head-azimuth
convolution with per-channel +/- lr_delay skew -> deemphasis -> optional
mono downmix.

The head-tilt FIR (ConvolutionMap, :278-371) rebuilds its kernel every
sample from

    head_tilt_final(t) = tilt + waver * sin(2*pi*1.5*t)
    lr_delay(t) = 1.5 * head_tilt_final(t)
    kernel_len  = floor(5*|tilt| + 7.5)          (fixed at stream start)
    mid_ch      = +/- lr_delay + len/2
    k[i] = max(0, 1 - |(i - mid)/( |htf|+1 )|) / (|htf|+1)

and convolves past samples: out(t) = sum_i k[i] * s(t - (len-1-i)). The
kernels of a chunk are one [N, C, len] tensor, the history a sliding
window over the chunk with len-1 carried samples (`Tensor.unfold`), and
the convolution a product and a sum over the window: no per-sample loop.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from cvsim_tpu_torch.audio.chains import _bandpass_bank, _const, _emphasis
from cvsim_tpu_torch.config import iir_alpha
from cvsim_tpu_torch.ops.blocked_iir import full_float32
from cvsim_tpu_torch.ops.cmath import c_div, clips16
from cvsim_tpu_torch.ops.noise import hiss_per_sample


class CassetteConfig(NamedTuple):
    rate: int = 44100
    channels: int = 2
    lowpass_hz: float = 20000.0
    highpass_hz: float = 20.0
    hiss_db: float = -72.0
    head_tilt: float = 0.2
    head_tilt_waver: float = 0.5
    emulating_preemphasis: bool = True
    emulating_deemphasis: bool = True
    preemphasis_cut_hz: float = 4000.0
    mono_downmix: bool = False
    bandpass_passes: int = 6

    @property
    def hiss_level(self) -> int:
        return int(10.0 ** (self.hiss_db / 20.0) * 5000)

    @property
    def kernel_len(self) -> int:
        return int(math.floor(abs(self.head_tilt) * 5 + 7.5))


CASSETTE_PRESETS = {
    # -preset 0..4 (ffmpeg_cassette.cpp:515-556)
    0: dict(lowpass_hz=16000, highpass_hz=100, head_tilt_waver=0.55, head_tilt=3.5),
    1: dict(lowpass_hz=14000, highpass_hz=100, head_tilt_waver=0.6, head_tilt=6),
    2: dict(lowpass_hz=10000, highpass_hz=100, head_tilt_waver=0.5, head_tilt=3),
    3: dict(lowpass_hz=16000, highpass_hz=20, head_tilt_waver=0.75, head_tilt=10),
    4: dict(lowpass_hz=16000, highpass_hz=20, head_tilt_waver=0.25, head_tilt=1.1),
}


class CassetteState(NamedTuple):
    bank_lo: torch.Tensor      # [C, passes]
    bank_hi: torch.Tensor      # [C, passes]
    pre: torch.Tensor          # [C]
    post: torch.Tensor         # [C]
    history: torch.Tensor      # [len-1, C] trailing samples feeding the FIR
    sample_count: int | torch.Tensor


def init_cassette_state(cfg: CassetteConfig, dtype=torch.float32,
                        device=None) -> CassetteState:
    c, p = cfg.channels, cfg.bandpass_passes
    z = lambda *s: torch.zeros(s, dtype=dtype, device=device)
    return CassetteState(
        bank_lo=z(c, p), bank_hi=z(c, p), pre=z(c), post=z(c),
        history=z(cfg.kernel_len - 1, c), sample_count=0)


def _head_kernels(cfg: CassetteConfig, start_count, n: int, dtype,
                  device=None) -> torch.Tensor:
    """Per-sample triangular kernels, [N, C, len]."""
    length = cfg.kernel_len
    # the 1.5 Hz waver's phase repeats every 2 seconds exactly (3 cycles):
    # reduce the absolute sample index mod 2*rate in integer math before
    # the float divide (a float32 counter loses sample resolution past
    # 2^24, ~6 minutes at 44.1 kHz)
    period = 2 * cfg.rate
    idx = (start_count % period
           + torch.arange(n, dtype=torch.int64, device=device)) % period
    t = idx.to(dtype)
    t = t / _const(float(cfg.rate), t)
    htf = cfg.head_tilt + cfg.head_tilt_waver * torch.sin(
        t * (2.0 * math.pi) * 1.5)
    lr = htf * 1.5
    i = torch.arange(length, dtype=dtype, device=device)
    denom = torch.abs(htf) + 1.0
    ks = []
    for c in range(cfg.channels):
        mid = (lr if c == 0 else -lr) + length / 2.0
        d = (i[None, :] - mid[:, None]) / denom[:, None]
        d = torch.clamp(1.0 - torch.abs(d), min=0.0) / denom[:, None]
        ks.append(d)
    return torch.stack(ks, dim=1)  # [N, C, len]


def cassette_audio_process(
    audio: torch.Tensor,     # int16-range [N, C]
    state: CassetteState,
    key32: int,
    *,
    cfg: CassetteConfig,
    dtype=torch.float32,
):
    """Process a chunk; returns (int32 int16-range [N, C], new state)."""
    n, c = audio.shape
    assert c == cfg.channels
    full_float32(audio)   # no TF32 in the block products
    s = audio.to(dtype) / 32768.0

    # 1. bandpass bank (shared with the VHS chain)
    s, bank_lo, bank_hi = _bandpass_bank(
        s, state.bank_lo, state.bank_hi, iir_alpha(cfg.rate, cfg.lowpass_hz),
        iir_alpha(cfg.rate, cfg.highpass_hz), cfg.bandpass_passes)

    # 2. preemphasis (interleaved-stream quirk, 4 kHz)
    pre_reg = state.pre
    if cfg.emulating_preemphasis:
        s, pre_reg = _emphasis(s, state.pre,
                               iir_alpha(cfg.rate, cfg.preemphasis_cut_hz),
                               "preemph")

    # 3. clip
    s = torch.clamp(s, -1.0, 1.0)

    # 4. hiss (content-addressed per absolute sample index)
    if cfg.hiss_level != 0:
        u = hiss_per_sample(key32, state.sample_count, n, c, cfg.hiss_level,
                            dtype, device=s.device)
        s = s + u / _const(20000.0, u)

    # 5. head-tilt convolution: windows [N, C, len] times kernels
    length = cfg.kernel_len
    full = torch.cat([state.history, s], dim=0)       # [len-1+N, C]
    wins = full.unfold(0, length, 1)                  # [N, C, len]
    kern = _head_kernels(cfg, state.sample_count, n, dtype, s.device)
    s = (wins * kern).sum(dim=-1)
    history = full[full.shape[0] - (length - 1):]

    # 6. deemphasis
    post_reg = state.post
    if cfg.emulating_deemphasis:
        s, post_reg = _emphasis(s, state.post,
                                iir_alpha(cfg.rate, cfg.preemphasis_cut_hz),
                                "deemph")

    out = clips16(s * 32768.0).to(torch.int32)

    # 7. mono downmix: audio[0] = audio[1] = (a0 + a1) / 2 (C division)
    if cfg.mono_downmix and c == 2:
        mono = c_div(out[:, 0] + out[:, 1], 2)
        out = torch.stack([mono, mono], dim=-1)

    new_state = CassetteState(
        bank_lo=bank_lo, bank_hi=bank_hi, pre=pre_reg, post=post_reg,
        history=history, sample_count=state.sample_count + n)
    return out, new_state
