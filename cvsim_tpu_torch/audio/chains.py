"""VHS audio emulation chain (twin of cvsim_tpu.audio.chains;
ffmpeg_to_composite.cpp:558-627, configured :2126-2162).

Stage order per sample (reference loop):
  1. bandpass bank: 6 serial lowpasses then 6 serial highpasses per channel
  2. preemphasis: s += pre[i].highpass(s) for i in range(channels); the
     reference drives every channel's filter with the interleaved stream,
     so each pass filters the flattened [N*C] stream (quirk kept)
  3. sync buzz on linear tracks: a host-side closed form of the sample
     counter (buzz_pulse_counts), no recurrence
  4. hard clip to [-1, 1]
  5. hiss: iid uniform in [-level, level] / 20000, content-addressed per
     absolute sample index (ops/noise.hiss_per_sample)
  6. linear-track high boost: s += boost[c].highpass(s) * k
  7. deemphasis: s = post[i].lowpass(s) for i in range(channels), the
     same interleaved-stream quirk as (2)

Every filter is the blocked one-pole IIR (ops/blocked_iir.py); a 1M-sample
chunk takes its long-axis branch, whose carry chain is a log-depth scan.
The chain is a `(state, x) -> (state, y)` step, so chunks with a carried
state match one whole stream: in float32 within 1 int16 LSB (the
reduction tree of the block products varies with the length), as in the
JAX package. There is no TPU kernel on this path: the JAX chain is plain
XLA, and this is its plain PyTorch twin. Block products must run in full
float32 (no TF32: it breaks the 1-LSB bound); both chains set that on the
card (blocked_iir.full_float32).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from cvsim_tpu_torch.config import AudioConfig, iir_alpha
from cvsim_tpu_torch.ops.blocked_iir import full_float32
from cvsim_tpu_torch.ops.cmath import clips16
from cvsim_tpu_torch.ops.iir import iir_lowpass
from cvsim_tpu_torch.ops.noise import hiss_per_sample


class AudioState(NamedTuple):
    """Carried filter registers. Shapes: [C, passes] for the bank, [C] for
    per-channel filters, [C] for the interleaved-stream filters."""

    bank_lo: torch.Tensor      # [C, passes]
    bank_hi: torch.Tensor      # [C, passes]
    pre: torch.Tensor          # [C] preemphasis registers
    boost: torch.Tensor        # [C]
    post: torch.Tensor         # [C] deemphasis registers
    sample_count: int | torch.Tensor   # running audio_proc_count


def init_audio_state(cfg: AudioConfig, dtype=torch.float32,
                     device=None) -> AudioState:
    c, p = cfg.channels, cfg.bandpass_passes
    z = lambda *s: torch.zeros(s, dtype=dtype, device=device)
    return AudioState(bank_lo=z(c, p), bank_hi=z(c, p), pre=z(c),
                      boost=z(c), post=z(c), sample_count=0)


def buzz_pulse_counts(cfg: AudioConfig, start_count: int, n: int):
    """Host-side (NumPy float64) closed form of the 16x-oversampled sync-buzz
    pulse train (ffmpeg_to_composite.cpp:582-599): number of pulse slots per
    sample, [n] uint8. Data-independent, so it is computed on the host and
    fed to the device kernel — float32 cannot hold the sample index exactly
    past ~6 minutes of audio."""
    import numpy as np

    hsync_hz = 15734.0 if cfg.ntsc else 15625.0
    vsync_lines = 525 if cfg.ntsc else 625
    vpulse_end = 10 if cfg.ntsc else 12
    hpulse_end = hsync_hz * ((4.7 if cfg.ntsc else 4.0) / 1e6)

    idx = np.arange(start_count, start_count + n, dtype=np.float64)
    oi = np.arange(16, dtype=np.float64)
    t = ((idx[:, None] * 16.0 + oi[None, :]) * hsync_hz) / cfg.rate / 16.0
    hpos = np.mod(t, 1.0)
    vline = np.mod(np.floor(t + 1e-4 - hpos), vsync_lines / 2.0)
    pulse = (hpos < hpulse_end) | (vline < vpulse_end)
    return pulse.sum(axis=-1).astype(np.uint8)


def _bandpass_bank(s, state_lo, state_hi, a_lo, a_hi, passes: int):
    """The reference's HiLoPass bank (ffmpeg_to_composite.cpp:133-228):
    per channel, `passes` serial lowpasses then `passes` serial
    highpasses. s: [N, C]; returns (filtered [N, C], bank_lo [C, passes],
    bank_hi [C, passes])."""
    new_lo, new_hi = [], []
    sc = s.T  # [C, N]
    for p in range(passes):
        lp = iir_lowpass(sc, a_lo, state_lo[:, p])
        new_lo.append(lp[:, -1])
        sc = lp
    for p in range(passes):
        lp = iir_lowpass(sc, a_hi, state_hi[:, p])
        new_hi.append(lp[:, -1])
        sc = sc - lp
    return sc.T, torch.stack(new_lo, dim=-1), torch.stack(new_hi, dim=-1)


def _interleaved_stage(x, alpha, y0, kind: str):
    """One reference-quirk filter stage over the flattened interleaved
    stream: x [N, C] -> [N*C]; 'preemph' gives s + highpass(s), 'deemph'
    gives lowpass(s). Returns ([N, C], new register)."""
    n, c = x.shape
    flat = x.reshape(n * c)
    lp = iir_lowpass(flat, alpha, y0)
    out = 2.0 * flat - lp if kind == "preemph" else lp
    return out.reshape(n, c), lp[-1]


def _emphasis(s, regs, alpha, kind: str):
    """The C interleaved passes of pre- or deemphasis, one register each."""
    new = []
    for i in range(s.shape[1]):
        s, r = _interleaved_stage(s, alpha, regs[i], kind)
        new.append(r)
    return s, torch.stack(new)


def _const(value: float, like: torch.Tensor) -> torch.Tensor:
    """A 0-dim tensor on `like`'s device: dividing by it is a true
    division on the card too (a Python divisor becomes a reciprocal
    multiply there)."""
    return torch.tensor(value, dtype=like.dtype, device=like.device)


def composite_audio_process(
    audio: torch.Tensor,       # int16-range [N, C] (interleaved samples)
    state: AudioState,
    key32: int,
    *,
    cfg: AudioConfig,
    pulses=None,               # [N] buzz pulse counts from buzz_pulse_counts()
    dtype=torch.float32,
):
    """Process a chunk; returns (int32 int16-range [N, C], new AudioState).
    key32: the stream seed (interop.key32_from_seed), one for the stream."""
    n, c = audio.shape
    assert c == cfg.channels
    full_float32(audio)   # no TF32 in the block products
    s = audio.to(dtype) / 32768.0

    # 1. bandpass bank: per channel, 6 lowpasses then 6 highpasses
    s, bank_lo, bank_hi = _bandpass_bank(
        s, state.bank_lo, state.bank_hi, iir_alpha(cfg.rate, cfg.lowpass_hz),
        iir_alpha(cfg.rate, cfg.highpass_hz), cfg.bandpass_passes)

    # 2. preemphasis (interleaved-stream quirk)
    pre_reg = state.pre
    if cfg.emulating_preemphasis:
        s, pre_reg = _emphasis(s, state.pre,
                               iir_alpha(cfg.rate, cfg.preemphasis_cut_hz),
                               "preemph")

    # 3. linear-track sync buzz
    linear_buzz = 10.0 ** (cfg.linear_buzz_db / 20.0)
    if (not cfg.vhs_hifi) and linear_buzz > 1e-9 and pulses is not None:
        p = torch.as_tensor(np.asarray(pulses)).to(device=s.device,
                                                   dtype=dtype)
        s = s - (p * (linear_buzz / 16.0 / 2.0))[:, None]

    # 4. clip
    s = torch.clamp(s, -1.0, 1.0)

    # 5. hiss, content-addressed per absolute sample index
    level = cfg.hiss_level
    if level != 0:
        u = hiss_per_sample(key32, state.sample_count, n, c, level, dtype,
                            device=s.device)
        s = s + u / _const(20000.0, u)

    # 6. linear high boost
    boost_reg = state.boost
    if (not cfg.vhs_hifi) and cfg.linear_high_boost > 0:
        lp = iir_lowpass(s.T, iir_alpha(cfg.rate, 10000.0), state.boost)
        boost_reg = lp[:, -1]
        s = s + (s.T - lp).T * _const(cfg.linear_high_boost, s)

    # 7. deemphasis (interleaved-stream quirk)
    post_reg = state.post
    if cfg.emulating_deemphasis:
        s, post_reg = _emphasis(s, state.post,
                                iir_alpha(cfg.rate, cfg.preemphasis_cut_hz),
                                "deemph")

    out = clips16(s * 32768.0).to(torch.int32)
    new_state = AudioState(
        bank_lo=bank_lo, bank_hi=bank_hi, pre=pre_reg, boost=boost_reg,
        post=post_reg, sample_count=state.sample_count + n)
    return out, new_state
