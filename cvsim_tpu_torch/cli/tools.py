"""The port's sibling tools: `cassette` (twin of
cvsim_tpu.cli.tools.run_cassette). The other sibling tools are not ported
yet.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from cvsim_tpu_torch.host import wavio


def run_cassette(argv, device: torch.device):
    """ffmpeg_cassette flags (:420-560): -low -high -headalign
    -headalignwaver -mono -preset 0..4 -audio-hiss -preemphasis -deemphasis.
    Audio-only: -i in.wav -o out.wav. The chain runs on `device` in
    1M-sample chunks with a carried state."""
    from cvsim_tpu_torch.audio.cassette import (CASSETTE_PRESETS,
                                                CassetteConfig)
    from cvsim_tpu_torch.interop import key32_from_seed

    kw = dict()
    in_path = out_path = ""
    ss = se = dur = -1.0
    i = 0
    while i < len(argv):
        a = argv[i].lstrip("-"); i += 1
        if a in ("h", "help"):
            print("flags: -i <in.wav> -o <out.wav> -preset <0..4> -mono "
                  "-low <hz> -high <hz> -headalign <n> -headalignwaver <n> "
                  "-audio-hiss <dB> -preemphasis <0|1> -deemphasis <0|1> "
                  "-a <idx> -an -ss <s> -se <s> -t <s>", file=sys.stderr)
            return 1
        if a == "i":
            in_path = argv[i]; i += 1
        elif a == "o":
            out_path = argv[i]; i += 1
        elif a == "mono":
            kw["mono_downmix"] = True
        elif a == "headalign":
            kw["head_tilt"] = float(int(float(argv[i]))); i += 1  # atoi in ref
        elif a == "headalignwaver":
            kw["head_tilt_waver"] = float(int(float(argv[i]))); i += 1
        elif a == "low":
            kw["lowpass_hz"] = float(argv[i]); i += 1
        elif a == "high":
            kw["highpass_hz"] = float(argv[i]); i += 1
        elif a == "audio-hiss":
            kw["hiss_db"] = float(argv[i]); i += 1
        elif a == "preemphasis":
            kw["emulating_preemphasis"] = int(argv[i]) > 0; i += 1
        elif a == "deemphasis":
            kw["emulating_deemphasis"] = int(argv[i]) > 0; i += 1
        elif a == "preset":
            kw.update(CASSETTE_PRESETS[int(argv[i])]); i += 1
        elif a == "ss":
            ss = float(argv[i]); i += 1
        elif a == "se":
            se = float(argv[i]); i += 1
        elif a == "t":
            dur = float(argv[i]); i += 1
        elif a in ("a", "an"):
            if a == "a":
                i += 1
        else:
            print(f"Unknown switch '{a}'", file=sys.stderr)
            return 1
    if not in_path or not out_path:
        print("cassette needs -i in.wav -o out.wav", file=sys.stderr)
        return 1

    # preset values may be overridden by later flags: _ToolArgs-style ordering
    # is already handled because we apply dict.update in argv order.
    cfg = CassetteConfig(**{k: v for k, v in kw.items()
                            if k in CassetteConfig._fields})
    from cvsim_tpu_torch.host import ffmpeg_pipe

    # WAV natively; any other container/codec through the backend (the
    # reference decodes via libav, ffmpeg_cassette.cpp input loop)
    samples, rate = ffmpeg_pipe.resolve_audio_input(in_path, cfg.rate, 2)
    if rate != cfg.rate:
        from cvsim_tpu_torch.host.pipeline import _resample_sinc
        samples = _resample_sinc(samples, rate, cfg.rate)
    if ss >= 0 or se >= 0 or dur >= 0:
        if se < 0 and dur >= 0:
            se = max(ss, 0) + dur
        s0 = int(max(ss, 0) * cfg.rate)
        s1 = int(se * cfg.rate) if se >= 0 else len(samples)
        samples = samples[s0:s1]
    if samples.shape[1] != cfg.channels:
        if cfg.channels == 2 and samples.shape[1] == 1:
            samples = np.repeat(samples, 2, axis=1)
        else:
            samples = samples[:, :cfg.channels]

    out = cassette_chain(samples, cfg, key32_from_seed(0), device)
    wavio.write_wav(out_path, out.astype(np.int16), cfg.rate)
    return 0


def cassette_chain(samples: np.ndarray, cfg, key32: int,
                   device: torch.device, chunk: int = 1 << 20) -> np.ndarray:
    """The cassette chain over a whole stream [N, C] (int16 range), in
    `chunk`-sample steps on `device` with a carried state (float32);
    returns int32 [N, C]."""
    from cvsim_tpu_torch.audio.cassette import (cassette_audio_process,
                                                init_cassette_state)

    state = init_cassette_state(cfg, torch.float32, device)
    outs = []
    for pos in range(0, len(samples), chunk):
        part = np.ascontiguousarray(samples[pos:pos + chunk], np.int32)
        out, state = cassette_audio_process(
            torch.from_numpy(part).to(device), state, key32, cfg=cfg)
        outs.append(out.cpu().numpy())
    return np.concatenate(outs)
