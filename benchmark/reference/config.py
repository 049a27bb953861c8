"""The chain's settings as the reference reads them: the `composite` and
`output` objects of a configuration file, which state every resolved
value of the configuration's flags. The harness checks, before it runs,
that the program's own flag parser gives the same values."""

from __future__ import annotations

from types import SimpleNamespace

# tape speed: (luma_cut, chroma_cut, gen-1 chroma delay, gen-2 chroma
# delay) (ffmpeg_to_composite.cpp:789-807, ffmpeg_ntsc.cpp:1773-1791)
TAPE_SPEEDS = {
    "SP": (2400000.0, 320000.0, 4, 9),
    "LP": (1900000.0, 300000.0, 5, 12),
    "EP": (1400000.0, 280000.0, 6, 14),
}


def chain_config(composite: dict) -> SimpleNamespace:
    """The `composite` object of a configuration file, with the tape
    speed's constants spelled out."""
    cfg = SimpleNamespace(**composite)
    luma, chroma, delay1, delay2 = TAPE_SPEEDS[composite["vhs_tape_speed"]]
    cfg.luma_cut = luma
    cfg.chroma_cut = chroma
    cfg.chroma_delay_gen1 = delay1
    cfg.chroma_delay_gen2 = delay2
    return cfg


def output_config(output: dict) -> SimpleNamespace:
    return SimpleNamespace(**output)
