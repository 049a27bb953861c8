"""CLI for the raw composite decoder (ffmpeg_raw28ntsc flags, :436-498):
-s <ntsc28|40mhz|hz> sample rate, -i <raw file|-> (repeatable), -o out.y4m,
-marksig, -nosig, -noequ, -nowequ, -nosc, -showsc, -422/-420, -width.
The twin of cvsim_tpu.cli.raw28: the same flags and output bytes, with
each field's line DSP on `device`.

`parse` turns the flags into the decoder's settings and `decode_stream`
runs one input through a decoder into a Y4M writer; `run` is the two with
the files around them.
"""

from __future__ import annotations

import sys
from fractions import Fraction
from typing import NamedTuple

import numpy as np
import torch

from cvsim_tpu_torch.host import y4m
from cvsim_tpu_torch.models.raw28 import Raw28Decoder, RawTiming, rate_preset
from cvsim_tpu_torch.utils import log

# one output frame per decoded field -> 59.94 fps progressive
# (output_field_rate {60000,1001}, ffmpeg_raw28ntsc.cpp:219)
FIELD_RATE = Fraction(60000, 1001)

HELP = ("flags: -i <raw|-> -o <out.y4m> -s <ntsc28|40mhz|hz> "
        "-width <n> -marksig -nosig -noequ -nowequ -nosc -showsc "
        "-color -sat <x> -422 -420 -inntsc")


class UsageError(ValueError):
    """A command line the decoder cannot run: its message is the answer."""


class Raw28Args(NamedTuple):
    """What the flags set: the sample rate, the output raster, its chroma
    layout, the decoder's keyword settings, the inputs and the output."""
    rate: float
    width: int
    height: int
    use_422: bool
    decoder_kw: dict
    inputs: list
    output: str

    def decoder(self, device) -> Raw28Decoder:
        return Raw28Decoder(self.rate, width=self.width, height=self.height,
                            device=device, **self.decoder_kw)

    def header(self) -> y4m.Y4MHeader:
        return y4m.Y4MHeader(width=self.width, height=self.height,
                             fps=FIELD_RATE, interlacing="p",
                             colorspace="422" if self.use_422 else "420jpeg")


def parse(argv) -> Raw28Args:
    """The settings of a raw28ntsc command line; raises UsageError for -h
    and an unknown switch."""
    inputs = []
    output = ""
    width = None  # default: full raster width, (rl+1)&~1 (preset_NTSC :396)
    srate = "ntsc28"
    use_422 = True
    kw = dict()
    i = 0
    while i < len(argv):
        a = argv[i].lstrip("-"); i += 1
        if a in ("h", "help"):
            raise UsageError(HELP)
        if a == "i":
            inputs.append(argv[i]); i += 1
        elif a == "o":
            output = argv[i]; i += 1
        elif a == "s":
            srate = argv[i]; i += 1
        elif a == "width":
            width = int(argv[i]); i += 1
        elif a == "marksig":
            kw["mark_sync"] = True
        elif a == "nosig":
            kw["disable_sync"] = True
        elif a == "noequ":
            kw["equalize"] = False
        elif a == "nowequ":
            kw["wp_equalize"] = False
        elif a == "nosc":
            kw["separate_chroma"] = False
        elif a == "showsc":
            kw["show_subcarrier"] = True
        elif a == "color":
            kw["decode_color"] = True   # beyond-reference: burst-locked QAM
        elif a == "sat":
            kw["saturation"] = float(argv[i]); i += 1
        elif a == "422":
            use_422 = True
        elif a == "420":
            use_422 = False
        elif a == "inntsc":
            pass
        else:
            raise UsageError(f"Unknown switch '{a}'")

    # Reference geometry: preset_NTSC() runs after parse_argv in main
    # (ffmpeg_raw28ntsc.cpp:877) and sets height=262, width=(rl+1)&~1
    # (:395-396) — each decoded 262-line field raster becomes ONE output
    # frame at 59.94 fps, full raster width, no line doubling. (The
    # reference thereby clobbers -width; we honor it when given.)
    rate = rate_preset(srate)
    if width is None:
        width = (RawTiming(rate).raw_length + 1) & ~1
    return Raw28Args(rate, width, 262, use_422, kw, inputs, output)


def write_field(writer: y4m.Y4MWriter, result, decode_color: bool):
    """One decoded field raster as one Y4M frame (no line doubling): its
    luma, and neutral chroma, or with -color its decoded chroma."""
    if decode_color:
        frame, uv = result
    else:
        frame, uv = result, None
    width = writer.header.width
    use_422 = writer.header.colorspace == "422"
    if uv is not None:
        u, v = uv
        cb = np.clip(128 + u * (224.0 / 255.0) / 1.772,
                     0, 255).astype(np.uint8)
        cr = np.clip(128 + v * (224.0 / 255.0) / 1.402,
                     0, 255).astype(np.uint8)
        if use_422:
            writer.write(frame, cb[:, 0::2], cr[:, 0::2])
        else:
            writer.write(frame, cb[0::2, 0::2], cr[0::2, 0::2])
    elif use_422:
        neutral = np.full((frame.shape[0], width // 2), 128, np.uint8)
        writer.write(frame, neutral, neutral)
    else:
        neutral = np.full((frame.shape[0] // 2, width // 2), 128, np.uint8)
        writer.write(frame, neutral, neutral)


def decode_stream(dec: Raw28Decoder, reader, writer: y4m.Y4MWriter,
                  chunk: int = 1 << 20, on_field=None) -> int:
    """Feed `reader` (a binary stream) to `dec` in `chunk`-byte reads until
    it ends, writing every field the decoder completes; returns the fields
    written. `on_field()` is called after each."""
    fields = 0
    while True:
        data = reader.read(chunk)
        if not data:
            return fields
        dec.feed(data)
        while True:
            result = dec.decode_field()
            if result is None:
                break
            with log.span("raw28.write"):
                write_field(writer, result, dec.decode_color)
            fields += 1
            if on_field is not None:
                on_field()


def run(argv, device: torch.device):
    try:
        args = parse(argv)
    except UsageError as e:
        print(e, file=sys.stderr)
        return 1
    if not args.inputs or not args.output:
        print("raw28ntsc needs -i <raw|-> and -o <out.y4m>", file=sys.stderr)
        return 1

    dec = args.decoder(device)
    fout = open(args.output, "wb")
    writer = y4m.Y4MWriter(fout, args.header())
    fields = 0

    def progress():
        nonlocal fields
        fields += 1
        print(f"\x0dOutput field {fields} ", end="", file=sys.stderr)

    for path in args.inputs:
        f = sys.stdin.buffer if path == "-" else open(path, "rb")
        decode_stream(dec, f, writer, on_field=progress)
        if path != "-":
            f.close()
    print("", file=sys.stderr)
    fout.close()
    return 0
