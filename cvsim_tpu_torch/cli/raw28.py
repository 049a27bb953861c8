"""CLI for the raw composite decoder (ffmpeg_raw28ntsc flags, :436-498):
-s <ntsc28|40mhz|hz> sample rate, -i <raw file|-> (repeatable), -o out.y4m,
-marksig, -nosig, -noequ, -nowequ, -nosc, -showsc, -422/-420, -width.
The twin of cvsim_tpu.cli.raw28: the same flags and output bytes, with
each field's line DSP on `device`.
"""

from __future__ import annotations

import sys
from fractions import Fraction

import numpy as np
import torch

from cvsim_tpu_torch.host import y4m
from cvsim_tpu_torch.models.raw28 import Raw28Decoder, RawTiming, rate_preset


def run(argv, device: torch.device):
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
            print("flags: -i <raw|-> -o <out.y4m> -s <ntsc28|40mhz|hz> "
                  "-width <n> -marksig -nosig -noequ -nowequ -nosc -showsc "
                  "-color -sat <x> -422 -420 -inntsc", file=sys.stderr)
            return 1
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
            print(f"Unknown switch '{a}'", file=sys.stderr)
            return 1
    if not inputs or not output:
        print("raw28ntsc needs -i <raw|-> and -o <out.y4m>", file=sys.stderr)
        return 1

    # Reference geometry: preset_NTSC() runs after parse_argv in main
    # (ffmpeg_raw28ntsc.cpp:877) and sets height=262, width=(rl+1)&~1
    # (:395-396) — each decoded 262-line field raster becomes ONE output
    # frame at 59.94 fps, full raster width, no line doubling. (The
    # reference thereby clobbers -width; we honor it when given.)
    rate = rate_preset(srate)
    if width is None:
        width = (RawTiming(rate).raw_length + 1) & ~1
    height = 262
    dec = Raw28Decoder(rate, width=width, height=height, device=device, **kw)

    # one output frame per decoded field -> 59.94 fps progressive
    # (output_field_rate {60000,1001}, ffmpeg_raw28ntsc.cpp:219)
    hdr = y4m.Y4MHeader(width=width, height=height,
                        fps=Fraction(60000, 1001), interlacing="p",
                        colorspace="422" if use_422 else "420jpeg")
    fout = open(output, "wb")
    writer = y4m.Y4MWriter(fout, hdr)

    fields = 0
    for path in inputs:
        f = sys.stdin.buffer if path == "-" else open(path, "rb")
        while True:
            chunk = f.read(1 << 20)
            if not chunk:
                break
            dec.feed(chunk)
            while True:
                result = dec.decode_field()
                if result is None:
                    break
                if dec.decode_color:
                    field, uv = result
                else:
                    field, uv = result, None
                frame = field  # one frame per field raster (no line doubling)
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
                fields += 1
                print(f"\x0dOutput field {fields} ", end="", file=sys.stderr)
        if path != "-":
            f.close()
    print("", file=sys.stderr)
    fout.close()
    return 0
