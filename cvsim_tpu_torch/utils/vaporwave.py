"""ASCII -> fullwidth Unicode "vaporwave" text (text2vaporwave.pl).

Printable ASCII 0x21..0x7E maps to the fullwidth block U+FF01..U+FF5E;
space maps to the ideographic space U+3000.
"""

from __future__ import annotations


def to_vaporwave(text: str) -> str:
    out = []
    for ch in text:
        o = ord(ch)
        if ch == " ":
            out.append("　")
        elif 0x21 <= o <= 0x7E:
            out.append(chr(o - 0x21 + 0xFF01))
        else:
            out.append(ch)
    return "".join(out)


def main(argv=None):
    import sys

    args = sys.argv[1:] if argv is None else argv
    if args:
        print(to_vaporwave(" ".join(args)))
    else:
        for line in sys.stdin:
            print(to_vaporwave(line.rstrip("\n")))
    return 0
