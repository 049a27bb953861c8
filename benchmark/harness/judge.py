"""The comparison that decides `correct`: each output field (a render's
output frame, or one field of a library call) that the run sampled
against the reference's, byte by byte.

Numbers compared, each against its limit in the workload file:
- `worst_field_mismatch_pct`: the largest share, over the sampled fields,
  of a field's bytes that differ from the reference's;
- `missing_fields`: fields that were due and never came (limit 0).
The largest difference of any byte (`max_diff`) is kept for calibration
only: the TF32 control reads 1 on gen-2, which a limit cannot separate
from a sound run's rounding."""

from __future__ import annotations

import sys

import numpy as np

NUMBERS = ("worst_field_mismatch_pct", "missing_fields")


class Tally:
    def __init__(self):
        self.fields = 0
        self.worst_pct = 0.0
        self.max_diff = 0
        self.missing = 0

    def add(self, got, want):
        """One field: `got` and `want` as sequences of uint8 planes (or
        bytes), compared plane by plane; a field that never came is None."""
        if got is None:
            self.missing += 1
            return
        n = diff = 0
        worst = 0
        for g, w in zip(got, want):
            g = np.frombuffer(g, np.uint8) if isinstance(g, bytes) else \
                np.asarray(g, np.uint8).ravel()
            w = np.asarray(w, np.uint8).ravel()
            if g.size != w.size:
                self.missing += 1
                return
            d = np.abs(g.astype(np.int16) - w.astype(np.int16))
            diff += int(np.count_nonzero(d))
            n += d.size
            worst = max(worst, int(d.max()) if d.size else 0)
        self.fields += 1
        self.worst_pct = max(self.worst_pct, 100.0 * diff / max(n, 1))
        self.max_diff = max(self.max_diff, worst)

    def numbers(self) -> dict:
        return {"worst_field_mismatch_pct": self.worst_pct,
                "missing_fields": float(self.missing)}


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): every number at or under its
    limit. A number without a limit fails."""
    out, ok = {}, True
    for name in NUMBERS:
        value, limit = numbers[name], limits.get(name)
        out[name] = {"value": value, "limit": limit}
        ok &= limit is not None and value <= limit
    return bool(ok), out


def print_check(check: dict, fields: int, stream=sys.stderr):
    """The numbers compared beside their limits, as the run's last lines on
    standard error."""
    print(f"\ncheck: {fields} sampled fields against the reference",
          file=stream)
    for name, v in check.items():
        print(f"check {name} {v['value']!r} limit {v['limit']!r}",
              file=stream)
    stream.flush()
