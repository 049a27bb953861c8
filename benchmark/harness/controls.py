"""Replacements for a chain's library entry, for calibrating and testing
the check (harness/core.run_cell's `entry`); the chain drivers give them
as their `control` and `FAULTS`, and the benchmark's own runs use none
of them.

- `control`: the reference in the program's place, computed one step
  below the precision the configuration states (its float32 block
  products rounded to TF32): the control whose readings set the upper
  end of each limit.
- `FAULTS`: the program's entry broken underneath: the step returns its
  input unchanged, half of the batch is left out (its outputs copied from
  the other half), one field's answer is altered where it is produced.
  The cells run on one chip, so there is no exchange between chips to
  leave out."""

from __future__ import annotations

from reference import common, gen1, gen2
from reference.config import chain_config


def control(gen: str, config: dict):
    cfg = chain_config(config["composite"])
    seed = config["seed"]

    def gen2_entry(original, rgb, fieldno, parity, key, **kw):
        with common.tf32_products():
            return gen2.chain(rgb, fieldno, parity, cfg, seed)

    def gen1_entry(original, y, u, v, fieldno, parity, key, **kw):
        with common.tf32_products():
            return gen1.chain(y, u, v, fieldno, parity, cfg, seed)

    return gen2_entry if gen == "gen2" else gen1_entry


def _planes(out):
    return out if isinstance(out, tuple) else (out,)


def _same_kind(out, planes):
    return planes if isinstance(out, tuple) else planes[0]


def unchanged(original, *args, **kwargs):
    """The step hands back its input planes as they came."""
    n = 1 if args[0].ndim == 4 else 3
    planes = tuple(p.clone() for p in args[:n])
    return planes if n == 3 else planes[0]


def half_batch(original, *args, **kwargs):
    """Only the first half of the fields is processed; the second half's
    outputs repeat the first half's."""
    out = original(*args, **kwargs)
    planes = []
    for p in _planes(out):
        h = p.shape[0] // 2
        q = p.clone()
        q[h:2 * h] = p[:h]
        planes.append(q)
    return _same_kind(out, tuple(planes))


def altered(original, *args, **kwargs):
    """One field of each call comes back altered (every byte of its first
    plane XOR 0x10)."""
    out = original(*args, **kwargs)
    planes = [p.clone() for p in _planes(out)]
    planes[0][0] ^= 0x10
    return _same_kind(out, tuple(planes))


FAULTS = {"unchanged": unchanged, "half_batch": half_batch,
          "altered": altered}
