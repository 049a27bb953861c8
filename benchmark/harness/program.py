"""The program under test as the harness touches it: its flag parser (the
run's configuration, checked against the configuration file), and the
replacement of a driver's entry (`drivers/<driver>.ENTRY`, a (module,
function) pair) by its lower-precision control or a planted fault for
the length of a run."""

from __future__ import annotations

import contextlib
import dataclasses
import importlib

@contextlib.contextmanager
def patched(*patches):
    """Set each (object, attribute, value) for the block; restore after."""
    old = [(obj, attr, getattr(obj, attr)) for obj, attr, _ in patches]
    try:
        for obj, attr, value in patches:
            setattr(obj, attr, value)
        yield
    finally:
        for obj, attr, value in reversed(old):
            setattr(obj, attr, value)


def replaced_entry(entry: tuple, fn):
    """The block runs with `fn(original, *args, **kwargs)` in place of the
    program function `entry`, (module, function)."""
    mod_name, name = entry
    mod = importlib.import_module(mod_name)
    original = getattr(mod, name)

    def replacement(*args, **kwargs):
        return fn(original, *args, **kwargs)

    return patched((mod, name, replacement))


def at_width(config: dict, width: int) -> dict:
    """Overrides of a chain configuration that run it at `width` samples a
    line through the parser's `-width` flag (no flag sets the height)."""
    return {"argv": config["argv"] + ["-width", str(width)],
            "output": {"width": width}}


def run_config(config: dict):
    """(RunConfig, FlagState) from the configuration's flags through the
    program's own parser, as its CLI builds them; raises where they differ
    from the values the configuration file states."""
    from cvsim_tpu_torch import presets

    gen2 = config["tool"] == "ntsc"
    st = presets.parse_composite_flags(config["argv"], gen2=gen2)
    cfg = st.to_run_config(gen1=not gen2)
    comp = dataclasses.asdict(cfg.composite)
    comp["vhs_tape_speed"] = cfg.composite.vhs_tape_speed.name
    stated = {"composite": config["composite"], "output": config["output"],
              "seed": config["seed"]}
    parsed = {"composite": comp, "output": dataclasses.asdict(cfg.output),
              "seed": cfg.seed}
    for key, want in stated.items():
        if parsed[key] != want:
            raise ValueError(f"{config['name']}: the program parses the "
                             f"flags to {key} {parsed[key]!r}, the "
                             f"configuration states {want!r}")
    return cfg, st
