"""The program under test as the harness touches it: its flag parser (the
run's configuration, checked against the configuration file), and the
two library entries of the chains, which the lower-precision control and
the planted faults replace for the length of a run."""

from __future__ import annotations

import contextlib
import dataclasses
import importlib

# the main-path entry of each chain: (module, function)
ENTRIES = {
    "gen2": ("cvsim_tpu_torch.models.yiq", "composite_layer_rgb_auto"),
    "gen1": ("cvsim_tpu_torch.models.yuv422", "composite_video_process_auto"),
}


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


def replaced_entry(gen: str, fn):
    """The block runs with `fn(original, *args, **kwargs)` in place of the
    chain's entry."""
    mod_name, name = ENTRIES[gen]
    mod = importlib.import_module(mod_name)
    original = getattr(mod, name)

    def replacement(*args, **kwargs):
        return fn(original, *args, **kwargs)

    return patched((mod, name, replacement))


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
