"""Small versions of the cells for CPU tests: each cell's driver gives
its own overrides (`drivers/<driver>.small(spec, name)`)."""

from harness import spec as spec_mod


def overrides(spec, name: str) -> dict:
    driver = spec_mod.driver_module(spec.cell(name)["driver"])
    return driver.small(spec, name)
