"""Small versions of the cells for CPU tests: the configuration's flags
with `-width 64` (the parser's smallest useful width; the height stays
480, as no flag sets it), GOPs of 4 fields, pools of 2-3 pictures."""


def overrides(spec, name: str) -> dict:
    cell = spec.cell(name)
    cfg = spec.config(cell["config"])
    o = {"argv": cfg["argv"] + ["-width", "64"], "output": {"width": 64},
         "gop": 4}
    if cell["driver"].startswith("render"):
        o.update(stream={"width": 64, "pool_frames": 3}, warmup_frames=2,
                 sample_gops=2)
    else:
        o.update(batch=4, field_shape=[240, 64], pool_batches=2,
                 warmup_calls=1, sample_calls=2)
    return o
