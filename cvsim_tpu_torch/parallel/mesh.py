"""Multi-device paths for field batches (twin of cvsim_tpu.parallel.mesh).

- **dp** axis: the fields of a batch are independent (their only shared
  state is fieldno/parity metadata, and the noise is content-addressed by
  (seed, fieldno, stage)), so the batch axis splits over devices.
- **sp** axis: every stage of the chain is local to one scanline except
  the 2-line chroma vertical blend, and the head switch is a per-row
  rotation by a shift that depends only on the row's global index. So the
  line axis splits too: each row shard runs kernels #2-#4
  (models/fused_yiq.stage_a/_b1/_b2) with its rows of the global per-line
  streams, and the blend takes one halo row per chroma plane from the
  shard above. No other rows cross devices.

A mesh is a (dp, sp) grid of torch devices. On CUDA it holds distinct
GPUs; on the CPU it holds n references to the CPU device, the twin of the
JAX tests' virtual CPU devices. Work is issued device by device from the
calling thread: CUDA launches are asynchronous, so the GPUs of a mesh run
concurrently.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from cvsim_tpu_torch.config import CompositeConfig


def _factor_2d(n: int) -> tuple[int, int]:
    """Split n devices into (dp, sp) as square as possible, dp >= sp."""
    best = (n, 1)
    for sp in range(1, int(math.isqrt(n)) + 1):
        if n % sp == 0:
            best = (n // sp, sp)
    return best


class Mesh(NamedTuple):
    """A (dp, sp) grid of devices: devices[d][s]."""
    devices: tuple

    @property
    def dp(self) -> int:
        return len(self.devices)

    @property
    def sp(self) -> int:
        return len(self.devices[0])

    @property
    def size(self) -> int:
        return self.dp * self.sp

    @property
    def flat(self) -> list:
        return [d for row in self.devices for d in row]


def make_mesh(n_devices: int, kind: str = "cuda",
              dp: int | None = None) -> Mesh:
    """(dp, sp) mesh over the first n devices of `kind` ("cuda" or "cpu").

    dp: explicit field-parallel extent (sp = n/dp); by default the
    square-ish factoring of _factor_2d. Raises if fewer than n CUDA devices
    are visible: silently shrinking the mesh would let an n-way check pass
    on fewer devices."""
    if n_devices < 1:
        raise ValueError(f"make_mesh({n_devices}): need at least one device")
    if kind == "cuda":
        count = torch.cuda.device_count()
        if count < n_devices:
            raise ValueError(f"make_mesh({n_devices}) but only {count} CUDA "
                             "device(s) visible")
        devices = [torch.device("cuda", k) for k in range(n_devices)]
    elif kind == "cpu":
        devices = [torch.device("cpu")] * n_devices
    else:
        raise ValueError(f"make_mesh: unknown device kind '{kind}'")
    if dp is not None:
        if n_devices % dp:
            raise ValueError(f"dp={dp} must divide {n_devices} devices")
        sp = n_devices // dp
    else:
        dp, sp = _factor_2d(n_devices)
    return Mesh(tuple(tuple(devices[d * sp:(d + 1) * sp]) for d in range(dp)))


def map_fields(mesh: Mesh, fn, *tensors, out_device=None):
    """Split each tensor's batch axis over every device of the mesh (dp and
    sp flattened), run fn on each device's block, and concatenate the
    results on out_device (default: the first tensor's device). fn returns
    a tensor or a tuple of tensors. The batch must divide the mesh size."""
    n = mesh.size
    b = tensors[0].shape[0]
    if b % n:
        raise ValueError(f"mesh size {n} must divide the field batch {b}")
    out_device = tensors[0].device if out_device is None else out_device
    step = b // n
    # every device's work is issued before any result is gathered: a copy
    # back to the host waits for its device, and would serialise the mesh
    outs = []
    for k, dev in enumerate(mesh.flat):
        out = fn(*(t[k * step:(k + 1) * step].to(dev, non_blocking=True)
                   for t in tensors))
        outs.append(out if isinstance(out, tuple) else (out,))
    cat = tuple(torch.cat([o.to(out_device) for o in c]) for c in zip(*outs))
    return cat if len(cat) > 1 else cat[0]


def run_sharded_chain_fused(mesh: Mesh, cfg: CompositeConfig, rgb, fieldno,
                            field_parity, key: int):
    """The gen-2 chain with the field batch split over every device of the
    mesh; each device runs the main path (yiq.composite_layer_rgb_auto:
    kernel #1 on a GPU) on its block. The noise is content-addressed per
    field, so the result equals the single-device batch byte for byte.

    rgb: uint8 [B, L, W, 3] on any device (a pinned CPU tensor for the
    pipeline); the output lands on rgb's device. B must divide the mesh
    size. key: the u32 stream seed."""
    from cvsim_tpu_torch.models import yiq

    return map_fields(
        mesh, lambda r, f, p: yiq.composite_layer_rgb_auto(r, f, p, key,
                                                           cfg=cfg),
        rgb, fieldno, field_parity)


def _run_fused_lines(grid, cfg: CompositeConfig, rgb, fieldno, field_parity,
                     key: int):
    """The line-sharded program over a [dp][sp] grid of devices: fields
    over dp, lines over sp. Each shard runs A -> head switch -> B1, then
    the vertical blend with a one-row halo from the shard above, then B2.
    Output: uint8 [B, L, W, 3] on rgb's device."""
    from cvsim_tpu_torch.models import fused_yiq, yiq

    b, l, w, _ = rgb.shape
    dp, sp = len(grid), len(grid[0])
    if b % dp or l % sp:
        raise ValueError(f"batch {b} / lines {l} must divide mesh dp={dp} / "
                         f"sp={sp}")
    bl, ll = b // dp, l // sp
    blend = yiq.do_vert_blend(cfg)
    front = {}
    for d in range(dp):
        fb = slice(d * bl, (d + 1) * bl)
        for s in range(sp):
            dev = grid[d][s]
            rgb_s = (rgb[fb, s * ll:(s + 1) * ll]
                     .to(dev, non_blocking=True).contiguous())
            prep = fused_yiq.prepare(cfg, rgb_s, fieldno[fb].to(dev),
                                     field_parity[fb].to(dev), key,
                                     row0=s * ll, l_glob=l)
            y = fused_yiq.stage_a(rgb_s, prep, cfg=cfg)
            if cfg.vhs_head_switching:
                y = fused_yiq.head_switch_rows(y, prep.shifts, w)
            front[d, s] = prep, fused_yiq.stage_b1(y, prep, cfg=cfg, w=w)
    rows = []
    for d in range(dp):
        shards = []
        for s in range(sp):
            dev = grid[d][s]
            prep, (y2, i2, q2) = front[d, s]
            if blend:
                # the unblended last row of each chroma plane above
                halo = ((None, None) if s == 0 else
                        tuple(p[:, -1:].to(dev) for p in front[d, s - 1][1][1:]))
                i2 = fused_yiq.vblend_rows(i2, prep.row0, halo[0])
                q2 = fused_yiq.vblend_rows(q2, prep.row0, halo[1])
            shards.append(fused_yiq.stage_b2(y2, i2, q2, prep, cfg=cfg, w=w))
        rows.append(shards)
    return torch.cat([torch.cat([o.to(rgb.device) for o in shards], dim=1)
                      for shards in rows])


def run_sharded_chain_fused_lines(mesh: Mesh, cfg: CompositeConfig, rgb,
                                  fieldno, field_parity, key: int):
    """Line-sharded multi-device path: fields over dp, lines over sp, with
    kernels #2-#4 on every shard. For a batch smaller than the mesh (one
    1080i frame's 2 fields over 8 GPUs) it keeps every device busy, where
    run_sharded_chain_fused would idle some. Outputs equal the unsharded
    chain. B must divide dp and L must divide sp."""
    return _run_fused_lines(mesh.devices, cfg, rgb, fieldno, field_parity,
                            key)


def run_fused_lines_local(cfg: CompositeConfig, rgb, fieldno, field_parity,
                          key: int, sp: int):
    """The line-sharded program with all `sp` row shards on rgb's device,
    run one after another: the same shard bodies and seams as
    run_sharded_chain_fused_lines, so one GPU runs the non-zero-row0
    kernels natively."""
    if rgb.shape[1] % sp:
        raise ValueError(f"lines {rgb.shape[1]} must divide sp={sp}")
    return _run_fused_lines([[rgb.device] * sp], cfg, rgb, fieldno,
                            field_parity, key)
