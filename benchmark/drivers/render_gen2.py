"""Gen-2 `ntsc` render: the stream through `YIQPipeline.run_video`, the
pipeline built as the CLI's `cmd_ntsc` builds it (host/pipeline_yiq.py:
the field loop, the GOP through `process_batch` and kernel #1, `_emit`:
bob and RGB->YUV per field, the Y4M writer)."""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from cvsim_tpu_torch.host import pipeline_yiq
from cvsim_tpu_torch.models import fused_yiq
from harness import controls, program, render
from harness.render import RenderDriver
from reference import gen2, host

# the program function the GOP step goes through, which the control and
# the faults replace
ENTRY = ("cvsim_tpu_torch.models.yiq", "composite_layer_rgb_auto")
FAULTS = controls.FAULTS
small = render.small


def control(config: dict):
    return controls.control("gen2", config)


class Driver(RenderDriver):
    def __init__(self, cell):
        super().__init__(cell)
        cfg, st = program.run_config(cell.config)
        self.pipe = pipeline_yiq.YIQPipeline(
            cfg, frame_delay=st.frame_delay, gop=self.gop, device=cell.device,
            devices=st.devices)

    def _run_video(self, reader, sink) -> int:
        return self.pipe.run_video([reader], sink)

    @contextlib.contextmanager
    def traced(self, spans):
        pipe = self.pipe
        with program.patched(
                (pipe, "_emit", spans.wrap("emit", pipe._emit)),
                (pipe, "process_batch",
                 spans.wrap("process_batch", pipe.process_batch)),
                (fused_yiq, "prepare", spans.wrap("prepare",
                                                  fused_yiq.prepare)),
                (pipeline_yiq, "_scale_frame_to",
                 spans.wrap("scale", pipeline_yiq._scale_frame_to))):
            yield

    def _reference_frames(self, cfg, fields, sources):
        """The reference's output frames (Y, U, V) of output fields
        `fields`: the source frame to RGB at the output raster, the field's
        lines, the chain, the bob and RGB->YUV."""
        rgb_of = {}
        rgb = []
        for n in fields:
            frame = sources[n]
            key = frame % len(self.pool)
            if key not in rgb_of:
                rgb_of[key] = host.frame_to_rgb(*self._source(frame),
                                                self.out_w, self.out_h)
            rgb.append(host.gen2_field(rgb_of[key], n))
        dev = self.cell.device
        batch = torch.from_numpy(np.stack(rgb).astype(np.uint8)).to(dev)
        fieldno = torch.tensor(fields, dtype=torch.int32)
        parity = torch.tensor([host.parity_of(n) for n in fields],
                              dtype=torch.int32)
        out = gen2.chain(batch, fieldno, parity, cfg,
                         self.cell.config["seed"]).cpu().numpy()
        return [host.gen2_output(f, self.out_h) for f in out]
