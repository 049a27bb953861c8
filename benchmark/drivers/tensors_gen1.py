"""Gen-1 library calls: `models.yuv422.composite_video_process_auto` on
batches of uint8 4:2:2 Y, U, V fields already on the card
(`fused_yuv.prepare`, then kernel #5), the shape the `to-composite`
render's GOP step hands it."""

from __future__ import annotations

from cvsim_tpu_torch.models import fused_yuv, yuv422  # noqa: F401
from harness import controls, tensors
from harness.tensors import TensorDriver
from harness.textures import device_pool
from harness.work import gen1_call
from reference import gen1

ENTRY = ("cvsim_tpu_torch.models.yuv422", "composite_video_process_auto")
FAULTS = controls.FAULTS
small = tensors.small


def control(config: dict):
    return controls.control("gen1", config)


class Driver(TensorDriver):
    ENTRY = ENTRY

    def __init__(self, cell):
        super().__init__(cell)
        lead = (self.n_pool, self.batch, self.lines)
        self.pool = (
            device_pool(cell.seed, (*lead, self.width), None, cell.device,
                        16.0, 235.0),
            device_pool(cell.seed + 1, (*lead, self.width // 2), None,
                        cell.device, 40.0, 216.0),
            device_pool(cell.seed + 2, (*lead, self.width // 2), None,
                        cell.device, 40.0, 216.0))
        self.least_time = gen1_call(cell.config["composite"], self.batch,
                                    self.lines, self.width)

    def _wrapped(self, spans):
        return [(fused_yuv, "prepare", spans.wrap("prepare",
                                                  fused_yuv.prepare)),
                (yuv422, "composite_video_process_auto",
                 spans.wrap("call", yuv422.composite_video_process_auto))]

    def _reference(self, inputs, fieldno, parity, cfg):
        out = gen1.chain(*inputs, fieldno, parity, cfg,
                         self.cell.config["seed"])
        return tuple(p.cpu().numpy() for p in out)
