"""Gen-2 library calls: `models.yiq.composite_layer_rgb_auto` on batches
of uint8 RGB fields already on the card (`fused_yiq.prepare`, then kernel
#1), the shape the `ntsc` render's GOP hands it."""

from __future__ import annotations

from cvsim_tpu_torch.models import fused_yiq, yiq  # noqa: F401
from harness import controls, tensors
from harness.tensors import TensorDriver
from harness.textures import device_pool
from harness.work import gen2_call
from reference import gen2

ENTRY = ("cvsim_tpu_torch.models.yiq", "composite_layer_rgb_auto")
FAULTS = controls.FAULTS
small = tensors.small


def control(config: dict):
    return controls.control("gen2", config)


class Driver(TensorDriver):
    ENTRY = ENTRY

    def __init__(self, cell):
        super().__init__(cell)
        self.pool = (device_pool(cell.seed, (self.n_pool, self.batch,
                                             self.lines, self.width, 3),
                                 3, cell.device),)
        self.least_time = gen2_call(cell.config["composite"], self.batch,
                                    self.lines, self.width)

    def _wrapped(self, spans):
        return [(fused_yiq, "prepare", spans.wrap("prepare",
                                                  fused_yiq.prepare)),
                (yiq, "composite_layer_rgb_auto",
                 spans.wrap("call", yiq.composite_layer_rgb_auto))]

    def _reference(self, inputs, fieldno, parity, cfg):
        out = gen2.chain(inputs[0], fieldno, parity, cfg,
                         self.cell.config["seed"])
        return (out.cpu().numpy(),)
