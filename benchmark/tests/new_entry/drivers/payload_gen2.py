"""Y4M frame payloads: `host.payload.payloads` on batches of uint8 RGB
fields already on the card (one launch of csrc/y4m_payload.cu; on a CPU
tensor `payloads_np`), the step of the gen-2 render's `process_batch`
after the chain, at the configuration's output height and chroma layout.

A driver on a program entry other than the two chains: it names its
entry and brings its control, its faults, its small size and its
reference (`reference/payload.py`)."""

from __future__ import annotations

import torch

from cvsim_tpu_torch.host import payload
from harness import controls
from harness.tensors import TensorDriver
from harness.textures import device_pool
from reference import payload as payload_ref

ENTRY = ("cvsim_tpu_torch.host.payload", "payloads")


def small(spec, name: str) -> dict:
    """The CPU tests' size: batches of 4 fields of 240x64."""
    return {"batch": 4, "field_shape": [240, 64], "pool_batches": 2,
            "warmup_calls": 1, "sample_calls": 2}


def control(config: dict):
    """The reference in the entry's place, its RGB->YUV in bfloat16, the
    step below the float32 that the program computes in."""
    def entry(original, fields, height, is422):
        out = payload_ref.payloads(fields.cpu(), height, is422,
                                   torch.bfloat16)
        return out.to(fields.device)

    return entry


def unchanged(original, fields, height, is422):
    """The step hands back its input's bytes as they came, cut to a
    payload's length."""
    n = payload.frame_bytes(height, fields.shape[2], is422)
    return fields.reshape(fields.shape[0], -1)[:, :n].clone()


FAULTS = {"unchanged": unchanged, "half_batch": controls.half_batch,
          "altered": controls.altered}


class Driver(TensorDriver):
    ENTRY = ENTRY

    def __init__(self, cell):
        super().__init__(cell)
        out = cell.config["output"]
        self.height, self.is422 = out["height"], out["use_422_colorspace"]
        self.pool = (device_pool(cell.seed, (self.n_pool, self.batch,
                                             self.lines, self.width, 3),
                                 3, cell.device),)
        self.least_time = None

    def _call(self, i: int):
        # looked up at each call, as a caller of the module's function does
        entry = getattr(self._entry_mod, self._entry_name)
        return entry(self.pool[0][i % self.n_pool], self.height, self.is422)

    def _wrapped(self, spans):
        return [(payload, "payloads", spans.wrap("call", payload.payloads))]

    def _reference(self, inputs, fieldno, parity, cfg):
        return (payload_ref.payloads(inputs[0].cpu(), self.height,
                                     self.is422).numpy(),)
