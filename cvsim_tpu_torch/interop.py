"""State that crosses from the JAX package to the port.

The chain has no weights. Its state is the configuration, the PRNG key
(collapsed to one u32 stream seed) and the IIR constant tables; the tests
feed both packages through these functions. Nothing here imports the JAX
package: a reference object is read by its field names.
"""

from __future__ import annotations

import numpy as np

import dataclasses

from cvsim_tpu_torch.config import CompositeConfig, VHSSpeed
from cvsim_tpu_torch.models.fused_yiq import _alpha_consts
from cvsim_tpu_torch.ops.noise import MASK32, key32


def key32_from_key_data(key_data: np.ndarray) -> int:
    """The engine's u32 stream seed from `np.asarray(jax.random.key_data(
    key))` (or a raw [2] u32 key): mix32(kd[0] ^ mix32(kd[-1]))."""
    return key32(np.asarray(key_data).astype(np.uint32).reshape(-1))


def key32_from_seed(seed: int) -> int:
    """key32_from_key_data(key_data(jax.random.PRNGKey(seed))) without
    jax: the key data of PRNGKey(seed) is [seed >> 32, seed & 0xFFFFFFFF]."""
    return key32([(seed >> 32) & MASK32, seed & MASK32])


def alpha_consts(cfg: CompositeConfig):
    """(tt, d, tt3, d3, vt) numpy tables, bit-equal to the JAX package's
    fused_yiq._alpha_consts(cfg)."""
    return _alpha_consts(cfg)


def convert_config(cfg, config_cls, speed_cls):
    """A `config_cls` built from any object with its fields (by name),
    the tape speed by enum member name. The two packages' configs share
    field and member names, so this maps either way."""
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(config_cls)}
    kw["vhs_tape_speed"] = speed_cls[kw["vhs_tape_speed"].name]
    return config_cls(**kw)


def config_from_reference(cfg) -> CompositeConfig:
    """The port's CompositeConfig from the JAX package's (or any object
    with its fields)."""
    return convert_config(cfg, CompositeConfig, VHSSpeed)
