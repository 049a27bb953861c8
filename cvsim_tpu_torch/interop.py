"""State that crosses from the JAX package to the port.

The chain has no weights. Its state is the configuration, the PRNG key
(collapsed to one u32 stream seed), the IIR constant tables and, for the
audio chains and the raw decoder, the state carried from chunk to chunk;
the tests feed both packages through these functions. Nothing here imports the JAX
package: a reference object is read by its field names.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cvsim_tpu_torch.audio.cassette import CassetteConfig, CassetteState
from cvsim_tpu_torch.audio.chains import AudioState
from cvsim_tpu_torch.config import AudioConfig, CompositeConfig, VHSSpeed
from cvsim_tpu_torch.models.fused_yiq import _alpha_consts
from cvsim_tpu_torch.models.raw28 import AGCState, Raw28State
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


def convert_config(cfg, config_cls, speed_cls=None):
    """A `config_cls` built from any object with its fields (by name),
    the tape speed (where the class has one) by enum member name. The two
    packages' configs share field and member names, so this maps either
    way."""
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(config_cls)}
    if "vhs_tape_speed" in kw:
        kw["vhs_tape_speed"] = speed_cls[kw["vhs_tape_speed"].name]
    return config_cls(**kw)


def config_from_reference(cfg):
    """The port's CompositeConfig or AudioConfig from the JAX package's
    (by class name; any object with the class's fields)."""
    if type(cfg).__name__ == "AudioConfig":
        return convert_config(cfg, AudioConfig)
    return convert_config(cfg, CompositeConfig, VHSSpeed)


def cassette_config_from_reference(cfg) -> CassetteConfig:
    """The port's CassetteConfig from the JAX package's (a NamedTuple with
    the same fields)."""
    return CassetteConfig(**{f: getattr(cfg, f)
                             for f in CassetteConfig._fields})


def _state_from_reference(state, state_cls, device, dtype):
    """A port state NamedTuple from a reference state (fields by name,
    each array-like): float fields as `dtype` tensors on `device`,
    sample_count as an int64 tensor."""
    kw = {}
    for name in state_cls._fields:
        value = np.asarray(getattr(state, name))
        if name == "sample_count":
            kw[name] = torch.tensor(int(value), dtype=torch.int64,
                                    device=device)
        else:
            kw[name] = torch.tensor(value, dtype=dtype, device=device)
    return state_cls(**kw)


def audio_state_from_reference(state, device="cuda",
                               dtype=torch.float32) -> AudioState:
    """The port's AudioState from the JAX package's (its fields as numpy
    arrays, e.g. after `jax.device_get`), so a port chain can continue a
    stream mid-way from the JAX chain's carried registers."""
    return _state_from_reference(state, AudioState, device, dtype)


def cassette_state_from_reference(state, device="cuda",
                                  dtype=torch.float32) -> CassetteState:
    """The port's CassetteState from the JAX package's (see
    audio_state_from_reference)."""
    return _state_from_reference(state, CassetteState, device, dtype)


def raw28_state_from_reference(decoder, device="cuda") -> Raw28State:
    """The port's Raw28State from a JAX package Raw28Decoder (its AGC
    levels and int32[16] chroma-tail carry), the carry on `device`: a
    port decoder built with it continues where the JAX one stands."""
    tail = decoder._chroma_tail
    return Raw28State(
        AGCState(float(decoder.agc.blank_level),
                 float(decoder.agc.white_level)),
        None if tail is None else torch.tensor(
            np.asarray(tail), dtype=torch.int32, device=device))
