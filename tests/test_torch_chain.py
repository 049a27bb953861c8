"""The port's gen-2 chain against the JAX package.

The port's composite_layer_rgb (stage path) and its main-path entry
(composite_layer_rgb_auto: prepare + chain_reference on a CPU tensor) vs
the JAX stage path yiq.composite_layer_rgb and the JAX fused kernel in
interpret mode, on every configuration of tests/test_fused_chain.py at
(2,32,128) and (1,16,176). Tolerance: assert_chain_equal, the JAX
package's own fused-vs-stage tolerance (at most 1 LSB on at most 0.1% of
samples): both sides run the same float32 math, but the matrix products
and the sin/cos of the chroma phase round differently in the two
frameworks, so a value that lands exactly on an integer can truncate one
LSB apart.

The kernel itself is tested in tests/test_torch_kernel.py.
"""

import zlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cvsim_tpu import config as jconfig
from cvsim_tpu.models import yiq as jyiq
from cvsim_tpu.models.fused_yiq import composite_layer_rgb_fused as jfused
from cvsim_tpu_torch import interop
from cvsim_tpu_torch.models import yiq
from cvsim_tpu_torch.testing import (CHAIN_CONFIGS, assert_chain_equal,
                                     reference_config)

SHAPES = {"2x32x128": ((2, 32, 128), [0, 1], [0, 1]),
          "1x16x176": ((1, 16, 176), [4], [1])}
CASES = [(n, s) for n in sorted(CHAIN_CONFIGS) for s in sorted(SHAPES)]


def _inputs(name, shape_name):
    (b, l, w), fn, par = SHAPES[shape_name]
    rng = np.random.default_rng(zlib.crc32(f"{name}/{shape_name}".encode()))
    rgb = rng.integers(0, 256, size=(b, l, w, 3)).astype(np.uint8)
    return rgb, np.array(fn, np.int32), np.array(par, np.int32)


@pytest.mark.parametrize("name,shape_name", CASES)
def test_chain_matches_jax(name, shape_name):
    cfg = CHAIN_CONFIGS[name]
    rgb, fn, par = _inputs(name, shape_name)
    key = jax.random.PRNGKey(5)
    k32 = interop.key32_from_key_data(np.asarray(jax.random.key_data(key)))
    rgb_j = jnp.asarray(rgb, jnp.int32)
    jcfg = reference_config(cfg, jconfig)
    want_stage = np.asarray(jyiq.composite_layer_rgb(
        rgb_j, jnp.asarray(fn), jnp.asarray(par), key, cfg=jcfg))
    want_fused = np.asarray(jfused(rgb_j, jnp.asarray(fn), jnp.asarray(par),
                                   key, cfg=jcfg, interpret=True))

    rgb_t = torch.from_numpy(rgb)
    fn_t, par_t = torch.from_numpy(fn), torch.from_numpy(par)
    got_stage = yiq.composite_layer_rgb(rgb_t, fn_t, par_t, k32,
                                        cfg=cfg).numpy()
    got_main = yiq.composite_layer_rgb_auto(rgb_t, fn_t, par_t, k32,
                                            cfg=cfg).numpy()
    assert got_stage.dtype == np.uint8 and got_stage.shape == rgb.shape
    np.testing.assert_array_equal(got_main, got_stage)
    assert_chain_equal(got_stage, want_stage, err_msg=f"{name} vs jax stage")
    assert_chain_equal(got_stage, want_fused, err_msg=f"{name} vs jax fused")
