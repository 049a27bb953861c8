"""Kernel #9's plain version (cvsim_tpu_torch.ops.fused_iir.
fused_iir_reference) against the JAX package's standalone pole-cascade
kernel (cvsim_tpu.ops.pallas.fused_iir.fused_iir, interpret mode) on the
same numpy inputs, and the wrapper's CPU contract. The kernel itself is
tested on the card in tests/test_torch_kernel.py.

Tolerance: |diff| <= 8 * eps_f32 * (1 + |gain|) * max|x|. Both sides run
the same per-pole blocked products (x @ T^T + d * carry per 128-sample
block), but XLA and torch sum each 128-term product in another order;
the rounding grows with the number of poles and the mode's gain scales
it (measured on the CPU: at most 0.086 at max|x| = 65280 with gain 7,
1.6e-4 of the bound's scale).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cvsim_tpu.ops.pallas.fused_iir import fused_iir as jfused_iir
from cvsim_tpu_torch.config import NTSC_RATE, iir_alpha
from cvsim_tpu_torch.ops import fused_iir, iir
from cvsim_tpu_torch.testing import iir_bound, launches

CUTS = (1.4e6, 2.4e6, 6e5, 2.8e6)
Y0S = (16.0, 128.0, 0.0, 16.0)
GAINS = {"none": (0.0,), "emph": (1.6, 7.0), "unsharp": (1.5,)}
ROWS = (3, 100)   # 300 rows: not a multiple of the TPU kernel's 256-row tile


def _bound(x, gain):
    return iir_bound(float(np.abs(x).max()), gain)


def _alphas(k):
    return tuple(float(iir_alpha(NTSC_RATE, c)) for c in CUTS[:k])


@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("mode", sorted(GAINS))
@pytest.mark.parametrize("w", [128, 176, 720])
def test_plain_matches_jax_kernel(w, mode, k):
    rng = np.random.default_rng(1000 * w + 10 * k + len(mode))
    for scale in (255, 65280):
        x = rng.integers(0, scale + 1, ROWS + (w,)).astype(np.float32)
        for gain in GAINS[mode]:
            kw = dict(alphas=_alphas(k), y0s=Y0S[:k], mode=mode, gain=gain)
            want = np.asarray(jfused_iir(jnp.asarray(x), interpret=True, **kw))
            got = fused_iir.fused_iir_reference(torch.from_numpy(x), **kw)
            assert got.shape == x.shape and got.dtype == torch.float32
            d = float(np.abs(got.numpy() - want).max())
            assert d <= _bound(x, gain), (scale, gain, d)


@pytest.mark.parametrize("mode", sorted(GAINS))
def test_cpu_wrapper_runs_plain_version(mode):
    """On a CPU tensor the wrapper runs its plain version and counts no
    launch."""
    x = torch.from_numpy(np.random.default_rng(3).integers(
        0, 256, (2, 5, 300)).astype(np.float32))
    kw = dict(alphas=_alphas(3), y0s=Y0S[:3], mode=mode, gain=GAINS[mode][0])
    before = launches("fused_iir")
    assert torch.equal(fused_iir.fused_iir(x, **kw),
                       fused_iir.fused_iir_reference(x, **kw))
    assert launches("fused_iir") == before


@pytest.mark.parametrize("shape", ["emph", "unsharp", "plain"])
@pytest.mark.parametrize("passes", [0, 3])
def test_cascades_match_stage_path_shapes(shape, passes):
    """The stage path's three cascade shapes on kernel #9's route
    (fused_iir.CASCADES) against the plain T^3 cascades (iir.PLAIN) that
    chain_reference runs: single poles against grouped ones, so within
    the float32 bound above (max|x| = 255)."""
    if shape != "emph" and passes == 0:
        passes = 1
    x = torch.from_numpy(np.random.default_rng(passes).integers(
        0, 256, (4, 720)).astype(np.float32))
    alpha = float(iir_alpha(NTSC_RATE, 3.0e6))
    gain = (1.6,) if shape != "plain" else ()
    got = getattr(fused_iir.CASCADES, shape)(x, alpha, 16.0, passes, *gain)
    want = getattr(iir.PLAIN, shape)(x, alpha, 16.0, passes, *gain)
    d = float((got - want).abs().max())
    assert d <= _bound(x.numpy(), gain[0] if gain else 0.0), d


def test_bad_arguments_raise():
    x = torch.zeros(2, 128)
    with pytest.raises(ValueError, match="mode"):
        fused_iir.fused_iir(x, alphas=(0.5,), y0s=(0.0,), mode="lowpass")
    with pytest.raises(ValueError, match="same count"):
        fused_iir.fused_iir(x, alphas=(0.5, 0.5), y0s=(0.0,))
    with pytest.raises(ValueError, match="same count"):
        fused_iir.fused_iir(x, alphas=(0.5,) * (fused_iir.MAX_POLES + 1),
                            y0s=(0.0,) * (fused_iir.MAX_POLES + 1))
