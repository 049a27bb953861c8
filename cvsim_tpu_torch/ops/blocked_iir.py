"""One-pole IIR as a blocked lower-triangular matmul (twin of
cvsim_tpu.ops.blocked_iir).

y[t] = a*x[t] + (1-a)*y[t-1] splits the sample axis into 128-sample
blocks: within a block, x_block -> y_block is a product with the dense
lower-triangular T[i,j] = a*(1-a)^(i-j); the carry-in adds d[i] =
(1-a)^(i+1) times the previous block's last value. The constant builders
are copies of the JAX package's (float64 math, one cast at the end), so
both packages filter with bit-equal tables, and the contraction shapes
and left-to-right add order follow the JAX functions so results agree as
closely as float32 allows.

The float32 product must run in full float32 (no TF32): the integer
truncations after each filter depend on it.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from cvsim_tpu_torch.utils import log

BLOCK = 128


@functools.lru_cache(maxsize=64)
def _decay_consts(alpha: float, block: int, np_dtype: str):
    """(T [K,K], d [K], pK scalar) as numpy constants for a given alpha."""
    a = np.float64(alpha)
    one_m = 1.0 - a
    i = np.arange(block)
    expo = i[:, None] - i[None, :]
    T = np.where(expo >= 0, a * one_m ** np.maximum(expo, 0), 0.0)
    d = one_m ** (i + 1.0)
    pk = one_m ** float(block)
    dt = np.dtype(np_dtype)
    return T.astype(dt), d.astype(dt), dt.type(pk)


@functools.lru_cache(maxsize=64)
def _cascade3_consts(alpha: float, block: int, np_dtype: str):
    """Constants for THREE identical poles composed into one matmul:
    y3 = T^3 x + (T^2 d) c1 + (T d) c2 + d c3, with the block-end carries
    from the last rows of T and T^2. Returns (T3, dc1, dc2, d, V12)."""
    a = np.float64(alpha)
    one_m = 1.0 - a
    i = np.arange(block)
    expo = i[:, None] - i[None, :]
    T = np.where(expo >= 0, a * one_m ** np.maximum(expo, 0), 0.0)
    d = one_m ** (i + 1.0)
    T2 = T @ T
    T3 = T2 @ T
    dc1 = T2 @ d
    dc2 = T @ d
    v12 = np.stack([T[block - 1, :], T2[block - 1, :]])
    dt = np.dtype(np_dtype)
    return (T3.astype(dt), dc1.astype(dt), dc2.astype(dt), d.astype(dt),
            v12.astype(dt))


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """[e0, o0, e1, o1, ...] along the last axis; `even` is as long as
    `odd` or one longer."""
    k = odd.shape[-1]
    both = torch.stack([even[..., :k], odd], dim=-1).flatten(-2)
    return torch.cat([both, even[..., k:]], dim=-1)


def carry_scan(m: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Inclusive scan of y[t] = m*y[t-1] + b[t] along the last axis from
    y[-1] = 0, for one decay m (a 0-d tensor of b's dtype).

    The odd/even recursion of `jax.lax.associative_scan` (jax 0.9.0,
    `_scan` in jax/_src/lax/control_flow/loops.py) over the affine maps
    (m, b[t]) with the combine (a_r*a_l, a_r*b_l + b_r): combine adjacent
    pairs, scan the reduced sequence, fill the even elements from it,
    interleave. Only B is kept: its combine reads the right operand's
    decay, which at every level is that level's m (m, m*m, ...), so the
    same products and sums in the same order give the JAX function's
    rounding. A few ops a level, log2(n) levels."""
    n = b.shape[-1]
    if n < 2:
        return b
    rb = m * b[..., 0:n - 1:2] + b[..., 1::2]
    ob = carry_scan(m * m, rb)
    eb = m * (ob[..., :-1] if n % 2 == 0 else ob) + b[..., 2::2]
    return _interleave(torch.cat([b[..., :1], eb], dim=-1), ob)


def full_float32(t: torch.Tensor):
    """The plain versions run with full float32 matrix products on the
    card: the blocked IIR's integer exactness needs them."""
    if t.is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _blocks(x: torch.Tensor, block: int):
    """x [..., W] -> ([..., nb, block] zero-padded, nb)."""
    w = x.shape[-1]
    nb = -(-w // block)
    pad = nb * block - w
    if pad:
        x = torch.cat([x, x.new_zeros(x.shape[:-1] + (pad,))], dim=-1)
    return x.reshape(x.shape[:-1] + (nb, block)), nb


def iir_lowpass3_blocked(x: torch.Tensor, alpha, y0,
                         block: int = BLOCK) -> torch.Tensor:
    """Three identical one-pole lowpasses in series (all registers reset
    to y0) as ONE blocked matmul per block. Long axes (nb > 16) run three
    sequential single-pole passes, as the JAX function does."""
    dtype, dev = x.dtype, x.device
    w = x.shape[-1]
    nb = -(-w // block)
    if nb > 16:
        y = x
        for _ in range(3):
            y = iir_lowpass_blocked(y, alpha, y0, block)
        return y

    consts = _cascade3_consts(float(alpha), block, _dtype_name(dtype))
    T3, dc1, dc2, d, v12 = (log.to_device(torch.from_numpy(c), dev)
                            for c in consts)
    dl = d[-1]
    s2 = dc2[-1]
    q1 = dc1[-1]

    xb, _ = _blocks(x, block)
    yw3 = torch.matmul(xb, T3.T)                   # [..., nb, K]
    u12 = torch.matmul(xb, v12.T)                  # [..., nb, 2]
    u1 = u12[..., 0]
    u2 = u12[..., 1]
    u3 = yw3[..., -1]

    c1 = c2 = c3 = torch.full(x.shape[:-1], float(y0), dtype=dtype,
                              device=dev)
    c1s, c2s, c3s = [], [], []
    for b in range(nb):
        c1s.append(c1)
        c2s.append(c2)
        c3s.append(c3)
        nc1 = u1[..., b] + dl * c1
        nc2 = u2[..., b] + s2 * c1 + dl * c2
        nc3 = u3[..., b] + q1 * c1 + s2 * c2 + dl * c3
        c1, c2, c3 = nc1, nc2, nc3
    C1 = torch.stack(c1s, dim=-1)[..., None]
    C2 = torch.stack(c2s, dim=-1)[..., None]
    C3 = torch.stack(c3s, dim=-1)[..., None]

    y = yw3 + dc1 * C1 + dc2 * C2 + d * C3
    y = y.reshape(x.shape[:-1] + (nb * block,))
    return y[..., :w]


def iir_lowpass_blocked(x: torch.Tensor, alpha, y0,
                        block: int = BLOCK) -> torch.Tensor:
    """Blocked-matmul one-pole lowpass along the last axis.

    y0: scalar or [...] carry-in (the filter's reset value)."""
    dtype, dev = x.dtype, x.device
    w = x.shape[-1]
    T_np, d_np, pk = _decay_consts(float(alpha), block, _dtype_name(dtype))
    T = log.to_device(torch.from_numpy(T_np), dev)
    d = log.to_device(torch.from_numpy(d_np), dev)
    pk_t = log.to_device(torch.tensor(pk, dtype=dtype), dev)

    xb, nb = _blocks(x, block)
    yw = torch.matmul(xb, T.T)                     # [..., nb, K]

    y0 = log.to_device(torch.as_tensor(y0, dtype=dtype),
                       dev).expand(x.shape[:-1])
    last = yw[..., -1]
    if nb <= 16:
        carries = [y0]
        for b in range(nb - 1):
            carries.append(last[..., b] + pk_t * carries[-1])
        c = torch.stack(carries, dim=-1)           # carry-in per block
    else:
        # long axes (noise walks, audio streams): the carry chain as the
        # JAX function's associative scan (zero init), then the y0 term
        post = carry_scan(
            log.to_device(torch.tensor(float(pk), dtype=dtype), dev), last)
        powers = log.to_device(torch.from_numpy(
            np.power(np.float64(pk), np.arange(nb)).astype(
                _dtype_name(dtype))), dev)
        prev = torch.cat([torch.zeros_like(post[..., :1]), post[..., :-1]],
                         dim=-1)
        c = prev + powers * y0[..., None]

    y = yw + d * c[..., None]
    y = y.reshape(x.shape[:-1] + (nb * block,))
    return y[..., :w]
