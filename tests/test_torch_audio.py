"""The port's audio chains on the CPU against the JAX package's, on the
same numpy inputs (tests/test_audio.py's `rand_audio`, seeded): the
log-depth carry scan of the blocked IIR's long axes, the hiss and buzz
streams, the VHS chain's stages and whole chain in test_audio.py's three
configurations, chunked against whole, the cassette chain with every
preset, the scalar reference, and a stream continued from JAX's state.

Tolerances:
- scan carries: exact against `jax.lax.associative_scan`;
- long-axis IIR: within 4 ULPs of max|x| of the JAX function's output
  (float32 block products sum in another order);
- int16 outputs, port against JAX, in float32 and float64:
  `assert_chain_equal` (at most 1 LSB on at most 0.1% of samples, the
  bound JAX holds its own chunked float32 output to); float stage outputs
  within 2^-15 (one int16 LSB of full scale); each case prints whether it
  was exact;
- hiss words and buzz counts: exact.
"""

import math

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax
import jax.numpy as jnp

import golden.ref_scalar as ref
from cvsim_tpu.audio import cassette as jcassette
from cvsim_tpu.audio import chains as jchains
from cvsim_tpu.config import AudioConfig as JAudioConfig
from cvsim_tpu.ops import blocked_iir as jblocked
from cvsim_tpu.ops import noise as jnoise
from cvsim_tpu_torch import interop
from cvsim_tpu_torch.audio import cassette, chains
from cvsim_tpu_torch.config import AudioConfig
from cvsim_tpu_torch.ops import blocked_iir, noise
from cvsim_tpu_torch.testing import assert_chain_equal, chain_diff
from tests.test_audio import assert_close_lsb, rand_audio

DTYPES = {"float32": (torch.float32, jnp.float32),
          "float64": (torch.float64, jnp.float64)}
LSB = 2.0 ** -15

# test_audio.py's three configurations (hiss off, so the scalar reference
# applies), as (kwargs, channels, scalar-reference kwargs)
CONFIGS = {
    "hifi-stereo": (dict(hiss_db=-1000.0), dict(
        preemph=True, deemph=True, pre_cut=16000.0, vhs_hifi=True)),
    "linear-mono-buzz-boost": (dict(
        hiss_db=-1000.0, vhs_hifi=False, channels=1, lowpass_hz=4000.0,
        highpass_hz=100.0, preemphasis_cut_hz=8000.0,
        emulating_preemphasis=False, emulating_deemphasis=False), dict(
        preemph=False, deemph=False, pre_cut=8000.0, vhs_hifi=False,
        buzz_db=-42.0, high_boost=0.25)),
    "linear-pal-48k": (dict(
        hiss_db=-1000.0, vhs_hifi=False, ntsc=False, channels=2, rate=48000,
        lowpass_hz=10000.0, highpass_hz=100.0, preemphasis_cut_hz=8000.0),
        dict(preemph=True, deemph=True, pre_cut=8000.0, vhs_hifi=False,
             buzz_db=-42.0, high_boost=0.25, ntsc=False)),
}


def _configs(name):
    kw = CONFIGS[name][0]
    return AudioConfig(**kw), JAudioConfig(**kw)


def _report(name, got, want):
    dmax, frac = chain_diff(got, want)
    print(f"{name}: {'exact' if dmax == 0 else f'max {dmax} LSB on {frac:.2e}'}")
    assert_chain_equal(got, want, err_msg=name)


def _assert_float_close(name, got, want, tol=LSB):
    d = float(np.abs(np.asarray(got, np.float64)
                     - np.asarray(want, np.float64)).max())
    print(f"{name}: max |diff| {d:.3e}")
    assert d <= tol, f"{name}: max |diff| {d} > {tol}"


# ---------------------------------------------------------------- the scan

def _comb(lhs, rhs):
    a_l, b_l = lhs
    a_r, b_r = rhs
    return a_r * a_l, a_r * b_l + b_r


@pytest.mark.parametrize("nb,dtype", [
    (nb, dt) for nb in (17, 33, 1000) for dt in DTYPES]
    + [(8192, "float32")])
def test_carry_scan_matches_associative_scan(nb, dtype):
    """Each JAX level compiles its eager ops once a shape: 8,192 blocks
    (a 1M-sample chunk) run in the card's dtype only."""
    np_dt = np.dtype(dtype)
    rng = np.random.default_rng(nb)
    # two rows, as the long-axis IIR's carries below
    b = rng.normal(0, 1000, (2, nb)).astype(np_dt)
    pk = np_dt.type(0.93)
    _, want = jax.lax.associative_scan(
        _comb, (jnp.full(b.shape, pk), jnp.asarray(b)), axis=-1)
    got = blocked_iir.carry_scan(torch.tensor(pk), torch.from_numpy(b))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("nb", [17, 1000])
def test_long_axis_iir_matches_jax(nb, dtype):
    """iir_lowpass_blocked past 16 blocks (the scan branch), a ragged last
    block and a carry-in per row."""
    np_dt = np.dtype(dtype)
    rng = np.random.default_rng(nb + 1)
    x = rng.normal(0, 20000, (2, nb * 128 - 5)).astype(np_dt)
    y0 = np.array([0.25, -5000.0], np_dt)
    want = np.asarray(jblocked.iir_lowpass_blocked(
        jnp.asarray(x), 0.2, jnp.asarray(y0)))
    got = blocked_iir.iir_lowpass_blocked(torch.from_numpy(x), 0.2,
                                          torch.from_numpy(y0)).numpy()
    _assert_float_close(f"iir nb={nb} {dtype}", got, want,
                        4 * np.finfo(np_dt).eps * np.abs(x).max())


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def test_long_axis_dispatch_count():
    """No Python loop over blocks: at nb = 8,192 (a 1M-sample chunk) the
    long branch dispatches at most 64*ceil(log2 nb) aten ops."""
    counts = {}
    for nb in (1024, 8192):
        x = torch.zeros(2, nb * 128)
        with _CountOps() as c:
            blocked_iir.iir_lowpass_blocked(x, 0.1, torch.zeros(2))
        counts[nb] = c.n
    print(counts)
    assert counts[8192] <= 64 * math.ceil(math.log2(8192))
    assert counts[8192] - counts[1024] <= 3 * 64


# ------------------------------------------------------- hiss and buzz

@pytest.mark.parametrize("start,c", [
    (0, 2), (123_457, 1), (2 ** 31 - 3, 2), (2 ** 32 // 3 - 2, 3),
    (2 ** 32 - 5, 2)])
def test_hiss_words_equal_jax(start, c):
    """Hiss is a pure function of (seed, start + t, channel): exact, also
    where (start + t)*c wraps past 2^32 (u32 math in int64)."""
    n, level, seed = 40, 1581, 11
    want = np.asarray(jnoise.hiss_per_sample(
        jax.random.PRNGKey(seed), start, n, c, level, jnp.float64))
    got = noise.hiss_per_sample(interop.key32_from_seed(seed), start, n, c,
                                level, torch.float64).numpy()
    np.testing.assert_array_equal(got, want)
    got_t = noise.hiss_per_sample(interop.key32_from_seed(seed),
                                  torch.tensor(start), n, c, level,
                                  torch.float32).numpy()
    np.testing.assert_array_equal(got_t, want.astype(np.float32))


@pytest.mark.parametrize("ntsc,start", [(True, 0), (True, 10 ** 9 + 7),
                                        (False, 0), (False, 123_456)])
def test_buzz_pulse_counts_equal_jax(ntsc, start):
    kw = dict(ntsc=ntsc, rate=44100 if ntsc else 48000)
    got = chains.buzz_pulse_counts(AudioConfig(**kw), start, 5000)
    want = jchains.buzz_pulse_counts(JAudioConfig(**kw), start, 5000)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------- the VHS chain

def _registers(cfg, np_dt, seed):
    rng = np.random.default_rng(seed)
    c, p = cfg.channels, cfg.bandpass_passes
    return (rng.normal(0, 0.05, (c, p)).astype(np_dt),
            rng.normal(0, 0.05, (c, p)).astype(np_dt),
            rng.normal(0, 0.05, c).astype(np_dt))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", list(CONFIGS))
def test_bandpass_bank_matches_jax(name, dtype):
    cfg, _ = _configs(name)
    np_dt = np.dtype(dtype)
    s = (rand_audio(3000, cfg.channels, seed=4) / 32768.0).astype(np_dt)
    lo, hi, _ = _registers(cfg, np_dt, 5)
    args = (cfg.lowpass_hz, cfg.highpass_hz)
    alphas = [chains.iir_alpha(cfg.rate, hz) for hz in args]
    want = jchains._bandpass_bank(jnp.asarray(s), jnp.asarray(lo),
                                  jnp.asarray(hi), *alphas, 6)
    got = chains._bandpass_bank(torch.from_numpy(s), torch.from_numpy(lo),
                                torch.from_numpy(hi), *alphas, 6)
    for part, g, w in zip(("out", "lo", "hi"), got, want):
        _assert_float_close(f"bank {name} {dtype} {part}", g.numpy(),
                            np.asarray(w))


@pytest.mark.parametrize("kind", ["preemph", "deemph"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", ["hifi-stereo", "linear-pal-48k"])
def test_interleaved_stage_matches_jax(name, dtype, kind):
    """Each pass filters the flattened [N*C] stream (the reference's
    quirk): 6,000 samples, the long-axis branch."""
    cfg, _ = _configs(name)
    np_dt = np.dtype(dtype)
    s = (rand_audio(3000, 2, seed=6) / 32768.0).astype(np_dt)
    alpha = chains.iir_alpha(cfg.rate, cfg.preemphasis_cut_hz)
    y0 = np_dt.type(0.125)
    out_j, reg_j = jchains._interleaved_stage(jnp.asarray(s), alpha,
                                              jnp.asarray(y0), kind)
    out_t, reg_t = chains._interleaved_stage(torch.from_numpy(s), alpha,
                                             torch.tensor(y0), kind)
    _assert_float_close(f"{kind} {name} {dtype}", out_t.numpy(),
                        np.asarray(out_j))
    _assert_float_close(f"{kind} register", reg_t.numpy(), np.asarray(reg_j))


def _run_port(cfg, audio, dtype, state=None, key=0, start=0):
    if state is None:
        state = chains.init_audio_state(cfg, dtype)
    pulses = (None if cfg.vhs_hifi
              else chains.buzz_pulse_counts(cfg, start, len(audio)))
    out, state = chains.composite_audio_process(
        torch.from_numpy(np.asarray(audio, np.int32)), state,
        interop.key32_from_seed(key), cfg=cfg, pulses=pulses, dtype=dtype)
    return out.numpy(), state


def _run_jax(cfg, audio, dtype, state=None, key=0, start=0):
    if state is None:
        state = jchains.init_audio_state(cfg, dtype)
    pulses = (None if cfg.vhs_hifi
              else jchains.buzz_pulse_counts(cfg, start, len(audio)))
    out, state = jchains.composite_audio_process(
        jnp.asarray(audio, jnp.int32), state, jax.random.PRNGKey(key),
        cfg=cfg, pulses=pulses, dtype=dtype)
    return np.asarray(out), state


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", list(CONFIGS))
def test_composite_audio_process_matches_jax(name, dtype):
    """The whole chain, with its registers, against JAX; hiss on."""
    kw = dict(CONFIGS[name][0], hiss_db=-40.0)
    cfg, cfg_j = AudioConfig(**kw), JAudioConfig(**kw)
    audio = rand_audio(3000, cfg.channels, seed=1)
    got, st = _run_port(cfg, audio, DTYPES[dtype][0], key=3)
    want, st_j = _run_jax(cfg_j, audio, DTYPES[dtype][1], key=3)
    _report(f"chain {name} {dtype}", got, want)
    for field in ("bank_lo", "bank_hi", "pre", "boost", "post"):
        _assert_float_close(field, getattr(st, field).numpy(),
                            np.asarray(getattr(st_j, field)))
    assert st.sample_count == int(st_j.sample_count) == 3000


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", list(CONFIGS))
def test_matches_scalar_reference(name, dtype):
    """The port against golden.ref_scalar's loop, with test_audio.py's own
    bound (assert_close_lsb: 2 LSB on at most 1%)."""
    cfg, _ = _configs(name)
    audio = rand_audio(3000, cfg.channels, seed=2)
    got, _ = _run_port(cfg, audio, DTYPES[dtype][0])
    want = ref.audio_chain_scalar(audio, cfg.rate, cfg.channels,
                                  cfg.lowpass_hz, cfg.highpass_hz,
                                  **CONFIGS[name][1])
    assert_close_lsb(got, want)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_chunked_equals_whole_with_hiss(dtype):
    """One hiss key for the stream and a carried state: chunks equal the
    whole stream (float64 exact; float32 within the chain tolerance, as
    JAX's own), and both equal JAX's whole stream."""
    cfg_kw = dict(hiss_db=-40.0, vhs_hifi=False, channels=2)
    cfg, cfg_j = AudioConfig(**cfg_kw), JAudioConfig(**cfg_kw)
    audio = np.random.default_rng(7).integers(-20000, 20000, (3000, 2))
    t_dt, j_dt = DTYPES[dtype]
    whole, _ = _run_port(cfg, audio, t_dt, key=11)
    state, outs, pos = None, [], 0
    for size in (1000, 37, 1200, 763):
        out, state = _run_port(cfg, audio[pos:pos + size], t_dt, state,
                               key=11, start=pos)
        outs.append(out)
        pos += size
    chunked = np.concatenate(outs)
    if dtype == "float64":
        np.testing.assert_array_equal(chunked, whole)
    _report(f"chunked vs whole {dtype}", chunked, whole)
    _report(f"whole vs JAX {dtype}", whole,
            _run_jax(cfg_j, audio, j_dt, key=11)[0])


# ----------------------------------------------------------- cassette

CASSETTE_CASES = {f"preset{p}": (dict(jcassette.CASSETTE_PRESETS[p]),
                                 "float32") for p in range(5)}
CASSETTE_CASES["preset2-mono"] = (dict(jcassette.CASSETTE_PRESETS[2],
                                       mono_downmix=True), "float32")
CASSETTE_CASES["preset0-float64"] = (dict(jcassette.CASSETTE_PRESETS[0]),
                                     "float64")


def _cassette_run(kw, audio, dtype, port_state=None, jax_state=None):
    cfg_t, cfg_j = (cassette.CassetteConfig(**kw),
                    jcassette.CassetteConfig(**kw))
    t_dt, j_dt = DTYPES[dtype]
    if port_state is None:
        port_state = cassette.init_cassette_state(cfg_t, t_dt)
    if jax_state is None:
        jax_state = jcassette.init_cassette_state(cfg_j, j_dt)
    got, st = cassette.cassette_audio_process(
        torch.from_numpy(np.asarray(audio, np.int32)), port_state,
        interop.key32_from_seed(0), cfg=cfg_t, dtype=t_dt)
    want, st_j = jcassette.cassette_audio_process(
        jnp.asarray(audio, jnp.int32), jax_state, jax.random.PRNGKey(0),
        cfg=cfg_j, dtype=j_dt)
    return got.numpy(), st, np.asarray(want), st_j


@pytest.mark.parametrize("case", list(CASSETTE_CASES))
def test_cassette_matches_jax(case):
    """Every preset (kernel lengths 18 to 57), -mono, hiss at the default
    -72 dB (level 1). The head kernels' sin rounds differently in the two
    frameworks: the chain tolerance covers it."""
    kw, dtype = CASSETTE_CASES[case]
    got, st, want, st_j = _cassette_run(kw, rand_audio(3000, 2, seed=7),
                                        dtype)
    _report(f"cassette {case}", got, want)
    if kw.get("mono_downmix"):
        np.testing.assert_array_equal(got[:, 0], got[:, 1])
    _assert_float_close("history", st.history.numpy(),
                        np.asarray(st_j.history))


def test_cassette_matches_scalar_reference():
    kw = dict(hiss_db=-1000.0, head_tilt=3.5, head_tilt_waver=0.55,
              lowpass_hz=16000.0, highpass_hz=100.0)
    cfg = cassette.CassetteConfig(**kw)
    audio = rand_audio(3000, 2, seed=7)
    got, _ = cassette.cassette_audio_process(
        torch.from_numpy(audio.astype(np.int32)),
        cassette.init_cassette_state(cfg, torch.float64), 0, cfg=cfg,
        dtype=torch.float64)
    want = ref.cassette_chain_scalar(
        audio, cfg.rate, 2, cfg.lowpass_hz, cfg.highpass_hz,
        head_tilt=cfg.head_tilt, head_tilt_waver=cfg.head_tilt_waver,
        pre_cut=cfg.preemphasis_cut_hz)
    assert_close_lsb(got.numpy(), want)


# --------------------------------------------- state carried across

@pytest.mark.parametrize("chain", ["vhs", "cassette"])
def test_second_chunk_from_jax_state(chain):
    """JAX runs the first chunk; the port continues from JAX's carried
    state (interop.*_state_from_reference) and matches JAX's second
    chunk."""
    audio = rand_audio(6000, 2, seed=9)
    first, second = audio[:3000], audio[3000:]
    if chain == "vhs":
        kw = dict(hiss_db=-40.0, vhs_hifi=False)
        cfg, cfg_j = AudioConfig(**kw), JAudioConfig(**kw)
        _, st_j = _run_jax(cfg_j, first, jnp.float32, key=5)
        want, _ = _run_jax(cfg_j, second, jnp.float32, st_j, key=5,
                           start=3000)
        st = interop.audio_state_from_reference(jax.device_get(st_j),
                                                 "cpu")
        got, st2 = _run_port(cfg, second, torch.float32, st, key=5,
                             start=3000)
        assert int(st2.sample_count) == 6000
    else:
        kw = dict(jcassette.CASSETTE_PRESETS[2], hiss_db=-50.0)
        _, _, _, st_j = _cassette_run(kw, first, "float32")
        st = interop.cassette_state_from_reference(
            jax.device_get(st_j), "cpu")
        assert st.history.shape == (cassette.CassetteConfig(**kw).kernel_len
                                    - 1, 2)
        got, _, want, _ = _cassette_run(kw, second, "float32", st, st_j)
    _report(f"{chain} second chunk from JAX's state", got, want)
