"""The sibling tools' noise, host-numpy maps and device twins of the port
against the JAX package, on the same numpy inputs: the twins of
tests/test_tools_np.py and tests/test_restore.py.

- The splitmix32 words of ops/noise_np.py and `noise.randint_stream`
  (torch) against JAX's noise and noise_np, exact.
- Every function of the port's models/tools_np.py and the numpy half of
  models/restore.py against the JAX package's, exact.
- Every device twin (`device="cpu"`) against JAX's jitted function,
  exact, on random int32 frames: posterize, colormap_apply,
  colorkey_apply over the xdivr x noisekey x fade x invert grid,
  average_delay_blend, frameblend_mix, filmac_measure and
  filmac_rescale, vhsled_dejitter (with shifts up to w//2), and the
  batched forms against JAX frame by frame.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cvsim_tpu.models import restore as jrestore
from cvsim_tpu.models import tools as jtools
from cvsim_tpu.models import tools_np as jtools_np
from cvsim_tpu.ops import noise as jnoise
from cvsim_tpu.ops import noise_np as jnoise_np
from cvsim_tpu_torch.models import restore, tools, tools_np
from cvsim_tpu_torch.ops import noise, noise_np

RNG = np.random.default_rng(42)


def rand_rgb(h=32, w=48, b=None):
    shape = (h, w, 3) if b is None else (b, h, w, 3)
    return RNG.integers(0, 256, shape).astype(np.int32)


def same(got, want):
    got = got.numpy() if hasattr(got, "numpy") else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------------ noise

KEYS = [7, 0, 2**32 - 1, np.asarray(jax.random.PRNGKey(11))]


@pytest.mark.parametrize("key", KEYS, ids=["7", "0", "max", "prngkey"])
def test_noise_words_and_randint_stream_match_jax(key):
    idx = np.arange(256, dtype=np.uint32)
    want = np.asarray(jnoise._bits(jnoise._key32(jnp.asarray(
        key if np.ndim(key) else [key], jnp.uint32)), jnp.asarray(idx)))
    same(noise_np.bits(noise_np.stream_id(key), idx), want)
    assert noise_np.stream_id(key) == jnoise_np.stream_id(key)
    assert noise.stream_key32(key) == int(jnoise_np.stream_id(key))
    for shape, lo, hi in (((17, 23), 0, 20001), ((64,), -3, 4),
                          ((2, 5, 7), 10, 11)):
        j = np.asarray(jax.jit(lambda: jnoise.randint_stream(
            jnp.asarray(key if np.ndim(key) else [key], jnp.uint32),
            shape, lo, hi))())
        same(noise.randint_stream(key, shape, lo, hi, device="cpu"), j)
        same(noise_np.randint_stream(key, shape, lo, hi), j)


def test_field_stage_key_matches_jax():
    key = np.asarray(jax.random.PRNGKey(3))
    for fieldno in (0, 1, 97, 100000):
        for stage in (0, 1, 5):
            want = int(np.asarray(jnoise.field_stage_keys(
                key, jnp.asarray([fieldno]), stage))[0])
            assert int(noise_np.field_stage_key(key, fieldno, stage)) == want
            assert (int(noise_np.field_stage_key(0, fieldno, stage))
                    == int(jnoise_np.field_stage_key(0, fieldno, stage)))


# ------------------------------------------------------- host numpy twins

def test_tools_np_pixel_maps_match_jax():
    src, dst = rand_rgb(), rand_rgb()
    for thr in (1, 3, 7):
        same(tools_np.posterize(src, thr), jtools_np.posterize(src, thr))
    map_rgb = rand_rgb(9, 300)
    lut = tools_np.take_colormap(map_rgb)
    same(lut, jtools_np.take_colormap(map_rgb))
    same(tools_np.colormap_apply(src, lut),
         jtools_np.colormap_apply(src, lut))
    for field, newlevel, delay in [(0, 128, 1), (7, 64, 3), (100, 255, 2)]:
        kw = dict(newlevel=newlevel, delay=delay)
        same(tools_np.average_delay_blend(dst, src, field, **kw),
             jtools_np.average_delay_blend(dst, src, field, **kw))
    for xdivr, noisekey, fade, invert in COLORKEY_GRID[::5]:
        kw = dict(color=(120, 40, 200), threshhold=90, invert=invert,
                  noisekey=noisekey, fade=fade, xdivr=xdivr)
        same(tools_np.colorkey_apply(dst, src, 9, **kw),
             jtools_np.colorkey_apply(dst, src, 9, **kw))


def test_tools_np_restore_maps_match_jax():
    frames = rand_rgb(b=3)
    w16 = [(0, 0x8000), (1, 0x4000), (2, 0x4000)]
    gdec, genc = restore.gamma_tables(2.2)
    f = rand_rgb(130, 300)
    for dec, enc in [(None, None), (gdec, genc)]:
        same(tools_np.frameblend_mix(frames, w16, dec, enc),
             jtools_np.frameblend_mix(frames, w16, dec, enc))
        m = tools_np.filmac_measure(f, dec)
        assert m == jtools_np.filmac_measure(f, dec)
        st = restore.FilmacState()
        restore.filmac_update_levels(st, m[0], m[1])
        same(tools_np.filmac_rescale(f, st, m[2], dec, enc),
             jtools_np.filmac_rescale(f, st, m[2], dec, enc))
    g = jittery_frame(40, 120)
    same(tools_np.vhsled_dejitter(g), jtools_np.vhsled_dejitter(g))


@pytest.mark.parametrize("gamma", [1.8, 2.2, 2.5])
def test_gamma_tables_match_jax(gamma):
    for a, b in zip(restore.gamma_tables(gamma),
                    jrestore.gamma_tables(gamma)):
        assert a.dtype == b.dtype
        same(a, b)


WEIGHT_CASES = [
    ([0.0, 0.8, 1.6], 0.0, 1, False, False),
    ([5.0], 0.0, 1, False, False),
    ([0.0, 1.005], 0.0, 1, False, True),
    ([0.0, 1.005, 2.01], 1.0, 1, False, True),
    (list(np.arange(40) * 0.4), 7.0, 1, False, False),
    (list(np.arange(40) * 2.5), 30.0, 1, False, False),
    (list(np.arange(40) * 0.4), 5.0, 2, False, False),
    (list(np.arange(40) * 0.4), 5.0, 3, True, False),
    (list(np.arange(12) * 1.25), 3.3, 4, True, True),
]


@pytest.mark.parametrize("case", WEIGHT_CASES,
                         ids=[f"w{k}" for k in range(len(WEIGHT_CASES))])
def test_frameblend_weights_match_jax(case):
    frame_t, current, framealt, ffa, squelch = case
    assert (restore.frameblend_weights(frame_t, current, framealt, ffa,
                                       squelch)
            == jrestore.frameblend_weights(frame_t, current, framealt, ffa,
                                           squelch))


def test_filmac_level_iir_matches_jax():
    st, st_j = restore.FilmacState(), jrestore.FilmacState()
    levels = RNG.integers(0, 1 << 24, (40, 2))
    for mn, mx in levels:
        restore.filmac_update_levels(st, int(mn), int(mx))
        jrestore.filmac_update_levels(st_j, int(mn), int(mx))
        assert (st.init, st.minv, st.maxv) == (st_j.init, st_j.minv,
                                               st_j.maxv)


# --------------------------------------------------- device twins vs JAX

def test_posterize_and_colormap_match_jax():
    f = rand_rgb()
    for thr in (1, 3, 7, 8):
        same(tools.posterize(f, thr, device="cpu"),
             jax.jit(jtools.posterize, static_argnums=1)(f, thr))
    lut = RNG.integers(0, 256, (256, 3)).astype(np.int32)
    same(tools.colormap_apply(f, lut, device="cpu"),
         jax.jit(jtools.colormap_apply)(f, lut))
    fb = rand_rgb(b=3)
    same(tools.posterize(fb, 3, device="cpu"), jtools.posterize(fb, 3))
    same(tools.colormap_apply(fb, lut, device="cpu"),
         jtools.colormap_apply(fb, lut))


COLORKEY_GRID = list(itertools.product((1, 3, 4), (0, 3000, 19000),
                                       (0, 64), (False, True)))


@pytest.mark.parametrize("xdivr,noisekey,fade,invert", COLORKEY_GRID)
def test_colorkey_matches_jax(xdivr, noisekey, fade, invert):
    src, dst = rand_rgb(), rand_rgb()       # w = 48: 3 and 4 both divide;
    src_odd, dst_odd = rand_rgb(w=47), rand_rgb(w=47)   # the pad path
    kw = dict(color=(120, 40, 200), threshhold=90, invert=invert,
              noisekey=noisekey, fade=fade, xdivr=xdivr)
    key = np.asarray(jax.random.PRNGKey(9))
    fn = jax.jit(lambda d, s: jtools.colorkey_apply(d, s, key, **kw))
    for d, s in ((dst, src), (dst_odd, src_odd)):
        same(tools.colorkey_apply(d, s, key, device="cpu", **kw), fn(d, s))
    # a batch keys one stream over its whole decision array, as JAX does
    db, sb = rand_rgb(b=2), rand_rgb(b=2)
    same(tools.colorkey_apply(db, sb, 77, device="cpu", **kw),
         jtools.colorkey_apply(db, sb, 77, **kw))


def test_average_delay_matches_jax():
    src, dst = rand_rgb(), rand_rgb()
    for field, newlevel, delay in [(0, 128, 1), (7, 64, 3), (100, 255, 2),
                                   (13, 0, 5)]:
        fn = jax.jit(lambda d, s: jtools.average_delay_blend(
            d, s, field, newlevel=newlevel, delay=delay))
        same(tools.average_delay_blend(dst, src, field, newlevel=newlevel,
                                       delay=delay, device="cpu"),
             fn(dst, src))
    # a batch, one field number a frame
    db, sb = rand_rgb(b=3), rand_rgb(b=3)
    got = tools.average_delay_blend(db, sb, [4, 5, 6], newlevel=100,
                                    delay=2, device="cpu")
    for k, field in enumerate((4, 5, 6)):
        same(got[k], jtools.average_delay_blend(db[k], sb[k], field,
                                                newlevel=100, delay=2))


def test_frameblend_mix_matches_jax():
    frames = rand_rgb(b=4)
    gdec, genc = restore.gamma_tables(2.2)
    for w16 in ([(0, 0x8000), (1, 0x4000), (2, 0x4000)],
                [(0, 0x10000)], [(0, 0x5555), (1, 0x5555), (2, 0x5556),
                                 (3, 0)]):
        used = frames[:len(w16)]
        for dec, enc in [(None, None), (gdec, genc)]:
            fn = jax.jit(lambda fr: jrestore.frameblend_mix(fr, w16, dec,
                                                            enc))
            want = fn(used)
            same(restore.frameblend_mix(used, w16, dec, enc, device="cpu"),
                 want)
            same(restore.frameblend_mix(list(used), w16, dec, enc,
                                        device="cpu"), want)


@pytest.mark.parametrize("h,w", [(130, 300), (16, 720), (300, 140)])
def test_filmac_matches_jax(h, w):
    f = rand_rgb(h, w)
    gdec, genc = restore.gamma_tables(2.2)
    for dec, enc in [(None, None), (gdec, genc)]:
        m = restore.filmac_measure(f, dec, device="cpu")
        assert m == jrestore.filmac_measure(f, dec)
        st = restore.FilmacState()
        restore.filmac_update_levels(st, m[0], m[1])
        fn = jax.jit(lambda x: jrestore.filmac_rescale(x, st, m[2], dec,
                                                       enc))
        same(restore.filmac_rescale(f, st, m[2], dec, enc, device="cpu"),
             fn(f))
    # a batch: one measurement a frame, from one reduction
    fb = rand_rgb(h, w, b=3)
    fb[1] //= 3
    assert (restore.filmac_measure(fb, gdec, device="cpu")
            == [jrestore.filmac_measure(x, gdec) for x in fb])


def test_filmac_measure_sees_past_maxx_like_jax():
    """tests/test_restore.py's highlight past maxx (column 700 of 720,
    inside the last block) and left of minx (column 50, outside)."""
    rgb = np.full((16, 720, 3), 120, np.int64)
    for col in (700, 50):
        lit = rgb.copy()
        lit[4, col] = 255
        assert (restore.filmac_measure(lit, device="cpu")
                == jrestore.filmac_measure(lit))


def jittery_frame(h, w, lo=8, span=4, seed=0):
    """A black left margin that varies by row, then bright content."""
    rng = np.random.default_rng(seed)
    f = np.zeros((h, w, 3), np.int32)
    margins = (lo + span * np.sin(np.arange(h) / 3)).astype(int)
    for y in range(h):
        f[y, margins[y]:] = rng.integers(64, 256, (w - margins[y], 3))
    return f


def test_vhsled_matches_jax():
    vh = jax.jit(jrestore.vhsled_dejitter)
    frames = [jittery_frame(40, 120),
              # margins 24..33 at w = 64: shifts reach w//2 = 32, where
              # the reference leaves the row alone
              jittery_frame(48, 64, lo=28, span=5, seed=1),
              rand_rgb(48, 64)]
    blue = np.zeros((16, 64, 3), np.int32)
    blue[:, 0, 2] = 240          # the ARGB-blue quirk: nothing shifts
    blue[:, 10:, :] = 200
    frames.append(blue)
    for f in frames:
        same(restore.vhsled_dejitter(f, device="cpu"), vh(f))
    shifts = jittery_frame(48, 64, lo=28, span=5, seed=1)
    out = restore.vhsled_dejitter(shifts, device="cpu").numpy()
    assert (out == shifts).all(axis=(1, 2)).any()     # some rows kept
    assert not (out == shifts).all()                  # some shifted
    batch = np.stack(frames[1:3])
    got = restore.vhsled_dejitter(batch, device="cpu")
    for k in range(2):
        same(got[k], vh(batch[k]))
