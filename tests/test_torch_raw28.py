"""The port's raw composite decoder (cvsim_tpu_torch.models.raw28 and the
`raw28ntsc` CLI) against the JAX package's, on the CPU, with inputs made
from numpy seeds and tests/test_raw28.py's synthetic captures.

- Twins of tests/test_raw28.py's tests, run on the port.
- decode_lines equal to JAX's (luma, chroma, carry) for every flag
  combination, with and without an incoming carry; tail_chain_reference
  (the raw28_tails kernel's plain version) equal to the carried end of
  JAX's lax.scan over the lines.
- Raw28Decoder field by field equal to JAX's (sync, -nosig, mark_sync),
  and a stream continued from a JAX decoder's state
  (interop.raw28_state_from_reference).
- decode_color_lines' u/v within float32 rounding of JAX's: the burst
  means are reductions in another order.
- The CLI's Y4M bytes equal to the JAX CLI's in every mode, on the clean
  captures and on testing.raw28_capture_jittery; with -color the chroma
  planes within 1 LSB on at most 0.1% of samples.

The JAX decoder takes about 0.3 s a field on a CPU, so its runs are shared
through module-scoped fixtures.
"""

import itertools
import subprocess

import numpy as np
import pytest
import torch

from cvsim_tpu.cli.main import main as jax_main
from cvsim_tpu.models import raw28 as jraw28
from cvsim_tpu_torch import interop, native
from cvsim_tpu_torch.cli.main import main
from cvsim_tpu_torch.models import raw28
from cvsim_tpu_torch.models.raw28 import (AGCState, Raw28Decoder, RawTiming,
                                          decode_color_lines, decode_lines,
                                          hunt_vsync, hunt_vsync_numpy,
                                          rate_preset, runs_below,
                                          tail_chain_reference, walk_lines,
                                          walk_lines_numpy)
from cvsim_tpu_torch.native import HsyncDcTracker
from cvsim_tpu_torch.testing import (assert_chain_equal, launches,
                                     raw28_capture, raw28_capture_jittery)
from cvsim_tpu_torch.utils import log
from tests.test_cli import read_all
from tests.test_raw28 import (BLANK, RL, synth_capture,
                              synth_color_capture)

RATE = rate_preset("ntsc28")
T = RawTiming(RATE)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU ops here are many and small: with the test workers
    sharing the cores, torch's intra-op threads oversubscribe them and
    spin (an 8x480 CLI run went from 1 s to minutes); one thread runs
    the same ops, with the same results."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _fields(decoder, capture):
    decoder.feed(capture)
    out = []
    while True:
        f = decoder.decode_field()
        if f is None:
            return out
        out.append(f)


# ------------------------------------------- twins of tests/test_raw28.py

def test_runs_below():
    dc = np.array([100, 5, 5, 100, 100, 3, 3, 3, 100], np.uint8)
    s, e = runs_below(dc, 24)
    np.testing.assert_array_equal(s, [1, 5])
    np.testing.assert_array_equal(e, [3, 8])


def test_tracker_native_matches_python():
    sig = synth_capture(1)[: RL * 40]
    t1 = HsyncDcTracker(RATE, T.one_scanline_time, T.one_frame_time)
    assert t1._native is not None, "libhostio did not build"
    r1, d1 = t1.process(sig)

    t2 = HsyncDcTracker(RATE, T.one_scanline_time, T.one_frame_time)
    t2._native = None
    t2._init_python()
    r2, d2 = t2.process(sig[: RL * 4])  # python path is slow; small slice
    np.testing.assert_array_equal(r1[: RL * 4], r2)
    diff = np.abs(d1[: RL * 4].astype(int) - d2.astype(int))
    assert diff.max() <= 1


def test_tracker_build_failure_raises(tmp_path, monkeypatch):
    """A libhostio build that fails raises: only a missing g++ sends the
    tracker to its numpy twin."""
    bad = tmp_path / "hostio.cpp"
    bad.write_text("not C++\n")
    monkeypatch.setattr(native, "_IO_SRC", str(bad))
    monkeypatch.setattr(native, "_IO_LIB", str(tmp_path / "libhostio.so"))
    monkeypatch.setattr(native, "_io_lib", None)
    with pytest.raises(subprocess.CalledProcessError):
        HsyncDcTracker(RATE, T.one_scanline_time, T.one_frame_time)


def test_tracker_without_gpp_warns_and_runs_numpy(tmp_path, monkeypatch,
                                                  capsys):
    sig = synth_capture(1)[: RL * 4]
    r1, d1 = HsyncDcTracker(RATE, T.one_scanline_time,
                            T.one_frame_time).process(sig)
    monkeypatch.setattr(native, "_IO_LIB", str(tmp_path / "libhostio.so"))
    monkeypatch.setattr(native, "_io_lib", None)
    monkeypatch.setenv("PATH", str(tmp_path))    # no g++ on it
    tr = HsyncDcTracker(RATE, T.one_scanline_time, T.one_frame_time)
    assert tr._native is None
    assert "g++ not found" in capsys.readouterr().err
    r2, d2 = tr.process(sig)
    np.testing.assert_array_equal(r1, r2)
    assert np.abs(d1.astype(int) - d2.astype(int)).max() <= 1


# ------------------------------- the native sync scan against its twins

def _tracked(capture: np.ndarray):
    """(raw, dc) of the native DC tracker over a capture."""
    return HsyncDcTracker(RATE, T.one_scanline_time,
                          T.one_frame_time).process(capture)


def _pulses(n: int, pulses, level: int = 60):
    """(raw, dc) of n samples: dc at `level` but for sync-tip runs of
    (start, length); raw seeded noise."""
    dc = np.full(n, level, np.uint8)
    for s, length in pulses:
        dc[s:s + length] = 5
    raw = np.random.default_rng(n).integers(0, 256, n).astype(np.uint8)
    return raw, dc


HS = int(RL * 0.09)    # the captures' hsync pulse


def _sync_case(name: str):
    """(raw, dc, walk starts) of each case of the sync scan; a walk start
    None is the hunt's lock."""
    if name.startswith("jittery-"):
        raw, dc = _tracked(raw28_capture_jittery(2, RL, int(name[8:])))
        return raw, dc, [None]
    if name == "clean":
        raw, dc = _tracked(raw28_capture(2, RL))
        return raw, dc, [None]
    if name == "pulse-cut-at-the-end":
        # ten lines, more than 4H without sync, then a pulse cut off by
        # the buffer's end: the numpy re-lock widens to the buffer's tail
        n = 1000 + 14 * RL + 400
        return (*_pulses(n, [(1000 + k * RL - HS // 2, HS) for k in range(10)]
                         + [(n - 150, 150)]), [1000, 1000 + RL])
    if name == "window-cuts-a-pulse":
        # a pulse across the end of the numpy re-lock's first window
        # (0.1H + 4H from 0.1H before the paced position)
        return (*_pulses(1000 + 32 * RL,
                         [(1000 + k * RL - HS // 2, HS) for k in range(10)]
                         + [(1000 + 14 * RL - 60, HS)]
                         + [(1000 + k * RL - HS // 2, HS)
                            for k in range(15, 31)]), [1000])
    if name == "serration-counts":
        # 8 counted equalization pulses, each with one 300 samples after
        # it that is skipped, lines, then 9 counted pulses: the hunt locks
        # after the second group
        pulses, x = [], 1000
        for group in (8, 9):
            for _ in range(5):
                pulses.append((x - HS // 2, HS))
                x += RL
            for _ in range(group):
                pulses += [(x, 60)] + [(x + 300, 60)] * (group == 8)
                x += RL // 2
        pulses += [(x + k * RL - HS // 2, HS) for k in range(20)]
        return (*_pulses(x + 22 * RL, pulses), [None, 1000, 1000 + 3 * RL])
    raw, dc = _tracked(raw28_capture_jittery(2, RL, 11))
    lock = hunt_vsync_numpy(dc, raw, RL, AGCState())
    if name == "starts-in-a-pulse":
        # the buffer opens halfway into a serration pulse of the second
        # field; a walk's first re-lock opens at a pulse's centre
        s, e = runs_below(dc)
        k = int(np.argmax((s > lock + 200 * RL) & (e - s >= int(RL * 0.02))
                          & (e - s < int(RL * 0.06))))
        cut = (s[k] + e[k]) // 2
        assert dc[cut - 1] < 24 and dc[cut] < 24
        raw, dc = raw[cut:], dc[cut:]
        lock = hunt_vsync_numpy(dc, raw, RL, AGCState())
        centre = walk_lines_numpy(dc, lock, RL, 262).starts[40]
        assert dc[centre] < 24
        return raw, dc, [None, centre + int(RL * 0.1) - RL]
    if name == "dropout-over-4H":
        # no sync for 5 lines from line 60: the numpy re-lock widens
        dc = dc.copy()
        dc[lock + 60 * RL - RL // 2:lock + 65 * RL] = 60
        return raw, dc, [None]
    if name == "vsync-in-the-walk":
        # a walk that starts 150 lines into the field meets the next vsync
        return raw, dc, [lock + 150 * RL, lock + 255 * RL + RL // 2]
    if name == "no-lock":
        # hsync pulses and no vsync: no lock, and the walk runs to its end
        return (raw[lock + 20 * RL:lock + 200 * RL],
                dc[lock + 20 * RL:lock + 200 * RL], [None, 3 * RL])
    raise KeyError(name)


SYNC_CASES = ["jittery-3", "jittery-4", "jittery-2147483659", "clean",
              "starts-in-a-pulse", "dropout-over-4H", "vsync-in-the-walk",
              "pulse-cut-at-the-end", "window-cuts-a-pulse",
              "serration-counts", "no-lock"]
NO_LOCK = ("pulse-cut-at-the-end", "window-cuts-a-pulse", "no-lock")


@pytest.mark.parametrize("name", SYNC_CASES)
def test_native_sync_scan_equals_numpy_twins(name):
    """hunt_vsync and walk_lines (libhostio's scan) against
    hunt_vsync_numpy and walk_lines_numpy: the lock, the AGC levels, the
    line starts, the final position, hit_vsync and the re-locks, with
    sync and without; the native scan examines fewer samples."""
    assert native.hostio() is not None, "libhostio did not build"
    raw, dc, walk_from = _sync_case(name)
    got_agc, want_agc = AGCState(), AGCState()
    lock = hunt_vsync(dc, raw, RL, got_agc)
    assert lock == hunt_vsync_numpy(dc, raw, RL, want_agc)
    assert got_agc.blank_level == want_agc.blank_level
    assert got_agc.white_level == want_agc.white_level
    assert (lock is None) == (name in NO_LOCK)
    for pos in walk_from:
        pos = (lock or 0) if pos is None else pos
        for sync in (True, False):
            got = walk_lines(dc, pos, RL, 262, sync)
            want = walk_lines_numpy(dc, pos, RL, 262, sync)
            np.testing.assert_array_equal(got.starts, want.starts)
            assert got.starts.dtype == want.starts.dtype == np.int64
            assert got[1:4] == want[1:4], (pos, sync)
            assert got.read <= want.read
            assert len(got.starts) > 0
    if name == "vsync-in-the-walk":
        assert walk_lines(dc, walk_from[0], RL, 262).hit_vsync
        assert len(walk_lines(dc, walk_from[0], RL, 262).starts) < 120


def test_sync_twin_reads_what_it_encodes():
    """walk_lines_numpy's `read` is the samples of the windows
    relock_hsync encodes: 4.1 lines a re-lock on a clean capture."""
    raw, dc = _tracked(raw28_capture(2, RL))
    lock = hunt_vsync_numpy(dc, raw, RL, AGCState())
    walk = walk_lines_numpy(dc, lock, RL, 100)
    assert walk.relocks == 100
    assert walk.read == 100 * (int(RL * 0.1) + 4 * RL)


def test_sync_walk_without_gpp_warns_and_runs_numpy(tmp_path, monkeypatch,
                                                    capsys):
    """Without g++ the decoder's sync runs the numpy twins, says so on
    stderr, and decodes the same bytes; the tracker's outputs come from
    the native tracker in both, so that the case takes seconds."""
    raw, dc = _tracked(raw28_capture_jittery(3, RL, 6))

    def decode():
        dec = Raw28Decoder(RATE, width=(RL + 1) & ~1, height=262,
                           device="cpu")
        monkeypatch.setattr(dec.tracker, "process", lambda data: (raw, dc))
        read = log.snapshot()["counters"].get("raw28.sync_samples", 0)
        fields = _fields(dec, raw[:1])
        return (fields, dec.agc,
                log.snapshot()["counters"]["raw28.sync_samples"] - read)

    want, want_agc, native_read = decode()
    monkeypatch.setattr(native, "_IO_LIB", str(tmp_path / "libhostio.so"))
    monkeypatch.setattr(native, "_io_lib", None)
    monkeypatch.setenv("PATH", str(tmp_path))    # no g++ on it
    assert native.hostio() is None
    got, got_agc, twin_read = decode()
    assert "g++ not found" in capsys.readouterr().err
    assert len(got) == len(want) >= 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got_agc == want_agc
    assert twin_read > 10 * native_read


def test_decoder_locks_and_recovers_ramp():
    dec = Raw28Decoder(RATE, width=720, height=240, device="cpu")
    fields = _fields(dec, synth_capture(4))
    assert len(fields) >= 2
    f = fields[1]  # let AGC settle on the first field
    assert f.shape == (240, 720)
    active = f[100, 250:700].astype(int)
    assert active[-1] > active[0] + 60, (active[0], active[-1])
    assert abs(dec.agc.blank_level - BLANK) < 40
    assert dec.agc.white_level > 150


def test_decoder_nosync_mode():
    dec = Raw28Decoder(RATE, width=720, height=240, disable_sync=True,
                       device="cpu")
    dec.feed(synth_capture(2))
    f = dec.decode_field()
    assert f is not None and f.shape == (240, 720)


def test_vsync_hunt_on_synth():
    tr = HsyncDcTracker(RATE, T.one_scanline_time, T.one_frame_time)
    raw, dc = tr.process(synth_capture(1))
    lock = hunt_vsync(dc, raw, RL, AGCState())
    assert lock is not None
    assert lock < RL * 20


def test_color_decode_recovers_uv():
    u0, v0 = 20.0, -12.0
    dec = Raw28Decoder(RATE, width=720, height=240, decode_color=True,
                       device="cpu")
    results = _fields(dec, synth_color_capture(4, u0=u0, v0=v0))
    assert len(results) >= 2
    luma, (u, v) = results[1]
    scale = 255.0 / (dec.agc.white_level - dec.agc.blank_level)
    exp_u, exp_v = u0 * scale, v0 * scale
    mid_u, mid_v = u[100, 450:650].mean(), v[100, 450:650].mean()
    assert abs(mid_u - exp_u) < 0.3 * abs(exp_u) + 3, (mid_u, exp_u)
    assert abs(mid_v - exp_v) < 0.3 * abs(exp_v) + 3, (mid_v, exp_v)
    assert luma[100, 450:650].astype(int).std() < 6


def test_mark_sync_paints_pulses():
    dec = Raw28Decoder(RATE, width=720, height=240, mark_sync=True,
                       disable_sync=True, device="cpu")
    dec.feed(synth_capture(2))
    f = dec.decode_field()
    assert f is not None
    assert (f[:, :20] > 200).mean() > 0.5


def test_chroma_shift_head_keeps_preshift_values():
    rng = np.random.default_rng(7)
    x = np.arange(RL + 16)
    carrier = (60 * np.sin(2 * np.pi * x / 8)).astype(np.int32) + 128
    line = np.clip(carrier + rng.integers(-3, 4, RL + 16), 0, 255)
    _, chroma, _ = decode_lines(torch.from_numpy(line[None, :]), 0.0, 255.0,
                                raw_len=RL, equalize=False, full_chroma=True)
    ch = chroma.numpy()[0]
    assert np.abs(ch[:16]).max() > 0
    np.testing.assert_array_less(np.abs(ch[:16] - 4 * ch[16:32]), 4)


# ---------------------------------------------- decode_lines against JAX

FLAGS = ("equalize", "wp_equalize", "separate_chroma", "show_subcarrier",
         "full_chroma")
COMBOS = list(itertools.product([True, False], repeat=len(FLAGS)))


def _lines(seed: int, n: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (n, RL + 24)).astype(np.int32)


@pytest.mark.parametrize("combo", COMBOS, ids=[
    "-".join(f for f, on in zip(FLAGS, c) if on) or "none" for c in COMBOS])
def test_decode_lines_equals_jax(combo):
    kw = dict(zip(FLAGS, combo))
    x = _lines(sum(combo) + 11, 9)
    carry = np.random.default_rng(3).integers(-90, 90, 16).astype(np.int32)
    for incoming in (None, carry):
        want = jraw28.decode_lines(x, 23.5, 201.25, raw_len=RL, width=RL - 6,
                                   chroma_carry=incoming, **kw)
        got = decode_lines(torch.from_numpy(x), 23.5, 201.25, raw_len=RL,
                           width=RL - 6, chroma_carry=None if incoming is None
                           else torch.from_numpy(incoming), **kw)
        for name, g, w in zip(("luma", "chroma", "carry"), got, want):
            w = np.asarray(w)
            assert g.dtype == {np.uint8: torch.uint8,
                               np.int32: torch.int32}[w.dtype.type], name
            np.testing.assert_array_equal(g.numpy(), w, err_msg=name)


@pytest.mark.parametrize("n", [1, 6, 300])
def test_tail_chain_reference_equals_jax_scan(n):
    """The plain loop of the raw28_tails kernel on each line's c3 tail
    gives JAX's chroma and luma at columns L-12.. and its final carry;
    the wrapper runs it on a CPU tensor and counts no launch."""
    x = _lines(n, n)
    carry = np.random.default_rng(n).integers(-90, 90, 16).astype(np.int32)
    want_out, want_ch, want_carry = jraw28.decode_lines(
        x, 0.0, 255.0, raw_len=RL, equalize=False, full_chroma=True,
        width=RL, chroma_carry=carry)
    args = (*raw28.tail_inputs(*raw28.split_lines(torch.from_numpy(x), RL)),
            torch.from_numpy(carry))
    before = launches("raw28_tails")
    got = raw28.raw28_tails(*args)
    assert launches("raw28_tails") == before
    for g, p in zip(got, tail_chain_reference(*args)):
        assert torch.equal(g, p)
    ch, lu, cy = got
    np.testing.assert_array_equal(ch.numpy(), np.asarray(want_ch)[:, RL - 12:])
    luma = np.clip(lu.numpy(), 0, 255)
    np.testing.assert_array_equal(luma, np.asarray(want_out)[:, RL - 12:])
    np.testing.assert_array_equal(cy.numpy(), np.asarray(want_carry))


def test_decode_color_lines_within_float_rounding():
    """u, v and the burst amplitude against JAX's, on random chroma: the
    burst means are float32 reductions in another order, so the bound is
    a few float32 ULPs of the largest value, not equality."""
    rng = np.random.default_rng(5)
    chroma = rng.integers(-400, 400, (12, RL)).astype(np.int32)
    kw = dict(raw_len=RL, width=720, burst_start=int(RL * 0.045),
              burst_len=int(RL * 0.04), saturation=2.0)
    got = decode_color_lines(torch.from_numpy(chroma), **kw)
    want = jraw28.decode_color_lines(chroma, **kw)
    for name, g, w in zip(("u", "v", "bnorm"), got, want):
        w = np.asarray(w)
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        bound = 16 * np.finfo(np.float32).eps * np.abs(w).max()
        assert np.abs(g.numpy() - w).max() <= bound, name


# ------------------------------------------------ the decoder against JAX

MODES = {"sync": {}, "nosig": {"disable_sync": True},
         "mark_sync": {"mark_sync": True}}


@pytest.fixture(scope="module")
def jax_fields():
    """JAX's fields of synth_capture(4) at the CLI's geometry, per mode."""
    width = (RL + 1) & ~1
    return {mode: _fields(jraw28.Raw28Decoder(RATE, width=width, height=262,
                                              **kw), synth_capture(4))
            for mode, kw in MODES.items()}


@pytest.mark.parametrize("mode", list(MODES))
def test_decoder_equals_jax_field_by_field(jax_fields, mode):
    dec = Raw28Decoder(RATE, width=(RL + 1) & ~1, height=262, device="cpu",
                       **MODES[mode])
    got = _fields(dec, synth_capture(4))
    want = jax_fields[mode]
    assert len(got) == len(want) >= 3
    for k, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == np.uint8
        np.testing.assert_array_equal(g, w, err_msg=f"{mode} field {k}")


def test_stream_continued_from_jax_state():
    """A JAX decoder decodes one capture; a fresh JAX decoder given its
    AGC levels and chroma carry, and a port decoder given the same through
    interop.raw28_state_from_reference, decode the next one alike."""
    first = jraw28.Raw28Decoder(RATE, width=720, height=240)
    assert _fields(first, synth_capture(2))
    state = interop.raw28_state_from_reference(first, "cpu")
    assert state.chroma_tail is not None and state.chroma_tail.shape == (16,)
    assert state.agc == AGCState(first.agc.blank_level, first.agc.white_level)

    again = jraw28.Raw28Decoder(RATE, width=720, height=240)
    again.agc = jraw28.AGCState(first.agc.blank_level, first.agc.white_level)
    again._chroma_tail = first._chroma_tail
    port = Raw28Decoder(RATE, width=720, height=240, state=state,
                        device="cpu")
    nxt = raw28_capture(2, RL, color=True)
    want, got = _fields(again, nxt), _fields(port, nxt)
    assert len(got) == len(want) >= 1
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(port.state.chroma_tail.numpy(),
                                  np.asarray(again._chroma_tail))
    assert port.state.agc == AGCState(again.agc.blank_level,
                                      again.agc.white_level)


# ---------------------------------------------------- the CLI against JAX

CLI_MODES = {"plain": [], "nosig": ["-nosig"], "marksig": ["-marksig"],
             "showsc": ["-showsc"], "nosc": ["-nosc"], "noequ": ["-noequ"],
             "nowequ-420": ["-nowequ", "-420"], "color": ["-color"],
             "jittery": [], "jittery-color": ["-color"]}


@pytest.fixture(scope="module")
def captures(tmp_path_factory):
    d = tmp_path_factory.mktemp("raw28")
    paths = {"mono": str(d / "cap.raw"), "color": str(d / "color.raw"),
             "jittery": str(d / "jittery.raw")}
    synth_capture(3).tofile(paths["mono"])
    synth_color_capture(3).tofile(paths["color"])
    raw28_capture_jittery(3, RL).tofile(paths["jittery"])
    return d, paths


def test_jittery_capture_equals_crosscheck():
    """testing.raw28_capture_jittery is the reference cross-check's
    jittery capture (tests/test_ref_crosscheck.py)."""
    from tests.test_ref_crosscheck import _raw28_capture_jittery

    np.testing.assert_array_equal(raw28_capture_jittery(4, RL),
                                  _raw28_capture_jittery())


@pytest.mark.parametrize("mode", list(CLI_MODES))
def test_cli_bytes_equal_jax(captures, mode):
    """Clean captures in every mode, and the jittery capture (line-length
    jitter, DC drift, noise, a moving chroma ripple), plain and -color."""
    d, paths = captures
    src = paths["jittery" if mode.startswith("jittery") else
                "color" if mode == "color" else "mono"]
    outs = [str(d / f"{mode}-{who}.y4m") for who in ("jax", "port")]
    assert jax_main(["raw28ntsc", "-i", src, "-o", outs[0],
                     *CLI_MODES[mode]]) == 0
    assert main(["--device", "cpu", "raw28ntsc", "-i", src, "-o", outs[1],
                 *CLI_MODES[mode]]) == 0
    (hdr_j, want), (hdr, got) = read_all(outs[0]), read_all(outs[1])
    assert (hdr.width, hdr.height) == (hdr_j.width, hdr_j.height) == (
        (RL + 1) & ~1, 262)
    assert len(got) == len(want) >= 2
    if "-color" not in CLI_MODES[mode]:
        with open(outs[0], "rb") as a, open(outs[1], "rb") as b:
            assert a.read() == b.read()
        return
    for k, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g[0], w[0], err_msg=f"luma field {k}")
        for plane in (1, 2):
            assert_chain_equal(g[plane], w[plane],
                               err_msg=f"chroma plane {plane} field {k}")
