"""Software composite-video decoder ("software TV set"),
ffmpeg_raw28ntsc.cpp: the twin of cvsim_tpu.models.raw28.

The data-dependent control flow (sync-pulse classification, vsync
hunting, AGC calibration, per-line re-lock, fractional scanline pacing)
runs on the host over the DC-normalized detector signal. The per-sample
DC tracker is native.HsyncDcTracker; the vsync hunt (`hunt_vsync`) and
the line walk (`walk_lines`) scan the signal forward in libhostio
(native/hostio.cpp) and stop at the pulse they need. Their numpy twins,
the JAX package's code, run where g++ is missing: `hunt_vsync_numpy`,
and `walk_lines_numpy` with `relock_hsync` a line, over `runs_below`'s
run-length encoding. The AGC's updates stay in numpy
(`AGCState.update_from_pulse`) on both paths. The per-line DSP
(equalization and the 8x-fsc Y/C separation) runs on the device over a
[lines, samples] matrix gathered at the host's line starts:

- `decode_lines` computes every line's carry-free columns at once, then
  chains the last 28 columns of each line, which read the line before
  (the reference's static int_chroma[]), through `raw28_tails`: the
  kernel of csrc/raw28.cu on a CUDA tensor, its plain version
  `tail_chain_reference` (a per-line loop) on a CPU tensor.
- `decode_color_lines`: the burst-locked QAM colour decode.

While tracing is on (utils/log) a decoded field is the span
`raw28.field` (unit `field=<k>`) holding `raw28.hunt` (the vsync hunt and
its AGC updates), `raw28.lines` (the pacing and per-line re-lock) and
`raw28.decode` (the gather, the copy to the device, `decode_lines` and
the fetch); a call that finds no line after the lock closes as
`raw28.nofield` instead. Each `feed` is `raw28.feed`. The counter
`raw28.relock_scans` counts the line walk's re-locks (one a line),
`raw28.sync_samples` the detector samples the hunt and the walk
examine, and `h2d_bytes.raw28`, `d2h_bytes.raw28` and `syncs` the
field's copies.

Timing constants (compute_NTSC, :249-256): scanline = rate/(29.97*525);
8fsc = 315/88 MHz * 8 ~= 28.636 MHz, so the chroma subcarrier is exactly
8 samples per cycle, enabling Y/C separation by destructive interference
(:725-760).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from cvsim_tpu_torch import kernels, native
from cvsim_tpu_torch.ops.cmath import c_div, sqrt_rn
from cvsim_tpu_torch.utils import log

SYNC_THRESHOLD = int(192 * 0.25 * 0.5)  # :552

# columns of each line that depend on the previous line's chroma tail:
# the burst enhancement reads the tail at x >= L-12 and each of the 4
# denoise passes widens that by 4 columns
TAIL_COLS = 28
OUT_COLS = 12    # chroma/luma columns that read those: L-12..L-1
CARRY = 16       # the int32 chroma tail carried from line to line


@dataclasses.dataclass
class RawTiming:
    sample_rate: float

    @property
    def subcarrier_freq(self):
        return 315000000.0 / 88.0

    @property
    def one_frame_time(self):
        return self.sample_rate / (30000.0 / 1001.0)

    @property
    def one_scanline_time(self):
        return self.one_frame_time / 525.0

    @property
    def raw_length(self) -> int:
        return int(self.one_scanline_time + 0.5)


def rate_preset(name: str) -> float:
    if name == "ntsc28":
        return (315000000.0 * 8.0) / 88.0
    if name == "40mhz":
        return 40000000.0
    return float(name)


def runs_below(dc: np.ndarray, threshold: int = SYNC_THRESHOLD):
    """RLE of sync pulses: regions where the detector signal dips below the
    threshold. Returns (starts, ends) arrays."""
    below = dc < threshold
    d = np.diff(below.astype(np.int8))
    starts = np.where(d == 1)[0] + 1
    ends = np.where(d == -1)[0] + 1
    if below.size and below[0]:
        starts = np.concatenate([[0], starts])
    if below.size and below[-1]:
        ends = np.concatenate([ends, [below.size]])
    return starts, ends


@dataclasses.dataclass
class AGCState:
    blank_level: float = 0.0
    white_level: float = 192.0

    def update_from_pulse(self, raw: np.ndarray, dc: np.ndarray,
                          threshold: int = SYNC_THRESHOLD):
        """Black/white calibration from an equalization-pulse window
        (:660-694): mean raw level inside vs outside the pulse, 1/8 IIR."""
        inside = dc < threshold
        mind = int(inside.sum())
        maxd = int((~inside).sum())
        mina = int(raw[inside].sum()) // mind if mind else 0
        maxa = int(raw[~inside].sum()) // maxd if maxd else 0
        nwhite = min(max(int(maxa + (maxa - mina) / (0.25 + 0.125)), maxa + 1), 240)
        nblack = maxa
        a = 1.0 / 8.0
        self.white_level = self.white_level * (1 - a) + nwhite * a
        self.blank_level = self.blank_level * (1 - a) + nblack * a


def pulse_lengths(raw_len: int) -> tuple[int, int, int]:
    """The shortest vsync (0.3H), hsync (0.06H) and equalization (0.02H)
    pulses in samples, as hunt_vsync_numpy and relock_hsync compare."""
    return int(raw_len * 0.3), int(raw_len * 0.06), int(raw_len * 0.02)


def hunt_vsync(dc: np.ndarray, raw: np.ndarray, raw_len: int,
               agc: AGCState, threshold: int = SYNC_THRESHOLD):
    """hunt_vsync_numpy's lock and AGC updates from libhostio's forward
    scan, which stops at the lock; hunt_vsync_numpy itself where g++ is
    missing. Counts the samples examined as `raw28.sync_samples` (the
    twin encodes the whole buffer)."""
    lib = native.hostio()
    if lib is None:
        log.count("raw28.sync_samples", len(dc))
        return hunt_vsync_numpy(dc, raw, raw_len, agc, threshold)
    pulses = pulse_lengths(raw_len)
    lock, equal_starts, read = native.sync_hunt(lib, dc, threshold, pulses)
    for s in equal_starts:
        agc.update_from_pulse(raw[s:s + pulses[0]], dc[s:s + pulses[0]],
                              threshold)
    log.count("raw28.sync_samples", read)
    return lock


def hunt_vsync_numpy(dc: np.ndarray, raw: np.ndarray, raw_len: int,
                     agc: AGCState, threshold: int = SYNC_THRESHOLD):
    """Pulse-length classifier (:625-699): walk sync pulses; vsync >= 0.3H,
    hsync >= 0.06H, equalization >= 0.02H. After >= 9 serration pulses, lock
    on the next hsync pulse center. Returns the locked sample index or None.
    """
    starts, ends = runs_below(dc, threshold)
    vsb = 0
    skip_until = -1
    for s, e in zip(starts, ends):
        if s < skip_until:
            continue
        synclen = e - s
        if synclen >= int(raw_len * 0.3):
            vsb += 1
            skip_until = max(e, s + int(raw_len * 0.3))
        elif synclen >= int(raw_len * 0.06):
            if vsb >= 9:
                return s + synclen // 2
        elif synclen >= int(raw_len * 0.02):
            vsb += 1
            agc.update_from_pulse(raw[s:s + int(raw_len * 0.3)],
                                  dc[s:s + int(raw_len * 0.3)], threshold)
            skip_until = max(e, s + int(raw_len * 0.3))
    return None


def relock_hsync(dc: np.ndarray, pos: int, window_back: int, raw_len: int,
                 threshold: int = SYNC_THRESHOLD):
    """Per-line hsync re-lock (:793-833): look from pos-window for the next
    hsync-length pulse; returns (new_pos, hit_vsync). walk_lines_numpy's
    step, the twin of the re-lock in libhostio's line walk.

    The scan is bounded (the next pulse is ~one line ahead; the reference
    stops at the first hit) and widens only on a miss — a full-tail RLE per
    line made decode_field quadratic in the buffered sample count."""
    start = max(0, pos - window_back)
    win = window_back + 4 * raw_len
    while True:
        seg = dc[start:start + win]
        at_tail = start + win >= len(dc)
        starts, ends = runs_below(seg, threshold)
        vsb = 0
        skip_until = -1
        for s, e in zip(starts, ends):
            if e == len(seg) and not at_tail:
                break   # truncated pulse: re-evaluate in the wider window
            if s < skip_until:
                continue
            synclen = e - s
            if synclen >= int(raw_len * 0.3):
                vsb += 1
                skip_until = s + int(raw_len * 0.3)
            elif synclen >= int(raw_len * 0.06):
                return start + s + synclen // 2, False
            elif synclen >= int(raw_len * 0.02):
                vsb += 1
                skip_until = s + int(raw_len * 0.3)
            if vsb >= 9:
                return pos, True
        if at_tail:
            return pos, False
        win *= 2


class Walk(NamedTuple):
    """A field's line walk: the line starts (int64), the position after
    the last line, whether 9 counted pulses ended it, the re-locks and the
    detector samples examined."""
    starts: np.ndarray
    p: int
    hit_vsync: bool
    relocks: int
    read: int


def walk_lines(dc: np.ndarray, pos: int, raw_len: int, height: int,
               sync: bool = True) -> Walk:
    """Up to `height` line starts from pos (:785-833): each line paced by
    raw_len with the fractional error carried, and with sync re-locked on
    the next hsync pulse from 0.1H before the paced position; 9 counted
    pulses end the field. A line starts only where 2 * raw_len samples
    follow it. libhostio's walk, one call a field; walk_lines_numpy where
    g++ is missing. Counts `raw28.relock_scans` and `raw28.sync_samples`."""
    lib = native.hostio()
    if lib is None:
        walk = walk_lines_numpy(dc, pos, raw_len, height, sync)
    else:
        walk = Walk(*native.sync_walk_lines(
            lib, dc, pos, raw_len, height, sync, SYNC_THRESHOLD,
            pulse_lengths(raw_len), int(raw_len * 0.1)))
    log.count("raw28.relock_scans", walk.relocks)
    log.count("raw28.sync_samples", walk.read)
    return walk


class _Reads:
    """dc as relock_hsync reads it: its slices, and the samples they
    held."""

    def __init__(self, dc: np.ndarray):
        self.dc, self.n = dc, 0

    def __len__(self):
        return len(self.dc)

    def __getitem__(self, key):
        seg = self.dc[key]
        self.n += len(seg)
        return seg


def walk_lines_numpy(dc: np.ndarray, pos: int, raw_len: int, height: int,
                     sync: bool = True) -> Walk:
    """walk_lines' numpy twin: relock_hsync a line. `read` counts the
    samples of the windows relock_hsync encodes."""
    reads = _Reads(dc)
    width_f = float(raw_len)
    err = 0.0
    line_starts = []
    p = pos
    hit_vsync = False
    for y in range(height):
        if p + raw_len * 2 >= len(dc):
            break
        line_starts.append(p)
        adj = int(np.floor(width_f))
        err += width_f - adj
        if err >= 1.0:
            err -= 1.0
            adj += 1
        p += adj
        if sync:
            p, hit_vsync = relock_hsync(reads, p, int(raw_len * 0.1),
                                        raw_len)
            if hit_vsync:
                break
    return Walk(np.asarray(line_starts, np.int64), int(p), hit_vsync,
                len(line_starts) if sync else 0, reads.n)


# ------------------------------------------------------------- device-side

def _box8(a: torch.Tensor) -> torch.Tensor:
    """Centered 8-tap moving average over the last axis (one subcarrier
    cycle at 8x fsc) — cancels the carrier, keeps the baseband envelope.
    The taps are summed in the JAX package's order."""
    pad = F.pad(a, (4, 3))
    w = a.shape[-1]
    return sum(pad[..., k:k + w] for k in range(8)) * (1.0 / 8.0)


def decode_color_lines(chroma, *, raw_len: int, width: int,
                       burst_start: int, burst_len: int,
                       saturation: float = 2.0):
    """Burst-locked QAM color demodulation — an extension BEYOND the
    reference, whose color decode is unfinished (ffmpeg_raw28ntsc.cpp
    renders B/W; show_subcarrier at :767-768 is its only chroma output).

    At 8x fsc the subcarrier advances exactly 45 degrees per sample, so
    quadrature mixing is a static period-8 table. The colorburst window
    gives the per-line reference phase; chroma is mixed down, box-filtered
    over one cycle, and rotated into the burst frame. Returns (u, v) float32
    tensors [N, width] on chroma's device, scaled so the burst amplitude
    maps to the standard 40 IRE burst (saturation tweaks the overall gain),
    and the burst amplitude [N]. The burst means are reductions whose
    order differs from XLA's, so u and v agree with the JAX package to
    float32 rounding, not bit for bit.
    """
    c = chroma.to(torch.float32)
    dev = c.device
    x8 = np.arange(c.shape[-1]) % 8
    cos_t = torch.from_numpy(
        np.cos(2 * np.pi * x8 / 8).astype(np.float32)).to(dev)
    sin_t = torch.from_numpy(
        np.sin(2 * np.pi * x8 / 8).astype(np.float32)).to(dev)

    zr = _box8(c * cos_t)
    zi = _box8(-c * sin_t)

    # per-line burst phase + amplitude
    br = zr[:, burst_start:burst_start + burst_len].mean(dim=-1)
    bi = zi[:, burst_start:burst_start + burst_len].mean(dim=-1)
    bnorm = sqrt_rn(br * br + bi * bi) + 1e-6

    # rotate into the burst frame: burst sits on the -U axis (NTSC), so the
    # component along the burst vector is -U and the quadrature is +V
    cr = (zr * br[:, None] + zi * bi[:, None]) / bnorm[:, None]
    ci = (zi * br[:, None] - zr * bi[:, None]) / bnorm[:, None]
    u = -cr * saturation
    v = ci * saturation
    return u[:, :width], v[:, :width], bnorm


def equalize_lut(blank_level: float, white_level: float,
                 wp_equalize: bool = True) -> np.ndarray:
    """Exact equalization table (:712-717). The reference subtracts the
    DOUBLE blank_level from the int luma and truncates, then divides the
    255-scaled int by the DOUBLE level span and truncates again — two
    float64 truncations per sample, not integer ops. Host-precomputed over
    the 256 possible raw values so the device path is one gather."""
    m = np.arange(256, dtype=np.float64)
    v = np.trunc(m - blank_level)
    if wp_equalize:
        v = np.trunc((v * 255.0) / (white_level - blank_level))
    return v.astype(np.int32)


def _check_tails(c3_tail: torch.Tensor, scan_tail: torch.Tensor,
                 carry: torch.Tensor) -> int:
    n = c3_tail.shape[0] if c3_tail.ndim == 2 else -1
    for name, t, shape in (("c3_tail", c3_tail, (n, TAIL_COLS)),
                           ("scan_tail", scan_tail, (n, OUT_COLS)),
                           ("carry", carry, (CARRY,))):
        if tuple(t.shape) != shape or t.dtype != torch.int32:
            raise ValueError(f"{name}: {t.dtype} {tuple(t.shape)}, expected "
                             f"int32 {shape}")
        if t.device != c3_tail.device:
            raise ValueError(f"{name} on {t.device}, c3_tail on "
                             f"{c3_tail.device}")
    return n


def tail_chain_reference(c3_tail: torch.Tensor, scan_tail: torch.Tensor,
                         carry: torch.Tensor):
    """Plain version of the raw28_tails kernel: the carried end of
    `one_line` (cvsim_tpu/models/raw28.py:260-281), line by line.

    c3_tail int32 [N, 28]: each line's c3 = s - (s + s[+4] + 1) / 2 at
    columns L-28..L-1; scan_tail int32 [N, 12]: its samples at L-12..L-1;
    carry int32 [16]: the chroma tail of the line before the first.
    Returns (chroma_tail [N, 12], luma_tail [N, 12], carry [16]) of
    columns L-12..L-1 and the last line. Integers only, C truncation."""
    n = _check_tails(c3_tail, scan_tail, carry)
    chroma, luma = [], []
    tail = carry
    for r in range(n):
        # the burst enhancement c[x] + c[x+8] - c[x+4] - c[x+12] over
        # columns L-28.. reads the tail past L
        ce = torch.cat([c3_tail[r], tail])
        c = (ce[:TAIL_COLS] + ce[8:TAIL_COLS + 8] - ce[4:TAIL_COLS + 4]
             - ce[12:TAIL_COLS + 12])
        # 4 denoise passes read tail[:4] past the row end
        t4 = tail[:4]
        for _ in range(4):
            cd = torch.cat([c, t4])
            c = c - c_div(cd[:TAIL_COLS] + cd[4:TAIL_COLS + 4], 2)
        tail = c_div(c[TAIL_COLS - CARRY:], 4)
        ch = c_div(c[:OUT_COLS], 4)
        chroma.append(ch)
        luma.append(scan_tail[r] - ch)
    if n == 0:
        empty = torch.zeros((0, OUT_COLS), dtype=torch.int32,
                            device=c3_tail.device)
        return empty, empty.clone(), carry.clone()
    return torch.stack(chroma), torch.stack(luma), tail


def raw28_tails(c3_tail: torch.Tensor, scan_tail: torch.Tensor,
                carry: torch.Tensor):
    """The carried line tails of decode_lines, with tail_chain_reference's
    arguments and results. A CPU tensor runs tail_chain_reference. A CUDA
    tensor launches the kernel of csrc/raw28.cu (built at first use),
    one launch for all N lines, or raises; there is no fallback."""
    dev = kernels.device_of(c3_tail, "raw28_tails")
    if dev is None:
        return tail_chain_reference(c3_tail, scan_tail, carry)
    n = _check_tails(c3_tail, scan_tail, carry)
    c3_tail, scan_tail, carry = (t.contiguous()
                                 for t in (c3_tail, scan_tail, carry))
    chroma = torch.empty((n, OUT_COLS), dtype=torch.int32, device=dev)
    luma = torch.empty_like(chroma)
    carry_out = torch.empty_like(carry)
    kernels.launch("raw28_tails", c3_tail, scan_tail, carry, chroma, luma,
                   carry_out, n, device=dev)
    return chroma, luma, carry_out


def split_lines(x: torch.Tensor, raw_len: int):
    """(s, c3) int32 [N, raw_len] of equalized lines x [N, >= raw_len + 4]:
    the samples, and each minus its luma estimate int_luma[x] = (s[x] +
    s[x+4] + 1) / 2 (:735-736), the chroma before enhancement."""
    s = x[:, :raw_len]
    return s, s - c_div(s + x[:, 4:raw_len + 4] + 1, 2)


def tail_inputs(s: torch.Tensor, c3: torch.Tensor):
    """(c3_tail [N, 28], scan_tail [N, 12]) of split_lines' outputs: the
    columns raw28_tails reads."""
    return (c3[:, -TAIL_COLS:].contiguous(),
            s[:, -OUT_COLS:].contiguous())


def decode_lines(
    raw_lines,            # int32 or uint8 [N, L+24] raw samples per line
    blank_level: float,
    white_level: float,
    *,
    raw_len: int,
    equalize: bool = True,
    wp_equalize: bool = True,
    separate_chroma: bool = True,
    show_subcarrier: bool = False,
    width: int = 720,
    full_chroma: bool = False,
    chroma_carry=None,    # int32 [16] from the previous line batch
):
    """Equalization + Y/C separation for a batch of scanlines
    (:706-779), on raw_lines' device. Returns (luma uint8 [N, width],
    chroma int32 [N, width] — or [N, raw_len] with full_chroma=True — and
    the int32[16] chroma-tail carry for the next batch), equal to the JAX
    package's decode_lines.

    The reference's int_chroma[4096] is a C static reused across scanlines
    AND fields: each line's shift stage writes [16, raw_len+16) only, so
    the chroma stages that read past raw_len (enhancement x+8/x+12,
    denoise x+4) pick up the PREVIOUS line's shifted tail — the last 28
    columns of every line's denoised chroma depend on the line before it,
    and with them chroma and luma at columns raw_len-12.. . Every other
    column is computed for all lines at once; the tails are chained in
    order by raw28_tails. Callers thread the carry across decode_field
    calls to preserve the cross-field leak."""
    x = torch.as_tensor(raw_lines)
    dev = x.device
    x = x.to(torch.int32)
    if equalize:
        lut = torch.from_numpy(
            equalize_lut(blank_level, white_level, wp_equalize)).to(dev)
        x = torch.take(lut, x.clamp(0, 255).long())

    carry0 = (torch.zeros(CARRY, dtype=torch.int32, device=dev)
              if chroma_carry is None
              else torch.as_tensor(chroma_carry).to(dev, torch.int32))

    L = raw_len
    if separate_chroma:
        if L < CARRY + TAIL_COLS:
            raise ValueError(f"raw_len {L}: expected >= "
                             f"{CARRY + TAIL_COLS}")
        s, c3 = split_lines(x, L)
        # burst enhancement c[x]+c[x+8]-c[x+4]-c[x+12] (:741-742) where it
        # stays inside the line: x < L-12
        c = c3[:, :L - 12] + c3[:, 8:L - 4] - c3[:, 4:L - 8] - c3[:, 12:L]
        # 4 denoise passes (:744-747), each over the columns whose x+4
        # is still carry-free: L-16, L-20, L-24, then L-28 columns
        for _ in range(4):
            w = c.shape[1] - 4
            c = c[:, :w] - c_div(c[:, :w] + c[:, 4:w + 4], 2)
        ch_tail, lu_tail, carry = raw28_tails(*tail_inputs(s, c3), carry0)
        # shift by 16 and /4 renormalize (:749-751): the backward loop
        # writes x+16 only, so columns 0..15 KEEP the pre-shift denoised
        # (undivided) values
        chroma = torch.cat([c[:, :16], c_div(c, 4), ch_tail], dim=1)
        luma = torch.cat([s[:, :L - OUT_COLS] - chroma[:, :L - OUT_COLS],
                          lu_tail], dim=1)
    else:
        luma = x[:, :L]
        chroma = torch.zeros_like(luma)
        carry = carry0

    if show_subcarrier:
        out = chroma[:, :width] + 128
    else:
        out = luma[:, :width]
    ch = chroma if full_chroma else chroma[:, :width]
    return out.clamp(0, 255).to(torch.uint8), ch, carry


class Raw28State(NamedTuple):
    """What a decoder carries from field to field besides its buffered
    samples: the AGC levels and the int32[16] chroma tail (None before the
    first decoded line)."""
    agc: AGCState
    chroma_tail: torch.Tensor | None


class Raw28Decoder:
    """Streaming decoder: feed raw bytes, pull decoded fields. The lines
    of each field cross to `device` as uint8 and decode there; the chroma
    carry stays on it from field to field. `state` starts the decoder
    from another's AGC levels and chroma carry
    (interop.raw28_state_from_reference)."""

    def __init__(self, sample_rate: float, width: int = 720,
                 height: int = 480, *, disable_sync: bool = False,
                 equalize: bool = True, wp_equalize: bool = True,
                 separate_chroma: bool = True, show_subcarrier: bool = False,
                 decode_color: bool = False, saturation: float = 2.0,
                 mark_sync: bool = False, device="cuda",
                 state: Raw28State | None = None):
        from cvsim_tpu_torch.native import HsyncDcTracker

        self.device = torch.device(device)
        self.t = RawTiming(sample_rate)
        self.width = width
        self.height = height
        self.disable_sync = disable_sync
        self.equalize = equalize
        self.wp_equalize = wp_equalize
        self.separate_chroma = separate_chroma
        self.show_subcarrier = show_subcarrier
        self.decode_color = decode_color
        self.saturation = saturation
        self.mark_sync = mark_sync
        self.agc = AGCState()
        self.tracker = HsyncDcTracker(
            sample_rate, self.t.one_scanline_time, self.t.one_frame_time)
        self.raw = np.zeros(0, np.uint8)
        self.dc = np.zeros(0, np.uint8)
        self._pending = []     # fed chunks, concatenated lazily (feed() is
        self.pos = 0           # O(chunk), not O(total buffered))
        # the reference's static int_chroma[] leaks its shifted tail across
        # scanlines AND fields (see decode_lines); zeros match the C static
        self._chroma_tail = None
        self.fields = 0        # fields decoded: the unit of `raw28.field`
        if state is not None:
            self.agc = dataclasses.replace(state.agc)
            if state.chroma_tail is not None:
                self._chroma_tail = state.chroma_tail.to(self.device,
                                                         torch.int32)

    @property
    def state(self) -> Raw28State:
        return Raw28State(dataclasses.replace(self.agc), self._chroma_tail)

    def feed(self, data: bytes | np.ndarray):
        with log.span("raw28.feed"):
            r, d = self.tracker.process(np.frombuffer(data, np.uint8)
                                        if isinstance(data, bytes) else data)
            if self.mark_sync:
                # paint detected sync pulses white
                # (ffmpeg_raw28ntsc.cpp:589-590)
                r = np.where(d < SYNC_THRESHOLD, np.uint8(255), r)
            self._pending.append((r, d))

    def buffered(self) -> tuple[np.ndarray, np.ndarray]:
        """(raw, dc) uint8: the tracker's outputs fed and not yet consumed,
        where the next decode_field starts. The decoder never writes into
        them: it replaces them."""
        self._compact()
        return self.raw, self.dc

    def _compact(self):
        if self._pending:
            self.raw = np.concatenate(
                [self.raw] + [r for r, _ in self._pending])
            self.dc = np.concatenate(
                [self.dc] + [d for _, d in self._pending])
            self._pending = []
        if self.pos > 0:
            self.raw = self.raw[self.pos:]
            self.dc = self.dc[self.pos:]
            self.pos = 0

    def decode_field(self):
        """Decode one field (height lines) if enough samples are buffered;
        returns uint8 [height, width] or None (with decode_color, a pair
        of that and the float32 (u, v) planes)."""
        self._compact()
        rl = self.t.raw_length
        need = rl * (self.height + 30)
        if len(self.raw) < need:
            return None
        with log.span("raw28.field", field=self.fields) as span:
            result = self._decode_field(rl)
            if result is None and span is not None:
                # no line after the lock: the call yields no field (a
                # profiler's range keeps the name it opened with)
                span.name = "raw28.nofield"
        if result is not None:
            self.fields += 1
        return result

    def _decode_field(self, rl: int):
        pos = 0
        if not self.disable_sync:
            with log.span("raw28.hunt"):
                lock = hunt_vsync(self.dc, self.raw, rl, self.agc)
            if lock is not None:
                pos = lock

        # gather line starts with fractional pacing + per-line re-lock
        with log.span("raw28.lines"):
            walk = walk_lines(self.dc, pos, rl, self.height,
                              not self.disable_sync)
        line_starts, p = walk.starts, walk.p
        if not len(line_starts):
            self.pos = min(len(self.raw), pos + rl * 240)
            return None

        with log.span("raw28.decode"):
            out, uv = self._decode_lines(line_starts, rl)

        # cursor advance (:836-845): with sync the read cursor moves to
        # exactly 240 scanlines past the vsync lock (input_start + 240H —
        # NOT to where the line scan ended; the ~22-line overlap is what
        # paces 262 rendered lines against the 262.5-line field cadence,
        # the next hunt re-locks inside it). nosig mode advances to the
        # scan end first (:835), then the same 240H floor applies.
        if self.disable_sync:
            consumed = max(p, pos + rl * 240)
        else:
            consumed = pos + rl * 240
        self.pos = min(len(self.raw), consumed)
        return (out, uv) if self.decode_color else out

    def _decode_lines(self, line_starts: np.ndarray, rl: int):
        """The field's lines gathered at `line_starts`, decoded on the
        device and fetched: (luma uint8 [height, width], the (u, v) planes
        with decode_color, else None)."""
        n = len(line_starts)
        # rows of a window view: every start lies 2 * rl samples or more
        # before the buffer's end (the line loop), so no row is clipped
        # and no index array is built; uint8 across, widened on the device
        windows = np.lib.stride_tricks.sliding_window_view(self.raw, rl + 24)
        lines = torch.from_numpy(windows[line_starts])
        on_card = self.device.type == "cuda"
        if on_card:
            log.count("h2d_bytes.raw28", lines.nbytes)
        lines = lines.to(self.device)

        out, chroma, self._chroma_tail = decode_lines(
            lines, self.agc.blank_level, self.agc.white_level,
            raw_len=rl, equalize=self.equalize, wp_equalize=self.wp_equalize,
            separate_chroma=self.separate_chroma,
            show_subcarrier=self.show_subcarrier, width=self.width,
            full_chroma=self.decode_color, chroma_carry=self._chroma_tail)
        if on_card:
            log.count("d2h_bytes.raw28", out.nbytes)
            log.count("syncs")
        out = out.cpu().numpy()
        uv = None
        if self.decode_color and self.separate_chroma:
            # burst window: just after the hsync pulse (breezeway + ~9
            # subcarrier cycles); hsync is ~0.075H and line starts at the
            # pulse center, so the burst sits around 0.045H..0.085H
            bs = int(rl * 0.045)
            bl = int(rl * 0.04)
            u, v, _ = decode_color_lines(
                chroma, raw_len=rl, width=self.width,
                burst_start=bs, burst_len=bl, saturation=self.saturation)
            if on_card:
                log.count("d2h_bytes.raw28", u.nbytes + v.nbytes)
                log.count("syncs", 2)
            uv = (u.cpu().numpy(), v.cpu().numpy())
            if n < self.height:
                uv = tuple(np.pad(p, [(0, self.height - n), (0, 0)])
                           for p in uv)
        if n < self.height:
            out = np.pad(out, [(0, self.height - n), (0, 0)])
        return out, uv
