"""Timestamp normalization and field targeting (reference L3).

Ports the monotonic-clock repair of the demux pump
(ffmpeg_to_composite.cpp:2249-2293) and the PTS->target rules of the
decode-render functions (:1663-1678 video, :1816-1829 audio), plus
normalize_ts.cpp's per-stream monotonic rewrite (:171-188, :438-467).
"""

from __future__ import annotations

import dataclasses
from fractions import Fraction


@dataclasses.dataclass
class TimestampNormalizer:
    """Monotonic master clock: feeds on packet times (seconds), returns the
    adjusted time, compensating backward jumps >1.5s and forward jumps >5s
    (DVD timecode resets / breaks)."""

    backward_slack: float = 1.5
    forward_slack: float = 5.0
    adj_time: float = 0.0
    prev_t: float = -1.0

    def feed(self, t: float) -> float:
        if self.prev_t < 0:
            self.adj_time = -t
        elif (t + self.backward_slack) < self.prev_t:
            self.adj_time += self.prev_t - t
        elif t > (self.prev_t + self.forward_slack):
            self.adj_time += self.prev_t - t
        self.prev_t = t
        return t + self.adj_time


def video_target_field(pts_field, current_field: int, slack: int = 4) -> int:
    """Clamp decoder PTS imperfections (ffmpeg_to_composite.cpp:1663-1678):
    None -> current; negative -> 0; small backwards jitter -> hold."""
    if pts_field is None:
        return current_field
    tgt = max(0, int(pts_field))
    if abs(tgt - current_field) < slack and tgt < current_field:
        tgt = current_field
    return tgt


def audio_target_sample(pts_sample, current_sample: int, rate: int) -> int:
    """Same rule with rate/30 slack (:1816-1829)."""
    if pts_sample is None:
        return current_sample
    tgt = max(0, int(pts_sample))
    if abs(tgt - current_sample) < rate // 30 and tgt < current_sample:
        tgt = current_sample
    return tgt


def frame_pts_to_field(frame_index: int, fps: Fraction, field_rate: Fraction) -> int:
    """Rescale a frame timestamp into the running field counter (the
    av_packet_rescale_ts to field timebase at :2300-2301). av_rescale's
    default AV_ROUND_NEAR_INF rounds half away from zero — truncation
    changes the pull-down cadence for rates that don't divide the field
    rate (24/25/48 fps into 59.94)."""
    q = Fraction(frame_index) * field_rate / fps
    n, d = q.numerator, q.denominator
    if n >= 0:
        return (2 * n + d) // (2 * d)
    return -((2 * -n + d) // (2 * d))


class FrameClock:
    """Per-frame presentation-time -> output-field targeting.

    CFR mode (no log): fields come from the frame index and the container
    rate — what Y4M can express. VFR mode (log given): each frame carries
    its own (pts, duration) in ticks at `log_rate`, the rebuild's version of
    the reference's reordered_opaque -> AVDelayedFrameInfo duration map
    (ffmpeg_to_composite.cpp:1641-1647, 2303-2307): a telecined/VFR source
    renders each frame for its OWN duration instead of a constant cadence.
    The demux pump's adj_time repair (:2249-2293) is applied to the pts
    stream (backward >1.5s / forward >5s jumps compensated); frames must be
    fed in presentation order (`fields` asserts monotonic access).

    All field math is exact rational arithmetic with AV_ROUND_NEAR_INF
    rounding (same as frame_pts_to_field).
    """

    def __init__(self, fps: Fraction, field_rate: Fraction,
                 log=None, log_rate: int = 90000):
        self.fps = fps
        self.field_rate = field_rate
        self.log = log            # list[(pts_ticks, dur_ticks)] or None
        self.log_rate = log_rate
        self._adj = []            # adjusted pts per frame idx (ticks)
        self._add = 0

    def _adj_pts(self, idx: int) -> int:
        log = self.log
        while len(self._adj) <= idx:
            k = len(self._adj)
            if k >= len(log):
                # past the log's coverage: extend by the last duration
                # (decoder behavior: missing info falls back to cadence)
                p, d = log[-1]
                extra = (k - len(log) + 1) * max(1, d)
                self._adj.append(self._adj[len(log) - 1] + extra)
                continue
            t = log[k][0]
            if k == 0:
                self._add = 0
            else:
                prev = self._adj[k - 1]
                raw = t + self._add
                back = int(1.5 * self.log_rate)
                fwd = int(5.0 * self.log_rate)
                if raw + back < prev or raw > prev + fwd:
                    self._add += prev - raw
            self._adj.append(t + self._add)
        return self._adj[idx]

    def _to_fields(self, ticks: int) -> int:
        q = Fraction(ticks) * self.field_rate / self.log_rate
        n, d = q.numerator, q.denominator
        if n >= 0:
            return (2 * n + d) // (2 * d)
        return -((2 * -n + d) // (2 * d))

    def seconds(self, idx: int) -> float:
        """Presentation time of frame idx (for -ss/-se gating), relative
        to the STREAM start: containers and -video-pts-in logs routinely
        start at a nonzero pts (MPEG-TS offsets); absolute pts here would
        shift — or empty out — the transcode window vs the CFR path."""
        if self.log is None:
            return float(idx / self.fps)
        return float((self._adj_pts(idx) - self._adj_pts(0)) / self.log_rate)

    def fields(self, idx: int, base_idx: int) -> tuple[int, int]:
        """(start_field, end_field) of frame `idx`, rebased so the first
        accepted frame (`base_idx`) starts the field clock at zero (the
        adj_time rebase, :2264-2265)."""
        if self.log is None:
            rel = idx - base_idx
            return (frame_pts_to_field(rel, self.fps, self.field_rate),
                    frame_pts_to_field(rel + 1, self.fps, self.field_rate))
        p0 = self._adj_pts(base_idx)
        p = self._adj_pts(idx) - p0
        d = self.log[idx][1] if idx < len(self.log) else self.log[-1][1]
        return (self._to_fields(p), self._to_fields(p + d))


def read_audio_pts_log(path: str):
    """Parse an `-audio-pts-in`-format packet log: optional `rate <hz>`
    first line (sample clock, None = stream rate), then one
    `<pts_samples|none> <nsamples>` line per audio packet in stream
    order. Returns (rate, [(pts, nsamples), ...])."""
    rate, pkts = None, []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "rate":
                rate = int(parts[1])
                continue
            pkts.append((None if parts[0] == "none" else int(parts[0]),
                         int(parts[1])))
    return rate, pkts


def read_frame_pts_log(path: str):
    """Parse a `-video-pts-in` sidecar frame log: optional `rate <hz>` first
    line (ticks/second, default 90000 — the MPEG-TS clock), then one
    `<pts> <duration>` line per frame in presentation order, ticks. The
    shape an ffprobe packet dump reduces to; normalize-ts can repair a
    non-monotonic log first."""
    rate = 90000
    entries = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "rate":
                rate = int(parts[1])
                continue
            entries.append((int(parts[0]), int(parts[1])))
    return entries, rate


@dataclasses.dataclass
class StreamTsState:
    """normalize_ts.cpp per-stream monotonic PTS rewrite (:171-188,438-467)."""

    prev_pts: int | None = None
    add: int = 0
    max_forward: int = 0  # in stream timebase ticks; 0 = no clamp

    def rewrite(self, pts: int | None) -> int | None:
        if pts is None:
            return None
        p = pts + self.add
        if self.prev_pts is not None:
            if p < self.prev_pts:
                self.add += self.prev_pts - p
                p = self.prev_pts
            elif self.max_forward and p > self.prev_pts + self.max_forward:
                self.add -= p - (self.prev_pts + self.max_forward)
                p = self.prev_pts + self.max_forward
        self.prev_pts = p
        return p
