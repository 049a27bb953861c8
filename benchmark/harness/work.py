"""The least time one call's work can take on the card: the larger of the
bytes it must move over the memory rate and the recurrences' float32
operations over the float32 rate (NVIDIA H100 SXM data sheet: 3.35 TB/s,
67 TFLOP/s outside the tensor cores, at its 700 W limit).

The work is counted from the call's shapes and the configuration alone,
so any implementation of the chain is read against the same work: each
input byte read once, each output byte written once, and three float32
operations per sample for every one-pole pass the chain's definition
runs. The pole counts are those of the chain as the reference tools
define it: a lowpass with a delayed writeback is three poles, the VHS
luma emphasis four, a noise walk one; gen-1's full chroma lowpass adds a
half-cut pole. The blocked-matrix form that one implementation uses for
exactness is not counted."""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
POLE_FLOPS = 3


def gen2_poles(c: dict) -> int:
    """One-pole passes per line of the gen-2 chain, all at the luma rate."""
    vhs = int(c["emulating_vhs"])
    pre = int(c["composite_preemphasis"] != 0
              and c["composite_preemphasis_cut"] > 0)
    a = 6 * int(c["composite_in_chroma_lowpass"]) + pre + int(
        c["video_noise"] != 0)
    b1 = 2 * int(c["video_chroma_noise"] != 0) + 10 * vhs
    b2 = 3 * vhs + 6 * int(bool(c["composite_out_chroma_lowpass"]))
    return a + b1 + b2


def gen1_poles(c: dict) -> tuple[int, int]:
    """(passes at the luma rate, passes at the chroma rate) per line of the
    gen-1 chain."""
    vhs = int(c["emulating_vhs"])
    pre = int(c["composite_preemphasis"] != 0
              and c["composite_preemphasis_cut"] > 0)
    if c["composite_out_chroma_lowpass"]:
        out_lp = 8
    elif c["composite_out_chroma_lowpass_lite"]:
        out_lp = 6
    else:
        out_lp = 0
    luma = pre + int(c["video_noise"] != 0) + 4 * vhs + 3 * vhs
    chroma = (8 * int(c["composite_in_chroma_lowpass"])
              + 2 * int(c["video_chroma_noise"] != 0) + 6 * vhs
              + 6 * vhs + out_lp)
    return luma, chroma


def gen2_flops(c: dict, b: int, l: int, w: int) -> float:
    return b * l * w * gen2_poles(c) * POLE_FLOPS


def gen1_flops(c: dict, b: int, l: int, w: int) -> float:
    luma, chroma = gen1_poles(c)
    return b * l * (luma * w + chroma * (w // 2)) * POLE_FLOPS


def least_time_s(flops: float, n_bytes: float) -> tuple[float, str]:
    """(seconds, "bytes" or "operations"): which bound the call meets."""
    t_ops = flops / F32_FLOPS
    t_bytes = n_bytes / HBM_BYTES_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def gen2_call(c: dict, b: int, l: int, w: int) -> tuple[float, str]:
    """A gen-2 library call on b uint8 RGB fields of l x w: the fields in,
    their field numbers and parities (int32), the fields out."""
    n_bytes = 2 * b * l * w * 3 + 2 * 4 * b
    return least_time_s(gen2_flops(c, b, l, w), n_bytes)


def gen1_call(c: dict, b: int, l: int, w: int) -> tuple[float, str]:
    """A gen-1 library call on b fields of uint8 Y [l, w], U, V [l, w/2]:
    the planes in, field numbers and parities (int32), the planes out."""
    n_bytes = 2 * b * l * (w + 2 * (w // 2)) + 2 * 4 * b
    return least_time_s(gen1_flops(c, b, l, w), n_bytes)


def roofline_pct(run) -> float | None:
    """A traced run's least time of a call's work over the device time per
    call (the union of the device intervals in the window over its calls),
    in %; None where the run has no trace, no count of work or no call."""
    if (run.trace is None or run.least_time is None or run.window.units == 0
            or run.trace.busy_s <= 0):
        return None
    return 100.0 * run.least_time[0] * run.window.units / run.trace.busy_s
