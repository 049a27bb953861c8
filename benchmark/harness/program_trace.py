"""What the program's own recorder (`cvsim_tpu_torch.utils.log`) kept of
a traced run: the per-name aggregates of its spans (count, total and
self ns, the counts made inside them), read in the process after the
window. The recorder records while a profiler runs, so a `--trace 1`
window is all it holds. A program without the recorder, or a run that
recorded nothing, reads None."""

from __future__ import annotations


def aggregates() -> dict | None:
    """{span name: {count, total_ns, self_ns, counts}}, or None."""
    from cvsim_tpu_torch.utils import log

    snapshot = getattr(log, "snapshot", None)
    if snapshot is None:
        return None
    return snapshot().get("aggregates") or None


def mean_ms(name: str) -> float | None:
    """Mean duration of the spans `name`, in ms."""
    aggs = aggregates()
    a = (aggs or {}).get(name)
    if not a or not a["count"]:
        return None
    return a["total_ns"] / a["count"] / 1e6


def per_parent_ms(parts: tuple, parent: str) -> float | None:
    """The spans `parts` together per span `parent`, in ms."""
    aggs = aggregates() or {}
    if not aggs.get(parent, {}).get("count"):
        return None
    total = sum(aggs[p]["total_ns"] for p in parts if p in aggs)
    return total / aggs[parent]["count"] / 1e6


def count_per_span(counter: str, names: tuple) -> float | None:
    """Counter `counter` counted inside the spans `names`, per span."""
    aggs = aggregates() or {}
    spans = [aggs[n] for n in names if n in aggs]
    n = sum(a["count"] for a in spans)
    if not n:
        return None
    return sum(a["counts"].get(counter, 0) for a in spans) / n


def aggregate(count: int, total_ms: float, counts: dict | None = None):
    """One span name's aggregate as the recorder's snapshot holds it (self
    time = total), for the hand-built snapshot of a reader's `CASE`."""
    ns = int(total_ms * 1e6)
    return {"count": count, "total_ns": ns, "self_ns": ns,
            "counts": counts or {}}
