"""The readers of the program's own spans and counters
(`harness/program_trace.py`): each returns its defined value on a
hand-built snapshot of the recorder, and None on one without aggregates
or on a program without the recorder. The snapshot and the value are
`SNAPSHOT` and `WANT` below, or the reader's own `CASE` (snapshot,
value) in its file."""

import pytest

from conftest import ROOT
from harness import spec as spec_mod


def _agg(count, total_ms, counts=None):
    return {"count": count, "total_ns": int(total_ms * 1e6),
            "self_ns": int(total_ms * 1e6), "counts": counts or {}}


SNAPSHOT = {
    "spans": [], "dropped": 0, "events": [], "counters": {"syncs": 99},
    "aggregates": {
        "gen2.call": _agg(4, 60.0, {"syncs": 36}),
        "gen2.prepare": _agg(4, 48.0),
        "gen2.prepare.streams": _agg(4, 40.0),
        "gen2.prepare.tables": _agg(4, 3.0),
        "gen2.prepare.copy": _agg(8, 2.0),
        "gen1.call": _agg(2, 30.0, {"syncs": 18}),
        "gen1.prepare": _agg(2, 26.0),
        "gen1.prepare.streams": _agg(2, 22.0),
        "gen1.prepare.tables": _agg(2, 1.5),
        "gen1.prepare.copy": _agg(4, 0.5),
        "gen2.read": _agg(33, 66.0),
        "gen2.wait": _agg(2, 30.0),
        "gen2.emit.convert": _agg(128, 512.0),
    },
}

WANT = {
    "prepare_streams_ms.gen2": 10.0,
    "prepare_tables_ms.gen2": 1.25,      # (3 + 2) ms over 4 prepares
    "prepare_streams_ms.gen1": 11.0,
    "prepare_tables_ms.gen1": 1.0,       # (1.5 + 0.5) ms over 2 prepares
    "syncs_per_call": 9.0,               # (36 + 18) over 6 calls
    "read_ms_per_frame.gen2": 2.0,
    "flush_wait_ms_per_gop.gen2": 15.0,
    "emit_convert_ms_per_field.gen2": 4.0,
}


# the benchmark's own wrappers (harness/trace.Spans) read these
WRAPPED = {"prepare_ms.gen2", "prepare_ms.gen1", "emit_ms_per_field.gen2"}


def _module(name):
    return spec_mod.metric_module(spec_mod.Spec.load(ROOT).bench_dir, name)


def _program_metrics():
    spec = spec_mod.Spec.load(ROOT)
    return {m["name"] for m in spec.bench["per_layer"]
            if m["source"] in ("program_span", "program_counter")} - WRAPPED


OWN_CASE = sorted(n for n in _program_metrics()
                  if hasattr(_module(n), "CASE"))


def test_every_program_metric_has_a_case():
    assert _program_metrics() - set(OWN_CASE) == set(WANT)


@pytest.mark.parametrize("name", sorted(set(WANT) | set(OWN_CASE)))
def test_reader_on_a_snapshot(name, monkeypatch):
    from cvsim_tpu_torch.utils import log

    snapshot, want = (_module(name).CASE if name in OWN_CASE
                      else (SNAPSHOT, WANT[name]))
    read = _module(name).read
    monkeypatch.setattr(log, "snapshot", lambda: snapshot, raising=False)
    assert read(None) == pytest.approx(want)
    empty = {**snapshot, "aggregates": {}}
    monkeypatch.setattr(log, "snapshot", lambda: empty, raising=False)
    assert read(None) is None
    monkeypatch.delattr(log, "snapshot")
    assert read(None) is None
