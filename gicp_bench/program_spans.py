"""The program's own record of the traced stretch: the spans and counters
of ``small_gicp_tpu_torch.utils.profiling`` (``collected()``), which record
while the profiler does. The readers of the ``program_span`` and
``program_counter`` metrics take it from here. A program that keeps no such
record gives None, and every reader then reports nothing."""

from __future__ import annotations

from typing import Iterable, Optional


def record() -> Optional[dict]:
    """The program's record, or None where the program keeps none."""
    try:
        from small_gicp_tpu_torch.utils import profiling
    except ImportError:
        return None
    collected = getattr(profiling, "collected", None)
    rec = collected() if collected is not None else None
    return rec if rec and rec["spans"] else None


def total_s(rec: dict, names: Iterable[str]) -> Optional[float]:
    """Host seconds in the spans ``names``, summed; None where none ran."""
    spans = [rec["spans"][n] for n in names if n in rec["spans"]]
    return sum(s["total_s"] for s in spans) if spans else None


def reads_s(rec: dict) -> float:
    """Host seconds spent waiting for the card (the ``read.*`` spans)."""
    return sum(s["total_s"] for n, s in rec["spans"].items() if n.startswith("read."))


def ms_per(names: Iterable[str], counter: str, less: Iterable[str] = ()) -> Optional[float]:
    """Milliseconds of the spans ``names`` (less those of ``less``) per unit
    of the program's counter ``counter``; None where either is missing."""
    rec = record()
    if rec is None:
        return None
    n, s = rec["counters"].get(counter), total_s(rec, names)
    if not n or s is None:
        return None
    return 1e3 * (s - (total_s(rec, less) or 0.0)) / n


def wait_share(ctx) -> Optional[float]:
    """Percent of the traced stretch's host time spent in ``read.*`` spans."""
    rec = record()
    if rec is None or not ctx.trace or ctx.trace.window_s <= 0:
        return None
    return 100.0 * reads_s(rec) / ctx.trace.window_s
