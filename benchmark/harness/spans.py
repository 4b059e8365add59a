"""Readings of the program's own spans in the traced window: the spans
``parc_torch`` opens at its layers' boundaries (``parc.<layer>.<part>``,
through ``parc_torch.utils.profiling.annotate``, which opens them only
while a profiler runs), as ``harness/trace.py`` keeps them.

An idle reading apportions the measured idle time, so that the profiler's
slowing of the traced step's host side does not inflate it: a step's
wall time in the measured window (``Run.step_s``) times its idle share
(``Run.idle_share``), times the share of the traced idle seconds that lay
in gaps labelled by the spans read (each gap is labelled by the innermost
span open at its start)."""

from __future__ import annotations

from typing import Iterable, Optional, Tuple


def count(run, name: str) -> int:
    """Spans named ``name`` in the traced window."""
    return sum(1 for n, _, _ in run.trace.spans if n == name)


def idle_ms(run, names: Iterable[str], inner: Tuple[str, ...] = ()
            ) -> Optional[float]:
    """Idle ms a step of the measured window under the spans ``names``:
    the gaps labelled by one of them, or by a span whose name starts with
    one of ``inner`` (PyTorch's own spans, such as ``Optimizer.step``,
    opened inside them). None where none of ``names`` is in the trace."""
    names = set(names)
    tr = run.trace
    if not any(n in names for n, _, _ in tr.spans):
        return None
    total = sum(s for _, s in tr.gaps)
    if total <= 0:
        return 0.0
    mine = sum(s for n, s in tr.gaps
               if n in names or (inner and n.startswith(inner)))
    return 1e3 * run.step_s * run.idle_share() / 100.0 * mine / total
