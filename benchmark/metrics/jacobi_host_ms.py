"""Host ms a step inside the port's ``solver.jacobi`` span (the IISPH
relaxed-Jacobi loop, its ``sync.converged`` waits included), averaged over
the window's steps.

It reads the port's host total by span name (``counters.span_host_ns``),
which the spans fill while the counters are on: the traced run turns them
on for the window alone (``Counters.enable()`` resets the total there) and
off before its two profiled passes, so those add nothing. None when the
program keeps no such total, or no step entered the span."""


def read(run):
    from salva_tpu_torch import counters

    totals = getattr(counters, "span_host_ns", None)
    ns = totals().get("solver.jacobi") if totals is not None else None
    if not ns or not run.steps:
        return None
    return ns / len(run.steps) / 1e6
