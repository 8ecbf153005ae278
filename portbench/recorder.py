"""What the program's own trace recorder (``tardis_torch.tracing``) holds
after a traced window: the profiler is on exactly around the window, and
the recorder records while it is, so its records are the window's.

Every reader returns None where the program has no recorder, so a layer
file that reads it reports nothing there rather than failing.
"""


def records():
    """The recorder's records of the last window, or None."""
    try:
        from tardis_torch import tracing
    except ImportError:
        return None
    return tracing.records()


def span_count(recs, name: str) -> int:
    return sum(1 for s in recs["spans"] if s.name == name)


def median_by_iteration(recs, counter: str, span: str):
    """The median over the iterations that hold a ``span`` of each one's
    ``counter``; None where none does."""
    import statistics

    its = {s.iteration for s in recs["spans"] if s.name == span}
    if not its:
        return None
    by = recs["by_iteration"]
    return float(statistics.median(by.get(i, {}).get(counter, 0)
                                   for i in its))
