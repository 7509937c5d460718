"""Share of the time in feed() that no leaf span covers, %: what the
program's spans leave unnamed (a parent's own time between its children)."""

from portbench import programspans


def read(ctx):
    w = programspans.of(ctx)
    return None if w is None else w.unspanned_pct()
