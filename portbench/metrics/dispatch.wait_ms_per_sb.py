"""Host time per superblock waiting for the dispatch, ms: the program's
"sync" spans (the one device sync of pipeline._fit_or_grow, two where a
dispatch is redone)."""

from portbench import programspans


def read(ctx):
    w = programspans.of(ctx)
    return None if w is None else w.ms_per_sb("sync")
