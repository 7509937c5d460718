"""Host time per superblock reading the dispatch back, ms: the program's
"fetch" spans (pipeline._fetch, the level and power sums, the rows
unpacked for the finalizers)."""

from portbench import programspans


def read(ctx):
    w = programspans.of(ctx)
    return None if w is None else w.ms_per_sb("fetch")
