"""Host time per superblock correcting the gate's drop counts, ms: the
program's "drops" spans, one per channel (ops/gate.skipped_drops)."""

from portbench import programspans


def read(ctx):
    w = programspans.of(ctx)
    return None if w is None else w.ms_per_sb("drops")
