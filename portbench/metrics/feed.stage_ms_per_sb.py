"""Host time per superblock staging the channels' IQ, ms: the program's
"stage" spans (MultiDemodulator.feed: the pending bytes joined and the
channels' chunks stacked into one array)."""

from portbench import programspans


def read(ctx):
    w = programspans.of(ctx)
    return None if w is None else w.ms_per_sb("stage")
