"""Host time per superblock in the finalizers, ms: the program's "finalize"
spans, one per channel (native/finalizer.cpp or decode/score.finalize_block)."""

from portbench import programspans


def read(ctx):
    w = programspans.of(ctx)
    return None if w is None else w.ms_per_sb("finalize")
