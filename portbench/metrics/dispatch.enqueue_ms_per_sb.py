"""Host time per superblock enqueueing the dispatch, ms: the program's
"dispatch" spans (_demod_and_gate_multi* with the ICAO table's rebuild)."""

from portbench import programspans


def read(ctx):
    w = programspans.of(ctx)
    return None if w is None else w.ms_per_sb("dispatch")
