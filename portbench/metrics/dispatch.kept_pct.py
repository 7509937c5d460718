"""Share of the scan's candidates that the score gate kept and read back,
%: the program's counters 100 x `kept` / `candidates`, as the superblock
spans note them."""

from portbench import programspans


def read(ctx):
    w = programspans.of(ctx)
    if w is None or not w.count("candidates"):
        return None
    return 100.0 * w.count("kept") / w.count("candidates")
