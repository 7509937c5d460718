"""Device-busy time per superblock outside every copy, ms: the kernels and
memsets of the dispatch (the torch stages of ops/demod.py, ops/gate.py,
ops/convert.py and the hand-written kernels)."""

KINDS = ("kernel", "memset")


def read(ctx):
    busy = ctx.busy(KINDS)
    if not ctx.n_calls or not busy:
        return None
    return sum(b - a for a, b in busy) / ctx.n_calls / 1e6
