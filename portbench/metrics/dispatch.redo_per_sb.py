"""Dispatches redone per superblock after a capacity overflow: the
program's counter `redispatches` over its superblocks, as the superblock
spans note them."""

from portbench import programspans


def read(ctx):
    w = programspans.of(ctx)
    return None if w is None else w.count("redispatches") / w.n_sb
