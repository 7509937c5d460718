"""Share of the superblocks whose IQ went to the device from the program's
staging buffer (pinned on a card), %: 100 x the counter `pinned` that the
superblock spans note (MultiDemodulator.feed), over the superblock spans.
None where no superblock span notes the counter."""

from portbench import programspans


def read(ctx):
    w = programspans.of(ctx)
    if w is None:
        return None
    noted = [s[6]["pinned"] for s in w.spans if s[0] == "superblock" and s[6] and "pinned" in s[6]]
    return 100.0 * sum(noted) / w.n_sb if noted else None
