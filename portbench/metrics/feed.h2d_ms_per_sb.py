"""Device time of the host-to-device copies per superblock, ms (the IQ
upload: pipeline._words_from_bytes on the raw route, _to_mag on the
magnitude route, and the small tables the dispatch sends)."""

KINDS = ("h2d",)


def read(ctx):
    copies = [e for e in ctx.events if e[3] in KINDS]
    if not ctx.n_calls or not copies:
        return None
    return sum(b - a for _, a, b, _ in copies) / ctx.n_calls / 1e6
