"""Device operations per superblock: kernels, memsets and copies, as the
trace lists them."""


def read(ctx):
    if not ctx.n_calls or not ctx.events:
        return None
    return len(ctx.events) / ctx.n_calls
