"""Host side of feed() per superblock, ms: the mean wall time of a call
minus the device-busy time inside it (all device work of the window runs
inside feed(), which waits for its readback).  Layer: the pipeline's host
side (MultiDemodulator.feed/_process, native/finalizer.cpp,
DeviceIcaoMirror)."""


def read(ctx):
    if not ctx.n_calls or not ctx.events:
        return None
    wall = sum(b - a for a, b in ctx.calls) / ctx.n_calls
    busy = sum(b - a for a, b in ctx.busy()) / ctx.n_calls
    return (wall - busy) / 1e6
