"""Time inside the interpreter's garbage collections per second of the
window, ms/s, from gc.callbacks in the run's process."""


def read(ctx):
    return sum(b - a for a, b in ctx.gcs) / 1e6 / ctx.window_s
