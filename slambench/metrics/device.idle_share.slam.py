"""The device's idle share of the traced window, %: 100 x (1 - the union
of the card's kernel, copy and fill intervals / the window)."""

from slambench.lib import trace as tr


def read(ctx):
    if ctx.trace is None:
        return None
    s = tr.idle_share(ctx.trace)
    return None if s is None else 100.0 * s
