"""sync.wait_s: the median over the window's passes of the seconds a
pass's host spends blocked on the card: the seconds of its `sync.*`
spans."""

from slambench.lib import passes


def read(ctx):
    return passes.per_pass(ctx, lambda p, _s: passes.syncs(p["timing"])[1])
