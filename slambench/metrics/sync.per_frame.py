"""sync.per_frame: the median over the window's passes of a pass's
host-card synchronizations per frame: the count of its `sync.*` spans
over its frames."""

from slambench.lib import passes


def _value(p, _pass_s):
    if not p.get("n_frames"):
        return None
    return passes.syncs(p["timing"])[0] / p["n_frames"]


def read(ctx):
    return passes.per_pass(ctx, _value)
