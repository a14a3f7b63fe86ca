"""pass.untraced_s: the median over the window's passes of the seconds
of a pass in no program span: the pass's seconds (the harness's `pass`
span) less the own seconds of every StageTimers stage."""

from slambench.lib import passes


def _value(p, pass_s):
    if pass_s is None:
        return None
    return pass_s - passes.own_seconds(p["timing"])


def read(ctx):
    return passes.per_pass(ctx, _value)
