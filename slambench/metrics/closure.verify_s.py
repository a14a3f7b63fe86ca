"""closure.verify_s: the median over the window's passes of the seconds
a pass spends proposing and verifying loop closures: StageTimers
`loop_verify`."""

from slambench.lib.context import stage_seconds

STAGES = ('loop_verify',)


def read(ctx):
    return stage_seconds(ctx, STAGES)
