"""closure.map_reintegrate_s: the median over the window's passes of
the seconds a pass spends re-integrating the moved keyframes into the
map after each accepted closure sweep's solve: StageTimers
`map_reintegrate` (inside `map_downdate`)."""

from slambench.lib.context import stage_seconds

STAGES = ('map_reintegrate',)


def read(ctx):
    return stage_seconds(ctx, STAGES)
