"""frame.map_update_s: the median over the window's passes of the
seconds a pass spends adding keyframes to the map while it runs:
StageTimers `map_update`."""

from slambench.lib.context import stage_seconds

STAGES = ('map_update',)


def read(ctx):
    return stage_seconds(ctx, STAGES)
