"""frame.register_s: the median over the window's passes of the seconds
a pass spends registering frames to the map (GICP, the NE kernel):
StageTimers `register`."""

from slambench.lib.context import stage_seconds

STAGES = ('register',)


def read(ctx):
    return stage_seconds(ctx, STAGES)
