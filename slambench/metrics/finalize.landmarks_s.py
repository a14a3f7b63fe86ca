"""finalize.landmarks_s: the median over the window's passes of the
seconds a pass spends in landmark extraction and association:
StageTimers `landmarks`."""

from slambench.lib.context import stage_seconds

STAGES = ('landmarks',)


def read(ctx):
    return stage_seconds(ctx, STAGES)
