"""frame.frontend_s: the median over the window's passes of the seconds
a pass spends decoding packets, compensating the frames' motion and
assembling them: StageTimers `decode` + `compensate` + `assemble`."""

from slambench.lib.context import stage_seconds

STAGES = ('decode', 'compensate', 'assemble')


def read(ctx):
    return stage_seconds(ctx, STAGES)
