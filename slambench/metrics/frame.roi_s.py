"""frame.roi_s: the median over the window's passes of the seconds a
pass spends assembling each frame's registration target from the map's
tiles on the host and uploading it: StageTimers `roi` (outside
`register`)."""

from slambench.lib.context import stage_seconds

STAGES = ('roi',)


def read(ctx):
    return stage_seconds(ctx, STAGES)
