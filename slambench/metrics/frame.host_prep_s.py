"""frame.host_prep_s: the median over the window's passes of the
seconds a pass spends on each frame's host bookkeeping: the frames read
back and split (`frames_to_host`), the INS pose, the transforms, the
subsampling and the prior (`frame_prep`), the frame store and the
trajectory record (`frame_store`)."""

from slambench.lib.context import stage_seconds

STAGES = ('frames_to_host', 'frame_prep', 'frame_store')


def read(ctx):
    return stage_seconds(ctx, STAGES)
