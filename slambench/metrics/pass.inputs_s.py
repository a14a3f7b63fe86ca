"""pass.inputs_s: the median over the window's passes of the seconds
a pass spends reading its inputs (the INS log, the pcap's LiDAR packets,
the GPS grounding from its position packets, the tail padding):
StageTimers `read_inputs`."""

from slambench.lib.context import stage_seconds

STAGES = ('read_inputs',)


def read(ctx):
    return stage_seconds(ctx, STAGES)
