"""closure.propose_s: the median over the window's passes of the
seconds a pass spends proposing loop closures: the scan-context
descriptor of each new keyframe (`scan_context`), and each sweep's
candidates with their scans stacked and uploaded (`loop_propose`)."""

from slambench.lib.context import stage_seconds

STAGES = ('scan_context', 'loop_propose')


def read(ctx):
    return stage_seconds(ctx, STAGES)
