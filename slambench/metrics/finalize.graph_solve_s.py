"""finalize.graph_solve_s: the median over the window's passes of the
seconds a pass spends in the graph solves (in the run after accepted
closures, and in `finalize`): StageTimers `graph_solve`."""

from slambench.lib.context import stage_seconds

STAGES = ('graph_solve',)


def read(ctx):
    return stage_seconds(ctx, STAGES)
