"""finalize.map_rebuild_s: the median over the window's passes of the
seconds a pass spends rebuilding the whole map from the keyframes at
their solved poses: StageTimers `map_rebuild` (inside `finalize`'s
`map_downdate`)."""

from slambench.lib.context import stage_seconds

STAGES = ('map_rebuild',)


def read(ctx):
    return stage_seconds(ctx, STAGES)
