"""finalize.map_s: the median over the window's passes of the seconds a
pass spends rebuilding the tiled map from the keyframes at their solved
poses, after each solve (in the run after accepted closures, and in
`finalize`): StageTimers `map_build` + `map_downdate`."""

from slambench.lib.context import stage_seconds

STAGES = ('map_build', 'map_downdate')


def read(ctx):
    return stage_seconds(ctx, STAGES)
