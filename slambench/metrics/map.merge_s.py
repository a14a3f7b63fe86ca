"""map.merge_s: the median over the window's passes of the seconds a
pass spends merging scans into the map's tiles: StageTimers `map_merge`
(one a tile merge, inside `map_update`, `map_reintegrate` and
`map_rebuild`)."""

from slambench.lib.context import stage_seconds

STAGES = ('map_merge',)


def read(ctx):
    return stage_seconds(ctx, STAGES)
