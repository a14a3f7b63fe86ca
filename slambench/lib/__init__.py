"""The harness's own pieces: the registry of configurations, cells,
entries and metrics, the spans, the trace reduction, the table of peaks
and the counts of the kernels' work."""
