"""Multi-device execution on torch.distributed: rank mesh, collectives,
map-sharded and halo registration, data-parallel decode, edge-sharded
graph solves and the distributed SLAM session."""
