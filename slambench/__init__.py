"""The port's benchmark: full-SLAM drive replay of the LiDAR SLAM engine in `veloslam_tpu_torch`, run as `python3 slambench/run.py`.

Nothing here imports `jax` or the JAX package `veloslam_tpu`; only the
entries (`slambench/entries/`) import the port, and the reference
(`slambench/reference/`) imports nothing of either.
"""
