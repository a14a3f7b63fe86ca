"""PyTorch + CUDA port of veloslam_tpu's bulk-odometry path.

Mirrors the JAX package's module paths (``veloslam_tpu_torch.registration.
gicp`` answers to ``veloslam_tpu.registration.gicp``).  Imports torch and
nothing of jax or of the JAX package: the host pieces it needs (constants,
calibration tables, simulator, PoseTrack, ATE) are jax-free copies.
"""
