"""PyTorch + CUDA port of veloslam_tpu's bulk-odometry and device
full-SLAM paths and the batched user pipeline around them
(runtime.pipeline.SlamPipeline, apps.slam_run).

Mirrors the JAX package's module paths (``veloslam_tpu_torch.registration.
gicp`` answers to ``veloslam_tpu.registration.gicp``).  Imports torch and
nothing of jax or of the JAX package: the host pieces it needs (constants,
config, calibration tables, simulator, pcap and packet codecs, PoseTrack,
landmark association, ATE) are jax-free copies.
"""
