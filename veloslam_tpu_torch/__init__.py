"""PyTorch + CUDA port of veloslam_tpu on one card: the odometry paths,
device full SLAM, the user pipeline around them (runtime.pipeline.
SlamPipeline: batched and per frame from a pcap, live over UDP), and the
tools (apps.slam_run, apps.replay, apps.inspect).

Mirrors the JAX package's module paths (``veloslam_tpu_torch.registration.
gicp`` answers to ``veloslam_tpu.registration.gicp``).  Imports torch and
nothing of jax or of the JAX package: the host pieces it needs (constants,
config, calibration tables, simulator, pcap and packet codecs, PoseTrack,
landmark association, ATE, the packet pump's C++ source) are jax-free
copies.
"""
