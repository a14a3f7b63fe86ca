"""Sensor and packet constants for Velodyne HDL-class LiDARs.

A copy of the values of veloslam_tpu/constants.py that the port uses, so
that importing the port loads nothing of the JAX package (its package
__init__ runs on any `veloslam_tpu.*` import).  tests/test_torch_host.py
holds every value here equal to the original.
"""

# --- HDL data packet layout --------------------------------------------------
HDL_PACKET_BYTES = 1206          # payload size of one LiDAR data packet
HDL_FIRINGS_PER_PACKET = 12      # firing blocks per packet
HDL_LASERS_PER_FIRING = 32       # laser returns per firing block
HDL_FIRING_BYTES = 100           # 2 (block id) + 2 (azimuth) + 32 * 3
POSITION_PACKET_BYTES = 512      # GPS/position packet payload (554 - 42)

# UDP ports (a pcap's canned headers name them).
LIDAR_DATA_PORT = 2368
LIDAR_POSITION_PORT = 8308

# Firing-block identifiers.
BLOCK_ID_0_TO_31 = 0xEEFF
BLOCK_ID_32_TO_63 = 0xDDFF

# Azimuth is reported in hundredths of a degree, [0, 36000).
AZIMUTH_TICKS_PER_REV = 36000
AZIMUTH_TICKS_PER_DEG = 100.0

# Distance is reported in 2 mm units.
DISTANCE_UNIT_M = 0.002

# Maximum firings per revolution; also bounds points-per-laser per frame.
MAX_FIRINGS_PER_FRAME = 2200

# --- Intra-frame timing models (µs) ------------------------------------------
HDL32_FIRING_BLOCK_US = 46.08    # per firing block
HDL32_LASER_US = 1.152           # per laser within a block
VLP16_FIRING_BLOCK_US = 110.592  # per block (two 16-laser sub-firings)
VLP16_LASER_US = 2.304
VLP16_SUBFIRING_US = 55.296

INS_PERIOD_MS = 10               # INSPVA at 100 Hz

ROI_RANGE_M = 100.0              # sensor detecting range for map ROI queries
