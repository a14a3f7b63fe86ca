"""Drive generator: a frozen copy of the port's `io/simulate.py` in torch
(float64 on the card), the packet and file encoders, the sensor
calibrations and the seeded placement of each drive."""
