"""The work a kernel's inputs need, counted from their shapes and hit
counts, whatever implements it.

Normal equations of one Gauss-Newton iteration (`gn_iteration` /
`fused_normal_equations`) over F slots of P points: every point's hit
flag is read (1 byte); a point with a hit also needs its p, mu and n
(3 x 3 float32) and costs the linearisation: p' = Rp + t (18), the
residual (8), the Huber weight (4), J = [p' x n | n] (9), the 21 upper
entries of w J J^T (a product, a multiply by w and an add each: 63), b
(12) and the error and weight sums (4).  Per slot the
pose in (7 float32) and the outputs H, b, err, n_hit and, for the step,
the new pose and its flag (36 + 6 + 2 + 1 + 7 + 1 words) are written
once.  The hit count used is the kernel's own output `n_hit` (the hits
that pass the distance gate), so the count is a floor of the work.
"""

from __future__ import annotations

FLAG_BYTES = 1
HIT_BYTES = 3 * 3 * 4
FLOPS_PER_HIT = 18 + 8 + 4 + 9 + 63 + 12 + 4
SLOT_BYTES = (7 + 36 + 6 + 2 + 1 + 7 + 1) * 4


def ne_bytes(F: int, P: int, hits: int) -> int:
    return F * P * FLAG_BYTES + hits * HIT_BYTES + F * SLOT_BYTES


def ne_flops(hits: int) -> int:
    return hits * FLOPS_PER_HIT
