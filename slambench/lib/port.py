"""The port's engine configuration of a cell: the configuration's
`engine` (a `SlamConfig` as `dataclasses.asdict` writes it), with the
sensor's db.xml where the drive has one, and the traffic's overrides."""

from __future__ import annotations

import copy
from typing import Optional


def engine_config(config: dict, calibration_path: Optional[str],
                  overrides: Optional[dict] = None):
    from veloslam_tpu_torch.config import SlamConfig
    eng = copy.deepcopy(config["engine"])
    eng["sensor"]["calibration_path"] = calibration_path
    for group, values in (overrides or {}).items():
        eng[group].update(values)
    return SlamConfig.from_dict(eng)


def sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
