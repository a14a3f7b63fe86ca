"""A cell's drive, made from the seed: the configuration's world and
path, simulated on the card for the traffic's length with the seed's
range noise, and written as the user's files
(pcap, INS log, and the sensor's db.xml where the configuration has a
per-unit calibration)."""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional

import numpy as np

from slambench.gen import drive as gdrive
from slambench.gen import files, scene
from slambench.gen import sensor as S


@dataclasses.dataclass
class DriveFiles:
    paths: Dict[str, str]
    drive: gdrive.Drive
    ins: Dict[str, np.ndarray]
    path: scene.Circle
    world: scene.World
    t0_us: int
    calibration_path: Optional[str]


def recipe(config: dict, seed: int):
    """(world, path, calibration) of the configuration at this seed."""
    d = config["drive"]
    w = d["world"]
    world = scene.World.demo(w["seed"], extent=w["extent"],
                             n_posts=w["n_posts"], n_walls=w["n_walls"])
    p = d["path"]
    path = scene.Circle(p["radius_m"], p["speed_m_per_s"], z=p["height_m"])
    sensor = config["sensor"]
    calib = None
    uc = sensor.get("unit_calibration")
    if uc:
        calib = S.unit_calib(sensor["model"], seed, uc["rot_sd_deg"],
                             uc["vert_sd_deg"])
    return world, path, calib


def make(config: dict, seconds: float, seed: int, device, out_dir: str,
         packet_multiple: int = 1) -> DriveFiles:
    """The drive of `seconds`, its packets cut to a multiple of
    `packet_multiple`."""
    world, path, calib = recipe(config, seed)
    model = config["sensor"]["model"]
    drv = gdrive.generate(seconds, model, world, path, calib=calib,
                          rpm=config["sensor"]["rpm"], device=device,
                          noise_std=config["sensor"]["range_noise_m"],
                          seed=seed)
    n = len(drv.packets) - len(drv.packets) % packet_multiple
    drv.packets, drv.pkt_times_us = drv.packets[:n], drv.pkt_times_us[:n]
    paths, ins = files.write_drive(
        drv, out_dir, config["drive"]["ins_drift_m_per_s"])
    cal_path = None
    if calib is not None:
        cal_path = os.path.join(out_dir, "db.xml")
        S.write_db_xml(calib, cal_path)
    return DriveFiles(paths, drv, ins, path, world, int(drv.ins_t_us[0]),
                      cal_path)
