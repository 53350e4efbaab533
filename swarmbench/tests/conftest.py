"""Tiny cells on the CPU: a copy of the harness's data files with the
routes and clouds cut down, so a run takes seconds."""

import json
import shutil
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
# route lengths and cloud capacity of the tiny cells
# the tiny clouds (1024 points) register to a few tenths of a metre, no
# closer than an identity on this route, so the tiny lidar cell judges
# no registration against the truth (revisit_gate_m 0); a card test
# judges it at the cell's size
TINY = {"kitti00-5r-sim512": {"route_length_m": 1000.0},
        "kitti00-2r-lidar": {"route_length_m": 500.0, "capacity": 1024,
                             "start_offset_m": [56.0, 0.0],
                             "revisit_gate_m": 0.0}}
# the tiny lidar cell detects every second of mission time, so a few
# seconds on the CPU hold registrations
TINY_PERIODS = {"kitti00-2r-lidar": {"inter_robot_detection": 1.0}}
# cells whose traffic files are kept for a later benchmark but that
# BENCHMARK.json does not list yet: the tiny copies list them
HELD_CELLS = [{"name": "lidar2r.revisit", "config": "kitti00-2r-lidar",
               "traffic": "lidar2r.revisit", "chips": 1,
               "why": "the lidar loops touching"},
              {"name": "sim5r.explore", "config": "kitti00-5r-sim512",
               "traffic": "sim5r.explore", "chips": 1,
               "why": "the sim loops apart"},
              {"name": "lidar2r.explore", "config": "kitti00-2r-lidar",
               "traffic": "lidar2r.explore", "chips": 1,
               "why": "the lidar loops apart"}]


def tiny_root(dest: Path, tiny: bool = True) -> Path:
    """A checkout-like directory: BENCHMARK.json (with the held cells)
    and swarmbench/ data files, with every configuration cut to a tiny
    size (`tiny`) or as it is."""
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    listed = {w["name"] for w in bench["workloads"]}
    bench["workloads"] += [c for c in HELD_CELLS if c["name"] not in listed]
    (dest / "BENCHMARK.json").write_text(json.dumps(bench))
    shutil.copytree(REPO / "swarmbench", dest / "swarmbench",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    for name, over in (TINY if tiny else {}).items():
        path = dest / "swarmbench" / "configs" / f"{name}.json"
        cfg = json.loads(path.read_text())
        cfg.update(over)
        cfg["periods_s"].update(TINY_PERIODS.get(name, {}))
        path.write_text(json.dumps(cfg))
    return dest


@pytest.fixture
def root(tmp_path):
    torch.set_num_threads(2)
    return tiny_root(tmp_path)


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
