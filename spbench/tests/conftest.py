"""A small copy of the benchmark's data folders: the real configurations
cut to sizes a CPU test holds, each cell beside its full-size one, and a
CG mix of 12 iterations (a small grid's CG converges before 50)."""

import json
import os
import shutil

import pytest

from spbench import harness

SMALL = {"hpcg6": ("hpcg104", {"nx": 6, "ny": 5, "nz": 7}),
         "urand9": ("urand20", {"scale": 9})}
CELLS = {"urand9.spmv": ("urand20.spmv", "urand9", "spmv_stream"),
         "hpcg6.spmv": ("hpcg104.spmv", "hpcg6", "spmv_stream"),
         "hpcg6.cg": ("hpcg104.cg", "hpcg6", "cg_sets12")}


def make_small_root(path):
    for folder in ("configs", "generators", "traffic", "workloads",
                   "metrics", "layouts"):
        if os.path.isdir(f"{harness.ROOT}/{folder}"):
            shutil.copytree(f"{harness.ROOT}/{folder}", path / folder)
    for name, (base, sizes) in SMALL.items():
        cfg = harness.load_json("configs", base)
        cfg.update(sizes, name=name)
        (path / "configs" / f"{name}.json").write_text(json.dumps(cfg))
    mix = harness.load_json("traffic", "cg_sets")
    mix["iterations"] = 12
    (path / "traffic" / "cg_sets12.json").write_text(json.dumps(mix))
    for cell, (full, cfg, traffic) in CELLS.items():
        wl = harness.load_json("workloads", full)
        wl.update(config=cfg, traffic=traffic)
        (path / "workloads" / f"{cell}.json").write_text(json.dumps(wl))
    return path


@pytest.fixture
def small_root(tmp_path):
    return make_small_root(tmp_path)
