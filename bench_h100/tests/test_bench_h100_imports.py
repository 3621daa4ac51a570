"""The benchmark loads neither JAX nor the JAX package ``l2hmc_tpu``
(whole top-level names: the port ``l2hmc_tpu_torch`` is allowed), and its
data files keep to the names and units ``BENCHMARK.json`` allows."""

import json
import re
import subprocess
import sys

import pytest

from bench_h100.lib import common

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")

IMPORT_ALL = r"""
import sys
sys.path.insert(0, {root!r})
import importlib
from bench_h100.lib import common
import bench_h100.run
for kind in ("drivers", "metrics", "counts"):
    for f in sorted((common.BENCH / kind).glob("*.py")):
        if f.stem != "__init__":
            common.load_module(kind, f.stem)
for m in ("chains", "judge", "lattice", "philox"):
    importlib.import_module("bench_h100.reference." + m)
import bench_h100.control
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""


def test_no_jax_loaded():
    out = subprocess.run(
        [sys.executable, "-c", IMPORT_ALL.format(root=str(common.ROOT))],
        capture_output=True, text=True, check=True).stdout
    loaded = set(json.loads(out.strip().splitlines()[-1].replace("'", '"')))
    assert not loaded & set(common.FORBIDDEN), loaded & set(common.FORBIDDEN)


def test_references_import_nothing_of_the_port():
    for f in (common.BENCH / "reference").glob("*.py"):
        assert "l2hmc_tpu" not in f.read_text(), f.name


def test_forbidden_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "l2hmc_tpu_torch_fake", object())
    assert "l2hmc_tpu" not in common.forbidden_modules()
    monkeypatch.setitem(sys.modules, "l2hmc_tpu.ops", object())
    assert common.forbidden_modules() == ["l2hmc_tpu"]


def data(kind):
    return sorted((common.BENCH / kind).glob("*.json"))


@pytest.mark.parametrize("path", data("workloads") + data("configs")
                         + data("traffic"), ids=lambda p: p.name)
def test_data_files_load_with_allowed_names(path):
    d = json.loads(path.read_text())
    assert NAME.match(path.stem)
    for key in d.get("reduced", []):
        assert NAME.match(key)
    if path.parent.name == "workloads":
        assert d["chips"] in (1, 4)
        assert common.load_json("configs", d["config"])
        traffic = common.load_json("traffic", d["traffic"])
        assert (common.BENCH / "drivers" / f"{traffic['driver']}.py").exists()
        assert d["limits"] and all(v >= 0 for v in d["limits"].values())


def test_benchmark_json_names_units_and_files():
    spec = common.benchmark()
    cells = {w["name"] for w in spec["workloads"]}
    for entry in spec["configs"] + spec["workloads"]:
        assert NAME.match(entry["name"])
    for w in spec["workloads"]:
        assert (common.BENCH / "workloads" / f"{w['name']}.json").exists()
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert set(m.get("workloads", cells)) <= cells
    for m in spec["per_layer"]:
        assert (common.BENCH / "metrics" / f"{m['name']}.py").exists()
    for c in spec["configs"]:
        assert (common.ROOT / c["file"]).exists()
        assert (common.BENCH / "counts" / f"{c['name']}.py").exists()
