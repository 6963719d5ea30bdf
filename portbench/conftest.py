"""Set-up shared by the benchmark's tests.

``test_portbench_units.py`` keys two configuration files by name in its
module-level ``CFGS``, and its ``test_an_unknown_name_fails_loudly[family]``
looks up there every configuration that ``BENCHMARK.json`` lists.  Until that
module reads ``CFGS`` from ``BENCHMARK.json`` itself, the fixture below adds
each listed configuration it lacks, read from its own file.  It touches no
other module."""
from __future__ import annotations

import json
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def units_cfgs_name_every_configuration(request):
    if request.module.__name__.rpartition(".")[2] != "test_portbench_units":
        return
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        request.module.CFGS.setdefault(c["name"], json.loads((ROOT / c["file"]).read_text()))
