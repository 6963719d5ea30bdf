"""Find a cell's pieces by name: nothing here names a cell, a configuration, a
mix or a metric, and a family only as the default.

- a cell is an entry of ``BENCHMARK.json``'s ``workloads``;
- its configuration is the file that ``configs`` gives for its name;
- the configuration's family is ``portbench/families/<family>.py``, named by
  the file's ``"family"`` key (``rf`` where it has none).  A family module
  gives ``make_forest(cfg, seed)``, the model's seeded arrays;
  ``Reference(forest, device, rows_dtype=torch.float32)`` with
  ``.scores(x) -> (scores (B, C), preds (B,))``, the plain reference that
  judges the answers; ``batch_bytes(cfg, rows)``, ``batch_ops(cfg, rows)``
  and ``bound_s(cfg, rows)``, its counted work; and ``program_model(forest)``,
  the model as the program's ``ForestIR.from_forest`` and
  ``ModelRegistry.register_forest`` take it;
- its traffic mix is ``portbench/traffic/<traffic>.json``, which names its
  driver, ``portbench/drivers/<driver>.py``: the client model.  A mix key that
  neither the generator (``portbench.traffic.KEYS``) nor that driver (its
  ``KEYS``) reads is refused;
- each metric is ``portbench/metrics/<name>.py``, a reader with
  ``read(records, cfg) -> float | None``.

A new family, configuration, mix, driver or metric is a new file and a new
entry; an unknown name fails loudly.
"""
from __future__ import annotations

import importlib.util
import json
import sys
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# the family of a configuration file without a "family" key
DEFAULT_FAMILY = "rf"


class UnknownName(KeyError):
    """A name that BENCHMARK.json or the benchmark's folders do not hold."""


@dataclass
class Cell:
    name: str
    chips: int
    cfg: dict
    family: object     # the configuration's family module
    mix: dict
    end_to_end: list   # metric entries this cell reports with --trace 0
    per_layer: list    # and with --trace 1


def load_module(path: Path, name: str):
    if not path.is_file():
        raise UnknownName(f"no file {path} for {name!r}")
    spec = importlib.util.spec_from_file_location(f"portbench_{path.parent.name}_{name}", path)
    module = importlib.util.module_from_spec(spec)
    # registered first, as an import does, so a dataclass in the file resolves its module
    sys.modules[spec.name] = module
    spec.loader.exec_module(module)
    return module


def _entry(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise UnknownName(f"{what} {name!r} is not in BENCHMARK.json "
                      f"(have {sorted(e['name'] for e in entries)})")


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def family(cfg: dict, root: Path = ROOT):
    """The family module of configuration ``cfg``."""
    name = cfg.get("family", DEFAULT_FAMILY)
    return load_module(root / "portbench" / "families" / f"{name}.py", name)


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    w = _entry(bench["workloads"], name, "workload")
    c = _entry(bench["configs"], w["config"], "configuration")
    if not (root / c["file"]).is_file():
        raise UnknownName(f"configuration {c['name']!r}: no file {root / c['file']}")
    cfg = json.loads((root / c["file"]).read_text())
    mix_path = root / "portbench" / "traffic" / f"{w['traffic']}.json"
    if not mix_path.is_file():
        raise UnknownName(f"traffic {w['traffic']!r}: no file {mix_path}")
    mix = json.loads(mix_path.read_text())
    return Cell(name=name, chips=int(w["chips"]), cfg=cfg, family=family(cfg, root),
                mix=mix, end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
                per_layer=[m for m in bench["per_layer"] if _applies(m, name)])


def driver(mix: dict, root: Path = ROOT):
    from portbench.traffic import KEYS

    module = load_module(root / "portbench" / "drivers" / f"{mix['driver']}.py", mix["driver"])
    unread = set(mix) - set(KEYS) - set(module.KEYS)
    if unread:
        raise UnknownName(f"mix keys {sorted(unread)}: neither the generator nor the driver "
                          f"{mix['driver']!r} reads them")
    return module


def reader(metric: str, root: Path = ROOT):
    return load_module(root / "portbench" / "metrics" / f"{metric}.py", metric)
