"""Where the harness finds a cell's parts: everything by the name that
``BENCHMARK.json`` gives it.

* a configuration: the ``file`` of its entry in ``configs``;
* a traffic mix: ``traffic/<name>.json``, whose ``call`` names the call
  driver ``calls/<call>.py``;
* a per-layer metric: ``metrics/<name>.py`` (a ``read(ctx)`` function);
* a cell's correctness limits: ``limits/<cell>.json``.

Adding a cell, a mix or a metric is adding files and entries; no table of
names lives in the code.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent


def benchmark() -> dict:
    with open(CHECKOUT / 'BENCHMARK.json') as f:
        return json.load(f)


def _named(entries, name, what):
    for e in entries:
        if e['name'] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def workload(bench: dict, name: str) -> dict:
    return _named(bench['workloads'], name, 'workload')


def config(bench: dict, name: str) -> dict:
    with open(CHECKOUT / _named(bench['configs'], name, 'config')['file']) as f:
        return json.load(f)


def traffic(name: str) -> dict:
    with open(HERE / 'traffic' / f'{name}.json') as f:
        return json.load(f)


def limits(cell: str) -> dict:
    with open(HERE / 'limits' / f'{cell}.json') as f:
        return json.load(f)


def load(path: Path, name: str):
    """A module from a file of the benchmark (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def call_driver(mix: dict):
    return load(HERE / 'calls' / f"{mix['call']}.py",
                f"portbench_call_{mix['call']}")


def metric_reader(name: str):
    return load(HERE / 'metrics' / f'{name}.py', f'portbench_metric_{name}')


def metrics_of(bench: dict, cell: str, group: str) -> list[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics that ``cell`` reports:
    each whose ``workloads`` lists it, or that has no ``workloads``."""
    return [m for m in bench[group]
            if cell in m.get('workloads', [cell])]
