"""On the card: each cell at a small size through the harness, correct,
with every metric it reports; and the control failing its limits.  Marked
``cuda``; skipped where torch sees no card (``python -m pytest
portbench/tests -m cuda`` on the GPU machine)."""

import time

import pytest

import control
import harness
import spec
from conftest import small_cell

CELLS = [w['name'] for w in spec.benchmark()['workloads']]


@pytest.mark.cuda
@pytest.mark.parametrize('cell', CELLS)
def test_cell_on_the_card(cell, card):
    cfg, mix, driver, limits = small_cell(cell)
    names = [m['name'] for m in spec.metrics_of(spec.benchmark(), cell,
                                                  'end_to_end')]
    r = harness.run_cell(cell, cfg, mix, driver, limits, 2 ** 31 + 11, 0.5,
                         False, str(card), time.perf_counter(),
                         end_to_end_names=names)
    assert r['correct'] and r['device']['platform'] == 'gpu'
    assert set(r['metrics']) == set(names)


@pytest.mark.cuda
@pytest.mark.parametrize('cell', CELLS)
def test_control_on_the_card(cell, card):
    cfg, mix, driver, limits = small_cell(cell)
    program, ctrl = control.readings(cfg, mix, driver, 23, 0.3,
                                     str(card))
    for name, spec_ in limits.items():
        assert program[name] <= spec_['limit'] < ctrl[name]
