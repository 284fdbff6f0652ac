"""A run with the timed path broken underneath comes out not correct, and
the lower-precision control fails the limits.

The harness is driven past its look for a card, on the CPU at a small
size, with each fault these cells can have planted where the output is
produced: an answer altered (one sample, one code or one IQ point) and
half of the batch left out.  (A step that returns its state unchanged and
a missing exchange between chips are training's and the mesh's faults;
no cell here has them.)"""

import time

import pytest
import torch

import control
import harness
from conftest import small_cell

CELLS = ['chip64.sweep', 'station_rb.chain', 'chip64.predistort',
         'station_rb.upload']


def altered(out):
    """One answer altered where it is produced."""
    out = out.clone()
    flat = out.view(-1)
    if out.dtype == torch.int16:
        flat[flat.numel() // 3] += 2
    else:
        flat[flat.numel() // 3] += 1e-3 * out.abs().max()
    return out


def half_left_out(out):
    """Half of the batch left out: the shots (or channels) of the second
    half never produced."""
    out = out.clone()
    out[out.shape[0] // 2:] = 0
    return out


def run(cell, fault=None, monkeypatch=None):
    cfg, mix, driver, limits = small_cell(cell)
    if fault is not None:
        issue = driver.Call.issue
        monkeypatch.setattr(driver.Call, 'issue',
                            lambda self, i, span: fault(issue(self, i, span)))
    return harness.run_cell(cell, cfg, mix, driver, limits, 2 ** 31 + 3,
                            0.3, False, 'cpu', time.perf_counter())


@pytest.mark.parametrize('cell', CELLS)
def test_sound_run_is_correct(cell):
    r = run(cell)
    assert r['correct'] and r['failed'] == 0 and r['attempted'] >= 1
    assert list(r)[-1] == 'checks'


@pytest.mark.parametrize('fault', [altered, half_left_out])
@pytest.mark.parametrize('cell', CELLS)
def test_broken_path_is_not_correct(cell, fault, monkeypatch):
    r = run(cell, fault, monkeypatch)
    assert not r['correct'] and r['failed'] >= 1


@pytest.mark.parametrize('cell', CELLS)
def test_control_fails_the_limit(cell):
    cfg, mix, driver, limits = small_cell(cell)
    program, ctrl = control.readings(cfg, mix, driver, 17, 0.2, 'cpu')
    for name, spec in limits.items():
        assert program[name] <= spec['limit'] < ctrl[name]
