"""The traffic generators' draws repeat for a seed and differ between
seeds."""

import numpy as np
import pytest
import torch

import draws
import spec
from conftest import small_cell

BIG = 2 ** 31 + 12345


@pytest.mark.parametrize('config', ['chip64', 'station_rb'])
def test_table_draws_repeat_for_a_seed_and_differ_between_seeds(config):
    cfg = spec.config(spec.benchmark(), config)
    a, b = draws.draw_table(cfg, BIG), draws.draw_table(cfg, BIG)
    c = draws.draw_table(cfg, BIG + 1)
    for kind in a:
        assert np.array_equal(a[kind].times, b[kind].times)
        assert np.array_equal(a[kind].amps, b[kind].amps)
        if a[kind].phases is not None:
            assert np.array_equal(a[kind].phases, b[kind].phases)
            assert not np.array_equal(a[kind].phases, c[kind].phases)
    assert any(not np.array_equal(a[k].times, c[k].times)
               or not np.array_equal(a[k].amps, c[k].amps) for k in a)


def test_draws_follow_the_configuration():
    cfg = spec.config(spec.benchmark(), 'station_rb')
    lines = draws.draw_table(cfg, 3)
    xy, z = lines['xy'], lines['z']
    assert list(xy.channels) == [0] and list(z.channels) == [1]
    assert xy.times.shape == z.times.shape == (8, 1, 10000)
    assert xy.stacked and z.stacked
    grid = 5.15e-7 + 3e-8 * np.arange(10000)
    assert np.allclose(xy.times[5, 0], grid) and np.allclose(z.times[2, 0],
                                                             grid)
    assert grid[-1] + 1.5e-8 <= cfg['duration_s']
    assert set(np.unique(xy.phases)) == set(np.arange(4) * np.pi / 2)
    assert set(np.unique(xy.amps)) == {0.25, 0.5}
    assert set(np.unique(z.amps)) == {-0.3, 0.3}
    chip = draws.draw_table(spec.config(spec.benchmark(), 'chip64'), 3)
    assert list(chip['xy'].channels[:3]) == [0, 2, 4]
    assert chip['xy'].freqs[1] == -1.5e8 - 2e6 * 2
    assert not chip['xy'].stacked and (chip['z'].amps == 0.3).all()


@pytest.mark.parametrize('cell', ['chip64.sweep', 'station_rb.chain'])
def test_index_pool_repeats_for_a_seed_and_differs_between_seeds(cell):
    cfg, mix, driver, _ = small_cell(cell)
    a = driver.Call(cfg, mix, BIG, 'cpu')
    b = driver.Call(cfg, mix, BIG, 'cpu')
    c = driver.Call(cfg, mix, BIG + 7, 'cpu')
    assert torch.equal(a.pool, b.pool)
    assert not torch.equal(a.pool, c.pool)
    assert int(a.pool.min()) >= 0 and int(a.pool.max()) < cfg['points']
    assert a.indices(3).shape == (mix['shots'],)


def test_seeds_beyond_32_bits_and_streams_are_independent():
    assert draws.torch_seed(2 ** 40 + 1, 'x') != draws.torch_seed(1, 'x')
    assert draws.torch_seed(5, 'a') != draws.torch_seed(5, 'b')
    assert 0 <= draws.torch_seed(2 ** 64 + 3, 'indices') < 2 ** 63


def test_hann_is_symmetric_with_unit_sum():
    h = draws.hann(31)
    assert h.shape == (31,) and np.isclose(h.sum(), 1.0)
    assert np.allclose(h, h[::-1]) and h[0] == 0.0 and h.argmax() == 15
