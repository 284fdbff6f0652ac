"""BENCHMARK.json keeps to the benchmark's contract, and every cell
resolves to its configuration, traffic mix, call driver, limits and
metric files by name."""

import json
import re
from pathlib import Path

import pytest

import spec

NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
TEXT = re.compile(r'^[^\t\n\r]{1,200}$')
BENCH = spec.benchmark()
CELLS = [w['name'] for w in BENCH['workloads']]


def test_top_level_keys_and_command():
    assert set(BENCH) == {'command', 'paths', 'run_seconds', 'configs',
                          'workloads', 'end_to_end', 'per_layer'}
    assert BENCH['command'] == ['python3', 'portbench/run.py']
    assert BENCH['paths'] == ['portbench']
    assert 1 <= BENCH['run_seconds'] <= 51
    raw = (spec.CHECKOUT / 'BENCHMARK.json').read_bytes()
    assert len(raw) <= 64 * 1024


def test_names_units_and_texts_use_only_allowed_characters():
    names = []
    for group in ('configs', 'workloads', 'end_to_end', 'per_layer'):
        for e in BENCH[group]:
            assert NAME.match(e['name']), e['name']
            names.append((group, e['name']))
            for key in ('why', 'layer', 'source'):
                if key in e and group != 'end_to_end':
                    assert TEXT.match(e[key]), (e['name'], key)
    for group in ('configs', 'workloads', 'end_to_end', 'per_layer'):
        group_names = [e['name'] for e in BENCH[group]]
        assert len(group_names) == len(set(group_names))
    for m in BENCH['end_to_end'] + BENCH['per_layer']:
        assert UNIT.match(m['unit']) and m['better'] in ('lower', 'higher')
    for w in BENCH['workloads']:
        assert NAME.match(w['config']) and NAME.match(w['traffic'])
        assert w['chips'] == 1


def test_metric_entries():
    e2e = {m['name'] for m in BENCH['end_to_end']}
    assert 'setup_s' in e2e
    for cell in CELLS:
        reported = {m['name'] for m in spec.metrics_of(BENCH, cell,
                                                       'end_to_end')}
        assert {'gsps', 'setup_s'} <= reported <= {'gsps', 'call_p95_ms',
                                                   'setup_s'}
        for m in spec.metrics_of(BENCH, cell, 'per_layer'):
            assert m['moves'] in reported, (cell, m['name'])
    for m in BENCH['end_to_end']:
        assert set(m) <= {'name', 'unit', 'better', 'bound', 'source',
                          'workloads'}
        assert m['source'] in ('host_clock', 'device_trace')
        assert 0.01 <= m['bound'] <= 0.25
    for m in BENCH['per_layer']:
        assert set(m) <= {'name', 'unit', 'better', 'source', 'layer',
                          'moves', 'workloads'}
        assert m['moves'] in e2e
        assert set(m.get('workloads', CELLS)) <= set(CELLS)
        if 'roofline' in m['name']:
            assert m['name'].endswith('_roofline')
            assert m['unit'] == '%'


@pytest.mark.parametrize('cell', CELLS)
def test_cell_resolves_by_name(cell):
    wl = spec.workload(BENCH, cell)
    cfg = spec.config(BENCH, wl['config'])
    assert cfg['name'] == wl['config']
    mix = spec.traffic(wl['traffic'])
    assert hasattr(spec.call_driver(mix), 'Call')
    limits = spec.limits(cell)
    assert limits and all('limit' in v for v in limits.values())
    reported = spec.metrics_of(BENCH, cell, 'per_layer')
    assert reported, cell
    for m in reported:
        assert hasattr(spec.metric_reader(m['name']), 'read')


def test_config_files_lie_under_paths_and_are_distinct():
    files = [c['file'] for c in BENCH['configs']]
    assert len(set(files)) == len(files)
    for f in files:
        assert f.startswith('portbench/') and (spec.CHECKOUT / f).is_file()
        assert json.loads((spec.CHECKOUT / f).read_text())['assumed']


def test_every_file_is_named_from_name_characters():
    for path in Path(spec.HERE).rglob('*'):
        if '__pycache__' in path.parts or path.is_dir():
            continue
        rel = path.relative_to(spec.CHECKOUT).as_posix()
        assert re.match(r'^[A-Za-z0-9_./-]+$', rel), rel
