"""BENCHMARK.json against the benchmark's contract: names, units, keys,
files, and the metrics each cell reports."""
import json
import re

import pytest

from perfbench import harness

NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
REG = harness.Registry()
BENCH = REG.benchmark()


def _line(text):
    return 1 <= len(text) <= 200 and '\n' not in text and '\t' not in text


def test_top_level_keys():
    assert set(BENCH) == {'command', 'paths', 'run_seconds', 'configs', 'workloads',
                          'end_to_end', 'per_layer'}
    assert BENCH['paths'] == ['perfbench'] and 1 <= BENCH['run_seconds'] <= 51
    assert len(BENCH['command']) <= 32 and all(_line(w) for w in BENCH['command'])
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize('section', ['configs', 'workloads', 'end_to_end', 'per_layer'])
def test_names_and_units(section):
    names = [e['name'] for e in BENCH[section]]
    assert len(names) == len(set(names))
    for e in BENCH[section]:
        assert NAME.match(e['name']), e['name']
        if 'unit' in e:
            assert UNIT.match(e['unit']), e['unit']
            assert e['better'] in ('lower', 'higher')
        for key in ('why', 'layer', 'source'):
            if key in e and section != 'end_to_end' and section != 'per_layer':
                assert _line(e[key])
        if section == 'per_layer':
            assert _line(e['layer'])


def test_entries_have_the_contracts_keys():
    for c in BENCH['configs']:
        assert set(c) == {'name', 'source', 'file', 'reduced', 'why'}
        assert c['file'].startswith('perfbench/') and len(c['reduced']) <= 16
    for w in BENCH['workloads']:
        assert set(w) == {'name', 'config', 'traffic', 'chips', 'why'} and w['chips'] in (1, 4)
        assert NAME.match(w['config']) and NAME.match(w['traffic']) and _line(w['why'])
    for m in BENCH['end_to_end']:
        assert set(m) - {'workloads'} == {'name', 'unit', 'better', 'bound', 'source'}
        assert m['source'] in ('host_clock', 'device_trace') and 0.01 <= m['bound'] <= 0.25
    for m in BENCH['per_layer']:
        assert set(m) - {'workloads'} == {'name', 'unit', 'better', 'source', 'layer', 'moves'}
        assert m['source'] in ('device_trace', 'program_span', 'program_counter', 'host_clock')


def test_files_match_the_entries():
    configs = {c['name']: c for c in BENCH['configs']}
    for w in BENCH['workloads']:
        cell = REG.cell(w['name'])
        for key in ('config', 'traffic', 'chips', 'why'):
            assert cell[key] == w[key], (w['name'], key)
        assert (REG.root / 'traffic' / f'{cell["kind"]}.py').exists()
        assert REG.config(w['config'])['name'] == w['config'] in configs
    for m in BENCH['per_layer']:
        assert (REG.root / 'metrics' / f'{m["name"]}.py').exists(), m['name']
    used = {w['config'] for w in BENCH['workloads']}
    assert used == set(configs)


def test_every_cell_reports_what_its_metrics_move():
    e2e = {m['name']: m for m in BENCH['end_to_end']}
    assert 'setup_s' in e2e and e2e['setup_s'].get('workloads') is None
    for w in BENCH['workloads']:
        reported = {m['name'] for m in REG.metrics_for(w['name'], 'end_to_end')}
        layers = REG.metrics_for(w['name'], 'per_layer')
        assert len(reported) >= 2 and layers, w['name']
        for m in layers:
            assert m['moves'] in reported, (w['name'], m['name'])


def test_layers_are_named_alike():
    layers = {m['layer'] for m in BENCH['per_layer']}
    assert all(_line(layer) for layer in layers)
    for m in BENCH['per_layer']:
        if m['name'].endswith('_roofline') or 'mfu' in m['name']:
            assert m['unit'] == '%'
