"""Whole runs of each traffic kind on the CPU at a tiny size, with the card's
look skipped: the program against the plain reference, each fault the cell
can have planted under the timed path (correct comes out false), the
control's readings, and a cell, configuration and metric dropped into a
copy of the folder without an edit."""
import json
import shutil

import pytest

from perfbench import harness
from perfbench.tests import tiny

REG = harness.Registry()
CELLS = {'char-train': None, 'bpe-train': (38, 60), 'char-transcribe': None,
         'char-stream': None}


def _run(cell, seconds=1.5, trace=False, registry=REG, **options):
    classes = CELLS.get(cell)
    name = tiny.cell(cell)['config']
    return harness.run_cell(registry, cell, 2 ** 31 + 17, seconds, trace, 'cpu',
                            config=tiny.config(name, classes=classes), cell=tiny.cell(cell),
                            options=options)


@pytest.mark.parametrize('cell', sorted(CELLS))
def test_the_program_matches_the_reference(cell):
    result = _run(cell, trace=True)
    assert result['correct'], result['checks']
    assert result['attempted'] > 0 and result['failed'] == 0
    for c in result['checks'].values():
        assert c['value'] < 1e-2 * c['limit'] + 1e-4
    assert json.loads(json.dumps(result))['breakdown']['idle_gaps']


@pytest.mark.parametrize('cell,fault', [
    ('char-train', 'stale_state'), ('char-train', 'half_batch'),
    ('char-transcribe', 'alter_token'), ('char-stream', 'alter_token')])
def test_a_fault_under_the_timed_path_is_not_correct(cell, fault):
    result = _run(cell, fault=fault)
    assert not result['correct'], result['checks']


@pytest.mark.parametrize('cell', ['char-train', 'bpe-train', 'char-transcribe'])
def test_the_control_is_not_correct(cell):
    """The reference in the program's place, in fp8 (the precision below the
    configuration's bf16), fails one of the cell's limits; the program in
    bf16 reads below it."""
    run = harness.Run(cell, tiny.cell(cell), tiny.config(REG.cell(cell)['config'], 'bfloat16',
                                                          CELLS[cell]), 5, 1.0, False, 'cpu',
                      dict(control='fp8', no_warmup=True))
    session = REG.kind(run.cell['kind']).setup(run)
    session.window(run, 0.5)
    session.check(run)
    limits = run.cell['params']['limits']
    prog, control = run.values['readings'], run.values['control_readings']
    assert any(control[k] > v for k, v in limits.items()), (control, limits)
    assert max(control[k] / max(prog[k], 1e-12) for k in limits) > 2.0, (prog, control)


def test_a_dropped_in_cell_config_and_metric_need_no_edit(tmp_path):
    root = tmp_path / 'perfbench'
    shutil.copytree(REG.root, root, ignore=shutil.ignore_patterns('__pycache__'))
    bench = REG.benchmark()
    cell = tiny.cell('char-train')
    cell['config'] = 'tiny_char'
    (root / 'cells' / 'tiny-train.json').write_text(json.dumps(cell))
    config = tiny.config()
    config['name'] = 'tiny_char'
    (root / 'configs' / 'tiny_char.json').write_text(json.dumps(config))
    (root / 'metrics' / 'steps_per_s.tiny.py').write_text(
        'def read(run):\n'
        '    v = run.values\n'
        '    return v["steps"] / v["window_s"] if v.get("kind") == "train" else None\n')
    bench['workloads'].append(dict(name='tiny-train', config='tiny_char', traffic=cell['traffic'],
                                   chips=1, why=cell['why']))
    bench['per_layer'].append(dict(name='steps_per_s.tiny', unit='1/s', better='higher',
                                   source='host_clock', layer='train step entry',
                                   moves='train_audio_s_per_s', workloads=['tiny-train']))
    for m in bench['end_to_end']:
        if m['name'] == 'train_audio_s_per_s':
            m['workloads'].append('tiny-train')
    (tmp_path / 'BENCHMARK.json').write_text(json.dumps(bench))
    registry = harness.Registry(root)
    result = harness.run_cell(registry, 'tiny-train', 11, 1.0, True, 'cpu')
    assert result['metrics']['steps_per_s.tiny']['value'] > 0
    assert result['correct']
    result = harness.run_cell(registry, 'tiny-train', 11, 1.0, False, 'cpu')
    assert set(result['metrics']) == {'train_audio_s_per_s', 'setup_s'}


def test_char_train_reads_the_card_over_one_whole_cycle(monkeypatch):
    """An untraced char-train run reports the card's busy ms over one whole
    cycle of the step shapes, per audio second of that cycle; the CPU's
    trace holds no device interval, so the reduction is stubbed with a
    busy time."""
    from perfbench import trace

    def reduced(events):
        assert any(kind == 'span' and name == 'window' for kind, name, _, _ in events)
        return dict(busy_s=0.5, window_s=1.0, by_name={}, gaps=[], device=[])

    monkeypatch.setattr(trace, 'reduce', reduced)
    cell, seed = tiny.cell('char-train'), 2 ** 31 + 17
    assert cell['params']['card_cycles'] == 1
    result = _run('char-train')
    work = REG.kind('train').Batches(cell['params'], tiny.config(), seed).work
    cycle_audio = sum(w['audio_s'] for w in work)
    assert set(result['metrics']) == {'train_card_ms_per_audio_s', 'setup_s'}
    assert result['metrics']['train_card_ms_per_audio_s']['value'] == \
        pytest.approx(1e3 * 0.5 / cycle_audio, rel=1e-12)
    assert result['correct'], result['checks']


def test_no_card_reading_without_device_intervals():
    """On the CPU the profiled cycle finds no operation on a card, and the
    metric is left out of the line rather than read as 0."""
    result = _run('char-train')
    assert set(result['metrics']) == {'setup_s'}
