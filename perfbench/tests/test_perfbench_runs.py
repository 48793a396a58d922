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
# every cell of BENCHMARK.json, those that later changes add too
CELLS = sorted(w['name'] for w in REG.benchmark()['workloads'])


def _run(cell, seconds=1.5, trace=False, registry=REG, **options):
    name = tiny.cell(cell)['config']
    return harness.run_cell(registry, cell, 2 ** 31 + 17, seconds, trace, 'cpu',
                            config=tiny.config(name), cell=tiny.cell(cell), options=options)


@pytest.mark.parametrize('cell', CELLS)
def test_the_program_matches_the_reference(cell):
    """In float32 the program meets the reference to rounding; a
    configuration that states a quantization is held to its cell's limits."""
    result = _run(cell, trace=True)
    assert result['correct'], result['checks']
    assert result['attempted'] > 0 and result['failed'] == 0
    if 'quantize' not in REG.config(REG.cell(cell)['config']):
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
    run = harness.Run(cell, tiny.cell(cell), tiny.config(REG.cell(cell)['config'], 'bfloat16'),
                      5, 1.0, False, 'cpu', dict(control='fp8', no_warmup=True))
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


def test_a_dropped_in_kind_config_and_span_metric_need_no_edit(tmp_path, monkeypatch):
    """A cell of a new kind (a file that takes traffic/train.py's session as
    it is, with a CPU size of its own), a configuration with its own `tiny`
    block and a metric that reads a program span, put into a copy of the
    folder: the cell runs on the CPU, reports the metric, and no file that
    was there changes. The CPU's trace holds no device interval, so one is
    put at each end of the traced window, as the span tests do."""
    from perfbench import trace
    from convasr_tpu_torch.infra import profiler
    root = tmp_path / 'perfbench'
    shutil.copytree(REG.root, root, ignore=shutil.ignore_patterns('__pycache__'))
    before = {p: p.read_bytes() for p in root.rglob('*') if p.is_file()}
    (root / 'traffic' / 'train_again.py').write_text(
        'from perfbench.traffic.train import Session\n\n'
        'TINY = dict(batch=2, steps_per_epoch=3, median_s=0.7, sigma=0.2, min_s=0.5, max_s=1.0,\n'
        '            padding_multiple=32)\n\n\n'
        'def setup(run):\n'
        '    return Session(run)\n')
    config = REG.config('jasper_big_char')
    config.update(name='dropin_char', tiny=dict(architecture=dict(base_width=4),
                                                frontend=dict(num_input_features=16)))
    (root / 'configs' / 'dropin_char.json').write_text(json.dumps(config))
    cell = REG.cell('char-train')
    cell.update(config='dropin_char', kind='train_again')
    (root / 'cells' / 'dropin-train.json').write_text(json.dumps(cell))
    (root / 'metrics' / 'forward_ms_per_step.dropin.py').write_text(
        'from perfbench import program_spans\n\n\n'
        'def read(run):\n'
        '    if run.values.get("kind") != "train":\n'
        '        return None\n'
        '    return program_spans.mean_ms(run, "train.forward")\n')
    bench = REG.benchmark()
    bench['workloads'].append(dict(name='dropin-train', config='dropin_char',
                                   traffic=cell['traffic'], chips=1, why=cell['why']))
    bench['per_layer'].append(dict(name='forward_ms_per_step.dropin', unit='ms', better='lower',
                                   source='program_span', layer='model step',
                                   moves='train_audio_s_per_s', workloads=['dropin-train']))
    for m in bench['end_to_end']:
        if m['name'] == 'train_audio_s_per_s':
            m['workloads'].append('dropin-train')
    (tmp_path / 'BENCHMARK.json').write_text(json.dumps(bench))

    reduce = trace.reduce

    def with_device(events):
        (t0, t1), = [(s, e) for kind, name, s, e in events if kind == 'span' and name == 'window']
        return reduce(events + [('device', 'first', t0, t0 + 1e-4),
                                ('device', 'last', t1 - 1e-4, t1)])

    monkeypatch.setattr(trace, 'reduce', with_device)
    registry = harness.Registry(root)
    config, cell = tiny.config('dropin_char', registry=registry), \
        tiny.cell('dropin-train', registry=registry)
    assert config['architecture']['base_width'] == 4 and 'tiny' not in config
    assert cell['params']['batch'] == 2 and cell['params']['steps_per_epoch'] == 3
    profiler.reset()
    result = harness.run_cell(registry, 'dropin-train', 13, 1.0, True, 'cpu', config=config,
                              cell=cell)
    profiler.reset()
    assert result['correct'], result['checks']
    assert result['metrics']['forward_ms_per_step.dropin']['value'] > 0
    assert {p: p.read_bytes() for p in before} == before


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
