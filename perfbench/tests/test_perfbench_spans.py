"""The readers of the program's spans (`perfbench/program_spans.py` and the
metrics that read the port's span recorder) on traced CPU runs of each cell
at a tiny size, and on synthetic spans and device intervals."""
import math

import pytest

from perfbench import harness, program_spans, trace
from perfbench.tests import tiny
from convasr_tpu_torch.infra import profiler

REG = harness.Registry()
# every cell of BENCHMARK.json, those that later changes add too
CELLS = sorted(w['name'] for w in REG.benchmark()['workloads'])
# the metrics whose readers read the program's spans
NEW = {m['name']: m for m in REG.benchmark()['per_layer']
       if 'program_spans' in (REG.root / 'metrics' / f'{m["name"]}.py').read_text()}


def test_the_span_metrics_are_those_named():
    """The span metrics of the recorder's first change are all still there;
    later changes add more."""
    assert set(NEW) >= {
        'feed_ms_per_step.train', 'forward_ms_per_step.train', 'backward_ms_per_step.train',
        'update_ms_per_step.train', 'update_idle_pct.train', 'dispatch_ms_per_batch.transcribe',
        'generator_ms_per_batch.transcribe', 'tick_launch_ms_p50.stream', 'tick_readback_ms_p50.stream',
        'ticker_wait_idle_pct.stream'}


@pytest.mark.parametrize('name', sorted(NEW))
def test_every_span_metric_keeps_the_rules(name):
    """A span metric reads one cell's spans, in ms, or in % for a _pct name;
    less is better."""
    m = NEW[name]
    assert m['better'] == 'lower' and len(m['workloads']) == 1
    assert m['unit'] == ('%' if m['name'].split('.')[0].endswith('_pct') else 'ms')


@pytest.mark.parametrize('cell', CELLS)
def test_each_metric_reads_its_cell_alone(cell, monkeypatch):
    """A traced run reports each span metric that lists the cell; every span
    metric of another traffic kind reads None there. The CPU's trace holds
    no device interval, so one is put at each end of the traced window: the
    card idle in between."""
    runs, reduce = [], trace.reduce

    class Run(harness.Run):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            runs.append(self)

    def with_device(events):
        (t0, t1), = [(s, e) for kind, name, s, e in events if kind == 'span' and name == 'window']
        return reduce(events + [('device', 'first', t0, t0 + 1e-4),
                                ('device', 'last', t1 - 1e-4, t1)])

    monkeypatch.setattr(harness, 'Run', Run)
    monkeypatch.setattr(trace, 'reduce', with_device)
    profiler.reset()
    result = harness.run_cell(REG, cell, 2 ** 31 + 29, 1.0, True, 'cpu',
                              config=tiny.config(tiny.cell(cell)['config']), cell=tiny.cell(cell))
    assert result['correct'], result['checks']
    listed = {n for n, m in NEW.items() if cell in m['workloads']}
    assert listed <= set(result['metrics']), listed - set(result['metrics'])
    (run,) = runs
    kind = run.cell['kind']
    for name, m in NEW.items():
        value = REG.metric(name).read(run)
        if name in listed:
            assert value is not None and math.isfinite(value) and value >= 0, (name, value)
            if m['unit'] == '%':
                assert value <= 100.0, (name, value)
        elif REG.cell(m['workloads'][0])['kind'] != kind:
            assert value is None, (name, value)
    profiler.reset()


def span(seq, name, start, end, parent=None, tid=1, traced=True):
    return profiler.Span(seq, name, int(start * 1e9), int(end * 1e9), parent, tid, None, traced)


class FakeRun:
    def __init__(self, device):
        self.traced = dict(device=[('k', s, e) for s, e in device])
        self.values = {}


def sample(name, t, value, traced=True):
    return profiler.Sample(name, int(t * 1e9), value, 1, traced)


def test_an_idle_gap_goes_to_the_span_that_was_open(monkeypatch):
    """Device operations at 100-101, 104-107 and 111-113 s leave gaps 101-104
    and 107-111. Thread 1 has A (100-110) holding B (102-105); thread 2 has C
    (106-112). The gaps go to A 6 s of 7 and C 4 s of 7. E (99.5-102.5), open
    across the window's first device operation, takes the 1.5 s of idle time
    inside it but no part in a mean or median; a span recorded outside the
    traced window (D) is left out, and so is a sample taken before the first
    device operation."""
    spans = [span(1, 'B', 102, 105, parent=0), span(0, 'A', 100, 110),
             span(2, 'C', 106, 112, tid=2), span(3, 'D', 100, 113, traced=False),
             span(4, 'E', 99.5, 102.5, tid=3)]
    samples = [sample('w', 99.9, 1.0), sample('w', 105, 2.0), sample('w', 106, 3.0, traced=False)]
    monkeypatch.setattr(profiler, 'snapshot',
                        lambda: dict(spans=spans, counts=[], samples=samples))
    run = FakeRun([(100, 101), (104, 107), (111, 113)])
    assert program_spans.device_range(run) == (100, 113)
    assert program_spans.device_idle(run) == [(101, 104), (107, 111)]
    records = program_spans.traced_records(run)
    assert sorted(s.name for s in records['spans']) == ['A', 'B', 'C']
    assert [s.value for s in records['samples']] == [2.0]
    assert program_spans.idle_share_pct(run, 'A') == pytest.approx(100 * 6 / 7)
    assert program_spans.idle_share_pct(run, 'C') == pytest.approx(100 * 4 / 7)
    assert program_spans.idle_share_pct(run, 'E') == pytest.approx(100 * 1.5 / 7)
    assert program_spans.idle_share_pct(run, 'D') is None
    assert program_spans.mean_ms(run, 'A') == pytest.approx(10e3)
    assert program_spans.mean_ms(run, 'E') is None
    assert program_spans.median_ms(run, 'B') == pytest.approx(3e3)
    assert program_spans.median_ms(run, 'E') is None
    assert program_spans.traced_records(FakeRun([])) is None


def test_a_program_without_the_recorder_reads_none(monkeypatch):
    """The parent of the recorder: its profiler module has no snapshot."""
    monkeypatch.delattr(profiler, 'snapshot')
    run = FakeRun([(0, 1), (2, 3)])
    assert program_spans.traced_records(run) is None
    assert program_spans.idle_share_pct(run, 'A') is None
    for name, m in NEW.items():
        run.values['kind'] = REG.cell(m['workloads'][0])['kind']
        assert REG.metric(name).read(run) is None, name
