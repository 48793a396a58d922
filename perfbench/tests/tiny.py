"""Tiny copies of the benchmark's configurations and cells for the CPU tests:
the same code paths at base width 8, a few short rows, float32 or bf16."""
import copy

from perfbench import harness


def config(name='jasper_big_char', dtype='float32', classes=None):
    c = copy.deepcopy(harness.Registry().config(name))
    c['architecture'].update(base_width=8)
    c['frontend'].update(num_input_features=16)
    c['dtype'] = dtype
    if classes is not None:
        for h, n in zip(c['heads'], classes):
            h['classes'] = n
    return c


def cell(name='char-train', **params):
    c = copy.deepcopy(harness.Registry().cell(name))
    if c['kind'] == 'train':
        c['params'].update(batch=4, steps_per_epoch=4, median_s=0.8, sigma=0.3, min_s=0.5,
                           max_s=1.5, padding_multiple=32)
    c['params'].update(TINY.get(c['kind'], {}))
    c['params'].update(params)
    return c


TINY = dict(
    transcribe=dict(calls=3, call_min_s=2.0, call_max_s=5.0, seg_median_s=1.0, seg_sigma=0.3,
                    seg_min_s=0.5, seg_max_s=2.0, padding_multiple=16, check_batches=1),
    stream=dict(slots=3, window_s=2.0, lead_s=1.0, pool_s=10.0, check_slots=2, check_ticks=2),
)
