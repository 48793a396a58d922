"""Tiny copies of the benchmark's configurations and cells for the CPU tests:
the same code paths at a few short rows, float32 or bf16.

Each configuration or traffic kind may bring its own CPU-size form, so that
one added as new files needs no edit here: a configuration file's `tiny`
block (its groups update the file's groups of the same key, any other value
replaces the file's) and a kind module's `TINY` dict (it updates the cell's
params). The benchmark's first configurations and kinds, which have neither,
take the overrides below."""
import copy

from perfbench import harness

# configurations without a `tiny` block: JasperNet at base width 8, and the
# heads' classes where a head is too wide for the CPU
ARCHITECTURE = dict(base_width=8)
FRONTEND = dict(num_input_features=16)
CLASSES = dict(jasper_big_bpe=(38, 60))


def config(name='jasper_big_char', dtype='float32', classes=None, registry=None):
    c = copy.deepcopy((registry or harness.Registry()).config(name))
    block = c.pop('tiny', None)
    if block is None:
        c['architecture'].update(ARCHITECTURE)
        c['frontend'].update(FRONTEND)
        classes = classes or CLASSES.get(name)
    else:
        for key, value in block.items():
            if isinstance(value, dict) and isinstance(c.get(key), dict):
                c[key].update(value)
            else:
                c[key] = value
    c['dtype'] = dtype
    if classes is not None:
        for h, n in zip(c['heads'], classes):
            h['classes'] = n
    return c


def cell(name='char-train', registry=None, **params):
    registry = registry or harness.Registry()
    c = copy.deepcopy(registry.cell(name))
    own = getattr(registry.kind(c['kind']), 'TINY', None)
    if own is not None:
        c['params'].update(own)
    else:
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
