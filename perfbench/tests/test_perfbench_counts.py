"""The benchmark's own counts against the port's module shapes, and its
roofline and trace arithmetic at known inputs."""
import numpy as np
import pytest
import torch

from perfbench import harness, measure, model_plan, trace, weights
from perfbench.tests import tiny

REG = harness.Registry()


def _port_model(config, device='meta'):
    from convasr_tpu_torch.frontend.logmel import LogFilterBankFrontend
    from convasr_tpu_torch.models.zoo import create_model
    fe, arch = config['frontend'], dict(config['architecture'])
    frontend = LogFilterBankFrontend(fe['num_input_features'], fe['sample_rate'],
                                     fe['window_size'], fe['window_stride'])
    classes = tuple(h['classes'] for h in config['heads'])
    with torch.device(device):
        return create_model(config['model'], num_input_features=fe['num_input_features'],
                            num_classes=classes, frontend=frontend if device != 'meta' else None,
                            decoder_type='bpe' if len(classes) > 1 else None,
                            dropout=arch.pop('dropout'), **arch)


@pytest.mark.parametrize('name', ['jasper_big_char', 'jasper_big_bpe'])
def test_parameter_plan_and_flops_equal_the_ports_modules(name):
    config = REG.config(name)
    model = _port_model(config)
    plan = model_plan.param_plan(weights.arch_of(config), weights.classes_of(config))
    assert {n: tuple(s) for n, s, _ in plan} == \
        {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert sum(p.numel() for p in model.parameters()) == config['parameters']
    flops = 0
    for m in model.modules():
        if isinstance(m, torch.nn.Conv1d):
            flops += 2 * m.in_channels // m.groups * m.kernel_size[0] * m.out_channels
    assert model_plan.conv_flops_per_frame(weights.arch_of(config),
                                           weights.classes_of(config)) == flops


def test_the_zoo_entry_is_the_configuration():
    from convasr_tpu_torch.models.zoo import MODEL_CONFIGS
    config = REG.config('jasper_big_char')
    for key, value in MODEL_CONFIGS[config['model']].items():
        assert config['architecture'][key] == value, key


@pytest.mark.parametrize('samples', [8000, 12345, 80000, 10240 * 3])
def test_output_frames_equal_the_ports(samples):
    config = tiny.config()
    model = _port_model(config, 'cpu').eval()
    with torch.no_grad():
        out = model(torch.zeros(1, samples), xlen=torch.ones(1))
    assert out['log_probs'][0].shape[1] == model_plan.output_frames(
        weights.arch_of(config), config['frontend'], samples)


@pytest.mark.parametrize('classes,L,expect', [
    # B32 T446 (PERF.md section 6's train batch), every row full length. At C 38 a
    # frame's whole row of log-probs is 152 bytes, 5 sectors: fewer than the
    # lattice's L + 1 classes at a sector each, unless the labels are very short
    (38, 128, dict(fwd_ops=12 * 32 * 446 * 257, bwd_ops=14 * 32 * 446 * 257,
                   fwd_bytes=32 * 446 * 160, bwd_bytes=32 * 446 * 160 + 32 * 446 * 38 * 4)),
    (38, 2, dict(fwd_ops=12 * 32 * 446 * 5, bwd_ops=14 * 32 * 446 * 5,
                 fwd_bytes=32 * 446 * 3 * 32, bwd_bytes=32 * 446 * 3 * 32 + 32 * 446 * 38 * 4)),
    # at C 5000 a row is 625 sectors: the lattice's 129 classes a frame
    (5000, 128, dict(fwd_ops=12 * 32 * 446 * 257, bwd_ops=14 * 32 * 446 * 257,
                     fwd_bytes=32 * 446 * 129 * 32,
                     bwd_bytes=32 * 446 * 129 * 32 + 32 * 446 * 5000 * 4)),
])
def test_ctc_counts_at_the_train_batch(classes, L, expect):
    counts = measure.ctc_counts([446] * 32, [L] * 32, 446, classes)
    assert counts == pytest.approx(expect)
    least = measure.least_seconds(counts['bwd_ops'], counts['bwd_bytes'],
                                  measure.PEAK_FP32_FLOPS)
    assert least == pytest.approx(max(counts['bwd_ops'] / 67e12, counts['bwd_bytes'] / 3.35e12))


# PERF.md section 6's bounds of K1f and K1b at C 38 in ms, (B, T, L) -> (K1f, K1b),
# from chip_smoke.py's arithmetic: the valid frames' rows of C log-probs read
# once, the (B, T, C) gradient written once, 12 float32 operations a lattice
# state and valid frame over the padded label length
SECTION6 = {(16, 300, 80): (0.00020, 0.00042), (64, 500, 160): (0.00181, 0.00289)}


@pytest.mark.parametrize('shape', sorted(SECTION6))
def test_ctc_least_time_meets_section6_bounds(shape):
    """At section 6's seeded shapes (row 1 two thirds long, row 2 as long as
    half the labels), with every row's labels as long as the padding, the
    benchmark's least times are section 6's bounds, up to the rounding of a
    152-byte row to its 160 bytes of sectors."""
    B, T, L = shape
    olen = np.full(B, T)
    olen[1], olen[2] = T * 2 // 3, L // 2
    counts = measure.ctc_counts(olen, np.full(B, L), T, 38)
    assert counts['fwd_bytes'] == 160 * olen.sum()
    assert counts['fwd_ops'] == 12 * olen.sum() * (2 * L + 1)
    fwd = measure.least_seconds(counts['fwd_ops'], counts['fwd_bytes'], measure.PEAK_FP32_FLOPS)
    bwd = measure.least_seconds(counts['bwd_ops'], counts['bwd_bytes'], measure.PEAK_FP32_FLOPS)
    for ours, bound in zip((fwd * 1e3, bwd * 1e3), SECTION6[shape]):
        assert 0.98 * bound <= ours <= 1.07 * bound, (ours, bound)


def test_union_and_gaps():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6), (9.0, 12.0)]
    assert measure.union_seconds(iv, 0.0, 10.0) == pytest.approx(4.0)
    assert measure.idle_gaps(iv, -1.0, 10.0) == [(-1.0, 0.0), (2.0, 3.0), (4.0, 9.0)]
    assert measure.percentile([1, 2, 3, 4], 50) == 2.5


def test_trace_reduce_names_gaps_by_the_innermost_span():
    events = [('span', 'window', 0.0, 10.0), ('span', 'dispatch', 1.0, 5.0),
              ('span', 'log', 2.0, 3.0), ('device', 'ctc_alpha<1>', 0.0, 2.5),
              ('device', 'k', 4.0, 6.0), ('device', 'k', 7.0, 11.0)]
    r = trace.reduce(events)
    assert r['busy_s'] == pytest.approx(7.5) and r['window_s'] == 10.0
    assert r['gaps'] == [('log', pytest.approx(1.5)), ('host', pytest.approx(1.0))]
    assert r['by_name'] == {'ctc_alpha<1>': 2.5, 'k': 5.0}
    b = trace.breakdown(r)
    assert b['device_ops'][0] == ['k', 5.0] and b['idle_gaps'][0][0] == 'log'
