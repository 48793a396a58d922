"""The int8 transcribe cell (`char-transcribe-int8`, traffic kind
`transcribe_int8`) on the CPU at a tiny size, with the card's look skipped:
the window runs the int8 forward and meets the plain reference within the
cell's limits, each fault the cell can have is not correct, the int4 control
is not correct, each of its metrics reads its own cell alone, the
benchmark's plan of the int8 products is the quantized model's, and the
int8 kernels' matcher takes the `__global__` names of their sources."""
import pathlib
import re

import numpy as np
import pytest
import torch

from perfbench import harness, measure, model_plan, trace, weights
from perfbench.tests import tiny

REG = harness.Registry()
CELL = 'char-transcribe-int8'
CSRC = pathlib.Path(__file__).resolve().parents[2] / 'convasr_tpu_torch' / 'csrc'


def _run(cell=CELL, seed=2 ** 31 + 17, trace_=False, **options):
    return harness.run_cell(REG, cell, seed, 1.0, trace_, 'cpu',
                            config=tiny.config(REG.cell(cell)['config']), cell=tiny.cell(cell),
                            options=options)


def test_the_window_runs_the_int8_forward_and_meets_the_reference(monkeypatch):
    """Every batch of the window goes through the int8 ops (the plain
    versions, on the CPU), and the served tokens meet the float32 reference
    within the cell's limits."""
    from convasr_tpu_torch.ops import int8
    calls = dict(conv=0, gemm=0)
    conv, gemm = int8.int8_conv1d_plain, int8.int8_matmul_plain

    def counted(key, fn):
        def call(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return call

    monkeypatch.setattr(int8, 'int8_conv1d_plain', counted('conv', conv))
    monkeypatch.setattr(int8, 'int8_matmul_plain', counted('gemm', gemm))
    result = _run()
    assert result['correct'], result['checks']
    assert result['attempted'] > 0 and result['failed'] == 0
    plan = model_plan.int8_products(weights.arch_of(tiny.config('jasper_big_char_int8')), [38],
                                    tiny.config('jasper_big_char_int8')['frontend'], 1, 16000)
    per_forward = dict(conv=sum(q['kind'] == 'conv' for q in plan),
                       gemm=sum(q['kind'] == 'gemm' for q in plan))
    # set-up's warm-up of every batch shape, then the window's batches
    forwards = calls['conv'] // per_forward['conv']
    assert calls == dict(conv=forwards * per_forward['conv'], gemm=forwards * per_forward['gemm'])
    assert forwards >= result['attempted'] + 3


@pytest.mark.parametrize('fault', ['alter_token', 'zero_calibration'])
def test_a_fault_under_the_int8_path_is_not_correct(fault):
    result = _run(fault=fault)
    assert not result['correct'], result['checks']


def test_the_int4_control_is_not_correct():
    """The reference in the program's place with every conv in int4 (the
    step below the configuration's int8) fails one of the cell's limits;
    the program reads below every limit and far below the control."""
    run = harness.Run(CELL, tiny.cell(CELL), tiny.config('jasper_big_char_int8'), 5, 1.0, False,
                      'cpu', dict(control='int4'))
    session = REG.kind(run.cell['kind']).setup(run)
    session.window(run, 0.5)
    checks = session.check(run)
    limits = run.cell['params']['limits']
    prog, control = run.values['readings'], run.values['control_readings']
    assert all(c['ok'] for c in checks), checks
    assert any(control[k] > v for k, v in limits.items()), (control, limits)
    assert max(control[k] / max(prog[k], 1e-12) for k in limits) > 2.0, (prog, control)


def _device_names():
    """A demangled name of each int8 kernel and of kernels of other layers,
    as the profiler's trace shows them."""
    return ['void int8_conv_wgmma::kernel<128>(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, '
            'int8_conv_wgmma::Params)', 'void int8_gemm_wgmma_tma::kernel<64>(CUtensorMap_st, '
            'CUtensorMap_st, int*, int, int, int)',
            'sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc',
            'void at::native::vectorized_elementwise_kernel<4>(int, float*)']


@pytest.mark.parametrize('cell', [CELL, 'char-transcribe'])
def test_each_int8_metric_reads_its_cell_alone(cell, monkeypatch):
    """A traced run of the int8 cell reports each of its per-layer metrics;
    a traced char-transcribe run reads None from each of them, and the int8
    run None from each of char-transcribe's. The CPU's trace holds no device
    operation, so int8 and bf16 kernels are put into the traced window."""
    from convasr_tpu_torch.infra import profiler
    runs, reduce = [], trace.reduce

    class Run(harness.Run):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            runs.append(self)

    def with_device(events):
        (t0, t1), = [(s, e) for kind, name, s, e in events if kind == 'span' and name == 'window']
        step = (t1 - t0) / 10
        return reduce(events + [('device', name, t0 + i * step, t0 + (i + 0.5) * step)
                                for i, name in enumerate(_device_names())]
                      + [('device', 'last', t1 - 1e-4, t1)])

    monkeypatch.setattr(harness, 'Run', Run)
    monkeypatch.setattr(trace, 'reduce', with_device)
    profiler.reset()
    result = _run(cell, trace_=True)
    assert result['correct'], result['checks']
    (run,) = runs
    mine = [m['name'] for m in REG.metrics_for(CELL, 'per_layer')]
    theirs = [m['name'] for m in REG.metrics_for('char-transcribe', 'per_layer')]
    assert len(mine) == 4 and not set(mine) & set(theirs)
    for name in mine:
        value = REG.metric(name).read(run)
        if cell == CELL:
            assert value is not None and np.isfinite(value) and value > 0, (name, value)
            assert result['metrics'][name]['value'] == value
        else:
            assert value is None, (name, value)
    if cell == CELL:
        for name in theirs:
            assert REG.metric(name).read(run) is None, name
        least = run.values['traced_int8_least_s']
        spent = trace.kernel_seconds(run.traced, REG.metric(mine[0]).is_int8_kernel)
        assert spent == pytest.approx(2 * (run.traced['window_s'] / 20), rel=1e-4)
        assert result['metrics'][mine[0]]['value'] == pytest.approx(100 * least / spent)
    profiler.reset()


def _quantized_products(config, rows, samples, seed=3):
    """(kind, ops, bytes) of every int8 product the port's quantized forward
    makes for one (rows, samples) batch on the CPU, read from the shapes of
    the int8 ops' calls."""
    from convasr_tpu_torch.frontend.logmel import LogFilterBankFrontend
    from convasr_tpu_torch.models import quantized
    from convasr_tpu_torch.models.zoo import create_model
    from convasr_tpu_torch.ops import int8
    fe, arch = config['frontend'], dict(config['architecture'])
    classes = tuple(h['classes'] for h in config['heads'])
    frontend = LogFilterBankFrontend(fe['num_input_features'], fe['sample_rate'],
                                     fe['window_size'], fe['window_stride'])
    torch.manual_seed(seed)
    model = create_model(config['model'], num_input_features=fe['num_input_features'],
                         num_classes=classes, frontend=frontend,
                         decoder_type='bpe' if len(classes) > 1 else None,
                         dropout=arch.pop('dropout'), **arch).eval()
    x = np.random.default_rng(seed).standard_normal((rows, samples)).astype(np.float32) * 0.1
    xlen = np.linspace(0.5, 1.0, rows).astype(np.float32)
    qtree = quantized.quantize(model, [dict(x=x, xlen=xlen)])
    seen = []
    conv, gemm = int8.int8_conv1d_plain, int8.int8_matmul_plain

    def conv_call(x, w, stride=1, dilation=1, *a, **kw):
        out = conv(x, w, stride, dilation, *a, **kw)
        B, T_in, Cin = x.shape
        K, _, Cout = w.shape
        seen.append(('conv', 2.0 * B * out.shape[1] * K * Cin * Cout,
                     float(x.numel() + w.numel() + 4 * out.numel())))
        return out

    def gemm_call(a, b, *args, **kw):
        out = gemm(a, b, *args, **kw)
        seen.append(('gemm', 2.0 * a.shape[0] * a.shape[1] * b.shape[1],
                     float(a.numel() + b.numel() + 4 * out.numel())))
        return out

    saved = int8.int8_conv1d_plain, int8.int8_matmul_plain
    int8.int8_conv1d_plain, int8.int8_matmul_plain = conv_call, gemm_call
    try:
        quantized.quantized_apply(model, qtree, torch.from_numpy(x), torch.from_numpy(xlen))
    finally:
        int8.int8_conv1d_plain, int8.int8_matmul_plain = saved
    return sorted(seen)


@pytest.mark.parametrize('name,rows,samples', [('jasper_big_char_int8', 3, 8000),
                                               ('jasper_big_char_int8', 2, 10240),
                                               ('jasper_big_bpe', 2, 6400)])
def test_the_int8_plan_is_the_quantized_models_products(name, rows, samples):
    """The benchmark's plan of the int8 convs and GEMMs (what the int8
    roofline divides by) holds every product the port's quantized forward
    makes, at its shape: the prologue's strided conv, each conv with taps,
    the fused dense-residual GEMMs, the one-tap epilogue and the heads."""
    config = tiny.config(name)
    plan = model_plan.int8_products(weights.arch_of(config), weights.classes_of(config),
                                    config['frontend'], rows, samples)
    assert sorted((q['kind'], q['ops'], q['bytes']) for q in plan) == \
        _quantized_products(config, rows, samples)
    least = sum(measure.least_seconds(q['ops'], q['bytes'], measure.PEAK_INT8_OPS) for q in plan)
    assert least > 0


def _global_functions():
    """(namespace, name) of each `__global__` function of csrc/int8_*.cu*,
    '' for the anonymous namespace."""
    found = []
    for path in sorted(CSRC.glob('int8_*.cu*')):
        text = path.read_text()
        events = sorted(
            [(m.start(), 'open', m.group(1)) for m in re.finditer(r'namespace\s*(\w*)\s*\{', text)]
            + [(m.start(), 'close', '') for m in re.finditer(r'\}\s*//\s*namespace', text)]
            + [(m.start(), 'global', m.group(1)) for m in re.finditer(
                r'__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(', text)])
        stack = []
        for _, what, name in events:
            if what == 'open':
                stack.append(name)
            elif what == 'close':
                stack.pop()
            else:
                found.append((stack[-1] if stack else None, name))
    return found


def test_the_int8_kernel_names_are_those_of_the_sources():
    """The int8 roofline's matcher takes every `__global__` function of the
    int8 kernels' sources, by its demangled and its mangled name, each of
    its tokens names one of them, and it takes no kernel of another
    layer."""
    is_int8 = REG.metric('int8_roofline_pct.transcribe_int8').is_int8_kernel
    functions = _global_functions()
    assert len(functions) == 4 and all(ns is not None for ns, _ in functions), functions
    for ns, fn in functions:
        demangled = f'void {ns or "(anonymous namespace)"}::{fn}<1>(int)'
        space = f'{len(ns)}{ns}' if ns else '12_GLOBAL__N_1'
        mangled = f'_ZN{space}{len(fn)}{fn}ILi1EEEvi'
        assert is_int8(demangled) and is_int8(mangled), (ns, fn)
    tokens = REG.metric('int8_roofline_pct.transcribe_int8').KERNELS
    for token in tokens:
        assert any(token in (ns, fn) for ns, fn in functions), token
    for name in _device_names()[2:] + [
            'cudnn::bn_fw_inf_1C11_kernel_NCHW_float__float__true__1__float__',
            'cutlass::Kernel2_cutlass_75_tensorop_bf16_s1688gemm_bf16_128x128',
            'void ctc_alpha<false>(float const*)', 'void update_kernel(Tensors)',
            '_ZN17cutlass__5x_cudnn6KernelINS_4conv6kernel23ImplicitGemmConvo']:
        assert not is_int8(name), name
