"""The harness loads nothing of JAX or the JAX package, and the reference
nothing of the program; without a card the command fails and prints no
result."""
import json
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
FORBIDDEN = {'jax', 'jaxlib', 'flax', 'optax', 'orbax', 'convasr_tpu'}


def _loaded(code: str) -> set:
    out = subprocess.run([sys.executable, '-c', code + '\nimport sys, json\n'
                          'print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))'],
                         cwd=ROOT, capture_output=True, text=True, check=True,
                         env=dict(os.environ, JAX_PLATFORMS='cpu'))
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_and_every_kind_load_no_jax():
    loaded = _loaded(
        'from perfbench import harness\n'
        'r = harness.Registry()\n'
        'for w in r.benchmark()["workloads"]:\n'
        '    r.kind(r.cell(w["name"])["kind"])\n'
        'for m in r.benchmark()["per_layer"]:\n'
        '    r.metric(m["name"])\n'
        'import convasr_tpu_torch.cli.train, convasr_tpu_torch.cli.transcribe\n'
        'import convasr_tpu_torch.serve.streaming_batch\n')
    assert 'convasr_tpu_torch' in loaded
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN


def test_reference_loads_nothing_of_the_program():
    loaded = _loaded('import perfbench.reference.jasper, perfbench.weights, perfbench.measure')
    assert not loaded & (FORBIDDEN | {'convasr_tpu_torch'})


def test_command_without_a_card_fails_and_prints_nothing():
    bench = json.loads((ROOT / 'BENCHMARK.json').read_text())
    cell = bench['workloads'][0]['name']
    out = subprocess.run(bench['command'] + ['--workload', cell, '--seed', '3000000001',
                                             '--seconds', '1', '--trace', '0'],
                         cwd=ROOT, capture_output=True, text=True,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=''))
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
