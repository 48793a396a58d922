"""Each cell once on the card, briefly, through the command: its result line
is well formed and correct. Skips where no card is visible; run on the card
with `python -m pytest perfbench/tests/test_perfbench_card.py -q`."""
import json
import pathlib
import subprocess

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / 'BENCHMARK.json').read_text())


@pytest.mark.cuda
@pytest.mark.parametrize('cell', [w['name'] for w in BENCH['workloads']])
def test_a_short_run_on_the_card(cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip('no CUDA device visible')
    out = subprocess.run(BENCH['command'] + ['--workload', cell, '--seed', '2147483659',
                                             '--seconds', '3', '--trace', '1'],
                         cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result['correct'], result['checks']
    assert result['device']['platform'] == 'gpu' and result['device']['busy_s'] > 0
    assert result['metrics'] and list(result)[-1] == 'checks'
