"""The port imports no JAX and nothing of the JAX package. Checked in a fresh
interpreter: the test process itself has imported JAX already."""
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent

SCRIPT = r'''
import importlib, pkgutil, sys
import convasr_tpu_torch
names = [m.name for m in pkgutil.walk_packages(convasr_tpu_torch.__path__, 'convasr_tpu_torch.')]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'chex', 'convasr_tpu'))
print(len(names), 'modules;', 'forbidden:', bad)
assert len(names) >= 20 and not bad
assert {'convasr_tpu_torch.models.quantized', 'convasr_tpu_torch.ops.int8',
        'convasr_tpu_torch.ops.ctc_loss_whole_t', 'convasr_tpu_torch.ops.beam_device',
        'convasr_tpu_torch.decode.beam', 'convasr_tpu_torch.decode.factory',
        'convasr_tpu_torch.native.build', 'convasr_tpu_torch.text.ngram_lm',
        'convasr_tpu_torch.text.binlm'} <= set(names)
'''


def test_port_imports_no_jax():
    proc = subprocess.run([sys.executable, '-c', SCRIPT], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
