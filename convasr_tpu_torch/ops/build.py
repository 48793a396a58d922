"""Build the port's CUDA kernels (csrc/*.cu) at first use and load them.

Each source is compiled by nvcc for Hopper into a shared library with a plain
C interface, loaded with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas=-v -o build/kernels/lib<name>_<hash>.so csrc/<name>.cu

The library name carries a hash of the sources and the command, so an edited
kernel is rebuilt and an unchanged one is reused. The build directory is
`build/kernels/` beside the package. A missing nvcc or a failed build raises:
there is no fallback.
"""
import concurrent.futures
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

CSRC = pathlib.Path(__file__).resolve().parent.parent / 'csrc'
BUILD_DIR = CSRC.parent.parent / 'build' / 'kernels'
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC', '-Xptxas=-v']

_LIBS: dict = {}
BUILD_LOG: dict = {}  # name -> dict(seconds, ptxas) of builds made in this process


def _nvcc() -> str:
    nvcc = shutil.which('nvcc') or '/usr/local/cuda/bin/nvcc'
    if not os.path.exists(nvcc):
        raise RuntimeError('nvcc not found: the CUDA kernels of convasr_tpu_torch are '
                           'built from csrc/ at first use and need the CUDA toolkit')
    return nvcc


def library_path(name: str) -> pathlib.Path:
    digest = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for src in [CSRC / f'{name}.cu'] + sorted(CSRC.glob('*.cuh')):
        digest.update(src.read_bytes())
    return BUILD_DIR / f'lib{name}_{digest.hexdigest()[:16]}.so'


def build(name: str) -> pathlib.Path:
    """Compile csrc/<name>.cu unless its library is already built."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f'{out.stem}.{os.getpid()}.tmp.so')
    cmd = [_nvcc()] + NVCC_FLAGS + ['-o', str(tmp), str(CSRC / f'{name}.cu')]
    tic = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f'nvcc failed for csrc/{name}.cu ({proc.returncode}):\n'
                           f'{proc.stdout}{proc.stderr}')
    os.replace(tmp, out)
    BUILD_LOG[name] = dict(seconds=time.perf_counter() - tic, ptxas=proc.stderr)
    return out


def build_all() -> list:
    """Compile every csrc/*.cu at once, one nvcc each; returns the names."""
    names = sorted(p.stem for p in CSRC.glob('*.cu'))
    with concurrent.futures.ThreadPoolExecutor(max(len(names), 1)) as pool:
        list(pool.map(build, names))
    return names


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built at first use."""
    if name not in _LIBS:
        _LIBS[name] = ctypes.CDLL(str(build(name)))
    return _LIBS[name]
