"""Build the port's host C++ components (native/*.cpp) with g++ at first use
and load them with ctypes:

    g++ -O3 -std=c++17 -shared -fPIC native/<name>.cpp -o build/native/<name>_<hash>.so

The library name carries a hash of the source and the command, so an edited
source is rebuilt and an unchanged one reused. Each process compiles to a
temporary name of its own and then renames it into place, so processes that
build at once never step on each other's output. A missing compiler or a
failed build raises: there is no fallback.
"""
import ctypes
import hashlib
import os
import pathlib
import subprocess

NATIVE_DIR = pathlib.Path(__file__).resolve().parent
BUILD_DIR = NATIVE_DIR.parent.parent / 'build' / 'native'
GXX_FLAGS = ['-O3', '-std=c++17', '-shared', '-fPIC']

_LIBS: dict = {}


def library_path(source_name: str) -> pathlib.Path:
    digest = hashlib.sha256(' '.join(GXX_FLAGS).encode())
    digest.update((NATIVE_DIR / source_name).read_bytes())
    return BUILD_DIR / f'{pathlib.Path(source_name).stem}_{digest.hexdigest()[:16]}.so'


def build_library(source_name: str) -> pathlib.Path:
    """Compile native/<source_name> unless its library is already built."""
    out = library_path(source_name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f'{out.stem}.{os.getpid()}.tmp.so')
    cmd = ['g++'] + GXX_FLAGS + [str(NATIVE_DIR / source_name), '-o', str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError(f'g++ not found: native/{source_name} of convasr_tpu_torch is '
                           'built at first use and needs a C++ compiler') from e
    if proc.returncode != 0:
        raise RuntimeError(f'g++ failed for native/{source_name} ({proc.returncode}):\n'
                           f'{proc.stdout}{proc.stderr}')
    os.replace(tmp, out)
    return out


def load_library(source_name: str) -> ctypes.CDLL:
    """The loaded library of native/<source_name>, built at first use."""
    if source_name not in _LIBS:
        _LIBS[source_name] = ctypes.CDLL(str(build_library(source_name)))
    return _LIBS[source_name]
