"""Build the port's CUDA kernels at first use and load them with ctypes.

Each source under ``visual_foresight_torch/csrc/`` is compiled by ``nvcc``
for ``sm_90a`` into a shared library with a plain C interface (no PyTorch
headers, so a build takes seconds).  Libraries go to ``build/kernels/`` at
the root of the checkout, named by a hash of their source and the shared
headers (``csrc/*.cuh``), so an edited source is rebuilt and a stale library
is never loaded.  A failed build raises.  ``build_concurrently`` starts one
nvcc per source at once.

``build_host`` compiles a host library the same way with ``g++`` (the
ingest engine, ``native/ingest.cpp``) into ``build/native/``: to a
temporary name, renamed into place under a file lock, so that processes
building it at once neither clash nor load a half-written file.
"""

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / 'csrc'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / 'kernels'
HOST_SRC = Path(__file__).resolve().parent.parent / 'native'
HOST_BUILD_DIR = BUILD_DIR.parent / 'native'
HOST_FLAGS = ('-O2', '-std=c++17', '-pthread', '-shared', '-fPIC')
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')


def _nvcc():
    found = shutil.which('nvcc')
    if found:
        return found
    for root in (os.environ.get('CUDA_HOME'), '/usr/local/cuda'):
        if root and os.path.isfile(os.path.join(root, 'bin', 'nvcc')):
            return os.path.join(root, 'bin', 'nvcc')
    raise RuntimeError('nvcc not found: the CUDA kernels need the CUDA '
                       'toolkit (set CUDA_HOME or put nvcc on PATH)')


def library_path(source):
    """Where the library built from ``csrc/<source>`` lives: named by a hash
    of the source, the headers beside it and the flags."""
    headers = b''.join(p.read_bytes() for p in sorted(CSRC.glob('*.cuh')))
    text = (CSRC / source).read_bytes() + headers + \
        ' '.join(NVCC_FLAGS).encode()
    digest = hashlib.sha256(text).hexdigest()[:16]
    return BUILD_DIR / '{}-{}.so'.format(Path(source).stem, digest)


def build(source):
    """Compile ``csrc/<source>`` unless its library exists; return the
    library path and the compiler's ``-Xptxas -v`` report."""
    so = library_path(source)
    log = so.with_suffix('.ptxas.txt')
    if so.is_file() and log.is_file():
        return so, log.read_text()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix('.so.tmp{}'.format(os.getpid()))
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, '-o', str(tmp),
                           str(CSRC / source)],
                          capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError('nvcc failed on {} (exit {}):\n{}{}'.format(
            source, proc.returncode, proc.stdout, proc.stderr))
    report = proc.stdout + proc.stderr
    log.write_text(report)
    os.replace(tmp, so)
    return so, report


def build_concurrently(sources):
    """Start one ``build`` per source, all at once; return {source: Future}
    whose ``result()`` is that build's (library path, report) or raises."""
    pool = ThreadPoolExecutor(max_workers=max(len(sources), 1))
    futures = {source: pool.submit(build, source) for source in sources}
    pool.shutdown(wait=False)
    return futures


@functools.lru_cache(maxsize=None)
def load(source):
    """Build (if needed) and load ``csrc/<source>`` as a ctypes library."""
    so, _ = build(source)
    return ctypes.CDLL(str(so))


def host_library_path(source, libs=(), flags=()):
    """Where ``build_host`` puts the library of ``native/<source>``: named
    by a hash of the source, the flags and the libraries."""
    text = (HOST_SRC / source).read_bytes() + \
        ' '.join(HOST_FLAGS + tuple(flags) + tuple(libs)).encode()
    digest = hashlib.sha256(text).hexdigest()[:16]
    return HOST_BUILD_DIR / '{}-{}.so'.format(Path(source).stem, digest)


def build_host(source, libs=(), flags=()):
    """Compile ``native/<source>`` with ``g++`` (``$CXX`` if set), the
    extra ``flags`` (for example ``('-DNAME',)``) and the libraries
    ``libs`` (for example ``('-ljpeg', '-lz')``) unless its library exists;
    return the library path.  Raises where the compiler is missing or the
    build fails."""
    so = host_library_path(source, libs, flags)
    if so.is_file():
        return so
    HOST_BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(so.with_suffix('.lock'), 'w') as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if so.is_file():
            return so
        cxx = shutil.which(os.environ.get('CXX', 'g++'))
        if cxx is None:
            raise RuntimeError('no C++ compiler (g++) on the PATH to build '
                               '{}'.format(source))
        tmp = so.with_suffix('.so.tmp{}'.format(os.getpid()))
        proc = subprocess.run([cxx, *HOST_FLAGS, *flags,
                               str(HOST_SRC / source), '-o', str(tmp), *libs],
                              capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            raise RuntimeError('{} failed on {} (exit {}):\n{}{}'.format(
                cxx, source, proc.returncode, proc.stdout, proc.stderr))
        os.replace(tmp, so)
    return so
