"""Builds the CUDA kernels in csrc/ and binds them with ctypes.

The sources are compiled at first use, on the machine with the card, by
nvcc into one shared library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
        -Xcompiler -fPIC -Xptxas -v -o libst2kernels.so csrc/*.cu

The library goes to build/kernels/<hash>/ under the repository root (listed
in .gitignore), keyed by a hash of the sources and the flags, so an edited
kernel rebuilds and an unchanged one loads at once. nvcc's output, ptxas's
register and shared-memory report included, is kept beside it as build.log.

Nothing here runs at import: the CPU tests import every module of the
package, and this machine may have neither nvcc nor a card.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / 'csrc'
BUILD_ROOT = Path(__file__).resolve().parents[1] / 'build' / 'kernels'
LIB_NAME = 'libst2kernels.so'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# Entry point -> argument types (every entry returns a cudaError_t as int).
_SIGNATURES = {
    'st2_conv3x3_fwd': [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    'st2_conv3x3_bwd': [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    'st2_style_branch': [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _P],
}

_lock = threading.Lock()
_lib = None


def _sources():
    return sorted(CSRC.glob('*.cu'))


def _nvcc():
    cuda_home = os.environ.get('CUDA_HOME', '/usr/local/cuda')
    candidate = Path(cuda_home) / 'bin' / 'nvcc'
    if candidate.exists():
        return str(candidate)
    found = shutil.which('nvcc')
    if found is None:
        raise RuntimeError('nvcc not found (looked in %s/bin and on PATH); '
                           'the CUDA kernels cannot be built' % cuda_home)
    return found


def build_dir():
    """The directory this version of the sources builds into."""
    digest = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_ROOT / digest.hexdigest()[:16]


def build():
    """Compiles the sources if this version is not built yet. Returns the
    library's path. Raises RuntimeError with nvcc's output on failure."""
    out_dir = build_dir()
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        return lib_path
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    # Compile to a temporary name and rename, so that a concurrent or
    # interrupted build never leaves a half-written library behind.
    fd, tmp = tempfile.mkstemp(suffix='.so', dir=out_dir)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, '-o', tmp, *map(str, _sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    (out_dir / 'build.log').write_text(
        ' '.join(cmd) + '\n' + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError('nvcc failed (%d):\n%s%s' % (
            proc.returncode, proc.stdout, proc.stderr))
    os.replace(tmp, lib_path)
    return lib_path


def lib():
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = handle
        return _lib


def check(err, what):
    """Raises if a kernel entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError('%s: CUDA error %d at launch' % (what, err))
