"""Builds the CUDA kernels in csrc/ and binds them with ctypes.

The sources (csrc/conv3x3.cu, conv3x3_wgmma.cu, style.cu, image.cu) are
compiled at first use, on the machine with the card, by nvcc into one
shared library with a plain C interface: one nvcc per source, all started
together, then one link:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \\
        -Xcompiler -fPIC -Xptxas -v -c -o <name>.o csrc/<name>.cu  (each)
    nvcc -shared -o libst2kernels.so *.o

The library goes to build/kernels/<hash>/ under the repository root (listed
in .gitignore), keyed by a hash of the sources and the flags, so an edited
kernel rebuilds and an unchanged one loads at once. nvcc's output, ptxas's
register and shared-memory report included, is kept beside it as build.log.

The wrappers launch through lib() and stream(), which cost a launch as
little host time as they can: after the first build lib() hands out the
bound library without taking the build lock, and stream() reads the
caller's current stream as a raw pointer (the value Triton's launcher
reads), with no torch.cuda.Stream object built per call.
tests/test_torch_binding.py holds _SIGNATURES against the extern "C"
entry points of csrc/*.cu.

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

import torch

CSRC = Path(__file__).resolve().parent / 'csrc'
BUILD_ROOT = Path(__file__).resolve().parents[1] / 'build' / 'kernels'
LIB_NAME = 'libst2kernels.so'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# Entry point -> argument types (every entry returns a cudaError_t as int).
_SIGNATURES = {
    'st2_conv3x3_fwd': [_I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                        _I, _I, _P],
    'st2_conv3x3_bwd': [_I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                        _I, _I, _P],
    'st2_style_branch': [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F,
                         _P],
    'st2_preprocess': [_P, _P, _P, _P],
    'st2_deprocess': [_P, _P, _P, _P],
}

# How the library is loaded: PyDLL keeps the interpreter lock through a
# call, as PyTorch's own launches do, and so skips releasing and taking it
# back on every launch (CDLL). `python -m
# style_transfer2_tpu_torch.launch_cost` times both.
LOADER = ctypes.PyDLL

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
    # Objects and the library go to temporary names first, so that a
    # concurrent or interrupted build never leaves a half-written library
    # behind.
    obj_dir = Path(tempfile.mkdtemp(dir=out_dir))
    try:
        jobs = []
        for src in _sources():
            cmd = [nvcc, *NVCC_FLAGS, '-c', '-o',
                   str(obj_dir / (src.stem + '.o')), str(src)]
            jobs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log, failed = [], []
        for cmd, proc in jobs:
            output = proc.communicate()[0]
            log.append(' '.join(cmd) + '\n' + output)
            if proc.returncode != 0:
                failed.append('%s (%d)' % (cmd[-1], proc.returncode))
        if not failed:
            fd, tmp = tempfile.mkstemp(suffix='.so', dir=out_dir)
            os.close(fd)
            cmd = [nvcc, '-shared', '-o', tmp,
                   *map(str, sorted(obj_dir.glob('*.o')))]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            log.append(' '.join(cmd) + '\n' + proc.stdout + proc.stderr)
            if proc.returncode != 0:
                os.unlink(tmp)
                failed.append('link (%d)' % proc.returncode)
            else:
                os.replace(tmp, lib_path)
        (out_dir / 'build.log').write_text(''.join(log))
        if failed:
            raise RuntimeError('nvcc failed: %s\n%s' % (', '.join(failed),
                                                        ''.join(log)))
    finally:
        shutil.rmtree(obj_dir, ignore_errors=True)
    return lib_path


def bind(loader):
    """The built library loaded by `loader` (ctypes.CDLL or ctypes.PyDLL)
    with every entry point's argument types set."""
    handle = loader(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(handle, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return handle


def lib():
    """The loaded kernel library, built on first use. The lock guards the
    build and the load only."""
    global _lib
    if _lib is None:
        with _lock:
            if _lib is None:
                _lib = bind(LOADER)
    return _lib


def stream(t):
    """The current CUDA stream of t's device as an integer, for a void*
    argument: the stream torch would launch on, inside torch.cuda.stream()
    blocks too."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def check(err, what):
    """Raises if a kernel entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError('%s: CUDA error %d at launch' % (what, err))
