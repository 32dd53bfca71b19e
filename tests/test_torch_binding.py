"""The port's ctypes binding (style_transfer2_tpu_torch/_build.py).

_build._SIGNATURES gives ctypes the argument types of every extern "C"
entry point in style_transfer2_tpu_torch/csrc/*.cu. A C signature changed
without its argtypes would pass a pointer as a 32-bit int or a float as an
int, and show only on the card; these tests read the sources and hold the
table against them. Nothing is compiled here.
"""

import ctypes
import re

import pytest

from style_transfer2_tpu_torch import _build

# The kinds an argument may have, as ctypes spells them.
_KINDS = {ctypes.c_void_p: 'pointer', ctypes.c_int: 'int',
          ctypes.c_longlong: 'long long', ctypes.c_float: 'float'}
_C_KINDS = {'int': 'int', 'long long': 'long long', 'float': 'float'}
_ENTRY = re.compile(r'extern\s+"C"\s+([\w\s]+?)\s+(\w+)\s*\(([^)]*)\)')


def _c_kind(arg):
    """'pointer', 'int', 'long long' or 'float' of one C parameter
    declaration such as 'const void* in' or 'long long n'."""
    arg = ' '.join(arg.replace('*', ' * ').split())
    if '*' in arg:
        return 'pointer'
    words = [w for w in arg.split()[:-1] if w != 'const']   # drop the name
    return _C_KINDS[' '.join(words)]


def _entry_points():
    """{name: (return type, [argument kinds])} of every extern "C" function
    defined in csrc/*.cu."""
    found = {}
    for src in _build._sources():
        text = re.sub(r'//[^\n]*', '', src.read_text())
        for ret, name, args in _ENTRY.findall(text):
            assert name not in found, 'entry point %s defined twice' % name
            found[name] = (ret.strip(), [_c_kind(a) for a in args.split(',')
                                         if a.strip()])
    return found


def test_parser_reads_a_declaration():
    text = 'extern "C" int f(const void* a, float* b,\n long long n, float m)'
    ret, name, args = _ENTRY.findall(text)[0]
    assert (ret, name) == ('int', 'f')
    assert [_c_kind(a) for a in args.split(',')] == [
        'pointer', 'pointer', 'long long', 'float']


def test_every_entry_point_is_bound_and_no_other():
    assert set(_entry_points()) == set(_build._SIGNATURES)


@pytest.mark.parametrize('name', sorted(_build._SIGNATURES))
def test_argtypes_match_the_c_signature(name):
    ret, kinds = _entry_points()[name]
    assert ret == 'int'                  # bind() sets restype c_int
    assert [_KINDS[t] for t in _build._SIGNATURES[name]] == kinds


class _NoLock:
    def __enter__(self):
        raise AssertionError('lib() took the build lock')

    def __exit__(self, *exc):
        return False


def test_lib_skips_the_lock_once_loaded(monkeypatch):
    loaded = object()
    monkeypatch.setattr(_build, '_lib', loaded)
    monkeypatch.setattr(_build, '_lock', _NoLock())
    assert _build.lib() is loaded


def test_lib_binds_once_under_the_lock(monkeypatch):
    calls = []
    monkeypatch.setattr(_build, '_lib', None)
    monkeypatch.setattr(_build, 'bind', lambda loader: calls.append(
        loader) or 'handle')
    assert _build.lib() == 'handle' and _build.lib() == 'handle'
    assert calls == [_build.LOADER]
