"""The ctypes bindings of the port's kernel library against its C sources.

kmbart_tpu_torch/ops/_cuda.py binds every entry point of csrc/*.cu with the
argument and return types in ``_SIGNATURES``. ctypes trusts those types: a
pointer bound as ``c_int`` is cut to 32 bits, and an argument too few or too
many shifts every one after it. Nothing on the CPU builds or calls the
library, so these tests hold the table against the ``KMB_EXPORT``
declarations it binds, kind by kind and in order.
"""

import ctypes
import glob
import os
import re

import pytest

from kmbart_tpu_torch.ops import _cuda

# C type (spaces removed) -> the ctypes type that carries it
C_TO_CTYPES = {
    "void*": ctypes.c_void_p,
    "constvoid*": ctypes.c_void_p,
    "int": ctypes.c_int,
    "float": ctypes.c_float,
    "size_t": ctypes.c_size_t,
    "constchar*": ctypes.c_char_p,
}

_EXPORT = re.compile(r"KMB_EXPORT\s+([\w\s\*]+?)\s*\b(kmb_\w+)\s*\(([^)]*)\)\s*\{")


def _c_type(decl):
    """The C type of a declaration such as ``const void* h`` (its last word
    is the name), spaces removed."""
    decl = " ".join(decl.split())
    m = re.fullmatch(r"(.+?)\s*\b\w+", decl)
    assert m, f"cannot parse the declaration {decl!r}"
    return m.group(1).replace(" ", "")


def parse_exports(text):
    """{name: (return type, [argument types])} of every KMB_EXPORT in a
    source, as C types with spaces removed."""
    out = {}
    for ret, name, args in _EXPORT.findall(text):
        args = [a for a in (x.strip() for x in args.split(",")) if a and a != "void"]
        out[name] = (ret.replace(" ", ""), [_c_type(a) for a in args])
    return out


def _exports():
    out = {}
    for path in sorted(glob.glob(os.path.join(_cuda.CSRC_DIR, "*.cu"))):
        with open(path) as f:
            text = f.read()
        found = parse_exports(text)
        # every KMB_EXPORT of the file was parsed
        assert len(found) == text.count("KMB_EXPORT "), os.path.basename(path)
        out.update(found)
    return out


EXPORTS = _exports()


def test_every_export_is_bound_and_every_binding_exported():
    assert EXPORTS, "no KMB_EXPORT found in csrc/*.cu"
    assert sorted(EXPORTS) == sorted(_cuda._SIGNATURES)


@pytest.mark.parametrize("name", sorted(_cuda._SIGNATURES))
def test_binding_matches_the_c_declaration(name):
    assert name in EXPORTS, f"{name} is bound but no csrc/*.cu exports it"
    ret, args = EXPORTS[name]
    restype, argtypes = _cuda._SIGNATURES[name]
    assert C_TO_CTYPES[ret] is restype, f"{name} returns {ret}"
    want = [C_TO_CTYPES[a] for a in args]
    assert len(argtypes) == len(want), f"{name}: {len(argtypes)} bound, {len(want)} declared"
    for i, (got, c_type) in enumerate(zip(argtypes, want)):
        assert got is c_type, f"{name} argument {i}: bound {got.__name__}, declared {args[i]}"


def test_parser_reads_each_kind():
    """The parser on a declaration with every kind, split over lines."""
    src = """KMB_EXPORT size_t kmb_x(const void* a, void* b,
                                  int n, float s, size_t k, void* stream) {
    return 0; }
    KMB_EXPORT const char* kmb_y(int err) { return 0; }"""
    assert parse_exports(src) == {
        "kmb_x": ("size_t", ["constvoid*", "void*", "int", "float", "size_t", "void*"]),
        "kmb_y": ("constchar*", ["int"])}
