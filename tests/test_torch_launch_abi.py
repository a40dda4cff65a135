"""The `ctypes` argument types of every C entry of the port's CUDA sources
against its ``extern "C"`` signature.  A pointer passed where the table says
int would be cut to 32 bits without a word, so each wrapper module's
``C_ENTRIES`` (what `ops/_build.py::load` sets as ``argtypes``) is held
against the parameters parsed from `interdiff_torch/csrc/<SOURCE>.cu`:
their count and kind (pointer, int, long long, float).  Nothing here loads
a library or needs a card."""

import ctypes
import glob
import os
import re

import pytest

torch = pytest.importorskip("torch")

from interdiff_torch.ops import (  # noqa: E402
    _build,
    gather,
    group,
    nn,
    packed_attention,
    sa,
)

MODULES = [gather, group, nn, sa, packed_attention]
# the kind of a `ctypes` type as the C side declares it
_TABLE_KIND = {"ptr": "pointer", "int*": "pointer", "int": "int",
               "i64": "long long", "f32": "float"}
_ENTRY = re.compile(r'extern\s+"C"\s+int\s+(\w+)\s*\(([^)]*)\)')


def _kind(param: str) -> str:
    p = " ".join(param.split())
    if "*" in p:
        return "pointer"
    for kind in ("long long", "float", "int"):
        if re.search(rf"\b{kind}\b", p):
            return kind
    raise ValueError(f"unknown parameter type: {param!r}")


def c_entries(text: str) -> dict:
    """{name: [kind, ...]} of the ``extern "C" int`` functions of a
    source (comments stripped)."""
    text = re.sub(r"//[^\n]*", "", text)
    return {name: [_kind(p) for p in params.split(",")
                   if p.strip() not in ("", "void")]
            for name, params in _ENTRY.findall(text)}


@pytest.mark.parametrize("module", MODULES, ids=lambda m: m.SOURCE)
def test_argtypes_match_the_c_signatures(module):
    with open(_build.source_path(module.SOURCE)) as f:
        signatures = c_entries(f.read())
    assert set(signatures) == set(module.C_ENTRIES)
    for name, kinds in module.C_ENTRIES.items():
        assert [_TABLE_KIND[k] for k in kinds] == signatures[name], name


def test_every_source_has_a_table():
    sources = {os.path.basename(p)[:-3] for p in glob.glob(os.path.join(
        os.path.dirname(_build.source_path("nn")), "*.cu"))}
    assert sources == {m.SOURCE for m in MODULES}


def test_parser_reads_count_and_kind():
    text = '''
    // extern "C" int commented(float* x);
    extern "C" int f(const float* a, void* b, int c, long long d,
                     float e, const int* w, void* stream) {
    extern "C" int g() { return 1; }
    extern "C" int h(void) { return 1; }
    '''
    assert c_entries(text) == {
        "f": ["pointer", "pointer", "int", "long long", "float", "pointer",
              "pointer"], "g": [], "h": []}
    # a table that passes the long long as an int does not match
    wrong = ("ptr", "ptr", "int", "int", "f32", "int*", "ptr")
    assert [_TABLE_KIND[k] for k in wrong] != c_entries(text)["f"]


def test_kinds_have_the_c_widths():
    assert ctypes.sizeof(_build.KINDS["ptr"]) == ctypes.sizeof(ctypes.c_void_p)
    assert ctypes.sizeof(_build.KINDS["int*"]) == ctypes.sizeof(
        ctypes.c_void_p)
    assert ctypes.sizeof(_build.KINDS["int"]) == 4
    assert ctypes.sizeof(_build.KINDS["i64"]) == 8
    assert ctypes.sizeof(_build.KINDS["f32"]) == 4
    assert set(_build.KINDS) == set(_TABLE_KIND)


def test_ptxas_report_is_parsed():
    log = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z1kPf' for 'sm_90a'
ptxas info    : Function properties for _Z1kPf
    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 94 registers, used 1 barriers, 8192 bytes smem, 400 bytes cmem[0]
ptxas info    : Function properties for _Z6helperv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Compiling entry function '_Z1gv' for 'sm_90a'
ptxas info    : Function properties for _Z1gv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 12 registers, 360 bytes cmem[0]
"""
    assert _build.parse_ptxas(log) == [
        {"kernel": "_Z1kPf", "spill_stores": 8, "spill_loads": 4,
         "registers": 94, "smem_bytes": 8192},
        {"kernel": "_Z1gv", "spill_stores": 0, "spill_loads": 0,
         "registers": 12, "smem_bytes": 0}]
