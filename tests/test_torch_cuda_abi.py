"""The C interface of the port's CUDA kernels, checked without a GPU.

ctypes passes every argument as its ``argtypes`` say; a table that
disagrees with a C signature corrupts memory silently on the card.  So
every ``extern "C"`` function of ``ngspeciesid_tpu_torch/csrc/*.cu`` must
have an entry in ``cuda_lib.SIGNATURES`` with as many parameters, pointers
and ints in the same order, and the same return kind.  The launch geometry
that ``cuda_lib`` computes for the wavefront kernels must fit a block and
cover the window, and its constants must equal the CUDA sources'.
"""

import ctypes
import glob
import os
import re

import pytest

from ngspeciesid_tpu_torch.ops import cuda_lib

CSRC = cuda_lib.CSRC
POINTERS = (ctypes.c_void_p, ctypes.c_char_p)


def c_functions():
    """{name: (return type, [parameter types])} of every extern "C"
    function defined in csrc/*.cu."""
    out = {}
    for path in sorted(glob.glob(os.path.join(CSRC, "*.cu"))):
        src = open(path).read()
        for block in re.findall(r'extern "C" \{(.*?)\}\s*// extern "C"',
                                src, re.S):
            block = re.sub(r"//[^\n]*", "", block)
            for ret, name, params in re.findall(
                    r"^([A-Za-z_][\w\s\*]*?[\s\*])(ngsid_\w+)\s*\(([^)]*)\)\s*\{",
                    block, re.M):
                types = [" ".join(p.split()[:-1]) + ("*" if "*" in p.split()[-1]
                                                     else "")
                         for p in params.split(",") if p.strip()]
                out[name] = (ret.strip(), types)
    return out


def kind(c_type):
    """'pointer' or 'int' for a C type; anything else fails the test."""
    if "*" in c_type:
        return "pointer"
    assert c_type == "int", c_type
    return "int"


def ctypes_kind(t):
    if t in POINTERS or isinstance(t, type) and issubclass(
            t, ctypes._Pointer):
        return "pointer"
    assert t is ctypes.c_int, t
    return "int"


def test_sources_define_the_kernels_entry_points():
    found = c_functions()
    assert {"ngsid_stats_launch", "ngsid_moves_launch",
            "ngsid_full_dp_launch", "ngsid_error_string"} <= set(found)


@pytest.mark.parametrize("name", sorted(cuda_lib.SIGNATURES))
def test_signature_table_matches_the_source(name):
    found = c_functions()
    assert name in found, f"{name} is in SIGNATURES but in no csrc/*.cu"
    ret, params = found[name]
    argtypes, restype = cuda_lib.SIGNATURES[name]
    assert [kind(p) for p in params] == [ctypes_kind(t) for t in argtypes]
    assert kind(ret) == ctypes_kind(restype)


def test_every_entry_point_has_a_signature():
    assert set(c_functions()) == set(cuda_lib.SIGNATURES)


def constant(path, name):
    src = open(os.path.join(CSRC, path)).read()
    found = re.search(rf"constexpr int {name} = ([^;]+);", src)
    assert found, name
    return found.group(1).strip()


def test_geometry_constants_equal_the_sources():
    assert int(constant("wavefront.cuh", "kMaxBlockThreads")) == \
        cuda_lib.MAX_BLOCK_THREADS
    assert int(constant("wavefront.cuh", "kMaxPairs")) == cuda_lib.MAX_PAIRS
    assert int(constant("wavefront.cuh", "kMemThreads")) == \
        cuda_lib.MEM_THREADS
    # the full DP launches with the moves kernel's geometries
    for kind_, path, policy in (("stats", "stats_kernel.cu", "StatsK"),
                                ("moves", "moves_kernel.cu", "MovesK"),
                                ("moves", "full_dp_kernel.cu", "FullK")):
        src = open(os.path.join(CSRC, path)).read()
        found = re.findall(rf"wf::launch<{policy}(?:<\w+>)?, ([\d, ]+)>",
                           src)
        assert found, path
        for lanes in found:
            assert tuple(int(x) for x in lanes.split(",")) == \
                cuda_lib.REGISTER_LANES[kind_]
    # wf::block_threads: the stats kernel's widest instantiation takes 256
    rule = re.search(r"\(!K::kMoves && L >= (\d+)\) \? (\d+) : kMaxBlockThreads",
                     open(os.path.join(CSRC, "wavefront.cuh")).read())
    assert rule, "wf::block_threads"
    wide, threads = int(rule.group(1)), int(rule.group(2))
    for kind_ in ("stats", "moves"):
        for L in cuda_lib.REGISTER_LANES[kind_]:
            want = (threads if kind_ == "stats" and L >= wide
                    else cuda_lib.MAX_BLOCK_THREADS)
            assert cuda_lib.block_threads(kind_, L) == want


@pytest.mark.parametrize("kind_", ["stats", "moves"])
@pytest.mark.parametrize("source", ["launch_geometry", "geometries"])
def test_launch_geometry_fits_a_block_and_covers_the_window(kind_, source):
    for W in range(128, 8192 + 1, 128):
        if source == "launch_geometry":
            found = [cuda_lib.launch_geometry(kind_, W, B, sms)
                     for B in (1, 2, 7, 64, 100, 128, 133, 512, 1000, 4096)
                     for sms in (132, 114, 1)]
        else:
            found = cuda_lib.geometries(kind_, W)
            assert found[-1].memory and not any(g.memory for g in found[:-1])
        for g in found:
            assert 1 <= g.threads <= min(1024, cuda_lib.MAX_BLOCK_THREADS)
            assert 1 <= g.pairs <= cuda_lib.MAX_PAIRS
            assert g.warps == 1 or g.pairs <= 15   # named barriers 1-15
            if g.memory:
                assert (g.lanes, g.pairs) == (1, 1)
                assert g.warps * 32 == cuda_lib.MEM_THREADS
            else:
                assert g.lanes in cuda_lib.REGISTER_LANES[kind_]
                assert g.warps * 32 * g.lanes == W
                assert g.threads <= cuda_lib.block_threads(kind_, g.lanes)


def test_launch_geometry_follows_the_launch_size():
    # few pairs: the shortest chain per diagonal; a 4096-pair wave: more
    # lanes per thread and several pairs per block; windows too wide for a
    # block's registers: memory mode
    small = cuda_lib.launch_geometry("stats", 256, 128, 132)
    wave = cuda_lib.launch_geometry("stats", 256, 4096, 132)
    assert small.lanes < wave.lanes and small.pairs == 1 < wave.pairs
    assert cuda_lib.launch_geometry("stats", 3200, 2, 132).memory
    assert not cuda_lib.launch_geometry("moves", 1664, 8, 132).memory
    # pairs packed to whole groups of four warps where they fit a block:
    # the full DP's polish shape (W 768) and the moves and stats kernels'
    # 512- and 4096-pair shapes (W 256)
    assert tuple(cuda_lib.launch_geometry("moves", 768, 512, 132)) == \
        (8, 3, 4, False)
    assert tuple(cuda_lib.launch_geometry("moves", 256, 512, 132)) == \
        (8, 1, 4, False)
    assert tuple(cuda_lib.launch_geometry("stats", 256, 4096, 132)) == \
        (4, 2, 2, False)
    assert cuda_lib.launch_geometry("moves", 1152, 100, 132).pairs == 1


def _package_data(package):
    """The ``package_data`` patterns that setup.py gives ``package``."""
    import ast

    with open(os.path.join(os.path.dirname(CSRC), "..", "setup.py")) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.keyword) and node.arg == "package_data":
            return ast.literal_eval(node.value)[package]
    raise AssertionError("setup.py has no package_data")


def test_install_ships_every_kernel_source():
    """A non-editable install must carry every file that cuda_lib.build()
    hands to nvcc, the headers included."""
    import fnmatch

    patterns = _package_data("ngspeciesid_tpu_torch")
    names = sorted(os.listdir(CSRC))
    assert any(n.endswith(".cuh") for n in names)
    for name in names:
        assert any(fnmatch.fnmatch(f"csrc/{name}", p) for p in patterns), name
