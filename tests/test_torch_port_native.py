"""The port's native neighbour list (``graph/native.py`` over
``csrc/neighborlist.cpp``) against the JAX package's and the numpy one.

``build_edges`` must give ``build_edges_np``'s arrays as they are, in the
same order (the ELL collation fills slots in that order), and the JAX
package's ``build_edges_native``'s: frames of 10-4,200 atoms, with and
without self-loops, the neighbour cap engaged, and the cases where the
float32 distance decides (ties of the cap, a distance that rounds onto the
cutoff).  A failed build or load raises; concurrent builds are safe.
"""

import subprocess
import sys

import numpy as np
import pytest

from gotennet_tpu.graph.native import build_edges_native as j_build_native
from gotennet_tpu.graph.native import native_available as j_native_available

from gotennet_tpu_torch.data.dataset import synthetic_molecules
from gotennet_tpu_torch.graph import native
from gotennet_tpu_torch.graph.native import build_edges
from gotennet_tpu_torch.graph.neighborlist import build_edges_np


def _assert_same(got, want):
    for g, w in zip(got, want):
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("loop", [True, False])
@pytest.mark.parametrize("sizes", [(10, 40, 6), (110, 120, 3),
                                   (600, 700, 2), (4000, 4200, 1)],
                         ids=["10-40", "110-120", "600-700", "4000-4200"])
def test_edges_match_numpy_and_jax_in_order(sizes, loop):
    lo, hi, n = sizes
    ds = synthetic_molecules(n, seed=lo, min_atoms=lo, max_atoms=hi,
                             box=6.3)
    assert j_native_available()
    for pos in ds.pos:
        got = build_edges(pos, 5.0, loop, 32)
        _assert_same(got, build_edges_np(pos, 5.0, loop, 32))
        _assert_same(got, j_build_native(pos, 5.0, loop, 32))


@pytest.mark.parametrize("loop", [True, False])
def test_cap_keeps_the_nearest_in_index_order(loop):
    """A dense blob: every atom has more than 5 neighbours within the
    cutoff, so the cap picks the 5 nearest and lists them by index."""
    rng = np.random.default_rng(0)
    pos = (rng.random((60, 3)) * 3.0).astype(np.float32)
    got = build_edges(pos, 5.0, loop, 5)
    assert np.all(np.bincount(got[1]) == 5 + loop)
    _assert_same(got, build_edges_np(pos, 5.0, loop, 5))
    _assert_same(got, j_build_native(pos, 5.0, loop, 5))


def test_float32_distance_decides_as_numpy_does():
    """Atoms placed where the squared distance and the float32 distance
    disagree (positions found by a search over float32 values): atoms 1 and
    2 are at the same float32 distance 2.5 from atom 0 though atom 2's
    square is smaller (numpy's stable argsort keeps the lower index), and
    atom 3's distance rounds onto the cutoff 5.0 while its square is below
    25 (numpy leaves it out).  The port follows numpy."""
    f = np.float32
    pos = np.zeros((5, 3), np.float32)
    pos[1] = [2.5, 0.0, 0.0]
    pos[2] = [2.399123, 0.703, 0.0]
    pos[3] = [0.0, 4.9504743, 0.70199996]
    pos[4] = [-3.0, 0.0, 0.0]
    sq = [f(f(f(p[0] * p[0]) + f(p[1] * p[1])) + f(p[2] * p[2]))
          for p in pos]
    assert sq[2] < sq[1] and np.sqrt(sq[2]) == np.sqrt(sq[1]) == f(2.5)
    assert sq[3] < f(25.0) and np.sqrt(sq[3]) == f(5.0)
    for cap in (1, 2, 32):
        for loop in (True, False):
            _assert_same(build_edges(pos, 5.0, loop, cap),
                         build_edges_np(pos, 5.0, loop, cap))
    src, dst = build_edges(pos, 5.0, False, 1)
    assert src[dst == 0].tolist() == [1]
    src, dst = build_edges(pos, 5.0, False, 32)
    assert 3 not in src[dst == 0] and 0 not in src[dst == 3]


def test_empty_and_single_atom_frames_and_bad_shapes():
    for n in (0, 1):
        pos = np.zeros((n, 3), np.float32)
        _assert_same(build_edges(pos, 5.0, True, 32),
                     build_edges_np(pos, 5.0, True, 32))
    with pytest.raises(ValueError, match=r"\[n, 3\]"):
        build_edges(np.zeros((4, 2), np.float32), 5.0)
    with pytest.raises(ValueError, match="max_num_neighbors"):
        build_edges(np.zeros((4, 3), np.float32), 5.0, True, -1)


@pytest.fixture
def fresh(monkeypatch, tmp_path):
    """A build directory of its own and no library loaded yet."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_lib", None)
    return tmp_path


def test_failed_build_raises(fresh, monkeypatch):
    bad = fresh / "neighborlist.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    with pytest.raises(RuntimeError, match="building neighborlist.cpp"):
        build_edges(np.zeros((3, 3), np.float32), 5.0)
    monkeypatch.setattr(native, "CXX", "no-such-compiler-here")
    with pytest.raises(RuntimeError, match="not found"):
        build_edges(np.zeros((3, 3), np.float32), 5.0)


def test_failed_load_raises(fresh, monkeypatch):
    junk = fresh / "libjunk.so"
    junk.write_bytes(b"not a shared library")
    monkeypatch.setattr(native, "_target", lambda: junk)
    with pytest.raises(RuntimeError, match="loading"):
        build_edges(np.zeros((3, 3), np.float32), 5.0)


_BUILD = r"""
import sys
from gotennet_tpu_torch.graph import native
native.BUILD_DIR = native.Path(sys.argv[1])
print(native.build_library())
"""


def test_concurrent_builds_and_the_source_stay_in_the_package(tmp_path):
    """Four processes building into one empty directory at once all get
    the same whole library; its source is the package's own copy."""
    root = native.Path(native.__file__).resolve().parents[2]
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD, str(tmp_path)],
                              stdout=subprocess.PIPE, text=True, cwd=root)
             for _ in range(4)]
    outs = [p.communicate(timeout=120)[0].strip() for p in procs]
    assert all(p.returncode == 0 for p in procs)
    assert len(set(outs)) == 1
    assert [p.name for p in tmp_path.iterdir()] == [
        native._target().name]
    package = native.Path(native.__file__).resolve().parents[1]
    assert native.SOURCE.parent == package / "csrc"
