"""io/hdf5.py: the built-in HDF5 subset, round-tripped against h5py in
both directions (h5py is a test-only dependency here)."""

import json

import h5py
import numpy as np
import pytest

from hichap_master_tpu.io import hdf5


def _fill(f):
    """The structures a cooler file uses, written through either API."""
    g = f.create_group("10000")
    g.attrs["format"] = "HDF5::Cooler"
    g.attrs["nbins"] = 12
    g.attrs["sum"] = 3.5
    g.attrs["metadata"] = json.dumps({"onlyIntra": "True", "pad": "x" * 5000})
    g.create_dataset("chroms/name", data=np.array([b"1", b"X"], "S64"))
    g.create_dataset("chroms/length", data=np.array([5, 6], np.int32))
    for i in range(20):  # more members than one symbol-table node holds
        g.create_dataset(f"bins/c{i:02d}", data=np.arange(i + 1) * 0.5)
    g.create_dataset("pixels/bin1_id", data=np.arange(7, dtype=np.int64))
    g.create_dataset("pixels/empty", data=np.zeros(0, np.int64))


def _check(f):
    g = f["10000"]
    assert g.attrs["format"] == "HDF5::Cooler"
    assert int(g.attrs["nbins"]) == 12 and float(g.attrs["sum"]) == 3.5
    assert json.loads(g.attrs["metadata"])["onlyIntra"] == "True"
    assert list(g["chroms/name"][:]) == [b"1", b"X"]
    assert g["chroms/length"][:].dtype == np.int32
    assert sorted(g["bins"].keys()) == [f"c{i:02d}" for i in range(20)]
    np.testing.assert_array_equal(g["bins/c19"][:], np.arange(20) * 0.5)
    np.testing.assert_array_equal(g["pixels/bin1_id"][:], np.arange(7))
    assert g["pixels/empty"][:].size == 0


def test_ours_read_by_h5py(tmp_path):
    p = str(tmp_path / "ours.h5")
    with hdf5.File(p, "w") as f:
        _fill(f)
    with h5py.File(p, "r") as f:
        _check(f)
        assert isinstance(f["10000"].attrs["format"], str)
        assert f["10000"].attrs["nbins"].shape == ()  # scalar attribute


def test_h5py_read_by_ours(tmp_path):
    p = str(tmp_path / "theirs.h5")
    with h5py.File(p, "w") as f:
        _fill(f)
    with hdf5.File(p, "r") as f:
        _check(f)


@pytest.mark.parametrize("writer", ["ours", "h5py"])
def test_append_then_read_by_both(tmp_path, writer):
    """Copy-on-write appends by this module onto a file either side wrote:
    delete, replace and add members, rewrite attributes."""
    p = str(tmp_path / "a.h5")
    with (hdf5.File(p, "w") if writer == "ours" else h5py.File(p, "w")) as f:
        _fill(f)
    with hdf5.File(p, "a") as f:
        del f["10000/bins"]["c00"]
        f["10000/bins"].create_dataset("weight", data=np.full(3, np.nan))
        f["10000"].attrs["nbins"] = 13
        f.require_group("/40000").attrs["bin-size"] = 40000
    for opener in (h5py.File, hdf5.File):
        with opener(p, "r") as f:
            assert "c00" not in f["10000/bins"]
            assert np.isnan(f["10000/bins/weight"][:]).all()
            assert int(f["10000"].attrs["nbins"]) == 13
            assert int(f["40000"].attrs["bin-size"]) == 40000
            np.testing.assert_array_equal(f["10000/bins/c19"][:],
                                          np.arange(20) * 0.5)


def test_h5py_appends_to_ours(tmp_path):
    p = str(tmp_path / "b.h5")
    with hdf5.File(p, "w") as f:
        _fill(f)
    with h5py.File(p, "a") as f:
        f["10000/pixels"].create_dataset("count", data=np.ones(4))
        f["10000"].attrs["nnz"] = 9
    with hdf5.File(p, "r") as f:
        _check(f)
        np.testing.assert_array_equal(f["10000/pixels/count"][:], np.ones(4))
        assert int(f["10000"].attrs["nnz"]) == 9


def test_dataset_indexing(tmp_path):
    p = str(tmp_path / "s.h5")
    with hdf5.File(p, "w") as f:
        f.create_dataset("v", data=np.arange(10, dtype=np.int64) * 3)
    with hdf5.File(p, "r") as f:
        v = f["v"]
        assert len(v) == 10
        np.testing.assert_array_equal(v[2:5], [6, 9, 12])
        assert v[3] == 9 and v[-1] == 27
        assert v[8:100].tolist() == [24, 27]
        with pytest.raises(IndexError):
            v[10]
        with pytest.raises(IndexError):
            v[::3]


def test_failed_write_keeps_previous_file(tmp_path):
    p = str(tmp_path / "c.h5")
    with hdf5.File(p, "w") as f:
        _fill(f)
    with pytest.raises(RuntimeError):
        with hdf5.File(p, "a") as f:
            del f["10000"]
            raise RuntimeError("interrupted")
    with h5py.File(p, "r") as f:
        _check(f)


def test_unsupported_layout_falls_back_to_h5py(tmp_path):
    from hichap_master_tpu.io.cooler import _open

    p = str(tmp_path / "chunked.h5")
    with h5py.File(p, "w") as f:
        f.create_dataset("x", data=np.arange(100), chunks=(10,),
                         compression="gzip")
    with pytest.raises(hdf5.Unsupported):
        hdf5.File(p, "r")
    with _open(p) as f:  # h5py reads what the subset does not
        np.testing.assert_array_equal(f["x"][:], np.arange(100))
