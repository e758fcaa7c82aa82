"""Device matrix fetch paths (io/cooler.py matrix_device / genomewide_device).

The reference fetches dense matrices through the cooler package on the host
(HiCHap/matrixBuilding.py:699-714 balances via cooler; StructureFind.py:854
reads cooler matrices).  Here matrices materialize ON DEVICE: small-P
squares densify host-side and ship in the narrowest exact dtype, large ones
upload as COO and scatter on device.  These tests
pin that every strategy produces the same symmetric dense matrix.
"""

import numpy as np
import pytest

import hichap_master_tpu.io.cooler as cool
from hichap_master_tpu.core.genome import Genome
from hichap_master_tpu.io.cooler import CoolerReader, write_cooler


@pytest.fixture()
def small_cooler(tmp_path):
    rng = np.random.default_rng(7)
    genome = Genome({"1": 40_000, "2": 24_000}, chroms=("1", "2"))
    res = 2_000
    nbins = genome.total_bins(res)  # 20 + 12 = 32
    # unique upper-tri pixels, a few with counts past uint16 range
    iu, ju = np.triu_indices(nbins)
    sel = rng.choice(len(iu), size=len(iu) // 2, replace=False)
    b1, b2 = iu[sel].astype(np.int64), ju[sel].astype(np.int64)
    v = rng.integers(1, 300, size=len(sel)).astype(np.int64)
    v[:3] = 70_000  # force the int32 wire branch
    order = np.lexsort((b2, b1))
    path = str(tmp_path / "t.cool")
    write_cooler(path, genome, res, {},
                 genomewide_coo=(b1[order], b2[order], v[order]),
                 dtype="int")
    return path, genome, res, nbins


def _dense_oracle(reader, nbins):
    b1, b2, v = reader.pixels_coo()
    M = np.zeros((nbins, nbins))
    M[b1, b2] = v
    return M + np.triu(M, 1).T


def test_matrix_device_matches_host_matrix(small_cooler):
    path, genome, res, nbins = small_cooler
    r = CoolerReader(path, res)
    for label in ("1", "2"):
        Mj, n = r.matrix_device(label)
        host = r.matrix(label)
        assert n == host.shape[0]
        np.testing.assert_allclose(np.asarray(Mj)[:n, :n], host)
        # padding stays zero
        assert not np.asarray(Mj)[n:, :].any()


def test_genomewide_device_matches_pixels(small_cooler):
    path, genome, res, nbins = small_cooler
    r = CoolerReader(path, res)
    Mj, S = r.genomewide_device()
    assert S == r.nbins
    np.testing.assert_allclose(np.asarray(Mj)[:S, :S],
                               _dense_oracle(r, S))


def test_scatter_fallback_matches_dense(small_cooler, monkeypatch):
    """Force the giant-P COO-scatter branch and pin parity with the dense
    host-densify branch."""
    path, genome, res, nbins = small_cooler
    r = CoolerReader(path, res)
    dense, _ = r.genomewide_device()
    dense_c, _ = r.matrix_device("1")
    monkeypatch.setattr(cool, "_DENSE_UPLOAD_MAX", 0)
    scat, _ = r.genomewide_device()
    scat_c, _ = r.matrix_device("1")
    np.testing.assert_allclose(np.asarray(scat), np.asarray(dense))
    np.testing.assert_allclose(np.asarray(scat_c), np.asarray(dense_c))


def test_uint16_wire_for_small_counts(tmp_path):
    """Integer counts <= 65535 ride the wire as uint16 without value change;
    float (corrected) counts ride as float32."""
    genome = Genome({"1": 16_000}, chroms=("1",))
    res = 2_000
    b1 = np.array([0, 0, 1, 3], np.int64)
    b2 = np.array([0, 2, 1, 7], np.int64)
    v_int = np.array([65_535, 3, 2, 1], np.int64)
    p_int = str(tmp_path / "i.cool")
    write_cooler(p_int, genome, res, {}, genomewide_coo=(b1, b2, v_int),
                 dtype="int")
    r = CoolerReader(p_int, res)
    M, n = r.matrix_device("1")
    M = np.asarray(M)
    assert M[0, 0] == 65_535 and M[0, 2] == 3 and M[2, 0] == 3

    v_f = np.array([0.5, 2.25, 3.75, 1.125])
    p_f = str(tmp_path / "f.cool")
    write_cooler(p_f, genome, res, {}, genomewide_coo=(b1, b2, v_f),
                 dtype="float")
    rf = CoolerReader(p_f, res)
    Mf, _ = rf.matrix_device("1")
    Mf = np.asarray(Mf)
    assert Mf[0, 2] == 2.25 and Mf[7, 3] == 1.125
