"""PDF plot outputs (C24): smoke the matplotlib paths end-to-end."""

import os

import numpy as np
import pytest

from hichap_master_tpu.core import Genome
from hichap_master_tpu.io import CoolerReader, write_cooler

RES = 40_000


def _find_pdfs(root):
    out = []
    for d, _, fs in os.walk(root):
        out += [os.path.join(d, f) for f in fs if f.endswith(".pdf")]
    return out


@pytest.fixture
def cool(tmp_path, rng):
    g = Genome({"1": 4_000_000})
    n = g.n_bins("1", RES)
    i = np.arange(n)
    d = np.abs(np.subtract.outer(i, i)) + 1.0
    lam = 60.0 / d**0.8
    same = np.equal.outer(i // 20, i // 20)
    M = rng.poisson(lam * np.where(same, 4.0, 1.0)).astype(np.float32)
    M = np.triu(M) + np.triu(M, 1).T
    path = str(tmp_path / "p.cool")
    write_cooler(path, g, RES, {"1": M})
    r = CoolerReader(path, RES)
    r.set_weights(np.ones(r.nbins))
    return path


def test_compartment_plot(cool, tmp_path):
    from hichap_master_tpu.models.compartment import run_compartment

    out = str(tmp_path / "PC")
    run_compartment(cool, RES, False, out, plot=True)
    pdfs = _find_pdfs(tmp_path)
    assert pdfs, "compartment plot PDF missing"
    assert all(os.path.getsize(f) > 1000 for f in pdfs)


def test_tads_plot(cool, tmp_path):
    from hichap_master_tpu.models.tads import run_tads

    out = str(tmp_path / "TAD")
    run_tads(cool, RES, False, out, min_tad=120_000, window=400_000,
             plot=True)
    assert _find_pdfs(tmp_path), "TAD plot PDF missing"


def test_loops_plot(cool, tmp_path):
    from hichap_master_tpu.models.loops import run_loops

    out = str(tmp_path / "LP")
    run_loops(cool, RES, False, out, loop_strength=4, plot=True)
    assert _find_pdfs(tmp_path), "loops plot PDF missing"


def test_plot_without_matplotlib_says_so(monkeypatch):
    import sys

    import pytest

    from hichap_master_tpu.utils.optional import require_matplotlib

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="--plot needs matplotlib"):
        require_matplotlib()
