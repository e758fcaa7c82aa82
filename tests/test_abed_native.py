"""Native allelic-bed columnizer (hicio_abed_*) vs the Python fallback
encoder: identical decoded columns, and strict-layout violations fall back
cleanly (native returns None)."""

import numpy as np
import pytest

from hichap_master_tpu.io.native import get_lib, load_allelic_bed
from hichap_master_tpu.pipeline.filtering import _load_frame_fallback

pytestmark = pytest.mark.skipif(get_lib() is None,
                                reason="native hicio unavailable")


def _mk_bed(path, rng, n=400, cand_frac=0.3):
    lines = []
    for i in range(n):
        c1, c2 = str(rng.integers(1, 5)), rng.choice(["2", "X", "11"])
        row = [f"pair{rng.integers(0, 10**6):07d}.{i}", c1, "0",
               str(rng.integers(1, 10**7)), "100", str(-rng.integers(0, 40)),
               str(rng.integers(1, 10**7)), str(rng.integers(0, 4)),
               c2, "16", str(rng.integers(1, 10**7)), "100",
               str(-rng.integers(0, 40)), str(rng.integers(1, 10**7)),
               str(rng.integers(0, 4))]
        if rng.random() < cand_frac:
            row += [rng.choice(["1", "7"]), "0", str(rng.integers(1, 10**7)),
                    "30", str(-rng.integers(0, 40)),
                    str(rng.integers(1, 10**7)), str(rng.integers(0, 4)),
                    rng.choice(["R1", "R2"])]
        lines.append("\t".join(row))
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def test_native_matches_pandas_encoder(tmp_path, rng):
    bed = _mk_bed(tmp_path / "a.bed", rng)
    n_cols, n_labels = load_allelic_bed(bed)
    p_cols, p_labels = _load_frame_fallback(bed)
    assert sorted(n_labels) == sorted(p_labels)
    n_lab = np.array(n_labels + [""], dtype=object)
    p_lab = np.array(p_labels + [""], dtype=object)
    # names decode identically (native width may differ from astype("S"))
    assert n_cols[0].astype("U").tolist() == p_cols[0].astype("U").tolist()
    for c in (1, 8, 15):  # codes decode to the same labels
        assert n_lab[n_cols[c]].tolist() == p_lab[p_cols[c]].tolist()
    for c in (3, 5, 6, 7, 10, 12, 13, 14, 17, 19, 20, 21, 22):
        np.testing.assert_array_equal(n_cols[c], p_cols[c], err_msg=str(c))


def test_pandas_fallback_handles_all_15_col_bed(tmp_path, rng):
    # no candidate rows anywhere: the fallback pads every missing tail
    # and must decode identically to the native path
    bed = _mk_bed(tmp_path / "no_cand.bed", rng, n=50, cand_frac=0.0)
    p_cols, p_labels = _load_frame_fallback(bed)
    n_cols, n_labels = load_allelic_bed(bed)
    assert sorted(n_labels) == sorted(p_labels)
    assert (p_cols[15] == -1).all() and (p_cols[22] == 0).all()
    for c in (3, 5, 6, 7, 10, 12, 13, 14, 17, 19, 20, 21, 22):
        np.testing.assert_array_equal(n_cols[c], p_cols[c], err_msg=str(c))


def test_native_rejects_ragged_width(tmp_path, rng):
    bad = tmp_path / "bad.bed"
    good = "\t".join(["p1", "1", "0", "5", "100", "-3", "4000", "1",
                      "2", "16", "9", "100", "-1", "8000", "0"])
    bad.write_text(good + "\n" + good + "\textra\n")  # 16 columns
    assert load_allelic_bed(str(bad)) is None


def test_native_rejects_bad_tag(tmp_path):
    row = ["p1", "1", "0", "5", "100", "-3", "4000", "1",
           "2", "16", "9", "100", "-1", "8000", "0",
           "1", "0", "7", "30", "-2", "4000", "2", "R9"]
    bad = tmp_path / "tag.bed"
    bad.write_text("\t".join(row) + "\n")
    assert load_allelic_bed(str(bad)) is None


def test_native_empty_file(tmp_path):
    empty = tmp_path / "empty.bed"
    empty.write_text("")
    cols, labels = load_allelic_bed(str(empty))
    assert cols[0].size == 0 and labels == []
