"""bedio parsing units: ragged valid-bed columns, unknown-chrom filtering,
streaming == batch, tag mapping."""

import numpy as np
import pytest

from hichap_master_tpu.core import Genome
from hichap_master_tpu.io.bedio import (TAG_BOTH, TAG_R1, TAG_R2,
                                        iter_allelic_bed, iter_valid_bed,
                                        read_allelic_bed, read_valid_bed)


@pytest.fixture
def genome():
    return Genome({"1": 1_000_000, "2": 1_000_000})


def _valid_line(c1, p1, c2, p2, ncols):
    # 23-col reference layout; only fields 1,6,8,13 are consumed
    f = ["x"] * ncols
    f[1], f[6], f[8], f[13] = str(c1), str(p1), str(c2), str(p2)
    return "\t".join(f)


def test_read_valid_bed_ragged_and_filtered(tmp_path, genome):
    p = tmp_path / "v.bed"
    p.write_text("\n".join([
        _valid_line("1", 100, "2", 200, 15),
        _valid_line("2", 300, "1", 400, 23),   # ragged widths mix
        _valid_line("chrUn", 1, "1", 2, 15),   # unknown chrom dropped
    ]) + "\n")
    c1, p1, c2, p2 = read_valid_bed([str(p)], genome)
    assert list(p1) == [100, 300] and list(p2) == [200, 400]
    assert c1.tolist() == [0, 1] and c2.tolist() == [1, 0]


def test_iter_valid_matches_batch(tmp_path, genome):
    rng = np.random.default_rng(0)
    p = tmp_path / "big.bed"
    lines = [_valid_line(str(rng.integers(1, 3)), rng.integers(0, 1_000_000),
                         str(rng.integers(1, 3)), rng.integers(0, 1_000_000),
                         15) for _ in range(500)]
    p.write_text("\n".join(lines) + "\n")
    batch = read_valid_bed([str(p)], genome)
    parts = list(iter_valid_bed([str(p)], genome, read_bytes=512))
    assert len(parts) > 1, "streaming should chunk"
    streamed = [np.concatenate([pt[i] for pt in parts]) for i in range(4)]
    for a, b in zip(batch, streamed):
        np.testing.assert_array_equal(a, b)


def test_native_parser_matches_pandas(tmp_path, genome, monkeypatch):
    """The C scanner (hicio_parse_valid_chunk) and the pandas path must
    agree exactly: chr-prefix stripping, unknown-chrom drops, ragged
    15/23-column widths, chunk boundaries mid-line."""
    from hichap_master_tpu.io.native import get_lib

    if get_lib() is None:
        pytest.skip("native hicio unavailable")
    rng = np.random.default_rng(3)
    p = tmp_path / "mix.bed"
    names = ["1", "chr1", "2", "chr2", "chrUn", "7"]
    lines = [_valid_line(names[rng.integers(0, len(names))],
                         rng.integers(0, 1_000_000),
                         names[rng.integers(0, len(names))],
                         rng.integers(0, 1_000_000),
                         int(rng.choice([15, 23]))) for _ in range(800)]
    p.write_text("\n".join(lines) + "\n")

    def collect():
        parts = list(iter_valid_bed([str(p)], genome, read_bytes=777))
        return [np.concatenate([pt[i] for pt in parts]) for i in range(4)]

    monkeypatch.setenv("HICHAP_NATIVE_BED", "1")
    native = collect()
    monkeypatch.setenv("HICHAP_NATIVE_BED", "0")
    pandas_ = collect()
    for a, b in zip(native, pandas_):
        np.testing.assert_array_equal(a, b)


def test_native_allelic_parser_matches_pandas(tmp_path, genome, monkeypatch):
    """The C allelic scanner (hicio_parse_allelic_chunk) and the pandas
    path must agree exactly: chr-prefix stripping, unknown-chrom drops,
    Both/R1/R2/garbage tag codes, both with_tag flavors, tiny chunk_rows
    (chunk boundaries mid-stream)."""
    from hichap_master_tpu.io.native import get_lib

    if get_lib() is None:
        pytest.skip("native hicio unavailable")
    rng = np.random.default_rng(5)
    p = tmp_path / "alle.bed"
    names = ["1", "chr1", "2", "chr2", "chrUn", "7"]
    tags = ["Both", "R1", "R2", "XX"]
    lines = ["%s\t%d\t%s\t%d\t%s" % (
        names[rng.integers(0, len(names))], rng.integers(0, 1_000_000),
        names[rng.integers(0, len(names))], rng.integers(0, 1_000_000),
        tags[rng.integers(0, len(tags))]) for _ in range(700)]
    p.write_text("\n".join(lines) + "\n")

    for with_tag in (True, False):
        w = 5 if with_tag else 4

        def collect():
            parts = list(iter_allelic_bed([str(p)], genome, with_tag,
                                          chunk_rows=37))
            return [np.concatenate([pt[i] for pt in parts])
                    for i in range(w)]

        monkeypatch.setenv("HICHAP_NATIVE_BED", "1")
        native = collect()
        monkeypatch.setenv("HICHAP_NATIVE_BED", "0")
        pandas_ = collect()
        for a, b in zip(native, pandas_):
            np.testing.assert_array_equal(a, b)


def test_native_scanners_handle_crlf(tmp_path, genome, monkeypatch):
    """CRLF beds (Windows-edited inputs) must parse identically through
    the native scanners and pandas — a round-3 review caught the native
    allelic path dropping every row (trailing \\r broke the numeric
    field) and miscoding every tag to -1."""
    from hichap_master_tpu.io.native import get_lib

    if get_lib() is None:
        pytest.skip("native hicio unavailable")
    a = tmp_path / "crlf_allelic.bed"
    a.write_bytes(b"1\t100\t2\t200\tBoth\r\n2\t300\t1\t400\tR1\r\n")
    v = tmp_path / "crlf_valid.bed"
    row = "\t".join(["r1", "1", "+", "100", "60", "100", "100", "f1",
                     "2", "-", "200", "60", "100", "200", "f2"])
    v.write_bytes((row + "\r\n" + row + "\r\n").encode())

    outs = {}
    for env in ("1", "0"):
        monkeypatch.setenv("HICHAP_NATIVE_BED", env)
        parts = list(iter_allelic_bed([str(a)], genome, True))
        outs[env] = [np.concatenate([pt[i] for pt in parts])
                     for i in range(5)]
        vparts = list(iter_valid_bed([str(v)], genome))
        outs[env] += [np.concatenate([pt[i] for pt in vparts])
                      for i in range(4)]
    assert outs["1"][4].tolist() == [0, 1]  # Both, R1 — not -1
    assert len(outs["1"][5]) == 2  # valid rows kept
    for x, y in zip(outs["1"], outs["0"]):
        np.testing.assert_array_equal(x, y)


def test_allelic_tagless_rows_default_minus_one(tmp_path, genome,
                                                monkeypatch):
    """A with_tag read of a bed whose rows have NO 5th column yields
    tag=-1 for those rows (the old tolerant per-line reader's behavior)
    through BOTH parse paths — a review found the pandas path raising
    and the native scanner dropping such rows."""
    p = tmp_path / "tagless.bed"
    p.write_text("1\t100\t2\t200\n"            # no tag
                 "2\t300\t1\t400\tR1\n"        # tagged
                 "1\t500\t1\t600\n")           # no tag
    for env in ("1", "0"):
        monkeypatch.setenv("HICHAP_NATIVE_BED", env)
        parts = list(iter_allelic_bed([str(p)], genome, True))
        tag = np.concatenate([pt[4] for pt in parts])
        assert tag.tolist() == [-1, TAG_R1, -1], env
        assert sum(len(pt[0]) for pt in parts) == 3


def test_allelic_tags_and_stream(tmp_path, genome):
    p = tmp_path / "a.bed"
    p.write_text("1\t100\t2\t200\tBoth\n"
                 "2\t300\t1\t400\tR1\n"
                 "1\t500\t1\t600\tR2\n")
    c1, p1, c2, p2, tag = read_allelic_bed([str(p)], genome, with_tag=True)
    assert tag.tolist() == [TAG_BOTH, TAG_R1, TAG_R2]
    parts = list(iter_allelic_bed([str(p)], genome, True, chunk_rows=1))
    assert len(parts) == 3, "chunk_rows must bound the streamed block size"
    streamed = np.concatenate([pt[4] for pt in parts])
    np.testing.assert_array_equal(streamed, tag)


def test_python_valid_parser_matches_native_chunk(genome):
    """The Python fallback (_parse_valid_lines) against the native scanner
    on one block: ragged 15/23-column rows, CRLF, blank lines, unknown and
    chr-prefixed chromosomes."""
    from hichap_master_tpu.io.bedio import _parse_valid_lines, label_index
    from hichap_master_tpu.io.native import get_lib, parse_valid_chunk

    if get_lib() is None:
        pytest.skip("native hicio unavailable")
    rng = np.random.default_rng(11)
    names = ["1", "chr2", "chrUn", "2", "X9"]
    rows = [_valid_line(names[rng.integers(0, 5)], rng.integers(0, 10**6),
                        names[rng.integers(0, 5)], rng.integers(0, 10**6),
                        int(rng.choice([15, 23]))) for _ in range(300)]
    text = "\r\n".join(rows[:150]) + "\n\n" + "\n".join(rows[150:]) + "\n"
    py = _parse_valid_lines(text.splitlines(keepends=True),
                            label_index(genome))
    nat = parse_valid_chunk(text.encode(), genome.labels)
    for a, b in zip(py, nat):
        np.testing.assert_array_equal(a, b)
    assert len(py[0]) > 0


def test_python_parsers_reject_short_rows():
    from hichap_master_tpu.io.bedio import _split_rows

    assert _split_rows(["a\tb\tc\td\n", "\n"], 4) == [["a", "b", "c", "d"]]
    with pytest.raises(ValueError):
        _split_rows(["a\tb\tc\n"], 4)
