"""The byte counts of the rooflines, one tiny case of each by hand."""
import tiny  # noqa: F401
from harness import needs


def test_peak_rate_is_the_data_sheets():
    assert needs.HBM_BYTES_PER_S == 3.35e12


def test_fold_bytes():
    # 10 items: 10 mask bytes; 6 live: 24 B of cell ids; 4 slots won:
    # 32 B (payload read, ring word written); 6 cells: 72 B.
    assert needs.fold_bytes(10, 6, 4, 6) == 10 + 24 + 32 + 72


def test_one_shot_bytes():
    # 10 items, 8 masked in (time + stratum), 3 won, K=2, S=3, 1 reset.
    carried = 4 * (3 * 6 + 11 * 3 + 2 * 2 + 14)
    assert needs.one_shot_bytes(10, 8, 3, 2, 3, 1) == (
        10 + 64 + 24 + carried + 4 * (3 + 3))
    assert needs.one_shot_bytes(10, 8, 3, 2, 3, 0) == 10 + 64 + 24 + carried


def test_stats_bytes():
    assert needs.stats_bytes(12, 5, 3) == 12 + 40 + 36


def test_whist_bytes():
    # 12 slots, 5 live, 4 in a bin, 2 rows, 3 bins.
    assert needs.whist_bytes(12, 5, 4, 2, 3) == 12 + 20 + 32 + 16 + 48


def test_ingest_bytes():
    assert needs.ingest_bytes(10, 4, 3) == 130 + 16 + 8 * 20


def test_share_of_roofline():
    assert needs.share_of_roofline(3.35e12, 2.0) == 50.0
    assert needs.share_of_roofline(1.0, 0.0) is None
