"""On the card: each cell at the tiny size, the kernels' path held to the
reference (run on the chip with ``python -m pytest -m cuda
streambench/tests``)."""
import pytest

import tiny


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is "
                    "False")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in
                                  tiny.benchmark()["workloads"]])
def test_cell_on_the_card_is_correct(card, tmp_path, monkeypatch, cell):
    r = tiny.run(cell, tmp_path, monkeypatch, seed=2 ** 31 + 5,
                 trace=True, cpu=False)
    assert r["correct"] is True
    assert r["device"]["busy_s"] > 0
    assert r["metrics"]["ingest.launches_per_chunk"]["value"] > 0
