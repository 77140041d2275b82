"""The port stands alone: no JAX and nothing of the reference package in
``src/repro_torch/`` or ``chip_smoke.py``, and no silent fallback to the
CPU when the card is missing."""
import ast
import importlib.util
from pathlib import Path

import pytest
import torch

from repro_torch import prng
from repro_torch.obs import summarize
from repro_torch.runtime import executor as tex
from repro_torch.runtime import registry as treg
from repro_torch.stream import (GaussianSource, ReplayableStream,
                                StreamAggregator)
from repro_torch.stream.pipeline import (TokenWindowSpec,
                                         synthetic_token_window)
from repro_torch.utils import NoCudaDeviceError

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.module
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")):
            yield node.args[0].value


def test_port_files_found():
    names = {p.name for p in PORT_FILES}
    assert {"executor.py", "oasrs.py", "prng.py", "chip_smoke.py"} <= names


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_and_nothing_of_the_reference(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in FORBIDDEN, f"{path.name} imports {mod}"


def _no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("device", [None, "cuda", "cuda:0"])
def test_entry_points_raise_without_a_card(monkeypatch, device):
    _no_card(monkeypatch)
    cfg = tex.RuntimeConfig(num_strata=3, capacity=8)
    with pytest.raises(NoCudaDeviceError, match="device='cpu'"):
        tex.init_state(cfg, prng.PRNGKey(0), device=device)
    reg = treg.QueryRegistry().register("total", "sum")
    with pytest.raises(NoCudaDeviceError):
        tex.PipelinedExecutor(cfg, reg, prng.PRNGKey(0), device=device)
    with pytest.raises(NoCudaDeviceError):
        StreamAggregator(GaussianSource(), seed=7, device=device)
    with pytest.raises(NoCudaDeviceError):
        ReplayableStream(StreamAggregator(GaussianSource(), device=device),
                         chunk_size=8, rate=16.0)
    with pytest.raises(NoCudaDeviceError):
        synthetic_token_window(TokenWindowSpec(2, 3, 2, 5), 0,
                               device=device)
    args = ["--smoke"] + ([] if device is None else ["--device", device])
    with pytest.raises(NoCudaDeviceError):
        summarize.main(args)


def test_cpu_on_request(monkeypatch):
    _no_card(monkeypatch)
    cfg = tex.RuntimeConfig(num_strata=3, capacity=8)
    state = tex.init_state(cfg, prng.PRNGKey(0), device="cpu")
    assert state.window.intervals.values.device.type == "cpu"
    stream = ReplayableStream(
        StreamAggregator(GaussianSource(), seed=7, device="cpu"),
        chunk_size=8, rate=16.0, disorder=0.5)
    chunk = stream.chunk_at(3)
    assert all(t.device.type == "cpu" for t in (
        chunk.values, chunk.stratum_ids, chunk.times, chunk.mask))
    tokens, _ = synthetic_token_window(TokenWindowSpec(2, 3, 2, 5), 0,
                                       device="cpu")
    assert tokens.device.type == "cpu"


def test_summarize_smoke_on_the_cpu(monkeypatch, capsys):
    _no_card(monkeypatch)
    assert summarize.main(["--smoke", "--device", "cpu"]) == 0
    assert "hw95" in capsys.readouterr().out


def test_chip_smoke_refuses_without_a_card(monkeypatch, capsys):
    _no_card(monkeypatch)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_under_test", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.main([]) != 0
    assert capsys.readouterr().out == ""
