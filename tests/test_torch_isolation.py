"""The port stands alone: no JAX and nothing of the reference package in
``src/repro_torch/`` or ``chip_smoke.py``, and no silent fallback to the
CPU when the card is missing."""
import ast
import importlib.util
from pathlib import Path

import pytest
import torch

from repro_torch import configs as tcfgs
from repro_torch import prng
from repro_torch.launch import serve as tlaunch
from repro_torch.launch import train as ttrain
from repro_torch.models import api as tapi
from repro_torch.models import kvcache as tkvc
from repro_torch.models import param as tparam
from repro_torch.obs import summarize
from repro_torch.runtime import executor as tex
from repro_torch.runtime import registry as treg
from repro_torch.stream import (GaussianSource, ReplayableStream,
                                StreamAggregator)
from repro_torch.serve.serve_step import Server
from repro_torch.stream.pipeline import (TokenWindowSpec,
                                         synthetic_token_window)
from repro_torch.utils import NoCudaDeviceError

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "chip_compare.py"] + [
    ROOT / "examples" / f"torch_{name}.py" for name in (
        "approx_training", "quickstart", "network_traffic", "taxi_rides",
        "streaming_runtime", "observability", "serve_telemetry")]
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
    assert {"executor.py", "oasrs.py", "prng.py", "chip_smoke.py",
            "sentinel.py", "param.py", "attention.py", "kvcache.py",
            "transformer.py", "api.py", "serve_step.py", "serve.py",
            "phi4_mini_3_8b.py", "optimizer.py", "train_step.py",
            "straggler.py", "checkpoint.py", "train.py",
            "torch_approx_training.py", "xlstm.py", "moe.py",
            "rglru.py", "encdec.py", "vlm.py", "chip_compare.py"} <= names


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


def _smoke_model(device):
    cfg = tcfgs.get_config("phi4-mini-3.8b", smoke=True).replace(
        dtype=torch.float32)
    return cfg, tparam.init_params(tapi.skeleton(cfg), prng.PRNGKey(0),
                                   device=device)


@pytest.mark.parametrize("device", [None, "cuda", "cuda:0"])
def test_serving_entry_points_raise_without_a_card(monkeypatch, device):
    """The serving path's entry points take the card unless asked for
    the CPU, and refuse without one."""
    _no_card(monkeypatch)
    cfg, cpu_params = _smoke_model("cpu")
    with pytest.raises(NoCudaDeviceError, match="device='cpu'"):
        tparam.init_params(tapi.skeleton(cfg), prng.PRNGKey(0),
                           device=device)
    with pytest.raises(NoCudaDeviceError):
        tparam.params_from_reference(
            tparam.params_to_reference(cpu_params), device=device)
    with pytest.raises(NoCudaDeviceError):
        tkvc.init_cache(cfg, 2, 1, 8, device=device)
    with pytest.raises(NoCudaDeviceError):
        tapi.init_decode_state(cfg, 1, 8, device=device)
    with pytest.raises(NoCudaDeviceError):
        Server(cfg, cpu_params, device=device)
    args = [] if device is None else ["--device", device]
    with pytest.raises(NoCudaDeviceError):
        tlaunch.main(args)


@pytest.mark.parametrize("device", [None, "cuda", "cuda:0"])
def test_training_entry_points_raise_without_a_card(monkeypatch, device):
    """``launch/train`` takes the card unless asked for the CPU, and
    refuses without one rather than training on the CPU."""
    _no_card(monkeypatch)
    run = ttrain.RunConfig(arch="phi4-mini-3.8b", steps=1)
    with pytest.raises(NoCudaDeviceError, match="device='cpu'"):
        ttrain.train(run, device=device)
    args = ["--arch", "phi4-mini-3.8b", "--steps", "1"]
    with pytest.raises(NoCudaDeviceError):
        ttrain.main(args + ([] if device is None else ["--device", device]))


def test_training_on_the_cpu_on_request(monkeypatch, capsys):
    _no_card(monkeypatch)
    assert ttrain.main(["--arch", "phi4-mini-3.8b", "--steps", "1",
                        "--batch", "2", "--seq-len", "8",
                        "--device", "cpu"]) == 0
    assert capsys.readouterr().out.startswith("[train] step    1 epoch 0")


def test_serving_on_the_cpu_on_request(monkeypatch, capsys):
    _no_card(monkeypatch)
    cfg, params = _smoke_model("cpu")
    assert params["dense_layers"]["attn"]["wq"].device.type == "cpu"
    server = Server(cfg, params, num_tenants=2, device="cpu")
    out = server.generate({"tokens": torch.zeros((2, 4), dtype=torch.int32)},
                          steps=2, tenant_ids=torch.tensor([0, 1]))
    assert tuple(out.shape) == (2, 3)
    assert server.telemetry.values.device.type == "cpu"
    assert tlaunch.main(["--requests", "2", "--prompt-len", "4",
                         "--steps", "1", "--device", "cpu"]) == 0
    assert capsys.readouterr().out.startswith("[serve] generated (2, 2)")


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
