"""The port's six reference examples, run in process on the CPU at a
small size (``examples/torch_<name>.py --device cpu``): each ends
normally, prints the reference example's columns, and every estimate
line is finite. Without a card and without ``--device cpu`` each raises
``NoCudaDeviceError``."""
import importlib.util
import os
import re

import pytest
import torch

from repro_torch.utils import NoCudaDeviceError

EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples")

#: name → (small-size arguments, the reference's columns and markers in
#: order, the prefix of every estimate line)
CASES = {
    "quickstart": (["--items", "4096"],
                   ["window 0: SUM=", "MEAN=", "COUNT(v>5k)=",
                    "adaptive capacities →", "window 4: SUM="],
                   "window "),
    "network_traffic": (["--items", "4096"],
                        ["win", "system", "TCP(GB)", "UDP(GB)", "ICMP(GB)",
                         "total ±bound", "oasrs", "native", "sts",
                         "quantiles", "p50=", "p99=", "top-sizes", "2^"],
                        "  "),
    "taxi_rides": (["--items", "2048"],
                   ["slide", "Manhattan", "Brooklyn", "Queens", "Bronx",
                    "StatenIs", "Newark", " mi",
                    "windowed overall mean distance:", "(95% CI)"],
                   "    "),
    "streaming_runtime": (["--chunk", "256"],
                          ["=== batched executor ===", "emit 0: watermark=",
                           "mean=", "p99=", "elephants≈", "late=",
                           "dropped=", "cap=", "step=",
                           "final windowed bytes ≈",
                           "=== pipelined executor ===",
                           "=== crash recovery (exactly-once) ===",
                           "recovery latency: restore",
                           "recovered run == uninterrupted run (bitwise): "
                           "True",
                           "=== sessionized traffic",
                           "closed @ watermark=", "per-key=",
                           "session-mean="],
                          "emit "),
    "observability": (["--chunk", "256"],
                      ["=== item accounting", "offered   :", "ingested  :",
                       "accepted  :", "occupancy :", "conservation holds",
                       "=== /metrics (first lines) ===",
                       "hot loop with telemetry attached: trace_count=",
                       "summarize", "== accuracy =="],
                      "avg: hw95"),
    "serve_telemetry": (["--prompt-len", "8"],
                        ["window 0: mean decode latency", "per-tenant:",
                         "t3=", "generated shape: (4, 5)",
                         "--- /metrics (Prometheus text exposition) ---"],
                        "window "),
}
_NUMBER = re.compile(r"[-+]?\d[\d.]*(?:e[-+]?\d+)?")


def _load(name):
    path = os.path.join(EXAMPLES, f"torch_{name}.py")
    spec = importlib.util.spec_from_file_location(f"torch_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def one_thread():
    """One torch thread per test: under several xdist workers torch's
    thread pool makes many small ops much slower."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("name", sorted(CASES))
def test_example_runs_on_cpu(name, capsys, one_thread):
    args, columns, prefix = CASES[name]
    _load(name).main(args + ["--device", "cpu"])
    out = capsys.readouterr().out
    at = 0
    for col in columns:
        found = out.find(col, at)
        assert found >= 0, f"{col!r} missing (after offset {at})"
        at = found
    lines = [l for l in out.splitlines() if l.startswith(prefix)]
    assert lines
    for line in lines:
        assert not re.search(r"\b(nan|inf)\b", line, re.I), line
        assert _NUMBER.search(line), line


@pytest.mark.parametrize("name", sorted(CASES))
def test_example_refuses_without_card(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(NoCudaDeviceError):
        _load(name).main(CASES[name][0])
