"""CPU self-checks of the span readers (harness/spans.py and the
``*.host_ms``, ``*_ms`` and ``*.kernels`` readers of the program's
spans): run with ``python -m pytest bench_torch/tests -q`` from the root
of the repository.

- on a hand-made window, self time leaves out the child spans and each
  launch goes to its innermost span, or to none;
- a traced run of ``flagship.resident`` on the CPU stand-in gives a
  number for every host-time reader and None for every kernel count
  (the CPU has no device events)."""
from __future__ import annotations

import importlib.util
import json
import os
import sys
from types import SimpleNamespace

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
for p in (BENCH, HERE):
    if p not in sys.path:
        sys.path.insert(0, p)

from harness import spans  # noqa: E402


def span_metrics():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fp:
        names = [m["name"] for m in json.load(fp)["per_layer"]]
    return [n for n in names if n.endswith((".host_ms", ".kernels"))
            or n.startswith("result.")]


def reader(name):
    spec = importlib.util.spec_from_file_location(
        "metric_" + name.replace(".", "_"),
        os.path.join(BENCH, "metrics", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_span_table_nesting_and_launches():
    # (name, start, end, root) in microseconds, as trace.Window.host
    host = [
        ("meterelf.stream.dispatch", 0.0, 100.0, True),
        ("meterelf.step.backhalf", 10.0, 30.0, False),
        ("cudaLaunchKernel", 12.0, 13.0, False),
        ("meterelf.decode.angles", 30.0, 80.0, False),
        ("aten::where", 31.0, 35.0, False),
        ("cudaLaunchKernel", 32.0, 33.0, False),
        ("cuLaunchKernel", 50.0, 51.0, False),
        ("cudaLaunchKernel", 90.0, 91.0, False),     # dispatch's own
        ("cudaLaunchKernel", 120.0, 121.0, True),    # outside every span
        ("meterelf.step.backhalf", 130.0, 140.0, True),
    ]
    w = SimpleNamespace(host=host, device=[("k", 0.0, 1.0)], units=2)
    t = spans.table(w)
    assert t.self_us == {"meterelf.stream.dispatch": 30.0,
                         "meterelf.step.backhalf": 30.0,
                         "meterelf.decode.angles": 50.0}
    assert t.kernels == {"meterelf.step.backhalf": 1,
                         "meterelf.decode.angles": 2,
                         "meterelf.stream.dispatch": 1}
    assert t.outside == 1
    assert spans.host_ms(w, "meterelf.decode.angles") == 0.025
    assert spans.kernels(w, "meterelf.decode.angles") == 1.0
    assert spans.kernels(w, "meterelf.decode.errors") is None
    assert spans.host_ms(w, "meterelf.decode.errors") is None
    w.device = []
    assert spans.kernels(w, "meterelf.decode.angles") is None


@pytest.fixture(scope="module")
def traced_resident():
    import torch

    from cpu import run_small

    torch.set_num_threads(2)
    captured = []
    from harness import trace

    class Keep(trace.Window):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            captured.append(self)

    orig, trace.Window = trace.Window, Keep
    try:
        result = run_small("flagship.resident", trace=1)
    finally:
        trace.Window = orig
    return result, captured[0]


@pytest.mark.parametrize("name", span_metrics())
def test_span_readers_on_the_cpu(name, traced_resident):
    result, window = traced_resident
    value = reader(name)(window)
    if name.endswith(".kernels"):
        assert value is None
        assert name not in result["metrics"]
    else:
        assert isinstance(value, float) and value >= 0.0
        assert result["metrics"][name]["value"] == value
    assert result["correct"]
