"""The result line: one JSON object with the contract's keys, the
compared numbers last and on standard error; no result without a card."""
import json
import os
import subprocess
import sys
import types

import pytest

from zkbench import harness, tracing
from zkbench.work.geometry import Geometry

import zkbench_tiny

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _fake_driver(trace):
    record = {"cycles": [{"traced": False, "step_s": [0.002, 0.004],
                          "verify_s": 1.5, "cycle_s": 3.0,
                          "profile": {"phases_s": {"commit": 0.25,
                                                   "openings": 2.0},
                                      "sub_phases_s": {"ipa-rounds": 1.5}}}],
              "trace": None, "geometry": Geometry((8, 8, 8), 4, 1)}
    summary = None
    if trace:
        summary = tracing.summarize(
            [("modmul_kernel", 10.0, 30.0), ("modmul_kernel", 50.0, 60.0)],
            [("prover.prove", 0.0, 100.0)])
        summary["window_s"] = 100e-6
        record["trace"] = summary

    def run(ctx):
        return {"setup_s": 12.5,
                "e2e": {"verified_steps_per_s": 0.5, "peak_device_gb": 1.0},
                "memory_peak_bytes": 10**9, "attempted": 1, "failed": 0,
                "checks": {"a_off": (0, 0), "b_off": (0, 0)},
                "trace": summary, "record": record}
    return types.SimpleNamespace(run=run)


@pytest.mark.parametrize("trace", [False, True])
def test_last_line_has_the_contract_keys(trace, monkeypatch, capsys):
    real = harness.load_module
    monkeypatch.setattr(harness, "load_module", lambda kind, name: (
        _fake_driver(trace) if kind == "drivers" else real(kind, name)))
    result = zkbench_tiny.run(trace=trace)
    harness.emit(result)
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert err.strip().splitlines()[-2:] == ["check a_off 0 limit 0",
                                             "check b_off 0 limit 0"]
    if trace:
        assert line["device"]["busy_s"] == pytest.approx(30e-6)
        assert line["breakdown"]["idle_gaps"][0] == ["prover.prove",
                                                     pytest.approx(40e-6)]
        assert line["metrics"]["device_idle_share"]["value"] == \
            pytest.approx(70.0)
        assert line["metrics"]["witness_ms"]["value"] == pytest.approx(3.0)
        assert line["metrics"]["commit_s"]["value"] == 0.25
        assert "qmatmul_roofline" not in line["metrics"]  # nothing to read
    else:
        assert set(line["metrics"]) == {"verified_steps_per_s",
                                        "peak_device_gb", "setup_s"}
        assert line["metrics"]["setup_s"] == {"value": 12.5, "unit": "s"}


def test_union_and_gaps():
    s = tracing.summarize([("k", 0.0, 10.0), ("k", 5.0, 20.0),
                           ("j", 40.0, 50.0)],
                          [("trainer.step", 0.0, 35.0),
                           ("verifier.verify_bytes", 35.0, 60.0)])
    assert s["busy_s"] == pytest.approx(30e-6)
    assert s["kernels"]["k"] == [2, pytest.approx(25e-6)]
    assert s["idle_gaps"] == [["trainer.step", pytest.approx(20e-6)],
                              ["verifier.verify_bytes",
                               pytest.approx(10e-6)]]


def test_spans_on_the_host_clock():
    rec = tracing.Recording()
    with rec.span("trainer.step"):
        pass
    with rec.span("prover.prove"):
        pass
    assert [s[0] for s in rec.spans] == ["trainer.step", "prover.prove"]
    assert rec.spans[0][1] <= rec.spans[0][2] <= rec.spans[1][1]


def test_no_result_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    res = subprocess.run(
        [sys.executable, os.path.join(ROOT, "zkbench", "run.py"),
         "--workload", "fcnn16l-w4096-t1", "--seed", "2147483653",
         "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert res.returncode != 0 and res.stdout == ""


def test_kernel_names():
    trace = {"kernels": {
        "void qmatmul_kernel<true, false>(short const*, long)": [3, 0.5],
        "qmatmul_kernel<false, false>(short const*, long)": [1, 0.25],
        "qmatmul_kernel_tail(long*)": [1, 1.0],
        "validity_tables_kernel(int const*, int const*)": [1, 0.125]}}
    assert tracing.kernel_seconds(trace, "qmatmul_kernel") == (4, 0.75)
    assert tracing.kernel_seconds(trace, "validity_tables_kernel") == (
        1, 0.125)
