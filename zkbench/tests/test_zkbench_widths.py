"""`drivers/train_prove_verify_widths.py` (mixed widths) at a pyramid
the CPU proves in seconds, of the shape of `dlrmtop-b512-t1`: five
layers, an input width off the powers of two, an output width of 1, and
3 / 4 / 1 shape buckets of the fwd / bwd / gw relations.  A sound run is
correct; with the state unchanged, half the batch or a proof byte
flipped it is not.  The new metric readers read the run's spans and
counters and return None without them."""
import time
from unittest import mock

import pytest

from zkbench import control_widths, harness
from zkbench.drivers import train_prove_verify_widths as drv

CONFIG = {"name": "tinyw", "widths": [3, 8, 8, 4, 2, 1], "n_layers": 5,
          "batch": 2, "q_bits": 16, "r_bits": 8}
CELL = {"name": "tinyw-t1", "config": "tinyw",
        "driver": "train_prove_verify_widths", "traffic": "tiny",
        "chips": 1, "window_steps": 1, "weight_gain": 2.0, "data_gain": 1.0,
        "label_share": 0.25, "lr_shift": 4, "batch_pool": 8,
        "warm_windows": 0}
NEW_METRICS = ("matmul_sumchecks_s", "aux_fill_share")


def _run(seed):
    """One run of the tiny cell on the CPU, found by name as a cell of
    the repository is."""
    bench = harness.benchmark()
    for m in bench["per_layer"]:
        m["workloads"] = [CELL["name"]]
    with mock.patch.object(harness, "load_cell", lambda name: CELL), \
            mock.patch.object(harness, "load_config", lambda name: CONFIG), \
            mock.patch.object(harness, "benchmark", lambda: bench):
        return harness.run_cell(CELL["name"], seed, 0.0, False, "cpu",
                                time.perf_counter())


def test_sound_run_is_correct_and_read():
    out = drv.run(harness.Context(CELL, CONFIG, 2**31 + 21, 0.0, False,
                                  "cpu", time.perf_counter()))
    assert {k: v for k, (v, _) in out["checks"].items()} == dict.fromkeys(
        ("step_weights_off", "final_weights_off", "openings_off",
         "honest_rejected", "tampered_accepted"), 0)
    assert out["attempted"] == 1 and out["failed"] == 0
    record = out["record"]
    (cycle,) = record["cycles"]
    # 2 x (8 + 8 + 4 + 2 + 1) real of 8 slots x 2 x 8
    assert cycle["profile"]["counts"] == {
        "buckets": 8, "aux_real": 46, "aux_stacked": 128,
        "validity_positions": 2 * 128 * 24}
    read = {m: harness.load_module("metrics", m).read(record)
            for m in NEW_METRICS}
    assert read["aux_fill_share"] == pytest.approx(100 * 46 / 128)
    sub = cycle["profile"]["sub_phases_s"]
    assert read["matmul_sumchecks_s"] == pytest.approx(
        sub["sumcheck-fwd"] + sub["sumcheck-bwd"] + sub["sumcheck-gw"])
    assert 0 < read["matmul_sumchecks_s"] <= \
        cycle["profile"]["phases_s"]["matmul"]


def _unchanged(build):
    def make(*args, **kwargs):
        step = build(*args, **kwargs)

        def unchanged(ws, batch):
            _, wit = step(ws, batch)
            return ws, wit
        return unchanged
    return make


def _half_batch(build):
    def make(zk_cfg, lr_shift=8, device=None):
        step = build(zk_cfg, lr_shift=lr_shift - 1, device=device)

        def half(ws, batch):
            rows = batch["x"].shape[0] // 2
            cut = {k: v.clone() for k, v in batch.items()}
            for v in cut.values():
                v[rows:] = 0
            return step(ws, cut)
        return half
    return make


def _flip(encode):
    def flipped(proof):
        raw = bytearray(encode(proof))
        raw[len(raw) // 2] ^= 0x04
        return bytes(raw)
    return flipped


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "proof_byte"])
def test_faults_are_not_correct(fault, monkeypatch):
    from repro_torch.core.pipeline import proofio
    from repro_torch.launch import steps

    if fault == "proof_byte":
        monkeypatch.setattr(proofio, "encode_proof",
                            _flip(proofio.encode_proof))
    else:
        wrap = {"unchanged": _unchanged, "half_batch": _half_batch}[fault]
        monkeypatch.setattr(steps, "build_zkdl_step",
                            wrap(steps.build_zkdl_step))
    result = _run(seed=2**31 + 22)
    checks = {k: c["value"] for k, c in result["checks"].items()}
    assert not result["correct"] and result["failed"] == 1
    if fault == "proof_byte":
        assert checks["honest_rejected"] == 1
    else:
        assert checks["step_weights_off"] > 0
        assert checks["final_weights_off"] > 0


@pytest.mark.parametrize("profile", [
    None, {"phases_s": {"matmul": 0.5}},
    {"phases_s": {"matmul": 0.5},
     "sub_phases_s": {"ipa-rounds": 1.5, "sumcheck-fwd": 0.1}}])
def test_new_readers_without_spans_or_counters(profile):
    """A record of a program without the matmul sub-phases or the
    counters (one from before they existed) reads None."""
    record = {"cycles": [{"traced": False, "step_s": [0.002],
                          "verify_s": 1.0, "cycle_s": 2.0,
                          "profile": profile}],
              "trace": None, "geometry": drv.geometry(CONFIG, CELL)}
    for name in NEW_METRICS:
        assert harness.load_module("metrics", name).read(record) is None


def test_control_and_faults_fail():
    inputs = drv.make_inputs(dict(CONFIG, widths=[13, 32, 32, 16, 8, 1],
                                  batch=8), CELL, 2**31 + 23, "cpu")
    params = {"q_bits": 16, "r_bits": 8, "lr_shift": 16,
              "window_steps": 2}
    for variant in ("control", "unchanged", "half_batch"):
        got = control_widths.variant_numbers(inputs, params, 4, "cpu",
                                             variant)
        assert got["step_weights_off"] > 0, variant
        assert got["final_weights_off"] > 0, variant


def test_inputs_follow_the_widths():
    inputs = drv.make_inputs(CONFIG, CELL, 2**33 + 5, "cpu")
    assert [tuple(w.shape) for w in inputs["ws"]] == [
        (3, 8), (8, 8), (8, 4), (4, 2), (2, 1)]
    assert tuple(inputs["pool_x"].shape) == (8, 2, 3)
    y = inputs["pool_y"]
    assert tuple(y.shape) == (8, 2, 1)
    assert set(y.unique().tolist()) <= {0, 256}
    again = drv.make_inputs(CONFIG, CELL, 2**33 + 5, "cpu")
    assert all((a == b).all() for a, b in zip(inputs["ws"], again["ws"]))
    fp = drv.fingerprint(inputs["ws"], inputs["probes"])
    bad = [w.clone() for w in inputs["ws"]]
    bad[4][1, 0] += 1
    diff = drv.fingerprint(bad, inputs["probes"]) != fp
    assert diff.tolist() == [False] * 8 + [True, True]


def test_the_cell_and_its_configuration():
    cell = harness.load_cell("dlrmtop-b512-t1")
    config = harness.load_config(cell["config"])
    geo = drv.geometry(config, cell)
    assert geo.widths == (479, 1024, 1024, 512, 256, 1)
    assert (geo.batch, geo.n_steps) == (512, 1)
    assert geo.merged_len == 1 << 28
    assert config["n_layers"] == len(config["widths"]) - 1
    assert config["published"]["widths"] == config["widths"]
