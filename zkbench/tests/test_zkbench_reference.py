"""The plain reference against the program at a tiny geometry on the
CPU: the same SGD step, the same transcript, the same openings of a real
proof; and a planted off-by-one caught."""
import random

import numpy as np
import pytest
import torch

from zkbench.drivers import train_prove_verify as drv
from zkbench.reference import proofcheck, sgd
from zkbench.work.geometry import Geometry

import zkbench_tiny


def _inputs(widths, batch, seed, steps):
    gen = torch.Generator().manual_seed(seed)
    ws = [drv.quantize(torch.rand(widths[l], widths[l + 1], generator=gen,
                                  dtype=torch.float64),
                       2 / widths[l] ** 0.5, 16, 8)
          for l in range(len(widths) - 1)]
    data = [(drv.quantize(torch.rand(batch, widths[0], generator=gen,
                                     dtype=torch.float64), 1.0, 16, 8),
             drv.quantize(torch.rand(batch, widths[-1], generator=gen,
                                     dtype=torch.float64), 1.0, 16, 8))
            for _ in range(steps)]
    return ws, data


@pytest.mark.parametrize("widths,seed", [((8, 8, 8), 1), ((16, 8, 4, 8), 2),
                                         ((8,) * 5, 3)])
def test_sgd_step_equals_the_program(widths, seed):
    from repro_torch.core import quantfc

    qc = quantfc.QuantConfig(16, 8)
    ws, data = _inputs(widths, 4, seed, 3)
    ref = [w.clone() for w in ws]
    for x, y in data:
        wit = quantfc.train_step_witness(x, y, ws, qc, device="cpu")
        ws = quantfc.sgd_apply(wit.w, wit.gw, 4, qc)
        ref, t = sgd.sgd_step(ref, x, y, 16, 8, 4)
        for l in range(len(ws)):
            assert torch.equal(ws[l], ref[l])
            assert torch.equal(wit.zpp[l], t["zpp"][l])
            assert torch.equal(wit.b[l], t["bq"][l])
            assert torch.equal(wit.rz[l], t["rz"][l])
            assert torch.equal(wit.gw[l], t["gw"][l])
        for l in range(len(ws) - 1):
            assert torch.equal(wit.gap[l], t["gap"][l])
            assert torch.equal(wit.rga[l], t["rga"][l])


def test_exact_matmul_refuses_a_sum_it_cannot_hold():
    a = torch.full((1, 4096), 1 << 25, dtype=torch.int64)
    with pytest.raises(OverflowError):
        sgd.exact_matmul(a, a.T.clone())


def test_fingerprint_catches_a_planted_off_by_one():
    ws, _ = _inputs((8, 8, 8), 4, 5, 0)
    probes = torch.randint(1, 16, (2, 2, 8)).to(torch.float64)
    bad = [w.clone() for w in ws]
    bad[1][3, 5] += 1
    diff = drv.fingerprint(ws, probes) != drv.fingerprint(bad, probes)
    assert diff.tolist() == [False, False, True, True]


def test_transcript_equals_the_program():
    from repro_torch.core.transcript import Transcript

    ours, theirs = proofcheck.Transcript(b"lbl"), Transcript(b"lbl")
    vals = [random.randrange(1 << 62) for _ in range(5)]
    ours.absorb_ints(b"coms", vals)
    theirs.absorb_ints(b"coms", vals)
    assert ours.challenges(b"u_r", 3) == theirs.challenge_ints(
        b"u_r", proofcheck.Q, 3)


def test_mle_eval_by_brute_force():
    rnd = random.Random(3)
    for n in (1, 3, 5):
        table = torch.randint(-(1 << 40), 1 << 40, (1 << n,))
        point = [rnd.randrange(proofcheck.Q) for _ in range(n)]
        want = 0
        for i in range(1 << n):
            e = 1
            for j, u in enumerate(point):
                e = e * (u if (i >> j) & 1 else 1 - u) % proofcheck.Q
            want = (want + int(table[i]) * e) % proofcheck.Q
        assert proofcheck.mle_eval(table, point) == want


def test_openings_of_a_real_proof():
    """One CPU proof of T = 2 steps of a pyramid: the reference reads
    every opening as the program proved it, and an off-by-one in one
    reference tensor shows in the openings it feeds."""
    from repro_torch.core.pipeline import (build_fcnn_graph, compile,
                                           encode_proof)
    from repro_torch.core.quantfc import QuantConfig
    from repro_torch.launch import steps

    widths = (8, 4, 8)
    pk, _ = compile(build_fcnn_graph(widths, 4), QuantConfig(16, 8),
                    n_steps=2, device="cpu")
    ws, data = _inputs(widths, 4, 9, 2)
    step = steps.build_zkdl_step(pk.cfg, lr_shift=4, device="cpu")
    hook = steps.ZkdlProveHook(pk, np.random.default_rng(1), verify=False,
                               label=drv.LABEL)
    ref, tensors = [w.clone() for w in ws], []
    for k, (x, y) in enumerate(data):
        ws, wit = step(ws, {"x": x, "y": y})
        hook.observe(k, wit)
        ref, t = sgd.sgd_step(ref, x, y, 16, 8, 4)
        tensors.append(t)
    raw = encode_proof(hook.proofs[-1][1])
    geo = Geometry(widths, 4, 2)
    assert proofcheck.check_proof(raw, geo, tensors, drv.LABEL) == []
    tensors[1]["gw"][0][2, 1] += 1
    assert proofcheck.check_proof(raw, geo, tensors, drv.LABEL) == ["a6"]
    assert proofcheck.check_proof(raw[:40], geo, tensors,
                                  drv.LABEL) == ["encoding"]


def test_make_inputs_is_fixed_by_the_seed():
    a = drv.make_inputs(zkbench_tiny.CONFIG, zkbench_tiny.CELL, 2**31 + 5,
                        "cpu")
    b = drv.make_inputs(zkbench_tiny.CONFIG, zkbench_tiny.CELL, 2**31 + 5,
                        "cpu")
    c = drv.make_inputs(zkbench_tiny.CONFIG, zkbench_tiny.CELL, 2**31 + 6,
                        "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a["ws"], b["ws"]))
    assert torch.equal(a["pool"], b["pool"])
    assert not torch.equal(a["pool"], c["pool"])
    assert a["pool"].shape == (8, 2, 4, 8)
