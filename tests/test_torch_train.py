"""The port's prove-while-train entry point (`repro_torch.launch.train`)
against the reference's (`repro.launch.train.run_zkdl_train`).

Each window's `encode_proof` bytes must hash to the digests recorded
once from the reference's `steps.build_zkdl_step` + `ZkdlProveHook`,
driven by `repro.launch.train.main` with the same flags (minus
``--device``) and ``ZKDL_EXEC_MODE=off JAX_PLATFORMS=cpu``.  In that
recording process the name `repro.core.zkrelu.batch_inv` was bound to a
host computation of the same Montgomery-form inverses (python
``pow(x, q - 2, q)``; inverses are unique, so every value is the
same): the reference's jitted `batch_inv`, a sequential `lax.scan`, ran
for over an hour on a CPU without finishing.  The reference verifier
accepted both uniform windows there.  Equal bytes mean equal weights,
data, witnesses, SGD updates and blinds across steps and windows.
The residual-operand witness is compared with the reference's numpy
witness generator directly."""
import hashlib

import numpy as np
import pytest
import torch

from repro.core import quantfc as rq

from repro_torch.core import quantfc
from repro_torch.core.pipeline import encode_proof
from repro_torch.launch import steps, train

# sha256 of each window's proof bytes, recorded from the reference
REFERENCE_WINDOW_SHA256 = {
    "uniform": [
        "663367e0b8122fa355335f05e22d6f62ab918d72e32946479af11b6904a47b10",
        "859efc1dad51fe748cce1059d1f4676d20d46d80b5fc05bf1ff5df7a98124bfc"],
    "pyramid": [
        "86192a732000a9ed3bb1e47bd28bb073ac34bf5a01747b57bd4b261f2eb639b1"],
}
ARGV = {
    "uniform": ["--layers", "2", "--d-model", "4", "--global-batch", "2",
                "--steps", "4", "--prove-window", "2"],
    "pyramid": ["--widths", "16,8,4,2", "--global-batch", "2", "--steps",
                "1", "--prove-window", "1", "--no-verify"],
}


@pytest.fixture
def hooks(monkeypatch):
    """Every `ZkdlProveHook` the trainer makes, kept for its proofs."""
    made = []

    class Kept(steps.ZkdlProveHook):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

    monkeypatch.setattr(steps, "ZkdlProveHook", Kept)
    return made


@pytest.mark.parametrize("case", ["uniform", "pyramid"])
def test_trainer_reproduces_reference_window_proofs(hooks, case, capsys):
    argv = ["--device", "cpu", "--arch", "fcnn-zkdl-16l", *ARGV[case]]
    assert train.main(argv) == 0
    (hook,) = hooks
    digests = [hashlib.sha256(encode_proof(proof)).hexdigest()
               for _, proof, _ in hook.proofs]
    assert digests == REFERENCE_WINDOW_SHA256[case]
    out = capsys.readouterr().out
    verified = "--no-verify" not in ARGV[case]
    assert out.count(f"verified={verified}") == len(digests)


def test_trainer_exits_on_unported_paths():
    """Every path is ported; what is still refused is a mesh larger than
    the world the trainer was started in (outside torchrun, one rank),
    with a message that says how to start it."""
    base = ["--device", "cpu", "--steps", "1"]
    with pytest.raises(SystemExit, match="torchrun --nproc-per-node 256"):
        train.main(base + ["--arch", "qwen3-0.6b", "--mesh", "16x16"])


# sha256 of the files the reference trainer's prover service wrote,
# recorded as above from `repro.launch.train.main` with
# ARGV["uniform"] + ["--proof-dir", <dir>]
REFERENCE_PROOF_DIR_SHA256 = {
    "proof_000000.bin":
        "236b0734ed48c3c8d21078e85bc4df886d060a78169565ba5e48dc9f80e79130",
    "proof_000001.bin":
        "969cc30d25e7320dbc807127f9d2d0ef879838c5dd2dff39515792308e07cad4",
    "vk.bin":
        "f0df597e6a37d443889b3b87c10536aac0c2e2216047af6d4f26bd6bf5338a6e",
}


def test_trainer_proof_dir_streams_the_reference_service_proofs(tmp_path,
                                                                capsys):
    """``--proof-dir`` hands every step to the port's ProverService (warm
    at start, journaled submits, one committed proof per window): the
    files are the reference service's, and nothing is left journaled."""
    import json

    from repro_torch.launch import serve

    argv = ["--device", "cpu", "--arch", "fcnn-zkdl-16l", *ARGV["uniform"],
            "--proof-dir", str(tmp_path)]
    assert train.main(argv) == 0
    for name, digest in REFERENCE_PROOF_DIR_SHA256.items():
        with open(tmp_path / name, "rb") as f:
            assert hashlib.sha256(f.read()).hexdigest() == digest, name
    assert serve.manifest_commit_counts(str(tmp_path)) == {0: 1, 1: 1}
    assert serve.journal_steps(serve.journal_dir(str(tmp_path))) == []
    with open(tmp_path / serve.MANIFEST) as f:
        assert [json.loads(ln)["samples"] for ln in f] == [[0, 4], [4, 4]]
    out = capsys.readouterr().out
    assert "prover service warm" in out
    assert out.count("verified=True") == 2


def test_residual_operand_witness_matches_reference():
    """A 3-layer residual MLP whose residual operand A^2 + A^1 and loss
    gradient Z' - Y both leave int16, so every witness product of the
    last layer goes through the two-part split."""
    qc = rq.QuantConfig(16, 8)
    rng = np.random.default_rng(2)
    eye = np.eye(4, dtype=np.int64)
    ws = [256 * eye, 256 * eye, 64 * eye]      # 1.0, 1.0 and 0.25
    x = rng.integers(17000, 20000, (2, 4))
    y = np.full((2, 4), -25000, dtype=np.int64)
    ref = rq.train_step_witness(x, y, ws, qc, skips={3: 1})
    got = quantfc.train_step_witness(x, y, ws, quantfc.QuantConfig(16, 8),
                                     skips={3: 1}, device="cpu")
    assert int((got.a[2] + got.a[1]).max()) > 2 ** 15
    assert int(got.gz[-1].max()) > 2 ** 15
    for name in ("z", "zpp", "b", "rz", "a", "gz", "ga", "gap", "rga", "gw"):
        for g, r in zip(getattr(got, name), getattr(ref, name)):
            assert torch.equal(g, torch.as_tensor(r)), name
