"""A whole run at a size the CPU proves in seconds, the chip check
skipped: sound, it is correct; with the timed path broken underneath,
`correct` comes out false.  The trainer's faults: a step that returns
its weights unchanged, and half of the batch left out with the update
doubled (the mean over the rest)."""
import pytest

import zkbench_tiny


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


@pytest.mark.parametrize("fault", [None, "unchanged", "half_batch"])
def test_trainer_faults(fault, monkeypatch):
    from repro_torch.launch import steps

    if fault is not None:
        wrap = {"unchanged": _unchanged, "half_batch": _half_batch}[fault]
        monkeypatch.setattr(steps, "build_zkdl_step",
                            wrap(steps.build_zkdl_step))
    result = zkbench_tiny.run(seed=2**31 + 11)
    checks = {k: c["value"] for k, c in result["checks"].items()}
    if fault is None:
        assert result["correct"] and result["failed"] == 0
        assert set(checks.values()) == {0}
    else:
        assert not result["correct"] and result["failed"] == 1
        assert checks["step_weights_off"] > 0
        assert checks["final_weights_off"] > 0


def test_missing_phase_profile_fails_the_run(monkeypatch):
    """The four metrics of the prover's phase profile never drop out in
    silence: a run whose prover keeps no profile raises."""
    from repro_torch.core.pipeline import session

    prove = session.ProofSession.prove

    def without_profile(self):
        proof = prove(self)
        self.last_profile = None
        return proof
    monkeypatch.setattr(session.ProofSession, "prove", without_profile)
    with pytest.raises(RuntimeError, match="phase profile"):
        zkbench_tiny.run(seed=2**31 + 13)
