r"""The port's service layer against the reference's on the CPU: the same
bytes, and files either package reads from the other.

The port's ``python -m repro_torch.launch.serve --device cpu`` CLI
(service and gateway) must write the proof files, ``vk.bin``,
``dataset.bin`` and manifest lines (timing fields aside) recorded once
from the reference's CLI:

    ZKDL_EXEC_MODE=off JAX_PLATFORMS=cpu PYTHONPATH=src \
        python -m repro.launch.serve --widths 4,4,4 --batch 2 --window 2 \
        --steps 4 --seed 5 --out-dir <scratch>/svc --bind-dataset
    ZKDL_EXEC_MODE=off JAX_PLATFORMS=cpu PYTHONPATH=src \
        python -m repro.launch.serve --tenants alice:2,bob --pool 1 \
        --widths 4,4,4 --batch 2 --window 2 --steps 4 --seed 5 \
        --out-dir <scratch>/gw

(a pool of one, so that the manifests' ``worker`` field is the same in
every run).  In that process the name `repro.core.zkrelu.batch_inv` was
bound to `_host_batch_inv` below, a host computation of the same
Montgomery-form scan (prefix products, one inverse, the backward pass),
as for tests/test_torch_train.py: the reference's jitted `batch_inv`
had not verified one window after fifteen minutes on a CPU, and the
bound run took under a minute.  The reference's `verify_bytes` checks
the port's files here under the same binding.  Journal segments,
reference service directories and ``dataset.bin`` are exchanged
between the packages directly.
"""
import hashlib
import json
import os

import numpy as np
import pytest
import torch

from repro.audit import membership as ref_membership
from repro.core import quantfc as rq
from repro.core import zkrelu as ref_zkrelu
from repro.core.pipeline import build_fcnn_graph as r_build_fcnn_graph
from repro.core.pipeline.proofio import decode_vk as r_decode_vk
from repro.core.pipeline.verifier import verify_bytes as r_verify_bytes
from repro.field import modarith as rfield
from repro.launch import serve as ref_serve
from repro.train.resilience import FailureInjector as RFailureInjector
from repro.train.resilience import SimulatedFailure as RSimulatedFailure

from repro_torch.audit import membership
from repro_torch.core.pipeline import build_fcnn_graph
from repro_torch.core.quantfc import (QuantConfig,
                                      synthetic_sgd_trajectory_widths)
from repro_torch.launch import serve

LABEL = b"zkdl/train"
ARGS = ["--device", "cpu", "--widths", "4,4,4", "--batch", "2", "--window",
        "2", "--steps", "4", "--seed", "5"]
VK_SHA256 = "b5f9659e266141abbc440a8450b89708a6b731d73299aabca551845d835b4c4d"
SERVICE_SHA256 = {
    "proof_000000.bin":
        "459631c21a8cb47fb64e5f507ae437445f739213998fbf42f31fd0dfe1cf56c8",
    "proof_000001.bin":
        "9b63d2eb3918c58adbcaaf0c99c04ae47323617b733f6f29139815d1421b9593",
    "dataset.bin":
        "3e2b2f4c980ced7c73565a3b9e68405c30203bfb828aa55e072e794a875d776c",
    "vk.bin": VK_SHA256,
}
GATEWAY_SHA256 = {
    "alice": ["459631c21a8cb47fb64e5f507ae437445f739213998fbf42f31fd0dfe1cf56c8",
              "b6b430a689a5c11bd27934ce5f0e8ac684e6e3941a218712153a4731d4f55c89"],
    "bob": ["5782504840059bc30600561d3393867db65cf9a6a20f1aa4b6bf863303b7c89d",
            "fc15ab87ca497e070f56d20c8821606fcd7487c55d23d1fb3bf9da171a501673"],
}
COMMITTED = [{"window": w, "status": "COMMITTED", "n_steps": 2,
              "bytes": 1244, "samples": [4 * w, 4], "attempts": 1}
             for w in (0, 1)]
SERVICE_MANIFEST = COMMITTED + [{
    "event": "DATASET_BINDING", "hash": "sha256",
    "root": "845a0949fbc3eeb3aba7c5ed110c118332fe96d0ce010d1a9bc10f7ba388e006",
    "n_windows": 2, "n_samples": 8}]
GATEWAY_MANIFEST = [dict(rec, worker=0) for rec in COMMITTED]
TIMING = ("prove_s", "ts")


def _host_batch_inv(spec, a):
    """The reference's `batch_inv` scan on the host, in Montgomery form:
    exclusive prefix products, the inverse of the total as
    ``pow_const(total, q - 2)``, then the backward pass."""
    a = np.asarray(a)
    if a.shape[0] == 0:
        return a
    q, r_inv = spec.modulus, pow(1 << 64, -1, spec.modulus)

    def mul(x, y):
        return x * y * r_inv % q

    xs = [int(v) for v in rfield.limbs_to_ints(a)]
    carry, pre = spec.r1, []
    for x in xs:
        pre.append(carry)
        carry = mul(carry, x)
    inv, base, e = spec.r1, carry, q - 2
    while e:
        if e & 1:
            inv = mul(inv, base)
        base, e = mul(base, base), e >> 1
    outs = [0] * len(xs)
    for i in range(len(xs) - 1, -1, -1):
        outs[i] = mul(inv, pre[i])
        inv = mul(inv, xs[i])
    import jax.numpy as jnp
    return jnp.asarray(rfield.ints_to_limbs(outs))


@pytest.fixture(autouse=True, scope="module")
def _reference_on_host_inverses():
    """The reference without its on-disk executable cache (entries keyed
    without the device count) and with host inverses (module doc)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ZKDL_EXEC_MODE", "off")
        mp.setattr(ref_zkrelu, "batch_inv", _host_batch_inv)
        yield


def test_host_batch_inv_equals_the_references():
    """The binding above changes no value: an inverse is unique, and the
    reference's own `batch_inv` over FQ, the field `repro.core.zkrelu`
    inverts in (run op by op, since its jitted form compiles for many
    minutes on a CPU), gives `_host_batch_inv`'s limbs, including the
    all-zero output of a batch that holds a zero."""
    import jax
    spec = rfield.FQ
    m = spec.modulus
    rng = np.random.default_rng(11)
    xs = [1, 2, m - 1, m - 2] + [int(v) % (m - 1) + 1
                                 for v in rng.integers(0, m, 5, np.uint64)]
    outs = []
    for vals in (xs, xs[:3] + [0] + xs[3:]):
        a = rfield.encode_ints(spec, np.array(vals, dtype=object))
        with jax.disable_jit():
            ref = np.asarray(rfield.batch_inv(spec, a))
        host = np.asarray(_host_batch_inv(spec, a))
        np.testing.assert_array_equal(host, ref)
        outs.append([int(v) for v in rfield.decode(spec, host)])
    assert outs == [[pow(x, -1, m) for x in xs], [0] * (len(xs) + 1)]


def _sha(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _manifest(d):
    with open(os.path.join(d, serve.MANIFEST)) as f:
        return [{k: v for k, v in json.loads(ln).items() if k not in TIMING}
                for ln in f if ln.strip()]


@pytest.fixture(scope="module")
def service_dir(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("svc"))
    assert serve.main(ARGS + ["--out-dir", out, "--bind-dataset"]) == 0
    return out


@pytest.fixture(scope="module")
def gateway_dir(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("gw"))
    assert serve.main(ARGS + ["--tenants", "alice:2,bob", "--pool", "1",
                              "--out-dir", out]) == 0
    return out


def test_service_cli_writes_the_reference_bytes(service_dir):
    for name, digest in SERVICE_SHA256.items():
        assert _sha(os.path.join(service_dir, name)) == digest, name
    assert _manifest(service_dir) == SERVICE_MANIFEST
    assert os.listdir(serve.journal_dir(service_dir)) == []


def test_gateway_cli_writes_the_reference_bytes(gateway_dir):
    for name, digests in GATEWAY_SHA256.items():
        tdir = os.path.join(gateway_dir, serve.TENANTS_DIR, name)
        assert [_sha(os.path.join(tdir, f"proof_{w:06d}.bin"))
                for w in (0, 1)] == digests
        assert _sha(os.path.join(tdir, "vk.bin")) == VK_SHA256
        assert _manifest(tdir) == GATEWAY_MANIFEST
    status = serve.dir_status(gateway_dir)
    assert status == ref_serve.dir_status(gateway_dir)
    assert {n: t["commit_lines"] for n, t in status["tenants"].items()} \
        == {"alice": 2, "bob": 2}


def test_reference_verifier_accepts_the_port_files(service_dir, gateway_dir):
    """The reference's `verify_bytes` against the port's ``vk.bin``."""
    dirs = [service_dir] + [os.path.join(gateway_dir, serve.TENANTS_DIR, n)
                            for n in GATEWAY_SHA256]
    for d in dirs:
        with open(os.path.join(d, "vk.bin"), "rb") as f:
            vk = r_decode_vk(f.read())
        for w in (0, 1):
            with open(os.path.join(d, f"proof_{w:06d}.bin"), "rb") as f:
                assert r_verify_bytes(vk, f.read(), label=LABEL), (d, w)


def test_journals_are_read_across_packages(tmp_path):
    """Each package's `journal_load` reads the other's segment
    tensor-equal (the same keys, dtypes and meta)."""
    ref_wit = rq.synthetic_sgd_trajectory_widths(
        1, (4, 8, 8, 4), 2, rq.QuantConfig(16, 8), seed=3, skips={3: 1})[0]
    port_wit = synthetic_sgd_trajectory_widths(
        1, (4, 8, 8, 4), 2, QuantConfig(16, 8), seed=3, skips={3: 1},
        device="cpu")[0]
    ref_serve.journal_append(str(tmp_path / "ref"), 0, ref_wit)
    serve.journal_append(str(tmp_path / "port"), 0, port_wit)
    from_ref = serve.journal_load(str(tmp_path / "ref"), 0, "cpu")
    from_port = ref_serve.journal_load(str(tmp_path / "port"), 0)
    for got, ref in ((from_ref, ref_wit), (port_wit, from_port)):
        assert (got.cfg.q_bits, got.cfg.r_bits, got.skips) == \
            (ref.cfg.q_bits, ref.cfg.r_bits, ref.skips) == (16, 8, {3: 1})
        for name in ("x", "y"):
            assert torch.equal(getattr(got, name),
                               torch.as_tensor(getattr(ref, name)))
        for name in serve._WIT_LISTS:
            assert len(getattr(got, name)) == len(getattr(ref, name))
            for g, r in zip(getattr(got, name), getattr(ref, name)):
                assert r.dtype == np.int64
                assert torch.equal(g, torch.as_tensor(r)), name


def test_port_service_resumes_a_reference_directory(tmp_path):
    """The reference's service journals window 0 and its worker dies
    before proving; the port's service on that directory replays and
    commits it, and proves the next window: the reference's bytes."""
    out = str(tmp_path)
    qc = rq.QuantConfig(16, 4)
    ref = ref_serve.ProverService(
        r_build_fcnn_graph((4, 4, 4), batch=2), qc, n_steps=2, out_dir=out,
        rng_seed=5, injector=RFailureInjector.from_spec("worker/kill@0"))
    ref.start(warm=False)
    for wit in rq.synthetic_sgd_trajectory_widths(2, (4, 4, 4), 2, qc,
                                                  seed=5):
        ref.submit(wit)
    with pytest.raises(RSimulatedFailure):
        ref.close(timeout=60)
    assert ref_serve.journal_steps(ref_serve.journal_dir(out)) == [0, 1]

    svc = serve.ProverService(build_fcnn_graph((4, 4, 4), batch=2),
                              QuantConfig(16, 4), n_steps=2, out_dir=out,
                              rng_seed=5, device="cpu")
    svc.start(warm=False)
    assert svc.stats["replayed"] == 2 and svc.next_step == 2
    for wit in synthetic_sgd_trajectory_widths(4, (4, 4, 4), 2,
                                               QuantConfig(16, 4), seed=5,
                                               device="cpu")[2:]:
        svc.submit(wit)
    svc.close(timeout=600)
    assert serve.manifest_commit_counts(out) == {0: 1, 1: 1}
    assert [_sha(os.path.join(out, f"proof_{w:06d}.bin")) for w in (0, 1)] \
        == [SERVICE_SHA256["proof_000000.bin"],
            SERVICE_SHA256["proof_000001.bin"]]
    assert serve.journal_steps(serve.journal_dir(out)) == []


def test_dataset_binding_bytes_equal_the_references(service_dir, tmp_path):
    """`bind_service_dir` of each package on the same directory writes
    the same ``dataset.bin`` (and the same root)."""
    import shutil

    roots = {}
    for name, bind in (("ref", ref_membership.bind_service_dir),
                       ("port", membership.bind_service_dir)):
        d = str(tmp_path / name)
        shutil.copytree(service_dir, d)
        os.remove(os.path.join(d, "dataset.bin"))
        _, binding = bind(d)
        roots[name] = binding.root
        assert _sha(os.path.join(d, "dataset.bin")) == \
            SERVICE_SHA256["dataset.bin"]
    assert roots["ref"] == roots["port"]
