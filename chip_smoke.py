#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`repro_torch`) on one GPU and check it.

    python3 chip_smoke.py                 # every phase, the full width
    python3 chip_smoke.py --width 1024    # a narrower full-width phase

Phases, each printing one JSON line:

1. device and build: the card, torch/CUDA/nvcc versions, the time to
   build every CUDA kernel from the sources in this checkout, and what
   ``cuobjdump -sass`` shows: qmatmul's integer tensor-core MMAs (and no
   dp4a), and the integer operations of one Montgomery multiply;
2. kernels: each kernel against its plain PyTorch version on the card,
   bit for bit, at main-path sizes (random inputs plus 0, 1 and m-1),
   with both times;
3. golden bytes: the uniform 2x4 MLP, QuantConfig(16, 4), seed 7, T = 1
   and T = 2, proved on the card, must hash to the reference's recorded
   proof digests and verify;
4. full width: the fcnn-zkdl-16l geometry (width 4096, batch 128,
   QuantConfig(16, 8), T = 1) with depth cut to 2 dense+ReLU layers:
   compile -> witness -> ProofSession.prove -> encode_proof ->
   verify_bytes accepts, one flipped byte is rejected, and every kernel
   was launched during the run;
5. train: prove-while-train at the same geometry, window 1, two steps
   through `launch.steps.build_zkdl_step` + `ZkdlProveHook` (the second
   step's witness on the weights the first updated on the card); both
   windows' bytes verify and a flipped byte is rejected; then one T = 2
   window at width 1024 (aggregation across two on-card SGD steps), all
   with 2/sqrt(width) weights and an SGD step of 2^-16;
6. open: the open IPA (`open_prove` / `open_verify`) at n = 2^20, and a
   wrong claim rejected;
7. audit: the soundness audit (`repro_torch.audit`) on the card.  (a)
   `run_audit` at the recorded reference report's configuration
   (`AUDIT_report.json`: widths (4, 4, 4), batch 2, T = 8,
   QuantConfig(16, 4), seed 11) must equal that report in every field
   but the timings; (b) at the full width (phase 4's geometry and
   witness recipe), all 14 attacks rejected, the membership audit
   verified in-process and by a fresh verifier process, and SC-BD on
   the first AUDIT_SCBD_D entries of the window's stacked gap verified
   with a forged claim rejected;
8. serve: the service layer (`repro_torch.launch.serve`) on the card.
   (a) a `ProverService` at phase 4's geometry (T = 1, verify=True),
   warmed, three steps, closed; (b) its directory again with the proof
   of one more step written but its commit lost (``commit/pre-manifest``)
   and a restart that replays it; (c) one window under subprocess
   isolation whose first child SIGKILLs itself mid-prove; (d) two
   tenants (weights 2:1) of a `ProvingGateway` on a pool of 2 at width
   1024 with one worker killed, then the same windows on a pool of 1;
   (e) `bind_service_dir` on (a)'s directory and a fresh-process
   membership verify; (f) ``python -m repro_torch.launch.train
   --proof-dir`` at d-model 256.  Exactly one COMMITTED line per
   window, every proof read back from disk verified, no journal left;
   it prints warm, submit, commit, child and memory numbers beside the
   card's name and power limit;
9. lm: the LM trainer and model zoo on the card.  (a) qwen3-0.6b at
   full width and depth (28 x 1024), seq 512, batch 8, 8 steps through
   `repro_torch.launch.train.main`: finite losses and grad norms, the
   first loss within 0.5 of ln(vocab); median step seconds, tokens/s,
   peak GB and the model-FLOP share of the bf16 dense peak; (b) depth 2,
   ``--compress int8 --ckpt-every 3 --fail-at 5`` under deterministic
   algorithms resumes at step 4 and reproduces the uninterrupted run's
   losses of steps 5-7 bit for bit (checkpoints under build/lm, save
   seconds and bytes printed); (c) width 1024, depth 2, float32, three
   AdamW steps on the card and on the CPU from one init; (d) every LM
   arch's smoke config: finite forward, grad and decode step, float32
   against the CPU; (e) full qwen3-0.6b: prefill 256 tokens, 8 greedy
   decode steps, each against a full forward, in float32 (1e-4 of the
   largest logit) and in bf16 (three times the bf16 forward's own
   error), greedy tokens equal, and a planted off-by-one position that
   the float32 leg must catch; (f) blockwise against
   dense attention at S = 4096 in float32, then one forward and
   backward pass at seq 4096.  Phase golden also proves the standalone
   validity IPA (`zkrelu.prove_validity`) on the card and compares it
   with the reference's recorded proof;
10. mesh: the DeviceMesh / DTensor path on the card.  (a) (9a)'s run
   plain and then with ``--mesh 1x1`` (an NCCL world of one): losses
   within 1e-6 relative (and whether bit for bit), median step seconds
   and peak GB of both; (b) `steps.lower_train` of that cell on a 1x1
   fake mesh in a subprocess: its argument bytes equal the bytes (a)'s
   state and batch held on the card, and its live bytes are within a
   factor of 1.5 of (a)'s peak; (c) ``python -m
   repro_torch.launch.dryrun`` on 16x16, one train_4k cell per family
   (dense, moe, ssm, hybrid, encdec, vlm), six processes at once, each
   ``ok``; (d) the forward of both moe smoke configs with DTensor
   parameters on a 1x1 mesh equals the plain forward to 1e-6.

Phase 1 also starts a fresh interpreter that calls one kernel: it must
report no compile (`repro_torch.core.execache.stats()`).

Then a JSON line with every kernel's numbers, the nvidia-smi name and
power limit, and as the last line
``{"ok": true, "device": {"platform": "gpu", ...}}``.  Exits non-zero
(printing no result) without a GPU, outside a checkout of the
repository, or when any phase fails.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "build")

# recorded reference proof digests (tests/test_proofio.py GOLDEN_SHA256)
GOLDEN_SHA256 = {
    1: "a538160f1da619bd39439420f78d24af9089dd1eacd770f3ce24d76dd80c2422",
    2: "17e8be25e9320abb55694a27615bf0093a7c0c08e290f2e11856a8d4f09b08f6",
}
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
INT32_OPS_PER_S = 33.5e12          # 64 INT32 lanes/SM: half the 67 T FP32 rate
INT8_TC_OPS_PER_S = 1979e12        # int8 tensor cores, dense
# 32-bit integer ops per 64-bit REDC multiply: the fewest over the
# stored products' SASS slices in the modmul library (phase build, which
# reports the count again), a multiply-add as 2, an add as 1, a move as 0
MODMUL_OPS = 38
SHA256_OPS = 3400                  # 32-bit integer ops per one-block hash
# fcnn-zkdl-16l (src/repro/configs/fcnn_zkdl_16l.py): batch 128, 16
# layers of width 4096; depth cut to 2 to fit the run's time and memory
FULL_BATCH, FULL_LAYERS = 128, 2
# the train phase's extra T = 2 window (aggregation across SGD steps)
AGG_WIDTH, AGG_STEPS = 1024, 2
# SGD step 2^-16 for the train phase: G_W is a sum over the batch, and
# at width 4096 and batch 128 the reference trainer's 2^-8 moves the
# weights so far that the second step's Z' leaves the 16-bit range
TRAIN_LR_SHIFT = 16
OPEN_N = 1 << 20
# SC-BD's three D^2 Q wiring tables at the full width: D = 2^12, Q = 16
# is 2^28 words (2 GiB) each and 38.7 GB above the baseline at the first
# round's peak on an H100 80GB, the largest power of two under half of it
AUDIT_SCBD_D = 1 << 12


# the standalone validity IPA (zkrelu.prove_validity) at DS = 8, Q = 8,
# R = 4 on the inputs of tests/test_torch_names.py (aux from
# default_rng(42)): the reference's commitments and proof, recorded once
VALIDITY_GOLDEN = {
    "coms": [3321668103897975935, 555965426435947559, 2789400395302629123,
             1254621978059809875],
    "ls": [2306671581511745815, 1746866287729908800, 4003374391151768675,
           4118535930058955682, 1754789279930431751, 1709501324969216675,
           2046351410251543085, 2544941545633683185],
    "rs": [4101627363386275095, 43585147357973719, 2487749357538791666,
           3249122387236444170, 2659917825134582638, 2486056974847485526,
           1924407162189139418, 930587536014344940],
    "sigma": [3649441468035683311, 919579863347573057, 2139500555648496446,
              870963889621916627, 1813593952376246272]}
# phase lm: qwen3-0.6b (src/repro/configs/qwen3_0p6b.py) at full width
# and depth, the reference trainer's default seq and batch
LM_ARCH, LM_SEQ, LM_BATCH, LM_STEPS = "qwen3-0.6b", 512, 8, 8
BF16_DENSE_FLOPS_PER_S = 989e12    # H100 SXM bf16 tensor cores, dense


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps: int = 5) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int = 20) -> float:
    """Device time of one call: ``reps`` calls captured in a CUDA graph
    and replayed, so host time between launches is not counted."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / reps


def bound_ms(n_bytes: float, n_ops: float,
             ops_per_s: float = INT32_OPS_PER_S):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nvidia_smi() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return res.stdout.strip().splitlines()[0] if res.stdout.strip() else ""


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

_SASS_FUNC = re.compile(r"Function : (\S+)")
_SASS_INSN = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;")
_SASS_REG = re.compile(r"U?R\d+(?:\.64)?|U?P\d+")
_INT_OPS = {"IMAD", "IADD3", "ISETP", "SEL", "LOP3", "SHF", "MOV", "LEA",
            "IMNMX", "PRMT", "IABS", "POPC", "FLO", "VIADD"}


def _sass(name: str) -> dict:
    """{function: [instruction, ...]} of a built kernel library, from
    ``cuobjdump -sass``."""
    from repro_torch.kernels import _build
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", str(_build._lib_path(name))],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    funcs, cur = {}, None
    for line in text.splitlines():
        m = _SASS_FUNC.search(line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
        elif cur is not None and _SASS_INSN.search(line):
            cur.append(_SASS_INSN.search(line).group(1))
    return funcs


def _regs(op: str) -> set:
    """Registers an operand names; R<n>.64 is the pair R<n>, R<n+1>."""
    out = set()
    for r in _SASS_REG.findall(op):
        if r.endswith(".64"):
            base, num = r[:-3].rstrip("0123456789"), int(r[:-3].lstrip("UR"))
            out |= {f"{base}{num}", f"{base}{num + 1}"}
        else:
            out.add(r)
    return out


def _defs_uses(insn: str):
    """(opcode, registers written, registers read, predicated)."""
    guard = insn.startswith("@")
    if guard:
        g, insn = insn.split(None, 1)
    opcode, _, rest = insn.partition(" ")
    ops = [o.strip().replace(".reuse", "") for o in rest.split(",") if o]
    uses = _regs(g[1:]) if guard else set()
    defs = set()
    if ops and not opcode.startswith(("ST", "BRA", "EXIT", "CALL", "BSYNC",
                                      "BSSY", "BAR")):
        wide = ".WIDE" in opcode or (opcode.startswith(("LD", "ULD"))
                                     and ".64" in opcode)
        first = ops.pop(0)
        defs = _regs(first + (".64" if wide and ".64" not in first else ""))
        while ops and re.fullmatch(r"U?P(\d+|T)", ops[0]):
            defs.add(ops.pop(0))         # carry-out / compare predicates
        if ".WIDE" in opcode and len(ops) >= 3 and \
                re.fullmatch(r"R\d+", ops[2]):
            ops[2] += ".64"              # the 64-bit addend
    elif opcode.startswith("ST") and ".64" in opcode and len(ops) >= 2:
        ops[1] += ".64"
    for o in ops:
        uses |= _regs(o)
    return opcode, defs - {"RZ", "PT"}, uses - {"RZ", "PT"}, guard


def _stored_value_slice(insns: list, idx: int) -> list:
    """The instructions that compute the value stored by insns[idx]: its
    backward data slice, stopped at loads."""
    opcode, _, _, _ = _defs_uses(insns[idx])
    value = insns[idx].partition(" ")[2].split(",")[1].strip()
    needed = _regs(value + (".64" if ".64" in opcode else ""))
    out = []
    for insn in reversed(insns[:idx]):
        if not needed:
            break
        op, defs, uses, guard = _defs_uses(insn)
        if defs & needed:
            out.append(insn)
            if not guard:
                needed -= defs
            if not op.startswith(("LD", "ULD", "S2R", "S2UR")):
                needed |= uses
    return out[::-1]


def _int_ops(insns: list) -> int:
    """Integer operations of per-thread instructions, as the 33.5 T/s
    INT32 peak counts them: a multiply-add (IMAD, IMAD.WIDE) as 2; an add
    (IMAD.IADD, IMAD.X, IMAD.SHL, IADD3, ...) as 1; a move (MOV,
    IMAD.MOV) as 0."""
    n = 0
    for insn in insns:
        opcode = insn.split()[1] if insn.startswith("@") else insn.split()[0]
        base, mods = opcode.split(".")[0], opcode.split(".")[1:]
        if base == "MOV" or (base == "IMAD" and "MOV" in mods):
            continue
        if base == "IMAD":
            n += 2 if "WIDE" in mods or not {"IADD", "X", "SHL"} & set(mods) \
                else 1
        elif base in _INT_OPS:
            n += 1
    return n


def sass_report() -> dict:
    """What the compiler made of two kernels: qmatmul's tensor-core MMA
    instructions (and no dp4a), and the integer operations of one 64-bit
    Montgomery multiply in modmul: the backward slice of each product a
    kernel stores, and the fewest over them, which MODMUL_OPS restates."""
    qm = [i for insns in _sass("qmatmul").values() for i in insns]
    imma = [i for i in qm if i.split()[0].startswith("IMMA")]
    mont = {}
    for fn, insns in _sass("modmul").items():
        slices = [_stored_value_slice(insns, k)
                  for k, i in enumerate(insns) if i.startswith("STG")]
        mont[fn] = {"ops_per_store": [_int_ops(s_) for s_ in slices],
                    "slice": slices[-1] if slices else []}
    return {"qmatmul": {"imma": len(imma), "imma_lines": sorted(set(
                            i.split()[0] for i in imma)),
                        "imma_sample": imma[:4],
                        "idp": sum(i.split()[0].startswith("IDP")
                                   for i in qm)},
            "modmul": mont, "MODMUL_OPS": MODMUL_OPS,
            "modmul_min_ops": min((n for f in mont.values()
                                   for n in f["ops_per_store"]), default=None)}


def phase_build(state) -> dict:
    import torch
    from repro_torch.kernels import _build
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, timeout=60).stdout.strip().splitlines()
    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    regs = {name: [ln.strip() for ln in log.splitlines()
                   if "registers" in ln]
            for name, log in _build.build_log.items() if name != "seconds"}
    sass = sass_report()
    fresh = _fresh_process_stats()
    ok = (sass["qmatmul"]["imma"] > 0 and sass["qmatmul"]["idp"] == 0
          and fresh["misses"] == 0 and fresh["disk_writes"] == 0)
    return {"nvidia_smi": state["smi"], "torch": torch.__version__,
            "cuda": torch.version.cuda, "nvcc": nvcc[-1] if nvcc else "",
            "build_s": build_s, "ptxas": regs, "sass": sass,
            "fresh_process_exec_stats": fresh, "_ok": ok}


_FRESH_CHILD = """
import json, torch
from repro_torch.core import execache
from repro_torch.field import FQ
from repro_torch.kernels import modmul as mk
a = torch.arange(1, 9, device="cuda")
mk.modmul(FQ, a, a)
torch.cuda.synchronize()
print(json.dumps(dict(execache.stats(), launches=mk.modmul.launches)))
"""


def _fresh_process_stats() -> dict:
    """execache.stats() of a fresh interpreter that calls one kernel
    after this process built them all: it must compile nothing."""
    from repro_torch.audit.report import _child_env
    res = subprocess.run([sys.executable, "-c", _FRESH_CHILD],
                         env=_child_env(), capture_output=True, text=True,
                         timeout=300)
    if res.returncode != 0:
        raise RuntimeError(f"fresh process failed: {res.stderr[-2000:]}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def _rand_field(spec, n, rng, device):
    import torch
    v = rng.integers(0, spec.modulus, size=n, dtype="uint64") % spec.modulus
    t = torch.as_tensor(v.astype("int64"), device=device)
    t[:3] = torch.tensor([0, 1, spec.modulus - 1], device=device)
    return t


def _max_err(a, b) -> int:
    return int((a - b).abs().max())


def phase_kernels(state) -> dict:
    import numpy as np
    import torch
    from repro_torch.field import FP, FQ, encode_int
    from repro_torch.kernels import generators as gk
    from repro_torch.kernels import modmul as mk
    from repro_torch.kernels import sumcheck_fold as fk
    from repro_torch.kernels import validity_tables as vk

    dev = torch.device("cuda")
    rng = np.random.default_rng(11)
    res, ok = {}, True
    n = 1 << 24

    errs, ms, pms = [], {}, {}
    for spec in (FQ, FP):
        a = _rand_field(spec, n, rng, dev)
        b = _rand_field(spec, n, rng, dev)[torch.randperm(n, device=dev)]
        got, want = mk.modmul(spec, a, b), mk.modmul_plain(spec, a, b)
        errs.append(_max_err(got, want))
        errs.append(_max_err(mk.modmul(spec, a, 12345),
                             mk.modmul_plain(spec, a, 12345)))
        ms[spec.name] = cuda_ms(lambda: mk.modmul(spec, a, b))
        pms[spec.name] = cuda_ms(lambda: mk.modmul_plain(spec, a, b), 2)
    res["modmul"] = {"n": n, "max_abs_err": max(errs), "ms": ms["Fq"],
                     "plain_ms": pms["Fq"], "ms_fp": ms["Fp"],
                     "plain_ms_fp": pms["Fp"],
                     "bytes": 24 * n, "ops": MODMUL_OPS * n}

    x = _rand_field(FQ, n, rng, dev)
    r = encode_int(FQ, int(rng.integers(0, FQ.modulus, dtype="uint64")))
    errs = [_max_err(fk.fold(x, r), fk.fold_plain(x, r)),
            _max_err(fk.fold(x, r, inner=4096), fk.fold_plain(x, r, 4096))]
    res["fold"] = {"n": n, "max_abs_err": max(errs),
                   "ms": cuda_ms(lambda: fk.fold(x, r)),
                   "plain_ms": cuda_ms(lambda: fk.fold_plain(x, r), 2),
                   "bytes": 12 * n, "ops": MODMUL_OPS * n // 2}
    c_hi = encode_int(FQ, 987654321)
    err = _max_err(fk.fold_halves(x, r, c_hi),
                   fk.fold_halves_plain(x, r, c_hi))
    res["fold_halves"] = {
        "n": n, "max_abs_err": err,
        "ms": cuda_ms(lambda: fk.fold_halves(x, r, c_hi)),
        "plain_ms": cuda_ms(lambda: fk.fold_halves_plain(x, r, c_hi), 2),
        "bytes": 12 * n, "ops": MODMUL_OPS * n}
    del x

    # validity tables at the full-width stacked aux length Ds = 2^20
    ds, qb, rb = 1 << 20, 16, 8
    lim = 1 << (qb - 1)
    zpp = torch.as_tensor(rng.integers(0, lim, ds), device=dev)
    gap = torch.as_tensor(rng.integers(-lim, lim, ds), device=dev)
    bq = torch.as_tensor(rng.integers(0, 2, ds), device=dev)
    rz = torch.as_tensor(rng.integers(0, 1 << rb, ds), device=dev)
    rga = torch.as_tensor(rng.integers(0, 1 << rb, ds), device=dev)
    layout = vk.build_layout(zpp, gap, bq, rz, rga, qb, rb)
    nv = layout.vals.shape[0]
    ef = _rand_field(FQ, nv, rng, dev)
    es = _rand_field(FQ, nv, rng, dev)
    chal = [int(v) for v in rng.integers(0, FQ.modulus, 3, dtype="uint64")]
    got = vk.build_tables(layout, *chal, ef, es)
    want = vk.build_tables_plain(layout, *chal, ef, es)
    res["validity_tables"] = {
        "n": nv, "max_abs_err": max(_max_err(got[0], want[0]),
                                    _max_err(got[1], want[1])),
        "ms": cuda_ms(lambda: vk.build_tables(layout, *chal, ef, es)),
        "plain_ms": cuda_ms(lambda: vk.build_tables_plain(layout, *chal,
                                                          ef, es), 2),
        "bytes": 56 * nv, "ops": MODMUL_OPS * nv}
    del layout, ef, es, got, want

    # generators: kernel vs the hashlib loop on 2^16 indices of two labels
    ng = 1 << 16
    errs, plain_s = [], 0.0
    for label in (b"zkdl/gens/agg", b"zkrelu/Gpad/ds1048576-q16-r8"):
        got = gk.derive(label, 0, ng, dev)
        t0 = time.perf_counter()
        want = gk.derive_plain(label, 0, ng, dev)
        plain_s += time.perf_counter() - t0
        errs.append(_max_err(got, want))
    n_main = 1 << 27
    res["generators"] = {
        "n": n_main, "max_abs_err": max(errs),
        "ms": cuda_ms(lambda: gk.derive(b"zkdl/gens/agg", 0, n_main, dev),
                      2),
        "ms_n_plain": cuda_ms(lambda: gk.derive(b"zkdl/gens/agg", 0, ng,
                                                dev)),
        "plain_ms": plain_s / 2 * 1e3, "plain_n": ng,
        # one SHA-256 block and six Montgomery multiplies per generator
        "bytes": 8 * n_main, "ops": (SHA256_OPS + 6 * MODMUL_OPS) * n_main}
    res["pow_mul"] = _bench_pow_mul(rng, dev)
    res["qmatmul"] = _bench_qmatmul(rng, dev)
    res["msm"] = _bench_msm(rng, dev)
    for name, r_ in res.items():
        ok &= r_["max_abs_err"] == 0
    state["kernel_bench"] = res
    return {"kernels": res, "bit_exact": ok, "_ok": ok}


def _pair_fold_modmuls(e_hi: int) -> int:
    """Multiplies per output word of pow_mul with e_lo = 1 (the lo chain
    skipped): a squaring per bit below the top one, a multiply per set
    bit, and the final lo * hi^{e_hi}."""
    return e_hi.bit_length() - 1 + bin(e_hi).count("1") + 1


def _bench_pow_mul(rng, dev) -> dict:
    """pow_mul against its plain version at 2^24 outputs (0, 1 and p-1 in
    both halves; the pair fold's e_lo = 1, top bits set, a zero
    exponent), then timed at a pair-fold half of the full-width merged
    IPA (2^26 outputs: round 2 of a 2^28 merged length)."""
    from repro_torch.field import FP
    from repro_torch.kernels import sumcheck_fold as fk

    n_cmp, n_main = 1 << 24, 1 << 26
    gens = _rand_field(FP, 2 * n_cmp, rng, dev)
    gens[n_cmp:n_cmp + 3] = gens[:3].flip(0)
    e_main = int(rng.integers(1 << 60, 1 << 61, dtype="uint64"))
    pairs = [(1, e_main), ((1 << 61) - 1, 1 << 60), (0, e_main)]
    errs = [_max_err(fk.pow_mul_halves(gens, *e), fk.pow_mul_plain(gens, *e))
            for e in pairs]
    plain_ms = cuda_ms(lambda: fk.pow_mul_plain(gens, 1, e_main), 1)
    del gens
    big = _rand_field(FP, 2 * n_main, rng, dev)
    mm = _pair_fold_modmuls(e_main)
    return {"n": n_main, "max_abs_err": max(errs),
            "ms": cuda_ms(lambda: fk.pow_mul_halves(big, 1, e_main)),
            "plain_ms": plain_ms, "plain_n": n_cmp,
            "exponents": [1, e_main], "modmuls_per_word": mm,
            "bytes": 24 * n_main, "ops": MODMUL_OPS * mm * n_main}


#: the full-width merged opening's length (fcnn-zkdl-16l at depth 2)
MSM_N = 1 << 28


def _bench_msm(rng, dev) -> dict:
    """The msm kernel against the torch-op Pippenger
    (`group.msm_many_plain`) on the same card tensors, bit for bit, at
    1 to 2^20 terms and at one 2^28 row (exponents below q, with 0, 1
    and q - 1), then timed at that row and at round 1 of the full-width
    merged pair IPA: two rows of 2^28 terms, each two 2^27 halves read
    in place, against the plain path's two concatenated rows.  Bound:
    16 bytes a term, or one Montgomery product a term (as window_mfu
    counts); the design's own products (61 squarings shared by K terms,
    one selected multiply a term and bit) beside it."""
    import torch
    from repro_torch.core import group
    from repro_torch.field import FQ
    from repro_torch.kernels import msm as km

    errs = {}
    for n in (1, 33, 4097, 1 << 20):
        pts = group.derive_generators(b"zkdl/msm-bench", n, dev)
        e = _rand_field(FQ, n, rng, dev)[None] if n >= 3 else \
            torch.ones((1, n), dtype=torch.int64, device=dev)
        errs[n] = _max_err(group.msm_many(pts, e),
                           group.msm_many_plain(pts, e))
    n, n2 = MSM_N, MSM_N // 2
    gg = group.derive_generators(b"zkdl/msm-bench", n, dev)
    ea = _rand_field(FQ, n, rng, dev)
    errs[n] = _max_err(group.msm(gg, ea), group.msm_many_plain(gg, ea[None]))
    ms = cuda_ms(lambda: group.msm(gg, ea), 3)
    plain_ms = cuda_ms(lambda: group.msm_many_plain(gg, ea[None]), 1)
    hh = group.derive_generators(b"zkdl/msm-bench-h", n, dev)
    eb = _rand_field(FQ, n, rng, dev)
    segs = [([gg[n2:], gg[:n2]], [ea[:n2], ea[n2:]]),
            ([hh[:n2], hh[n2:]], [eb[n2:], eb[:n2]])]

    def plain_round():
        return torch.stack([
            group.msm_many_plain(torch.cat([gg[n2:], hh[:n2]]),
                                 torch.cat([ea[:n2], eb[n2:]])[None])[0],
            group.msm_many_plain(torch.cat([gg[:n2], hh[n2:]]),
                                 torch.cat([ea[n2:], eb[:n2]])[None])[0]])
    errs["round1"] = _max_err(group.msm_segments(segs), plain_round())
    round_ms = cuda_ms(lambda: group.msm_segments(segs), 3)
    round_plain_ms = cuda_ms(plain_round, 1)
    del gg, hh, ea, eb, segs
    k, threads = km.geometry(n, 1)
    products = 61 + 61 / k
    return {"n": n, "max_abs_err": max(errs.values()), "errs": errs,
            "ms": ms, "plain_ms": plain_ms, "round1_ms": round_ms,
            "round1_plain_ms": round_plain_ms, "round1_terms": 2 * n,
            "terms_per_thread": k, "threads_per_block": threads,
            "bytes": 16 * n, "ops": MODMUL_OPS * n,
            "design_products_per_term": products,
            "design_ops": MODMUL_OPS * products * n,
            "design_bound_ms": bound_ms(0, MODMUL_OPS * products * n)[0]}


def _int16(rng, shape, edges: bool = True):
    import torch
    x = torch.as_tensor(rng.integers(-2 ** 15, 2 ** 15, shape),
                        dtype=torch.int16)
    if edges:
        x.view(-1)[:2] = torch.tensor([-2 ** 15, 2 ** 15 - 1])
    return x


#: the witness's exact products at the full width, with the operand
#: layouts it passes (core/quantfc.py): name -> ((M, K, N), A a .T view,
#: B a .T view)
QMATMUL_SHAPES = {"Z": ((FULL_BATCH, 4096, 4096), False, False),
                  "G_X": ((FULL_BATCH, 4096, 4096), False, True),
                  "G_W": ((4096, FULL_BATCH, 4096), True, False)}


def _views(a, b, a_t: bool, b_t: bool, dev):
    """a, b on ``dev``, each as the .T view of a contiguous transpose
    where asked."""
    a, b = a.to(dev), b.to(dev)
    return (a.T.contiguous().T if a_t else a,
            b.T.contiguous().T if b_t else b)


def time_qmatmul(qmatmul_i64, a, b, reps: int = 20) -> dict:
    """One whole ``qmatmul_i64(a, b)`` on the card: its device time
    (calls replayed from a CUDA graph) and its time per back-to-back call
    from Python, beside the bound (bytes 2MK + 2KN + 8MN, operations
    4 x 2MNK int8) and the library yardstick, four torch._int_mm calls on
    the reference's int8 digit matrices, which the port never makes."""
    import torch

    def digits(x):
        x = x.to(torch.int32)
        return ((x >> 8).to(torch.int8).contiguous(),
                ((x & 0xFF) - 128).to(torch.int8).contiguous())
    (m, k), n = a.shape, b.shape[1]
    (a_hi, a_c), (b_hi, b_c) = digits(a), digits(b)
    pairs = [(a_hi, b_hi), (a_hi, b_c), (a_c, b_hi), (a_c, b_c)]
    n_bytes, n_ops = 2 * m * k + 2 * k * n + 8 * m * n, 4 * 2 * m * n * k
    b_ms, b_by = bound_ms(n_bytes, n_ops, INT8_TC_OPS_PER_S)
    ms = graph_ms(lambda: qmatmul_i64(a, b), reps)
    return {"shape": [m, k, n], "a_strides": list(a.stride()),
            "b_strides": list(b.stride()), "ms": ms,
            "host_loop_ms": cuda_ms(lambda: qmatmul_i64(a, b), reps),
            "bound_ms": b_ms, "bound_by": b_by, "share_of_bound": b_ms / ms,
            "library_ms": cuda_ms(lambda: [torch._int_mm(x, y)
                                           for x, y in pairs], reps),
            "bytes": n_bytes, "ops": n_ops}


def _bench_qmatmul(rng, dev) -> dict:
    """qmatmul_i64, the fused kernel, bit for bit against its plain
    version on CPU copies (CUDA has no integer matmul) at the witness
    shapes with the witness's operand layouts (QMATMUL_SHAPES) and at the
    edges: a ragged shape, K = 1, K off the 64-entry K tile, int16
    extremes in both operands, and the largest accepted K at M = N = 1.
    Timed at the witness shapes by `time_qmatmul`."""
    import torch
    from repro_torch.kernels import qmatmul as qk

    errs, shapes, edges = [], {}, {}
    for name, ((m, k, n), a_t, b_t) in QMATMUL_SHAPES.items():
        a, b = _int16(rng, (m, k)), _int16(rng, (k, n))
        da, db = _views(a, b, a_t, b_t, dev)
        got = qk.qmatmul_i64(da, db)
        t0 = time.perf_counter()
        want = qk.qmatmul_i64(a, b)
        plain_ms = (time.perf_counter() - t0) * 1e3
        errs.append(_max_err(got.cpu(), want))
        del got, want
        shapes[name] = dict(time_qmatmul(qk.qmatmul_i64, da, db),
                            plain_ms_cpu=plain_ms)
        del da, db
    k_max = qk.K_MAX
    for name, (m, k, n), fill in [
            ("ragged", (1000, 777, 333), None), ("k1", (37, 1, 45), None),
            ("k_off_tile", (130, 100, 72), None),
            ("min_x_min", (65, 200, 67), (-2 ** 15, -2 ** 15)),
            ("min_x_max", (65, 200, 67), (-2 ** 15, 2 ** 15 - 1)),
            ("k_max", (1, k_max, 1), None),
            ("k_max_min_x_min", (1, k_max, 1), (-2 ** 15, -2 ** 15))]:
        if fill is None:
            a, b = _int16(rng, (m, k)), _int16(rng, (k, n))
        else:
            a = torch.full((m, k), fill[0], dtype=torch.int16)
            b = torch.full((k, n), fill[1], dtype=torch.int16)
        want = qk.qmatmul_i64(a, b)
        err = max(_max_err(qk.qmatmul_i64(*_views(a, b, a_t, b_t, dev))
                           .cpu(), want)
                  for a_t in (False, True) for b_t in (False, True))
        edges[name] = {"shape": [m, k, n], "max_abs_err": err}
        errs.append(err)
    main = shapes["Z"]
    return {"n": f"{FULL_BATCH}x4096x4096", "max_abs_err": max(errs),
            "ms": main["ms"], "plain_ms": main["plain_ms_cpu"],
            "plain_device": "cpu", "library_ms": main["library_ms"],
            "bytes": main["bytes"], "ops": main["ops"],
            "ops_per_s": INT8_TC_OPS_PER_S, "shapes": shapes,
            "edges": edges}


def phase_golden(state) -> dict:
    import numpy as np
    from repro_torch.core.quantfc import QuantConfig, synthetic_sgd_trajectory
    from repro_torch.core.pipeline import (GraphBuilder, compile,
                                           encode_proof, prove_session,
                                           verify_bytes)
    qc = QuantConfig(16, 4)
    out, ok = {}, True
    for T in (1, 2):
        graph = GraphBuilder(batch=2).input(4).dense(4).relu() \
            .dense(4).relu().output()
        pk, vk = compile(graph, qc, n_steps=T, device="cuda")
        wits = synthetic_sgd_trajectory(T, 2, 2, 4, qc, seed=7,
                                        device="cuda")
        raw = encode_proof(prove_session(pk, wits,
                                         np.random.default_rng(7)))
        digest = hashlib.sha256(raw).hexdigest()
        verified = verify_bytes(vk, raw)
        out[f"T{T}"] = {"sha256": digest, "golden": digest == GOLDEN_SHA256[T],
                        "verified": verified}
        ok &= digest == GOLDEN_SHA256[T] and verified
    val = _validity_golden()
    ok &= val["equal_to_reference"] and val["verified"]
    return {"golden": out, "validity": val, "_ok": ok}


def _validity_golden(dev: str = "cuda") -> dict:
    """`zkrelu.prove_validity` / `verify_validity` on the card (through
    the existing kernels): the proof must equal the reference's."""
    import numpy as np
    import torch
    from repro_torch.core import mle, zkrelu
    from repro_torch.core.transcript import Transcript
    from repro_torch.field import FQ

    q, ds, qb, rb = FQ.modulus, 8, 8, 4
    rng = np.random.default_rng(42)
    lim = 1 << (qb - 1)
    aux = [rng.integers(0, lim, size=ds), rng.integers(-lim, lim, size=ds),
           rng.integers(0, 2, size=ds), rng.integers(0, 1 << rb, size=ds),
           rng.integers(0, 1 << rb, size=ds)]
    keys = zkrelu.make_validity_keys(ds, qb, rb, dev)
    bits = zkrelu.build_aux_bits(*[torch.as_tensor(a, dtype=torch.int64,
                                                   device=dev)
                                   for a in aux], qb, rb)
    coms, blinds = zkrelu.commit_validity(keys, bits, rng)
    com_list = [coms.com_b_ip, coms.com_bq1, coms.com_bq1p, coms.com_br_ip]

    def transcript():
        t = Transcript(b"zkrelu-test")
        t.absorb_ints(b"coms", com_list)
        u = t.challenge_ints(b"urelu", q, 4)
        e = mle.hexpand_point(u[:-1])
        ev = [sum(int(a[i]) % q * e[i] for i in range(ds)) % q for a in aux]
        claims = [((1 - u[-1]) * ev[0] + u[-1] * ev[1]) % q, ev[2],
                  ((1 - u[-1]) * ev[3] + u[-1] * ev[4]) % q]
        t.absorb_ints(b"claims", claims)
        return t, u, claims

    t0 = time.perf_counter()
    tp, u_relu, (v, vq1, vr) = transcript()
    proof = zkrelu.prove_validity(keys, bits, blinds, u_relu, v, vq1, vr,
                                  tp, rng)
    tv, _, _ = transcript()
    verified = zkrelu.verify_validity(keys, coms, v, vq1, vr, u_relu, proof,
                                      tv)
    got = {"coms": com_list, "ls": proof.ls, "rs": proof.rs,
           "sigma": proof.sigma}
    return {"equal_to_reference": got == VALIDITY_GOLDEN,
            "verified": bool(verified),
            "seconds": time.perf_counter() - t0}


def _prove_again(pk, wit, profile: bool):
    """A second prove of the same window (kernels and allocator warm);
    with ``profile``, under torch.profiler, returning the top device
    kernels and the share of the wall time the card was busy."""
    import numpy as np
    import torch
    from repro_torch.core.pipeline import ProofSession, encode_proof

    session = ProofSession(pk, np.random.default_rng(0))
    session.add_step(wit)
    if not profile:
        t0 = time.perf_counter()
        raw = encode_proof(session.prove())
        return raw, time.perf_counter() - t0, None
    from torch.profiler import ProfilerActivity, profile as tprofile
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        raw = encode_proof(session.prove())
        wall = time.perf_counter() - t0
    return raw, wall, _device_profile(prof, wall)


def _device_profile(prof, wall: float) -> dict:
    """The top device kernels of a torch.profiler run and the share of
    ``wall`` seconds the card was busy."""
    import torch

    rows = []
    busy_us = 0.0
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue                  # operator rows repeat their kernels
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0))
        busy_us += dev_us
        rows.append((dev_us, ev.key, ev.count))
    rows.sort(reverse=True)
    top = [{"kernel": k[:90], "device_ms": us / 1e3, "calls": c}
           for us, k, c in rows[:15]]
    return {"wall_s": wall, "device_busy_s": busy_us / 1e6,
            "device_busy_share": busy_us / 1e6 / wall, "top_kernels": top}


def _full_witness(width: int, seed: int, qc, dev):
    """One step witness at the full width and depth FULL_LAYERS, drawn as
    the service's warm-up draws (`api.warm_witnesses`): weights and data
    from ``seed``, the weights scaled by 2/sqrt(fan-in) so every rescaled
    activation and gradient stays inside the 16-bit range (the
    reference's fixed 0.3 scale overflows Z' at width 4096)."""
    from repro_torch.core.pipeline import build_fcnn_graph
    from repro_torch.core.pipeline.api import warm_witnesses
    from repro_torch.core.pipeline.config import PipelineConfig

    cfg = PipelineConfig.from_graph(
        build_fcnn_graph((width,) * (FULL_LAYERS + 1), batch=FULL_BATCH),
        q_bits=qc.q_bits, r_bits=qc.r_bits, n_steps=1)
    return warm_witnesses(cfg, seed, dev)[0]


def phase_full(state, width: int, profile: bool = False) -> dict:
    import numpy as np
    import torch
    from repro_torch.core.quantfc import QuantConfig
    from repro_torch.core.pipeline import (GraphBuilder, ProofSession,
                                           compile, encode_proof,
                                           verify_bytes)
    from repro_torch import kernels

    qc = QuantConfig()                       # (16, 8)
    layers, batch = FULL_LAYERS, FULL_BATCH
    dev = torch.device("cuda")
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    b = GraphBuilder(batch=batch).input(width)
    for _ in range(layers):
        b = b.dense(width).relu()
    pk, vk = compile(b.output(), qc, n_steps=1, device=dev)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0

    t0 = time.perf_counter()
    wit = _full_witness(width, 0, qc, dev)
    torch.cuda.synchronize()
    t_wit = time.perf_counter() - t0

    peak_setup = torch.cuda.max_memory_allocated()

    session = ProofSession(pk, np.random.default_rng(0))
    session.add_step(wit)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    proof = session.prove()
    t_prove = time.perf_counter() - t0
    raw = encode_proof(proof)
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trace: list = []
    accepted = verify_bytes(vk, raw, trace=trace)
    t_verify = time.perf_counter() - t0
    peak_verify = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    rejected = not verify_bytes(vk, _tamper(raw))
    t_reject = time.perf_counter() - t0
    state["launches"] = counts
    raw2, t_prove_warm, trace_out = _prove_again(pk, wit, profile)
    ok = (accepted and rejected and raw2 == raw
          and all(v > 0 for v in counts.values()))
    return {"width": width, "batch": batch, "layers": layers,
            "quant": [qc.q_bits, qc.r_bits], "n_steps": 1,
            "reduced": {"layers": [16, layers]},
            "geometry": {"d_stack": pk.cfg.d_stack, "agg_len": pk.cfg.agg_len,
                         "merged_len": pk.cfg.merged_len},
            "setup_s": t_setup, "witness_s": t_wit, "prove_s": t_prove,
            "prove_warm_s": t_prove_warm, "deterministic": raw2 == raw,
            "device_profile": trace_out,
            "profile": session.last_profile.as_dict(),
            "proof_bytes": len(raw), "verify_s": t_verify,
            "verified": accepted, "verify_trace": trace,
            "tamper_rejected": rejected, "tamper_verify_s": t_reject,
            "launches": counts, "max_memory_allocated": peak,
            "max_memory_allocated_setup_witness": peak_setup,
            "max_memory_allocated_verify": peak_verify, "_ok": ok}


def _tamper(raw: bytes) -> bytes:
    """Flip one byte inside the SC section (sumcheck messages)."""
    from repro_torch.core.pipeline.proofio import _SECTIONS
    pos, sec_start = 6, None
    for i, _ in enumerate(_SECTIONS):
        length = int.from_bytes(raw[pos + 1: pos + 5], "little")
        if i == 3:
            sec_start = pos + 5 + length // 2
        pos += 5 + length
    bad = bytearray(raw)
    bad[sec_start] ^= 0x01
    return bytes(bad)


def _train_run(width: int, window: int, n_steps: int, seed: int) -> dict:
    """Prove-while-train through the port's step and hook: ``n_steps``
    integer SGD steps on the card, one aggregated proof per ``window``
    steps; every window's bytes verified from bytes and tampered."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.core.pipeline import compile, encode_proof, verify_bytes
    from repro_torch.core.quantfc import QuantConfig, quantize
    from repro_torch.launch import steps

    qc = QuantConfig()                       # (16, 8)
    dev = torch.device("cuda")
    zk_cfg = steps.build_proof_pipeline_config(
        get_config("fcnn-zkdl-16l"), batch=FULL_BATCH, n_steps=window,
        widths=(width,) * (FULL_LAYERS + 1))
    t0 = time.perf_counter()
    pk, vk = compile(zk_cfg.graph, qc, n_steps=window, device=dev)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    # 2/sqrt(width) weights as in phase_full: the reference trainer's
    # 0.3 scale overflows Z' at width 4096
    rng = np.random.default_rng(seed)
    ws0 = [torch.as_tensor(quantize(
        rng.uniform(-1, 1, (width, width)) * (2 / width ** 0.5), qc),
        device=dev) for _ in range(FULL_LAYERS)]
    hook = steps.ZkdlProveHook(pk, rng, verify=False)
    step_fn = steps.build_zkdl_step(zk_cfg, lr_shift=TRAIN_LR_SHIFT,
                                    device=dev)
    ws, witness_s = ws0, []
    for step in range(n_steps):
        batch = {"x": quantize(rng.uniform(-1, 1, (FULL_BATCH, width)), qc),
                 "y": quantize(rng.uniform(-1, 1, (FULL_BATCH, width)), qc)}
        t0 = time.perf_counter()
        ws, wit = step_fn(ws, batch)
        torch.cuda.synchronize()
        witness_s.append(time.perf_counter() - t0)
        hook.observe(step, wit)
    on_card = all(w.is_cuda for w in ws)
    changed = any(not torch.equal(a, b) for a, b in zip(ws0, ws))
    windows, ok = [], on_card and changed and hook.n_pending == 0
    for _, proof, prove_s in hook.proofs:
        raw = encode_proof(proof)
        t0 = time.perf_counter()
        accepted = verify_bytes(vk, raw, label=b"zkdl/train")
        verify_s = time.perf_counter() - t0
        rejected = not verify_bytes(vk, _tamper(raw), label=b"zkdl/train")
        windows.append({"prove_s": prove_s, "verify_s": verify_s,
                        "proof_bytes": len(raw),
                        "sha256": hashlib.sha256(raw).hexdigest(),
                        "verified": accepted, "tamper_rejected": rejected})
        ok &= accepted and rejected
    return {"width": width, "window": window, "steps": n_steps,
            "merged_len": pk.cfg.merged_len, "setup_s": t_setup,
            "witness_s": witness_s, "weights_on_card": on_card,
            "weights_changed": changed,
            "windows": windows, "_ok": ok}


def phase_train(state, width: int) -> dict:
    import torch
    from repro_torch import kernels
    from repro_torch.configs.registry import get_config
    from repro_torch.core import ipa
    from repro_torch.kernels import modmul as mk
    from repro_torch.launch import steps

    # geometry of the window sizes the card cannot hold at this width
    geometry = {f"T{t}": steps.build_proof_pipeline_config(
        get_config("fcnn-zkdl-16l"), batch=FULL_BATCH, n_steps=t,
        widths=(width,) * (FULL_LAYERS + 1)).merged_len for t in (1, 2, 4)}
    pair_fold_modmuls = []
    orig = ipa._pair_fold

    def counted(*args):
        before = mk.modmul.launches
        out = orig(*args)
        pair_fold_modmuls.append(mk.modmul.launches - before)
        return out

    ipa._pair_fold = counted
    try:
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        main = _train_run(width, 1, 2, seed=1)
        counts = kernels.launch_counts()
        peak = torch.cuda.max_memory_allocated()
    finally:
        ipa._pair_fold = orig
    state["launches_train"] = counts
    torch.cuda.reset_peak_memory_stats()
    agg = _train_run(AGG_WIDTH, AGG_STEPS, AGG_STEPS, seed=2)
    ok = (main.pop("_ok") and agg.pop("_ok") and counts["qmatmul"] > 0
          and counts["pow_mul"] > 0 and len(pair_fold_modmuls) > 0
          and sum(pair_fold_modmuls) == 0)
    return {"width": width, "batch": FULL_BATCH, "layers": FULL_LAYERS,
            "quant": [16, 8], "lr_shift": TRAIN_LR_SHIFT,
            "reduced": {"layers": [16, FULL_LAYERS], "prove_window": [4, 1]},
            "merged_len_by_window": geometry, "main": main,
            "launches": counts, "pair_fold_calls": len(pair_fold_modmuls),
            "pair_fold_modmul_launches": sum(pair_fold_modmuls),
            "max_memory_allocated": peak,
            "aggregated_T2": dict(agg, max_memory_allocated=(
                torch.cuda.max_memory_allocated())), "_ok": ok}


def phase_open(state) -> dict:
    import numpy as np
    import torch
    from repro_torch.core import ipa, pedersen
    from repro_torch.core.mle import fdot
    from repro_torch.core.transcript import Transcript
    from repro_torch.field import FQ, decode

    dev = torch.device("cuda")
    rng = np.random.default_rng(13)
    n = OPEN_N
    a, b = _rand_field(FQ, n, rng, dev), _rand_field(FQ, n, rng, dev)
    claim = int(decode(FQ, fdot(a, b).reshape(()))[()])
    key = pedersen.make_key(b"smoke/open", n, dev)
    com = pedersen.commit(key, a, 777)
    t0 = time.perf_counter()
    proof = ipa.open_prove(key, a, b, 777, claim, Transcript(b"smoke"),
                           np.random.default_rng(3))
    prove_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    accepted = ipa.open_verify(key, com, b, claim, proof,
                               Transcript(b"smoke"))
    verify_s = time.perf_counter() - t0
    rejected = not ipa.open_verify(key, com, b, (claim + 1) % FQ.modulus,
                                   proof, Transcript(b"smoke"))
    return {"n": n, "rounds": len(proof.ls), "prove_s": prove_s,
            "verify_s": verify_s, "verified": accepted,
            "wrong_claim_rejected": rejected, "_ok": accepted and rejected}


def _strip_timing(obj):
    """A report without its wall-clock fields: ``timings`` and every
    ``seconds``."""
    if isinstance(obj, dict):
        return {k: _strip_timing(v) for k, v in obj.items()
                if k not in ("timings", "seconds")}
    if isinstance(obj, list):
        return [_strip_timing(v) for v in obj]
    return obj


def _diff_paths(got, want, path: str = "") -> list:
    """The paths at which two JSON values differ."""
    if isinstance(got, dict) and isinstance(want, dict):
        return [p for k in sorted(set(got) | set(want))
                for p in _diff_paths(got.get(k), want.get(k),
                                     f"{path}/{k}")]
    if isinstance(got, list) and isinstance(want, list) and \
            len(got) == len(want):
        return [p for i, (g, w) in enumerate(zip(got, want))
                for p in _diff_paths(g, w, f"{path}/{i}")]
    return [] if got == want else [path or "/"]


def _audit_recorded(work: str, dev) -> dict:
    """(a): `run_audit` at the recorded reference report's configuration,
    equal to `AUDIT_report.json` in every field but the timings."""
    from repro_torch.audit.report import run_audit

    with open(os.path.join(ROOT, "AUDIT_report.json")) as f:
        recorded = json.load(f)
    cfg = recorded["config"]
    report = run_audit(smoke=cfg["smoke"], widths=tuple(cfg["widths"]),
                       batch=cfg["batch"], n_steps=cfg["n_steps"],
                       q_bits=cfg["q_bits"], r_bits=cfg["r_bits"],
                       seed=cfg["seed"], label=cfg["label"].encode(),
                       work_dir=os.path.join(work, "recorded"),
                       fresh_process=True, device=dev)
    with open(os.path.join(OUT_DIR, "AUDIT_report.json"), "w") as f:
        json.dump(report, f, indent=2)
    diffs = _diff_paths(_strip_timing(report), _strip_timing(recorded))
    return {"config": cfg, "timings": report["timings"],
            "attack_s": {o["name"]: o["seconds"] for o in report["attacks"]},
            "membership_s": report["membership"]["seconds"],
            "scbd_s": report["scbd"]["seconds"],
            "summary": report["summary"], "differs_from_recorded": diffs,
            "_ok": bool(report["ok"]) and not diffs}


class _Counted:
    """Counts the calls of one module attribute while installed."""

    def __init__(self, module, name: str):
        self.module, self.name, self.calls = module, name, 0
        self.orig = getattr(module, name)

    def __enter__(self):
        def counted(*args, **kwargs):
            self.calls += 1
            return self.orig(*args, **kwargs)
        setattr(self.module, self.name, counted)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def _audit_full(width: int, work: str, dev, scbd_d: int) -> dict:
    """(b): the battery, the membership audit and SC-BD at the full
    width, on an AttackContext built from its fields: phase 4's witness
    recipe (the reference's synthetic stream overflows G_A' at batch
    128), the train phase's SGD step, and a second honest window from a
    second seed."""
    import numpy as np
    import torch
    from repro_torch.audit import attacks
    from repro_torch.audit import report as audit_report
    from repro_torch.core.pipeline import (build_fcnn_graph, compile,
                                           encode_proof, prove_session,
                                           verify_bytes)
    from repro_torch.core.quantfc import QuantConfig

    qc, seed, label = QuantConfig(), 0, b"zkdl"             # (16, 8)
    widths = (width,) * (FULL_LAYERS + 1)
    t0 = time.perf_counter()
    pk, vk = compile(build_fcnn_graph(widths, batch=FULL_BATCH), qc,
                     n_steps=1, device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    wit = _full_witness(width, seed, qc, dev)
    t0 = time.perf_counter()
    raw = encode_proof(prove_session(pk, [wit], np.random.default_rng(seed),
                                     label=label))
    prove_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    honest = verify_bytes(vk, raw, label=label)
    verify_s = time.perf_counter() - t0
    ctx = attacks.AttackContext(
        pk=pk, vk=vk, quant=qc, wits=[wit], widths=widths, batch=FULL_BATCH,
        n_steps=1, label=label, seed=seed, lr_shift=TRAIN_LR_SHIFT,
        proof_bytes=raw, compile_seconds=setup_s, prove_seconds=prove_s)
    wits2 = [_full_witness(width, seed + 1, qc, dev)]
    raw2 = ctx.reprove(wits2, 999)
    honest2 = verify_bytes(vk, raw2, label=label)
    ctx._second = (wits2, raw2)

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with _Counted(attacks, "prove_session") as proves, \
            _Counted(attacks, "verify_bytes") as verifies:
        battery = attacks.run_battery(ctx)
    battery_s = time.perf_counter() - t0
    peak_battery = torch.cuda.max_memory_allocated()
    membership = audit_report._membership_section(
        ctx, os.path.join(work, "full"), True)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    scbd = audit_report._scbd_section(ctx, max_d=scbd_d)
    scbd_peak = torch.cuda.max_memory_allocated() - base

    control = {o.name: o for o in battery}["cross_window_replay"].variants[1]
    ok = (honest and honest2 and len(battery) == 14
          and all(o.rejected for o in battery)
          and control.rejected and control.trace == ""
          and membership["ok"] and membership["n_members"] == 5
          and membership["n_window_members"] == 3
          and membership["n_non_members"] == 3
          and membership["cross_process"]["ran"]
          and membership["cross_process"]["ok"]
          and scbd["ok"] and scbd["tamper_rejected"] and scbd["d"] == scbd_d)
    return {"width": width, "batch": FULL_BATCH, "layers": FULL_LAYERS,
            "quant": [qc.q_bits, qc.r_bits], "n_steps": 1,
            "lr_shift": TRAIN_LR_SHIFT,
            "reduced": {"layers": [16, FULL_LAYERS],
                        "scbd_d": [pk.cfg.d_stack, scbd_d]},
            "setup_s": setup_s, "prove_s": prove_s, "verify_s": verify_s,
            "battery_s": battery_s, "proves_in_battery": proves.calls,
            "verifies_in_battery": verifies.calls,
            "attacks": [o.as_dict() for o in battery],
            "membership": membership, "scbd": dict(scbd, peak_bytes=scbd_peak),
            "max_memory_allocated_battery": peak_battery, "_ok": ok}


def phase_audit(state, width: int) -> dict:
    import torch
    from repro_torch import kernels

    work = os.path.join(OUT_DIR, "audit")
    dev = torch.device("cuda")
    kernels.reset_launch_counts()
    recorded = _audit_recorded(work, dev)
    launches_recorded = kernels.launch_counts()
    kernels.reset_launch_counts()
    full = _audit_full(width, work, dev, AUDIT_SCBD_D)
    launches_full = kernels.launch_counts()
    state["launches_audit"] = {k: launches_recorded[k] + launches_full[k]
                               for k in launches_full}
    ok = recorded.pop("_ok") and full.pop("_ok")
    return {"recorded": dict(recorded, launches=launches_recorded),
            "full": dict(full, launches=launches_full), "_ok": ok}


# ---------------------------------------------------------------------------
# serve: the crash-safe prover service, the gateway and --proof-dir
# ---------------------------------------------------------------------------

SERVE_STEPS = 3                    # (a): windows of T = 1
GATEWAY_WIDTH = 1024               # (d): pool 2 (two full-width proves
                                   # would need ~95 GB at once)
TRAIN_D_MODEL, TRAIN_BATCH = 256, 4  # (f): the trainer's own 0.3-scaled
                                     # weights overflow from batch 8 here


def _fs_type(path: str) -> str:
    """The filesystem type of the mount that holds ``path``."""
    path, best, kind = os.path.realpath(path), "", "unknown"
    with open("/proc/mounts") as f:
        for line in f:
            parts = line.split()
            mnt = parts[1]
            if (path == mnt or path.startswith(mnt.rstrip("/") + "/")) \
                    and len(mnt) >= len(best):
                best, kind = mnt, parts[2]
    return f"{kind} at {best}"


def _verify_dir(out: str, windows, label: bytes, dev) -> dict:
    """The exactly-once audit of one service or tenant directory from
    disk: one COMMITTED line per window, every proof accepted by
    `verify_bytes` under ``vk.bin``, no journal left."""
    from repro_torch.core.pipeline import verify_bytes
    from repro_torch.core.pipeline.proofio import decode_vk
    from repro_torch.launch import serve

    counts = serve.manifest_commit_counts(out)
    with open(os.path.join(out, "vk.bin"), "rb") as f:
        vk = decode_vk(f.read(), max_merged_len=1 << 30, device=dev)
    verified, t0 = [], time.perf_counter()
    for w in windows:
        with open(os.path.join(out, f"proof_{w:06d}.bin"), "rb") as f:
            verified.append(verify_bytes(vk, f.read(), label=label))
    journal = serve.journal_steps(serve.journal_dir(out))
    ok = (all(counts.get(w, 0) == 1 for w in windows)
          and set(counts) == set(windows) and all(verified) and not journal)
    return {"commit_lines": {str(w): counts.get(w, 0) for w in windows},
            "verified_from_disk": verified,
            "verify_s": time.perf_counter() - t0,
            "journal_left": journal, "ok": ok}


def _stamp_commits(obj):
    """Wall-clock stamps of the COMMITTED lines ``obj`` appends (a
    service or a gateway tenant): {window: perf_counter at the append}."""
    stamps, orig = {}, obj._manifest_append

    def append(rec):
        orig(rec)
        if rec.get("status") == "COMMITTED":
            stamps[int(rec["window"])] = time.perf_counter()
    obj._manifest_append = append
    return stamps


def _submit_steps(svc, wits) -> dict:
    """Submit ``wits`` (T = 1) and time each `submit` (journal write
    included); the size of each journal segment on disk."""
    from repro_torch.launch import serve

    submit_s, mb, submitted_at = [], [], {}
    jdir = serve.journal_dir(svc.out_dir)
    for wit in wits:
        step = svc.next_step
        t0 = time.perf_counter()
        svc.submit(wit)
        submitted_at[step] = time.perf_counter()
        submit_s.append(submitted_at[step] - t0)
        path = os.path.join(jdir, f"step_{step:08d}.npz")
        mb.append(os.path.getsize(path) / 1e6 if os.path.exists(path)
                  else None)
    return {"submit_s": submit_s, "journal_mb": mb, "_at": submitted_at}


def _shared_faults(graph, qc, dev) -> dict:
    """The two faults the port shares with the reference at this
    geometry, which the service repairs: the reference's warm-up stream
    (its synthetic SGD trajectory) leaves the Q-bit range, and the
    default decode cap refuses the ``vk.bin`` a prove child reads."""
    from repro_torch.core.pipeline import VerifyingKey
    from repro_torch.core.pipeline.graph import graph_widths
    from repro_torch.core.pipeline.proofio import ProofDecodeError, decode_vk
    from repro_torch.core.pipeline.config import PipelineConfig
    from repro_torch.core.quantfc import synthetic_sgd_trajectory_widths

    out = {}
    try:
        synthetic_sgd_trajectory_widths(1, graph_widths(graph), FULL_BATCH,
                                        qc, seed=0, device=dev)
        out["reference_warm_stream"] = "no error"
    except OverflowError as exc:
        out["reference_warm_stream"] = f"OverflowError: {exc}"
    cfg = PipelineConfig.from_graph(graph, q_bits=qc.q_bits,
                                    r_bits=qc.r_bits, n_steps=1)
    try:
        decode_vk(VerifyingKey(cfg=cfg).to_bytes())
        out["default_decode_cap"] = "accepted"
    except ProofDecodeError as exc:
        out["default_decode_cap"] = f"ProofDecodeError: {exc}"
    return out


def _serve_thread(width: int, out: str, dev) -> dict:
    """(a): ProverService at the full width, T = 1, verify=True, warmed,
    three steps from phase `full`'s witness recipe, then close."""
    import torch
    from repro_torch.core.pipeline import build_fcnn_graph
    from repro_torch.core.quantfc import QuantConfig
    from repro_torch.launch.serve import ProverService

    qc = QuantConfig()
    graph = build_fcnn_graph((width,) * (FULL_LAYERS + 1), batch=FULL_BATCH)
    faults = _shared_faults(graph, qc, dev)
    torch.cuda.reset_peak_memory_stats()
    svc = ProverService(graph, qc, n_steps=1, out_dir=out, verify=True,
                        rng_seed=0, device=dev)
    svc.start(warm=True)
    reserved_after_warm = torch.cuda.memory_reserved()
    stamps = _stamp_commits(svc)
    wits = [_full_witness(width, s, qc, dev) for s in range(SERVE_STEPS)]
    torch.cuda.synchronize()
    sub = _submit_steps(svc, wits)
    del wits
    svc.close()
    at = sub.pop("_at")
    return dict(sub, shared_faults=faults, warm_s=svc.warm_seconds,
                warm_stats=svc.warm_stats,
                prove_s=[p[3] for p in svc.proofs],
                commit_latency_s=[stamps[w] - at[w] for w in sorted(stamps)],
                proof_bytes=[p[2] for p in svc.proofs], stats=svc.stats,
                max_memory_allocated=torch.cuda.max_memory_allocated(),
                max_memory_reserved=torch.cuda.max_memory_reserved(),
                memory_reserved_after_warm_release=reserved_after_warm,
                journal_fs=_fs_type(out), tmp_fs=_fs_type(
                    os.environ.get("TMPDIR", "/tmp")),
                _ok=svc.stats["proved"] == SERVE_STEPS)


def _serve_restart(width: int, out: str, dev) -> dict:
    """(b): (a)'s directory, one more step with ``commit/pre-manifest``
    injected once (the proof lands, its manifest line does not, the
    worker dies), then a restart that replays and commits it."""
    from repro_torch.core.pipeline import build_fcnn_graph
    from repro_torch.core.quantfc import QuantConfig
    from repro_torch.launch.serve import ProverService
    from repro_torch.train.resilience import FailureInjector, SimulatedFailure

    qc = QuantConfig()
    graph = build_fcnn_graph((width,) * (FULL_LAYERS + 1), batch=FULL_BATCH)
    svc = ProverService(graph, qc, n_steps=1, out_dir=out, verify=True,
                        rng_seed=0, device=dev,
                        injector=FailureInjector.from_spec(
                            "commit/pre-manifest@0"))
    svc.start(warm=False)
    step = svc.next_step
    svc.submit(_full_witness(width, step, qc, dev))
    try:
        svc.close()
        crashed = False
    except SimulatedFailure:
        crashed = True
    t0 = time.perf_counter()
    svc2 = ProverService(graph, qc, n_steps=1, out_dir=out, verify=True,
                         rng_seed=0, device=dev)
    svc2.start(warm=False)
    restart_s = time.perf_counter() - t0
    replayed, next_step = svc2.stats["replayed"], svc2.next_step
    svc2.close()
    audit = _verify_dir(out, range(step + 1), b"zkdl/train", dev)
    return {"crashed_before_commit": crashed, "resubmitted_step": step,
            "restart_s": restart_s, "replayed": replayed,
            "next_step_after_restart": next_step,
            "proved_after_restart": svc2.stats["proved"], "audit": audit,
            "_ok": crashed and replayed == 1 and svc2.stats["proved"] == 1
            and next_step == step + 1 and audit["ok"]}


def _serve_subprocess(width: int, out: str, dev) -> dict:
    """(c): one window under subprocess isolation; the first child
    SIGKILLs itself at ``prove/mid`` (after its setup), the retry proves
    and the parent commits.  Both processes' peak memory: the child
    prints its own, the parent's comes from its allocator."""
    import torch
    from repro_torch.core.pipeline import build_fcnn_graph
    from repro_torch.core.quantfc import QuantConfig
    from repro_torch.launch import serve

    qc = QuantConfig()
    graph = build_fcnn_graph((width,) * (FULL_LAYERS + 1), batch=FULL_BATCH)
    results = []
    orig = serve.supervise.run_subprocess_supervised

    def kept(*args, **kwargs):
        res = orig(*args, **kwargs)
        results.append(res)
        return res

    env = {"ZKDL_FAULTS": "prove/mid@0:kill",
           "ZKDL_FAULTS_ONCE": os.path.join(out, "fired")}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    serve.supervise.run_subprocess_supervised = kept
    try:
        torch.cuda.reset_peak_memory_stats()
        svc = serve.ProverService(graph, qc, n_steps=1, out_dir=out,
                                  verify=True, rng_seed=0, device=dev,
                                  isolation="subprocess", max_attempts=3,
                                  backoff_base=0.1, prove_timeout=900)
        svc.start(warm=True)
        reserved_before_child = torch.cuda.memory_reserved()
        svc.submit(_full_witness(width, 0, qc, dev))
        svc.close()
    finally:
        serve.supervise.run_subprocess_supervised = orig
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    (res,) = results
    child = {}
    for line in res.value.stdout.splitlines():
        if line.startswith("[serve:child] {"):
            child = json.loads(line[len("[serve:child] "):])
    attempts = [{"seconds": a.seconds, "error": a.error, "signal": a.signal}
                for a in res.attempts]
    audit = _verify_dir(out, [0], b"zkdl/train", dev)
    man = serve.read_manifest(out)
    ok = (len(attempts) == 2 and attempts[0]["signal"] == 9
          and man[0]["attempts"] == 2 and audit["ok"] and bool(child))
    return {"attempts": attempts, "warm_s": svc.warm_seconds,
            "child": child,
            "child_cold_start_s": (attempts[-1]["seconds"]
                                   - child.get("prove_s", 0.0)),
            "killed_child_s": attempts[0]["seconds"],
            "parent_max_memory_reserved": torch.cuda.max_memory_reserved(),
            "parent_max_memory_allocated": torch.cuda.max_memory_allocated(),
            "parent_memory_reserved_before_child": reserved_before_child,
            "card_free_after": torch.cuda.mem_get_info()[0],
            "commit_prove_s": man[0]["prove_s"], "audit": audit, "_ok": ok}


def _gateway_run(out: str, graph, qc, wits, dev, pool: int, injector):
    """Two tenants (weights 2:1), one window each, on a pool of ``pool``
    workers: (gateway, tenants, commit stamps, submit stamps, wall s)."""
    from repro_torch.launch.serve import ProvingGateway

    gw = ProvingGateway(out, n_workers=pool, backoff_base=0.01,
                        injector=injector, device=dev).start()
    tenants, stamps, at = {}, {}, {}
    for i, (name, weight) in enumerate((("alice", 2.0), ("bob", 1.0))):
        tenants[name] = gw.add_tenant(name, graph, qc, n_steps=1,
                                      weight=weight, verify=True,
                                      rng_seed=i, warm=(i == 0))
        stamps[name] = _stamp_commits(tenants[name])
    t0 = time.perf_counter()
    for name, wit in zip(tenants, wits):
        gw.submit(name, wit)
        at[name] = time.perf_counter()
    gw.close()
    return gw, tenants, stamps, at, time.perf_counter() - t0


def _serve_gateway(out: str, dev) -> dict:
    """(d): two tenants (weights 2:1) on a pool of 2 at GATEWAY_WIDTH,
    one window each, the first dequeue killing its worker thread; both
    commit exactly once, and `dir_status` agrees with `status()`.  Then
    the same two windows on a pool of 1, for the wall time."""
    from repro_torch.core.pipeline import build_fcnn_graph
    from repro_torch.core.quantfc import QuantConfig
    from repro_torch.launch.serve import dir_status
    from repro_torch.train.resilience import FailureInjector

    qc = QuantConfig()
    graph = build_fcnn_graph((GATEWAY_WIDTH,) * (FULL_LAYERS + 1),
                             batch=FULL_BATCH)
    wits = [_full_witness(GATEWAY_WIDTH, 10 + i, qc, dev) for i in (0, 1)]
    gw, tenants, stamps, at, wall = _gateway_run(
        os.path.join(out, "pool2"), graph, qc, wits, dev, 2,
        FailureInjector.from_spec("pool/worker-kill@0"))
    _, tenants1, _, _, wall1 = _gateway_run(
        os.path.join(out, "pool1"), graph, qc, wits, dev, 1, None)
    live, disk = gw.status(), dir_status(os.path.join(out, "pool2"))
    agree = all(
        disk["tenants"][n]["by_status"].get("COMMITTED", 0)
        == live["tenants"][n]["committed"]
        == disk["tenants"][n]["commit_lines"]
        == disk["tenants"][n]["proof_files"]
        and disk["tenants"][n]["journal_steps"] == 0 for n in tenants)
    audits = {n: _verify_dir(t.dir, [0], b"zkdl/train", dev)
              for n, t in tenants.items()}
    ok = (agree and all(a["ok"] for a in audits.values())
          and live["workers"]["respawns"] == 1
          and all(t.stats["proved"] == 1 for t in tenants.values()))
    return {"width": GATEWAY_WIDTH, "pool": 2, "wall_s": wall,
            "prove_s": {n: [p[3] for p in t.proofs]
                        for n, t in tenants.items()},
            "pool1_wall_s": wall1,
            "pool1_prove_s": {n: [p[3] for p in t.proofs]
                              for n, t in tenants1.items()},
            "commit_latency_s": {n: stamps[n][0] - at[n] for n in tenants
                                 if 0 in stamps[n]},
            "respawns": live["workers"]["respawns"],
            "worker_events": live["workers"]["events"],
            "status_agrees_with_dir_status": agree, "audits": audits,
            "launch_counts_note": "approximate: two pool threads bump "
                                  "the wrappers' counters without a lock",
            "_ok": ok}


def _serve_membership(out: str, dev) -> dict:
    """(e): `bind_service_dir` on (a)'s directory, then a membership audit
    of window 0 verified by a fresh verifier process."""
    from repro_torch.audit import membership as mem
    from repro_torch.audit.report import _child_env
    from repro_torch.core.pipeline.proofio import decode_vk

    t0 = time.perf_counter()
    tree, binding = mem.bind_service_dir(out)
    coms = {}
    for w in (0, 1):
        with open(os.path.join(out, f"proof_{w:06d}.bin"), "rb") as f:
            coms[w] = mem.sample_coms(f.read())
    queried = ([mem.com_to_bytes(c) for c in coms[0][:3]]
               + [mem.com_to_bytes(c) for c in coms[1][:2]])
    audit = mem.prove_membership(tree, binding, 0, queried)
    with open(os.path.join(out, "audit_000000.bin"), "wb") as f:
        f.write(audit.to_bytes())
    with open(os.path.join(out, "vk.bin"), "rb") as f:
        merged = decode_vk(f.read(), max_merged_len=1 << 30).cfg.merged_len
    bind_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.audit", "verify-membership",
         "--dir", out, "--window", "0", "--label", "zkdl/train",
         "--device", dev.type, "--max-merged-len", str(merged)],
        capture_output=True, text=True, env=_child_env(), timeout=600)
    fresh_s = time.perf_counter() - t0
    try:
        verdict = json.loads(proc.stdout.strip().splitlines()[-1])
    except (IndexError, json.JSONDecodeError):
        verdict = {"ok": False, "stderr": proc.stderr[-2000:]}
    ok = (proc.returncode == 0 and verdict.get("ok")
          and [r["in_dataset"] for r in verdict["results"]] == [True] * 5
          and [r["in_window"] for r in verdict["results"]]
          == [True] * 3 + [False] * 2
          and binding.n_samples == FULL_BATCH * len(binding.windows)
          and any(ln.get("event") == "DATASET_BINDING"
                  for ln in _manifest_lines(out)))
    return {"windows_bound": len(binding.windows),
            "samples": binding.n_samples, "root": binding.root.hex(),
            "bind_s": bind_s, "fresh_verifier_s": fresh_s,
            "verdict": verdict, "_ok": bool(ok)}


def _manifest_lines(out: str) -> list:
    from repro_torch.launch import serve
    with open(os.path.join(out, serve.MANIFEST)) as f:
        return [json.loads(ln) for ln in f if ln.strip()]


def _serve_trainer(out: str, dev) -> dict:
    """(f): ``python -m repro_torch.launch.train --proof-dir`` (its
    ``main``, in this process so its launches count) at --d-model 256,
    two windows of T = 2."""
    import contextlib
    import io
    from repro_torch.launch import train

    argv = ["--arch", "fcnn-zkdl-16l", "--layers", str(FULL_LAYERS),
            "--d-model", str(TRAIN_D_MODEL), "--global-batch",
            str(TRAIN_BATCH), "--steps", "4", "--prove-window", "2",
            "--proof-dir", out, "--device", dev.type]
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = train.main(argv)
    wall = time.perf_counter() - t0
    log = buf.getvalue().splitlines()
    audit = _verify_dir(out, [0, 1], b"zkdl/train", dev)
    return {"argv": argv, "rc": rc, "wall_s": wall, "log": log[-4:],
            "audit": audit,
            "_ok": rc == 0 and audit["ok"]
            and sum("verified=True" in ln for ln in log) == 2}


def phase_serve(state, width: int) -> dict:
    import shutil

    import torch
    from repro_torch import kernels

    work = os.path.join(OUT_DIR, "serve")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    kernels.reset_launch_counts()
    parts, t = {}, {}
    import gc

    for name, fn in (
            ("a_thread", lambda: _serve_thread(width, os.path.join(
                work, "service"), dev)),
            ("b_restart", lambda: _serve_restart(width, os.path.join(
                work, "service"), dev)),
            ("c_subprocess", lambda: _serve_subprocess(width, os.path.join(
                work, "subprocess"), dev)),
            ("d_gateway", lambda: _serve_gateway(os.path.join(
                work, "gateway"), dev)),
            ("e_membership", lambda: _serve_membership(os.path.join(
                work, "service"), dev)),
            ("f_trainer", lambda: _serve_trainer(os.path.join(
                work, "trainer"), dev))):
        t0 = time.perf_counter()
        parts[name] = fn()
        t[name] = time.perf_counter() - t0
        gc.collect()                  # services and keys of this part
        torch.cuda.empty_cache()
    counts = kernels.launch_counts()
    state["launches_serve"] = counts
    ok = all([p.pop("_ok") for p in parts.values()]) and \
        all(v > 0 for v in counts.values())
    smi = state["smi"]
    a, c = parts["a_thread"], parts["c_subprocess"]
    gb = 1e9
    summary = [
        f"warm {a['warm_s']:.2f} s",
        "submit s per step " + ", ".join(f"{v:.3f}" for v in a["submit_s"])
        + "; journal MB per step " + ", ".join(
            f"{v:.1f}" for v in a["journal_mb"] if v is not None)
        + f" ({a['journal_fs']})",
        "prove s per window " + ", ".join(f"{v:.2f}" for v in a["prove_s"])
        + "; commit latency s " + ", ".join(
            f"{v:.2f}" for v in a["commit_latency_s"]),
        f"child cold start {c['child_cold_start_s']:.2f} s, child peak "
        f"{c['child'].get('max_memory_allocated', 0) / gb:.1f} GB; parent "
        f"peak reserved {c['parent_max_memory_reserved'] / gb:.1f} GB "
        f"(reserved when the child ran "
        f"{c['parent_memory_reserved_before_child'] / gb:.1f} GB)",
        f"restart replayed {parts['b_restart']['replayed']} step(s) in "
        f"{parts['b_restart']['restart_s']:.2f} s",
        f"gateway at width {GATEWAY_WIDTH}: two windows in "
        f"{parts['d_gateway']['wall_s']:.2f} s on a pool of 2, "
        f"{parts['d_gateway']['pool1_wall_s']:.2f} s on a pool of 1",
        "launches " + json.dumps(counts) + " (approximate under the "
        "pool of 2)"]
    for line in summary:
        print(f"serve: {line} [{smi}]", flush=True)
    return {"width": width, "batch": FULL_BATCH, "layers": FULL_LAYERS,
            "reduced": {"layers": [16, FULL_LAYERS]}, "nvidia_smi": smi,
            "seconds_by_part": t, **parts, "launches": counts, "_ok": ok}


def _lm_main(argv, out: str) -> list:
    """`repro_torch.launch.train.main(argv)`; its per-step JSON records."""
    from repro_torch.launch import train

    if os.path.exists(out):
        os.remove(out)
    rc = train.main(argv + ["--metrics-out", out, "--log-every", "4"])
    if rc != 0:
        raise RuntimeError(f"train.main returned {rc}")
    with open(out) as f:
        return [json.loads(line) for line in f]


def _finite(recs) -> bool:
    import math
    return all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])
               for r in recs)


def _lm_full(work: str, dev) -> dict:
    """(a) qwen3-0.6b at full width and depth through the trainer."""
    import math
    import statistics

    import torch
    from repro_torch.configs.registry import get_config

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()      # earlier phases' tensors
    recs = _lm_main(["--arch", LM_ARCH, "--steps", str(LM_STEPS), "--seq",
                     str(LM_SEQ), "--global-batch", str(LM_BATCH)],
                    os.path.join(work, "full.jsonl"))
    cfg = get_config(LM_ARCH)
    tokens = LM_SEQ * LM_BATCH
    step_s = statistics.median(r["seconds"] for r in recs[1:])
    flops = 6 * cfg.param_count() * tokens
    first = recs[0]["loss"]
    ok = (len(recs) == LM_STEPS and _finite(recs)
          and abs(first - math.log(cfg.vocab)) < 0.5)
    return {"layers": cfg.n_layers, "d_model": cfg.d_model,
            "params": cfg.param_count(), "losses": [r["loss"] for r in recs],
            "grad_norms": [r["grad_norm"] for r in recs],
            "step_s": [r["seconds"] for r in recs],
            "median_step_s_after_0": step_s, "tokens_per_s": tokens / step_s,
            "peak_gb": (torch.cuda.max_memory_allocated() - held) / 1e9,
            "held_before_gb": held / 1e9,
            "model_flops_per_step": flops,
            "model_flop_share": flops / step_s / BF16_DENSE_FLOPS_PER_S,
            "_ok": ok}


def _lm_profile(dev) -> dict:
    """One train step of (a)'s geometry under torch.profiler, after one
    warm-up step: device time by kernel and the card's busy share."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.launch import steps, train
    from torch.profiler import ProfilerActivity, profile as tprofile

    cfg = get_config(LM_ARCH)
    opt_cfg = steps.default_opt_cfg(cfg)
    state, _ = train.build_state(cfg, opt_cfg, device=dev)
    step = steps.build_train_step(cfg, opt_cfg)
    source = SyntheticTokens(cfg, LM_SEQ, LM_BATCH)
    batches = [{k: torch.as_tensor(v, device=dev)
                for k, v in source.batch(i).items()} for i in range(2)]
    state, m = step(state, batches[0])
    float(m["loss"])
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, m = step(state, batches[1])
        float(m["loss"])
        wall = time.perf_counter() - t0
    return _device_profile(prof, wall)


def _lm_restart(work: str) -> dict:
    """(b) a --fail-at run resumes at its checkpoint with the
    uninterrupted run's losses, bit for bit (deterministic algorithms)."""
    import shutil

    import torch

    ckpt = os.path.join(work, "ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    argv = ["--arch", LM_ARCH, "--layers", "2", "--steps", "8", "--seq",
            str(LM_SEQ), "--global-batch", str(LM_BATCH), "--compress",
            "int8"]
    torch.use_deterministic_algorithms(True)
    try:
        plain = _lm_main(argv, os.path.join(work, "plain.jsonl"))
        failed = _lm_main(argv + ["--ckpt-dir", ckpt, "--ckpt-every", "3",
                                  "--fail-at", "5"],
                          os.path.join(work, "failed.jsonl"))
    finally:
        torch.use_deterministic_algorithms(False)
    steps = [r["step"] for r in failed]
    resumed_at = next((b for a, b in zip(steps, steps[1:]) if b <= a), None)
    after = {r["step"]: r["loss"] for r in failed}      # the last of each
    saves = [(r["step"], r["ckpt_seconds"], r["ckpt_bytes"])
             for r in failed if "ckpt_bytes" in r]
    equal = all(after[s] == plain[s]["loss"] for s in (5, 6, 7))
    shutil.rmtree(ckpt, ignore_errors=True)
    return {"steps_run": steps, "resumed_at": resumed_at,
            "losses_plain": [r["loss"] for r in plain],
            "losses_resumed": [after[s] for s in range(8)],
            "bit_equal_5_to_7": equal, "saves": saves,
            "fs": _fs_type(work),
            "_ok": resumed_at == 4 and equal and _finite(failed)}


def _float32_exact():
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _rel_err(got, want) -> float:
    want = want.detach().float().cpu()
    err = (got.detach().float().cpu() - want).abs().max()
    return float(err / want.abs().max().clamp(min=1e-30))


def _lm_card_vs_cpu(dev) -> dict:
    """(c) three AdamW steps at width 1024, depth 2, float32, from one
    init on the card and on the CPU."""
    import dataclasses

    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.launch import steps, train
    from repro_torch.tree import tree_leaves, tree_map

    cfg = dataclasses.replace(get_config(LM_ARCH), n_layers=2,
                              dtype="float32")
    opt_cfg = steps.default_opt_cfg(cfg)
    state, _ = train.build_state(cfg, opt_cfg, device="cpu")
    card = tree_map(lambda t: t.to(dev), state)
    step = steps.build_train_step(cfg, opt_cfg)
    source = SyntheticTokens(cfg, 64, 2)
    losses = {"cpu": [], "card": []}
    t0 = time.perf_counter()
    for i in range(3):
        batch = {k: torch.as_tensor(v) for k, v in source.batch(i).items()}
        state, m = step(state, batch)
        losses["cpu"].append(float(m["loss"]))
        card, m = step(card, {k: v.to(dev) for k, v in batch.items()})
        losses["card"].append(float(m["loss"]))
    err = max(float((a.cpu() - b).abs().max()) for a, b in zip(
        tree_leaves(card["params"]), tree_leaves(state["params"])))
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses["card"],
                                                   losses["cpu"]))
    # each AdamW step moves a weight by at most about lr (<= 9e-6 here,
    # in warm-up): a direction flipped by rounding moves it by 2 lr
    return {"losses": losses, "loss_max_rel": rel,
            "params_max_abs_err": err, "params_tol": 2e-5,
            "seconds": time.perf_counter() - t0,
            "_ok": rel <= 1e-4 and err <= 2e-5}


def _lm_archs(dev) -> dict:
    """(d) every LM arch's smoke config: finite forward, grad and decode
    step on the card, and the float32 run against the CPU's."""
    import dataclasses

    import torch
    from repro_torch.configs.registry import ARCHS, smoke_config
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tt
    from repro_torch.tree import tree_leaves, tree_map

    out, ok = {}, True
    for arch in ARCHS:
        if arch == "fcnn_zkdl_16l":
            continue
        rec = {}
        for dtype in ("float32", "bfloat16"):
            cfg = dataclasses.replace(smoke_config(arch), dtype=dtype)
            params = tt.init_params(cfg, torch.Generator().manual_seed(0))
            batch = {k: torch.as_tensor(v) for k, v in SyntheticTokens(
                cfg, 32, 2, seed=1).batch(0).items()}
            on = {"cpu": (params, batch, "cpu"),
                  "card": (tree_map(lambda t: t.to(dev), params),
                           {k: v.to(dev) for k, v in batch.items()}, dev)}
            res = {}
            for where, (p, b, d) in on.items():
                if dtype == "bfloat16" and where == "cpu":
                    continue
                with torch.no_grad():
                    logits, _ = tt.forward(cfg, p, b)
                loss, grads = steps.value_and_grad(cfg, p, b)
                cache = tt.make_cache(cfg, 2, 32, d)
                if cfg.family == "encdec":
                    tok = b["tokens"][:, 0]
                elif cfg.family == "vlm":
                    tok = b["embeds"][:, :1]
                else:
                    tok = b["tokens"][:, 0]
                pos3 = (b["positions3"][:, :, :1] if cfg.family == "vlm"
                        else None)
                with torch.no_grad():
                    dec, _ = tt.decode_step(cfg, p, cache, tok, 0,
                                            positions3=pos3)
                res[where] = (logits, loss, grads, dec)
            lg, loss, grads, dec = res["card"]
            finite = (bool(torch.isfinite(lg.float()).all())
                      and bool(torch.isfinite(loss))
                      and all(bool(torch.isfinite(g.float()).all())
                              for g in tree_leaves(grads))
                      and bool(torch.isfinite(dec.float()).all()))
            rec[f"{dtype}_finite"] = finite
            ok &= finite
            if dtype == "float32":
                c = res["cpu"]
                rec["logits_rel"] = _rel_err(lg, c[0])
                rec["loss_rel"] = abs(float(loss) - float(c[1])) / float(c[1])
                rec["grad_rel"] = max(_rel_err(g, h) for g, h in zip(
                    tree_leaves(grads), tree_leaves(c[2])))
                rec["decode_rel"] = _rel_err(dec, c[3])
                ok &= (rec["logits_rel"] <= 1e-4 and rec["loss_rel"] <= 1e-5
                       and rec["grad_rel"] <= 1e-3
                       and rec["decode_rel"] <= 1e-4)
        out[arch] = rec
    return {"archs": out, "tolerance": {"logits_rel": 1e-4, "loss_rel": 1e-5,
                                        "grad_rel": 1e-3, "decode_rel": 1e-4},
            "_ok": ok}


def _lm_serve(dev, params) -> dict:
    """(e) prefill 256 tokens at full qwen3-0.6b, then 8 greedy decode
    steps, each against a full forward over the extended sequence, in
    two legs on one token chain (the float32 leg's greedy tokens).

    float32 (full matmul precision): |decode - full| <= 1e-4 of
    max|full| at every step, greedy tokens equal.  bfloat16: the
    tolerance is measured, not assumed: each step's float32 forward
    gives the bf16 full forward's own rounding error, and the decode
    step (a bf16 cache, one query row, other matmul shapes) must stay
    within three times it of the bf16 full forward; greedy tokens equal
    unless the full forward's top two logits lie within twice the
    decode error.  A planted fault shows what each leg can see: at step
    0 the same decode at position + 1 (the key written one slot late,
    every rotation one step off) must fail the float32 tolerance; its
    distance from the bf16 band is recorded."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tt

    _float32_exact()
    cfgs = {"f32": dataclasses.replace(get_config(LM_ARCH), dtype="float32"),
            "bf16": get_config(LM_ARCH)}
    n_prompt, n_new = 256, 8
    prompt = torch.as_tensor(np.random.default_rng(6).integers(
        0, cfgs["bf16"].vocab, (1, n_prompt)), dtype=torch.int32, device=dev)
    legs = {}
    for leg, cfg in cfgs.items():
        t0 = time.perf_counter()
        last, (k, v) = steps.build_prefill_step(cfg)(params,
                                                     {"tokens": prompt})
        torch.cuda.synchronize()
        cache = tt.make_cache(cfg, 1, n_prompt + n_new, dev)
        cache["k"][:, :, :n_prompt] = k
        cache["v"][:, :, :n_prompt] = v
        legs[leg] = {"cfg": cfg, "decode": steps.build_decode_step(cfg),
                     "cache": cache, "last": last,
                     "prefill_s": time.perf_counter() - t0,
                     "decode_vs_full": [], "max_abs_full": [],
                     "greedy_agrees": [], "top2_margin": [], "decode_s": []}
    tokens = prompt
    nxt = legs["f32"]["last"].argmax(-1).to(torch.int32)
    bf16_own_err = []
    for i in range(n_new):
        tokens = torch.cat([tokens, nxt[:, None]], dim=1)
        pos = n_prompt + i
        full = {}
        for leg, r in legs.items():
            if i == 0:
                wrong, _ = r["decode"](params, r["cache"], nxt, pos + 1)
            t0 = time.perf_counter()
            logits, r["cache"] = r["decode"](params, r["cache"], nxt, pos)
            torch.cuda.synchronize()
            r["decode_s"].append(time.perf_counter() - t0)
            with torch.no_grad():
                f, _ = tt.forward(r["cfg"], params, {"tokens": tokens},
                                  head_last_only=True)
            f = full[leg] = f[:, -1].float()
            logits = r["last"] = logits.float()
            top2 = f.topk(2, dim=-1).values
            r["decode_vs_full"].append(float((logits - f).abs().max()))
            r["max_abs_full"].append(float(f.abs().max()))
            r["top2_margin"].append(float((top2[:, 0] - top2[:, 1]).min()))
            r["greedy_agrees"].append(bool(
                (logits.argmax(-1) == f.argmax(-1)).all()))
            if i == 0:
                r["planted_pos_plus_1_vs_full"] = float(
                    (wrong.float() - f).abs().max())
        bf16_own_err.append(float((full["bf16"] - full["f32"]).abs().max()))
        nxt = legs["f32"]["last"].argmax(-1).to(torch.int32)
    f32, bf16 = legs["f32"], legs["bf16"]
    f32["tolerance"] = [1e-4 * m for m in f32["max_abs_full"]]
    bf16["full_bf16_vs_f32"] = bf16_own_err
    bf16["tolerance"] = [3 * e for e in bf16_own_err]

    def greedy_ok(r):
        return all(a or m <= 2 * d for a, m, d in zip(
            r["greedy_agrees"], r["top2_margin"], r["decode_vs_full"]))

    ok = (all(d <= t for d, t in zip(f32["decode_vs_full"],
                                     f32["tolerance"]))
          and all(d <= t for d, t in zip(bf16["decode_vs_full"],
                                         bf16["tolerance"]))
          and greedy_ok(f32) and greedy_ok(bf16)
          and f32["planted_pos_plus_1_vs_full"] > f32["tolerance"][0])
    for r in legs.values():
        for key in ("cfg", "decode", "cache", "last"):
            r.pop(key)
    return {"prompt": n_prompt, "new_tokens": n_new,
            "tolerance": {"f32": "max|decode - full| <= 1e-4 max|full|",
                          "bf16": "max|decode - full| <= 3 max|full - f32|",
                          "greedy": "argmax equal unless the top-2 margin "
                                    "<= 2 max|decode - full|"},
            "planted_fault_caught": {
                "f32": f32["planted_pos_plus_1_vs_full"]
                > f32["tolerance"][0],
                "bf16": bf16["planted_pos_plus_1_vs_full"]
                > bf16["tolerance"][0]},
            "f32": f32, "bf16": bf16, "_ok": ok}


def _lm_blockwise(dev, params) -> dict:
    """(f) blockwise attention against dense `attention` math on one
    layer's q/k/v at S = 4096 in float32; then one forward and backward
    pass of the full config at seq 4096, batch 1."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import steps
    from repro_torch.models import attention as am
    from repro_torch.models import transformer as tt
    from repro_torch.models.blockwise import blockwise_attention
    from repro_torch.models.layers import apply_rope, rms_norm
    from repro_torch.tree import tree_leaves, tree_map

    import numpy as np

    cfg = get_config(LM_ARCH)
    s = 4096
    assert s > tt.DENSE_ATTN_MAX_SEQ
    tokens = torch.as_tensor(np.random.default_rng(7).integers(
        0, cfg.vocab, (1, s)), dtype=torch.int32, device=dev)
    blk = tree_map(lambda a: a[0], params["blocks"])
    a = blk["attn"]
    with torch.no_grad():
        x = rms_norm(params["embed"][tokens.long()], blk["ln1"])
        pos = torch.arange(s, device=dev)[None]
        q = rms_norm((x @ a["wq"]).reshape(1, s, cfg.n_heads, cfg.head_dim),
                     a["q_norm"])
        k = rms_norm((x @ a["wk"]).reshape(1, s, cfg.n_kv_heads,
                                           cfg.head_dim), a["k_norm"])
        v = (x @ a["wv"]).reshape(1, s, cfg.n_kv_heads, cfg.head_dim)
        q, k = apply_rope(q, pos, cfg.rope_theta), apply_rope(
            k, pos, cfg.rope_theta)
        blockwise = blockwise_attention(q, k, v, causal=True)
        scores = am._gqa_scores(q, k, cfg)
        mask = torch.tril(torch.ones((s, s), dtype=torch.bool, device=dev))
        scores = torch.where(mask[None, None, None], scores, am.NEG_INF)
        dense = am._gqa_out(torch.softmax(scores, -1), v).reshape(
            blockwise.shape)
        err = float((blockwise - dense).abs().max())
        del scores, mask, dense
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    loss, grads = steps.value_and_grad(cfg, params, {"tokens": tokens,
                                                     "labels": tokens})
    finite = bool(torch.isfinite(loss)) and all(
        bool(torch.isfinite(g).all()) for g in tree_leaves(grads))
    torch.cuda.synchronize()
    return {"seq": s, "max_abs_err_vs_dense": err, "tolerance": 1e-4,
            "fwd_bwd_s": time.perf_counter() - t0, "loss": float(loss),
            "fwd_bwd_peak_gb": (torch.cuda.max_memory_allocated() - held)
            / 1e9,
            "_ok": err < 1e-4 and finite}


def phase_lm(state, profile: bool = False) -> dict:
    """The LM trainer and model zoo on the card (see the docstring)."""
    import gc
    import shutil

    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer as tt

    work = os.path.join(OUT_DIR, "lm")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    dev = torch.device("cuda")
    parts, t = {}, {}
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    runs = (("a_full", lambda: _lm_full(work, dev)),
            ("b_restart", lambda: _lm_restart(work)),
            ("c_card_vs_cpu", lambda: _lm_card_vs_cpu(dev)),
            ("d_archs", lambda: _lm_archs(dev)),
            ("e_serve", lambda: _lm_serve(dev, params)),
            ("f_blockwise", lambda: _lm_blockwise(dev, params)))
    if profile:
        runs += (("profile", lambda: _lm_profile(dev)),)
    params = None
    matmul_tf32 = torch.backends.cuda.matmul.allow_tf32
    try:
        for name, fn in runs:
            if name == "c_card_vs_cpu":
                _float32_exact()
            if name == "e_serve":
                params = tt.init_params(get_config(LM_ARCH), gen)
            t0 = time.perf_counter()
            parts[name] = fn()
            t[name] = time.perf_counter() - t0
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul_tf32
    ok = all([p.pop("_ok", True) for p in parts.values()])
    smi = state["smi"]
    a, b, e = parts["a_full"], parts["b_restart"], parts["e_serve"]
    state["lm_a"] = a
    e32, e16 = e["f32"], e["bf16"]
    for line in (
            f"qwen3-0.6b {a['layers']} layers x {a['d_model']}, seq "
            f"{LM_SEQ}, batch {LM_BATCH}: median step "
            f"{a['median_step_s_after_0']:.4f} s after step 0, "
            f"{a['tokens_per_s']:.0f} tokens/s, peak {a['peak_gb']:.2f} GB "
            f"above the {a['held_before_gb']:.2f} GB held before, "
            f"model FLOP share {a['model_flop_share']:.4f} of bf16 dense; "
            f"first loss {a['losses'][0]:.4f}",
            f"restart: resumed at step {b['resumed_at']}, steps 5-7 "
            f"bit-equal {b['bit_equal_5_to_7']}; checkpoint saves "
            + ", ".join(f"step {s}: {n / 1e6:.0f} MB in {sec:.2f} s"
                        for s, sec, n in b["saves"]) + f" ({b['fs']})",
            f"decode: float32 max|decode - full| "
            f"{max(e32['decode_vs_full']):.3g} (tolerance from "
            f"{min(e32['tolerance']):.3g}), bf16 "
            f"{max(e16['decode_vs_full']):.3g} (band from "
            f"{min(e16['tolerance']):.3g}); planted position + 1: float32 "
            f"{e32['planted_pos_plus_1_vs_full']:.3g}, bf16 "
            f"{e16['planted_pos_plus_1_vs_full']:.3g} against the step-0 "
            f"band {e16['tolerance'][0]:.3g}; greedy agrees "
            f"{e32['greedy_agrees'].count(True)}/{len(e32['greedy_agrees'])}"
            f" (f32), {e16['greedy_agrees'].count(True)}/"
            f"{len(e16['greedy_agrees'])} (bf16)"):
        print(f"lm: {line} [{smi}]", flush=True)
    return {"arch": LM_ARCH, "seq": LM_SEQ, "batch": LM_BATCH,
            "nvidia_smi": smi, "seconds_by_part": t, **parts, "_ok": ok}


# phase mesh (c): one train_4k cell per family on the 16x16 dry-run mesh
MESH_FAMILY_ARCHS = {"dense": "qwen3-0.6b", "moe": "deepseek-v2-lite-16b",
                     "ssm": "mamba2-2.7b", "hybrid": "zamba2-2.7b",
                     "encdec": "seamless-m4t-medium", "vlm": "qwen2-vl-2b"}
# (b): the dry run's live bytes against the card's peak, within this factor
MESH_LIVE_FACTOR = 1.5

_MESH_LOWER = r"""
import json, sys
from repro_torch.configs.registry import get_config
from repro_torch.launch import dryrun, mesh, steps
dryrun.init_fake_world(1)
cell = steps.lower_train(get_config(sys.argv[1]),
                         mesh.make_mesh((1, 1), ("data", "model")),
                         int(sys.argv[2]), int(sys.argv[3]))
print("RECORD " + json.dumps(dryrun.analyze_compiled(cell.compile(), 1)))
"""


def _mesh_train(work: str) -> dict:
    """(a) phase lm (a)'s run, plain and then with --mesh 1x1."""
    import gc
    import statistics

    import torch

    argv = ["--arch", LM_ARCH, "--steps", str(LM_STEPS), "--seq",
            str(LM_SEQ), "--global-batch", str(LM_BATCH)]
    out = {}
    for name, extra in (("plain", []), ("mesh_1x1", ["--mesh", "1x1"])):
        gc.collect()                    # the last run's state, if cyclic
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        recs = _lm_main(argv + extra, os.path.join(work, name + ".jsonl"))
        out[name] = {
            "losses": [r["loss"] for r in recs],
            "grad_norms": [r["grad_norm"] for r in recs],
            "median_step_s_after_0": statistics.median(
                r["seconds"] for r in recs[1:]),
            "peak_bytes": torch.cuda.max_memory_allocated() - held,
            "held_before_bytes": held,
            "state_bytes": recs[0]["state_bytes"], "_finite": _finite(recs)}
    plain, mesh = out["plain"], out["mesh_1x1"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(mesh["losses"],
                                                   plain["losses"]))
    return {**out, "loss_max_rel": rel,
            "bit_equal": mesh["losses"] == plain["losses"],
            "_ok": (len(mesh["losses"]) == LM_STEPS and rel <= 1e-6
                    and plain.pop("_finite") and mesh.pop("_finite"))}


def _subprocess(argv, timeout: int) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.run(argv, capture_output=True, text=True,
                          timeout=timeout, env=env, cwd=ROOT)


def _mesh_lower(a: dict) -> dict:
    """(b) `steps.lower_train` of (a)'s cell on a 1x1 fake mesh against
    what (a) held on the card."""
    res = _subprocess([sys.executable, "-c", _MESH_LOWER, LM_ARCH,
                       str(LM_SEQ), str(LM_BATCH)], 600)
    lines = [ln for ln in res.stdout.splitlines() if ln.startswith("RECORD ")]
    if res.returncode != 0 or not lines:
        return {"stderr": res.stderr[-3000:], "_ok": False}
    rec = json.loads(lines[-1][len("RECORD "):])
    batch_bytes = 2 * LM_BATCH * LM_SEQ * 4          # int32 tokens, labels
    want_args = a["mesh_1x1"]["state_bytes"] + batch_bytes
    args = rec["memory"]["argument_size_in_bytes"]
    live, peak = rec["per_device_live_bytes"], a["mesh_1x1"]["peak_bytes"]
    ratio = live / peak
    return {"argument_bytes": args, "card_argument_bytes": want_args,
            "live_bytes": live, "card_peak_bytes": peak,
            "live_over_peak": ratio, "flops": rec["per_device_flops"],
            "collective_bytes": rec["per_device_collective_bytes"],
            "_ok": (args == want_args
                    and 1 / MESH_LIVE_FACTOR <= ratio <= MESH_LIVE_FACTOR)}


def _mesh_dryrun(work: str) -> dict:
    """(c) `python -m repro_torch.launch.dryrun` on 16x16, one train_4k
    cell per family, the six in parallel processes."""
    procs = {}
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    for fam, arch in MESH_FAMILY_ARCHS.items():
        procs[fam] = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", "train_4k", "--out",
             os.path.join(work, "dryrun")], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, env=env, cwd=ROOT)
    cells, ok = {}, True
    for fam, proc in procs.items():
        try:
            _, err = proc.communicate(timeout=900)
        except subprocess.TimeoutExpired:
            proc.kill()
            _, err = proc.communicate()
        path = os.path.join(work, "dryrun", f"{MESH_FAMILY_ARCHS[fam]}"
                            "__train_4k__16_16.json")
        rec = {}
        if os.path.exists(path):
            with open(path) as f:
                rec = json.load(f)
        cells[fam] = {k: rec.get(k) for k in (
            "arch", "status", "error", "per_device_flops",
            "per_device_collective_bytes", "per_device_live_bytes",
            "compile_s")}
        cells[fam]["memory"] = rec.get("memory")
        if rec.get("status") != "ok" or proc.returncode != 0:
            cells[fam]["stderr"] = err[-2000:]
            ok = False
    return {"cells": cells, "_ok": ok}


def _mesh_moe(dev) -> dict:
    """(d) the forward of both moe smoke configs on a 1x1 DeviceMesh
    (DTensors, the MoE local_map path) against the plain forward."""
    import dataclasses

    import torch
    import torch.distributed as dist
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs.registry import ARCHS, get_config, smoke_config
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.distributed import hints, sharding
    from repro_torch.launch import steps, train
    from repro_torch.models import transformer as tt

    out, ok = {}, True
    mesh, _, started = train.start_mesh("1x1", dev)
    try:
        for arch in ARCHS:
            if get_config(arch).family != "moe":
                continue
            cfg = dataclasses.replace(smoke_config(arch), dtype="float32")
            params = tt.init_params(
                cfg, torch.Generator(device=dev).manual_seed(0))
            batch = {k: torch.as_tensor(v, device=dev) for k, v in
                     SyntheticTokens(cfg, 32, 2, seed=1).batch(0).items()}
            with torch.no_grad():
                plain, _ = tt.forward(cfg, params, batch)
                steps.set_mesh_hints(mesh)
                dp = steps.place(params, sharding.param_shardings(
                    cfg, mesh, params))
                db = steps.place(batch, sharding.batch_shardings(
                    cfg, mesh, batch))
                with implicit_replication():
                    got, _ = tt.forward(cfg, dp, db)
                hints.clear()
            got = got.full_tensor()
            rel = _rel_err(got, plain)
            out[arch] = {"max_rel": rel, "bit_equal": bool(
                torch.equal(got, plain))}
            ok &= rel <= 1e-6
    finally:
        hints.clear()
        if started:
            dist.destroy_process_group()
    return {"archs": out, "tolerance": 1e-6, "_ok": ok}


def phase_mesh(state) -> dict:
    """The mesh code on the card (see the docstring)."""
    import shutil

    import torch

    work = os.path.join(OUT_DIR, "mesh")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    dev = torch.device("cuda")
    parts, t = {}, {}
    for name, fn in (("a_train", lambda: _mesh_train(work)),
                     ("b_lower", lambda: _mesh_lower(parts["a_train"])),
                     ("c_dryrun", lambda: _mesh_dryrun(work)),
                     ("d_moe", lambda: _mesh_moe(dev))):
        t0 = time.perf_counter()
        try:
            parts[name] = fn()
        except Exception:                    # report, then fail the phase
            parts[name] = {"error": traceback.format_exc(), "_ok": False}
        t[name] = time.perf_counter() - t0
    ok = all([p.pop("_ok", True) for p in parts.values()])
    smi = state["smi"]
    a, b = parts["a_train"], parts["b_lower"]
    lm_a = state.get("lm_a", {})
    if "plain" in a:
        print(f"mesh: qwen3-0.6b {LM_SEQ} x {LM_BATCH}, --mesh 1x1 losses "
              f"within {a['loss_max_rel']:.3g} of the plain path's, bit "
              f"for bit {a['bit_equal']}; median step "
              f"{a['mesh_1x1']['median_step_s_after_0']:.4f} s (DTensor) "
              f"against {a['plain']['median_step_s_after_0']:.4f} s (plain; "
              f"phase lm (a) "
              f"{lm_a.get('median_step_s_after_0', float('nan')):.4f} s); "
              f"peak {a['mesh_1x1']['peak_bytes'] / 1e9:.2f} GB (plain "
              f"{a['plain']['peak_bytes'] / 1e9:.2f} GB) [{smi}]", flush=True)
    if "live_bytes" in b:
        print(f"mesh: dry run of that cell on a 1x1 fake mesh: argument "
              f"bytes {b['argument_bytes']} (card {b['card_argument_bytes']}"
              f"), live {b['live_bytes'] / 1e9:.2f} GB against the card's "
              f"peak {b['card_peak_bytes'] / 1e9:.2f} GB "
              f"({b['live_over_peak']:.3f}x) [{smi}]", flush=True)
    return {"nvidia_smi": smi, "seconds_by_part": t, **parts, "_ok": ok}


KERNEL_META = {
    "modmul": ("src/repro_torch/kernels/modmul/modmul.cu",
               "src/repro/kernels/modmul/kernel.py:50"),
    "fold": ("src/repro_torch/kernels/sumcheck_fold/sumcheck_fold.cu",
             "src/repro/kernels/sumcheck_fold/kernel.py:169"),
    "fold_halves": ("src/repro_torch/kernels/sumcheck_fold/sumcheck_fold.cu",
                    "src/repro/kernels/sumcheck_fold/kernel.py:74"),
    "validity_tables": (
        "src/repro_torch/kernels/validity_tables/validity_tables.cu",
        "src/repro/kernels/validity_tables/kernel.py:106"),
    "generators": ("src/repro_torch/kernels/generators/generators.cu",
                   "none (host loop src/repro/core/group.py:381)"),
    "pow_mul": ("src/repro_torch/kernels/sumcheck_fold/sumcheck_fold.cu",
                "src/repro/kernels/sumcheck_fold/kernel.py:144"),
    "qmatmul": ("src/repro_torch/kernels/qmatmul/qmatmul.cu",
                "src/repro/kernels/qmatmul/kernel.py:93"),
    "msm": ("src/repro_torch/kernels/msm/msm.cu",
            "none (the reference's MSM is jnp code, src/repro/core/group.py)"),
}


def kernel_line(state) -> dict:
    rows = []
    for name, (src, replaces) in KERNEL_META.items():
        kb = state["kernel_bench"][name]
        b_ms, b_by = bound_ms(kb["bytes"], kb["ops"],
                              kb.get("ops_per_s", INT32_OPS_PER_S))
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces,
                     "launches": state.get("launches", {}).get(name, 0),
                     "launches_train": state.get("launches_train",
                                                 {}).get(name, 0),
                     "launches_audit": state.get("launches_audit",
                                                 {}).get(name, 0),
                     "launches_serve": state.get("launches_serve",
                                                 {}).get(name, 0),
                     "max_abs_err": kb["max_abs_err"], "ms": kb["ms"],
                     "plain_ms": kb["plain_ms"], "bound_ms": b_ms,
                     "bound_by": b_by,
                     "library_ms": kb.get("library_ms"), "n": kb["n"]})
    return {"kernels": rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--width", type=int, default=4096)
    ap.add_argument("--phases",
                    default="build,kernels,golden,full,train,open,audit,"
                            "serve,lm,mesh")
    ap.add_argument("--profile", action="store_true",
                    help="trace the second full-width prove (phase "
                         "full) and one LM train step (phase lm) with "
                         "torch.profiler")
    args = ap.parse_args(argv)

    # deterministic cuBLAS for phase lm's restart (set before any handle)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs on a GPU only", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    try:
        import repro_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: cannot import repro_torch from {ROOT}/src "
              f"({exc}); run from a checkout of the repository",
              file=sys.stderr)
        return 2

    phases = args.phases.split(",")
    state = {"smi": nvidia_smi()}
    runners = {
        "build": lambda: phase_build(state),
        "kernels": lambda: phase_kernels(state),
        "golden": lambda: phase_golden(state),
        "full": lambda: phase_full(state, args.width, args.profile),
        "train": lambda: phase_train(state, args.width),
        "open": lambda: phase_open(state),
        "audit": lambda: phase_audit(state, args.width),
        "serve": lambda: phase_serve(state, args.width),
        "lm": lambda: phase_lm(state, args.profile),
        "mesh": lambda: phase_mesh(state),
    }
    failed, record = [], {}
    for name in phases:
        t0 = time.perf_counter()
        try:
            out = runners[name]()
            ok = out.pop("_ok", True)
        except Exception:                       # report, then fail the run
            out, ok = {"error": traceback.format_exc()}, False
        out = {"phase": name, "ok": ok,
               "seconds": time.perf_counter() - t0, **out}
        record[name] = out
        emit(out)
        if not ok:
            failed.append(name)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(record, f, indent=1, default=str)
    if failed:
        print(f"chip_smoke: phases failed: {failed}", file=sys.stderr)
        return 1
    if "kernels" in phases:
        emit(kernel_line(state))
    print(state["smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
