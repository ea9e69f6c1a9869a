"""Port configs and data pipeline against the reference.

Every field of every architecture's config and smoke config, every
alias, and the parameter counts are compared with
`repro.configs.registry`; `SyntheticTokens` and `BinTokenFile` batches
must be equal arrays for every family (exact: both sides are numpy)."""
import dataclasses

import numpy as np
import pytest

from repro.configs import registry as rreg
from repro.data import pipeline as rpipe
from repro_torch.configs import registry as treg
from repro_torch.data import pipeline as tpipe

FAMILY_ARCHS = {"dense": "qwen3_0p6b", "moe": "deepseek_v2_lite_16b",
                "ssm": "mamba2_2p7b", "hybrid": "zamba2_2p7b",
                "encdec": "seamless_m4t_medium", "vlm": "qwen2_vl_2b"}


#: fields the port's ModelConfig adds to the reference's, with the
#: default every reference architecture keeps
PORT_FIELDS = {"widths": ()}


def _fields(cfg):
    out = dataclasses.asdict(cfg)
    for name, default in PORT_FIELDS.items():
        if name in out:
            assert out.pop(name) == default, (cfg.name, name)
    return out


@pytest.mark.parametrize("arch", rreg.ARCHS)
def test_config_fields_and_counts_match_reference(arch):
    for getter in ("get_config", "smoke_config"):
        ref = getattr(rreg, getter)(arch)
        got = getattr(treg, getter)(arch)
        assert _fields(got) == _fields(ref), (arch, getter)
        assert got.param_count() == ref.param_count()
        assert got.active_param_count() == ref.active_param_count()
        assert (got.d_inner, got.ssm_nheads, got.is_moe) == \
            (ref.d_inner, ref.ssm_nheads, ref.is_moe)


def test_archs_and_aliases_match_reference():
    assert treg.ARCHS == rreg.ARCHS
    assert treg._ALIASES == rreg._ALIASES
    for alias in rreg._ALIASES:
        assert _fields(treg.get_config(alias)) == \
            _fields(rreg.get_config(alias))
    got = treg.get_config("qwen3-0.6b", n_layers=2, dtype="float32")
    ref = rreg.get_config("qwen3-0.6b", n_layers=2, dtype="float32")
    assert _fields(got) == _fields(ref)
    with pytest.raises(LookupError, match="unknown architecture"):
        treg.get_config("no-such-arch")


@pytest.mark.parametrize("family", sorted(FAMILY_ARCHS))
def test_synthetic_batches_match_reference(family):
    arch = FAMILY_ARCHS[family]
    for getter in ("smoke_config", "get_config"):
        rcfg = getattr(rreg, getter)(arch)
        tcfg = getattr(treg, getter)(arch)
        seq, batch = (32, 2) if getter == "smoke_config" else (16, 1)
        ref = rpipe.make_source(rcfg, seq, batch, seed=5)
        got = tpipe.make_source(tcfg, seq, batch, seed=5)
        assert isinstance(got, tpipe.SyntheticTokens)
        for step in (0, 1, 7):
            rb, tb = ref.batch(step), got.batch(step)
            assert sorted(rb) == sorted(tb)
            for k in rb:
                assert rb[k].dtype == tb[k].dtype, (family, k)
                np.testing.assert_array_equal(tb[k], rb[k])


@pytest.mark.parametrize("dtype", ["uint16", "uint32"])
def test_bin_token_file_batches_match_reference(tmp_path, dtype):
    rng = np.random.default_rng(11)
    path = str(tmp_path / "tokens.bin")
    rng.integers(0, 60000, 3 * 2 * 33 + 5).astype(dtype).tofile(path)
    rcfg, tcfg = (rreg.smoke_config("qwen3_0p6b"),
                  treg.smoke_config("qwen3_0p6b"))
    ref = rpipe.BinTokenFile(path, rcfg, 32, 2, dtype=dtype)
    got = tpipe.BinTokenFile(path, tcfg, 32, 2, dtype=dtype)
    assert got.n_steps == ref.n_steps == 3
    for step in range(5):                   # wraps past n_steps
        rb, tb = ref.batch(step), got.batch(step)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(tb[k], rb[k])
    assert isinstance(tpipe.make_source(tcfg, 32, 2, path=path),
                      tpipe.BinTokenFile)
