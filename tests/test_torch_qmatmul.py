"""The port's exact int16 matmul (`repro_torch.kernels.qmatmul`) and the
witness products built on it (`quantfc.exact_matmul`) against the
reference.

On the CPU `qmatmul_i64` runs its plain version: the reference's digit
split, K padding, digit products, row / column sums and assembly, kept in
int64.  The operand checks and the reading of ``.T`` views are the same
code the card runs.  Every comparison is exact (tolerance 0).  The fused
CUDA kernel is held against the plain version in tests/test_torch_gpu.py
(marker ``gpu``) and in `chip_smoke.py`."""
import numpy as np
import pytest
import torch

from repro.kernels.qmatmul import qmatmul_partials as r_partials
from repro.kernels.qmatmul.ref import qmatmul_ref

from repro_torch.core.quantfc import exact_matmul
from repro_torch.kernels.qmatmul import K_MAX, qmatmul_i64, qmatmul_partials

LIM = 1 << 15


def _int16(rng, shape, lo=-LIM, hi=LIM):
    x = rng.integers(lo, hi, shape)
    x.flat[:2] = [lo, hi - 1]                  # the range edges
    return x


@pytest.mark.parametrize("m,k,n", [(1, 1, 1), (3, 5, 7), (17, 100, 9),
                                   (33, 64, 31), (2, 129, 40)])
def test_qmatmul_i64_matches_reference_oracle(m, k, n):
    rng = np.random.default_rng(m * 1000 + k * 10 + n)
    a, b = _int16(rng, (m, k)), _int16(rng, (k, n))
    got = qmatmul_i64(torch.as_tensor(a).to(torch.int16),
                      torch.as_tensor(b).to(torch.int16))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), qmatmul_ref(a, b))


@pytest.mark.parametrize("layout", ["a_T", "b_T", "both_T"])
def test_qmatmul_i64_reads_transposed_views(layout):
    """The witness passes W^T and G_Z^T as views; the wrapper reads them
    as they lie."""
    m, k, n = 9, 70, 12
    rng = np.random.default_rng(len(layout))
    a, b = _int16(rng, (m, k)), _int16(rng, (k, n))
    ta = torch.as_tensor(a).to(torch.int16)
    tb = torch.as_tensor(b).to(torch.int16)
    if layout in ("a_T", "both_T"):
        ta = ta.T.contiguous().T
    if layout in ("b_T", "both_T"):
        tb = tb.T.contiguous().T
    assert not (ta.is_contiguous() and tb.is_contiguous())
    np.testing.assert_array_equal(qmatmul_i64(ta, tb).numpy(),
                                  qmatmul_ref(a, b))


@pytest.mark.parametrize("fill", [0, -LIM])
def test_qmatmul_i64_exact_at_k_max(fill):
    """K = 2^17 is accepted; there the reference's int32 digit sums
    overflow ((-128)(-128) 2^17 = 2^31), and a zero product came out as
    -4294967296."""
    a = np.full((1, K_MAX), fill, dtype=np.int64)
    b = np.full((K_MAX, 1), fill, dtype=np.int64)
    got = qmatmul_i64(torch.as_tensor(a).to(torch.int16),
                      torch.as_tensor(b).to(torch.int16))
    np.testing.assert_array_equal(got.numpy(), a @ b)


def test_qmatmul_i64_rejects_k_past_k_max():
    a = torch.zeros((1, K_MAX + 1), dtype=torch.int16)
    with pytest.raises(ValueError):
        qmatmul_i64(a, a.T)


def test_qmatmul_partials_match_reference_kernel():
    """Digit products and sums equal the reference's Pallas kernel (run
    in interpret mode) at a shape where neither side pads K."""
    m, k, n = 8, 64, 16
    rng = np.random.default_rng(3)
    a, b = _int16(rng, (m, k)), _int16(rng, (k, n))
    ref, ref_k = r_partials(a.astype(np.int16), b.astype(np.int16), bm=m,
                            bn=n, bk=k, interpret=True)
    got, k_pad = qmatmul_partials(torch.as_tensor(a).to(torch.int16),
                                  torch.as_tensor(b).to(torch.int16))
    assert k_pad == ref_k == k
    for g, r in zip(got, ref):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_qmatmul_rejects_other_dtypes():
    x = torch.zeros((2, 2), dtype=torch.int64)
    with pytest.raises(TypeError):
        qmatmul_partials(x, x)


@pytest.mark.parametrize("a_range,b_range", [
    # the loss gradient Z' - Y times W^T (reaches about +-(2^15 + 2^8))
    ((-LIM - 256, LIM + 256), (-LIM, LIM)),
    # a residual operand A^{l-1} + A^j times W (reaches 2^16 - 2)
    ((0, 2 * LIM - 1), (-LIM, LIM)),
    # both operands outside int16 (G_Z^T A with a residual A)
    ((-LIM - 256, LIM + 256), (0, 2 * LIM - 1)),
])
def test_exact_matmul_splits_out_of_int16_operands(a_range, b_range):
    rng = np.random.default_rng(7)
    a, b = _int16(rng, (6, 40), *a_range), _int16(rng, (40, 5), *b_range)
    got = exact_matmul(torch.as_tensor(a), torch.as_tensor(b))
    np.testing.assert_array_equal(got.numpy(), a @ b)


def test_exact_matmul_raises_beyond_two_parts():
    a = torch.full((2, 3), 2 * LIM, dtype=torch.int64)
    with pytest.raises(OverflowError):
        exact_matmul(a, torch.ones((3, 2), dtype=torch.int64))
