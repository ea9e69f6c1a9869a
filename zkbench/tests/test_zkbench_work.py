"""The yardstick's geometry and counts against hand-worked values at a
tiny geometry, and the geometry against the program's own layout."""
import pytest

from zkbench.work import counts, peaks
from zkbench.work.geometry import Geometry

TINY = Geometry((8, 8, 8), batch=4, n_steps=1)


def test_tiny_geometry_by_hand():
    g = TINY
    # 2 aux slots of 4 x 8; 2 weight slots of 8 x 8
    assert (g.s_pad, g.d_elem, g.w_elem) == (2, 32, 64)
    assert (g.d_stack, g.w_stack, g.y_stack, g.x_len) == (64, 128, 32, 8)
    # 32 + 2*128 + 5*64 + 2*8 = 624 -> 1024; + 2*64*16 + 2*64*8 -> 4096
    assert g.agg_len == 1024 and g.merged_len == 4096
    assert (g.lb, g.la, g.lw, g.lj, g.ls) == (2, 5, 6, 3, 1)


@pytest.mark.parametrize("widths,batch,steps", [
    ((8, 8, 8), 4, 1), ((8, 8, 8, 8), 4, 2), ((8, 4, 2), 4, 1),
    ((4096, 4096, 4096), 128, 1), ((1024,) * 9, 64, 4)])
def test_geometry_matches_the_program(widths, batch, steps):
    from repro_torch.core.pipeline.config import PipelineConfig
    from repro_torch.core.pipeline.graph import build_fcnn_graph

    cfg = PipelineConfig.from_graph(build_fcnn_graph(widths, batch),
                                    16, 8, steps)
    g = Geometry(widths, batch, steps)
    assert (g.d_stack, g.w_stack, g.y_stack, g.agg_len, g.merged_len) == (
        cfg.d_stack, cfg.w_stack, cfg.y_stack, cfg.agg_len, cfg.merged_len)
    assert (g.lb, g.la, g.lw, g.lj, g.ls) == (
        cfg.lb, cfg.la, cfg.lw, cfg.lj, cfg.s_pad.bit_length() - 1)
    assert [n for n, _ in g.agg_blocks()[:-2]] == [
        s.name for s in cfg.graph.commit_slots]


def test_cells_geometry():
    assert Geometry((4096,) * 3, 128, 1).merged_len == 1 << 28
    g = Geometry((1024,) * 9, 64, 4)
    assert (g.d_stack, g.w_stack, g.merged_len) == (1 << 21, 1 << 25,
                                                    1 << 28)


def test_qmatmul_counts_by_hand():
    assert counts.step_products(TINY) == [
        (4, 8, 8), (8, 4, 8), (4, 8, 8), (4, 8, 8), (8, 4, 8)]
    assert counts.qmatmul_bytes(2, 4, 8) == 2 * (8 + 32) + 8 * 16
    assert counts.qmatmul_int8_ops(2, 4, 8) == 4 * 2 * 64
    # the kernel table's Z product: 128 x 4096 x 4096 is bound by bytes
    z = (128, 4096, 4096)
    assert counts.bound_s(counts.qmatmul_bytes(*z),
                          n_int8_ops=counts.qmatmul_int8_ops(*z)) == \
        pytest.approx(38_797_312 / peaks.HBM_BYTES_PER_S)


def test_validity_counts_by_hand():
    assert counts.validity_positions(TINY) == 2 * 64 * 24
    # 50,331,648 positions at width 4096: 0.841 ms, bound by bytes
    g = Geometry((4096,) * 3, 128, 1)
    assert counts.validity_positions(g) == 50_331_648
    assert counts.validity_tables_bound_s(g) == pytest.approx(
        56 * 50_331_648 / 3.35e12)


def test_window_counts_by_hand():
    assert counts.ipa_products(4) == 5 * 4 + 5 * 2
    assert counts.ipa_bytes(4) == 4 * (4 + 2) * 8 + 4 * (2 + 1) * 8
    # x 4*8, y 4*8, W and G_W 2*128, Z'' and R_Z 2*4*16, G_A' and R_GA 2*4*8
    assert counts.committed_elements(TINY) == 32 + 32 + 256 + 128 + 64
    w = counts.window_work(TINY)
    assert w["montgomery_products"] == 512 + counts.ipa_products(4096) \
        + 2 * 4096
    assert w["int8_ops"] == sum(counts.qmatmul_int8_ops(*p)
                                for p in counts.step_products(TINY))
    assert counts.window_bound_s(TINY) > 0
