"""The yardstick's counts against counts made by hand."""

from __future__ import annotations

import pytest

from portbench import counts, loader


@pytest.mark.parametrize("bits,code_bytes,table_bytes", [(4, 0.5, 256),
                                                          (8, 1, 2 * 65536)])
def test_one_lut_product(bits, code_bytes, table_bytes):
    ops, nbytes = counts.lut_work(128, 2048, 5632, bits)
    assert ops == 2 * 128 * 2048 * 5632
    # codes of both operands, the table's entries as bytes, int32 out
    assert nbytes == ((128 * 2048 + 2048 * 5632) * code_bytes + table_bytes
                      + 4 * 128 * 5632)
    peaks = loader.peaks("NVIDIA H100 80GB HBM3")
    t = counts.bound_s(ops, nbytes, peaks["int8_op_s"], peaks["hbm_byte_s"])
    assert t == pytest.approx(nbytes / 3.35e12) and t > ops / 1979e12


def test_stablelm_step_by_hand():
    d = counts.dims(loader.config("stablelm-1.6b-w8"))
    D, F, V, H, hd = 2048, 5632, 100352, 32, 64
    assert (d.D, d.F, d.V, d.H, d.hd, d.L) == (D, F, V, H, hd, 24)
    per_token_at_0 = 24 * (4 * 2 * D * D + 4 * H * hd * 1 + 3 * 2 * D * F) + 2 * D * V
    assert counts.token_flops(d, 1) == per_token_at_0
    # a step of two rows at positions 0 and 9: ten more keys for the second
    assert counts.step_flops(d, [0, 9]) == (2 * per_token_at_0
                                            + 24 * 4 * H * hd * 9)
    prods = counts.lut_products(d, 128)
    assert len(prods) == 72
    assert prods[:3] == [(128, D, F), (128, D, F), (128, F, D)]


def test_a_step_bound_sums_its_products():
    d = counts.dims(loader.config("stablelm-1.6b-w8"))
    peaks = loader.peaks("NVIDIA H100 80GB HBM3")
    want = 24 * sum(counts.bound_s(*counts.lut_work(*mkn, 8), peaks["int8_op_s"],
                                   peaks["hbm_byte_s"])
                    for mkn in [(8, 2048, 5632), (8, 2048, 5632), (8, 5632, 2048)])
    assert counts.lut_step_bound_s(d, 8, peaks, 8) == pytest.approx(want, rel=1e-12)
