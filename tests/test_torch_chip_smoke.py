"""The parts of chip_smoke.py that run without a GPU: its refusal without
CUDA, the bounds it reports, and its refusal without the committed splits."""

import pytest
import torch

import chip_smoke


def test_exits_nonzero_with_no_result_without_cuda(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert chip_smoke.main() != 0
    assert capsys.readouterr().out == ""


def test_pairwise_bound_counts_operations_and_bytes():
    off = 1.0 - torch.eye(5)
    ms, by = chip_smoke.pairwise_bound_ms(2560, off, 64, 2)
    # only the G*N*(N-1) edges the off-diagonal mask keeps do work
    flops = 2560 * 20 * (2 * (2 * 64 * 64 + 64 + 2 * 64 + 64) + 12 * 64)
    assert by == "operations"
    assert ms == pytest.approx(1e3 * flops / chip_smoke.PEAK_FP32_FLOPS)
    sparse = off.clone()
    sparse[0] = 0.0
    assert chip_smoke.pairwise_bound_ms(2560, sparse, 64, 2)[0] == \
        pytest.approx(ms * 16 / 20)
    # with a tiny hidden width the same chain moves more bytes than it computes
    assert chip_smoke.pairwise_bound_ms(2560, off, 1, 64)[1] == "bytes"


def test_pairwise_bwd_bound_counts_operations_and_bytes():
    h, e = 64, 2
    macs = (4 * h * h                  # a1 W2, msg Wc1, dcpre Wc1^T, dpre2 W2^T
            + 2 * h * h                # a1^T dpre2, msg^T dcpre
            + 3 * e * h                # efea We, dpre1 We^T, efea^T dpre1
            + 4 * h)                   # ca wc2, dpre1 wg, r2 dpre1, ca dcw
    per_edge = 2 * macs + 41 * h + 38
    assert chip_smoke.pairwise_bwd_flops_per_edge(h, e) == per_edge == 53094
    off = 1.0 - torch.eye(5)
    ms, by = chip_smoke.pairwise_bwd_bound_ms(2560, off, h, e)
    assert by == "operations"
    # 2.72 GFLOP over the 51,200 kept edges: about 0.041 ms at 67 TFLOP/s
    assert ms == pytest.approx(1e3 * 51200 * per_edge
                               / chip_smoke.PEAK_FP32_FLOPS)
    assert 0.040 < ms < 0.041
    sparse = off.clone()
    sparse[:, 0] = 0.0
    assert chip_smoke.pairwise_bwd_bound_ms(2560, sparse, h, e)[0] == \
        pytest.approx(ms * 16 / 20)
    assert chip_smoke.pairwise_bwd_bound_ms(2560, off, 1, 64)[1] == "bytes"


def test_committed_split_is_found_or_named_as_missing(tmp_path):
    assert chip_smoke.committed_split() == chip_smoke.ROOT / "data"
    (tmp_path / "data").mkdir()
    (tmp_path / "data" / "loc_test_charged5_initvel1small.npy").touch()
    with pytest.raises(FileNotFoundError,
                       match="vel_test_charged5_initvel1small.npy, charges_"):
        chip_smoke.committed_split(tmp_path)


def test_nbody_bound_counts_pairs_operations_and_bytes():
    # a 99-step charged block at N=1000: 99 x 1000 x 999 pairs at 22 FLOP,
    # about 0.0325 ms at 67 TFLOP/s
    ms, by = chip_smoke.nbody_bound_ms("nbody_charged_leapfrog", 1000, 99)
    flops = 99 * 1000 * 999 * 22
    assert by == "operations"
    assert ms == pytest.approx(1e3 * flops / chip_smoke.PEAK_FP32_FLOPS)
    assert 0.032 < ms < 0.033
    # the whole stretch run (20,000 steps) is about 6.6 ms, as bench.py counts
    stretch = chip_smoke.nbody_bound_ms("nbody_charged_leapfrog", 1000, 20000)
    assert 6.5 < stretch[0] < 6.7
    # one force evaluation: 10^6 pairs, a third of a microsecond
    ms, by = chip_smoke.nbody_bound_ms("nbody_gravity_accel", 1000)
    assert by == "operations" and 3.2e-4 < ms < 3.4e-4
    # a lone body has no pair: the bytes bound it
    ms, by = chip_smoke.nbody_bound_ms("nbody_gravity_leapfrog", 1, 100)
    assert by == "bytes"
    assert ms == pytest.approx(1e3 * 4 * 19 / chip_smoke.PEAK_BYTES)


def test_block_kernels_line_reports_the_launch_and_time_per_step():
    shape = dict(blocks=125, threads=1024, receivers_per_pass=8,
                 warps_per_receiver=4, passes=1, smem_bytes=16768)
    line = chip_smoke.block_kernels_line(
        1000, {"nbody_charged_leapfrog": (shape, 0.198, 99),
               "nbody_gravity_leapfrog": (dict(shape, passes=2), 0.15, 100)},
        0.099)
    assert line.startswith(
        "block kernels at N=1000: nbody_charged_leapfrog 125 blocks of 1024 "
        "threads (8 receivers a pass x 4 warps each, 1 pass), 2.000 us per "
        "micro-step; nbody_gravity_leapfrog ")
    assert "4 warps each, 2 passes), 1.500 us per micro-step;" in line
    # the probe's 0.099 ms over the charged kernel's 99 steps and 0.198 ms
    assert line.endswith("probe without the pair sums 1.000 us per "
                         "micro-step, 0.500 of the charged kernel's")


def test_pairwise_tc_bound_takes_the_longest_pipe_of_the_split_tf32_route():
    h, e = 64, 2
    off = 1.0 - torch.eye(5)
    edges = 2560 * 20                         # the 51,200 kept edges
    # forward: 2 products x 2 H^2 FLOP, three times over at the TF32 peak
    ms, pipe = chip_smoke.pairwise_tc_bound_ms(2560, off, h, e)
    assert pipe == "tensor cores"
    assert ms == pytest.approx(1e3 * edges * 3 * 4 * h * h
                               / chip_smoke.PEAK_TF32_FLOPS)
    assert 0.0050 < ms < 0.0051               # 5.08 us
    # the other pipes: the rest of the FLOP on the CUDA cores (0.98 us), an
    # exp and a reciprocal per SiLU on the SFUs (4.70 us), the bytes (3.19 us)
    rest = chip_smoke.pairwise_flops_per_edge(h, e) - 4 * h * h
    assert rest == 1280
    assert 1e3 * edges * rest / chip_smoke.PEAK_FP32_FLOPS == \
        pytest.approx(0.000978, rel=1e-3)
    assert 1e3 * edges * 6 * h / chip_smoke.PEAK_RSQRT == \
        pytest.approx(0.00470, rel=1e-3)
    assert 1e3 * chip_smoke.pairwise_bytes(2560, 5, h, e) \
        / chip_smoke.PEAK_BYTES == pytest.approx(0.00319, rel=1e-3)
    # backward: 6 products (15.25 us), above its SFU time
    ms_b, pipe_b = chip_smoke.pairwise_tc_bound_ms(2560, off, h, e,
                                                   backward=True)
    assert pipe_b == "tensor cores"
    assert ms_b == pytest.approx(3 * ms)
    assert 0.01524 < ms_b < 0.01526
    # both sit well under the fp32 bounds (13.5 and 40.6 us)
    assert ms < chip_smoke.pairwise_bound_ms(2560, off, h, e)[0] / 2
    assert ms_b < chip_smoke.pairwise_bwd_bound_ms(2560, off, h, e)[0] / 2
    # a sparser mask keeps fewer edges; a tiny width moves more bytes than
    # it computes; at width 16 the SFUs outlast the products
    sparse = off.clone()
    sparse[0] = 0.0
    assert chip_smoke.pairwise_tc_bound_ms(2560, sparse, h, e)[0] == \
        pytest.approx(ms * 16 / 20)
    assert chip_smoke.pairwise_tc_bound_ms(2560, off, 1, 64)[1] == "bytes"
    assert chip_smoke.pairwise_tc_bound_ms(2560, off, 16, 2)[1] == \
        "special-function units"


def test_route_row_holds_a_kernel_to_its_split_tf32_bound():
    row = chip_smoke.route_row(0.05, (0.0135, "operations"),
                               (0.005, "tensor cores"))
    assert row.pop("bound_share") == pytest.approx(0.1)
    assert row == dict(bound_ms=0.005, bound_by="operations",
                       bound_pipe="tensor cores", fp32_bound_ms=0.0135,
                       fp32_bound_by="operations")
    assert chip_smoke.route_row(1.0, (0.2, "bytes"), (0.2, "bytes"))[
        "bound_by"] == "bytes"
    text = chip_smoke.bounds_text((0.0135, "operations"),
                                  (0.005, "tensor cores"), 0.05)
    assert text == ("bound 0.0050 ms in split TF32 (set by the tensor cores; "
                    "the route's bound, 0.100 of it), 0.0135 ms in fp32 on "
                    "the CUDA cores (by operations)")
