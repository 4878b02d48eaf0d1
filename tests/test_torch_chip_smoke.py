"""The parts of chip_smoke.py that run without a GPU: its refusal without
CUDA, the bound it reports, and its refusal without the committed split."""

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


def test_committed_split_is_found_or_named_as_missing(tmp_path):
    assert chip_smoke.committed_split() == chip_smoke.ROOT / "data"
    (tmp_path / "data").mkdir()
    (tmp_path / "data" / "loc_test_charged5_initvel1small.npy").touch()
    with pytest.raises(FileNotFoundError,
                       match="vel_test_charged5_initvel1small.npy, charges_"):
        chip_smoke.committed_split(tmp_path)
