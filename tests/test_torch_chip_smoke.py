"""The parts of chip_smoke.py that run without a GPU: its refusal without
CUDA, the bounds it reports, the launch counts it expects of each path, the
artifact shapes it checks, its refusal without the committed splits, the
sweep phase's schedule, the instruments it puts around a driver run (the
PhaseTimer breakdown, the integrator-step count), the mocap run case it
writes, the mocap path's launch count and the kernels line."""

import contextlib
import json
import pickle
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from torch_port_util import write_charged_split


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


def test_slice_bounds_count_the_slice_rows():
    """A receiver slice's bounds: the operations of its rows' kept edges,
    the bytes of its rows (hi, efea, the mask, the outputs, the cotangents,
    dhi, defea) and of all N senders (x, hj; dx and dhj written whole)."""
    g, n, ni, h, e = 50, 10, 5, 64, 2
    off = 1.0 - torch.eye(n)
    assert chip_smoke.pairwise_bytes(g, n, h, e, ni=n) == \
        chip_smoke.pairwise_bytes(g, n, h, e)
    w = 2 * h * h + 5 * h + e * h + 1
    assert chip_smoke.pairwise_bytes(g, n, h, e, ni=ni) == 4 * (
        g * n * 3 + g * ni * h + g * n * h + g * ni * n * e + ni * n + w
        + g * ni * 3 + g * ni * h)
    assert chip_smoke.pairwise_bytes(g, n, h, e, True, ni) == 4 * (
        g * n * 3 + g * ni * h + g * n * h + g * ni * n * e + ni * n + w
        + g * ni * 3 + g * ni * h
        + g * n * 3 + g * ni * h + g * n * h + g * ni * n * e + w)
    # operations: the slice's kept edges, half of the graph's here
    for bound in (chip_smoke.pairwise_bound_ms,
                  chip_smoke.pairwise_bwd_bound_ms):
        whole, by = bound(g, off, h, e)
        part, part_by = bound(g, off[:ni], h, e)
        assert by == part_by == "operations"
        assert part == pytest.approx(whole / 2)
    tc, _ = chip_smoke.pairwise_tc_bound_ms(g, off[ni:], h, e, backward=True)
    assert tc == pytest.approx(
        chip_smoke.pairwise_tc_bound_ms(g, off, h, e, backward=True)[0] / 2)


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


def test_path_launches_reckons_every_driver_path():
    """#1 once an EGNO layer or a SEGNO integrator step of a forward, #2 as
    often a training step; the paths' counts at the committed splits' sizes
    (7 test and valid batches of 256, 11 train batches, traj_len 20)."""
    segno_t, egno_layers = chip_smoke.T_MODEL, chip_smoke.LAYERS
    assert chip_smoke.path_launches(segno_t, 7, 20) == {
        "egnn_pairwise_fwd": 1400, "egnn_pairwise_bwd": 0}
    assert chip_smoke.path_launches(segno_t, 7, 20, 2, 11, 1, 7) == {
        "egnn_pairwise_fwd": 220 + 70 + 1400, "egnn_pairwise_bwd": 220}
    assert chip_smoke.path_launches(egno_layers, 7, 20) == {
        "egnn_pairwise_fwd": 560, "egnn_pairwise_bwd": 0}
    assert chip_smoke.path_launches(egno_layers, 7, 20, 2, 11, 1, 7) == {
        "egnn_pairwise_fwd": 676, "egnn_pairwise_bwd": 88}
    # the gravity main: one epoch of 2 batches, no validation, traj_len 2
    assert chip_smoke.path_launches(egno_layers, 1, 2, 1, 2) == {
        "egnn_pairwise_fwd": 16, "egnn_pairwise_bwd": 8}


@pytest.mark.parametrize("model,frames", [("egno", (8, 20)),
                                          ("segno", (2, 2))])
def test_check_artifact_holds_each_models_shapes(tmp_path, model, frames):
    """EGNO's artifact has T=10 frames a window, its predictions cut at 40%
    of the horizon; SEGNO's one frame a window, not cut."""
    cut, full = frames
    path = tmp_path / "a.npz"
    np.savez(path, targets=np.zeros((4, full, 5, 3)),
             preds=np.zeros((4, cut, 5, 3)),
             energy_conservation=np.zeros((4, cut, 1)))
    chip_smoke.check_artifact(path, 4, traj_len=2, model=model)
    other = "segno" if model == "egno" else "egno"
    with pytest.raises(AssertionError, match="has shape"):
        chip_smoke.check_artifact(path, 4, traj_len=2, model=other)


def test_seed_axis_inputs_stack_one_weight_set_a_seed():
    """The seed-axis cases' inputs: G = K x B graphs, the K weight sets
    stacked [K, ...] in seed order, each set as pairwise_inputs draws one,
    the SEGNO case's coordinate head scaled so that the clip engages."""
    k, b, n, h, e = 3, 4, 5, 16, 2
    x, hi, hj, efea, mask, weights, sets = chip_smoke.seed_axis_inputs(
        k, b, n, h, e, 11, torch.device("cpu"), 400.0)
    assert x.shape == (k * b, n, 3) and efea.shape == (k * b, n, n, e)
    assert [tuple(w.shape) for w in weights] == [
        (k, 1, h), (k, e, h), (k, 1, h), (k, h, h), (k, 1, h), (k, h, h),
        (k, 1, h), (k, h, 1), (k, 1, 1)]
    for s in range(k):
        for w, ws in zip(weights, sets[s]):
            assert torch.equal(w[s], ws)
    assert not torch.equal(weights[3][0], weights[3][1])
    plain = chip_smoke.pairwise_inputs(1, n, h, e, 12, torch.device("cpu"),
                                       coord_scale=400.0)[5]
    assert torch.equal(sets[0][7], plain[7])
    assert [c[0] for c in chip_smoke.SEED_AXIS_CASES] == ["egno", "segno"]
    assert chip_smoke.SEEDS == len(chip_smoke.FLEET_SEEDS) == 5


def test_fleet_launches_reckons_the_fleet_paths_and_the_sweep_groups():
    """One sequential run's training and validation, then K test
    rollouts: the fleet paths' K=5 counts and the sweep's K=3 groups at the
    committed splits' sizes."""
    egno, segno = chip_smoke.LAYERS, chip_smoke.T_MODEL
    assert chip_smoke.fleet_launches(egno, 5, 2, 11, 7, 7) == {
        "egnn_pairwise_fwd": 2916, "egnn_pairwise_bwd": 88}
    assert chip_smoke.fleet_launches(segno, 5, 2, 11, 7, 7) == {
        "egnn_pairwise_fwd": 7290, "egnn_pairwise_bwd": 220}
    assert chip_smoke.fleet_launches(egno, 3, 2, 11, 7, 7) == {
        "egnn_pairwise_fwd": 88 + 28 + 3 * 560, "egnn_pairwise_bwd": 88}
    assert chip_smoke.fleet_launches(segno, 3, 2, 11, 7, 7) == {
        "egnn_pairwise_fwd": 220 + 70 + 3 * 1400, "egnn_pairwise_bwd": 220}


def test_sweep_schedule_gives_two_fleet_groups_and_one_sequential_run(
        tmp_path):
    from nonode_tpu_torch.parallel import sweep

    path = tmp_path / "grid.json"
    path.write_text(json.dumps(chip_smoke.sweep_schedule()))
    smoke = sweep.expand_grid(sweep.load_schedule(str(path), "SMOKE"))
    assert len(smoke) == 6
    groups = sweep.group_for_fleet(smoke)
    assert sorted((json.loads(k)["model"], [c["seed"] for c in v])
                  for k, v in groups.items()) == [
        ("egno", chip_smoke.SWEEP_SEEDS), ("segno", chip_smoke.SWEEP_SEEDS)]
    seq = sweep.expand_grid(sweep.load_schedule(str(path), "SMOKE_SEQ"))
    assert seq == [{"exp_name": "_exp_new", "dataset": "charged",
                    "n_balls": 5, "num_inputs": 2, "varDT": True,
                    "model": "segno", "seed": 1}]
    assert sweep.group_for_fleet(seq) == {}


def _tiny_driver_run(tmp_path, model, *extra):
    from nonode_tpu_torch import main as nt_main

    data = tmp_path / "data"
    data.mkdir()
    for seed, part in enumerate(("train", "valid", "test")):
        write_charged_split(data, part, seed=seed, s=8, f=55)
    args = nt_main.get_args([
        "--model", model, "--only_test", "false", "--device", "cpu",
        "--data_dir", str(data), "--outf", str(tmp_path / "out"),
        "--epochs", "2", "--test_interval", "1", "--batch_size", "4",
        "--traj_len", "2", *extra])
    return nt_main, lambda: nt_main.main(args)


def test_phase_breakdown_times_each_part_of_a_driver_run(tmp_path):
    """Every part of a training run gets its phase (the datasets by
    partition, each train epoch by number), and the wrapped names are
    restored afterwards."""
    from nonode_tpu_torch.train.checkpoint import EarlyStopping
    from nonode_tpu_torch.train.loop import _Experiment

    nt_main, run = _tiny_driver_run(tmp_path, "segno")
    before = (nt_main.NBodyDataset, nt_main.load_params, torch.optim.Adam,
              _Experiment.__dict__["train_epoch"],
              EarlyStopping.save_checkpoint, np.savez)
    with chip_smoke.phase_breakdown(nt_main, torch.device("cpu")) as timer:
        run()
    assert (nt_main.NBodyDataset, nt_main.load_params, torch.optim.Adam,
            _Experiment.__dict__["train_epoch"],
            EarlyStopping.save_checkpoint, np.savez) == before
    assert {name: s["count"] for name, s in timer.summary().items()} == {
        "model build": 1, "optimizer build": 1, "data load train": 1,
        "data load val": 1, "data load test": 1, "epoch draws": 3,
        "train epoch 0": 1, "train epoch 1": 1, "validation epoch": 1,
        "checkpoint save": 1, "checkpoint load": 1, "test rollout": 1,
        "artifact write": 1}
    assert "left over" in chip_smoke.breakdown_text(timer, 100.0)


def test_counted_integrator_steps_are_the_launches_path_launches_reckons(
        tmp_path):
    """On a one-input SEGNO run (T steps a forward) the counted steps give
    path_launches' counts: recorded steps launch #1 and #2, the others #1."""
    nt_main, run = _tiny_driver_run(tmp_path, "segno")
    with chip_smoke.counted_integrator_steps() as steps:
        run()
    # 8 samples in batches of 4: 2 train, 2 validation and 2 test batches
    want = chip_smoke.path_launches(chip_smoke.T_MODEL, 2, 2, 2, 2, 1, 2)
    assert {"egnn_pairwise_fwd": sum(steps.values()),
            "egnn_pairwise_bwd": steps["recorded"]} == want
    from nonode_tpu_torch.models.segno import SEGNO
    assert SEGNO.integrate.__name__ == "integrate" and \
        SEGNO.__dict__["integrate"].__qualname__ == "SEGNO.integrate"


def test_counted_integrator_steps_count_a_replay_as_its_capture(
        tmp_path, monkeypatch):
    """A graphed rollout (StepGraph on the CPU, its capture running the
    body once and its replays launching nothing, as on the card) counts
    each replay the steps its capture ran, and the capture's own not:
    the eager rollout's counts, on SEGNO with two inputs and varDT, whose
    windows before the ``in_steps`` fixed point run eagerly."""
    from nonode_tpu_torch.models.segno import SEGNO
    from nonode_tpu_torch.train.graphs import StepGraph
    from test_torch_rollout_graphs import _setup

    class Replayed:
        def replay(self):
            pass

    monkeypatch.setattr(torch.cuda, "CUDAGraph", Replayed)
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda g: contextlib.nullcontext())
    write_charged_split(tmp_path, "test", seed=3, s=16, f=70)
    counts = []
    for graphed in (False, True):
        exp, _, ds = _setup("segno-multi", tmp_path, False)
        if graphed:
            exp._steps.devices = ("cpu",)
        with chip_smoke.counted_integrator_steps() as steps:
            exp.test_rollout(ds, 8, np.random.RandomState(7))
        counts.append((steps, exp.rollout_replays))
    (eager, none), (graphed, replays) = counts
    assert none == 0 and replays > 2 and graphed == eager
    assert eager["not recorded"] > 0 and eager["recorded"] == 0
    assert SEGNO.__dict__["integrate"].__qualname__ == "SEGNO.integrate"
    assert StepGraph.__dict__["replay"].__qualname__ == "StepGraph.replay"


def test_written_skeleton_is_cmus_31_bone_tree(tmp_path):
    """The mocap run case: CMU's 31 joints as a tree (root first, parents
    before children), 11 trials with trial 9 (09_10) 6 frames short, and
    the skeleton + 2-hop mask's degrees from 2 to 8."""
    from nonode_tpu_torch.data.amc import Skeleton, parse_asf

    edges, trials = chip_smoke.write_mocap_case(tmp_path)
    skel = Skeleton(parse_asf(tmp_path / "amc" / "09.asf"))
    assert len(skel.names) == 31 and skel.names[0] == "root"
    assert edges == skel.edges() and len(edges) == 30
    assert all(p < c for c, p in edges)
    with open(tmp_path / "motion_run.pkl", "rb") as f:
        pkl_edges, pkl_trials = pickle.load(f)
    assert pkl_edges == edges and len(pkl_trials) == chip_smoke.MOCAP_TRIALS
    frames = [x.shape[0] for x in pkl_trials]
    assert frames[9] == chip_smoke.MOCAP_FRAMES - 6
    assert all(f == chip_smoke.MOCAP_FRAMES for i, f in enumerate(frames)
               if i != 9)
    assert all(x.shape[1:] == (31, 3) and np.isfinite(x).all()
               for x in pkl_trials)
    mask = chip_smoke.mocap_mask("cpu")
    deg = mask.sum(1)
    assert torch.equal(mask, mask.T) and float(mask.diagonal().abs().sum()) \
        == 0.0
    assert (int(deg.min()), int(deg.max()), int(mask.sum())) == (2, 8, 130)


def test_mocap_cases_take_the_mocap_paths_shape():
    """#1/#2 at H=128 are held at the mocap path's shape: G = T x B = 5 x 12
    graphs of 31 joints, E=1, the written skeleton's mask; with and without
    the clip, and two seeds over G = 2 x 30."""
    cpu = torch.device("cpu")
    assert chip_smoke.MOCAP_G == 5 * 12
    labels = []
    for label, kw, clip, timed in chip_smoke.MOCAP_CASES:
        g, n, h, e, args = chip_smoke.case_inputs(kw, kw["n"], cpu)
        assert (g, n, h, e) == (60, 31, 128, 1)
        assert torch.equal(args[4], chip_smoke.mocap_mask(cpu))
        assert args[1].shape == (60, 31, 128) and args[3].shape == \
            (60, 31, 31, 1)
        labels.append((timed, clip))
    assert labels == [("mocap", False), ("mocap clip", True)]
    (label, b, clip, _, shape), = chip_smoke.MOCAP_SEED_AXIS_CASES
    assert (shape["k"] * b, shape["n"], shape["h"], shape["e"]) == \
        (60, 31, 128, 1) and clip
    # the H=64 cases keep their shapes and inputs
    g, n, h, e, args = chip_smoke.case_inputs(
        chip_smoke.PAIRWISE_CASES[0][1], 5, cpu)
    assert (g, n, h, e) == (2560, 5, 64, 2)
    plain = chip_smoke.pairwise_inputs(2560, 5, 64, 2, seed=5, dev=cpu)
    assert all(torch.equal(a, b) for a, b in zip(args[:5], plain[:5]))


def test_mocap_path_launches_are_what_its_splits_ask(tmp_path, monkeypatch):
    """A tiny motion_main run on the CPU: the calls of #1's and #2's
    wrappers (a forward a layer; one decode a test batch) are
    path_launches' counts at the split sizes mocap_split_sizes reads, and
    phase_breakdown times every part of the run."""
    from nonode_tpu_torch import motion_main
    from nonode_tpu_torch.ops.kernels import egnn_fused

    data = tmp_path / "mocap"
    chip_smoke.write_mocap_case(data)
    calls = {"egnn_pairwise_fwd": 0, "egnn_pairwise_bwd": 0}
    for name, attr in (("egnn_pairwise_fwd", "pairwise_message_fwd"),
                       ("egnn_pairwise_bwd", "pairwise_message_bwd")):
        fn = getattr(egnn_fused, attr)

        def counted(*a, _fn=fn, _name=name):
            calls[_name] += 1
            return _fn(*a)
        monkeypatch.setattr(egnn_fused, attr, counted)
    args = motion_main.get_args([
        "--nf", "16", "--n_layers", "2", "--num_timesteps", "4",
        "--batch_size", "12", "--max_training_samples", "48", "--epochs", "2",
        "--test_interval", "1", "--data_dir", str(data), "--outf",
        str(tmp_path / "out"), "--device", "cpu"])
    with chip_smoke.phase_breakdown(
            motion_main, torch.device("cpu"), "MotionDynamicsDataset",
            [(motion_main.MotionExperiment, "test_pass", "test pass")]) \
            as timer:
        motion_main.main(args)
    sizes = chip_smoke.mocap_split_sizes(data, 48)
    assert sizes == {"train": 45, "val": 240, "test": 240}
    assert calls == chip_smoke.path_launches(2, 240 // 12, 1, 2, 45 // 12, 1,
                                             240 // 12)
    assert calls == {"egnn_pairwise_fwd": 2 * 3 * 2 + 20 * 2 + 20 * 2,
                     "egnn_pairwise_bwd": 12}
    assert {name: s["count"] for name, s in timer.summary().items()} == {
        "model build": 1, "optimizer build": 1, "data load train": 1,
        "data load val": 1, "data load test": 1, "epoch draws": 3,
        "train epoch 0": 1, "train epoch 1": 1, "validation epoch": 1,
        "checkpoint save": 1, "checkpoint load": 1, "test pass": 1,
        "artifact write": 1}
    assert motion_main.MotionDynamicsDataset.__name__ == \
        "MotionDynamicsDataset"


def test_kernels_line_names_each_route():
    """#1 and #2 appear twice each: at H=64 with their launches on their
    own paths, and as egnn_pairwise_fwd_tiles and egnn_pairwise_bwd_tiles
    with their tile routes' numbers and their launches on the mocap path
    and the width paths (#1's also on SEGNO serving at nf 200); every entry
    has the contract's keys."""
    from nonode_tpu_torch.ops.kernels import KERNELS

    keys = {"max_abs_err": 1e-6, "ms": 1.0, "plain_ms": 2.0, "bound_ms": 0.1,
            "bound_by": "operations", "library_ms": None}
    rows = {k["name"]: dict(keys, width=64) for k in KERNELS}
    paths = {"train": {k["name"]: 7 for k in KERNELS},
             "stretch": {k["name"]: 1 for k in KERNELS},
             "gravity": {k["name"]: 2 for k in KERNELS},
             "mocap": {k["name"]: 432 if k["name"].endswith("fwd") else 192
                       for k in KERNELS},
             "width egno nf96": {k["name"]: 5 for k in KERNELS},
             "width egno nf256": {k["name"]: 9 for k in KERNELS},
             "width segno nf200 serving": {k["name"]: 3 for k in KERNELS}}
    routes = {"egnn_pairwise_fwd": [
        ("tiles", dict(keys, width=128, ms=3.0),
         list(chip_smoke.FWD_TILE_PATHS))],
        "egnn_pairwise_bwd": [("tiles", dict(keys, width=128, ms=0.7),
                               list(chip_smoke.TILE_PATHS))]}
    out = chip_smoke.kernels_line(KERNELS, rows, paths, routes)
    assert [e["name"] for e in out] == [
        "egnn_pairwise_fwd", "egnn_pairwise_fwd_tiles", "egnn_pairwise_bwd",
        "egnn_pairwise_bwd_tiles", "nbody_charged_force",
        "nbody_gravity_accel", "nbody_charged_leapfrog",
        "nbody_gravity_leapfrog"]
    contract = {"name", "route", "source", "replaces", "launches", *keys}
    assert all(contract <= set(e) for e in out)
    by = {e["name"]: e for e in out}
    fwd = by["egnn_pairwise_fwd_tiles"]
    assert (fwd["launches"], fwd["path"]) == (432, "mocap")
    assert fwd["launches_by_path"] == {
        "mocap": 432, "width egno nf96": 5, "width egno nf256": 9,
        "width segno nf200 serving": 3}
    assert fwd["width"] == 128 and fwd["ms"] == 3.0 and \
        fwd["route"] == "cuda"
    assert fwd["source"] == "nonode_tpu_torch/csrc/egnn_fused_fwd.cu"
    assert out[0]["launches"] == 7 and out[0]["width"] == 64
    tiles = by["egnn_pairwise_bwd_tiles"]
    assert (tiles["launches"], tiles["path"]) == (192, "mocap")
    assert tiles["launches_by_path"] == {"mocap": 192, "width egno nf96": 5,
                                         "width egno nf256": 9}
    assert tiles["source"] == "nonode_tpu_torch/csrc/egnn_fused_bwd.cu"
    json.dumps({"kernels": out})


def test_tile_route_row_gathers_every_case_of_the_route():
    """A tile route's kernels-line row: the mocap case's numbers, and
    under ``cases`` every other case the kernel runs on that route (the
    mocap clip and x200 cases, N=64, H=128 and the padded 96 and 100 at
    EGNO's shape, the wide cases, and for #1 SEGNO's nf-200 case), with the
    seed axis at the mocap shape and H=256 and the receiver slices at H=256
    (and H=128); H=32, which both run on their H=64 kernels, is not among
    them."""
    from nonode_tpu_torch.ops.kernels import egnn_fused

    def row(ms):
        return {"ms": ms, "max_abs_err": 1e-6, "bound_ms": 0.01}

    mocap = {label: row(i) for i, label in enumerate(
        ("mocap", "mocap clip", "mocap x200", "N=64 E=3"))}
    width = {"H=128": row(5)}
    padded = {f"H={h}": row(h) for h in chip_smoke.WIDTHS}
    wide = dict(row(6), width=256, cases={r: row(7) for r in
                                          chip_smoke.WIDE_ROWS
                                          if r != "H=256"},
                seed_axis={"H=256": row(8)}, receiver_slice={"s": row(9)})
    got = chip_smoke.tile_route_row(egnn_fused, mocap, {"mocap": row(10)},
                                    width, padded, wide)
    assert got["ms"] == 0 and got["width"] == 128
    assert set(got["cases"]) == {
        "mocap clip", "mocap x200", "N=64 E=3", "H=128", "H=96", "H=100",
        *chip_smoke.WIDE_ROWS}
    assert got["cases"]["H=256"] == dict(row(6), width=256)
    assert set(got["seed_axis"]) == {"mocap", "H=256"}
    assert got["receiver_slice"] == {"s": row(9)}
    assert not egnn_fused.tile_route(32, 2)
    fwd = chip_smoke.tile_route_row(egnn_fused, mocap, {"mocap": row(10)},
                                    width, padded, wide,
                                    {"SEGNO H=200": row(11)}, {"t": row(12)})
    assert set(fwd["cases"]) == set(got["cases"]) | {"SEGNO H=200"}
    assert fwd["receiver_slice"] == {"s": row(9), "t": row(12)}


def test_tile_cases_take_the_tile_route_at_their_shapes():
    """#2's new kernels-phase cases: the mocap shape with hi and hj x200
    (the same seeded inputs scaled) and N=64 graphs at H=128 with E=3 over
    2 x 132 + 7 graphs; both on the tile route and held, with the mocap
    case, to the split-TF32 budget; every H=128, padded and wide case is
    on the tile route too. Each one's split-TF32 bound counts the edges its
    mask keeps: 12 H^2 multiply-adds of products a kept edge, three times
    over, at the TF32 peak."""
    from nonode_tpu_torch.ops.kernels import egnn_fused

    cpu = torch.device("cpu")
    (l1, kw1, clip1, row1), (l2, kw2, clip2, row2) = chip_smoke.TILE_CASES
    assert (row1, row2) == ("mocap x200", "N=64 E=3") and not clip1 and \
        not clip2
    assert {row1, row2, "mocap"} == chip_smoke.TILE_SPLIT_TF32_ROWS
    g, n, h, e, args = chip_smoke.case_inputs({**kw1, "g": 2}, 31, cpu)
    plain = chip_smoke.case_inputs({**chip_smoke.MOCAP_CASES[0][1], "g": 2},
                                   31, cpu)[4]
    assert torch.equal(args[1], 200.0 * plain[1]) and \
        torch.equal(args[2], 200.0 * plain[2]) and \
        torch.equal(args[3], plain[3])
    assert (kw2["g"], kw2["n"], kw2["h"], kw2["e"]) == (271, 64, 128, 3)
    for _, kw, _, _ in (*chip_smoke.TILE_CASES, *chip_smoke.MOCAP_CASES,
                        *chip_smoke.WIDE_CASES):
        assert egnn_fused.tile_route(kw["h"], kw.get("e", 2))
    assert [egnn_fused.tile_route(h, 2) for h in chip_smoke.WIDTHS] == [
        False, True, True]
    off = 1.0 - torch.eye(64)
    bound, pipe = chip_smoke.pairwise_tc_bound_ms(271, off, 128, 3,
                                                  backward=True)
    products = 271 * 64 * 63 * 3 * 12 * 128 * 128
    assert pipe == "tensor cores" and abs(
        bound - 1e3 * products / chip_smoke.PEAK_TF32_FLOPS) < 1e-12
    mask = chip_smoke.mocap_mask(cpu)
    assert chip_smoke.pairwise_tc_bound_ms(60, mask, 128, 1, True)[0] == \
        pytest.approx(1e3 * 60 * 130 * 3 * 12 * 128 * 128
                      / chip_smoke.PEAK_TF32_FLOPS)


def test_split_digests_hold_each_kernel_to_its_own_build():
    """The H=128 digest of both kernels is split: #1's tile route's outputs
    at H=128 and 256 (fwd_digest) and #2's (tiles_digest), each recorded
    from the build that brought the route; chip_smoke.py and the card tests
    hold the same three sha256 values, and the timing script computes each
    and times every forward case of the tile route."""
    import importlib.util
    import re

    root = Path(chip_smoke.__file__).resolve().parent
    card = (root / "tests" / "test_torch_cuda.py").read_text()
    for name in ("H64_DIGEST", "H128_FWD_DIGEST", "TILES_BWD_DIGEST"):
        value = getattr(chip_smoke, name)
        assert re.fullmatch(r"[0-9a-f]{64}", value), name
        assert re.search(rf'{name} = (\\\n\s*)?"{value}"', card), name
    assert chip_smoke.H128_FWD_DIGEST != chip_smoke.TILES_BWD_DIGEST
    spec = importlib.util.spec_from_file_location(
        "time_pairwise", root / "scripts" / "time_pairwise_kernels.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    assert callable(script.fwd_digest) and callable(script.tiles_digest)
    assert not hasattr(script, "h128_digest")
    assert {"fwd H=128 mocap", "bwd H=256 EGNO", "bwd E=6 H=64 EGNO",
            "bwd H=1024 EGNO", "fwd H=96 EGNO", "fwd H=512 EGNO",
            "fwd H=1024 EGNO", "fwd E=6 H=64 EGNO", "fwd SEGNO nf200"} <= {
        c[0] for c in script.ROUTE_CASES}
    segno = [c for c in script.ROUTE_CASES if c[0] == "fwd SEGNO nf200"][0]
    assert segno[1:7] == ("fwd", 256, 5, 200, 2, True)


def test_mocap_step_names_the_kernels_of_each_call():
    """The traced mocap step splits its device time by the kernels of #1's
    and #2's calls: every fragment names a kernel of the sources, and #2's
    cover the split, the tiles, the weight-gradient sum and the node
    sums."""
    root = Path(chip_smoke.__file__).resolve().parent / "nonode_tpu_torch" \
        / "csrc"
    bwd = (root / "egnn_fused_bwd.cu").read_text()
    fwd = (root / "egnn_fused_fwd.cu").read_text()
    for kernel in ("egnn_split_weights", "egnn_pairwise_bwd_tiles",
                   "egnn_pairwise_bwd_reduce", "egnn_pairwise_bwd_node_reduce"):
        assert f"__global__" in bwd and kernel in bwd
        assert any(f in kernel for f in chip_smoke.MOCAP_KERNEL_PARTS["#2"])
    assert all(f in fwd for f in chip_smoke.MOCAP_KERNEL_PARTS["#1"])


def test_wide_cases_take_the_wide_route():
    """The cases above H=128 and at E > 4: H=256 at EGNO's serving shape
    with and without the clip, H=200 padded to 256, H=512 and H=1024, E=6
    at H=64 and H=256, the mocap shape at H=256; every one on #1's and
    #2's tile routes, and all but the clip held to the split-TF32 budget;
    the seed axis (two sets over G = 2 x 1280) and the slice (rows 5-9 of
    N=10) at H=256, a slice at H=128 too; #1 also at SEGNO's nf-200 serving
    shape (G=256, the clip engaged, H=200 on the tile route at 256)."""
    from nonode_tpu_torch.ops.kernels import egnn_fused

    cpu = torch.device("cpu")
    shapes = {}
    for label, kw, clip, timed in chip_smoke.WIDE_CASES:
        kw = {**kw, "g": 2}             # the shapes, at two graphs
        g, n, h, e, args = chip_smoke.case_inputs(kw, kw["n"], cpu)
        assert egnn_fused.tile_route(h, e), label
        assert args[1].shape == (2, n, h) and args[3].shape == (2, n, n, e)
        shapes[timed] = (n, h, e, clip)
        assert (timed in chip_smoke.SPLIT_TF32_ROWS) == (not clip)
    assert shapes == {
        "H=256": (5, 256, 2, False), "H=256 clip": (5, 256, 2, True),
        "H=200": (5, 200, 2, False), "H=512": (5, 512, 2, False),
        "H=1024": (5, 1024, 2, False), "E=6 H=64": (5, 64, 6, False),
        "E=6 H=256": (5, 256, 6, False), "mocap H=256": (31, 256, 1, False)}
    assert {kw["g"] for _, kw, _, _ in chip_smoke.WIDE_CASES} == {2560, 60}
    assert egnn_fused.padded_width(200) == 256
    (label, b, clip, _, shape), = chip_smoke.WIDE_SEED_AXIS_CASES
    assert (shape["k"] * b, shape["h"]) == (2560, 256) and not clip
    (label, g, clip, _), = chip_smoke.WIDE_SLICE_CASES
    assert (g, chip_smoke.SLICE_N, chip_smoke.SLICE_SPACE) == (500, 10, 2)
    (label, g, clip, _), = chip_smoke.TILE_SLICE_CASES
    assert g == 500 and not clip and "H=128" in label
    (label, kw, clip, timed), = chip_smoke.SEGNO_WIDE_CASES
    assert (kw["g"], kw["n"], kw["h"], clip, timed) == (256, 5, 200, True,
                                                       "SEGNO H=200")
    g, n, h, e, args = chip_smoke.case_inputs({**kw, "g": 2}, 5, cpu)
    assert egnn_fused.tile_route(h, e) and args[1].shape == (2, 5, 200)
    assert timed not in chip_smoke.SPLIT_TF32_ROWS
    off = 1.0 - torch.eye(5)
    assert chip_smoke.pairwise_tc_bound_ms(256, off, 200, 2)[0] == \
        pytest.approx(1e3 * 256 * 20 * 3 * 4 * 200 * 200
                      / chip_smoke.PEAK_TF32_FLOPS)


def test_width_runs_take_an_instantiation_and_the_wide_route():
    """The width path's runs: SEGNO nf 32 padded to the instantiated 64;
    EGNO nf 96 (at 128), EGNO nf 256 (cut to one training batch and one
    test window) and SEGNO nf 200 (at 256) on the tile routes; #1 on the
    paths of each of those, #2 on the EGNO ones."""
    from nonode_tpu_torch.ops.kernels import egnn_fused

    assert chip_smoke.WIDTH_RUNS == ((96, 32, 512, 2), (256, 200, 256, 1))
    assert [(egnn_fused.padded_width(a), egnn_fused.padded_width(b))
            for a, b, _, _ in chip_smoke.WIDTH_RUNS] == [(128, 64),
                                                        (256, 256)]
    assert [egnn_fused.tile_route(nf, 2) for run in chip_smoke.WIDTH_RUNS
            for nf in run[:2]] == [True, False, True, True]
    assert chip_smoke.FWD_TILE_PATHS == (
        "mocap", "width egno nf96", "width egno nf256",
        "width segno nf200 serving")
    assert chip_smoke.TILE_PATHS == chip_smoke.FWD_TILE_PATHS[:3]
    assert [samples // chip_smoke.BATCH for _, _, samples, _ in
            chip_smoke.WIDTH_RUNS] == [2, 1]


def test_padded_widths_are_bound_at_both_widths():
    """A width that runs zero-padded keeps the bound of its own work and
    gains the bound of the padded width's beside it; an instantiated width
    gains nothing."""
    from nonode_tpu_torch.ops.kernels import egnn_fused

    off = 1.0 - torch.eye(5)
    assert chip_smoke.padded_bound(egnn_fused, 2560, off, 64, 2, 0.1) == \
        ({}, "")
    for h, hp in ((32, 64), (96, 128), (100, 128)):
        for backward in (False, True):
            row, text = chip_smoke.padded_bound(egnn_fused, 2560, off, h, 2,
                                                0.5, backward)
            want = chip_smoke.pairwise_tc_bound_ms(2560, off, hp, 2,
                                                   backward)[0]
            assert row == dict(padded_width=hp, padded_bound_ms=want,
                               padded_bound_share=want / 0.5)
            assert f"H={hp}" in text
            assert want > chip_smoke.pairwise_tc_bound_ms(
                2560, off, h, 2, backward)[0]
    assert {f"H={h}" for h in chip_smoke.WIDTHS} <= chip_smoke.SPLIT_TF32_ROWS
    assert [c[3] for c in chip_smoke.WIDTH_CASES] == [
        row for h in chip_smoke.WIDTHS for row in (f"H={h}", f"H={h} clip")
    ] + ["H=128"]


def test_width_preset_sets_the_models_width(tmp_path):
    """The width path's preset reaches the model through --config_by_file,
    and nothing else of the arguments."""
    from nonode_tpu_torch import main as nt_main
    from nonode_tpu_torch.runtime import seed_everything

    for nf in (96, 256):
        preset = chip_smoke.write_width_preset(tmp_path / "p.json", nf)
        args = nt_main.get_args(["--model", "egno", "--epochs", "2",
                                 "--config_by_file", str(preset)])
        assert args.epochs == 2
        exp = nt_main.build_experiment(args, torch.device("cpu"),
                                       seed_everything(1))
        assert exp.model.embedding.weight.shape[0] == nf
        assert exp.model.layers[0].hidden_nf == nf


def test_plain_versions_are_guarded_and_restored():
    from nonode_tpu_torch.ops.kernels import egnn_fused

    before = egnn_fused.pairwise_message_reference
    x = torch.zeros(1, 2, 3)
    with chip_smoke.no_plain_on_card(egnn_fused):
        assert egnn_fused.pairwise_message_reference is not before
        w = tuple(torch.zeros(s) for s in egnn_fused._weight_shapes(4, 1))
        out = egnn_fused.pairwise_message_fwd(
            False, x, torch.zeros(1, 2, 4), torch.zeros(1, 2, 4),
            torch.zeros(1, 2, 2, 1), 1.0 - torch.eye(2), w)
        assert [tuple(o.shape) for o in out] == [(1, 2, 3), (1, 2, 4)]
    assert egnn_fused.pairwise_message_reference is before


def test_baselines_phase_runs_each_baseline_on_the_cpu():
    """The baselines phase's inputs, models and step on the CPU: 100 graphs
    of the committed split, every parameter given a gradient, RFVel's NaN
    gradients confined to the layers before its last (as in JAX)."""
    from nonode_tpu_torch.runtime import seed_everything

    inputs = chip_smoke.baseline_inputs(chip_smoke.ROOT / "data", "cpu")
    assert [tuple(a.shape) for a in inputs] == [
        (100, 5, 3), (100, 5, 3), (100, 5, 1), (100, 5, 2), (100, 5, 5, 2)]
    models = chip_smoke.baseline_models(2, 2)
    assert list(models) == ["GNN", "LinearDynamics", "RFVel",
                            "EquivariantScalarNet", "EGMN", "FullMLP"]
    for name, (cls, kw, call) in models.items():
        model = cls(**kw, device="cpu", generator=seed_everything(42))
        outs, grads = chip_smoke.baseline_step(model, call, inputs)
        assert outs[0].shape == (100, 5, 3), name
        assert set(grads) == set(dict(model.named_parameters()))
        nan = {n.split(".")[1] for n, g in grads.items()
               if torch.isnan(g).any()}
        assert nan == ({"0", "1", "2"} if name == "RFVel" else set()), name
        assert all(torch.isfinite(o).all() for o in outs)
    a = torch.tensor([1.0, float("nan"), 3.0])
    assert chip_smoke.nan_aware_rel_err(a, a.clone()) == 0.0
    with pytest.raises(AssertionError, match="NaN"):
        chip_smoke.nan_aware_rel_err(torch.ones(3), a)
