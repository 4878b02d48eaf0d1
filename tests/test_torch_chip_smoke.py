"""The parts of chip_smoke.py that run without a GPU: its refusal without
CUDA, the bounds it reports, the launch counts it expects of each path, the
artifact shapes it checks, its refusal without the committed splits, the
sweep phase's schedule, the instruments it puts around a driver run (the
PhaseTimer breakdown, the integrator-step count), the mocap run case it
writes, the mocap path's launch count and the kernels line."""

import json
import pickle

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


def test_kernels_line_names_the_h128_instantiations():
    """#1 and #2 appear twice: at H=64 with their launches on the N-body
    paths, and as <name>_h128 with the mocap cases' numbers and their
    launches on the mocap path; every entry has the contract's keys."""
    from nonode_tpu_torch.ops.kernels import KERNELS

    keys = {"max_abs_err": 1e-6, "ms": 1.0, "plain_ms": 2.0, "bound_ms": 0.1,
            "bound_by": "operations", "library_ms": None}
    rows = {k["name"]: dict(keys, width=64) for k in KERNELS}
    paths = {"train": {k["name"]: 7 for k in KERNELS},
             "stretch": {k["name"]: 1 for k in KERNELS},
             "gravity": {k["name"]: 2 for k in KERNELS}}
    mocap_rows = {n: dict(keys, width=128, ms=3.0)
                  for n in ("egnn_pairwise_fwd", "egnn_pairwise_bwd")}
    mocap = {"egnn_pairwise_fwd": 432, "egnn_pairwise_bwd": 192}
    out = chip_smoke.kernels_line(KERNELS, rows, paths, mocap_rows, mocap)
    assert [e["name"] for e in out] == [
        "egnn_pairwise_fwd", "egnn_pairwise_fwd_h128", "egnn_pairwise_bwd",
        "egnn_pairwise_bwd_h128", "nbody_charged_force",
        "nbody_gravity_accel", "nbody_charged_leapfrog",
        "nbody_gravity_leapfrog"]
    contract = {"name", "route", "source", "replaces", "launches", *keys}
    assert all(contract <= set(e) for e in out)
    h128 = {e["name"]: e for e in out if e["name"].endswith("_h128")}
    assert h128["egnn_pairwise_fwd_h128"]["launches"] == 432
    assert h128["egnn_pairwise_bwd_h128"]["launches_by_path"] == {
        "mocap": 192}
    assert h128["egnn_pairwise_fwd_h128"]["width"] == 128 and \
        h128["egnn_pairwise_fwd_h128"]["ms"] == 3.0
    assert out[0]["launches"] == 7 and out[0]["width"] == 64
    json.dumps({"kernels": out})


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

    preset = chip_smoke.write_width_preset(tmp_path / "p.json", 96)
    args = nt_main.get_args(["--model", "egno", "--epochs", "2",
                             "--config_by_file", str(preset)])
    assert args.epochs == 2
    exp = nt_main.build_experiment(args, torch.device("cpu"),
                                   seed_everything(1))
    assert exp.model.embedding.weight.shape[0] == 96
    assert exp.model.layers[0].hidden_nf == 96


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
