"""The port's bf16 mode (``--precision bf16``) against the JAX package's
``compute_dtype=jnp.bfloat16``: EGNO's ``_loss``, SEGNO's ``_loss`` and
``_loss_dynamic``, one Adam-L2 epoch of each, and two-epoch driver runs.

Both sides keep fp32 parameters and Adam state, cast the parameters and the
batch's inputs to bf16 for the forward and backward, and take the loss in
fp32. bf16 keeps 8 mantissa bits (about 4e-3 relative); the two packages
round at other places (XLA on the CPU fuses elementwise chains and rounds
once per fusion, torch rounds after every op), so the bounds are bf16's,
set before the first run:
- a forward (positions and per-frame losses) within 3e-2 x max(1, max|ref|);
- the losses of a two-epoch driver run within rtol 5e-2 of JAX's bf16 run,
  and within rtol 0.2 of the port's own fp32 run (as the JAX package's
  tests/test_driver.py:135-145 holds its bf16 driver to its fp32 one).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nonode_tpu.data.nbody import NBodyDataset as JaxNBodyDataset
from nonode_tpu.models.egno import EGNO as JaxEGNO
from nonode_tpu.models.segno import SEGNO as JaxSEGNO
from nonode_tpu.train.loop import EGNOExperiment as JaxEGNOExperiment
from nonode_tpu.train.loop import SEGNOExperiment as JaxSEGNOExperiment
from nonode_tpu.train.loop import make_perm as jax_make_perm
from nonode_tpu_torch import main as tmain
from nonode_tpu_torch.compat.params import (egno_state_dict_from_jax_params,
                                            segno_state_dict_from_jax_params)
from nonode_tpu_torch.data.nbody import NBodyDataset
from nonode_tpu_torch.models.egno import EGNO
from nonode_tpu_torch.models.segno import SEGNO
from nonode_tpu_torch.train.checkpoint import save_params
from nonode_tpu_torch.train.loop import EGNOExperiment, SEGNOExperiment
from test_torch_e2e import _run_both_drivers, _tiny_models
from torch_port_util import write_charged_split


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Each test on one torch thread: its tensors are tiny, and in a
    parallel test run a thread pool in every worker oversubscribes the
    CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


BF16 = jnp.bfloat16
FWD_REL = 3e-2        # a bf16 forward, scaled by max(1, max|ref|)
DRIVER_RTOL = 5e-2    # a two-epoch bf16 driver run against JAX's
FP32_RTOL = 0.2       # and against the port's fp32 run


def assert_bf16_close(actual, expected):
    expected = np.asarray(expected, np.float32)
    actual = np.asarray(actual, np.float32)
    scale = max(1.0, float(np.abs(expected).max()))
    assert np.isfinite(actual).all()
    np.testing.assert_allclose(actual, expected, rtol=0,
                               atol=FWD_REL * scale)


def _split(d, partition, L=1, s=12):
    write_charged_split(d, "valid" if partition == "val" else partition,
                        seed=2, s=s, f=55)
    kw = dict(partition=partition, num_inputs=L, num_timesteps=5)
    return JaxNBodyDataset(d, **kw), NBodyDataset(d, device="cpu", **kw)


def _egno(L=1, lr=1e-3):
    kw = dict(n_layers=2, hidden_nf=16, time_emb_dim=8, num_timesteps=5,
              num_modes=2, num_inputs=L, varDT=L > 1)
    jm = JaxEGNO(**kw)
    jexp = JaxEGNOExperiment(jm, lr=lr, weight_decay=1e-8,
                             compute_dtype=BF16)
    params, opt_state = jexp.init(jax.random.PRNGKey(0))
    model = EGNO(device="cpu", **kw)
    model.load_state_dict(egno_state_dict_from_jax_params(
        jax.tree.map(np.asarray, params), 2), strict=True)
    return jexp, params, opt_state, EGNOExperiment(
        model, lr=lr, weight_decay=1e-8, compute_dtype=torch.bfloat16)


def _segno(L=1, varDT=False, lr=1e-3):
    agg = "attn" if L > 1 else None
    jm = JaxSEGNO(hidden_nf=16, multiple_agg=agg)
    jexp = JaxSEGNOExperiment(jm, num_timesteps=5, lr=lr,
                              weight_decay=1e-12, compute_dtype=BF16)
    params, opt_state = jexp.init(jax.random.PRNGKey(1))
    model = SEGNO(hidden_nf=16, multiple_agg=agg, device="cpu")
    model.load_state_dict(segno_state_dict_from_jax_params(
        jax.tree.map(np.asarray, params)), strict=True)
    return jexp, params, opt_state, SEGNOExperiment(
        model, num_timesteps=5, varDT=varDT, lr=lr, weight_decay=1e-12,
        compute_dtype=torch.bfloat16)


def _assert_fp32_state(texp):
    for name, p in texp.model.named_parameters():
        assert p.dtype == torch.float32, name
    for state in texp.optimizer.state.values():
        assert state["exp_avg"].dtype == torch.float32
        assert state["exp_avg_sq"].dtype == torch.float32


@pytest.mark.parametrize("L", [1, 3], ids=["single", "multi-varDT"])
def test_egno_loss_matches_jax_bf16(tmp_path, L):
    """EGNOExperiment._loss in bf16: the decoded positions of the forward
    and the per-frame losses, from crossed weights on one batch."""
    jds, tds = _split(tmp_path, "train", L)
    jexp, params, _, texp = _egno(L)
    idx_np = jexp.epoch_index_arrays(jds, np.random.RandomState(3))
    idx = np.arange(6)
    jb = jexp._batch((jds.loc, jds.vel, jds.charges, jds.edge_weights),
                     {k: jnp.asarray(v) for k, v in idx_np.items()},
                     jnp.asarray(idx))
    tb = texp._batch((tds.loc, tds.vel, tds.charges, tds.edge_weights),
                     {k: torch.from_numpy(v) for k, v in idx_np.items()},
                     torch.from_numpy(idx))
    cast = lambda a: a.astype(BF16)                          # noqa: E731
    jx, _, _ = jexp._forward(jax.tree.map(cast, params),
                             *map(cast, jb[:4]), jb[5], jb[6][:, :5])
    assert jx.dtype == BF16
    with torch.no_grad():
        p16, ins = texp._cast(None, tb[:4])
        tx, _, _ = texp._forward(*ins, tb[5], tb[6][:, :5], params=p16)
        assert tx.dtype == torch.bfloat16
        assert_bf16_close(tx.float(), np.asarray(jx, np.float32))
        loss, losses = texp._loss(tb)
    jloss, jlosses = jexp._loss(params, jb)
    assert loss.dtype == torch.float32
    assert_bf16_close(losses, jlosses)
    assert_bf16_close(loss, jloss)


@pytest.mark.parametrize("L,varDT", [(1, False), (3, False), (3, True)],
                         ids=["single", "multi", "dynamic"])
def test_segno_loss_matches_jax_bf16(tmp_path, L, varDT):
    """SEGNOExperiment._loss in bf16 against JAX's _loss (one input, three
    inputs at fixed offsets) and _loss_dynamic (per-batch segment lengths,
    which the port runs exactly)."""
    jds, tds = _split(tmp_path, "train", L)
    jexp, params, _, texp = _segno(L, varDT)
    rng = np.random.RandomState(5)
    perm, windows = texp.draw_epoch(tds, rng, 4)
    frames = windows[0]
    arrays = (jds.loc, jds.vel, jds.charges, jds.edge_weights)
    idx = perm[0]
    tb = texp.batch(tds, windows, 0, torch.from_numpy(idx))
    if varDT:
        jb = jexp._make_batch_dynamic(arrays, jnp.asarray(idx),
                                      jnp.asarray(frames))
        jloss = jexp._loss_dynamic(params, jb, jnp.diff(jnp.asarray(frames)),
                                   jexp.max_interior(jds))
    else:
        in_steps = tb[5]
        end = int(frames[-1]) + 5
        jb = jexp._make_batch(arrays, jnp.asarray(idx),
                              tuple(int(f) for f in frames), in_steps, end)
        jloss = jexp._loss(params, jb, in_steps)
    with torch.no_grad():
        loss, _ = texp._loss(tb)
    assert loss.dtype == torch.float32
    assert_bf16_close(loss, jloss)
    # the fp32 loss of the same batch is another number: the mode is on
    texp.compute_dtype = None
    with torch.no_grad():
        fp32, _ = texp._loss(tb)
    assert float(fp32) != float(loss)


def test_egno_epoch_matches_jax_bf16(tmp_path):
    """Three Adam-L2 steps in bf16 from crossed weights on the same batches:
    the per-batch losses against JAX's; the parameters and Adam's moments
    stay fp32."""
    jds, tds = _split(tmp_path, "train")
    jexp, params, opt_state, texp = _egno()
    rng = np.random.RandomState(9)
    perm = jax_make_perm(rng, len(jds), 4)
    idx_np = jexp.epoch_index_arrays(jds, rng)
    arrays = (jds.loc, jds.vel, jds.charges, jds.edge_weights)
    jp, _, jl, jlast = jexp.train_epoch(
        params, opt_state, arrays,
        {k: jnp.asarray(v) for k, v in idx_np.items()}, perm)
    tl, tlast = texp.train_epoch(tds, texp.windows(tds, rng, len(perm)),
                                 perm)
    assert jax.tree.leaves(jp)[0].dtype == jnp.float32
    assert_bf16_close(tl, jl)
    assert_bf16_close(tlast, jlast)
    _assert_fp32_state(texp)


@pytest.mark.parametrize("L,varDT", [(1, False), (3, True)],
                         ids=["single", "dynamic"])
def test_segno_epoch_matches_jax_bf16(tmp_path, L, varDT):
    """Three Adam-L2 steps in bf16: JAX's static epoch (one input) or its
    dynamic epoch (per-batch segment lengths) against the port's."""
    jds, tds = _split(tmp_path, "train", L)
    jexp, params, opt_state, texp = _segno(L, varDT)
    perm, windows = texp.draw_epoch(tds, np.random.RandomState(4), 4)
    arrays = (jds.loc, jds.vel, jds.charges, jds.edge_weights)
    if varDT:
        _, _, jl = jexp.train_epoch_dynamic(
            params, opt_state, arrays, perm, jnp.asarray(windows),
            jexp.max_interior(jds))
    else:
        frames, in_steps, _ = jexp.input_frames(jds, None)
        _, _, jl = jexp.train_epoch(params, opt_state, arrays, perm, frames,
                                    in_steps)
    tl, _ = texp.train_epoch(tds, windows, perm)
    assert_bf16_close(tl, jl)
    _assert_fp32_state(texp)


@pytest.mark.parametrize("model,extra", [
    ("egno", ()), ("egno", ("--num_inputs", "3", "--varDT", "true")),
    ("segno", ()), ("segno", ("--num_inputs", "3", "--varDT", "true"))],
    ids=["egno", "egno-multi-varDT", "segno", "segno-multi-varDT"])
def test_bf16_driver_matches_jax_and_stays_near_fp32(tmp_path, model, extra):
    """``--precision bf16`` through both drivers for two epochs from the
    JAX driver's seed-42 weights: every reported loss within rtol 5e-2 of
    JAX's bf16 run and within rtol 0.2 of the port's fp32 run; the test
    rollout (fp32 in both packages) is finite."""
    extra = ("--precision", "bf16", *extra)
    stem, (jres, _), (res, (best, test_loss, epoch)) = _run_both_drivers(
        tmp_path, model, "charged", extra)
    for key in ("train loss", "val loss", "test loss"):
        assert np.isfinite(res[key]).all(), key
        assert res[key] == pytest.approx(jres[key], rel=DRIVER_RTOL), key

    # the port's fp32 run from the same weights
    outf = tmp_path / "fp32"
    save_params(outf / "tiny" / f"{stem}.ckpt", _tiny_models(model, extra))
    fp32_argv = ["--model", model, "--only_test", "false", "--test_interval",
                 "1", "--traj_len", "2", "--config_by_file",
                 str(tmp_path / "tiny.json"), "--dataset", "charged",
                 *extra[2:], "--outf", str(outf), "--device", "cpu",
                 "--load_checkpoint", "true"]
    fbest, ftest, fepoch = tmain.main(tmain.get_args(fp32_argv))
    assert epoch == fepoch
    assert best == pytest.approx(fbest, rel=FP32_RTOL)
    assert test_loss == pytest.approx(ftest, rel=FP32_RTOL)
