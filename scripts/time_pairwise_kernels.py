"""Device times of the pairwise-chain kernels #1 and #2 of one tree, one
weight set, at the main paths' shapes, on one NVIDIA GPU.

    python scripts/time_pairwise_kernels.py [--root DIR] [--label NAME]
        [--routes]

``--root`` names the tree whose ``nonode_tpu_torch`` is built and timed
(default: this repository), so that two trees (a change and its parent,
unpacked with ``git archive``) can be compared in one call, in turns:
parent, change, change, parent. Shapes and inputs are chip_smoke.py's: the
EGNO slice (G=2560, N=5, H=64, E=2) and SEGNO's (G=256, the per-edge clip
engaged). Each time is the median of 50 calls by CUDA events
(``chip_smoke.device_ms``). ``--routes`` adds the tile routes' shapes
(``ROUTE_CASES``: #1 and #2 from H=64 with E=6 to H=1024, and #1 at
SEGNO's nf-200 serving shape), each the median of fewer calls, with the
bytes of scratch each #2 call takes on this card (``routes_scratch_bytes``)
and each #1 call's scratch and shared memory a block
(``routes_fwd_scratch_bytes``, ``routes_fwd_smem_bytes``; a tree whose
library has no ``egnn_pairwise_fwd_smem_bytes`` reports none). Prints one
JSON line with the card's name and power limit and three digests, so that
two trees that must give the same bits can be held to them: ``digest``,
the sha256 of both kernels' outputs at H=64 on those inputs, on a 31-node
sparse graph with E=1 and on a 2-seed weight stack; ``fwd_digest``, #1's
outputs at H=128 and H=256 at EGNO's serving shape (H=128 without and with
the clip);
``tiles_digest``, #2's outputs on its tile route at those shapes and at
the mocap shape (G=60, N=31, H=128, E=1, a sparse mask).
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]

# (label, kernel, G, N, H, E, clip_edges, calls timed): the routes other
# than H=64's, at chip_smoke.py's shapes (the mocap shape on a random sparse
# mask of about its density; SEGNO's nf-200 serving shape with the clip
# engaged)
ROUTE_CASES = (
    ("fwd H=128 mocap", "fwd", 60, 31, 128, 1, False, 50),
    ("fwd H=128 EGNO", "fwd", 2560, 5, 128, 2, False, 50),
    ("fwd H=96 EGNO", "fwd", 2560, 5, 96, 2, False, 50),
    ("fwd H=256 EGNO", "fwd", 2560, 5, 256, 2, False, 50),
    ("fwd H=512 EGNO", "fwd", 2560, 5, 512, 2, False, 10),
    ("fwd H=1024 EGNO", "fwd", 2560, 5, 1024, 2, False, 5),
    ("fwd E=6 H=64 EGNO", "fwd", 2560, 5, 64, 6, False, 50),
    ("fwd SEGNO nf200", "fwd", 256, 5, 200, 2, True, 50),
    ("bwd H=128 mocap", "bwd", 60, 31, 128, 1, False, 20),
    ("bwd H=128 EGNO", "bwd", 2560, 5, 128, 2, False, 20),
    ("bwd H=96 EGNO", "bwd", 2560, 5, 96, 2, False, 20),
    ("bwd H=256 EGNO", "bwd", 2560, 5, 256, 2, False, 20),
    ("bwd E=6 H=64 EGNO", "bwd", 2560, 5, 64, 6, False, 20),
    ("bwd H=512 EGNO", "bwd", 2560, 5, 512, 2, False, 5),
    ("bwd H=1024 EGNO", "bwd", 2560, 5, 1024, 2, False, 3),
)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", type=Path, default=REPO)
    ap.add_argument("--label", default="tree")
    ap.add_argument("--routes", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    sys.path.insert(0, str(args.root.resolve()))
    sys.path.append(str(REPO))
    import chip_smoke
    from nonode_tpu_torch.ops.kernels import egnn_fused

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"label": args.label, "root": str(args.root),
           "card": chip_smoke.card_line(),
           "module": egnn_fused.__file__}
    for name, g, clip, scale in (("slice", 2560, False, 1.0),
                                 ("segno", 256, True, 400.0)):
        x, hi, hj, efea, mask, weights = chip_smoke.pairwise_inputs(
            g, 5, 64, 2, seed=5, dev=dev, coord_scale=scale)
        rng = torch.Generator().manual_seed(g)
        cot = (torch.randn(g, 5, 3, generator=rng).to(dev),
               torch.randn(g, 5, 64, generator=rng).to(dev))
        with torch.no_grad():
            out[f"fwd_{name}_ms"] = chip_smoke.device_ms(
                lambda: egnn_fused.pairwise_message(
                    clip, x, hi, hj, efea, mask, weights), iters=50)
        out[f"bwd_{name}_ms"] = chip_smoke.device_ms(
            lambda: egnn_fused.pairwise_message_bwd(
                clip, x, hi, hj, efea, mask, weights, *cot), iters=50)
    if args.routes:
        out["routes_ms"] = route_times(chip_smoke, egnn_fused, dev)
        _, scratch_floats = egnn_fused._bind_bwd()
        out["routes_scratch_bytes"] = {
            label: 4 * scratch_floats(g, n, egnn_fused.padded_width(h), e, 1,
                                      n)
            for label, which, g, n, h, e, _, _ in ROUTE_CASES
            if which == "bwd"}
        out.update(fwd_route_bytes(egnn_fused))
    out["digest"] = h64_digest(chip_smoke, egnn_fused, dev)
    out["fwd_digest"] = fwd_digest(chip_smoke, egnn_fused, dev)
    out["tiles_digest"] = tiles_digest(chip_smoke, egnn_fused, dev)
    print(json.dumps(out), flush=True)


def fwd_route_bytes(egnn_fused):
    """Bytes of scratch and of shared memory a block of each #1 call of
    ROUTE_CASES on this card (the shared memory where the tree's library
    reports it)."""
    lib = egnn_fused.load(egnn_fused.SOURCE)
    _, scratch_floats = egnn_fused._bind_fwd()
    cases = [(label, g, n, h, e) for label, which, g, n, h, e, _, _ in
             ROUTE_CASES if which == "fwd"]
    out = {"routes_fwd_scratch_bytes": {
        label: 4 * scratch_floats(g, n, egnn_fused.padded_width(h), e, 1, n)
        for label, g, n, h, e in cases}}
    smem = getattr(lib, "egnn_pairwise_fwd_smem_bytes", None)
    if smem is not None:
        smem.argtypes = scratch_floats.argtypes
        smem.restype = ctypes.c_longlong
        out["routes_fwd_smem_bytes"] = {
            label: smem(g, n, egnn_fused.padded_width(h), e, 1, n)
            for label, g, n, h, e in cases}
    return out


def route_times(chip_smoke, egnn_fused, dev):
    """{label: ms} of ROUTE_CASES."""
    times = {}
    for label, which, g, n, h, e, clip, iters in ROUTE_CASES:
        x, hi, hj, efea, mask, weights = chip_smoke.pairwise_inputs(
            g, n, h, e, seed=g + n, dev=dev, isolated=3 if n > 5 else None,
            coord_scale=400.0 if clip else 1.0)
        rng = torch.Generator().manual_seed(g + h)
        cot = (torch.randn(g, n, 3, generator=rng).to(dev),
               torch.randn(g, n, h, generator=rng).to(dev))
        args = (clip, x, hi, hj, efea, mask, weights)
        with torch.no_grad():
            call = (lambda: egnn_fused.pairwise_message(*args)) \
                if which == "fwd" else \
                (lambda: egnn_fused.pairwise_message_bwd(*args, *cot))
            times[label] = chip_smoke.device_ms(call, iters=iters,
                                                warmup=2)
    return times


def h64_digest(chip_smoke, egnn_fused, dev):
    """sha256 of #1's and #2's outputs at H=64: the slice shape, SEGNO's
    with the clip, N=31 with E=1 on a sparse mask with a lone node, and two
    stacked weight sets over G = 2 x 128."""
    return outputs_digest(chip_smoke, egnn_fused, dev, 64, (
        (2560, 5, 2, False, {}), (256, 5, 2, True, {"coord_scale": 400.0}),
        (60, 31, 1, False, {"isolated": 3}), (256, 5, 2, False, {"seeds": 2})))


def fwd_digest(chip_smoke, egnn_fused, dev):
    """sha256 of #1's outputs at EGNO's serving shape (G=2560, N=5, E=2):
    H=128 without and with the clip engaged, H=256."""
    digest = hashlib.sha256()
    for h, clip, kw in ((128, False, {}), (128, True, {"coord_scale": 400.0}),
                        (256, False, {})):
        outputs_digest(chip_smoke, egnn_fused, dev, h,
                       ((2560, 5, 2, clip, kw),), digest, backward=False)
    return digest.hexdigest()


def tiles_digest(chip_smoke, egnn_fused, dev):
    """sha256 of #2's outputs on its tile route: H=128 at EGNO's serving
    shape without and with the clip, H=256 there, and H=128 at the mocap
    shape (G=60, N=31, E=1, a sparse mask with a lone node)."""
    digest = hashlib.sha256()
    for h, cases in ((128, ((2560, 5, 2, False, {}),
                            (2560, 5, 2, True, {"coord_scale": 400.0}),
                            (60, 31, 1, False, {"isolated": 3}))),
                     (256, ((2560, 5, 2, False, {}),))):
        outputs_digest(chip_smoke, egnn_fused, dev, h, cases, digest,
                       forward=False)
    return digest.hexdigest()


def outputs_digest(chip_smoke, egnn_fused, dev, h, cases, digest=None,
                   forward=True, backward=True):
    """sha256 of #1's and (or) #2's outputs at width ``h`` on ``cases``,
    each (G, N, E, clip_edges, extra inputs: ``seeds`` stacks two weight
    sets), added to ``digest`` when given."""
    digest = hashlib.sha256() if digest is None else digest
    for g, n, e, clip, kw in cases:
        kw = dict(kw)
        k = kw.pop("seeds", None)
        x, hi, hj, efea, mask, weights = chip_smoke.pairwise_inputs(
            g, n, h, e, seed=g + n, dev=dev, **kw)
        if k is not None:
            weights = tuple(torch.stack([w, 0.5 * w]) for w in weights)
        rng = torch.Generator().manual_seed(g + n)
        cot = (torch.randn(g, n, 3, generator=rng).to(dev),
               torch.randn(g, n, h, generator=rng).to(dev))
        outs = []
        if forward:
            with torch.no_grad():
                outs += list(egnn_fused.pairwise_message(
                    clip, x, hi, hj, efea, mask, weights))
        if backward:
            dx, dhi, dhj, defea, dw = egnn_fused.pairwise_message_bwd(
                clip, x, hi, hj, efea, mask, weights, *cot)
            outs += [dx, dhi, dhj, defea, *dw]
        for t in outs:
            digest.update(t.contiguous().cpu().numpy().tobytes())
    return digest.hexdigest()


if __name__ == "__main__":
    main()
