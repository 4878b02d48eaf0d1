"""Device times of the pairwise-chain kernels #1 and #2 of one tree, one
weight set, at the main paths' shapes, on one NVIDIA GPU.

    python scripts/time_pairwise_kernels.py [--root DIR] [--label NAME]

``--root`` names the tree whose ``nonode_tpu_torch`` is built and timed
(default: this repository), so that two trees (a change and its parent,
unpacked with ``git archive``) can be compared in one call, in turns:
parent, change, change, parent. Shapes and inputs are chip_smoke.py's: the
EGNO slice (G=2560, N=5, H=64, E=2) and SEGNO's (G=256, the per-edge clip
engaged). Each time is the median of 50 calls by CUDA events
(``chip_smoke.device_ms``). Prints one JSON line with the card's name and
power limit, ``digest``: the sha256 of both kernels' outputs at H=64 on
those inputs, on a 31-node sparse graph with E=1 and on a 2-seed weight
stack, and ``h128_digest``: the same at H=128 at EGNO's serving shape,
without and with the clip, so that two trees that must give the same bits
can be held to them.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", type=Path, default=REPO)
    ap.add_argument("--label", default="tree")
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
    out["digest"] = h64_digest(chip_smoke, egnn_fused, dev)
    out["h128_digest"] = h128_digest(chip_smoke, egnn_fused, dev)
    print(json.dumps(out), flush=True)


def h64_digest(chip_smoke, egnn_fused, dev):
    """sha256 of #1's and #2's outputs at H=64: the slice shape, SEGNO's
    with the clip, N=31 with E=1 on a sparse mask with a lone node, and two
    stacked weight sets over G = 2 x 128."""
    return outputs_digest(chip_smoke, egnn_fused, dev, 64, (
        (2560, 5, 2, False, {}), (256, 5, 2, True, {"coord_scale": 400.0}),
        (60, 31, 1, False, {"isolated": 3}), (256, 5, 2, False, {"seeds": 2})))


def h128_digest(chip_smoke, egnn_fused, dev):
    """sha256 of #1's and #2's outputs at H=128 at EGNO's serving shape
    (G=2560, N=5, E=2), without and with the clip engaged."""
    return outputs_digest(chip_smoke, egnn_fused, dev, 128, (
        (2560, 5, 2, False, {}), (2560, 5, 2, True, {"coord_scale": 400.0})))


def outputs_digest(chip_smoke, egnn_fused, dev, h, cases):
    """sha256 of #1's and #2's outputs at width ``h`` on ``cases``, each
    (G, N, E, clip_edges, extra inputs: ``seeds`` stacks two weight sets)."""
    digest = hashlib.sha256()
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
        with torch.no_grad():
            outs = list(egnn_fused.pairwise_message(clip, x, hi, hj, efea,
                                                    mask, weights))
        dx, dhi, dhj, defea, dw = egnn_fused.pairwise_message_bwd(
            clip, x, hi, hj, efea, mask, weights, *cot)
        for t in (*outs, dx, dhi, dhj, defea, *dw):
            digest.update(t.contiguous().cpu().numpy().tobytes())
    return digest.hexdigest()


if __name__ == "__main__":
    main()
