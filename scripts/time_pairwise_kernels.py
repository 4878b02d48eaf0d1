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
power limit.
"""

from __future__ import annotations

import argparse
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
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
