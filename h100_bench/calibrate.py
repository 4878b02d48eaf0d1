"""The readings the limits of ``correct`` are set from, for one cell.

    python3 -m h100_bench.calibrate --workload <cell> --seeds 1-12 \\
        [--control-seeds 1-3]

For each seed of ``--seeds``: the program's set-up (which drives the
checked part of the cell's work) and the numbers compared against the
reference, as a run computes them (the lower readings). For each seed of
``--control-seeds``, with the same inputs: the control, the reference in
the program's place computed with TF32 products (the precision step below
the configuration's float32 with TF32 off), held to the references as
the program is; then each fault the mix can have (its ``faults``),
planted in the reference put in the program's place (the upper
readings). One JSON line a reading on standard output. No window is
measured: the checked work is all in the set-up.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import sys

import torch

from h100_bench import compare
from h100_bench import run as runner


@contextlib.contextmanager
def tf32():
    """TF32 products for float32 matrix products on the card."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def readings(manifest, cell, seeds, control_seeds, device, overrides=None):
    """Yield one dict a reading: the program's numbers on ``seeds``, the
    control's and each fault's on ``control_seeds``."""
    for seed in seeds:
        entry, ctx = runner.context(manifest, cell, seed, device, overrides)
        mix = runner.mix_module(entry["traffic"])
        cap = mix.release(mix.setup(ctx))
        if device.type == "cuda":
            torch.cuda.empty_cache()
        refs = compare.references(mix, cap)
        yield _reading(cell, seed, "program", mix.gaps(cap, refs, cap))
        if seed not in control_seeds:
            continue
        with tf32():
            got = mix.reference_run(cap)
        yield _reading(cell, seed, "control", mix.gaps(got, refs, cap))
        for name, fn in mix.faults(ctx.reference).items():
            got = mix.reference_run(cap, fn)
            yield _reading(cell, seed, name, mix.gaps(got, refs, cap))


def _reading(cell, seed, side, numbers):
    return dict(cell=cell, seed=seed, side=side,
                **{k: (v if isinstance(v, str) or math.isfinite(v) else None)
                   for k, v in numbers.items()})


def _seeds(text):
    out = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out += list(range(int(lo), int(hi or lo) + 1))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="1-12")
    ap.add_argument("--control-seeds", default="1-3")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("the readings are taken on the card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for r in readings(runner.load_manifest(), args.workload,
                      _seeds(args.seeds), set(_seeds(args.control_seeds)),
                      device):
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
