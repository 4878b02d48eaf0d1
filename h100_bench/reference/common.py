"""What the references of EGNO and SEGNO share: parameter drawing from
init bounds, the N-body input features, the conserved energy of the
charged system, and Adam with L2 weight decay.

Every function takes plain tensors and a name -> tensor dict of
parameters in the ``[out, in]`` layout of ``torch.nn.Linear``."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def linear_spec(name, fan_in, fan_out):
    """(name, shape, low, high) of a Linear's weight and bias, drawn
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)) as torch.nn.Linear draws them."""
    b = 1.0 / math.sqrt(fan_in)
    return [(f"{name}.weight", (fan_out, fan_in), -b, b),
            (f"{name}.bias", (fan_out,), -b, b)]


def draw(specs, k, generator, device):
    """K parameter sets {name: [K, *shape]} from ``specs``: one uniform
    draw of every value on ``device``, mapped per leaf onto its bounds."""
    total = sum(math.prod(shape) for _, shape, _, _ in specs)
    u = torch.rand((k, total), generator=generator, device=device,
                   dtype=torch.float32)
    out, off = {}, 0
    for name, shape, low, high in specs:
        n = math.prod(shape)
        out[name] = (low + (high - low) * u[:, off:off + n]).reshape(
            k, *shape)
        off += n
    return out


def linear(params, name, x):
    return F.linear(x, params[f"{name}.weight"], params[f"{name}.bias"])


def mlp2(params, name, x, last_act=False):
    """Linear, SiLU, Linear (and SiLU when ``last_act``) under
    ``name.0`` and ``name.2``."""
    y = linear(params, f"{name}.2", F.silu(linear(params, f"{name}.0", x)))
    return F.silu(y) if last_act else y


def node_edge_features(loc, vel, charges):
    """|v| [.., N, 1], the pair features [q_i q_j, |x_i - x_j|^2]
    [.., N, N, 2] and the pair products q_i q_j [.., N, N]."""
    speed = vel.norm(dim=-1, keepdim=True)
    qq = charges[..., :, None, 0] * charges[..., None, :, 0]
    diff = loc[..., :, None, :] - loc[..., None, :, :]
    dist = (diff * diff).sum(-1)
    return speed, torch.stack([qq, dist], dim=-1), qq


def complete_graph_mask(n, like):
    """[N, N] weights of the graph's edges, 1 off the diagonal, in the
    dtype and on the device of ``like``."""
    return 1.0 - torch.eye(n, device=like.device, dtype=like.dtype)


def charged_energy(loc, vel, qq):
    """K + U of the charged system: 0.5 sum |v|^2 + 0.5 sum_{i != j}
    q_i q_j / r_ij, over the last two axes of loc and vel."""
    kinetic = 0.5 * (vel * vel).sum((-1, -2))
    diff = loc[..., :, None, :] - loc[..., None, :, :]
    r = (diff * diff).sum(-1).sqrt()
    off = ~torch.eye(loc.shape[-2], dtype=torch.bool, device=loc.device)
    potential = 0.5 * torch.where(off, qq / r, 0.0).sum((-1, -2))
    return kinetic + potential


class AdamL2:
    """Adam with L2 weight decay (wd * p joins the gradient before the
    moments, not AdamW), the defaults of torch.optim.Adam: betas (0.9,
    0.999), eps 1e-8, bias-corrected moments."""

    def __init__(self, params, lr, weight_decay, betas=(0.9, 0.999),
                 eps=1e-8):
        self.lr, self.wd, self.eps = lr, weight_decay, eps
        self.b1, self.b2 = betas
        self.t = 0
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}

    def step(self, params, grads):
        """New parameters; ``grads`` None for a leaf that feeds no loss
        (it still decays)."""
        self.t += 1
        c1 = 1 - self.b1 ** self.t
        c2 = 1 - self.b2 ** self.t
        out = {}
        for k, p in params.items():
            g = grads[k] if grads[k] is not None else torch.zeros_like(p)
            g = g + self.wd * p
            self.m[k] = self.b1 * self.m[k] + (1 - self.b1) * g
            self.v[k] = self.b2 * self.v[k] + (1 - self.b2) * g * g
            denom = (self.v[k] / c2).sqrt() + self.eps
            out[k] = p - self.lr * (self.m[k] / c1) / denom
        return out

