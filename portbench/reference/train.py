"""A plain training step: mixup, normalize and featurize, the train-mode
forward with dropout, binary cross-entropy and Adam, in float32.

Mixup (the reference's ``tfdataset.mix_up``, tfdataset.py:930-955): each
clip ``i`` of a batch takes ``l_i * one_i + (1 - l_i) * two_i``, with
``l_i`` a Beta(alpha, alpha) draw (the ratio of two Gamma(alpha) draws)
kept with probability ``chance`` and 0 otherwise; its label is ``one``'s
where ``l_i > 0.5`` and ``two``'s otherwise.  The draws are made from a
CUDA generator seeded as the program's is, in the order the program makes
them (the two Gamma draws, then the uniform draw), so both sides mix the
same clips by the same weights; the dropout masks likewise
(``layers.dropout``).

Adam (Kingma & Ba): ``m = b1 m + (1 - b1) g``, ``v = b2 v + (1 - b2) g^2``,
``p -= lr (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps)``.
"""

from __future__ import annotations

import torch

B1, B2, EPS = 0.9, 0.999, 1e-8


def mix(gen: torch.Generator, one: torch.Tensor, y_one: torch.Tensor,
        two: torch.Tensor, y_two: torch.Tensor, alpha: float,
        chance: float) -> tuple[torch.Tensor, torch.Tensor]:
    n = one.shape[0]
    a = torch.full((n,), float(alpha), device=gen.device)
    g1 = torch._standard_gamma(a, generator=gen)
    g2 = torch._standard_gamma(a, generator=gen)
    keep = torch.rand(n, generator=gen, device=gen.device) < chance
    lam = (g1 / (g1 + g2)) * keep.to(g1.dtype)
    x = one * lam[:, None] + two * (1.0 - lam[:, None])
    hard = (lam > 0.5).to(y_one.dtype)[:, None]
    return x, y_one * hard + y_two * (1.0 - hard)


def bce(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Binary cross-entropy on logits, the mean over labels and clips:
    ``max(z, 0) - z y + log(1 + exp(-|z|))``."""
    per = logits.clamp_min(0) - logits * y + torch.log1p(torch.exp(-logits.abs()))
    return per.mean()


class Adam:
    def __init__(self, params: dict, lr: float):
        self.params, self.lr, self.t = params, lr, 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self, grads: dict) -> None:
        self.t += 1
        c1, c2 = 1.0 - B1 ** self.t, 1.0 - B2 ** self.t
        for k, p in self.params.items():
            g = grads[k]
            self.m[k].mul_(B1).add_((1.0 - B1) * g)
            self.v[k].mul_(B2).add_((1.0 - B2) * g * g)
            p.sub_(self.lr * (self.m[k] / c1)
                   / (torch.sqrt(self.v[k] / c2) + EPS))


def loss_and_grads(forward, ctx, params: dict, buffers: dict,
                   x: torch.Tensor, y: torch.Tensor):
    """The logits, the loss and the gradient of every parameter, one
    forward and one backward."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    logits = forward(ctx, {**buffers, **leaves}, x)
    loss = bce(logits, y)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return logits.detach(), loss.detach(), dict(zip(leaves, grads))
