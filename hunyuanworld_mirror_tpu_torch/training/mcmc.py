"""MCMC splat strategy and selective Adam.

Port of hunyuanworld_mirror_tpu/training/mcmc.py (gsplat's MCMCStrategy,
"3D Gaussian Splatting as Markov Chain Monte Carlo", arXiv:2404.09591, and
its SelectiveAdam) on the fixed-capacity raw dict of training/splat_opt.py:

  * `compute_relocation`: the opacity and scales of a splat split into n
    copies, the binomial double loop collapsed into one (N, N_MAX) sum;
  * `sample_sources` + `mcmc_refine`: one refine, dying splats teleported
    onto live ones drawn in proportion to opacity, and the population grown
    by 5% into free slots. The draw and the relocation are two functions,
    so a caller can hand `mcmc_refine` the source ids it drew elsewhere;
  * `inject_position_noise`: covariance-shaped noise on near-dead splats
    after every optimizer step, its normal draws from a generator or given;
  * `SelectiveAdam`: Adam on the rows whose gradient is not all zero, no
    bias correction; the other rows keep their values and their moments.

Plain torch: the refine's work is a few gathers and scatters of the slot
array, the optimizer's a handful of elementwise passes.
"""

from math import comb
from typing import Dict, Optional

import torch

from ..ops.projection import quat_scale_to_covar

N_MAX = 51            # the most copies a relocation splits a source into
GROW_FACTOR = 1.05    # each refine grows the population by 5%
SPLAT_ROWS = ("means", "quats", "log_scales", "opacity_logits", "sh")


def _binom_table(device) -> torch.Tensor:
    return torch.tensor([[comb(n, k) if k <= n else 0.0 for k in range(N_MAX + 1)]
                         for n in range(N_MAX + 1)], dtype=torch.float32,
                        device=device)


def compute_relocation(opacities: torch.Tensor, scales: torch.Tensor,
                       ratios: torch.Tensor):
    """New (opacity, scales) for splats split into `ratios` copies:
    opacities (N,), scales (N, 3), ratios (N,) int >= 1.
    new_op = 1 - (1 - op)^(1/n); scales *= op / denom(n, new_op) with
    denom = sum_{j=1..n} C(n, j) (-1)^(j+1) new_op^j / sqrt(j)."""
    n = torch.clamp(ratios, 1, N_MAX).long()
    new_op = 1.0 - torch.pow(1.0 - opacities, 1.0 / n)
    js = torch.arange(1, N_MAX + 1, dtype=torch.float32, device=opacities.device)
    c_nj = _binom_table(opacities.device)[n][:, 1:]                 # (N, N_MAX)
    sign = torch.pow(-1.0, js + 1.0)
    terms = c_nj * sign * torch.pow(new_op[:, None], js) / torch.sqrt(js)
    denom = torch.sum(torch.where(js[None, :] <= n[:, None], terms, 0.0), dim=1)
    coeff = opacities / torch.clamp_min(denom, 1e-12)
    return new_op, scales * coeff[:, None]


def _healthy(raw: Dict, min_opacity: float):
    opac = torch.sigmoid(raw["opacity_logits"])
    alive = raw["alive"] > 0.5
    return opac, alive, alive & (opac > min_opacity)


@torch.no_grad()
def sample_sources(raw: Dict, min_opacity: float = 0.005,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """(N,) source ids drawn with replacement, each live splat above
    `min_opacity` in proportion to its opacity (the JAX function's
    categorical draw). With no such splat every slot is equally likely, as
    the JAX draw's equal logits make it."""
    opac, _, healthy = _healthy(raw, min_opacity)
    probs = torch.where(healthy, opac, 0.0)
    probs = probs + (probs.sum() == 0)
    return torch.multinomial(probs, probs.shape[0], replacement=True,
                             generator=generator)


@torch.no_grad()
def mcmc_refine(raw: Dict, sampled: torch.Tensor,
                min_opacity: float = 0.005) -> Dict:
    """One MCMC refine with the source ids `sampled` (sample_sources).

    Destinations: every live slot at or below `min_opacity` (teleported),
    plus the first n_grow = min(floor(n_alive (GROW_FACTOR - 1)), free)
    free slots in argsort order. A source fed by k destinations splits into
    k + 1 copies (compute_relocation), and the destinations copy its
    rescaled row. Returns a new dict; keys other than the splat rows and
    `alive` are the input's own tensors."""
    N = raw["means"].shape[0]
    opac, alive, healthy = _healthy(raw, min_opacity)
    dying = alive & ~healthy

    n_grow = torch.minimum(
        torch.floor(alive.sum().float() * (GROW_FACTOR - 1.0)).long(),
        (~alive).sum())
    free_rank = torch.argsort(alive.float(), stable=True)     # free slots first
    grow_dest = torch.zeros(N, dtype=torch.bool, device=alive.device)
    grow_dest[free_rank] = torch.arange(N, device=alive.device) < n_grow
    dest = dying | grow_dest

    # a source's ratio counts only the real destinations that drew it
    counts = torch.zeros(N, dtype=torch.long, device=alive.device).index_add_(
        0, sampled, dest.long())
    new_op, new_scales = compute_relocation(opac, torch.exp(raw["log_scales"]),
                                            counts + 1)
    new_op = torch.clamp(new_op, min_opacity, 1.0 - 1e-7)

    fed = counts > 0
    out = dict(raw)
    out["opacity_logits"] = torch.where(fed, torch.log(new_op / (1.0 - new_op)),
                                        raw["opacity_logits"].detach())
    out["log_scales"] = torch.where(
        fed[:, None], torch.log(torch.clamp_min(new_scales, 1e-12)),
        raw["log_scales"].detach())
    for k in SPLAT_ROWS:
        x = out[k].detach()
        m = dest.view((N,) + (1,) * (x.dim() - 1))
        out[k] = torch.where(m, x[sampled], x)
    out["alive"] = torch.where(dest, 1.0, raw["alive"])
    return out


@torch.no_grad()
def inject_position_noise(raw: Dict, scaler: float,
                          noise: Optional[torch.Tensor] = None,
                          generator: Optional[torch.Generator] = None) -> Dict:
    """means += Sigma (n * gate(1 - opacity) * scaler * alive), in place, so
    an optimizer holding raw["means"] keeps it; gate is a steep sigmoid
    around opacity 0.005, so only near-dead splats move. `noise` (N, 3)
    standard normal draws, else drawn from `generator`.

    Sigma is quat_scale_to_covar(raw["quats"], scales) with the raw quats
    as they are (WXYZ) read as XYZW, which is what the JAX function
    computes."""
    means = raw["means"]
    opac = torch.sigmoid(raw["opacity_logits"])
    covars = quat_scale_to_covar(raw["quats"], torch.exp(raw["log_scales"]))
    gate = torch.sigmoid(100.0 * ((1.0 - opac) - 0.995))
    if noise is None:
        noise = torch.randn(means.shape, generator=generator, device=means.device)
    noise = noise * gate[:, None] * scaler * raw["alive"][:, None]
    means.add_(torch.einsum("nij,nj->ni", covars, noise))
    return raw


class SelectiveAdam(torch.optim.Optimizer):
    """Visibility-masked Adam (gsplat SelectiveAdam; the JAX package's
    `selective_adam`). A row of a parameter is visible iff its gradient row
    is not all zero; visible rows take m = b1 m + (1 - b1) g,
    v = b2 v + (1 - b2) g^2, p -= lr m / (sqrt(v) + eps) with no bias
    correction, the others keep their values and moments. The moments sit
    in `state[p]` under Adam's names, exp_avg and exp_avg_sq."""

    def __init__(self, params, lr: float = 1e-3, betas=(0.9, 0.999),
                 eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            lr, (b1, b2), eps = group["lr"], group["betas"], group["eps"]
            for p in group["params"]:
                g = p.grad
                if g is None:
                    continue
                st = self.state[p]
                if not st:
                    st["exp_avg"] = torch.zeros_like(p)
                    st["exp_avg_sq"] = torch.zeros_like(p)
                vis = (g != 0).reshape(g.shape[0], -1).any(dim=1)
                vis = vis.view((-1,) + (1,) * (g.dim() - 1))
                m = torch.where(vis, b1 * st["exp_avg"] + (1 - b1) * g,
                                st["exp_avg"])
                v = torch.where(vis, b2 * st["exp_avg_sq"] + (1 - b2) * g * g,
                                st["exp_avg_sq"])
                st["exp_avg"], st["exp_avg_sq"] = m, v
                p.sub_(torch.where(vis, lr * m / (torch.sqrt(v) + eps), 0.0))
        return None
