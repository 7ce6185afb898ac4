"""Collaborative learning at the consumer edge: FedAvg + DP + SecAgg
(PyTorch port of ``repro.training.federated``).

Implements the paper's Privacy pillar (Table 1) end-to-end:

* **FedAvg** rounds over heterogeneous edge clients (the orchestrator
  schedules which devices participate — see ``core.orchestrator``).
* **Differential privacy** (McMahan et al., ICLR'18): per-client update
  clipping + Gaussian noise on the aggregate.
* **Secure aggregation** (Bonawitz et al.): pairwise PRG masks derived
  from shared seeds; masks cancel exactly in the sum, so the server only
  ever sees the aggregate.  (Key agreement itself is out of scope — the
  seed matrix stands in for the DH exchange.)

Local steps take plain autograd through ``models.model.loss_fn`` with
no kernel (no kernel has a backward, as no Pallas call has one).  Trees
are nested dicts walked in sorted key order (the JAX order).  Masks and
noise come from ``torch.Generator``s seeded as the JAX keys are seeded:
a pair's two clients draw the same mask from the same seed on the same
device, so the masks cancel in the sum; the draws are not JAX's.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Sequence

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M
from repro_torch.training import optimizer as opt

Params = Any


@dataclass(frozen=True)
class FedConfig:
    num_clients: int = 8
    clients_per_round: int = 4
    local_steps: int = 4
    local_lr: float = 0.05
    # differential privacy (0 disables)
    dp_clip: float = 0.0
    dp_noise_multiplier: float = 0.0
    # secure aggregation
    secure_aggregation: bool = False
    seed: int = 0


def _map(fn, *trees) -> Params:
    """``fn`` over the trees' leaves, zipped in ``tree_leaves`` order."""
    cols = zip(*(opt.tree_leaves(t) for t in trees))
    return opt.tree_unflatten(trees[0], [fn(*xs) for xs in cols])


# ---------------------------------------------------------------------------
# local training
# ---------------------------------------------------------------------------

def _sgd_step(cfg: ModelConfig, fcfg: FedConfig, p: Params, batch) -> Params:
    leaves = [x.detach().requires_grad_() for x in opt.tree_leaves(p)]
    with torch.enable_grad():
        loss = M.loss_fn(cfg, opt.tree_unflatten(p, leaves), batch)[0]
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g
             for x, g in zip(leaves, grads)]
    with torch.no_grad():
        return opt.sgd_update(p, opt.tree_unflatten(p, grads), fcfg.local_lr)


def local_update(cfg: ModelConfig, fcfg: FedConfig, params: Params,
                 batches: Sequence[dict]) -> Params:
    """Run local SGD steps; return the DELTA (new - old), float32."""
    p = params
    for b in batches[: fcfg.local_steps]:
        p = _sgd_step(cfg, fcfg, p, b)
    with torch.no_grad():
        return _map(lambda a, b: a.float() - b.float(), p, params)


# ---------------------------------------------------------------------------
# privacy mechanisms
# ---------------------------------------------------------------------------

def clip_update(delta: Params, clip: float) -> Params:
    norm = opt.global_norm(delta)
    factor = torch.clamp(clip / (norm + 1e-12), max=1.0)
    return _map(lambda x: x * factor, delta)


def add_gaussian_noise(tree: Params, sigma: float,
                       generator: torch.Generator) -> Params:
    """``tree`` plus ``sigma`` x standard normal float32 noise drawn
    from ``generator`` leaf by leaf (on the leaves' device)."""
    return _map(lambda x: x + sigma * torch.randn(
        x.shape, generator=generator, dtype=torch.float32, device=x.device),
        tree)


def _pair_mask(tree: Params, seed: int) -> Params:
    leaves = opt.tree_leaves(tree)
    gen = torch.Generator(device=leaves[0].device).manual_seed(seed)
    return opt.tree_unflatten(tree, [
        torch.randn(x.shape, generator=gen, dtype=torch.float32,
                    device=x.device) for x in leaves])


def secagg_mask(tree: Params, client: int, others: Sequence[int],
                round_seed: int) -> Params:
    """Sum of pairwise masks for ``client``: +mask(i,j) if i<j else -."""
    masked = tree
    for other in others:
        if other == client:
            continue
        i, j = min(client, other), max(client, other)
        seed = (round_seed * 1_000_003 + i * 1009 + j) % (2 ** 31)
        mask = _pair_mask(tree, seed)
        sign = 1.0 if client == i else -1.0
        masked = _map(lambda a, m: a + sign * m, masked, mask)
    return masked


# ---------------------------------------------------------------------------
# federated round
# ---------------------------------------------------------------------------

def fed_round(cfg: ModelConfig, fcfg: FedConfig, params: Params,
              client_batches: dict[int, Sequence[dict]], round_idx: int,
              *, generator: Optional[torch.Generator] = None
              ) -> tuple[Params, dict]:
    """One FedAvg round over the given clients' local data.  The DP noise
    comes from ``generator`` (default: seeded ``fcfg.seed + round_idx``
    on the parameters' device)."""
    clients = sorted(client_batches)
    deltas = {}
    for c in clients:
        d = local_update(cfg, fcfg, params, client_batches[c])
        with torch.no_grad():
            if fcfg.dp_clip:
                d = clip_update(d, fcfg.dp_clip)
            if fcfg.secure_aggregation:
                d = secagg_mask(d, c, clients,
                                round_seed=fcfg.seed + round_idx)
        deltas[c] = d

    with torch.no_grad():
        # server only ever computes the SUM (SecAgg masks cancel here)
        total = _map(lambda *xs: sum(xs), *deltas.values())
        del deltas
        avg = _map(lambda x: x / len(clients), total)
        del total

        if fcfg.dp_clip and fcfg.dp_noise_multiplier:
            sigma = fcfg.dp_noise_multiplier * fcfg.dp_clip / len(clients)
            if generator is None:
                dev = opt.tree_leaves(avg)[0].device
                generator = torch.Generator(device=dev).manual_seed(
                    fcfg.seed + round_idx)
            avg = add_gaussian_noise(avg, sigma, generator)

        new_params = _map(lambda p, d: (p.float() + d).to(p.dtype),
                          params, avg)
        update_norm = float(opt.global_norm(avg))
    return new_params, {"clients": clients, "update_norm": update_norm}
