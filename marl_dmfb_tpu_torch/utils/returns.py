"""TD(lambda) targets (JAX ``utils/returns.py``; the reference's
``td_lambda_target``, common/utils.py:33-79, a COMA leftover that its main
path does not call, kept for the utility surface).

The semantics are the reference's: n-step returns masked by padding,
bootstrapping gated by ``1 - terminated``, lambda-mixing with the final
tail term; computed as a reverse loop over T, as the JAX package's reverse
``lax.scan``, instead of the reference's O(T^2) loops.
"""

from __future__ import annotations

import torch


def td_lambda_target(batch: dict, q_targets: torch.Tensor, gamma: float,
                     td_lambda: float, n_agents: int) -> torch.Tensor:
    """Lambda-returns (b, T, n_agents).

    ``batch`` holds ``r``, ``padded`` and ``terminated``, each (b, T, 1);
    ``q_targets`` is (b, T, n_agents).  Step by step backwards:
    ``G_t = mask_t * (r_t + gamma * ((1 - lambda) * q_t * (1 - term_t)
    + lambda * G_{t+1}))``, from ``G_T = q_{T-1} * (1 - term_{T-1})``,
    which makes ``G_{T-1}`` the one-step return exactly."""
    mask = (1.0 - batch["padded"].float()).expand(-1, -1, n_agents)
    not_term = (1.0 - batch["terminated"].float()).expand(-1, -1, n_agents)
    r = batch["r"].float().expand(-1, -1, n_agents)
    g = q_targets[:, -1] * not_term[:, -1]
    out = []
    for t in reversed(range(q_targets.shape[1])):
        one_step = q_targets[:, t] * not_term[:, t]
        g = mask[:, t] * (r[:, t] + gamma * ((1.0 - td_lambda) * one_step
                                             + td_lambda * g))
        out.append(g)
    return torch.stack(out[::-1], dim=1)
