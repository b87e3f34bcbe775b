"""Greedy scheduling math (Alg. 1) — vectorized array programs.

Two mechanisms:
  * initialization offload: capacity prefix rule over T_max = sum_k I_k*C_max
  * apparent-closeness-to-deadline (ACD) sweep over a stage queue

Both are pure array programs (sort / cumsum / masks). The discrete-event
loop in ``simulator.py`` calls the numpy functions; the ``*_torch``
counterparts take tensors on any device and keep the same semantics
(stable sorts, first-index argmin ties).

Float prefix sums stay sequential: :func:`init_offload_torch` takes its
running sum on the host with numpy, because a parallel ``torch.cumsum``
on CUDA associates the additions differently and can flip a job that
sits exactly at the capacity edge.
"""
from __future__ import annotations

import numpy as np
import torch


# -- initialization phase (Alg. 1 lines 2-10) -----------------------------

def t_max(replicas: np.ndarray, c_max: float) -> float:
    """T_max = sum_k I_k * C_max: total private compute capacity."""
    return float(np.sum(replicas) * c_max)


def init_offload(C_total: np.ndarray, keys: np.ndarray, capacity: float) -> np.ndarray:
    """Capacity prefix rule.

    ``C_total[j]`` = estimated whole-job private runtime; ``keys[j]`` = the
    priority key (ascending = head first); jobs are kept in priority order
    while the running sum of C stays <= capacity, the rest (the tail) are
    offloaded.  Returns a boolean offload mask [J].
    """
    C_total = np.asarray(C_total, dtype=np.float64)
    order = np.argsort(np.asarray(keys), kind="stable")        # head first
    csum = np.cumsum(C_total[order])
    keep_sorted = csum <= capacity + 1e-12
    offload = np.ones(C_total.shape[0], dtype=bool)
    offload[order[keep_sorted]] = False
    return offload


def init_offload_torch(C_total: torch.Tensor, keys: torch.Tensor,
                       capacity) -> torch.Tensor:
    """Torch counterpart of :func:`init_offload`, batched over leading dims.

    ``C_total``/``keys`` are [..., J], ``capacity`` a scalar or [...]
    tensor. The stable sort runs where the tensors live; the float
    prefix sum runs on the host in numpy (sequential association, as the
    DES sums), and the mask comes back on the input's device.
    """
    order = torch.argsort(keys, dim=-1, stable=True)
    c_sorted = torch.take_along_dim(C_total, order, dim=-1)
    csum = np.cumsum(c_sorted.detach().cpu().numpy(), axis=-1)
    cap = torch.as_tensor(capacity, dtype=torch.float64).cpu().numpy()
    keep_np = csum <= np.asarray(cap)[..., None] + 1e-12
    keep_sorted = torch.from_numpy(keep_np).to(C_total.device)
    offload = torch.ones(C_total.shape, dtype=torch.bool,
                         device=C_total.device)
    return offload.scatter(-1, order, ~keep_sorted)


# -- ACD (Sec. III-B) ------------------------------------------------------

def acd_sweep(
    queue_P_stage: np.ndarray,
    path_remaining: np.ndarray,
    t: float,
    deadline: float,
    replicas: int,
) -> np.ndarray:
    """ACD for every job currently in one stage queue, in queue order.

    ACD_{l,j}(t) = D - ( t + sum_{y<j in Q_l} P^priv_{l,y} / I_l
                           + sum_{k in Gamma(l)} P^priv_{k,j} )

    ``queue_P_stage[i]`` = P^private of the i-th queued job *at this stage*;
    ``path_remaining[i]`` = critical-path latency from this stage (incl.)
    to the sink for that job.  Returns ACD values [Q].
    """
    P = np.asarray(queue_P_stage, dtype=np.float64)
    excl_prefix = np.concatenate([[0.0], np.cumsum(P)[:-1]])
    return deadline - (t + excl_prefix / max(replicas, 1)
                       + np.asarray(path_remaining, dtype=np.float64))


def acd_sweep_torch(queue_P_stage, path_remaining, t, deadline, replicas,
                    mask=None):
    """Torch counterpart of :func:`acd_sweep`; ``mask`` marks real entries
    in a fixed-size padded queue.

    Padded entries contribute no queue delay and return ACD=+inf. The
    arithmetic dtype follows the inputs (ints promote to float64), so a
    float64 queue reproduces the numpy function on the CPU. On CUDA the
    prefix sum is a parallel scan: use it where the ACD values feed no
    comparison that must agree bit for bit with the DES.
    """
    P = torch.as_tensor(queue_P_stage)
    if not P.is_floating_point():
        P = P.to(torch.float64)
    if mask is not None:
        P = P * torch.as_tensor(mask, device=P.device)
    csum = torch.cumsum(P, dim=-1)
    excl_prefix = csum - P
    rep = torch.clamp(torch.as_tensor(replicas, device=P.device), min=1)
    acd = deadline - (t + excl_prefix / rep
                      + torch.as_tensor(path_remaining, dtype=P.dtype,
                                        device=P.device))
    if mask is not None:
        acd = torch.where(torch.as_tensor(mask, device=P.device).bool(),
                          acd, torch.full_like(acd, float("inf")))
    return acd


def offload_negative_acd(acd: np.ndarray) -> np.ndarray:
    """Alg. 1 line 17: mask of queue positions to dispatch to public."""
    return np.asarray(acd) < 0.0


# -- provider selection (multi-cloud eviction target) ----------------------

def select_provider(selection_costs: np.ndarray) -> np.ndarray:
    """Cheapest feasible provider per (job, stage).

    ``selection_costs``: [P, ...] predicted billed cost per provider, +inf
    where infeasible (see ``ProviderPortfolio.np_selection_costs``). The
    eviction target is the argmin along the provider axis, ties broken by
    the lowest provider index.
    """
    return np.argmin(np.asarray(selection_costs), axis=0)


def select_provider_torch(selection_costs: torch.Tensor) -> torch.Tensor:
    """Torch counterpart of :func:`select_provider` (same first-min
    tie-break: ``torch.argmin`` returns the first minimal index)."""
    return torch.argmin(selection_costs, dim=0)
