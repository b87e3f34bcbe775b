"""Priority-queue sort orders (Sec. III-C).

A priority order maps per-job keys to a queue position: *head* (index 0) is
dispatched to private replicas first; offloading (both the initialization
prefix rule and ACD-triggered eviction) removes from the *tail*.

- SPT: shortest processing time at head  => longest jobs offloaded. The
  100 ms rounding penalty is a smaller fraction of long executions, and
  long jobs exploit public-cloud parallelism without hurting the makespan.
- HCF: highest public cost at head       => cheapest jobs offloaded.
"""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np

# A key function maps (P_private[J,M] sec, H[J,M] USD, stage or None) -> [J]
# keys; queues sort ascending so smaller key == closer to head.
KeyFn = Callable[[np.ndarray, np.ndarray, int | None], np.ndarray]


def spt_key(P_private: np.ndarray, H: np.ndarray,
            stage: int | None = None) -> np.ndarray:
    """Shortest Processing Time: key = (stage or total) private latency."""
    P = np.asarray(P_private, dtype=np.float64)
    return P[:, stage] if stage is not None else P.sum(axis=1)


def hcf_key(P_private: np.ndarray, H: np.ndarray,
            stage: int | None = None) -> np.ndarray:
    """Highest Cost First: key = -(stage or total) public cost."""
    Hm = np.asarray(H, dtype=np.float64)
    return -(Hm[:, stage] if stage is not None else Hm.sum(axis=1))


ORDERS: Dict[str, KeyFn] = {"spt": spt_key, "hcf": hcf_key}


def sort_queue(job_ids: np.ndarray, keys: np.ndarray) -> np.ndarray:
    """Stable ascending sort: returns job ids head-first."""
    job_ids = np.asarray(job_ids)
    return job_ids[np.argsort(np.asarray(keys)[job_ids], kind="stable")]
