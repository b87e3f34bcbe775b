"""Application DAGs: the paper's job model (Sec. II-A).

An application is a DAG of *stages* (serverless functions). Every job of an
application executes the same DAG; precedence edges constrain stage start
times. Each stage k has a fixed number of private-cloud replicas ``I_k`` and
a public-cloud memory configuration ``mem_mb`` (the M in the Lambda cost
model, Eqn. 1).

Structure queries (successors, topo order, descendants, ...) are cached on
first use: ``AppDAG`` is immutable, and the discrete-event simulator calls
these on every event, so the naive per-call edge scans were a measurable
hot-path cost. The ``naive_*`` module functions keep the original
O(E)-per-call implementations as the reference the caches are tested
against (``tests/test_apps.py``).
"""
from __future__ import annotations

import dataclasses
from functools import cached_property
from typing import Dict, List, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Stage:
    """One function/stage of an application."""

    name: str
    replicas: int = 1          # I_k: private-cloud replicas
    mem_mb: float = 1024.0     # public-cloud memory config (Lambda M)
    must_private: bool = False  # Omega_j: privacy-constrained stages


# -- reference implementations (uncached) --------------------------------
# These are the seed's original edge-scan queries. The cached properties on
# AppDAG must agree with them exactly; tests assert that.

def naive_successors(edges: Sequence[Tuple[int, int]], k: int) -> List[int]:
    return [v for (u, v) in edges if u == k]


def naive_predecessors(edges: Sequence[Tuple[int, int]], k: int) -> List[int]:
    return [u for (u, v) in edges if v == k]


def naive_sources(edges: Sequence[Tuple[int, int]], n: int) -> List[int]:
    has_pred = {v for (_, v) in edges}
    return [k for k in range(n) if k not in has_pred]


def naive_sinks(edges: Sequence[Tuple[int, int]], n: int) -> List[int]:
    has_succ = {u for (u, _) in edges}
    return [k for k in range(n) if k not in has_succ]


def naive_topo_order(edges: Sequence[Tuple[int, int]], n: int) -> List[int]:
    indeg = [0] * n
    for (_, v) in edges:
        indeg[v] += 1
    frontier = [k for k in range(n) if indeg[k] == 0]
    out: List[int] = []
    while frontier:
        k = frontier.pop()
        out.append(k)
        for v in naive_successors(edges, k):
            indeg[v] -= 1
            if indeg[v] == 0:
                frontier.append(v)
    return out


def naive_descendants(edges: Sequence[Tuple[int, int]], k: int) -> List[int]:
    seen, stack = set(), list(naive_successors(edges, k))
    while stack:
        v = stack.pop()
        if v not in seen:
            seen.add(v)
            stack.extend(naive_successors(edges, v))
    return sorted(seen)


@dataclasses.dataclass(frozen=True)
class AppDAG:
    """A serverless application: stages + precedence edges.

    ``edges`` are (src, dst) stage-index pairs; the DAG identifies the
    partial order in which stages must execute (Fig. 1).
    """

    name: str
    stages: Tuple[Stage, ...]
    edges: Tuple[Tuple[int, int], ...]

    def __post_init__(self):
        n = len(self.stages)
        for (u, v) in self.edges:
            if not (0 <= u < n and 0 <= v < n and u != v):
                raise ValueError(f"bad edge ({u},{v}) for {n} stages")
        order = self.topo_order()  # raises on cycles
        if len(order) != n:
            raise ValueError("DAG has a cycle")

    # -- structure -----------------------------------------------------
    @property
    def num_stages(self) -> int:
        return len(self.stages)

    @cached_property
    def replicas(self) -> np.ndarray:
        return np.array([s.replicas for s in self.stages], dtype=np.int64)

    @cached_property
    def mem_mb(self) -> np.ndarray:
        return np.array([s.mem_mb for s in self.stages], dtype=np.float64)

    @cached_property
    def must_private_mask(self) -> np.ndarray:
        return np.array([s.must_private for s in self.stages], dtype=bool)

    # -- cached adjacency ----------------------------------------------
    @cached_property
    def succ_lists(self) -> Tuple[Tuple[int, ...], ...]:
        """succ_lists[k] = successors of k, in edge order."""
        out: List[List[int]] = [[] for _ in range(self.num_stages)]
        for (u, v) in self.edges:
            out[u].append(v)
        return tuple(tuple(s) for s in out)

    @cached_property
    def pred_lists(self) -> Tuple[Tuple[int, ...], ...]:
        """pred_lists[k] = predecessors of k, in edge order."""
        out: List[List[int]] = [[] for _ in range(self.num_stages)]
        for (u, v) in self.edges:
            out[v].append(u)
        return tuple(tuple(p) for p in out)

    @cached_property
    def adjacency(self) -> np.ndarray:
        """[M, M] bool: adjacency[u, v] iff edge u -> v."""
        A = np.zeros((self.num_stages, self.num_stages), dtype=bool)
        for (u, v) in self.edges:
            A[u, v] = True
        return A

    @cached_property
    def source_ids(self) -> Tuple[int, ...]:
        return tuple(k for k in range(self.num_stages) if not self.pred_lists[k])

    @cached_property
    def sink_ids(self) -> Tuple[int, ...]:
        return tuple(k for k in range(self.num_stages) if not self.succ_lists[k])

    @cached_property
    def is_sink(self) -> np.ndarray:
        out = np.zeros(self.num_stages, dtype=bool)
        out[list(self.sink_ids)] = True
        return out

    @cached_property
    def topo(self) -> Tuple[int, ...]:
        """Topological order (same tie-breaking as the seed's Kahn loop)."""
        n = self.num_stages
        indeg = [len(self.pred_lists[k]) for k in range(n)]
        frontier = [k for k in range(n) if indeg[k] == 0]
        out: List[int] = []
        while frontier:
            k = frontier.pop()
            out.append(k)
            for v in self.succ_lists[k]:
                indeg[v] -= 1
                if indeg[v] == 0:
                    frontier.append(v)
        return tuple(out)

    @cached_property
    def descendant_masks(self) -> np.ndarray:
        """[M, M] bool: descendant_masks[k, d] iff d is reachable from k."""
        reach = self.adjacency.copy()
        # reverse-topo DP: reach[k] = A[k] | union of reach over successors
        for k in reversed(self.topo):
            for v in self.succ_lists[k]:
                reach[k] |= reach[v]
        return reach

    @cached_property
    def descendant_lists(self) -> Tuple[Tuple[int, ...], ...]:
        return tuple(tuple(np.flatnonzero(self.descendant_masks[k]))
                     for k in range(self.num_stages))

    # -- list-returning API (kept for callers; backed by caches) --------
    def successors(self, k: int) -> List[int]:
        return list(self.succ_lists[k])

    def predecessors(self, k: int) -> List[int]:
        return list(self.pred_lists[k])

    def sources(self) -> List[int]:
        return list(self.source_ids)

    def sinks(self) -> List[int]:
        return list(self.sink_ids)

    def topo_order(self) -> List[int]:
        return list(self.topo)

    def descendants(self, k: int) -> List[int]:
        """All stages reachable from k (excluding k)."""
        return list(self.descendant_lists[k])

    def with_replicas(self, counts: Sequence[int]) -> "AppDAG":
        """Same application with per-stage replica counts ``counts`` [M].

        The unit of a replica autoscaling sweep: structure, memory
        configs and privacy pins are shared, only the private pool sizes
        differ. Used by the DES replay of a ``replicas=`` scenario axis
        (the vector engine consumes the counts directly as data).
        """
        counts = [int(c) for c in counts]
        if len(counts) != self.num_stages:
            raise ValueError(
                f"replicas: expected {self.num_stages} per-stage counts "
                f"(M={self.num_stages}), got {len(counts)}")
        if any(c < 1 for c in counts):
            raise ValueError(f"replicas: counts must be >= 1, got {counts}")
        stages = tuple(dataclasses.replace(s, replicas=c)
                       for s, c in zip(self.stages, counts))
        return AppDAG(self.name, stages, self.edges)

    # -- ACD support (Sec. III-B) ---------------------------------------
    def longest_path_latency(self, latencies: np.ndarray) -> np.ndarray:
        """Per-stage critical-path remainder  sum_{k in Gamma(l)} P_k.

        ``latencies``: [..., M] per-stage latency (batched over jobs).
        Returns [..., M]: for each stage l, the latency along the
        longest-latency path from l to the sink(s), *including* stage l —
        the optimistic time-to-finish term of the ACD.
        """
        lat = np.asarray(latencies, dtype=np.float64)
        out = np.zeros_like(lat)
        for k in reversed(self.topo):
            succ = self.succ_lists[k]
            best = 0.0
            if succ:
                best = np.max(np.stack([out[..., v] for v in succ], axis=-1), axis=-1)
            out[..., k] = lat[..., k] + best
        return out

    def validate_schedule(
        self,
        start: np.ndarray,
        dur: np.ndarray,
        eps: float = 1e-9,
    ) -> bool:
        """Check precedence feasibility of per-(job,stage) start times."""
        start = np.asarray(start)
        dur = np.asarray(dur)
        for (u, v) in self.edges:
            if np.any(start[..., v] + eps < start[..., u] + dur[..., u]):
                return False
        return True


# -- canonical applications (Sec. V-A) ----------------------------------

def matrix_app(replicas: int = 2) -> AppDAG:
    """Matrix Processing: MM -> LU (compute-heavy ETL)."""
    return AppDAG(
        name="matrix",
        stages=(
            Stage("MM", replicas=replicas, mem_mb=2048.0),
            Stage("LU", replicas=replicas, mem_mb=2048.0),
        ),
        edges=((0, 1),),
    )


def video_app(replicas: int = 2) -> AppDAG:
    """Video Processing: EF -> {DO, RI} -> ME (Fig. 1)."""
    return AppDAG(
        name="video",
        stages=(
            Stage("EF", replicas=replicas, mem_mb=1024.0),
            Stage("DO", replicas=replicas, mem_mb=3008.0),
            Stage("RI", replicas=replicas, mem_mb=1024.0),
            Stage("ME", replicas=replicas, mem_mb=512.0),
        ),
        edges=((0, 1), (0, 2), (1, 3), (2, 3)),
    )


def image_app(replicas: int = 2) -> AppDAG:
    """Image Processing: Rotate -> Resize -> Compress (I/O heavy)."""
    return AppDAG(
        name="image",
        stages=(
            Stage("Rotate", replicas=replicas, mem_mb=2048.0),
            Stage("Resize", replicas=replicas, mem_mb=2048.0),
            Stage("Compress", replicas=replicas, mem_mb=2048.0),
        ),
        edges=((0, 1), (1, 2)),
    )


APPS: Dict[str, "AppDAG"] = {}
for _f in (matrix_app, video_app, image_app):
    _d = _f()
    APPS[_d.name] = _d
