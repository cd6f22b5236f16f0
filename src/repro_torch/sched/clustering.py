"""Availability filtering + capacity/stability clustering (port of
``repro/sched/clustering.py``; paper §4.1.1–2).

Eq. 1/2 split vehicles into resource-sufficient (train alone — plain FL
clients) and resource-limited (must join a cluster). Eq. 6 forms clusters
greedily by stability, subject to:
  c1: cluster memory  > M_cap,
  c2: cluster compute-over-dwell > e * alpha' * M_cmp,
  c3: cluster size bounded by the in-range neighbor set over the horizon.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.sched.costmodel import Vehicle


@dataclasses.dataclass(frozen=True)
class TrainingTask:
    m_cap: float       # model training footprint (bytes)
    m_cmp: float       # FLOPs per epoch
    e_req: int = 1     # required epochs
    alpha: float = 0.1  # min fraction of the task a participant must carry
    alpha_prime: float = 1.2   # fault-tolerance redundancy (Eq. 6 c2)


def availability_split(vehicles: Sequence[Vehicle], task: TrainingTask
                       ) -> Tuple[List[Vehicle], List[Vehicle], List[Vehicle]]:
    """Eq. 1/2: (resource_sufficient, resource_limited, unavailable)."""
    rs, rl, out = [], [], []
    for v in vehicles:
        # Eq. 1: dwl*cmp >= alpha * M_cmp * e_req to participate at all
        can_contribute = v.dwl * v.cmp >= \
            task.alpha * task.m_cmp * task.e_req
        if not can_contribute:
            out.append(v)
        elif v.dwl * v.cmp >= task.m_cmp * task.e_req and v.mem >= task.m_cap:
            rs.append(v)
        else:
            rl.append(v)
    return rs, rl, out


def form_cluster(seed: Vehicle, neighbors: Sequence[Vehicle],
                 task: TrainingTask, *,
                 stability: Optional[Dict[int, float]] = None,
                 max_size: Optional[int] = None) -> Optional[List[Vehicle]]:
    """Eq. 6: grow ``seed``'s cluster by descending neighbor stability until
    c1 (memory) and c2 (compute-over-dwell) hold; None if infeasible within
    c3 (size cap = in-range neighbor count)."""
    stability = stability or {}
    cand = sorted(neighbors, key=lambda v: -stability.get(v.vid, v.stb))
    cluster = [seed]
    cap = seed.mem
    cmp_dwl = seed.dwl * seed.cmp
    limit = max_size if max_size is not None else len(cand) + 1
    need_cmp = task.e_req * task.alpha_prime * task.m_cmp

    for v in cand:
        if cap > task.m_cap and cmp_dwl > need_cmp:
            break
        if len(cluster) >= limit:
            break
        cluster.append(v)
        cap += v.mem
        cmp_dwl += v.dwl * v.cmp
    if cap > task.m_cap and cmp_dwl > need_cmp and len(cluster) <= limit:
        return cluster
    return None


def cluster_fleet(vehicles: Sequence[Vehicle], task: TrainingTask, *,
                  stability: Optional[Dict[Tuple[int, int], float]] = None,
                  max_size: Optional[int] = None
                  ) -> Tuple[List[List[Vehicle]], List[Vehicle]]:
    """Partition resource-limited vehicles into clusters (each acting as one
    FL client, §4.1.2 end). Returns (clusters, leftover)."""
    rs, rl, _ = availability_split(vehicles, task)
    clusters: List[List[Vehicle]] = [[v] for v in rs]
    remaining = sorted(rl, key=lambda v: -v.stb)
    used: set = set()
    for seed in remaining:
        if seed.vid in used:
            continue
        nbrs = [v for v in remaining
                if v.vid != seed.vid and v.vid not in used]
        stb = None
        if stability is not None:
            stb = {v.vid: stability.get((seed.vid, v.vid), 0.0)
                   for v in nbrs}
        got = form_cluster(seed, nbrs, task, stability=stb,
                           max_size=max_size)
        if got is not None:
            clusters.append(got)
            used.update(v.vid for v in got)
    leftover = [v for v in remaining if v.vid not in used]
    return clusters, leftover
