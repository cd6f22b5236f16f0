"""Model DAG + topological sort (port of ``repro/sched/graph.py``; paper
§4.1.3 "systematic model partitioning": nodes = modules, edges = data
dependencies).

The graph is built from the config, as the reference's is, so no model
is traced.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

from repro_torch.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class Node:
    name: str
    cap: float     # training memory footprint (bytes)
    cmp: float     # FLOPs per sample
    com: float     # output activation bytes per sample
    deps: tuple = ()


@dataclasses.dataclass
class ModelGraph:
    nodes: Dict[str, Node]

    def topo_sorted(self) -> List[Node]:
        """Kahn's algorithm; raises on cycles."""
        indeg = {n: 0 for n in self.nodes}
        for node in self.nodes.values():
            for _ in node.deps:
                indeg[node.name] += 1
        ready = sorted([n for n, k in indeg.items() if k == 0])
        out: List[Node] = []
        while ready:
            cur = ready.pop(0)
            out.append(self.nodes[cur])
            for node in sorted(self.nodes.values(), key=lambda x: x.name):
                if cur in node.deps:
                    indeg[node.name] -= 1
                    if indeg[node.name] == 0:
                        ready.append(node.name)
        if len(out) != len(self.nodes):
            raise ValueError("cycle in model graph")
        return out


def vision_encoder_graph(cfg: ModelConfig, *, tokens: int = 256,
                         dtype_bytes: int = 4) -> ModelGraph:
    """The paper's vision encoder DAG: RGB backbone + LiDAR backbone ->
    transformer encoder blocks -> query decoder (Eq. 7 components)."""
    d, f = cfg.d_model, cfg.d_ff
    train_mult = 10 * dtype_bytes / 4  # paper: train state ~10x params
    nodes: Dict[str, Node] = {}

    def add(name, params, flops, out_bytes, deps=()):
        nodes[name] = Node(name, params * train_mult, flops, out_bytes,
                           tuple(deps))

    proj_p = cfg.prefix_dim * d
    add("rgb_backbone", proj_p, 2 * proj_p * tokens,
        tokens * d * dtype_bytes)
    add("lidar_backbone", proj_p, 2 * proj_p * tokens,
        tokens * d * dtype_bytes)
    blk_p = 4 * d * d + 3 * d * f + 2 * d
    t2 = 2 * tokens  # fused multimodal stream
    for i in range(cfg.num_layers):
        deps = ("rgb_backbone", "lidar_backbone") if i == 0 \
            else (f"enc{i-1}",)
        add(f"enc{i}", blk_p,
            6 * blk_p * t2 + 4 * cfg.num_heads * cfg.hd * t2 * t2,
            t2 * d * dtype_bytes, deps)
    dec_p = 4 * d * d + (cfg.num_waypoints + 1) * d
    add("decoder", dec_p, 6 * dec_p * (cfg.num_waypoints + 1),
        (cfg.num_waypoints * 2 + cfg.num_light_classes) * dtype_bytes,
        (f"enc{cfg.num_layers-1}",))
    return ModelGraph(nodes)
