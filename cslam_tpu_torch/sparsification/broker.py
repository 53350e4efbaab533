"""Broker: choose which keyframe vertices to transmit to cover all
selected inter-robot edges.

Port of cslam_tpu/sparsification/broker.py (host-side Python, no device
work).

Capability parity with the reference broker
(Swarm-SLAM cslam/broker.py): per connected component, a minimum
vertex cover — exact for two robots (bipartite: maximum matching +
Konig's theorem), greedy 2-approximation for >2 robots — or the
randomized "simple dialog" strategy. Self-contained graph algorithms
(Hopcroft-Karp augmenting paths, Konig alternating BFS) instead of the
reference's networkx dependency; the graphs here are tiny (budget ~5
edges), so this is host-side Python by design.
"""

from collections import deque
from typing import Dict, List, Sequence, Set, Tuple

import numpy as np

from cslam_tpu_torch.utils.edges import EdgeInterRobot

Vertex = Tuple[int, int]  # (robot_id, keyframe_id)


def _connected_components(adjacency: Dict[Vertex, Set[Vertex]]):
    seen: Set[Vertex] = set()
    for start in adjacency:
        if start in seen:
            continue
        comp = set()
        stack = [start]
        while stack:
            v = stack.pop()
            if v in comp:
                continue
            comp.add(v)
            stack.extend(adjacency[v] - comp)
        seen |= comp
        yield comp


def _hopcroft_karp(left: List[Vertex],
                   adjacency: Dict[Vertex, Set[Vertex]]):
    """Maximum bipartite matching; returns dict right_vertex -> left_vertex
    plus left->right. Standard BFS/DFS augmenting-path phases."""
    INF = float("inf")
    match_l: Dict[Vertex, Vertex] = {}
    match_r: Dict[Vertex, Vertex] = {}

    def bfs():
        dist = {}
        queue = deque()
        for u in left:
            if u not in match_l:
                dist[u] = 0
                queue.append(u)
            else:
                dist[u] = INF
        found = False
        while queue:
            u = queue.popleft()
            for v in adjacency[u]:
                w = match_r.get(v)
                if w is None:
                    found = True
                elif dist.get(w, INF) == INF:
                    dist[w] = dist[u] + 1
                    queue.append(w)
        return found, dist

    def dfs(u, dist):
        for v in adjacency[u]:
            w = match_r.get(v)
            if w is None or (dist.get(w) == dist[u] + 1 and dfs(w, dist)):
                match_l[u] = v
                match_r[v] = u
                return True
        dist[u] = float("inf")
        return False

    while True:
        found, dist = bfs()
        if not found:
            break
        for u in list(left):
            if u not in match_l:
                dfs(u, dist)
    return match_l, match_r


def _konig_cover(left: List[Vertex], right: List[Vertex],
                 adjacency: Dict[Vertex, Set[Vertex]]) -> Set[Vertex]:
    """Minimum vertex cover of a bipartite graph from a maximum matching:
    cover = (L \\ Z) | (R & Z) with Z the vertices reachable from
    unmatched left vertices by alternating paths."""
    match_l, match_r = _hopcroft_karp(left, adjacency)
    z: Set[Vertex] = set(u for u in left if u not in match_l)
    queue = deque(z)
    while queue:
        u = queue.popleft()
        for v in adjacency[u]:
            if match_l.get(u) == v:
                continue  # only traverse non-matching edges L->R
            if v not in z:
                z.add(v)
                w = match_r.get(v)
                if w is not None and w not in z:
                    z.add(w)
                    queue.append(w)
    return (set(left) - z) | (set(right) & z)


def _greedy_cover(edges: Sequence[Tuple[Vertex, Vertex]]) -> Set[Vertex]:
    """Greedy max-degree vertex cover for the >2-robot case (replaces
    networkx min_weighted_vertex_cover at broker.py:107-109). Every pick
    covers at least one uncovered edge, so |cover| <= |edges| — and
    high-degree-first keeps it close to minimum on the small matching
    graphs produced by budgeted selection."""
    uncovered = set(range(len(edges)))
    incidence: Dict[Vertex, Set[int]] = {}
    for idx, (u, v) in enumerate(edges):
        incidence.setdefault(u, set()).add(idx)
        incidence.setdefault(v, set()).add(idx)
    cover: Set[Vertex] = set()
    while uncovered:
        best = max(incidence, key=lambda vtx: len(incidence[vtx] & uncovered))
        covered_now = incidence.pop(best) & uncovered
        if not covered_now:
            break
        cover.add(best)
        uncovered -= covered_now
    return cover


class Broker:
    """Decides which vertices' local descriptors to transmit."""

    def __init__(self, edges: Sequence[EdgeInterRobot],
                 robots_involved: Sequence[int]):
        self.edges = list(edges)
        involved: Set[int] = set()
        for e in self.edges:
            if e.robot0_id in robots_involved:
                involved.add(e.robot0_id)
            if e.robot1_id in robots_involved:
                involved.add(e.robot1_id)
        self.robots_involved_with_edges = sorted(involved)
        self.is_multi_robot_graph = len(involved) >= 2
        self.is_bipartite = len(involved) == 2

        self.adjacency: Dict[Vertex, Set[Vertex]] = {}
        self.graph_edges: List[Tuple[Vertex, Vertex]] = []
        if self.is_multi_robot_graph:
            for e in self.edges:
                v0 = (e.robot0_id, e.robot0_keyframe_id)
                v1 = (e.robot1_id, e.robot1_keyframe_id)
                if v0[0] in involved and v1[0] in involved:
                    self.adjacency.setdefault(v0, set()).add(v1)
                    self.adjacency.setdefault(v1, set()).add(v0)
                    self.graph_edges.append((v0, v1))

    def brokerage(self, use_vertex_cover: bool) -> List[Set[Vertex]]:
        if not self.is_multi_robot_graph:
            return []
        return self.vertex_cover() if use_vertex_cover else self.simple_dialog()

    def vertex_cover(self) -> List[Set[Vertex]]:
        """Min vertex cover per connected component (broker.py:84-110)."""
        covers = []
        side0 = self.robots_involved_with_edges[0]
        for comp in _connected_components(self.adjacency):
            comp_adj = {v: self.adjacency[v] & comp for v in comp}
            if self.is_bipartite:
                left = [v for v in comp if v[0] == side0]
                right = [v for v in comp if v[0] != side0]
                covers.append(_konig_cover(left, right, comp_adj))
            else:
                comp_edges = [(u, v) for (u, v) in self.graph_edges
                              if u in comp and v in comp]
                covers.append(_greedy_cover(comp_edges))
        return covers

    def simple_dialog(self) -> List[Set[Vertex]]:
        """One random endpoint per edge unless already covered
        (broker.py:112-129)."""
        vertices: Set[Vertex] = set()
        for e in self.edges:
            ev = [(e.robot0_id, e.robot0_keyframe_id),
                  (e.robot1_id, e.robot1_keyframe_id)]
            if ev[0] not in vertices and ev[1] not in vertices:
                vertices.add(ev[int(np.random.randint(2))])
        return [vertices]
