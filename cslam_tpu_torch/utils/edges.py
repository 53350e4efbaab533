"""Edge containers for pose-graph / matching-graph bookkeeping.

Semantics follow the reference containers
(cslam/mac/utils.py:13 `Edge`,
cslam/algebraic_connectivity_maximization.py:8-30
`EdgeInterRobot` whose equality ignores the weight and is symmetric in the
two endpoints).
"""

from typing import NamedTuple


class Edge(NamedTuple):
    """Single-graph weighted edge (rekeyed node ids)."""

    i: int
    j: int
    weight: float


class EdgeInterRobot(NamedTuple):
    """Inter-robot loop-closure edge keyed by (robot_id, keyframe_id) pairs.

    Equality ignores the weight and is symmetric under swapping the two
    (robot, keyframe) endpoints — required by the candidate/fixed-edge
    bookkeeping (candidate removal matches edges regardless of weight).
    """

    robot0_id: int
    robot0_keyframe_id: int
    robot1_id: int
    robot1_keyframe_id: int
    weight: float

    def __eq__(self, other):
        return (
            (self.robot0_id == other.robot0_id)
            and (self.robot0_keyframe_id == other.robot0_keyframe_id)
            and (self.robot1_id == other.robot1_id)
            and (self.robot1_keyframe_id == other.robot1_keyframe_id)
        ) or (
            (self.robot0_id == other.robot1_id)
            and (self.robot0_keyframe_id == other.robot1_keyframe_id)
            and (self.robot1_id == other.robot0_id)
            and (self.robot1_keyframe_id == other.robot0_keyframe_id)
        )

    def __ne__(self, other):
        return not self.__eq__(other)

    def __hash__(self):
        # Symmetric hash consistent with the symmetric __eq__.
        a = (self.robot0_id, self.robot0_keyframe_id)
        b = (self.robot1_id, self.robot1_keyframe_id)
        return hash(frozenset((a, b)))


def edge_key(edge: EdgeInterRobot):
    """Canonical (lowest-robot-first) key for an inter-robot edge.

    Mirrors AlgebraicConnectivityMaximization.edge_key
    (cslam/algebraic_connectivity_maximization.py:75-89).
    """
    if edge.robot0_id < edge.robot1_id:
        return (edge.robot0_id, edge.robot0_keyframe_id, edge.robot1_id,
                edge.robot1_keyframe_id)
    return (edge.robot1_id, edge.robot1_keyframe_id, edge.robot0_id,
            edge.robot0_keyframe_id)


def replace_weight(edge, weight):
    """Return a copy of an Edge/EdgeInterRobot with a new weight."""
    if isinstance(edge, EdgeInterRobot):
        return EdgeInterRobot(edge.robot0_id, edge.robot0_keyframe_id,
                              edge.robot1_id, edge.robot1_keyframe_id, weight)
    if isinstance(edge, Edge):
        return Edge(edge.i, edge.j, weight)
    raise TypeError(f"unsupported edge type {type(edge)}")
