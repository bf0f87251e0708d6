"""MCTS tree node (host-side bookkeeping).

Parity with the reference implementation's trainer/agent.py:136-192 (Node): PUCT stats,
per-node step dict, chat messages, tool context, latent-bank linkage and
prune state. Backup propagates the *search* value (state_value mix or
terminal true reward) to the root.

A copy of ``lapha_tpu/search/node.py`` (host code; importing the JAX
package's ``search`` would pull in jax).
"""

from __future__ import annotations

import math
from typing import Any, Optional


class Node:
    __slots__ = (
        "parent", "depth", "children", "P", "N", "W", "Q",
        "step", "messages", "context",
        "hid", "hid_idx", "cluster_id", "disabled",
        "v_pred", "state_value", "is_terminal", "expand_calls",
    )

    def __init__(
        self,
        parent: Optional["Node"],
        p_prior: float,
        step: dict[str, Any],
        messages: list[dict[str, Any]],
        context: dict[str, Any],
        depth: int,
    ):
        self.parent = parent
        self.depth = depth
        self.children: list[Node] = []
        self.P = float(p_prior)
        self.N = 0
        self.W = 0.0
        self.Q = 0.0
        self.step = step
        self.messages = messages
        self.context = context

        self.hid = step.get("hid")
        self.hid_idx = step.get("hid_idx")
        self.cluster_id = step.get("cluster_id")
        self.disabled = bool(step.get("disabled", False))

        self.v_pred = step.get("v_pred")
        self.state_value = step.get("state_value")
        self.is_terminal = False
        self.expand_calls = int(step.get("expand_calls", 0))

    def u_score(self, c_puct: float, total_n: int) -> float:
        return c_puct * self.P * math.sqrt(total_n) / (1 + self.N)

    def backup(self, value: float) -> None:
        node: Optional[Node] = self
        while node is not None:
            node.N += 1
            node.W += value
            node.Q = node.W / node.N
            node = node.parent
