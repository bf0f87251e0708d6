from .cluster import average_linkage_labels, cluster_and_select_disabled, frechet_center
from .latent_bank import LatentBank
from .mcts import MCTSAgent, dump_step
from .node import Node
from .tool_parse import parse_tool_calls
from .value_fn import ValueFunction

__all__ = [
    "average_linkage_labels",
    "cluster_and_select_disabled",
    "frechet_center",
    "LatentBank",
    "MCTSAgent",
    "dump_step",
    "Node",
    "parse_tool_calls",
    "ValueFunction",
]
