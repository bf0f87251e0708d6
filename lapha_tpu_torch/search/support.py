"""Support-material loading shared by the MCTS and ReAct agents.

CSV tables (or raw text) -> context vars + description string
(reference agent.py:384-398 / rollout_jsonl.py:253-273).

A copy of ``lapha_tpu/search/support.py`` (host code; importing the JAX
package's ``search`` would pull in jax).
"""

from __future__ import annotations

from typing import Any


def read_support_material(table_paths) -> tuple[dict[str, Any], str]:
    if not table_paths:
        return {}, ""
    import pandas as pd

    material: dict[str, Any] = {}
    for i, path in enumerate(table_paths):
        try:
            material[f"df{i}"] = pd.read_csv(path)
        except Exception:
            with open(path) as f:
                material[f"tb{i}"] = f.read()
    lines = []
    for k, v in material.items():
        if isinstance(v, pd.DataFrame):
            lines.append(f"Var: {k}; Type: {type(v)}\n{v}\n{v.dtypes}")
        else:
            lines.append(f"Var: {k}; Type: {type(v)}\n{v}")
    return material, "\n".join(lines)
