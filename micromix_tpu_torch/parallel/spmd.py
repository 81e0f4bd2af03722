"""The tensor-parallel plan's check of a configuration.

Counterpart of ``micromix_tpu/parallel/spmd.py``'s
``tp_validate_config``; the rest of that module (TP v1: replicated o /
down over all-gathered inputs) is not ported yet (``ROADMAP.md``).
"""

from __future__ import annotations

from ..models.common import ModelConfig


def tp_validate_config(cfg: ModelConfig, tp: int) -> None:
    """ValueError naming the first head count or width ``tp`` does not
    divide (query and KV heads shard whole; the MLP rows shard evenly)."""
    for name in ("num_kv_heads", "num_heads", "intermediate_size"):
        v = getattr(cfg, name)
        if v % tp:
            raise ValueError(f"tp={tp} does not divide {name}={v}")


__all__ = ["tp_validate_config"]
