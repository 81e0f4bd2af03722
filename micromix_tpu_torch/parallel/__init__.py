"""Tensor- and expert-parallel serving over ``torch.distributed``.

Counterpart of ``micromix_tpu/parallel/`` for serving: one process per
rank (``launch.spawn``), each with a ``mesh.RankGroup`` and its own
engine over its shard.  Tensor parallelism v2 for dense models
(``tp_quant``, ``tp_hetero``, ``tp_serve``: column-parallel q/k/v/gate/up,
row-parallel o / down with one f32 sum each) and expert parallelism for
Mixtral (``moe_ep``, ``ep_serve``: one f32 sum per MoE block).  TP v1
(``spmd``'s gathers), pipeline and sequence parallelism are not ported
(``ROADMAP.md``).
"""

from .ep_serve import (make_ep_engine, make_ep_step_fns, quantize_model_ep,
                       shard_params_ep, stack_layer_experts)
from .launch import spawn
from .mesh import RankGroup, pick_backend
from .moe_ep import (ep_moe_forward, ep_moe_forward_hetero,
                     ep_moe_forward_quant, stack_dense_experts,
                     stack_hetero_experts, stack_quant_experts)
from .spmd import tp_validate_config
from .tp_hetero import (quantize_model_tp_hetero, shard_params_tp_hetero,
                        sharded_forward_tp_hetero,
                        split_site_calibration_hetero)
from .tp_quant import (quantize_model_tp, shard_params_tp, sharded_forward_tp,
                       split_site_calibration)
from .tp_serve import make_tp_engine, make_tp_step_fns

__all__ = [
    "spawn", "RankGroup", "pick_backend", "tp_validate_config",
    "quantize_model_tp", "shard_params_tp", "sharded_forward_tp",
    "split_site_calibration",
    "quantize_model_tp_hetero", "shard_params_tp_hetero",
    "sharded_forward_tp_hetero", "split_site_calibration_hetero",
    "make_tp_engine", "make_tp_step_fns",
    "ep_moe_forward", "ep_moe_forward_quant", "ep_moe_forward_hetero",
    "stack_dense_experts", "stack_quant_experts", "stack_hetero_experts",
    "make_ep_engine", "make_ep_step_fns", "quantize_model_ep",
    "shard_params_ep", "stack_layer_experts",
]
