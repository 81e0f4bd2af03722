"""Parallel forwards and serving over ``torch.distributed``.

Counterpart of ``micromix_tpu/parallel/``: one process per rank
(``launch.spawn``), each with a ``mesh.RankGroup`` for the mesh axis the
JAX program names (``mesh.axis_groups`` for a 2-D layout).

  * tensor parallelism v2 for dense models (``tp_quant``, ``tp_hetero``,
    ``tp_serve``: column-parallel q/k/v/gate/up, row-parallel o / down
    with one f32 sum each), served by one engine a rank;
  * expert parallelism for Mixtral (``moe_ep``, ``ep_serve``: one f32 sum
    per MoE block), served the same way;
  * tensor parallelism v1 (``spmd``: replicated o / down over
    all-gathered inputs, the batch over "data");
  * pipeline parallelism (``pp``: layer stages, microbatches handed on
    by ``ppermute``);
  * sequence parallelism (``sp``: K/V all-gathered, a ring of
    ``ppermute``s, or Ulysses' ``all_to_all``s);
  * data parallelism over whole engines (``replicas``: ``ReplicaRouter``,
    the serving router over R replicas of P TP / EP ranks, on disjoint
    rank groups), with the HTTP server in front (``api_ranks.serve_http``).
"""

from .ep_serve import (make_ep_engine, make_ep_step_fns, quantize_model_ep,
                       shard_params_ep, stack_layer_experts)
from .launch import spawn
from .mesh import RankGroup, axis_groups, pick_backend
# the JAX package's mesh constructors: a rank's groups on each axis of a layout
# (``make_mesh(group, data=, expert=, seq=, model=)``,
# ``make_pp_mesh(group, stage=n)``)
make_mesh = make_pp_mesh = axis_groups
from .moe_ep import (ep_moe_forward, ep_moe_forward_hetero,
                     ep_moe_forward_quant, stack_dense_experts,
                     stack_hetero_experts, stack_quant_experts)
from .api_ranks import serve_http
from .pp import pipeline_parallel_forward, stack_layers
from .replicas import ReplicaRouter
from .sp import sequence_parallel_forward, sp_forward_local
from .spmd import (shard_quantized_params, sharded_quantized_forward,
                   tp_validate_config)
from .tp_hetero import (quantize_model_tp_hetero, shard_params_tp_hetero,
                        sharded_forward_tp_hetero,
                        split_site_calibration_hetero)
from .tp_quant import (quantize_model_tp, shard_params_tp, sharded_forward_tp,
                       split_site_calibration)
from .tp_serve import make_tp_engine, make_tp_step_fns

__all__ = [
    "spawn", "RankGroup", "axis_groups", "pick_backend", "make_mesh",
    "make_pp_mesh", "tp_validate_config",
    "shard_quantized_params", "sharded_quantized_forward", "stack_layers",
    "pipeline_parallel_forward", "sequence_parallel_forward",
    "sp_forward_local",
    "quantize_model_tp", "shard_params_tp", "sharded_forward_tp",
    "split_site_calibration",
    "quantize_model_tp_hetero", "shard_params_tp_hetero",
    "sharded_forward_tp_hetero", "split_site_calibration_hetero",
    "make_tp_engine", "make_tp_step_fns",
    "ep_moe_forward", "ep_moe_forward_quant", "ep_moe_forward_hetero",
    "stack_dense_experts", "stack_quant_experts", "stack_hetero_experts",
    "make_ep_engine", "make_ep_step_fns", "quantize_model_ep",
    "shard_params_ep", "stack_layer_experts", "ReplicaRouter", "serve_http",
]
