"""Model layer (torch counterpart of ``micromix_tpu.models``)."""

from .common import (DenseLinear, FakeQuantSite, Int8TurboLinear,
                     ModelConfig, QuantLinear, QuantSite, WeightOnlyLinear,
                     project_all, quantize_int_group, rmsnorm, rope_inv_freq)
from .surgery import (ATTN_IN, DOWN_IN, MLP_IN, O_IN, LayerCalib,
                      SiteCalibration, default_calibration,
                      identity_calibration, quantize_layer,
                      quantize_linear, quantize_model,
                      quantize_model_int8_turbo, quantize_model_weight_only,
                      random_dense_params, random_quantized_model,
                      stack_layer_projections)
from .hetero import quantize_model_hetero
from .transformer import forward
from .checkpoint import load_params, save_params

__all__ = [
    "DenseLinear", "ModelConfig", "QuantLinear", "QuantSite", "project_all",
    "FakeQuantSite", "Int8TurboLinear", "WeightOnlyLinear",
    "rmsnorm", "rope_inv_freq", "quantize_int_group", "SiteCalibration",
    "LayerCalib", "ATTN_IN", "O_IN", "MLP_IN", "DOWN_IN", "default_calibration",
    "identity_calibration",
    "quantize_layer", "quantize_linear", "quantize_model",
    "quantize_model_hetero", "quantize_model_weight_only",
    "quantize_model_int8_turbo",
    "random_dense_params", "random_quantized_model",
    "stack_layer_projections", "forward", "load_params", "save_params",
]
