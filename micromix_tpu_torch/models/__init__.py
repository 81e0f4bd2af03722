"""Model layer (torch counterpart of ``micromix_tpu.models``)."""

from .common import (DenseLinear, FakeQuantSite, Int8TurboLinear,
                     ModelConfig, QuantLinear, QuantSite, WeightOnlyLinear,
                     project_all, rmsnorm, rope_inv_freq)
from .surgery import (SiteCalibration, default_calibration,
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
    "rmsnorm", "rope_inv_freq", "SiteCalibration", "default_calibration",
    "identity_calibration",
    "quantize_layer", "quantize_linear", "quantize_model",
    "quantize_model_hetero", "quantize_model_weight_only",
    "quantize_model_int8_turbo",
    "random_dense_params", "random_quantized_model",
    "stack_layer_projections", "forward", "load_params", "save_params",
]
