"""Model layer (torch counterpart of ``micromix_tpu.models``)."""

from .common import (DenseLinear, ModelConfig, QuantLinear, QuantSite,
                     project_all, rmsnorm, rope_inv_freq)
from .surgery import (SiteCalibration, default_calibration, quantize_layer,
                      quantize_linear, quantize_model, random_dense_params,
                      random_quantized_model, stack_layer_projections)
from .transformer import forward
from .checkpoint import load_params, save_params

__all__ = [
    "DenseLinear", "ModelConfig", "QuantLinear", "QuantSite", "project_all",
    "rmsnorm", "rope_inv_freq", "SiteCalibration", "default_calibration",
    "quantize_layer", "quantize_linear", "quantize_model",
    "random_dense_params", "random_quantized_model",
    "stack_layer_projections", "forward", "load_params", "save_params",
]
