"""Tensor ops of the port (NCHW, torch weight layouts)."""
from .conv_autograd import (
    conv3x3_residual_trainable,
    conv3x3_trainable,
    conv_transpose4x4s2_trainable,
)
from .convops import (
    conv2d,
    conv2d_input_grad,
    conv2d_input_grad_plain,
    conv2d_weight_grad,
    conv2d_weight_grad_plain,
    conv2d_wgrad,
    conv3x3,
    conv3x3_chain2,
    conv3x3_chain2_plain,
    conv3x3_plain,
    conv3x3s2_input_grad,
    conv3x3s2_input_grad_plain,
    conv_transpose2d,
    conv_transpose4x4s2,
    conv_transpose4x4s2_input_grad,
    conv_transpose4x4s2_input_grad_plain,
    conv_transpose4x4s2_plain,
    on_tensor_cores,
    on_thin,
)
from .nconv import (
    EPS_DEFAULT,
    POS_FNS,
    nconv2d,
    nconv2d_fused,
    nconv2d_fused_plain,
    nconv2d_trainable,
)
from .pool import max_pool2x2, max_pool_pair
from .resize import downscale_bilinear, resize_bilinear, resize_nearest

__all__ = [
    "EPS_DEFAULT", "POS_FNS", "conv2d", "conv2d_input_grad",
    "conv2d_input_grad_plain", "conv2d_weight_grad", "conv2d_weight_grad_plain",
    "conv2d_wgrad", "conv3x3", "conv3x3_chain2",
    "conv3x3_chain2_plain", "conv3x3_plain", "conv3x3_residual_trainable", "conv3x3_trainable",
    "conv3x3s2_input_grad", "conv3x3s2_input_grad_plain", "conv_transpose2d",
    "conv_transpose4x4s2", "conv_transpose4x4s2_input_grad",
    "conv_transpose4x4s2_input_grad_plain", "conv_transpose4x4s2_plain",
    "conv_transpose4x4s2_trainable", "downscale_bilinear",
    "max_pool2x2", "max_pool_pair", "nconv2d", "nconv2d_fused",
    "nconv2d_fused_plain", "nconv2d_trainable", "on_tensor_cores", "on_thin",
    "resize_bilinear", "resize_nearest",
]
