"""Models of the port: step-1 ``NConvUNet``, step-2 ``GuidedDepthNet``."""
from .backend import on_card, resolve_device
from .fold import fold_batchnorm_state, maybe_fold
from .guided import GuidedDepthNet, border_mask
from .unguided import CONF_THRESHOLD, NConvUNet, Step1Unguided

__all__ = [
    "CONF_THRESHOLD", "GuidedDepthNet", "NConvUNet", "border_mask",
    "Step1Unguided", "fold_batchnorm_state", "maybe_fold", "on_card", "resolve_device",
]
