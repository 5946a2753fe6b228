"""Interop with the reference PyTorch stack: checkpoint conversion in both
directions (reference ``.pth.tar`` state dicts to the port's and back,
:mod:`.torch_convert`), the deployment ONNX artifact (:mod:`.onnx_export`)
and a numpy executor for it (:mod:`.onnx_exec`)."""
from .onnx_export import export_guided_onnx, read_onnx_summary, selftest_guided_onnx
from .torch_convert import (
    convert_guided_state_dict,
    convert_unguided_state_dict,
    load_pth_tar,
    save_pth_tar,
    strip_data_parallel_prefix,
    to_guided_state_dict,
    to_unguided_state_dict,
)

__all__ = [
    "convert_guided_state_dict",
    "export_guided_onnx",
    "read_onnx_summary",
    "selftest_guided_onnx",
    "convert_unguided_state_dict",
    "load_pth_tar",
    "save_pth_tar",
    "strip_data_parallel_prefix",
    "to_guided_state_dict",
    "to_unguided_state_dict",
]
