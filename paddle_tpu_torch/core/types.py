"""Data type and variable-kind enums with numpy and torch mappings.

Counterpart of ``paddle_tpu/core/types.py``.  The enums are plain ints
with the values of ``torch_framework.proto`` (the schema is not imported
here, so the port runs without protobuf); bfloat16 maps to
``torch.bfloat16``.
"""
import numpy as np
import torch

try:
    import ml_dtypes

    _BF16 = np.dtype(ml_dtypes.bfloat16)
except ImportError:  # numpy has no bfloat16 of its own
    _BF16 = None


class DataType:
    """The proto's DataType values."""

    UNSET = 0
    FP32 = 1
    FP64 = 2
    INT32 = 3
    INT64 = 4
    BOOL = 5
    BF16 = 6
    FP16 = 7
    UINT8 = 8
    INT8 = 9
    INT16 = 10
    UINT32 = 11
    UINT64 = 12


class VarKind:
    """The proto's VarKind values."""

    DENSE = 0
    LOD_TENSOR = 1
    SELECTED_ROWS = 2
    READER = 3
    STEP_SCOPES = 4
    LOD_TENSOR_ARRAY = 5
    FETCH_LIST = 6
    FEED_MINIBATCH = 7
    RAW = 8
    LOD_RANK_TABLE = 9


_NP_TO_PROTO = {
    np.dtype(np.float32): DataType.FP32,
    np.dtype(np.float64): DataType.FP64,
    np.dtype(np.int32): DataType.INT32,
    np.dtype(np.int64): DataType.INT64,
    np.dtype(np.bool_): DataType.BOOL,
    np.dtype(np.float16): DataType.FP16,
    np.dtype(np.uint8): DataType.UINT8,
    np.dtype(np.int8): DataType.INT8,
    np.dtype(np.int16): DataType.INT16,
    np.dtype(np.uint32): DataType.UINT32,
    np.dtype(np.uint64): DataType.UINT64,
}
if _BF16 is not None:
    _NP_TO_PROTO[_BF16] = DataType.BF16
_PROTO_TO_NP = {v: k for k, v in _NP_TO_PROTO.items()}

_TORCH_TO_PROTO = {
    torch.float32: DataType.FP32,
    torch.float64: DataType.FP64,
    torch.int32: DataType.INT32,
    torch.int64: DataType.INT64,
    torch.bool: DataType.BOOL,
    torch.bfloat16: DataType.BF16,
    torch.float16: DataType.FP16,
    torch.uint8: DataType.UINT8,
    torch.int8: DataType.INT8,
    torch.int16: DataType.INT16,
    torch.uint32: DataType.UINT32,
    torch.uint64: DataType.UINT64,
}
_PROTO_TO_TORCH = {v: k for k, v in _TORCH_TO_PROTO.items()}

_STR_TO_PROTO = {
    "float32": DataType.FP32,
    "float64": DataType.FP64,
    "int32": DataType.INT32,
    "int64": DataType.INT64,
    "bool": DataType.BOOL,
    "bfloat16": DataType.BF16,
    "float16": DataType.FP16,
    "uint8": DataType.UINT8,
    "int8": DataType.INT8,
    "int16": DataType.INT16,
    "uint32": DataType.UINT32,
    "uint64": DataType.UINT64,
}


def np_dtype_to_proto(dtype):
    """numpy dtype / dtype string / torch dtype / proto int -> proto
    DataType int."""
    if isinstance(dtype, int):
        return dtype
    if isinstance(dtype, str):
        return _STR_TO_PROTO[dtype]
    if isinstance(dtype, torch.dtype):
        return _TORCH_TO_PROTO[dtype]
    return _NP_TO_PROTO[np.dtype(dtype)]


def proto_to_np_dtype(proto_dtype):
    if proto_dtype == DataType.BF16 and _BF16 is None:
        raise TypeError("bfloat16 has no numpy dtype without ml_dtypes; "
                        "use proto_to_torch_dtype")
    return _PROTO_TO_NP[proto_dtype]


def proto_to_torch_dtype(proto_dtype):
    return _PROTO_TO_TORCH[proto_dtype]


def dtype_is_floating(proto_dtype):
    return proto_dtype in (DataType.FP32, DataType.FP64, DataType.BF16,
                           DataType.FP16)
