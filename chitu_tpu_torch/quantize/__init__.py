"""On-load quantization of the parameter tree (see `transforms`), and
AWQ calibration (`awq`)."""

from chitu_tpu_torch.quantize.transforms import (  # noqa: F401
    expand_fp8_scales_rowwise,
    fp8_act_roundtrip,
    is_packed_int4,
    merge_moe_gate_up,
    pack_int4_storage,
    quantize_llmint8,
    quantize_params,
    quantize_weight,
    unpack_int4_storage,
)
