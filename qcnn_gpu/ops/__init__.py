from qcnn_gpu.ops.requant import (  # noqa: F401
    blu_requant_i32,
    final_residual_i32,
    apply_residual_u8,
)
