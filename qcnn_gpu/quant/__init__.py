from qcnn_gpu.quant.params import LayerQuant, QuantTable  # noqa: F401
from qcnn_gpu.quant.solver import (  # noqa: F401
    solve_mul_shift,
    solve_mul_shift_float,
    solve_layer,
    solve_concat,
    solve_last,
    solve_network,
    stepw_from_weights,
    BLU_INIT,
)
