from qcnn_gpu.models.topology import (  # noqa: F401
    QVRCNN_LAYERS,
    QVRCNN_CONCATS,
    LAYER_NAMES,
    LayerDef,
    RECEPTIVE_RADIUS,
    MACS_PER_PIXEL,
)
