from qcnn_gpu.parallel.mesh import make_mesh, mesh_shape_for  # noqa: F401
from qcnn_gpu.parallel.spatial import (  # noqa: F401
    halo_exchange_rows,
    make_sharded_forward,
)
