from qcnn_gpu.engine.runner import Engine, RunRecord  # noqa: F401
