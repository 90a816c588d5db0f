from qcnn_gpu.data import model_files, yuv  # noqa: F401
