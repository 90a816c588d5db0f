from qcnn_gpu.train.trainer import TrainConfig, Trainer, make_train_step  # noqa: F401
from qcnn_gpu.train.finetune import quant_finetune  # noqa: F401
