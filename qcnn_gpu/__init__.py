"""qcnn_gpu — a bit-exact INT8 inference/training framework for QVRCNN, in JAX.

A JAX/XLA re-design of the capabilities of the reference CUDA/cuDNN engine
(binbinmeng/QCNN_GPU), running on NVIDIA GPUs: bit-exact integer-arithmetic
inference for the QVRCNN compressed-video restoration network, the
fixed-point quantization toolkit that produces its parameters, float
training / quantization-aware fine-tuning, and a scale-out engine over
device meshes.

Layering (bottom → top):
  quant/     fixed-point parameter solver + table IO
  models/    topology, NumPy integer oracle, JAX int8 model, float model
  ops/       exact integer requant epilogues
  parallel/  mesh construction, halo-exchange spatial sharding, DP
  data/      YUV420 IO, model-file formats, manifests, patch pipelines
  engine/    program cache, streaming runner, calibration, metrics log
  train/     float training + shadow-weight quant fine-tune (optax)
  native/    C++ host-side YUV/PSNR fast path (ctypes)
"""

__version__ = "0.1.0"

from qcnn_gpu.models.topology import QVRCNN_LAYERS, LayerDef  # noqa: F401
