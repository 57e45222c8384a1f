"""tvretrieval_tpu_torch: the PyTorch / CUDA port of ``tvretrieval_tpu``.

The JAX package stays the reference; this package mirrors its layout
(``models/``, ``ops/``, ``retrieval/``) so each counterpart sits under the
same module name. Numpy-only host modules (``tvretrieval_tpu.data`` except
``device_corpus``, ``tvretrieval_tpu.evaluation``, ``tvretrieval_tpu.utils.io``)
are imported from the JAX package instead of copied: they pull in no JAX.

Ported so far: exact full-corpus XML retrieval (``retrieval.engine``) with
the hand-written CUDA video-score kernels (``csrc/video_score.cu``,
``ops.video_score``).

Precision: the reference holds float32 matmuls at full precision. PyTorch
already defaults matmuls to full float32 on the card, but lets cuDNN
convolutions run in TF32 and cuBLAS reduce bf16 products in bf16; both are
switched off here so the ConvSE conv and the bf16 similarity sweep keep
f32 accumulation (set once, on import, process-wide).
"""
import torch

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
torch.set_float32_matmul_precision("highest")

__version__ = "0.1.0"
