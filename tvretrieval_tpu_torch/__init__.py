"""tvretrieval_tpu_torch: the PyTorch / CUDA port of ``tvretrieval_tpu``.

The JAX package stays the reference; this package mirrors its layout
(``models/``, ``ops/``, ``data/``, ``training/``, ``retrieval/``,
``evaluation/``, ``utils/``) so each counterpart sits under the same module
name. It imports nothing of the JAX package, not even a module there that
imports no JAX: it keeps its own copy of the numpy-only host modules
(``data``, ``evaluation``, ``utils``). Only the tests import both.

Ported so far: full-corpus XML retrieval (``retrieval.engine``) in every
exact and int8 engine mode, with the hand-written CUDA video-score kernels
(``csrc/video_score.cu``, ``ops.video_score``), int8 span sweep
(``csrc/span_sim.cu``, ``ops.video_score``) and sorting top-k
(``csrc/topk_sort.cu``, ``ops.sort``), and XML training (``training.train_xml``,
``training.xml_trainer``) on host-built batches or on the GPU-resident
corpus (``data.device_corpus``) with the hand-written CUDA byte-row gather
(``csrc/gather.cu``, ``ops.gather``), and the stage-study entry point
(``profiling.engine_modes``) with the four study kernels that no engine
mode runs: fused gather + similarity (``csrc/gathered_sim.cu``,
``ops.gather``), fused banded top-N (``csrc/banded_topk.cu``, ``ops.topk``),
masked video scores and one-stream clip-major scores
(``csrc/masked_score.cu``, ``ops.video_score``, ``ops.fused_score``). Every
Pallas kernel of the JAX package now has its CUDA counterpart, and every
XML configuration of the JAX package runs here: the LSTM / GRU
(``models.rnn``) and CNN encoders, one-stream models, the ablations, both
span heads, and bf16 compute.

Precision: the reference holds float32 matmuls at full precision. PyTorch
already defaults matmuls to full float32 on the card, but lets cuDNN
convolutions run in TF32 and cuBLAS reduce bf16 products in bf16; both are
switched off here so the ConvSE conv and the bf16 similarity sweep keep
f32 accumulation (set once, on import, process-wide). cuDNN's recurrent
networks stay on, in float32 (TF32 off).
"""
import torch

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
torch.set_float32_matmul_precision("highest")

__version__ = "0.1.0"
