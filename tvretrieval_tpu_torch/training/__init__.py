"""Training: the optimizer, the trainers and their CLIs (the port of the
JAX package's ``training``). ``BertAdam`` is the port's name for the JAX
package's ``bert_adam`` (an optax transformation there, a
``torch.optim.Optimizer`` here)."""
from tvretrieval_tpu_torch.training.optimization import (
    BertAdam,
    make_lr_multiplier,
    no_decay_mask,
)

__all__ = ["BertAdam", "make_lr_multiplier", "no_decay_mask"]
