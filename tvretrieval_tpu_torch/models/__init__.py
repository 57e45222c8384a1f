"""The models: XML, the MEE, CAL / MCN and ExCL baselines, and the RNN
encoder (the port of the JAX package's ``models``)."""
from tvretrieval_tpu_torch.models.cal import CALConfig, CALWithSub
from tvretrieval_tpu_torch.models.excl import ExCL, ExCLConfig
from tvretrieval_tpu_torch.models.mee import MEE, MEEConfig
from tvretrieval_tpu_torch.models.rnn import RNNEncoder
from tvretrieval_tpu_torch.models.xml import XML, XMLConfig

__all__ = [
    "XML", "XMLConfig",
    "MEE", "MEEConfig",
    "CALWithSub", "CALConfig",
    "ExCL", "ExCLConfig",
    "RNNEncoder",
]
