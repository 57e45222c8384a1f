"""Feature sources, example building, batch pipelines and the synthetic
world (the port's copies of the JAX package's ``data``)."""
from tvretrieval_tpu_torch.data.features import (
    FeatureSource,
    MemoryFeatureSource,
    H5FeatureSource,
)
from tvretrieval_tpu_torch.data.datasets import (
    CorpusIndex,
    ExampleBuilder,
    StartEndBatch,
    train_st_ed_label,
    eval_st_ed_label,
    tef_features,
)
from tvretrieval_tpu_torch.data.pipeline import BatchIterator, DevicePrefetcher
from tvretrieval_tpu_torch.data.synthetic import make_synthetic_world, SyntheticWorld

__all__ = [
    "FeatureSource",
    "MemoryFeatureSource",
    "H5FeatureSource",
    "CorpusIndex",
    "ExampleBuilder",
    "StartEndBatch",
    "train_st_ed_label",
    "eval_st_ed_label",
    "tef_features",
    "BatchIterator",
    "DevicePrefetcher",
    "make_synthetic_world",
    "SyntheticWorld",
]
