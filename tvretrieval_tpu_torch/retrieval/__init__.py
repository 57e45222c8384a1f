"""Whole-corpus retrieval: the resident engine and the streaming engine
(the port of the JAX package's ``retrieval``)."""
from tvretrieval_tpu_torch.retrieval.engine import (
    RetrievalConfig,
    CorpusCache,
    arrays_to_submission,
    encode_corpus,
    retrieve,
)
from tvretrieval_tpu_torch.retrieval.streaming import (
    HostCorpusCache,
    host_cache_from_device,
    streaming_score_query_batch,
)

__all__ = [
    "RetrievalConfig", "CorpusCache", "arrays_to_submission",
    "encode_corpus", "retrieve",
    "HostCorpusCache", "host_cache_from_device", "streaming_score_query_batch",
]
