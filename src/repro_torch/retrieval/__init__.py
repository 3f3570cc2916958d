"""Host-side retrieval: the Sidebar flexible-op split at serving scale.

Embedding lookup, similarity search, and prompt assembly are flexible
host work; decode is the accelerator's static matrix work. This package
provides the host half: a deterministic toy embedding index over a
block-aligned chunked corpus (``index``) and the prompt-assembly
pipeline (``rag``). The paged server's ``submit_query``
(``repro_torch.launch.scheduler``) runs it between segment dispatches, so
retrieval for request N+1 overlaps the card's decode of active requests.
"""

from repro_torch.retrieval.index import (
    ChunkedCorpus,
    EmbeddingIndex,
    make_toy_corpus,
)
from repro_torch.retrieval.rag import RagPipeline, RagPrompt, RetrievedChunk

__all__ = [
    "ChunkedCorpus",
    "EmbeddingIndex",
    "make_toy_corpus",
    "RagPipeline",
    "RagPrompt",
    "RetrievedChunk",
]
