"""Deterministic toy embedding index over a block-aligned chunked corpus
(a copy of ``repro.retrieval.index``: numpy only, so the port keeps its
own; the same seed gives the same corpus, embeddings and rankings).

The retrieval half of the RAG workload is deliberately a *toy* — no
learned encoder, no ANN structure — because what the serving stack
exercises is the SPLIT, not retrieval quality: retrieval is flexible
host work (numpy, data-dependent, cheap to change) feeding the
accelerator's static decode programs, exactly the Sidebar host/
accelerator division. Determinism is the one property the toy must
hold hard: the same query against the same corpus retrieves the same
chunks in the same order on every run, platform, and replica, because
assembled prompts feed bit-exactness tests downstream.

Three pieces:

  * ``make_toy_corpus`` — seeded synthetic documents (token arrays)
    with repeated per-document motifs, so queries built from a
    document's tokens genuinely rank its chunks first;
  * ``ChunkedCorpus`` — documents split into fixed-size chunks of
    ``chunk_tokens`` tokens each (the tail dropped, never padded).
    ``chunk_tokens`` is validated against the KV pool's ``block_size``
    by the pipeline layer: chunk boundaries MUST land on block
    boundaries for chunk-level KV sharing to be addressable;
  * ``EmbeddingIndex`` — seeded random-projection embeddings
    (bag-of-tokens -> fixed projection matrix -> L2 normalize) with
    exact top-k dot-product search, ties broken by chunk id so the
    ranking is a total order.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np


def make_toy_corpus(vocab_size: int, *, n_docs: int, doc_len: int,
                    seed: int = 0) -> list[np.ndarray]:
    """Seeded synthetic corpus: each document draws from its own narrow
    token band plus a per-document motif repeated throughout, so
    bag-of-token embeddings separate documents cleanly and a query made
    of one document's tokens retrieves that document's chunks."""
    rng = np.random.RandomState(seed)
    docs = []
    band = max(2, vocab_size // max(n_docs, 1))
    for d in range(n_docs):
        lo = (d * band) % max(vocab_size - band, 1)
        toks = rng.randint(lo, lo + band, size=doc_len)
        # the motif: every 4th token is the document's signature token
        toks[::4] = lo + (d % band)
        docs.append(np.asarray(toks, np.int32) % vocab_size)
    return docs


@dataclasses.dataclass(frozen=True)
class Chunk:
    """One corpus chunk: provenance plus its token content."""

    doc: int                  # document index in the corpus
    idx: int                  # chunk index within the document
    tokens: np.ndarray        # (chunk_tokens,) int32


class ChunkedCorpus:
    """Documents split into fixed ``chunk_tokens``-token chunks.

    The tail of a document shorter than one chunk is dropped — a
    partial chunk could never be block-aligned in an assembled prompt,
    and padding it would put pad tokens inside retrieved content.
    """

    def __init__(self, docs: list[np.ndarray], chunk_tokens: int) -> None:
        if chunk_tokens < 1:
            raise ValueError("chunk_tokens must be >= 1")
        self.chunk_tokens = int(chunk_tokens)
        self.chunks: list[Chunk] = []
        for d, doc in enumerate(docs):
            doc = np.asarray(doc, np.int32).reshape(-1)
            for i in range(doc.size // self.chunk_tokens):
                lo = i * self.chunk_tokens
                self.chunks.append(Chunk(
                    doc=d, idx=i,
                    tokens=doc[lo:lo + self.chunk_tokens].copy()))
        if not self.chunks:
            raise ValueError(
                f"no document holds a full chunk of {chunk_tokens} tokens")

    def __len__(self) -> int:
        return len(self.chunks)


class EmbeddingIndex:
    """Exact top-k dot-product search over seeded projection embeddings.

    The embedding of a token sequence is the L2-normalized sum of
    per-token projection rows — a bag-of-tokens map through one fixed
    ``(vocab, dim)`` matrix drawn from ``seed``. Deterministic by
    construction: no learned state, float64 accumulation, and a stable
    (score desc, chunk id asc) ranking, so every replica of a fleet
    ranks identically.

    ``io_latency_s`` models the chunk-payload fetch (disk/network)
    behind a real index that a CPU-resident toy corpus doesn't
    otherwise exhibit: each ``search`` sleeps that long with the GIL
    released, so an overlapped scheduler can hide the fetch behind
    in-flight decode while a serial one stalls on it. Default 0 —
    purely a bench/modeling knob, never ranking-relevant.
    """

    def __init__(self, corpus: ChunkedCorpus, *, vocab_size: int,
                 dim: int = 64, seed: int = 0,
                 io_latency_s: float = 0.0) -> None:
        self.corpus = corpus
        self.dim = int(dim)
        self.io_latency_s = float(io_latency_s)
        rng = np.random.RandomState(seed)
        self._proj = rng.standard_normal((int(vocab_size), self.dim))
        self._emb = np.stack([self.embed(c.tokens)
                              for c in corpus.chunks])   # (n_chunks, dim)

    def embed(self, tokens: np.ndarray) -> np.ndarray:
        """(dim,) float64 unit vector for a token sequence."""
        toks = np.asarray(tokens, np.int64).reshape(-1)
        v = self._proj[toks].sum(axis=0)
        n = np.linalg.norm(v)
        return v / n if n > 0 else v

    def search(self, query_tokens: np.ndarray,
               k: int) -> list[tuple[int, float]]:
        """Exact top-k: ``[(chunk_id, score), ...]`` by descending
        dot-product score, chunk id ascending on ties."""
        if k < 1:
            raise ValueError("k must be >= 1")
        k = min(k, len(self.corpus))
        if self.io_latency_s > 0:
            time.sleep(self.io_latency_s)   # modeled payload fetch
        scores = self._emb @ self.embed(query_tokens)
        # stable sort on (-score, id): exact, total, deterministic
        order = np.lexsort((np.arange(scores.size), -scores))[:k]
        return [(int(i), float(scores[i])) for i in order]
