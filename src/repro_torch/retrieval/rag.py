"""RAG prompt assembly: query -> (system prefix + chunks + question)
(a copy of ``repro.retrieval.rag``).

``RagPipeline.assemble`` is the host-side flexible op the scheduler
runs between segment dispatches: embed the query, exact top-k search,
lay the retrieved chunks out block-aligned, and return the assembled
prompt plus per-chunk provenance. Everything here is plain numpy —
it never touches the accelerator, which is the point.

Layout rules (the chunk-addressing contract; the JAX package's
``docs/rag.md`` sets it out):

  * the system prefix is right-padded with ``pad_token`` to a multiple
    of ``block_size``, so the first retrieved chunk starts ON a block
    boundary;
  * ``chunk_tokens`` must be a multiple of ``block_size``, so every
    chunk covers whole blocks and chunk boundaries are block
    boundaries;
  * with ``canonical_order=True`` (default) retrieved chunks are laid
    out by ascending corpus chunk id rather than by score. Two queries
    whose retrieved sets overlap then share a *leading* run of chunks
    wherever their sorted sets agree — and leading runs are exactly
    what the KV chunk index can reuse, because a transformer block's
    KV depends on its whole preceding context, not just the chunk's
    own tokens. Score order is available (``canonical_order=False``)
    for workloads where chunk precedence matters more than KV reuse.

Provenance (``RetrievedChunk.offset``) records where each chunk landed
in the prompt; the scheduler uses ``RagPrompt.chunk_blocks`` to
account chunk-level KV hits against exactly the retrieved-chunk
blocks, not the system prefix or the question tail.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.retrieval.index import EmbeddingIndex


@dataclasses.dataclass(frozen=True)
class RetrievedChunk:
    """Provenance of one retrieved chunk inside an assembled prompt."""

    doc: int                  # source document
    idx: int                  # chunk index within the document
    chunk_id: int             # corpus-global chunk id
    score: float              # dot-product retrieval score
    offset: int               # token offset of the chunk in the prompt
    tokens: np.ndarray        # (chunk_tokens,) int32 — the content


@dataclasses.dataclass(frozen=True)
class RagPrompt:
    """One assembled prompt plus everything needed to audit it."""

    tokens: np.ndarray               # (S,) int32 — the full prompt
    chunks: tuple[RetrievedChunk, ...]
    query: np.ndarray                # (Q,) int32 — as submitted

    def chunk_blocks(self, block_size: int) -> list[int]:
        """Block indices (of the assembled prompt's block grid) covered
        by retrieved chunks — the denominator of chunk-reuse stats."""
        out = []
        for c in self.chunks:
            lo = c.offset // block_size
            hi = (c.offset + c.tokens.size) // block_size
            out.extend(range(lo, hi))
        return out


class RagPipeline:
    """Query -> assembled prompt, deterministically.

    >>> pipe = RagPipeline(index, system_prefix=[7, 8, 9],
    ...                    block_size=8, top_k=2)
    >>> rp = pipe.assemble([42, 43, 44])
    >>> rp.tokens           # [sys..pad][chunk][chunk][42, 43, 44]
    """

    def __init__(self, index: EmbeddingIndex, *, system_prefix,
                 block_size: int, top_k: int = 2, pad_token: int = 0,
                 canonical_order: bool = True) -> None:
        if top_k < 1:
            raise ValueError("top_k must be >= 1")
        bs = int(block_size)
        if bs < 1:
            raise ValueError("block_size must be >= 1")
        if index.corpus.chunk_tokens % bs:
            raise ValueError(
                f"chunk_tokens {index.corpus.chunk_tokens} must be a "
                f"multiple of block_size {bs}: chunk boundaries must "
                "land on KV block boundaries to be chunk-addressable"
            )
        self.index = index
        self.block_size = bs
        self.top_k = int(top_k)
        self.canonical_order = bool(canonical_order)
        sys_toks = np.asarray(system_prefix, np.int32).reshape(-1)
        pad = (-sys_toks.size) % bs
        self.system_prefix = np.concatenate(
            [sys_toks, np.full((pad,), int(pad_token), np.int32)])

    @property
    def prompt_len_for(self) -> int:
        """Assembled-prompt length minus the query length (the fixed
        part) — lets callers validate capacity before retrieval runs."""
        return (self.system_prefix.size
                + self.top_k * self.index.corpus.chunk_tokens)

    def retrieve(self, query) -> list[tuple[int, float]]:
        """The expensive half on its own: exact top-k search (plus the
        index's modeled payload fetch, if any). Pure function of the
        query — thread-safe over the read-only index, so a scheduler
        can run it on a background I/O worker and ``assemble`` later
        with the ranked result."""
        query = np.asarray(query, np.int32).reshape(-1)
        if query.size < 1:
            raise ValueError("empty query")
        return self.index.search(query, self.top_k)

    def assemble(self, query, *,
                 ranked: list[tuple[int, float]] | None = None
                 ) -> RagPrompt:
        """Retrieve and lay out: ``[system | chunks... | query]``.
        Pass ``ranked`` (a prior ``retrieve`` result for the SAME
        query) to skip the search and only lay out."""
        query = np.asarray(query, np.int32).reshape(-1)
        if query.size < 1:
            raise ValueError("empty query")
        if ranked is None:
            ranked = self.index.search(query, self.top_k)
        if self.canonical_order:
            # ascending chunk id: overlapping retrieval sets become
            # shared leading chunk runs — the shareable-KV layout
            ranked = sorted(ranked, key=lambda t: t[0])
        parts = [self.system_prefix]
        chunks = []
        offset = self.system_prefix.size
        for cid, score in ranked:
            c = self.index.corpus.chunks[cid]
            chunks.append(RetrievedChunk(
                doc=c.doc, idx=c.idx, chunk_id=cid, score=score,
                offset=offset, tokens=c.tokens))
            parts.append(c.tokens)
            offset += c.tokens.size
        parts.append(query)
        return RagPrompt(tokens=np.concatenate(parts).astype(np.int32),
                         chunks=tuple(chunks), query=query)
