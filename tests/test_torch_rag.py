"""RAG serving in the port, held to the JAX package on the CPU.

Mirroring ``tests/test_rag.py``: the port's ``retrieval`` package equals
the JAX package's element for element (the corpus, the embeddings, the
ranking and its scores, the assembled tokens, provenance and
``chunk_blocks``); a RAG drain through ``submit_query`` gives the tokens
of plain ``submit`` of the same assembled prompts and of the JAX RAG
server on the same weights (``repro_torch.bridge``), with its retrieval
counters, on nemotron-4-15b and deepseek-v3-671b smoke (no-drop
capacity); distinct queries share chunk-addressed KV blocks; overlap on
and off give equal tokens, and so does a speculative RAG drain;
interior-hole splicing; ``submit_query``'s validation; and ``cancel`` of
a parked query.
"""

import dataclasses

import jax
import numpy as np
import pytest

from repro import configs as jcfg
from repro import retrieval as jret
from repro.launch.sampling import SamplingParams as JSP
from repro.launch.scheduler import PagedContinuousBatchingServer as JaxPaged
from repro.models.registry import get_model as jget
from repro_torch import bridge
from repro_torch import configs as tcfg
from repro_torch.launch.sampling import SamplingParams
from repro_torch.launch.scheduler import PagedContinuousBatchingServer
from repro_torch.launch.spec import SpecConfig
from repro_torch.retrieval import (
    ChunkedCorpus,
    EmbeddingIndex,
    RagPipeline,
    make_toy_corpus,
)

ARCHS = ["nemotron-4-15b", "deepseek-v3-671b"]
BS = 8
RAG_COUNTS = ("retrievals", "retrieval_overlapped", "retrieval_chunk_blocks",
              "retrieval_chunk_hits", "prefix_block_hits",
              "prefix_prompt_blocks", "chunk_interior_hits")
SAMPLES = [None, dict(temperature=0.8, seed=11), None,
           dict(temperature=1.1, top_k=20, seed=3), None]


def _cfgs(arch):
    cj, ct = jcfg.get_smoke_config(arch), tcfg.get_smoke_config(arch)
    if cj.num_experts:
        # no-drop capacity: co-scheduled rows must not change routing
        cj = dataclasses.replace(cj, capacity_factor=float(cj.num_experts))
        ct = dataclasses.replace(ct, capacity_factor=float(ct.num_experts))
    return cj, ct


@pytest.fixture(scope="module")
def models():
    """arch -> (JAX cfg, port cfg, JAX params, port params)."""
    out = {}
    for arch in ARCHS:
        cj, ct = _cfgs(arch)
        pj = jget(cj).init(jax.random.PRNGKey(0), cj)
        out[arch] = (cj, ct, pj, bridge.params_from_jax(
            jax.tree.map(np.asarray, pj), device="cpu"))
    return out


def _rag(vocab, lib=None, *, block_size=BS, top_k=2, chunk_tokens=BS,
         n_docs=4, doc_len=32, seed=0, **kw):
    """(docs, pipeline) from the port's package, or the JAX package's
    with ``lib=jret``."""
    corpus_fn, chunked, index_cls, pipe_cls = (
        (make_toy_corpus, ChunkedCorpus, EmbeddingIndex, RagPipeline)
        if lib is None else (lib.make_toy_corpus, lib.ChunkedCorpus,
                             lib.EmbeddingIndex, lib.RagPipeline))
    docs = corpus_fn(vocab, n_docs=n_docs, doc_len=doc_len, seed=seed)
    corpus = chunked(docs, chunk_tokens=chunk_tokens)
    index = index_cls(corpus, vocab_size=vocab, seed=seed)
    return docs, pipe_cls(index, system_prefix=[5, 6, 7],
                          block_size=block_size, top_k=top_k, **kw)


def _server(ct, pt, *, rag=None, **kw):
    kw.setdefault("num_slots", 2)
    kw.setdefault("max_len", 96)
    kw.setdefault("block_size", BS)
    kw.setdefault("prefill_chunk", BS)
    kw.setdefault("segment", 4)
    return PagedContinuousBatchingServer(ct, pt, device="cpu", rag=rag, **kw)


def _queries(docs, rng, n):
    """Queries from document content, concentrated on two documents, so
    the retrieved sets of distinct queries overlap."""
    out = []
    for _ in range(n):
        d = docs[rng.randint(len(docs) // 2)]
        lo = rng.randint(0, d.size - 6)
        out.append(d[lo:lo + rng.randint(3, 7)].copy())
    return out


@pytest.fixture(scope="module")
def jax_drains(models):
    """The JAX RAG server's drain of ``_queries(seed 7)`` per family:
    tokens by rid, the assembled prompts and the counters."""
    out = {}
    for arch in ARCHS:
        cj, _, pj, _ = models[arch]
        docs, pipe = _rag(cj.vocab_size, jret)
        srv = JaxPaged(cj, pj, rag=pipe, num_slots=2, max_len=96,
                       block_size=BS, prefill_chunk=BS, segment=4)
        qs = _queries(docs, np.random.RandomState(7), 5)
        rids = [srv.submit_query(q, 5, None if s is None else JSP(**s))
                for q, s in zip(qs, SAMPLES)]
        done = {r.rid: np.asarray(r.tokens) for r in srv.run()}
        out[arch] = ({rid: done[rid] for rid in rids},
                     {rid: srv.rag_results[rid].tokens for rid in rids},
                     {k: srv.stats[k] for k in RAG_COUNTS})
    return out


# ---------------------------------------------------------------------------
# The pipeline against the JAX package's (no model)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(), dict(top_k=3, n_docs=6, doc_len=48),
    dict(canonical_order=False, chunk_tokens=2 * BS, doc_len=64),
    dict(block_size=4, chunk_tokens=8, seed=5, pad_token=3)],
    ids=["default", "top3", "score_order", "block4"])
def test_retrieval_equals_jax(kw):
    vocab = 512
    docs, pipe = _rag(vocab, **kw)
    jdocs, jpipe = _rag(vocab, jret, **kw)
    for a, b in zip(docs, jdocs):
        np.testing.assert_array_equal(a, b)
    assert len(pipe.index.corpus) == len(jpipe.index.corpus)
    for a, b in zip(pipe.index.corpus.chunks, jpipe.index.corpus.chunks):
        assert (a.doc, a.idx) == (b.doc, b.idx)
        np.testing.assert_array_equal(a.tokens, b.tokens)
    np.testing.assert_array_equal(pipe.index._emb, jpipe.index._emb)
    np.testing.assert_array_equal(pipe.system_prefix, jpipe.system_prefix)
    assert pipe.prompt_len_for == jpipe.prompt_len_for
    rng = np.random.RandomState(1)
    for q in _queries(docs, rng, 6) + [np.asarray([1, 2, 3], np.int32)]:
        assert pipe.retrieve(q) == jpipe.retrieve(q)   # ids and scores
        a, b = pipe.assemble(q), jpipe.assemble(q)
        np.testing.assert_array_equal(a.tokens, b.tokens)
        np.testing.assert_array_equal(a.query, b.query)
        assert len(a.chunks) == len(b.chunks)
        for ca, cb in zip(a.chunks, b.chunks):
            assert ((ca.doc, ca.idx, ca.chunk_id, ca.score, ca.offset)
                    == (cb.doc, cb.idx, cb.chunk_id, cb.score, cb.offset))
            np.testing.assert_array_equal(ca.tokens, cb.tokens)
        assert a.chunk_blocks(pipe.block_size) == b.chunk_blocks(
            pipe.block_size)


def test_pipeline_deterministic_and_block_aligned():
    _, pipe1 = _rag(512)
    _, pipe2 = _rag(512)
    q = np.asarray([11, 12, 13], np.int32)
    a, b = pipe1.assemble(q), pipe2.assemble(q)
    np.testing.assert_array_equal(a.tokens, b.tokens)
    assert pipe1.system_prefix.size % BS == 0
    for c in a.chunks:
        assert c.offset % BS == 0 and c.tokens.size % BS == 0
        np.testing.assert_array_equal(
            a.tokens[c.offset:c.offset + c.tokens.size], c.tokens)
    np.testing.assert_array_equal(a.tokens[-q.size:], q)
    assert a.tokens.size == pipe1.prompt_len_for + q.size
    ids = [c.chunk_id for c in a.chunks]
    assert ids == sorted(ids)
    blocks = a.chunk_blocks(BS)
    assert len(blocks) == sum(c.tokens.size // BS for c in a.chunks)
    assert min(blocks) == pipe1.system_prefix.size // BS


def test_index_retrieves_own_document_first():
    docs, pipe = _rag(512, n_docs=4, doc_len=32)
    for d in range(4):
        ranked = pipe.index.search(docs[d][:8], 2)
        assert pipe.index.corpus.chunks[ranked[0][0]].doc == d


def test_alignment_validation_refuses_what_jax_refuses():
    for lib in (None, jret):
        chunked, index_cls, pipe_cls = (
            (ChunkedCorpus, EmbeddingIndex, RagPipeline) if lib is None
            else (lib.ChunkedCorpus, lib.EmbeddingIndex, lib.RagPipeline))
        docs = make_toy_corpus(512, n_docs=2, doc_len=32)
        index = index_cls(chunked(docs, chunk_tokens=6), vocab_size=512)
        with pytest.raises(ValueError, match="multiple of block_size"):
            pipe_cls(index, system_prefix=[1], block_size=8)
        with pytest.raises(ValueError, match="full chunk"):
            chunked([np.asarray([1, 2], np.int32)], chunk_tokens=8)
        with pytest.raises(ValueError, match="top_k"):
            pipe_cls(index_cls(chunked(docs, chunk_tokens=8),
                               vocab_size=512), system_prefix=[1],
                     block_size=8, top_k=0)


# ---------------------------------------------------------------------------
# The server
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_rag_drain_matches_plain_submit_and_jax(arch, models, jax_drains):
    """Greedy and sampled queries: the JAX RAG server's tokens, prompts
    and retrieval counters, and plain ``submit`` of the same prompts."""
    _, ct, _, pt = models[arch]
    want, want_prompts, jcounts = jax_drains[arch]
    docs, pipe = _rag(ct.vocab_size)
    srv = _server(ct, pt, rag=pipe)
    qs = _queries(docs, np.random.RandomState(7), 5)
    samples = [None if s is None else SamplingParams(**s) for s in SAMPLES]
    rids = [srv.submit_query(q, 5, s) for q, s in zip(qs, samples)]
    done = {r.rid: r for r in srv.run()}
    assert sorted(done) == sorted(rids) == sorted(want)
    for rid in rids:
        np.testing.assert_array_equal(srv.rag_results[rid].tokens,
                                      want_prompts[rid])
        np.testing.assert_array_equal(done[rid].tokens, want[rid],
                                      err_msg=f"{arch} rid {rid}: != JAX")
    assert {k: srv.stats[k] for k in RAG_COUNTS} == jcounts
    assert srv.stats.retrievals == len(qs)
    plain = _server(ct, pt)
    plain_rids = [plain.submit(srv.rag_results[rid].tokens, 5, s)
                  for rid, s in zip(rids, samples)]
    plain_done = {r.rid: r for r in plain.run()}
    for rid, prid in zip(rids, plain_rids):
        np.testing.assert_array_equal(
            done[rid].tokens, plain_done[prid].tokens,
            err_msg=f"{arch} rid {rid}: RAG drain != plain submit")
    assert srv.mgr.alloc.in_use == 0


def test_chunk_reuse_across_distinct_queries(models):
    """Distinct queries whose retrieved sets overlap splice each other's
    chunk blocks."""
    _, ct, _, pt = models["nemotron-4-15b"]
    docs, pipe = _rag(ct.vocab_size)
    srv = _server(ct, pt, rag=pipe)
    for q in (docs[0][:5], docs[0][10:16], docs[0][3:9]):
        srv.submit_query(q, 4)
    srv.run()
    st = srv.stats
    assert st.retrieval_chunk_blocks > 0
    assert st.retrieval_chunk_hits > 0, "no chunk-level reuse"
    assert 0 < st.retrieval_chunk_hit_rate <= 1
    assert st.prefix_prompt_blocks >= st.prefix_block_hits > 0
    assert "retrieval" in st.summary()


@pytest.mark.parametrize("spec", [False, True], ids=["plain", "spec"])
def test_overlap_on_off_token_equality(spec, models):
    """Overlapped retrieval (collected behind the in-flight segment or
    verify) and serial retrieval give equal tokens; the overlapped arm
    overlaps the queries that arrive mid-decode. The speculative path
    gives the plain path's tokens."""
    _, ct, _, pt = models["nemotron-4-15b"]
    tokens = {}
    for overlap in (True, False):
        docs, pipe = _rag(ct.vocab_size)
        srv = _server(ct, pt, rag=pipe, rag_overlap=overlap,
                      spec=SpecConfig(ct, pt, k=3) if spec else None)
        r0 = srv.submit_query(docs[0][:5], 24)      # long: keeps decoding
        done = srv.step()
        late = [srv.submit_query(docs[1][:6], 6),
                srv.submit_query(docs[0][3:9], 6)]
        while srv._has_work():
            done += srv.step(draining=True)
        tokens[overlap] = {r.rid: r.tokens for r in done}
        assert sorted(tokens[overlap]) == sorted([r0] + late)
        if overlap:
            assert srv.stats.retrieval_overlapped == 2
            assert srv.stats.retrieval_overlap_frac > 0
        else:
            assert srv.stats.retrieval_overlapped == 0
        assert (srv.stats.spec_steps > 0) == spec
    for rid in tokens[True]:
        np.testing.assert_array_equal(tokens[True][rid], tokens[False][rid])
    if spec:
        # the same traffic on the plain path
        docs, pipe = _rag(ct.vocab_size)
        srv = _server(ct, pt, rag=pipe)
        srv.submit_query(docs[0][:5], 24)
        srv.submit_query(docs[1][:6], 6)
        srv.submit_query(docs[0][3:9], 6)
        for r in srv.run():
            np.testing.assert_array_equal(r.tokens, tokens[True][r.rid])


def test_interior_hole_splice_end_to_end(models):
    """An evicted leading prompt block no longer voids the later ones:
    the re-walk splices them at interior chunk boundaries, staging
    prefills only the hole, and the tokens equal the cold run's."""
    _, ct, _, pt = models["nemotron-4-15b"]
    srv = _server(ct, pt, num_slots=1, block_size=4, prefill_chunk=4,
                  max_len=64)
    prompt = np.random.RandomState(0).randint(
        0, ct.vocab_size, size=17).astype(np.int32)
    srv.submit(prompt, 4)
    (r0,) = srv.run()
    assert srv.mgr.alloc.evict_cached(1) == 1       # LRU = leading block
    srv.submit(prompt, 4)
    (r1,) = srv.run()
    np.testing.assert_array_equal(r0.tokens, r1.tokens)
    assert srv.stats.chunk_interior_hits >= 3, "interior blocks recomputed"


def test_submit_query_validation(models):
    _, ct, _, pt = models["nemotron-4-15b"]
    plain = _server(ct, pt)
    with pytest.raises(ValueError, match="needs a RagPipeline"):
        plain.submit_query([1, 2], 4)
    _, pipe = _rag(ct.vocab_size)
    srv = _server(ct, pt, rag=pipe)
    with pytest.raises(ValueError, match="empty query"):
        srv.submit_query([], 4)
    with pytest.raises(ValueError, match="max_new_tokens"):
        srv.submit_query([1], 0)
    with pytest.raises(ValueError, match="exceeds max_len"):
        srv.submit_query(np.arange(60, dtype=np.int32), 30)
    with pytest.raises(ValueError, match="needs .* blocks"):
        _server(ct, pt, rag=pipe, num_blocks=4).submit_query([1, 2], 8)
    with pytest.raises(ValueError, match="block_size"):
        _server(ct, pt, rag=pipe, block_size=4)
    assert srv.load == 0 and not srv._queries


def test_cancel_parked_query(models):
    """A query cancelled before its retrieval vanishes: never retrieved,
    never decoded; the load drops at once."""
    _, ct, _, pt = models["nemotron-4-15b"]
    docs, pipe = _rag(ct.vocab_size)
    srv = _server(ct, pt, rag=pipe)
    keep = srv.submit_query(docs[0][:5], 3)
    drop = srv.submit_query(docs[1][:5], 3)
    assert srv.load == 2
    assert srv.cancel(drop)
    assert srv.load == 1
    assert not srv.cancel(drop)
    done = srv.run()
    assert [r.rid for r in done] == [keep]
    assert srv.stats.retrievals == 1
    assert srv.stats.cancelled == 1
    assert drop not in srv.rag_results


def test_rag_io_is_one_worker_in_submission_order(models):
    """Searches run on one background thread, in submission order."""
    from repro_torch.launch import scheduler

    _, ct, _, pt = models["nemotron-4-15b"]
    docs, pipe = _rag(ct.vocab_size)
    order = []
    retrieve = pipe.retrieve

    def logged(q):
        order.append(int(q[0]))
        return retrieve(q)

    pipe.retrieve = logged
    srv = _server(ct, pt, rag=pipe)
    qs = [docs[i % 4][i:i + 4] for i in range(6)]
    for q in qs:
        srv.submit_query(q, 2)
    srv.run()
    assert order == [int(q[0]) for q in qs]
    assert scheduler._rag_io()._max_workers == 1
