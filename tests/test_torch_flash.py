"""flash_attention and the attention routes of the training forward, in
the port, held to the JAX package on the CPU.

Across frameworks, on inputs made from a seed with numpy:

  * the port's plain version (what ``flash_attention`` and its op take
    for a CPU tensor) against the JAX Pallas kernel in interpret mode
    (``block_q = block_k = 64``) on the JAX package's own five
    ``FLASH_CASES`` (3e-4, the JAX test's tolerance) and in bf16 (3e-2),
    plus the GQA and causal ``T < S`` refusals;
  * ``_attend``'s routes: the cache-free ``forward`` with ``use_pallas``
    records the flash op (variant "ref" on the CPU); ``prefill``, whose
    ``cache_pos`` is 0, never does; the chunked route (``CHUNK_Q``
    patched to 32 in both packages — the JAX module reads its global at
    call time) gives the JAX logits for GQA and MLA, in its unrolled
    (causal prefixes) and scanned forms, to 1e-4.

The kernel itself runs only on the card: its `gpu` cases (against this
plain version) live in ``tests/test_torch_isolation.py``, which imports
no JAX.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.kernels import ops as jops
from repro.models import attention as jattn
from repro.models import layers as jL
from repro.models.registry import get_model as jget
from repro_torch import bridge
from repro_torch import configs as tcfg
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops as kops
from repro_torch.models import attention as attn
from repro_torch.models import transformer as T

FLASH_CASES = [
    # (B, Hq, Hkv, S, T, Dh, causal): tests/test_kernels.py
    (2, 4, 4, 128, 128, 64, True),
    (1, 8, 2, 128, 128, 64, True),     # GQA
    (2, 4, 2, 128, 256, 32, True),     # decode-style offset
    (1, 4, 4, 128, 128, 128, False),   # non-causal (cross-attn)
    (1, 2, 1, 256, 256, 64, True),     # multiple q blocks
]


def _arr(rng, shape, scale=0.3):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _qkv(seed, b, hq, hkv, s, t, dh):
    rng = np.random.default_rng(seed)
    return (_arr(rng, (b, hq, s, dh)), _arr(rng, (b, hkv, t, dh)),
            _arr(rng, (b, hkv, t, dh)))


@pytest.mark.parametrize("case", FLASH_CASES)
def test_plain_matches_jax_kernel(case):
    b, hq, hkv, s, t, dh, causal = case
    q, k, v = _qkv(sum(case), b, hq, hkv, s, t, dh)
    want = jops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=causal,
                                interpret=True, use_kernel=True,
                                block_q=64, block_k=64)
    got = fa.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                             causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-4,
                               atol=3e-4)


def test_plain_matches_jax_kernel_bf16():
    q, k, v = _qkv(3, 1, 4, 4, 128, 128, 64)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want = jops.flash_attention(jq, jk, jv, causal=True, interpret=True,
                                use_kernel=True)
    got = fa.flash_attention(*(torch.from_numpy(a).bfloat16()
                               for a in (q, k, v)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=3e-2,
                               atol=3e-2)


def test_refusals():
    q, k, _ = _qkv(4, 1, 3, 2, 128, 128, 64)
    with pytest.raises(ValueError, match="GQA"):
        fa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(k))
    q, k, _ = _qkv(5, 1, 2, 2, 128, 64, 16)
    with pytest.raises(ValueError, match="T >= S"):
        fa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(k))


def test_op_eligibility_and_dispatch_on_cpu():
    """The op takes every shape through its wrapper, whole 128-blocks or
    ragged (the block rule lives in ``_attend``); on the CPU every call
    records variant "ref", equals the plain version and launches
    nothing."""
    kops.reset_launch_counts()
    recs = []
    with kops.record_dispatches(recs):
        for s, t in ((128, 128), (100, 130)):
            q, k, v = (torch.from_numpy(a)
                       for a in _qkv(6, 1, 4, 2, s, t, 16))
            torch.testing.assert_close(kops.flash_attention(q, k, v),
                                       fa.flash_attention_plain(q, k, v),
                                       rtol=0, atol=0)
    assert [(r.op, r.variant, r.used_kernel) for r in recs] == [
        ("flash_attention", "ref", False)] * 2
    assert kops.launch_counts()["flash_attention"] == 0


# ---------------------------------------------------------------------------
# _attend routes in the model
# ---------------------------------------------------------------------------

ARCHS = ["nemotron-4-15b", "deepseek-v3-671b"]


def _pair(arch, **kw):
    cj = dataclasses.replace(jcfg.get_smoke_config(arch), **kw)
    ct = dataclasses.replace(tcfg.get_smoke_config(arch), **kw)
    return cj, ct


@pytest.fixture(scope="module")
def weights():
    out = {}
    for arch in ARCHS:
        cj, _ = _pair(arch)
        pj = jax.jit(lambda k, cj=cj: jget(cj).init(k, cj))(
            jax.random.PRNGKey(0))
        out[arch] = (pj, bridge.params_from_jax(
            jax.tree.map(np.asarray, pj), device="cpu"))
    return out


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def test_forward_records_flash_and_prefill_never_does(weights,
                                                      monkeypatch):
    """The cache-free forward hands the kernel's wrapper what the card
    needs (contiguous operands: the wrapper raises on a CUDA view)."""
    _, ct = _pair("nemotron-4-15b", use_pallas=True)
    pt = weights["nemotron-4-15b"][1]
    toks = torch.from_numpy(_tokens(7, 2, 128, ct.vocab_size))

    def kernel(q, k, v, **kw):
        assert all(t.is_contiguous() for t in (q, k, v))
        return fa.flash_attention(q, k, v, **kw)

    monkeypatch.setattr(kops, "_flash_kernel", kernel)
    recs = []
    with kops.record_dispatches(recs):
        T.forward(pt, ct, {"tokens": toks})
    flash = [r for r in recs if r.op == "flash_attention"]
    assert [r.layer for r in flash] == list(range(ct.num_layers))
    assert all(r.variant == "ref" and not r.used_kernel for r in flash)
    recs = []
    with kops.record_dispatches(recs):
        T.prefill(pt, ct, {"tokens": toks},
                  T.init_cache(ct, 2, 128, device="cpu"))
        T.prefill(pt, ct, {"tokens": toks},
                  T.init_cache(ct, 2, 128, device="cpu"), cache_pos=0)
    assert recs and not any(r.op == "flash_attention" for r in recs)


@pytest.mark.parametrize("unroll", [64, 2], ids=["unrolled", "scanned"])
@pytest.mark.parametrize("arch", ["nemotron-4-15b", "deepseek-v3-671b"])
def test_chunked_route_matches_jax(monkeypatch, weights, arch, unroll):
    """S = 128 in four chunks of 32: the causal prefixes (4 <= unroll)
    or every chunk against all keys (4 > 2); the forward's logits and a
    prefill's (a non-static offset: always the scanned form)."""
    for mod in (jattn, attn):
        monkeypatch.setattr(mod, "CHUNK_Q", 32)
        monkeypatch.setattr(mod, "UNROLL_CHUNKS", unroll)
    cj, ct = _pair(arch)
    pj, pt = weights[arch]
    toks = _tokens(8, 2, 128, ct.vocab_size)
    want = jget(cj).forward(pj, cj, {"tokens": jnp.asarray(toks)})
    got = T.forward(pt, ct, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    jc = jget(cj).init_cache(cj, jL.HOST, 2, 128)
    want, _ = jget(cj).prefill(pj, cj, {"tokens": jnp.asarray(toks)}, jc)
    got, _ = T.prefill(pt, ct, {"tokens": torch.from_numpy(toks)},
                       T.init_cache(ct, 2, 128, device="cpu"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
