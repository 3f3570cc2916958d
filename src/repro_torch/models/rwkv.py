"""RWKV6 ("Finch") blocks: attention-free, data-dependent decay (mirror
of ``repro.models.rwkv``).

The r/k/v/g projections, the lora mixers and the chunked WKV
contractions are static products; the decay ``exp_decay``
(w = e^{-e^{x}}), the SiLU / sigmoid gates and the squared-ReLU
channel-mix are function-table entries.

Chunked WKV (chunk Q, per head, key dim K, value dim V):

  S_t = diag(w_t) S_{t-1} + k_tᵀ v_t
  o_t = r_t (diag(u) k_tᵀ v_t + S_{t-1})

  With L_t = Σ_{s≤t} log w_s (cumsum per channel, ≤ 0):
    intra (s<t):  A_ts = Σ_d r_td k_sd e^{L_{t-1,d} - L_{s,d}}
    diag:         A_tt = Σ_d r_td k_td u_d
    inter:        o°_t = (r_t ⊙ e^{L_{t-1}}) · S
    state:        S' = diag(e^{L_Q}) S + Σ_s (k_s ⊙ e^{L_Q-L_s})ᵀ v_s

  The pairwise decay e^{L_{t-1}-L_s} is computed explicitly per chunk,
  clipped to [-60, 0] in the exponent, and the chunks run in order (the
  JAX module's ``lax.scan``).

Every cast sits where the JAX module has it: r / k / v / log w and the
WKV state in fp32, the five token mixes in fp32 then in ``cfg.dtype``,
the WKV output in ``cfg.dtype`` before its norm. The blocks are
functional: they return new states, and the model writes them into its
carried state in place.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import linear, rms_norm

Tensor = torch.Tensor
F32 = torch.float32

LORA_MIX = 32
LORA_DECAY = 64
CHUNK = 64
MIX_COMPONENTS = 5  # r, k, v, w, g


def rwkv_dims(cfg: ModelConfig) -> tuple[int, int]:
    """(heads, head dim)."""
    return cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim


def rwkv_param_shapes(cfg: ModelConfig) -> dict:
    """One layer's time-mix and channel-mix weights: name -> (shape,
    init[, dtype])."""
    d, f = cfg.d_model, cfg.d_ff
    return {
        # time-mix (token-shift ddlerp)
        "mix_base": ((MIX_COMPONENTS, d), "zeros"),
        "mix_w1": ((d, MIX_COMPONENTS * LORA_MIX), "normal"),
        "mix_w2": ((MIX_COMPONENTS, LORA_MIX, d), "normal"),
        # data-dependent decay lora
        "w0": ((d,), "zeros", F32),
        "w_lora1": ((d, LORA_DECAY), "normal"),
        "w_lora2": ((LORA_DECAY, d), "normal"),
        # projections
        "wr": ((d, d), "normal"),
        "wk": ((d, d), "normal"),
        "wv": ((d, d), "normal"),
        "wg": ((d, d), "normal"),
        "u": ((d,), "zeros", F32),
        "ln_x": ((d,), "ones"),
        "wo": ((d, d), "normal"),
        # channel-mix
        "cm_mix_k": ((d,), "zeros"),
        "cm_mix_r": ((d,), "zeros"),
        "cm_key": ((d, f), "normal"),
        "cm_value": ((f, d), "normal"),
        "cm_recept": ((d, d), "normal"),
    }


def rwkv_state_shapes(cfg: ModelConfig, batch: int) -> dict:
    """One layer's decode state: name -> (shape, dtype)."""
    h, k = rwkv_dims(cfg)
    return {
        "wkv": ((batch, h, k, k), F32),
        "shift_tm": ((batch, cfg.d_model), cfg.dtype),
        "shift_cm": ((batch, cfg.d_model), cfg.dtype),
    }


def _token_shift(x: Tensor, prev: Tensor | None) -> Tensor:
    """shift(x)[t] = x[t-1]; position 0 gets ``prev`` (decode state) or
    0."""
    b, _, d = x.shape
    first = (torch.zeros((b, 1, d), dtype=x.dtype, device=x.device)
             if prev is None else prev[:, None, :])
    return torch.cat([first, x[:, :-1, :]], dim=1)


def chunk_len(t: int, chunk: int) -> int:
    """The JAX modules' chunk rule: ``chunk`` (at most t), halved until
    it divides t."""
    q = min(chunk, t)
    while t % q:
        q //= 2
    return q


def wkv_chunked(r: Tensor, k: Tensor, v: Tensor, logw: Tensor, u: Tensor,
                s0: Tensor, chunk: int = CHUNK) -> tuple[Tensor, Tensor]:
    """r/k/v (B,T,H,K) fp32, logw (B,T,H,K) (<= 0), u (H,K), s0
    (B,H,K,K). Returns o (B,T,H,K) and the final state; state layout
    S[h, d_k, d_v]."""
    t = r.shape[1]
    q = chunk_len(t, chunk)
    strict = torch.tril(torch.ones((q, q), dtype=F32, device=r.device),
                        diagonal=-1)
    s = s0
    outs = []
    for c0 in range(0, t, q):
        rq, kq, vq, lw = (a[:, c0:c0 + q] for a in (r, k, v, logw))
        lc = torch.cumsum(lw, dim=1)               # cumulative log w
        lc_prev = lc - lw                          # L_{t-1}
        # intra: A_ts = Σ_d r_td k_sd e^{Lprev_t - L_s}  (s < t)
        pair = torch.exp(torch.clamp(lc_prev[:, :, None] - lc[:, None],
                                     -60.0, 0.0))  # (B,Q,S,H,K)
        a = torch.einsum("bqhk,bshk,bqshk->bqsh", rq, kq, pair)
        a = a * strict[None, :, :, None]
        a_diag = torch.einsum("bqhk,bqhk,hk->bqh", rq, kq, u)
        o = torch.einsum("bqsh,bshk->bqhk", a, vq)
        o = o + a_diag[..., None] * vq
        # inter: o° = (r ⊙ e^{Lprev}) · S
        o = o + torch.einsum("bqhk,bhkv->bqhv", rq * torch.exp(lc_prev), s)
        # state update
        kdec = kq * torch.exp(torch.clamp(lc[:, -1:] - lc, -60.0, 0.0))
        s = torch.exp(lc[:, -1])[..., None] * s + torch.einsum(
            "bshk,bshv->bhkv", kdec, vq)
        outs.append(o)
    return torch.cat(outs, dim=1), s


def wkv_step(r: Tensor, k: Tensor, v: Tensor, w: Tensor, u: Tensor,
             s: Tensor) -> tuple[Tensor, Tensor]:
    """One decode step; r/k/v/w (B,H,K), s (B,H,K,K)."""
    kv = torch.einsum("bhk,bhv->bhkv", k, v)
    o = torch.einsum("bhk,bhkv->bhv", r, s + u[None, :, :, None] * kv)
    return o, w[..., None] * s + kv


def rwkv_block(params: dict, cfg: ModelConfig, xin: Tensor, *, table,
               state: dict | None = None) -> tuple[Tensor, dict | None]:
    """Time-mix (WKV) half on the post-norm input (B, S, D). Returns
    (out, new state without the channel-mix's shift)."""
    b, s, d = xin.shape
    h, kk = rwkv_dims(cfg)
    silu = table.lookup("silu")
    exp_decay = table.lookup("exp_decay")

    prev = state["shift_tm"] if state is not None else None
    delta = _token_shift(xin, prev) - xin
    # ddlerp: 5 data-dependent mixes from one lora
    mix_l = torch.tanh(linear(xin, params["mix_w1"]))
    mix_l = mix_l.reshape(b, s, MIX_COMPONENTS, LORA_MIX)
    mix_dyn = torch.einsum("bscl,cld->bscd", mix_l.float(),
                           params["mix_w2"].float())
    mix = params["mix_base"].float()[None, None] + mix_dyn
    xmix = xin[:, :, None, :].float() + delta[:, :, None, :].float() * mix
    x_r, x_k, x_v, x_w, x_g = (xmix[:, :, i, :].to(cfg.dtype)
                               for i in range(MIX_COMPONENTS))

    r = linear(x_r, params["wr"]).float().reshape(b, s, h, kk)
    k = linear(x_k, params["wk"]).float().reshape(b, s, h, kk)
    v = linear(x_v, params["wv"]).float().reshape(b, s, h, kk)
    g = silu(linear(x_g, params["wg"]))

    ww = params["w0"][None, None, :] + torch.einsum(
        "bsl,ld->bsd", torch.tanh(linear(x_w, params["w_lora1"])).float(),
        params["w_lora2"].float())
    w = exp_decay(ww)                                  # (B,S,D) in (0,1)
    logw = torch.log(torch.clamp_min(w.float(), 1e-38)).reshape(b, s, h, kk)
    u = params["u"].float().reshape(h, kk)

    if state is None:
        s0 = torch.zeros((b, h, kk, kk), dtype=F32, device=xin.device)
        o, s_new = wkv_chunked(r, k, v, logw, u, s0)
    elif s == 1:
        o, s_new = wkv_step(r[:, 0], k[:, 0], v[:, 0], torch.exp(logw[:, 0]),
                            u, state["wkv"])
        o = o[:, None]
    else:
        o, s_new = wkv_chunked(r, k, v, logw, u, state["wkv"])

    o = o.reshape(b, s, d).to(cfg.dtype)
    o = rms_norm(o, params["ln_x"], cfg.norm_eps) * g.to(cfg.dtype)
    out = linear(o, params["wo"])

    new_state = None
    if state is not None:
        new_state = dict(state, wkv=s_new, shift_tm=xin[:, -1, :])
    return out, new_state


def rwkv_channel_mix(params: dict, cfg: ModelConfig, xin: Tensor, *, table,
                     state: dict | None = None
                     ) -> tuple[Tensor, dict | None]:
    """Channel-mix half: squared-ReLU MLP with a sigmoid receptance
    gate."""
    sq_relu = table.lookup("squared_relu")
    sigmoid = table.lookup("sigmoid")

    prev = state["shift_cm"] if state is not None else None
    delta = _token_shift(xin, prev) - xin
    x_k = xin + delta * params["cm_mix_k"].to(xin.dtype)[None, None]
    x_r = xin + delta * params["cm_mix_r"].to(xin.dtype)[None, None]

    kk = sq_relu(linear(x_k, params["cm_key"]))
    vv = linear(kk.to(xin.dtype), params["cm_value"])
    rr = sigmoid(linear(x_r, params["cm_recept"]))
    out = (rr * vv).to(xin.dtype)

    new_state = None
    if state is not None:
        new_state = dict(state, shift_cm=xin[:, -1, :])
    return out, new_state
