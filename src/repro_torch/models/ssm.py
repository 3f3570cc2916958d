"""Mamba2 (SSD) blocks, the zamba2 backbone (mirror of
``repro.models.ssm``).

The chunked SSD algorithm is built from static tensor contractions (the
intra-chunk (CBᵀ⊙L)X products and the inter-chunk state einsums); the
flexible ops are the nonlinearities from the function table: softplus
of dt, the SiLU gates, and the gated RMSNorm.

Chunked SSD recurrence (chunk length Q, per head, state N, head dim P):

  a_t = exp(dt_t · A)            L_t = Σ_{s≤t} log a_s   (cumsum in chunk)
  h_t = a_t h_{t-1} + dt_t B_t ⊗ x_t          y_t = C_t · h_t + D x_t

  intra:  y⁺_t = Σ_{s≤t} (C_t·B_s) e^{L_t-L_s} dt_s x_s
  inter:  y°_t = e^{L_t} (C_t · h_chunk_start)
  state:  h' = e^{L_Q} h + Σ_s e^{L_Q-L_s} dt_s B_s ⊗ x_s

The chunks run in order (the JAX module's ``lax.scan``); decode is the
single-step recurrence. Blocks are functional: they return new states.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import linear, rms_norm
from repro_torch.models.rwkv import chunk_len

Tensor = torch.Tensor
F32 = torch.float32

CONV_K = 4  # causal depthwise conv kernel width


def ssm_dims(cfg: ModelConfig) -> tuple[int, int, int]:
    """(d_inner, n_heads, head_dim)."""
    d_inner = cfg.ssm_expand * cfg.d_model
    return d_inner, d_inner // cfg.ssm_head_dim, cfg.ssm_head_dim


def mamba2_param_shapes(cfg: ModelConfig) -> dict:
    """One layer's weights: name -> (shape, init[, dtype])."""
    d, n = cfg.d_model, cfg.ssm_state
    d_in, h, _ = ssm_dims(cfg)
    return {
        "in_x": ((d, d_in), "normal"),
        "in_z": ((d, d_in), "normal"),
        "in_B": ((d, n), "normal"),
        "in_C": ((d, n), "normal"),
        "in_dt": ((d, h), "normal"),
        "conv_x": ((CONV_K, d_in), "normal"),
        "conv_B": ((CONV_K, n), "normal"),
        "conv_C": ((CONV_K, n), "normal"),
        "a_log": ((h,), "ones", F32),
        "d_skip": ((h,), "ones", F32),
        "dt_bias": ((h,), "zeros", F32),
        "norm": ((d_in,), "ones"),
        "out": ((d_in, d), "normal"),
    }


def ssm_state_shapes(cfg: ModelConfig, batch: int) -> dict:
    """One layer's decode state: name -> (shape, dtype)."""
    d_in, h, p = ssm_dims(cfg)
    n = cfg.ssm_state
    return {
        "h": ((batch, h, n, p), F32),
        "conv": ((batch, CONV_K - 1, d_in + 2 * n), cfg.dtype),
    }


def _causal_conv(x: Tensor, w: Tensor, state: Tensor | None = None
                 ) -> tuple[Tensor, Tensor]:
    """Depthwise causal conv of width CONV_K: x (B,T,C), w (K,C). The
    taps are summed in x's type in tap order. Returns (y, new state): the
    trailing K-1 inputs."""
    b, t, c = x.shape
    pad = (torch.zeros((b, CONV_K - 1, c), dtype=x.dtype, device=x.device)
           if state is None else state.to(x.dtype))
    xp = torch.cat([pad, x], dim=1)                       # (B, T+K-1, C)
    y = sum(xp[:, i:i + t, :] * w[i][None, None, :] for i in range(CONV_K))
    return y.to(x.dtype), xp[:, -(CONV_K - 1):, :]


def mamba2_chunked(x: Tensor, dt: Tensor, a: Tensor, bmat: Tensor,
                   cmat: Tensor, d_skip: Tensor, h0: Tensor, chunk: int
                   ) -> tuple[Tensor, Tensor]:
    """Chunked SSD scan. x (B,T,H,P) fp32, dt (B,T,H) fp32 (post-
    softplus), a (H,) negative, bmat/cmat (B,T,N) fp32, d_skip (H,), h0
    (B,H,N,P) fp32. Returns y (B,T,H,P) fp32 and the final state."""
    t = x.shape[1]
    q = chunk_len(t, chunk)
    causal = torch.tril(torch.ones((q, q), dtype=F32, device=x.device))
    hstate = h0
    outs = []
    for c0 in range(0, t, q):
        xq, dtq, bq, cq = (u[:, c0:c0 + q] for u in (x, dt, bmat, cmat))
        lc = torch.cumsum(dtq * a[None, None, :], dim=1)   # (B,Q,H) <= 0
        # inter-chunk: y° = e^{L_t} C_t · h_start
        y_inter = torch.einsum("bqn,bhnp->bqhp", cq, hstate) * \
            torch.exp(lc)[..., None]
        # intra-chunk: M ⊙ decay, then @ (dt x)
        m = torch.einsum("bqn,bsn->bqs", cq, bq)
        decay = torch.exp(torch.clamp(lc[:, :, None, :] - lc[:, None, :, :],
                                      -60.0, 0.0))          # (B,Q,S,H)
        w = m[..., None] * decay * dtq[:, None, :, :] * \
            causal[None, :, :, None]
        y_intra = torch.einsum("bqsh,bshp->bqhp", w, xq)
        # state: h' = e^{L_Q} h + Σ e^{L_Q - L_s} dt_s B_s ⊗ x_s
        decay_state = torch.exp(torch.clamp(lc[:, -1:, :] - lc, -60.0,
                                            0.0)) * dtq
        h_inc = torch.einsum("bsh,bsn,bshp->bhnp", decay_state, bq, xq)
        hstate = torch.exp(lc[:, -1])[..., None, None] * hstate + h_inc
        outs.append(y_intra + y_inter + xq * d_skip[None, None, :, None])
    return torch.cat(outs, dim=1), hstate


def mamba2_step(x: Tensor, dt: Tensor, a: Tensor, bvec: Tensor,
                cvec: Tensor, d_skip: Tensor, h: Tensor
                ) -> tuple[Tensor, Tensor]:
    """One decode step. x (B,H,P), dt (B,H), b/c (B,N), h (B,H,N,P)."""
    decay = torch.exp(dt * a[None, :])
    h_new = decay[..., None, None] * h + torch.einsum(
        "bh,bn,bhp->bhnp", dt, bvec, x)
    y = torch.einsum("bn,bhnp->bhp", cvec, h_new) + \
        x * d_skip[None, :, None]
    return y, h_new


def mamba2_block(params: dict, cfg: ModelConfig, xin: Tensor, *, table,
                 state: dict | None = None) -> tuple[Tensor, dict | None]:
    """xin (B, S, D); ``state`` {"h": (B,H,N,P), "conv": (B,K-1,C)}."""
    b, s, _ = xin.shape
    d_in, h, p = ssm_dims(cfg)
    n = cfg.ssm_state
    silu = table.lookup("silu")
    softplus = table.lookup("softplus")

    z = linear(xin, params["in_z"])
    xbc = torch.cat([linear(xin, params["in_x"]), linear(xin, params["in_B"]),
                     linear(xin, params["in_C"])], dim=-1)
    dt_raw = linear(xin, params["in_dt"])                    # (B,S,H)
    conv_w = torch.cat([params["conv_x"], params["conv_B"],
                        params["conv_C"]], dim=-1)
    xbc, new_conv = _causal_conv(
        xbc, conv_w, state["conv"] if state is not None else None)
    xbc = silu(xbc)
    xs = xbc[..., :d_in].float().reshape(b, s, h, p)
    bmat = xbc[..., d_in:d_in + n].float()
    cmat = xbc[..., d_in + n:].float()

    dt = softplus(dt_raw.float() + params["dt_bias"][None, None, :]).float()
    a = -torch.exp(params["a_log"].float())                  # (H,) < 0
    d_skip = params["d_skip"].float()

    if state is None:
        h0 = torch.zeros((b, h, n, p), dtype=F32, device=xin.device)
        y, h_new = mamba2_chunked(xs, dt, a, bmat, cmat, d_skip, h0,
                                  cfg.ssm_chunk)
    elif s == 1:
        y, h_new = mamba2_step(xs[:, 0], dt[:, 0], a, bmat[:, 0],
                               cmat[:, 0], d_skip, state["h"])
        y = y[:, None]
    else:
        y, h_new = mamba2_chunked(xs, dt, a, bmat, cmat, d_skip, state["h"],
                                  cfg.ssm_chunk)

    y = y.reshape(b, s, d_in).to(cfg.dtype)
    y = rms_norm(y * silu(z), params["norm"], cfg.norm_eps)
    out = linear(y, params["out"])
    new_state = None
    if state is not None:
        new_state = {"h": h_new, "conv": new_conv.to(state["conv"].dtype)}
    return out, new_state
