"""The analytic collective model of tensor-parallel serving (the
``_COLL_KINDS``, ``ALGO_FACTOR`` and ``tp_step_collectives`` of
``repro.launch.roofline``).

The JAX package holds this model to the collective bytes parsed from
the compiled HLO (``hlo_analysis.analyze_hlo``). The port has no HLO:
``parallel.tp``'s helpers count the bytes each collective moves, with
the same conventions (result bytes per device x ``ALGO_FACTOR``), and
the tests and ``chip_smoke.py`` hold this model to those counts. The
rest of the JAX module (XLA cost analysis, ``count_params``,
``model_flops``) is not ported.
"""

from __future__ import annotations

import torch

_COLL_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# ring-algorithm wire multiplier per result byte
ALGO_FACTOR = {
    "all-gather": 1.0,        # result is the gathered (full) buffer
    "all-reduce": 2.0,        # reduce-scatter + all-gather ring
    "reduce-scatter": 1.0,    # input is the big buffer; result is shard
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}


def tp_step_collectives(cfg, *, batch: int, tp: int, seq: int = 1,
                        steps: int = 1) -> dict[str, float]:
    """Modelled per-device collective bytes of ``steps`` iterations of
    the tensor-parallel serve step, in ``parallel.tp``'s accounting.

    Per decode step the Megatron partition issues exactly:

      * one fp32 all-reduce of the (B, S, D) embedding partial (the
        vocab-row-sharded lookup is reduced in fp32 before the cast);
      * per layer, two activation-dtype all-reduces of (B, S, D): the
        attention output projection's partial and the MLP / MoE down
        projection's (MoE folds the routed and shared experts' partials
        into one);
      * one fp32 all-gather assembling the (B, S, V_padded) logits from
        the vocab-sharded unembedding (result bytes: the gathered
        buffer).

    The KV cache never moves: heads are sharded, so paged reads and
    writes stay on their rank. At ``tp <= 1`` every collective is an
    identity and the model returns zeros.
    """
    from repro_torch.models.layers import padded_vocab

    out = {k: 0.0 for k in _COLL_KINDS}
    if tp <= 1:
        return out
    act_bytes = torch.empty((), dtype=cfg.dtype).element_size()
    tok = batch * seq
    ar = tok * cfg.d_model * 4                      # embed partial, fp32
    ar += cfg.num_layers * 2 * tok * cfg.d_model * act_bytes
    ag = tok * padded_vocab(cfg.vocab_size) * 4     # gathered logits, fp32
    out["all-reduce"] = ar * ALGO_FACTOR["all-reduce"] * steps
    out["all-gather"] = ag * ALGO_FACTOR["all-gather"] * steps
    return out
