"""A configuration file's model, in the harness's terms, and the port's
``TransformerConfig`` for it.

The files keep the source's own key names (``hidden_size`` for BERT,
``n_embd`` for GPT-2); this table maps each onto one name.
"""

from __future__ import annotations

ALIASES = {
    "vocab_size": ("vocab_size",),
    "d_model": ("hidden_size", "n_embd"),
    "n_layers": ("num_hidden_layers", "n_layer"),
    "n_heads": ("num_attention_heads", "n_head"),
    "d_ff": ("intermediate_size", "n_inner"),
    "max_len": ("max_position_embeddings", "n_positions"),
    "layer_norm_eps": ("layer_norm_eps", "layer_norm_epsilon"),
}


def model_of(config: dict) -> dict:
    out = {}
    for key, names in ALIASES.items():
        for n in names:
            if n in config:
                out[key] = config[n]
                break
    if out.get("d_ff") is None:
        out["d_ff"] = 4 * out["d_model"]       # GPT-2's n_inner: null
    out["causal"] = bool(config["causal"])
    return out


def port_config(model: dict, settings: dict, ttr, torch):
    """The port's ``TransformerConfig`` of ``model`` under the path's
    ``settings`` (``ttr`` is ``deeplearning4j_tpu_torch.models.transformer``)."""
    kw = dict(vocab_size=model["vocab_size"], d_model=model["d_model"],
              n_heads=model["n_heads"], n_layers=model["n_layers"],
              d_ff=model["d_ff"], max_len=model["max_len"],
              causal=model["causal"], tie_embeddings=True,
              dtype=getattr(torch, settings["dtype"]),
              param_dtype=getattr(torch, settings["param_dtype"]))
    for key in ("attention", "fused_ln", "xent_impl", "remat"):
        if key in settings:
            kw[key] = settings[key]
    return ttr.TransformerConfig(**kw)


def matmul_params(model: dict) -> int:
    """Weights that enter matrix products: each block's q, k, v and output
    projections and its two FFN matrices, and the tied head."""
    L, d, f, V = (model["n_layers"], model["d_model"], model["d_ff"],
                  model["vocab_size"])
    return L * (4 * d * d + 2 * d * f) + V * d
