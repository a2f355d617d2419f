"""HF <-> port checkpoint converters (counterpart of
``areal_tpu/models/hf.py``): the llama-like families (llama, mistral,
qwen2, qwen3, gemma), mixtral (llama-like with ``block_sparse_moe``
experts) and gpt2, config and params both ways, plus checkpoint IO
(``model.safetensors`` + ``config.json``).

Converters are pure functions over ``Dict[str, np.ndarray]`` (flat HF
state dicts) <-> the JAX package's host layout: layer leaves stacked on a
leading ``[L, ...]`` axis, weights ``[in, out]``. They are layout-for-layout
copies of the reference's, so a checkpoint written by either package loads
in the other; ``models/transformer.py::params_from_numpy`` /
``params_to_numpy`` carry that layout to and from the port's tensors.

The torch/HF ``nn.Linear`` convention stores weights ``[out, in]``; ours
are ``[in, out]`` (right-multiplication ``x @ w``), so linear weights are
transposed on the way through. GPT-2's ``Conv1D`` is already ``[in, out]``.

Files are read and written by ``base/safetensors_io.py``; half-precision
tensors (F16, BF16) widen to float32 on the host, which loses nothing.
"""

import dataclasses
import json
import os
from typing import Any, Callable, Dict

import numpy as np
import torch

from areal_tpu_torch.base import safetensors_io
from areal_tpu_torch.models.config import ModelConfig, MoEConfig

HFState = Dict[str, np.ndarray]


@dataclasses.dataclass
class HFFamily:
    name: str
    hf_model_type: str
    config_from_hf: Callable[[Dict[str, Any]], ModelConfig]
    config_to_hf: Callable[[ModelConfig], Dict[str, Any]]
    params_from_hf: Callable[[HFState, ModelConfig], Dict[str, Any]]
    params_to_hf: Callable[[Dict[str, Any], ModelConfig], HFState]


HF_FAMILIES: Dict[str, HFFamily] = {}


def register_hf_family(family: HFFamily):
    HF_FAMILIES[family.name] = family


# --------------------------------------------------------------------------- #
# Llama-like families (llama, mistral, qwen2, qwen3, gemma)
# --------------------------------------------------------------------------- #


def _rope_fields(hf: Dict[str, Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    rs = hf.get("rope_scaling") or None
    if rs:
        typ = rs.get("rope_type", rs.get("type"))
        if typ in ("default", None):
            return out
        out["rotary_scaling_type"] = typ
        out["rotary_scaling_factor"] = rs.get("factor", 1.0)
        if typ == "llama3":
            out["rotary_low_freq_factor"] = rs.get("low_freq_factor", 1.0)
            out["rotary_high_freq_factor"] = rs.get("high_freq_factor", 4.0)
            out["rotary_original_max_position"] = rs.get(
                "original_max_position_embeddings", 8192
            )
    return out


def _llama_like_config_from_hf(
    hf: Dict[str, Any],
    *,
    qkv_bias: bool = False,
    qk_layernorm: bool = False,
    gemma: bool = False,
    sliding_window: bool = False,
) -> ModelConfig:
    n_q = hf["num_attention_heads"]
    head_dim = hf.get("head_dim") or hf["hidden_size"] // n_q
    return ModelConfig(
        n_layers=hf["num_hidden_layers"],
        n_q_heads=n_q,
        n_kv_heads=hf.get("num_key_value_heads") or n_q,
        head_dim=head_dim,
        hidden_dim=hf["hidden_size"],
        intermediate_dim=hf["intermediate_size"],
        vocab_size=hf["vocab_size"],
        n_positions=hf.get("max_position_embeddings", 32768),
        layer_norm_type="gemma" if gemma else "rms",
        layer_norm_epsilon=hf.get("rms_norm_eps", 1e-6),
        use_attention_bias=qkv_bias or bool(hf.get("attention_bias", False)),
        qk_layernorm=qk_layernorm,
        sliding_window=(hf.get("sliding_window") if sliding_window else None),
        rotary_base=hf.get("rope_theta", 10000.0),
        activation_function={"gelu_pytorch_tanh": "gelu_pytorch_tanh"}.get(
            hf.get("hidden_act", "silu"), hf.get("hidden_act", "silu")
        ),
        tied_embedding=bool(hf.get("tie_word_embeddings", False)) or gemma,
        normalize_embed=gemma,
        **_rope_fields(hf),
    )


def _llama_like_config_to_hf(cfg: ModelConfig, model_type: str) -> Dict[str, Any]:
    hf: Dict[str, Any] = {
        "model_type": model_type,
        "architectures": [_ARCH_NAMES.get(model_type, "LlamaForCausalLM")],
        "hidden_size": cfg.hidden_dim,
        "intermediate_size": cfg.intermediate_dim,
        "num_hidden_layers": cfg.n_layers,
        "num_attention_heads": cfg.n_q_heads,
        "num_key_value_heads": cfg.n_kv_heads,
        "head_dim": cfg.head_dim,
        "vocab_size": cfg.vocab_size,
        "max_position_embeddings": cfg.n_positions,
        "rms_norm_eps": cfg.layer_norm_epsilon,
        "rope_theta": cfg.rotary_base,
        "hidden_act": cfg.activation_function,
        "tie_word_embeddings": cfg.tied_embedding,
        "attention_bias": cfg.use_attention_bias,
    }
    if cfg.sliding_window is not None:
        hf["sliding_window"] = cfg.sliding_window
    if cfg.rotary_scaling_type is not None:
        rs = {"rope_type": cfg.rotary_scaling_type, "factor": cfg.rotary_scaling_factor}
        if cfg.rotary_scaling_type == "llama3":
            rs.update(
                low_freq_factor=cfg.rotary_low_freq_factor,
                high_freq_factor=cfg.rotary_high_freq_factor,
                original_max_position_embeddings=cfg.rotary_original_max_position,
            )
        hf["rope_scaling"] = rs
    return hf


_ARCH_NAMES = {
    "llama": "LlamaForCausalLM",
    "mistral": "MistralForCausalLM",
    "qwen2": "Qwen2ForCausalLM",
    "qwen3": "Qwen3ForCausalLM",
    "gemma": "GemmaForCausalLM",
    "gpt2": "GPT2LMHeadModel",
    "mixtral": "MixtralForCausalLM",
}


def _stack(sd: HFState, pattern: str, n_layers: int, transpose: bool = False):
    mats = []
    for i in range(n_layers):
        m = np.asarray(sd[pattern.format(i=i)])
        mats.append(m.T if transpose else m)
    return np.stack(mats)


def _llama_like_params_from_hf(sd: HFState, cfg: ModelConfig) -> Dict[str, Any]:
    L = cfg.n_layers
    p = "model.layers.{i}."
    attn: Dict[str, Any] = {
        "wq": _stack(sd, p + "self_attn.q_proj.weight", L, True),
        "wk": _stack(sd, p + "self_attn.k_proj.weight", L, True),
        "wv": _stack(sd, p + "self_attn.v_proj.weight", L, True),
        "wo": _stack(sd, p + "self_attn.o_proj.weight", L, True),
    }
    if cfg.use_attention_bias:
        attn["bq"] = _stack(sd, p + "self_attn.q_proj.bias", L)
        attn["bk"] = _stack(sd, p + "self_attn.k_proj.bias", L)
        attn["bv"] = _stack(sd, p + "self_attn.v_proj.bias", L)
    if cfg.qk_layernorm:
        attn["q_norm"] = _stack(sd, p + "self_attn.q_norm.weight", L)
        attn["k_norm"] = _stack(sd, p + "self_attn.k_norm.weight", L)
    if cfg.mlp_type == "moe":
        experts = p + "block_sparse_moe.experts.{j}.{w}.weight"

        def expert_stack(w):   # [L, X, in, out]
            return np.stack([
                np.stack([np.asarray(sd[experts.format(i=i, j=j, w=w)]).T
                          for j in range(cfg.moe.num_experts)])
                for i in range(L)])

        mlp = {
            "router": _stack(sd, p + "block_sparse_moe.gate.weight", L, True),
            "w_gate": expert_stack("w1"),
            "w_down": expert_stack("w2"),
            "w_up": expert_stack("w3"),
        }
    else:
        mlp = {
            "w_gate": _stack(sd, p + "mlp.gate_proj.weight", L, True),
            "w_up": _stack(sd, p + "mlp.up_proj.weight", L, True),
            "w_down": _stack(sd, p + "mlp.down_proj.weight", L, True),
        }
    params: Dict[str, Any] = {
        "embed": {"weight": np.asarray(sd["model.embed_tokens.weight"])},
        "layers": {
            "ln1": {"weight": _stack(sd, p + "input_layernorm.weight", L)},
            "attn": attn,
            "ln2": {"weight": _stack(sd, p + "post_attention_layernorm.weight", L)},
            "mlp": mlp,
        },
        "final_ln": {"weight": np.asarray(sd["model.norm.weight"])},
    }
    if cfg.is_critic:
        pass  # critic head is never loaded from a CausalLM checkpoint
    elif not cfg.tied_embedding:
        params["head"] = {"weight": np.asarray(sd["lm_head.weight"]).T}
    return params


def _llama_like_params_to_hf(params: Dict[str, Any], cfg: ModelConfig) -> HFState:
    sd: HFState = {"model.embed_tokens.weight": np.asarray(params["embed"]["weight"])}
    lp = params["layers"]
    for i in range(cfg.n_layers):
        p = f"model.layers.{i}."
        sd[p + "input_layernorm.weight"] = np.asarray(lp["ln1"]["weight"][i])
        sd[p + "post_attention_layernorm.weight"] = np.asarray(lp["ln2"]["weight"][i])
        a = lp["attn"]
        sd[p + "self_attn.q_proj.weight"] = np.asarray(a["wq"][i]).T
        sd[p + "self_attn.k_proj.weight"] = np.asarray(a["wk"][i]).T
        sd[p + "self_attn.v_proj.weight"] = np.asarray(a["wv"][i]).T
        sd[p + "self_attn.o_proj.weight"] = np.asarray(a["wo"][i]).T
        if cfg.use_attention_bias:
            sd[p + "self_attn.q_proj.bias"] = np.asarray(a["bq"][i])
            sd[p + "self_attn.k_proj.bias"] = np.asarray(a["bk"][i])
            sd[p + "self_attn.v_proj.bias"] = np.asarray(a["bv"][i])
        if cfg.qk_layernorm:
            sd[p + "self_attn.q_norm.weight"] = np.asarray(a["q_norm"][i])
            sd[p + "self_attn.k_norm.weight"] = np.asarray(a["k_norm"][i])
        m = lp["mlp"]
        if cfg.mlp_type == "moe":
            sd[p + "block_sparse_moe.gate.weight"] = np.asarray(m["router"][i]).T
            for j in range(cfg.moe.num_experts):
                e = p + f"block_sparse_moe.experts.{j}."
                sd[e + "w1.weight"] = np.asarray(m["w_gate"][i, j]).T
                sd[e + "w2.weight"] = np.asarray(m["w_down"][i, j]).T
                sd[e + "w3.weight"] = np.asarray(m["w_up"][i, j]).T
        else:
            sd[p + "mlp.gate_proj.weight"] = np.asarray(m["w_gate"][i]).T
            sd[p + "mlp.up_proj.weight"] = np.asarray(m["w_up"][i]).T
            sd[p + "mlp.down_proj.weight"] = np.asarray(m["w_down"][i]).T
    sd["model.norm.weight"] = np.asarray(params["final_ln"]["weight"])
    if cfg.is_critic:
        pass
    elif not cfg.tied_embedding:
        sd["lm_head.weight"] = np.asarray(params["head"]["weight"]).T
    return sd


def _register_llama_like(name: str, **cfg_kwargs):
    register_hf_family(
        HFFamily(
            name=name,
            hf_model_type=name,
            config_from_hf=lambda hf, kw=cfg_kwargs: _llama_like_config_from_hf(
                hf, **kw
            ),
            config_to_hf=lambda cfg, n=name: _llama_like_config_to_hf(cfg, n),
            params_from_hf=_llama_like_params_from_hf,
            params_to_hf=_llama_like_params_to_hf,
        )
    )


_register_llama_like("llama")
_register_llama_like("mistral", sliding_window=True)
_register_llama_like("qwen2", qkv_bias=True)
_register_llama_like("qwen3", qk_layernorm=True)
_register_llama_like("gemma", gemma=True)


# --------------------------------------------------------------------------- #
# Mixtral (llama-like + MoE)
# --------------------------------------------------------------------------- #


def _mixtral_config_from_hf(hf: Dict[str, Any]) -> ModelConfig:
    """Mixtral's config: the llama-like fields, its sliding window, and the
    router (``dispatch`` stays ``"dense"``, which the serving paths'
    CUDA graphs capture)."""
    base = _llama_like_config_from_hf(hf, sliding_window=True)
    return dataclasses.replace(
        base,
        mlp_type="moe",
        moe=MoEConfig(
            num_experts=hf["num_local_experts"],
            top_k=hf["num_experts_per_tok"],
            aux_loss_coeff=hf.get("router_aux_loss_coef", 0.0),
            norm_topk_prob=True,
        ),
    )


def _mixtral_config_to_hf(cfg: ModelConfig) -> Dict[str, Any]:
    hf = _llama_like_config_to_hf(cfg, "mixtral")
    hf["num_local_experts"] = cfg.moe.num_experts
    hf["num_experts_per_tok"] = cfg.moe.top_k
    return hf


register_hf_family(
    HFFamily(
        name="mixtral",
        hf_model_type="mixtral",
        config_from_hf=_mixtral_config_from_hf,
        config_to_hf=_mixtral_config_to_hf,
        params_from_hf=_llama_like_params_from_hf,
        params_to_hf=_llama_like_params_to_hf,
    )
)


# --------------------------------------------------------------------------- #
# GPT-2
# --------------------------------------------------------------------------- #


def _gpt2_config_from_hf(hf: Dict[str, Any]) -> ModelConfig:
    n_head = hf["n_head"]
    return ModelConfig(
        n_layers=hf["n_layer"],
        n_q_heads=n_head,
        n_kv_heads=n_head,
        head_dim=hf["n_embd"] // n_head,
        hidden_dim=hf["n_embd"],
        intermediate_dim=hf.get("n_inner") or 4 * hf["n_embd"],
        vocab_size=hf["vocab_size"],
        n_positions=hf["n_positions"],
        layer_norm_type="layer",
        layer_norm_epsilon=hf.get("layer_norm_epsilon", 1e-5),
        use_attention_bias=True,
        use_attn_proj_bias=True,
        apply_rotary=False,
        abs_position_embedding=True,
        activation_function="gelu_new",
        mlp_type="fc",
        use_mlp_bias=True,
        tied_embedding=True,
    )


def _gpt2_config_to_hf(cfg: ModelConfig) -> Dict[str, Any]:
    return {
        "model_type": "gpt2",
        "architectures": ["GPT2LMHeadModel"],
        "n_layer": cfg.n_layers,
        "n_head": cfg.n_q_heads,
        "n_embd": cfg.hidden_dim,
        "n_inner": cfg.intermediate_dim,
        "vocab_size": cfg.vocab_size,
        "n_positions": cfg.n_positions,
        "layer_norm_epsilon": cfg.layer_norm_epsilon,
        "activation_function": "gelu_new",
    }


def _gpt2_params_from_hf(sd: HFState, cfg: ModelConfig) -> Dict[str, Any]:
    L, E = cfg.n_layers, cfg.hidden_dim
    # strip HF's "transformer." prefix if present
    if any(k.startswith("transformer.") for k in sd):
        sd = {
            k[len("transformer."):]: v
            for k, v in sd.items()
            if k.startswith("transformer.")
        }
    # c_attn is fused qkv with Conv1D layout [in, 3E]
    wq, wk, wv, bq, bk, bv = [], [], [], [], [], []
    for i in range(L):
        w = np.asarray(sd[f"h.{i}.attn.c_attn.weight"])
        b = np.asarray(sd[f"h.{i}.attn.c_attn.bias"])
        wq.append(w[:, :E]); wk.append(w[:, E : 2 * E]); wv.append(w[:, 2 * E :])
        bq.append(b[:E]); bk.append(b[E : 2 * E]); bv.append(b[2 * E :])
    p = "h.{i}."
    return {
        "embed": {"weight": np.asarray(sd["wte.weight"])},
        "pos_embed": {"weight": np.asarray(sd["wpe.weight"])},
        "layers": {
            "ln1": {
                "weight": _stack(sd, p + "ln_1.weight", L),
                "bias": _stack(sd, p + "ln_1.bias", L),
            },
            "attn": {
                "wq": np.stack(wq), "wk": np.stack(wk), "wv": np.stack(wv),
                "bq": np.stack(bq), "bk": np.stack(bk), "bv": np.stack(bv),
                "wo": _stack(sd, p + "attn.c_proj.weight", L),
                "bo": _stack(sd, p + "attn.c_proj.bias", L),
            },
            "ln2": {
                "weight": _stack(sd, p + "ln_2.weight", L),
                "bias": _stack(sd, p + "ln_2.bias", L),
            },
            "mlp": {
                "w_fc": _stack(sd, p + "mlp.c_fc.weight", L),
                "b_fc": _stack(sd, p + "mlp.c_fc.bias", L),
                "w_proj": _stack(sd, p + "mlp.c_proj.weight", L),
                "b_proj": _stack(sd, p + "mlp.c_proj.bias", L),
            },
        },
        "final_ln": {
            "weight": np.asarray(sd["ln_f.weight"]),
            "bias": np.asarray(sd["ln_f.bias"]),
        },
    }


def _gpt2_params_to_hf(params: Dict[str, Any], cfg: ModelConfig) -> HFState:
    sd: HFState = {
        "transformer.wte.weight": np.asarray(params["embed"]["weight"]),
        "transformer.wpe.weight": np.asarray(params["pos_embed"]["weight"]),
        "transformer.ln_f.weight": np.asarray(params["final_ln"]["weight"]),
        "transformer.ln_f.bias": np.asarray(params["final_ln"]["bias"]),
    }
    lp = params["layers"]
    for i in range(cfg.n_layers):
        p = f"transformer.h.{i}."
        a = lp["attn"]
        sd[p + "ln_1.weight"] = np.asarray(lp["ln1"]["weight"][i])
        sd[p + "ln_1.bias"] = np.asarray(lp["ln1"]["bias"][i])
        sd[p + "ln_2.weight"] = np.asarray(lp["ln2"]["weight"][i])
        sd[p + "ln_2.bias"] = np.asarray(lp["ln2"]["bias"][i])
        sd[p + "attn.c_attn.weight"] = np.concatenate(
            [np.asarray(a["wq"][i]), np.asarray(a["wk"][i]), np.asarray(a["wv"][i])],
            axis=1,
        )
        sd[p + "attn.c_attn.bias"] = np.concatenate(
            [np.asarray(a["bq"][i]), np.asarray(a["bk"][i]), np.asarray(a["bv"][i])]
        )
        sd[p + "attn.c_proj.weight"] = np.asarray(a["wo"][i])
        sd[p + "attn.c_proj.bias"] = np.asarray(a["bo"][i])
        m = lp["mlp"]
        sd[p + "mlp.c_fc.weight"] = np.asarray(m["w_fc"][i])
        sd[p + "mlp.c_fc.bias"] = np.asarray(m["b_fc"][i])
        sd[p + "mlp.c_proj.weight"] = np.asarray(m["w_proj"][i])
        sd[p + "mlp.c_proj.bias"] = np.asarray(m["b_proj"][i])
    return sd


register_hf_family(
    HFFamily(
        name="gpt2",
        hf_model_type="gpt2",
        config_from_hf=_gpt2_config_from_hf,
        config_to_hf=_gpt2_config_to_hf,
        params_from_hf=_gpt2_params_from_hf,
        params_to_hf=_gpt2_params_to_hf,
    )
)


# --------------------------------------------------------------------------- #
# Checkpoint IO (safetensors + config.json)
# --------------------------------------------------------------------------- #


def family_for_model_type(model_type: str) -> HFFamily:
    for fam in HF_FAMILIES.values():
        if fam.hf_model_type == model_type:
            return fam
    raise KeyError(f"No converter registered for HF model_type={model_type!r}")


def _host_array(t: torch.Tensor) -> np.ndarray:
    if t.dtype in (torch.bfloat16, torch.float16):
        t = t.float()
    return t.numpy()


def load_hf_checkpoint(path: str):
    """Read an HF checkpoint dir -> (ModelConfig, params tree of numpy
    arrays in the stacked ``[L, ...]``, ``[in, out]`` layout)."""
    with open(os.path.join(path, "config.json")) as f:
        hf_cfg = json.load(f)
    fam = family_for_model_type(hf_cfg["model_type"])
    cfg = fam.config_from_hf(hf_cfg)
    sd: HFState = {}
    shards = sorted(
        f for f in os.listdir(path) if f.endswith(".safetensors")
    )
    if not shards:
        raise FileNotFoundError(f"No .safetensors shards under {path}")
    for shard in shards:
        loaded = safetensors_io.load_file(os.path.join(path, shard))
        sd.update({k: _host_array(t) for k, t in loaded.items()})
    # critic/reward checkpoints: the scalar value head rides as
    # ``score.weight [1, E]`` (the HF SequenceClassification convention)
    # plus an ``is_critic`` marker in config.json; family converters only
    # handle the CausalLM surface
    if hf_cfg.get("is_critic"):
        cfg = dataclasses.replace(cfg, is_critic=True)
    params = fam.params_from_hf(sd, cfg)
    if cfg.is_critic and "score.weight" in sd:
        params["head"] = {"weight": np.asarray(sd["score.weight"]).T}
    return cfg, params


def save_hf_checkpoint(params, cfg: ModelConfig, family: str, path: str):
    """Write host params (numpy, layers stacked: the form
    ``models/transformer.py::params_to_numpy`` gives) as an HF checkpoint
    dir (model.safetensors + config.json)."""
    fam = HF_FAMILIES[family]
    os.makedirs(path, exist_ok=True)
    sd = fam.params_to_hf(params, cfg)
    hf_cfg = fam.config_to_hf(cfg)
    if cfg.is_critic:
        # value head [E, 1] -> score.weight [1, E]; marker for the loader
        sd["score.weight"] = np.asarray(params["head"]["weight"]).T
        hf_cfg["is_critic"] = True
    # the converters emit transposed views of the stacked params; the
    # writer stores each contiguous, never a view's raw buffer
    safetensors_io.save_file(sd, os.path.join(path, "model.safetensors"))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf_cfg, f, indent=2)
