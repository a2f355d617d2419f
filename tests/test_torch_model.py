"""Port parity: the paged-KV transformer of ``areal_tpu_torch`` against
``areal_tpu`` on tiny float32 configs (qwen2-like with qkv bias, gpt2-like
with layer norm + fc MLP + absolute positions, gemma-like with soft caps
and a sliding window). One param tree (made with numpy from a seed) feeds
both packages through ``params_from_numpy``; chunked prefill fills the
pools and a decode step produces logits. Tolerance 1e-4: float32 on both
sides, accumulation order only.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from areal_tpu.models import transformer as jax_tfm
from areal_tpu.models.config import ModelConfig as JaxConfig
from areal_tpu_torch.models import transformer as pt_tfm
from areal_tpu_torch.models.config import ModelConfig as PtConfig


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tensors here are tiny, so torch's intra-op thread pool buys nothing;
    one pool per test worker crowds out the timing-sensitive tests that
    other workers run beside this file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = dict(atol=1e-4, rtol=1e-4)
COMMON = dict(n_layers=2, n_q_heads=4, n_kv_heads=2, head_dim=8,
              hidden_dim=32, intermediate_dim=64, vocab_size=128,
              n_positions=128, dtype="float32")
CONFIGS = {
    "qwen2": dict(use_attention_bias=True),
    "gpt2": dict(layer_norm_type="layer", mlp_type="fc", use_mlp_bias=True,
                 use_attention_bias=True, use_attn_proj_bias=True,
                 apply_rotary=False, abs_position_embedding=True,
                 activation_function="gelu_new", tied_embedding=True),
    "gemma": dict(layer_norm_type="gemma", normalize_embed=True,
                  attn_logits_soft_cap=20.0, final_logits_soft_cap=10.0,
                  sliding_window=6, activation_function="gelu_pytorch_tanh",
                  tied_embedding=True),
}
PAGE, N_PAGES = 8, 16


def _param_tree(jcfg, seed=0):
    """JAX init, then numpy noise on every leaf so biases and norm gains
    are not their trivial init values."""
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(np.asarray, jax_tfm.init_params(jcfg, jax.random.key(seed)))
    return jax.tree.map(
        lambda a: (a + rng.normal(scale=0.05, size=a.shape)).astype(np.float32),
        tree,
    )


def test_config_copy_matches_fields():
    import dataclasses

    assert [f.name for f in dataclasses.fields(PtConfig)] == [
        f.name for f in dataclasses.fields(JaxConfig)
    ]
    assert PtConfig(**COMMON).flash_enabled() is False


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_init_params_structure_matches_params_from_numpy(name):
    kw = dict(COMMON, **CONFIGS[name])
    tree = _param_tree(JaxConfig(**kw))
    conv = pt_tfm.params_from_numpy(tree, device="cpu")
    fresh = pt_tfm.init_params(PtConfig(**kw), seed=1, device="cpu")

    def shapes(t):
        return pt_tfm.tree_map(lambda x: tuple(x.shape), t)

    assert shapes(conv) == shapes(fresh)
    assert len(conv["layers"]) == kw["n_layers"]
    np.testing.assert_array_equal(
        conv["layers"][1]["attn"]["wq"].numpy(), tree["layers"]["attn"]["wq"][1]
    )


def test_params_from_numpy_bf16_leaves():
    import ml_dtypes

    tree = {"embed": {"weight": np.ones((4, 2), ml_dtypes.bfloat16)}}
    out = pt_tfm.params_from_numpy(tree, device="cpu")
    assert out["embed"]["weight"].dtype == torch.bfloat16
    out32 = pt_tfm.params_from_numpy(tree, device="cpu", dtype="float32")
    assert out32["embed"]["weight"].dtype == torch.float32


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_extend_and_decode_logits_match_jax(name, quant):
    kw = dict(COMMON, **CONFIGS[name])
    jcfg, pcfg = JaxConfig(**kw), PtConfig(**kw)
    tree = _param_tree(jcfg)
    jparams = jax.tree.map(jnp.asarray, tree)
    tparams = pt_tfm.params_from_numpy(tree, device="cpu")
    kv = "int8" if quant else None
    jcache = jax_tfm.PagedKVCache.empty(jcfg, N_PAGES, PAGE, kv_dtype=kv)
    tcache = pt_tfm.PagedKVCache.empty(pcfg, N_PAGES, PAGE, kv_dtype=kv,
                                       device="cpu")
    rng = np.random.default_rng(4)
    B, C, Mw = 3, 8, 4
    table = rng.permutation(N_PAGES)[: B * Mw].reshape(B, Mw).astype(np.int32)
    waves = [  # (start, n_new, skip_pool)
        (np.zeros(B, np.int32), np.asarray([8, 5, 8], np.int32), True),
        (np.asarray([8, 5, 8], np.int32), np.asarray([6, 8, 2], np.int32),
         False),
    ]
    for start, n_new, skip in waves:
        tokens = rng.integers(0, 128, size=(B, C)).astype(np.int32)
        jcache = jax_tfm.extend_paged(
            jparams, jcfg, jcache, tokens, table, start, n_new, skip_pool=skip
        )
        pt_tfm.extend_paged(
            tparams, pcfg, tcache, torch.from_numpy(tokens).long(),
            torch.from_numpy(table), torch.from_numpy(start),
            torch.from_numpy(n_new), skip_pool=skip,
        )
    lens = np.asarray([14, 13, 10], np.int32)
    cur = rng.integers(0, 128, size=(B,)).astype(np.int32)
    active = np.asarray([True, True, False])
    jlogits, jcache, jlens = jax_tfm.decode_step_paged(
        jparams, jcfg, jcache, cur, table, lens, active, use_pallas=False
    )
    tlogits, tcache, tlens = pt_tfm.decode_step_paged(
        tparams, pcfg, tcache, torch.from_numpy(cur).long(),
        torch.from_numpy(table), torch.from_numpy(lens),
        torch.from_numpy(active),
    )
    assert tlogits.shape == (B, 128) and tlogits.dtype == torch.float32
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), **TOL)
    np.testing.assert_array_equal(tlens.numpy(), np.asarray(jlens))
    if quant:
        # int8 codes may differ by one where a value sits on a rounding
        # edge after f32 noise; the dequantized pools agree to the tolerance
        got = tcache.pages.float() * tcache.scales[..., None]
        want = np.asarray(jcache.pages, np.float32) * np.asarray(
            jcache.scales
        )[..., None]
        np.testing.assert_allclose(got.numpy(), want, atol=2e-3)
    else:
        np.testing.assert_allclose(
            tcache.pages.numpy(), np.asarray(jcache.pages), **TOL
        )
