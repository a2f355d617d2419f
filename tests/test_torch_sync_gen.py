"""Port parity: the dense-KV generation path of ``areal_tpu_torch`` against
``areal_tpu`` on tiny float32 configs.

- ``ops/attention.py::decode_attention`` (GQA, sliding window, soft cap, a
  row with ``cache_lens == 0``) to 1e-5;
- ``models/transformer.py``: ``prefill`` logits and cache, then 4
  ``decode_step``s with a partly inactive row, to 1e-4;
- ``train/generation.py::SyncGenerator``: greedy tokens equal to the JAX
  generator's, ``gen_logprobs`` to 1e-4, over uneven prompts, padding and
  stop tokens; the ports of ``tests/test_sync_ppo.py``'s generator tests
  (shapes, greedy determinism, stop tokens); one program per key.

One param tree (numpy, from a seed) feeds both packages through
``params_from_numpy``. float32 on both sides: the differences are
accumulation order only. The port's prefill runs its rows as one packed
axis (the flash layout); on the CPU that is the plain version.
"""

import gc
import weakref

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from areal_tpu.api.model import GenerationHyperparameters as JaxGHP
from areal_tpu.models import transformer as jax_tfm
from areal_tpu.models.config import ModelConfig as JaxConfig
from areal_tpu.ops import attention as jax_attn
from areal_tpu.train.engine import TrainEngine as JaxEngine
from areal_tpu.train.generation import SyncGenerator as JaxSyncGenerator
from areal_tpu_torch.api.model import GenerationHyperparameters
from areal_tpu_torch.models import transformer as pt_tfm
from areal_tpu_torch.models.config import ModelConfig as PtConfig
from areal_tpu_torch.ops import attention as pt_attn
from areal_tpu_torch.train.engine import TrainEngine
from areal_tpu_torch.train.generation import SyncGenerator


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TINY = dict(n_layers=2, n_q_heads=4, n_kv_heads=2, head_dim=8, hidden_dim=32,
            intermediate_dim=64, vocab_size=128, dtype="float32")
CONFIGS = {
    "qwen2": dict(use_attention_bias=True),
    "gpt2": dict(layer_norm_type="layer", mlp_type="fc", use_mlp_bias=True,
                 use_attention_bias=True, use_attn_proj_bias=True,
                 apply_rotary=False, abs_position_embedding=True,
                 n_positions=256, activation_function="gelu_new",
                 tied_embedding=True),
    "gemma": dict(layer_norm_type="gemma", normalize_embed=True,
                  attn_logits_soft_cap=20.0, final_logits_soft_cap=10.0,
                  sliding_window=6, activation_function="gelu_pytorch_tanh",
                  tied_embedding=True),
}


def _param_tree(jcfg, seed=0):
    """JAX init, then numpy noise on every leaf (biases and norm gains off
    their trivial init values)."""
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(np.asarray, jax_tfm.init_params(jcfg, jax.random.key(seed)))
    return jax.tree.map(
        lambda a: (a + rng.normal(scale=0.05, size=a.shape)).astype(np.float32),
        tree,
    )


# --------------------------------------------------------------------------- #
# decode_attention
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("H,Hkv,window,cap", [
    (4, 2, None, None), (6, 1, 3, None), (8, 8, None, 5.0), (4, 2, 4, 5.0),
])
def test_decode_attention_matches_the_reference(H, Hkv, window, cap):
    rng = np.random.default_rng(H * 10 + Hkv)
    B, S, D = 4, 12, 8
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    lens = np.array([5, 0, 12, 1], np.int32)       # row 1: nothing resident
    kw = dict(softmax_scale=0.3, soft_cap=cap, sliding_window=window)
    want = np.asarray(jax_attn.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens), **kw))
    got = pt_attn.decode_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(lens), **kw).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    assert not got[1].any()


# --------------------------------------------------------------------------- #
# prefill + decode_step
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_prefill_and_decode_steps_match_the_reference(name):
    kw = dict(TINY, **CONFIGS[name])
    jcfg, pcfg = JaxConfig(**kw), PtConfig(**kw)
    tree = _param_tree(jcfg)
    jparams = jax.tree.map(jnp.asarray, tree)
    pparams = pt_tfm.params_from_numpy(tree, device="cpu")
    rng = np.random.default_rng(1)
    B, Sp, S = 3, 16, 32
    plens = np.array([16, 5, 1], np.int32)
    ids = np.zeros((B, Sp), np.int32)
    for b, n in enumerate(plens):
        ids[b, :n] = rng.integers(0, 128, n)
    jcache = jax_tfm.KVCache.empty(jcfg, B, S)
    jlog, jcache = jax_tfm.prefill(jparams, jcfg, jcache, jnp.asarray(ids),
                                   jnp.asarray(plens))
    pcache = pt_tfm.KVCache.empty(pcfg, B, S, device="cpu")
    plog, pcache = pt_tfm.prefill(pparams, pcfg, pcache,
                                  torch.from_numpy(ids).long(),
                                  torch.from_numpy(plens))
    tol = dict(atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(plog.numpy(), np.asarray(jlog), **tol)
    for a, b in ((pcache.k, jcache.k), (pcache.v, jcache.v)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **tol)
    np.testing.assert_array_equal(pcache.lens.numpy(), np.asarray(jcache.lens))
    # four steps; row 1 sits out the second and third
    for step in range(4):
        tok = rng.integers(0, 128, B).astype(np.int32)
        act = np.array([True, step not in (1, 2), True])
        jlog, jcache = jax_tfm.decode_step(jparams, jcfg, jcache,
                                           jnp.asarray(tok), jnp.asarray(act))
        plog, pcache = pt_tfm.decode_step(pparams, pcfg, pcache,
                                          torch.from_numpy(tok).long(),
                                          torch.from_numpy(act))
        np.testing.assert_allclose(plog.numpy(), np.asarray(jlog), **tol)
        for a, b in ((pcache.k, jcache.k), (pcache.v, jcache.v)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **tol)
        np.testing.assert_array_equal(pcache.lens.numpy(),
                                      np.asarray(jcache.lens))
    assert pcache.lens.tolist() == [20, 7, 5]


# --------------------------------------------------------------------------- #
# SyncGenerator
# --------------------------------------------------------------------------- #


def _engines(name="qwen2", seed=0):
    kw = dict(TINY, **CONFIGS[name])
    tree = _param_tree(JaxConfig(**kw), seed)
    jeng = JaxEngine(JaxConfig(**kw)).load_params(tree)
    peng = TrainEngine(PtConfig(**kw), device="cpu").load_params(tree)
    return jeng, peng


@pytest.fixture(scope="module")
def port_engine():
    return _engines()[1]


PROMPTS = [[1, 2, 3], [4, 5, 6, 7, 8, 9, 10], [11]]


@pytest.mark.parametrize("name,stop,min_new", [
    ("qwen2", [], 0), ("qwen2", [17, 40, 99], 2), ("gemma", [], 0),
    ("gpt2", [3, 8], 0),
])
def test_sync_generator_greedy_matches_the_reference(name, stop, min_new):
    jeng, peng = _engines(name)
    kw = dict(n=2, max_new_tokens=12, greedy=True, stop_token_ids=stop,
              min_new_tokens=min_new)
    want = JaxSyncGenerator(jeng).generate(PROMPTS, JaxGHP(**kw), seed=0)
    got = SyncGenerator(peng).generate(PROMPTS, GenerationHyperparameters(**kw),
                                       seed=0)
    assert len(got) == len(want) == 3
    for g_group, w_group in zip(got, want):
        assert len(g_group) == len(w_group) == 2
        for g, w in zip(g_group, w_group):
            np.testing.assert_array_equal(g.tokens, w.tokens)
            np.testing.assert_allclose(g.gen_logprobs, w.gen_logprobs,
                                       atol=1e-4, rtol=1e-4)
            assert g.no_eos == w.no_eos


def test_sync_generator_sampled_shapes_and_programs(port_engine):
    """Port of ``test_group_generation_shapes``, plus the program count: one
    per key, none for a repeated key, every step counted."""
    gen = SyncGenerator(port_engine)
    ghp = GenerationHyperparameters(n=3, max_new_tokens=8)
    prompts = [[1, 2, 3], [4, 5, 6, 7]]
    for seed in (0, 1):
        groups = gen.generate(prompts, ghp, seed=seed)
        assert len(groups) == 2 and all(len(g) == 3 for g in groups)
        for plist, group in zip(prompts, groups):
            for o in group:
                assert 1 <= len(o.gen_logprobs) <= 8
                assert len(o.tokens) == len(plist) + len(o.gen_logprobs)
                np.testing.assert_array_equal(o.tokens[: len(plist)], plist)
                assert np.all(o.gen_logprobs <= 0.0)
    assert gen.n_compiles() == 1
    assert gen.stats["decode_steps"] == 2 * 7
    # the CPU runs every step eagerly: no graph
    assert gen.stats["graph_captures"] == gen.stats["graph_replays"] == 0
    gen.generate([[1] * 70], ghp, seed=0)      # Sp 128: a second key
    assert gen.n_compiles() == 2


def test_sync_generator_keeps_only_the_current_key(port_engine):
    """A new key releases the previous key's cache and rows (the reference
    allocates its cache per call, so its memory is the largest call's); a
    key that comes back is built anew and gives the same tokens."""
    gen = SyncGenerator(port_engine)
    ghp = GenerationHyperparameters(n=2, max_new_tokens=6, greedy=True)
    first = gen.generate([[1, 2, 3]], ghp, seed=0)
    key64 = gen._state.key
    cache64 = weakref.ref(gen._state.cache.k)
    assert key64[1] == 64
    gen.generate([[1] * 70], ghp, seed=0)      # Sp 128
    assert gen._state.key[1] == 128
    gc.collect()
    assert cache64() is None                   # the Sp-64 cache is gone
    again = gen.generate([[1, 2, 3]], ghp, seed=0)
    assert gen._state.key == key64
    assert gen.n_compiles() == 3
    for a, b in zip(first[0], again[0]):
        np.testing.assert_array_equal(a.tokens, b.tokens)


def test_sync_generator_seeds(port_engine):
    gen = SyncGenerator(port_engine)
    ghp = GenerationHyperparameters(n=4, max_new_tokens=8)
    a = gen.generate([[1, 2, 3]], ghp, seed=5)[0]
    b = gen.generate([[1, 2, 3]], ghp, seed=5)[0]
    c = gen.generate([[1, 2, 3]], ghp, seed=6)[0]
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.tokens, y.tokens)
    assert any(not np.array_equal(x.tokens, y.tokens) for x, y in zip(a, c))


def test_sync_generator_greedy_is_deterministic(port_engine):
    gen = SyncGenerator(port_engine)
    ghp = GenerationHyperparameters(n=2, max_new_tokens=6, greedy=True)
    (g1,) = gen.generate([[1, 2, 3]], ghp, seed=0)
    (g2,) = gen.generate([[1, 2, 3]], ghp, seed=123)
    np.testing.assert_array_equal(g1[0].tokens, g2[0].tokens)
    np.testing.assert_array_equal(g1[0].tokens, g1[1].tokens)


def test_sync_generator_stop_token_terminates(port_engine):
    gen = SyncGenerator(port_engine)
    # stopping on every token id: generation ends after one token
    ghp = GenerationHyperparameters(
        n=1, max_new_tokens=8, stop_token_ids=list(range(128))
    )
    (group,) = gen.generate([[1, 2, 3]], ghp, seed=0)
    assert len(group[0].gen_logprobs) == 1
    assert not group[0].no_eos
    # no stopping: runs to max_new_tokens and reports truncation
    ghp2 = GenerationHyperparameters(n=1, max_new_tokens=8)
    (group2,) = gen.generate([[1, 2, 3]], ghp2, seed=0)
    assert len(group2[0].gen_logprobs) == 8
    assert group2[0].no_eos
    # min_new_tokens holds the stop back
    ghp3 = GenerationHyperparameters(n=1, max_new_tokens=8, min_new_tokens=3,
                                     stop_token_ids=list(range(128)))
    (group3,) = gen.generate([[1, 2, 3]], ghp3, seed=0)
    assert len(group3[0].gen_logprobs) == 3 and not group3[0].no_eos


def test_sync_generator_casts_the_masters_once_per_call():
    """The weights a call generates with are the engine's at the call: an
    update between calls reaches the next call through the static
    buffers."""
    _, peng = _engines()
    gen = SyncGenerator(peng)
    ghp = GenerationHyperparameters(n=1, max_new_tokens=6, greedy=True)
    before = gen.generate(PROMPTS, ghp)
    buf = gen._params["layers"][0]["attn"]["wq"]
    with torch.no_grad():
        for lp in peng.params["layers"]:
            lp["mlp"]["w_down"].mul_(-3.0)
    after = gen.generate(PROMPTS, ghp)
    assert gen._params["layers"][0]["attn"]["wq"] is buf
    fresh = SyncGenerator(peng).generate(PROMPTS, ghp)
    for a, f in zip(after, fresh):
        np.testing.assert_array_equal(a[0].tokens, f[0].tokens)
    assert any(not np.array_equal(a[0].tokens, b[0].tokens)
               for a, b in zip(after, before))
