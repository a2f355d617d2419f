"""Port parity: the weight-sync leg of ``areal_tpu_torch`` against
``areal_tpu``: the safetensors reader/writer against the ``safetensors``
package, the HF converters of both packages on tiny ``transformers``
checkpoints of every family, ``TrainEngine.save_hf`` / ``load_hf`` across
the two packages on disk (float32, bit for bit), the commit protocol, and
``POST /update_weights_from_disk`` on a CPU engine.
"""

import dataclasses
import json
import os
import struct
import threading
import time
import urllib.request

import numpy as np
import pytest
import safetensors.numpy
import safetensors.torch

import jax
import jax.numpy as jnp
import torch

from areal_tpu.gen import engine as jax_engine
from areal_tpu.models import hf as jax_hf
from areal_tpu.models import transformer as jax_tfm
from areal_tpu.models.config import ModelConfig as JaxConfig
from areal_tpu_torch.base import recover, safetensors_io
from areal_tpu_torch.gen import engine as pt_engine
from areal_tpu_torch.gen import server as pt_server
from areal_tpu_torch.models import hf as pt_hf
from areal_tpu_torch.models import transformer as pt_tfm
from areal_tpu_torch.models.config import ModelConfig as PtConfig
from areal_tpu_torch.train.engine import TrainEngine


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tensors here are tiny, so torch's intra-op thread pool buys nothing;
    one pool per test worker crowds out the timing-sensitive tests that
    other workers run beside this file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------------- #
# safetensors
# --------------------------------------------------------------------------- #


def _tensors():
    g = torch.Generator().manual_seed(0)
    return {
        "model.w": torch.randn(3, 5, generator=g),
        "model.half": torch.randn(7, generator=g).half(),
        "model.bf16": torch.randn(4, 6, generator=g).to(torch.bfloat16),
        "ids64": torch.arange(5) - 2,
        "ids32": torch.arange(6, dtype=torch.int32).reshape(2, 3),
        "q8": torch.arange(-3, 4, dtype=torch.int8),
        "mask": torch.tensor([True, False, True]),
        "scalar": torch.tensor(3.5),
        "empty": torch.zeros(0, 3),
        # a transposed view: its raw buffer is NOT its contents
        "view": torch.randn(4, 6, generator=g).T,
    }


@pytest.mark.parametrize("metadata", [None, {"format": "pt"}])
def test_written_file_is_byte_identical_to_the_package(tmp_path, metadata):
    t = _tensors()
    mine, theirs = tmp_path / "mine.safetensors", tmp_path / "theirs.safetensors"
    safetensors_io.save_file(t, str(mine), metadata=metadata)
    safetensors.torch.save_file({k: v.contiguous() for k, v in t.items()},
                                str(theirs), metadata=metadata)
    assert mine.read_bytes() == theirs.read_bytes()
    raw = mine.read_bytes()
    (n,) = struct.unpack("<Q", raw[:8])
    header = json.loads(raw[8:8 + n])
    assert header.get("__metadata__") == metadata
    assert header["view"]["shape"] == [6, 4]


def test_port_writes_what_the_package_reads(tmp_path):
    t = _tensors()
    path = str(tmp_path / "a.safetensors")
    safetensors_io.save_file(t, path)
    got = safetensors.torch.load_file(path)
    assert set(got) == set(t)
    for k, v in t.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        assert torch.equal(got[k], v), k
    as_np = safetensors.numpy.load_file(
        _without(path, t, {"model.bf16"}, tmp_path))
    for k, a in as_np.items():
        np.testing.assert_array_equal(a, t[k].numpy(), k)


def _without(path, tensors, drop, tmp_path):
    """numpy has no bfloat16: the numpy reader gets a file without it."""
    out = str(tmp_path / "no_bf16.safetensors")
    safetensors_io.save_file(
        {k: v for k, v in tensors.items() if k not in drop}, out)
    return out


def test_port_reads_what_the_package_writes(tmp_path):
    t = _tensors()
    path = str(tmp_path / "b.safetensors")
    safetensors.torch.save_file({k: v.contiguous() for k, v in t.items()},
                                path)
    got = safetensors_io.load_file(path)
    assert set(got) == set(t)
    for k, v in t.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        assert torch.equal(got[k], v), k
    # numpy arrays in, the numpy writer's file out: the same bytes
    arrays = {k: v.contiguous().numpy() for k, v in t.items()
              if v.dtype != torch.bfloat16}
    p1, p2 = str(tmp_path / "n1.safetensors"), str(tmp_path / "n2.safetensors")
    safetensors.numpy.save_file(arrays, p1)
    safetensors_io.save_file(arrays, p2)
    assert open(p1, "rb").read() == open(p2, "rb").read()


def test_reader_rejects_damaged_files(tmp_path):
    path = tmp_path / "c.safetensors"
    safetensors_io.save_file({"w": torch.ones(4)}, str(path))
    raw = path.read_bytes()
    (tmp_path / "short").write_bytes(raw[:5])
    with pytest.raises(ValueError, match="shorter than"):
        safetensors_io.load_file(str(tmp_path / "short"))
    (tmp_path / "cut").write_bytes(raw[:-4])
    with pytest.raises(ValueError, match="bad offsets"):
        safetensors_io.load_file(str(tmp_path / "cut"))
    with pytest.raises(ValueError, match="unsupported dtype"):
        safetensors_io.save_file({"w": torch.ones(2, dtype=torch.float64)},
                                 str(tmp_path / "f64"))


# --------------------------------------------------------------------------- #
# HF converters, both packages on the same tiny checkpoint
# --------------------------------------------------------------------------- #

TINY = dict(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, vocab_size=128,
            max_position_embeddings=128)
FAMILIES = ["llama", "mistral", "qwen2", "qwen3", "gemma", "gpt2", "mixtral"]


def _hf_model(family):
    import transformers

    torch.manual_seed(0)
    if family == "llama":
        cfg = transformers.LlamaConfig(**TINY, rope_theta=10000.0)
        model = transformers.LlamaForCausalLM(cfg)
    elif family == "mistral":
        cfg = transformers.MistralConfig(**TINY, sliding_window=None)
        model = transformers.MistralForCausalLM(cfg)
    elif family == "qwen2":
        cfg = transformers.Qwen2Config(**TINY)
        model = transformers.Qwen2ForCausalLM(cfg)
    elif family == "qwen3":
        cfg = transformers.Qwen3Config(**TINY, head_dim=8)
        model = transformers.Qwen3ForCausalLM(cfg)
    elif family == "gemma":
        cfg = transformers.GemmaConfig(**TINY, head_dim=8,
                                       hidden_act="gelu_pytorch_tanh")
        model = transformers.GemmaForCausalLM(cfg)
    elif family == "gpt2":
        cfg = transformers.GPT2Config(n_embd=32, n_layer=2, n_head=4,
                                      vocab_size=128, n_positions=128)
        model = transformers.GPT2LMHeadModel(cfg)
    elif family == "mixtral":
        cfg = transformers.MixtralConfig(**TINY, num_local_experts=4,
                                         num_experts_per_tok=2,
                                         router_aux_loss_coef=0.02)
        model = transformers.MixtralForCausalLM(cfg)
    else:
        raise ValueError(family)
    return cfg, model


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, np.asarray(tree)


def _assert_trees_equal(a, b):
    la, lb = dict(_leaves(a)), dict(_leaves(b))
    assert set(la) == set(lb)
    for k in la:
        assert la[k].dtype == lb[k].dtype and la[k].shape == lb[k].shape, k
        np.testing.assert_array_equal(la[k], lb[k], k)


@pytest.mark.parametrize("family", FAMILIES)
def test_family_converts_the_same_through_both_packages(family, tmp_path):
    hf_cfg, model = _hf_model(family)
    d = tmp_path / family
    model.save_pretrained(str(d), safe_serialization=True)
    want_cfg, want = jax_hf.load_hf_checkpoint(str(d))
    got_cfg, got = pt_hf.load_hf_checkpoint(str(d))
    assert dataclasses.asdict(got_cfg) == dataclasses.asdict(want_cfg)
    assert pt_hf.family_for_model_type(hf_cfg.model_type).name == family
    _assert_trees_equal(got, want)
    # and back: the same HF state dict and config from both
    fam_j, fam_p = jax_hf.HF_FAMILIES[family], pt_hf.HF_FAMILIES[family]
    assert fam_p.config_to_hf(got_cfg) == fam_j.config_to_hf(want_cfg)
    sd_j, sd_p = fam_j.params_to_hf(want, want_cfg), fam_p.params_to_hf(got, got_cfg)
    assert set(sd_j) == set(sd_p)
    for k in sd_j:
        np.testing.assert_array_equal(sd_p[k], sd_j[k], k)
    # through the port's tensors and back: nothing moves
    params = pt_tfm.params_from_numpy(got, device="cpu")
    _assert_trees_equal(pt_tfm.params_to_numpy(params), want)


def test_bf16_checkpoint_widens_exactly(tmp_path):
    hf_cfg, model = _hf_model("qwen2")
    d = tmp_path / "bf16"
    model.to(torch.bfloat16).save_pretrained(str(d), safe_serialization=True)
    _, got = pt_hf.load_hf_checkpoint(str(d))
    sd = safetensors.torch.load_file(str(d / "model.safetensors"))
    assert sd["model.embed_tokens.weight"].dtype == torch.bfloat16
    assert got["embed"]["weight"].dtype == np.float32
    np.testing.assert_array_equal(
        got["embed"]["weight"], sd["model.embed_tokens.weight"].float().numpy())
    np.testing.assert_array_equal(
        got["layers"]["attn"]["wq"][1],
        sd["model.layers.1.self_attn.q_proj.weight"].float().numpy().T)


def test_unknown_family_and_moe_raise():
    """An unknown ``model_type`` raises; mixtral, the MoE family, is
    registered, and the port knows the reference's families."""
    with pytest.raises(KeyError, match="No converter"):
        pt_hf.family_for_model_type("mixtral2")
    assert pt_hf.family_for_model_type("mixtral").name == "mixtral"
    assert set(pt_hf.HF_FAMILIES) == set(jax_hf.HF_FAMILIES)


def test_mixtral_logits_match_transformers(tmp_path):
    """A tiny ``MixtralForCausalLM`` (4 experts, top 2): its logits against
    the port's ``forward_packed`` on the converted checkpoint, two packed
    sequences (float32 both sides; atol 1e-4)."""
    _, model = _hf_model("mixtral")
    d = tmp_path / "mixtral"
    model.save_pretrained(str(d), safe_serialization=True)
    cfg, host = pt_hf.load_hf_checkpoint(str(d))
    cfg = dataclasses.replace(cfg, dtype="float32")
    params = pt_tfm.params_from_numpy(host, device="cpu")
    rng = np.random.default_rng(0)
    seqs = [rng.integers(0, 128, n).tolist() for n in (13, 21)]
    with torch.no_grad():
        want = [model(torch.tensor([s])).logits[0].numpy() for s in seqs]
        got = pt_tfm.forward_packed(
            params, cfg, torch.tensor(seqs[0] + seqs[1]),
            torch.tensor([1] * 13 + [2] * 21, dtype=torch.int32),
            torch.tensor(list(range(13)) + list(range(21)), dtype=torch.int32))
    np.testing.assert_allclose(got.numpy(), np.concatenate(want), atol=1e-4,
                               rtol=1e-4)


def test_mixtral_checkpoints_load_across_the_packages_bit_for_bit(tmp_path):
    """A Mixtral checkpoint written by either package loads in the other to
    the bit (the ``[L, X, E, F]`` expert leaves included)."""
    from areal_tpu.models.config import MoEConfig as JaxMoE
    from areal_tpu_torch.models.config import MoEConfig as PtMoE

    moe = dict(num_experts=4, top_k=2, aux_loss_coeff=0.02)
    kw = dict(CFG_KW, use_attention_bias=False, mlp_type="moe")
    jcfg, pcfg = JaxConfig(**kw, moe=JaxMoE(**moe)), PtConfig(**kw,
                                                              moe=PtMoE(**moe))
    tree = jax.device_get(jax_tfm.init_params(jcfg, jax.random.key(3)))
    pt_hf.save_hf_checkpoint(tree, pcfg, "mixtral", str(tmp_path / "port"))
    jax_hf.save_hf_checkpoint(tree, jcfg, "mixtral", str(tmp_path / "jax"))
    for src, load in (("port", jax_hf.load_hf_checkpoint),
                      ("jax", pt_hf.load_hf_checkpoint)):
        cfg, got = load(str(tmp_path / src))
        assert cfg.mlp_type == "moe" and cfg.moe.num_experts == 4
        _assert_trees_equal(jax.tree.map(np.asarray, got),
                            jax.tree.map(np.asarray, tree))
    assert got["layers"]["mlp"]["w_gate"].shape == (2, 4, 32, 64)


# --------------------------------------------------------------------------- #
# save_hf / load_hf across the packages, the commit protocol
# --------------------------------------------------------------------------- #

CFG_KW = dict(n_layers=2, n_q_heads=4, n_kv_heads=2, head_dim=8,
              hidden_dim=32, intermediate_dim=64, vocab_size=128,
              use_attention_bias=True, dtype="float32")


@pytest.fixture(scope="module")
def tree():
    return jax.tree.map(
        np.asarray, jax_tfm.init_params(JaxConfig(**CFG_KW), jax.random.key(9))
    )


def test_port_save_hf_loads_in_the_jax_package_bit_for_bit(tree, tmp_path):
    eng = TrainEngine(PtConfig(**CFG_KW), device="cpu").load_params(tree)
    eng.version, eng._step = 4, 7
    path = str(tmp_path / "export")
    assert eng.save_hf(path, "qwen2") is None
    assert recover.read_manifest(path) == {"step": 7, "version": 4,
                                           "format": "hf"}
    assert sorted(os.listdir(tmp_path)) == ["export"]       # no staging left
    cfg, got = jax_hf.load_hf_checkpoint(path)
    assert cfg.n_layers == 2 and cfg.use_attention_bias
    _assert_trees_equal(got, tree)
    # the export is a checkpoint transformers itself reads
    hf_cfg = json.load(open(os.path.join(path, "config.json")))
    assert hf_cfg["model_type"] == "qwen2"


def test_jax_save_hf_checkpoint_loads_in_the_port_bit_for_bit(tree, tmp_path):
    path = str(tmp_path / "from_jax")
    jax_hf.save_hf_checkpoint(jax.tree.map(jnp.asarray, tree),
                              JaxConfig(**CFG_KW), "qwen2", path)
    eng = TrainEngine(PtConfig(**CFG_KW), device="cpu").load_hf(path)
    assert eng.hf_family == "qwen2"
    _assert_trees_equal(pt_tfm.params_to_numpy(eng.params), tree)
    assert all(t.requires_grad for t in eng.params["layers"][0]["attn"].values())


def test_critic_head_kept_or_seeded(tree, tmp_path):
    critic_kw = dict(CFG_KW, is_critic=True)
    crit = dict(tree)
    crit["head"] = {"weight": np.random.default_rng(1).normal(
        size=(32, 1)).astype(np.float32)}
    eng = TrainEngine(PtConfig(**critic_kw), device="cpu").load_params(crit)
    path = str(tmp_path / "critic")
    eng.save_hf(path, "qwen2")
    sd = safetensors.numpy.load_file(os.path.join(path, "model.safetensors"))
    np.testing.assert_array_equal(sd["score.weight"], crit["head"]["weight"].T)
    assert "lm_head.weight" not in sd
    assert json.load(open(os.path.join(path, "config.json")))["is_critic"]
    # both packages read the trained head back, and init_critic_head keeps it
    jcfg, jgot = jax_hf.load_hf_checkpoint(path)
    assert jcfg.is_critic
    np.testing.assert_array_equal(jgot["head"]["weight"], crit["head"]["weight"])
    again = TrainEngine(PtConfig(**critic_kw), device="cpu").load_hf(
        path, init_critic_head=True)
    np.testing.assert_array_equal(
        again.params["head"]["weight"].detach().numpy(), crit["head"]["weight"])
    # a CausalLM checkpoint: the lm head goes, the reference's seeded head
    # (numpy default_rng(0), std 0.02) comes
    actor = str(tmp_path / "actor")
    TrainEngine(PtConfig(**CFG_KW), device="cpu").load_params(tree).save_hf(
        actor, "qwen2")
    seeded = TrainEngine(PtConfig(**critic_kw), device="cpu").load_hf(
        actor, init_critic_head=True)
    want = (np.random.default_rng(0).standard_normal((32, 1)) * 0.02
            ).astype(np.float32)
    np.testing.assert_array_equal(
        seeded.params["head"]["weight"].detach().numpy(), want)


def test_async_write_returns_the_thread_and_surfaces_failures(tree, tmp_path):
    eng = TrainEngine(PtConfig(**CFG_KW), device="cpu").load_params(tree)
    called = []
    t = eng.save_hf(str(tmp_path / "bg"), "qwen2", async_write=True,
                    post_write=lambda: called.append(1))
    assert isinstance(t, threading.Thread)
    t.join(60)
    assert not t.is_alive() and t._areal_exc is None and called == [1]
    assert recover.is_committed(str(tmp_path / "bg"))
    # the host copy was taken before save_hf returned
    with torch.no_grad():
        eng.params["embed"]["weight"].zero_()
    _, got = pt_hf.load_hf_checkpoint(str(tmp_path / "bg"))
    np.testing.assert_array_equal(got["embed"]["weight"],
                                  tree["embed"]["weight"])
    bad = eng.save_hf(str(tmp_path / "bg2"), "no_such_family",
                      async_write=True)
    bad.join(60)
    assert isinstance(bad._areal_exc, KeyError)
    assert not os.path.exists(tmp_path / "bg2")


def test_crash_between_staging_and_commit_keeps_the_old_export(
        tree, tmp_path, monkeypatch):
    path = str(tmp_path / "sync")
    eng = TrainEngine(PtConfig(**CFG_KW), device="cpu").load_params(tree)
    eng.save_hf(path, "qwen2")
    eng.version = 1
    with torch.no_grad():
        eng.params["embed"]["weight"].mul_(2.0)

    def crash(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(recover, "commit_checkpoint", crash)
    with pytest.raises(OSError, match="disk full"):
        eng.save_hf(path, "qwen2")
    monkeypatch.undo()
    # the staged, uncommitted attempt is there; readers still get version 0
    assert os.path.isdir(recover.staging_path(path, "hf"))
    assert not recover.is_committed(recover.staging_path(path, "hf"))
    assert recover.resolve_committed(path) == path
    assert recover.read_manifest(path)["version"] == 0
    assert not os.path.exists(recover.staging_path(path, "hf"))
    _, got = pt_hf.load_hf_checkpoint(path)
    np.testing.assert_array_equal(got["embed"]["weight"],
                                  tree["embed"]["weight"])
    # a crash after the manifest, before the renames: the committed staging
    # dir is newer and gets promoted
    staging = recover.prepare_staging(path, "hf")
    pt_hf.save_hf_checkpoint(pt_tfm.params_to_numpy(eng.params), eng.cfg,
                             "qwen2", staging)
    recover.write_manifest(staging, {"step": 1, "version": 1, "format": "hf"})
    assert recover.resolve_committed(path) == path
    assert recover.read_manifest(path)["version"] == 1
    _, got = pt_hf.load_hf_checkpoint(path)
    np.testing.assert_array_equal(got["embed"]["weight"],
                                  tree["embed"]["weight"] * 2.0)
    recover.discard_checkpoint(path)
    assert recover.resolve_committed(path) is None


# --------------------------------------------------------------------------- #
# POST /update_weights_from_disk
# --------------------------------------------------------------------------- #


def _call(port, path, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=data,
        method="GET" if data is None else "POST",
    )
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, json.loads(r.read())


@pytest.fixture
def sync_world(tree, tmp_path):
    """A server on the seed's weights and an export of OTHER weights (the
    tree scaled by 0.5, as a train step would have moved it)."""
    cfg = PtConfig(**CFG_KW)
    eng = pt_engine.GenerationEngine(
        cfg, pt_tfm.params_from_numpy(tree, device="cpu"), max_slots=2,
        max_seqlen=1024, page_size=8, device="cpu")
    new = jax.tree.map(lambda a: (a * 0.5).astype(np.float32), tree)
    path = str(tmp_path / "export")
    trainer = TrainEngine(cfg, device="cpu").load_params(new)
    trainer.version = 5
    trainer.save_hf(path, "qwen2")
    srv = pt_server.serve(eng, "127.0.0.1", 0, decode_steps=4)
    yield srv, path, new
    srv.stop()


PROMPT = [7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17]


def _jax_greedy(path, n):
    """Greedy tokens of the JAX engine loading the same directory."""
    cfg, host = jax_hf.load_hf_checkpoint(path)
    cfg = dataclasses.replace(cfg, dtype="float32")
    eng = jax_engine.GenerationEngine(
        cfg, jax.tree.map(jnp.asarray, host), max_slots=2, max_seqlen=1024,
        page_size=8)
    eng.submit(jax_engine.GenRequest(rid="j", input_ids=PROMPT,
                                     max_new_tokens=n, greedy=True))
    return eng.run_until_done(decode_steps=4)[0].output_ids


@pytest.mark.parametrize("overlap", [True, False])
def test_update_weights_with_interrupt(sync_world, overlap):
    srv, path, _ = sync_world
    got = {}
    body = {"rid": "long", "input_ids": PROMPT,
            "sampling_params": {"max_new_tokens": 1000, "greedy": True}}
    t = threading.Thread(
        target=lambda: got.update(ans=_call(srv.port, "/generate", body)))
    t.start()
    deadline = time.time() + 60
    while srv.engine.stats["decode_steps"] < 4:
        assert time.time() < deadline
        time.sleep(0.01)
    assert len(srv.engine.prefix) > 0
    status, ans = _call(srv.port, "/update_weights_from_disk", {
        "model_path": path, "version": 5, "allow_interrupt": True,
        "overlap_load": overlap})
    assert status == 200 and ans["success"], ans
    assert ans["num_paused_requests"] == 1
    t.join(60)
    status, partial = got["ans"]
    assert status == 200 and partial["finish_reason"] == "interrupted"
    assert 0 < len(partial["output_ids"]) < 1000 and partial["version"] == 0
    m = _call(srv.port, "/metrics_json")[1]
    assert m["version"] == 5 and m["n_weight_updates"] == 1
    assert m["n_interrupted"] == 1 and m["paused"] is False
    assert m["prefix_pages"] == 0             # old-weight KV must not seed
    assert (m["weight_load_overlapped_s"] > 0) == overlap
    status, after = _call(srv.port, "/generate", {
        "rid": "after", "input_ids": PROMPT,
        "sampling_params": {"max_new_tokens": 12, "greedy": True}})
    assert after["version"] == 5
    assert after["output_ids"] == _jax_greedy(path, 12)


def test_update_weights_with_drain(sync_world):
    srv, path, _ = sync_world
    got = {}
    body = {"rid": "short", "input_ids": PROMPT,
            "sampling_params": {"max_new_tokens": 40, "greedy": True}}
    t = threading.Thread(
        target=lambda: got.update(ans=_call(srv.port, "/generate", body)))
    t.start()
    deadline = time.time() + 60
    while srv.engine.stats["decode_steps"] < 4:
        assert time.time() < deadline
        time.sleep(0.01)
    status, ans = _call(srv.port, "/update_weights_from_disk", {
        "model_path": path, "allow_interrupt": False})
    assert ans["success"] and ans["num_paused_requests"] == 0
    t.join(60)
    status, done = got["ans"]
    # drained to completion under the old weights
    assert done["finish_reason"] == "length" and len(done["output_ids"]) == 40
    assert done["version"] == 0
    m = _call(srv.port, "/metrics_json")[1]
    assert m["version"] == 1 and m["n_interrupted"] == 0   # no version given
    assert srv.engine.accepting and not srv.engine.paused


def test_failed_update_leaves_the_engine_untouched(sync_world, tmp_path):
    srv, path, _ = sync_world
    before = _call(srv.port, "/generate", {
        "rid": "b", "input_ids": PROMPT,
        "sampling_params": {"max_new_tokens": 8, "greedy": True}})[1]
    params_before = srv.engine.params
    for overlap in (True, False):
        status, ans = _call(srv.port, "/update_weights_from_disk", {
            "model_path": str(tmp_path / "missing"), "version": 9,
            "overlap_load": overlap})
        assert status == 200 and ans["success"] is False
        assert "weight update failed" in ans["message"]
    # a checkpoint of another architecture is refused too
    other = str(tmp_path / "other")
    ocfg = PtConfig(**dict(CFG_KW, n_layers=1))
    TrainEngine(ocfg, device="cpu").init_random(0).save_hf(other, "qwen2")
    ans = _call(srv.port, "/update_weights_from_disk",
                {"model_path": other})[1]
    assert ans["success"] is False and "n_layers" in ans["message"]
    ans = _call(srv.port, "/update_weights_from_disk", {
        "model_path": path, "draft_model_path": path})[1]
    assert ans["success"] is False and "draft model" in ans["message"]
    assert srv.engine.params is params_before and srv.engine.version == 0
    assert not srv.engine.paused
    after = _call(srv.port, "/generate", {
        "rid": "a", "input_ids": PROMPT,
        "sampling_params": {"max_new_tokens": 8, "greedy": True}})[1]
    assert after["output_ids"] == before["output_ids"]
    assert after["version"] == 0
