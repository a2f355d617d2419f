"""Port parity: the dataflow-graph layer of ``areal_tpu_torch`` (``api/dfg.py``,
``experiments/graphs.py``, ``system/function_executor.py``) against
``areal_tpu`` on the CPU.

- graph building: both packages level-order the same MFCs identically and
  raise the same errors (missing input, duplicate producer, cycle, bad
  interface type);
- the PPO recipes: node names, levels and hooks for critic on/off, ref
  on/off, ``kl_ctl == 0`` (no ``ref_inf``), the EMA hook and
  ``ref_logprobs_in_batch``; the port raises ``NotImplementedError`` for a
  reward model;
- one graph-driven PPO step through both executors on the same batch and
  params (tiny float32 model, as ``tests/test_torch_train.py``): stats to
  rtol 1e-4, the analytic FLOP count exactly, params to an atol of 1% of
  lr (Adam divides by sqrt(v): summation-order noise in near-zero
  gradients grows up to ~lr in the update);
- the EMA hook against the JAX ``_param_realloc`` (f32 both sides,
  atol 1e-7).
"""

import numpy as np
import pytest

import jax
import torch

from areal_tpu.api import data as jax_data
from areal_tpu.api import dfg as jax_dfg
from areal_tpu.api import model as jax_model
from areal_tpu.experiments import graphs as jax_graphs
from areal_tpu.models.config import ModelConfig as JaxConfig
from areal_tpu.system import function_executor as jax_fe
from areal_tpu.train import engine as jax_engine
from areal_tpu_torch.api import data as pt_data
from areal_tpu_torch.api import dfg as pt_dfg
from areal_tpu_torch.api import model as pt_model
from areal_tpu_torch.experiments import graphs as pt_graphs
from areal_tpu_torch.models import transformer as pt_tfm
from areal_tpu_torch.models.config import ModelConfig as PtConfig
from areal_tpu_torch.system import function_executor as pt_fe
from areal_tpu_torch.train import engine as pt_engine

MODEL = dict(n_layers=2, n_q_heads=4, n_kv_heads=2, head_dim=8,
             hidden_dim=32, intermediate_dim=64, vocab_size=128,
             dtype="float32", use_attention_bias=True)
LR = 1e-3
SPEC = dict(max_tokens_per_mb=64)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mfc(mod, name, model="m", itype="inference", ins=(), outs=()):
    return mod.MFCDef(name=name, model_name=model, interface_type=itype,
                      input_keys=tuple(ins), output_keys=tuple(outs))


# --------------------------------------------------------------------------- #
# graph building
# --------------------------------------------------------------------------- #

GRAPHS = {
    "level_order": ([("train", "train_step", ("ids", "adv"), ()),
                     ("inf_a", "inference", ("ids",), ("lp",)),
                     ("inf_b", "inference", ("ids", "lp"), ("adv",))],
                    ("ids",), None),
    "missing_input": ([("t", "inference", ("adv",), ())], ("ids",),
                      "needs key 'adv'"),
    "duplicate_producer": ([("a", "inference", (), ("x",)),
                            ("b", "inference", (), ("x",))], (),
                           "produced by both"),
    "cycle": ([("a", "inference", ("y",), ("x",)),
               ("b", "inference", ("x",), ("y",))], (), "cycle"),
    "duplicate_name": ([("a", "inference", (), ()),
                        ("a", "inference", (), ())], (), "duplicate MFC"),
}


@pytest.mark.parametrize("case", sorted(GRAPHS))
def test_build_graph_matches(case):
    nodes, batch_keys, error = GRAPHS[case]
    results = []
    for mod in (jax_dfg, pt_dfg):
        mfcs = [_mfc(mod, n, itype=t, ins=i, outs=o) for n, t, i, o in nodes]
        if error is None:
            g = mod.build_graph(mfcs, batch_keys=batch_keys)
            results.append(([[m.name for m in lvl] for lvl in g.levels],
                            g.producers))
        else:
            with pytest.raises(ValueError, match=error) as e:
                mod.build_graph(mfcs, batch_keys=batch_keys)
            results.append(str(e.value))
    assert results[0] == results[1]
    if case == "level_order":
        assert results[1][0] == [["inf_a"], ["inf_b"], ["train"]]


def test_bad_interface_type_raises_in_both():
    for mod in (jax_dfg, pt_dfg):
        with pytest.raises(ValueError, match="interface_type"):
            mod.MFCDef(name="x", model_name="m", interface_type="trane_step")


# --------------------------------------------------------------------------- #
# the PPO recipes
# --------------------------------------------------------------------------- #

RECIPES = {
    "grpo_minimal": (dict(disable_value=True), dict(use_ref=False,
                                                    use_critic=False)),
    "full_ppo": ({}, dict(use_ref=True, use_critic=True)),
    "ref_no_critic": ({}, dict(use_ref=True, use_critic=False)),
    "kl_zero_skips_ref_inf": (dict(kl_ctl=0.0), dict(use_ref=True,
                                                     use_critic=False)),
    "ema_ref": ({}, dict(use_ref=True, use_critic=False, ema_ref_eta=0.3)),
    "ema_ref_kl_zero": (dict(kl_ctl=0.0), dict(use_ref=True, use_critic=False,
                                               ema_ref_eta=0.5)),
    "ref_logprobs_in_batch": ({}, dict(use_ref=False, use_critic=False,
                                       ref_logprobs_in_batch=True)),
    "no_decoupled_loss": (dict(use_decoupled_loss=False,
                               recompute_logprob=False),
                          dict(use_ref=False, use_critic=True)),
}


def _describe(graph, ifaces):
    return dict(
        names=graph.names,
        levels=[[m.name for m in lvl] for lvl in graph.levels],
        inputs={m.name: sorted(m.input_keys) for m in graph.mfcs},
        outputs={m.name: sorted(m.output_keys) for m in graph.mfcs},
        remap={m.name: dict(m.output_key_remap) for m in graph.mfcs},
        hooks={m.name: [(h.source, h.target, h.eta) for h in m.post_hooks]
               for m in graph.mfcs},
        producers=dict(graph.producers),
        interfaces=sorted(ifaces),
    )


@pytest.mark.parametrize("case", sorted(RECIPES))
def test_ppo_graph_matches(case):
    hp, kw = RECIPES[case]
    jg, ji = jax_graphs.build_ppo_graph(jax_model.PPOHyperparameters(**hp), **kw)
    pg, pi = pt_graphs.build_ppo_graph(pt_model.PPOHyperparameters(**hp), **kw)
    assert _describe(pg, pi) == _describe(jg, ji)
    # one interface drives every actor node (one KL controller); the
    # critic shares it
    assert pi["actor_train"] is pi.get("actor_inf", pi["actor_train"])
    if "critic_train" in pi:
        assert pi["critic_train"].kl_ctl is pi["actor_train"].kl_ctl
    if case == "full_ppo":
        assert _describe(pg, pi)["levels"] == [
            ["actor_inf", "critic_inf", "ref_inf"],
            ["actor_train", "critic_train"]]
    if case == "kl_zero_skips_ref_inf":
        assert "ref_inf" not in pg.names


def test_ppo_graph_errors():
    for graphs, model in ((jax_graphs, jax_model), (pt_graphs, pt_model)):
        with pytest.raises(ValueError, match="EMA reference requires"):
            graphs.build_ppo_graph(model.PPOHyperparameters(), use_ref=False,
                                   use_critic=False, ema_ref_eta=0.3)
    with pytest.raises(NotImplementedError, match="reward"):
        pt_graphs.build_ppo_graph(pt_model.PPOHyperparameters(), use_ref=False,
                                  use_critic=False, use_reward_model=True)


# --------------------------------------------------------------------------- #
# the executor
# --------------------------------------------------------------------------- #


def _batch(mod, seed, n=6):
    """A rollout batch as ``mod.SequenceSample``: one sequence per item,
    a 2-token prompt, behaviour logprobs on the generated tokens."""
    rng = np.random.default_rng(seed)
    lens = [int(x) for x in rng.integers(6, 12, size=n)]
    lps = []
    for ln in lens:
        lp = np.zeros(ln, np.float32)
        lp[1:ln - 1] = rng.normal(size=ln - 2) * 0.1 - 1.0
        lps.append(lp)
    return mod.SequenceSample.from_default(
        ids=list(range(n)), seqlens=lens,
        data={
            "packed_input_ids": rng.integers(0, 128, sum(lens)).astype(np.int64),
            "prompt_mask": np.concatenate(
                [np.r_[np.ones(2, bool), np.zeros(ln - 2, bool)] for ln in lens]
            ),
            "packed_logprobs": np.concatenate(lps),
            "rewards": rng.normal(size=n).astype(np.float32),
            "seq_no_eos_mask": np.zeros(n, bool),
        },
    )


def _engine_pair(seed, with_optimizer=True):
    j = jax_engine.TrainEngine(
        JaxConfig(**MODEL),
        optimizer=jax_engine.OptimizerConfig(lr=LR) if with_optimizer else None,
    ).init_random(seed)
    p = pt_engine.TrainEngine(
        PtConfig(**MODEL),
        optimizer=pt_engine.OptimizerConfig(lr=LR) if with_optimizer else None,
        device="cpu",
    ).load_params(jax.device_get(j.params))
    if with_optimizer:
        j.setup_optimizer(100)
        p.setup_optimizer(100)
    return j, p


def _assert_params_match(jparams, pparams, atol):
    want = dict(jax.tree_util.tree_leaves_with_path(jax.device_get(jparams)))
    got = dict(jax.tree_util.tree_leaves_with_path(
        pt_tfm.params_to_numpy(pparams)))
    assert set(want) == set(got)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], np.asarray(w), atol=atol, rtol=0,
                                   err_msg=jax.tree_util.keystr(k))


def test_graph_driven_ppo_step_matches():
    """actor_inf + ref_inf -> actor_train (decoupled loss, KL penalty, two
    minibatches), the same batch through both executors, two steps."""
    hp = dict(ppo_n_minibatches=2, use_decoupled_loss=True, kl_ctl=0.05,
              adv_norm=True)
    jact, pact = _engine_pair(3)
    jref, pref = _engine_pair(4, with_optimizer=False)
    jg, ji = jax_graphs.build_ppo_graph(
        jax_model.PPOHyperparameters(**hp), use_ref=True, use_critic=False,
        mb_spec=jax_data.MicroBatchSpec(**SPEC))
    pg, pi = pt_graphs.build_ppo_graph(
        pt_model.PPOHyperparameters(**hp), use_ref=True, use_critic=False,
        mb_spec=pt_data.MicroBatchSpec(**SPEC))
    jex = jax_fe.FunctionExecutor(jg, {"actor": jact, "ref": jref}, ji)
    pex = pt_fe.FunctionExecutor(pg, {"actor": pact, "ref": pref}, pi)
    for step, seed in enumerate((11, 12), start=1):
        js, ps = _batch(jax_data, seed), _batch(pt_data, seed)
        jst, pst = jex.run(js), pex.run(ps)
        for k in ("prox_logp", "packed_ref_logprobs"):
            np.testing.assert_allclose(ps.data[k], js.data[k], atol=1e-5,
                                       rtol=1e-5, err_msg=k)
        assert set(pst) == set(jst)
        assert pst["flops"] == jst["flops"]
        for k in jst:
            np.testing.assert_allclose(pst[k], jst[k], rtol=1e-4, atol=1e-6,
                                       err_msg=k)
        assert pact.version == jact.version == step
        _assert_params_match(jact.params, pact.params, atol=0.01 * LR * step)


def test_ema_hook_matches_jax_param_realloc():
    rng = np.random.default_rng(0)
    src = {"a": rng.normal(size=(3, 4)).astype(np.float32),
           "layers": {"w": rng.normal(size=(2, 5)).astype(np.float32)}}
    dst = {"a": rng.normal(size=(3, 4)).astype(np.float32),
           "layers": {"w": rng.normal(size=(2, 5)).astype(np.float32)}}
    want = jax.device_get(jax_fe._param_realloc(
        jax.tree.map(jax.numpy.asarray, dst),
        jax.tree.map(jax.numpy.asarray, src), 0.3))
    pdst = {"a": torch.from_numpy(dst["a"].copy()),
            "layers": {"w": torch.from_numpy(dst["layers"]["w"].copy())}}
    keep = pdst["a"]
    pt_fe._param_realloc(
        pdst, {"a": torch.from_numpy(src["a"]),
               "layers": {"w": torch.from_numpy(src["layers"]["w"])}}, 0.3)
    assert pdst["a"] is keep                       # in place
    np.testing.assert_allclose(pdst["a"].numpy(), want["a"], atol=1e-7, rtol=0)
    np.testing.assert_allclose(pdst["layers"]["w"].numpy(),
                               want["layers"]["w"], atol=1e-7, rtol=0)


def test_ema_hook_moves_ref_toward_actor_in_both():
    """The EMA-ref recipe end to end: after the step, ref = 0.5 * ref0 +
    0.5 * actor1 on each side, and the two sides agree."""
    hp = dict(ppo_n_minibatches=1, disable_value=True, kl_ctl=0.05)
    jact, pact = _engine_pair(5)
    jref, pref = _engine_pair(6, with_optimizer=False)
    r0 = pt_tfm.params_to_numpy(pref.params)
    jg, ji = jax_graphs.build_ppo_graph(
        jax_model.PPOHyperparameters(**hp), use_ref=True, use_critic=False,
        ema_ref_eta=0.5, mb_spec=jax_data.MicroBatchSpec(**SPEC))
    pg, pi = pt_graphs.build_ppo_graph(
        pt_model.PPOHyperparameters(**hp), use_ref=True, use_critic=False,
        ema_ref_eta=0.5, mb_spec=pt_data.MicroBatchSpec(**SPEC))
    jax_fe.FunctionExecutor(jg, {"actor": jact, "ref": jref}, ji).run(
        _batch(jax_data, 21))
    pt_fe.FunctionExecutor(pg, {"actor": pact, "ref": pref}, pi).run(
        _batch(pt_data, 21))
    a1 = pt_tfm.params_to_numpy(pact.params)
    r1 = pt_tfm.params_to_numpy(pref.params)
    np.testing.assert_allclose(r1["embed"]["weight"],
                               0.5 * r0["embed"]["weight"]
                               + 0.5 * a1["embed"]["weight"], atol=1e-6)
    _assert_params_match(jref.params, pref.params, atol=0.5 * 0.01 * LR)


def test_undeclared_output_raises_in_both():
    results = []
    for dfg, graphs, fe, data, eng in (
            (jax_dfg, jax_graphs, jax_fe, jax_data, _engine_pair(7)[0]),
            (pt_dfg, pt_graphs, pt_fe, pt_data, _engine_pair(7)[1])):
        mfc = dfg.MFCDef(
            name="inf", model_name="actor", interface_type="inference",
            interface_impl="ppo_actor", input_keys=("packed_input_ids",),
            output_keys=("nonexistent_key",))
        g = dfg.build_graph([mfc], batch_keys=graphs.ROLLOUT_BATCH_KEYS)
        ex = fe.FunctionExecutor(g, {"actor": eng},
                                 default_mb_spec=data.MicroBatchSpec(**SPEC))
        with pytest.raises(ValueError, match="declared outputs") as e:
            ex.run(_batch(data, 31))
        results.append(str(e.value))
    assert results[0] == results[1]


def test_executor_rejects_unknown_engine_and_interface():
    _, peng = _engine_pair(8)
    mfc = pt_dfg.MFCDef(name="inf", model_name="critic",
                        interface_type="inference", interface_impl="ppo_actor")
    g = pt_dfg.build_graph([mfc])
    with pytest.raises(ValueError, match="wants engine 'critic'"):
        pt_fe.FunctionExecutor(g, {"actor": peng})
    mfc = pt_dfg.MFCDef(name="inf", model_name="actor",
                        interface_type="inference")
    with pytest.raises(ValueError, match="no interface instance"):
        pt_fe.FunctionExecutor(pt_dfg.build_graph([mfc]), {"actor": peng})
