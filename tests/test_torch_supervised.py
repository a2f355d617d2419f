"""The port's supervised recipes against ``areal_tpu``'s: the paired
reward model (``datasets/rw_paired.py``, ``interfaces/reward.py``), the
SFT dataset and worker, the ``sft`` and ``rw`` entry points and
``apps/profile.py``, on the tiny arch of ``tests/test_reward_model.py``.

- the reference's reward-model tests, ported: the pair layout, the
  one-to-one check, Bradley-Terry training that separates good from bad
  answers, scores that rank held-out answers, the ``rw`` experiment end
  to end, and a critic export that keeps its value head through the disk;
- ``PairedRewardInterface``'s loss, stats and scores against the JAX
  interface's on one param tree and one batch, to 1e-4; the datasets'
  samples equal the reference's;
- ``run_sft`` (the port of ``tests/test_experiment_e2e.py::
  test_sft_experiment`` on one device and ``trainer_device=cpu``; the
  port's memory monitor has no CPU gauge, so that line is not ported);
- ``run_profile`` on the CPU returns the reference's JSON keys.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax

from areal_tpu.api.data import MicroBatchSpec as JaxMBSpec
from areal_tpu.api.data import SequenceSample as JaxSample
from areal_tpu.api.dataset import DatasetUtility as JaxUtil
from areal_tpu.api.model import make_interface as jax_make_interface
from areal_tpu.datasets.prompt_answer import PromptAnswerDataset as JaxPADataset
from areal_tpu.datasets.rw_paired import RewardPairedDataset as JaxRWDataset
from areal_tpu.models import transformer as jax_tfm
from areal_tpu.models.config import ModelConfig as JaxConfig
from areal_tpu.train.engine import OptimizerConfig as JaxOptConfig
from areal_tpu.train.engine import TrainEngine as JaxEngine
from areal_tpu_torch.api.data import MicroBatchSpec, SequenceSample
from areal_tpu_torch.api.dataset import DatasetUtility, make_dataset
from areal_tpu_torch.api.model import make_interface
from areal_tpu_torch.datasets.rw_paired import RewardPairedDataset
from areal_tpu_torch.models import hf as hf_conv
from areal_tpu_torch.models import transformer as tfm
from areal_tpu_torch.models.config import ModelConfig
from areal_tpu_torch.train.engine import OptimizerConfig, TrainEngine


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


RM_ARCH = dict(
    n_layers=2, n_q_heads=4, n_kv_heads=2, head_dim=8, hidden_dim=32,
    intermediate_dim=64, vocab_size=128, dtype="float32", is_critic=True,
    use_attention_bias=True,
)
TINY_RM = ModelConfig(**RM_ARCH)
GOOD_TOKEN, BAD_TOKEN = 7, 13


def _write_pairs(path, n=24, seed=0):
    """Synthetic preference data: positives end with GOOD_TOKEN runs,
    negatives with BAD_TOKEN runs."""
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for i in range(n):
            prompt = [int(x) for x in rng.integers(20, 120, 4)]
            pos = [prompt + [GOOD_TOKEN] * int(rng.integers(3, 6)) for _ in range(2)]
            neg = [prompt + [BAD_TOKEN] * int(rng.integers(3, 6)) for _ in range(2)]
            f.write(json.dumps({
                "qid": f"p{i}", "prompt_ids": prompt,
                "pos_answer_ids": pos, "neg_answer_ids": neg,
            }) + "\n")


def _write_sft(path, n=16):
    rng = np.random.default_rng(0)
    with open(path, "w") as f:
        for i in range(n):
            f.write(json.dumps({
                "qid": f"s{i}",
                "prompt_ids": [int(x) for x in rng.integers(1, 128, 4)],
                "answer_ids": [int(x) for x in rng.integers(1, 128, 6)],
            }) + "\n")


def _util():
    return DatasetUtility(seed=1, dp_rank=0, world_size=1, tokenizer=None)


@pytest.fixture(scope="module")
def pairs_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("rw") / "pairs.jsonl")
    _write_pairs(path)
    return path


@pytest.fixture(scope="module")
def rw_dataset(pairs_path):
    return RewardPairedDataset(_util(), pairs_path)


# --------------------------------------------------------------------------- #
# datasets
# --------------------------------------------------------------------------- #


def test_pair_layout(rw_dataset):
    s = rw_dataset[0]
    assert s.keys == {"packed_input_ids", "pair_id", "pair_sign"}
    n = len(s.seqlens["packed_input_ids"][0])
    assert n == 4  # 2 pairs -> [pos0, neg0, pos1, neg1]
    np.testing.assert_array_equal(s.data["pair_sign"], [1, -1, 1, -1])
    np.testing.assert_array_equal(s.data["pair_id"], [0, 0, 1, 1])


def test_pair_mismatch_raises(tmp_path):
    path = str(tmp_path / "bad.jsonl")
    with open(path, "w") as f:
        f.write(json.dumps({
            "qid": "x", "prompt_ids": [1],
            "pos_answer_ids": [[1, 2]], "neg_answer_ids": [],
        }) + "\n")
    with pytest.raises(ValueError, match="one-to-one"):
        RewardPairedDataset(_util(), path)


@pytest.mark.parametrize("name", ["rw_paired", "prompt_answer"])
def test_datasets_match_the_reference(name, tmp_path):
    path = str(tmp_path / "d.jsonl")
    if name == "rw_paired":
        _write_pairs(path, n=9)
        kw = dict(max_pairs_per_prompt=1, max_length=8)
        want = JaxRWDataset(JaxUtil(seed=1, dp_rank=0, world_size=1), path, **kw)
    else:
        _write_sft(path, n=9)
        kw = dict(max_length=12)
        want = JaxPADataset(JaxUtil(seed=1, dp_rank=0, world_size=1), path, **kw)
    got = make_dataset(name, _util(), path=path, **kw)
    assert len(got) == len(want) > 0
    for i in range(len(want)):
        a, b = got[i], want[i]
        assert a.keys == b.keys and a.ids == b.ids and a.seqlens == b.seqlens
        for k in b.keys:
            np.testing.assert_array_equal(a.data[k], b.data[k])


# --------------------------------------------------------------------------- #
# the reward interface against the reference's
# --------------------------------------------------------------------------- #


def _batch(ds, lo, hi, cls):
    items = [ds[i] for i in range(lo, hi)]
    return cls.gather([cls(keys=s.keys, ids=s.ids, seqlens=s.seqlens,
                           data=dict(s.data)) for s in items])


def test_reward_interface_matches_the_reference(rw_dataset):
    jcfg = JaxConfig(**RM_ARCH)
    rng = np.random.default_rng(2)
    tree = jax.tree.map(
        lambda a: (np.asarray(a) + rng.normal(scale=0.05, size=a.shape)
                   ).astype(np.float32),
        jax_tfm.init_params(jcfg, jax.random.key(2)))
    jeng = JaxEngine(jcfg, optimizer=JaxOptConfig(lr=3e-3)).load_params(tree)
    jeng.setup_optimizer(total_train_steps=40)
    peng = TrainEngine(TINY_RM, optimizer=OptimizerConfig(lr=3e-3),
                       device="cpu").load_params(tree).setup_optimizer(40)
    jif, pif = jax_make_interface("reward"), make_interface("reward")
    jb = _batch(rw_dataset, 0, 6, JaxSample)
    pb = _batch(rw_dataset, 0, 6, SequenceSample)
    tol = dict(atol=1e-4, rtol=1e-4)
    # loss at the same params, then one step of each from them
    np.testing.assert_allclose(
        peng.eval_batch(pb, MicroBatchSpec(), pif._rw_loss_fn)["loss"],
        jeng.eval_batch(jb, JaxMBSpec(), jif._rw_loss_fn)["loss"], **tol)
    spec = dict(max_tokens_per_mb=40)     # several micro-batches, pair-weighted
    want = jif.train_step(jeng, jb, JaxMBSpec(**spec))
    got = pif.train_step(peng, pb, MicroBatchSpec(**spec))
    assert got["n_mbs"] == want["n_mbs"] > 1
    for k in ("rw_loss", "rw_acc", "score_diff", "loss", "grad_norm"):
        np.testing.assert_allclose(got[k], float(want[k]), err_msg=k, **tol)
    assert peng.version == jeng.version == 1
    # scores after the step
    sj = jif.inference(jeng, _batch(rw_dataset, 6, 9, JaxSample), JaxMBSpec())
    sp = pif.inference(peng, _batch(rw_dataset, 6, 9, SequenceSample),
                       MicroBatchSpec())
    assert sp.seqlens == sj.seqlens and sp.ids == sj.ids
    np.testing.assert_allclose(sp.data["rewards"], sj.data["rewards"], **tol)


def test_pair_id_past_the_bucket_factor_raises(rw_dataset):
    eng = TrainEngine(TINY_RM, optimizer=OptimizerConfig(), device="cpu")
    eng.init_random(0).setup_optimizer(10)
    with pytest.raises(ValueError, match="max_pairs_per_prompt"):
        make_interface("reward", max_pairs_per_prompt=1).train_step(
            eng, _batch(rw_dataset, 0, 2, SequenceSample), MicroBatchSpec())


@pytest.fixture(scope="module")
def trained_rm(rw_dataset):
    eng = TrainEngine(TINY_RM, optimizer=OptimizerConfig(lr=3e-3), device="cpu")
    eng.init_random(0)
    eng.setup_optimizer(total_train_steps=40)
    iface = make_interface("reward")
    stats = None
    for epoch in range(6):
        for lo in range(0, len(rw_dataset), 8):
            batch = SequenceSample.gather(
                [rw_dataset[i] for i in range(lo, min(lo + 8, len(rw_dataset)))]
            )
            stats = iface.train_step(eng, batch, MicroBatchSpec())
    return eng, iface, stats


def test_bt_loss_learns_preference(trained_rm):
    _, _, stats = trained_rm
    assert stats["rw_acc"] > 0.9          # separates pos from neg
    assert stats["score_diff"] > 0        # s_pos > s_neg on average
    assert np.isfinite(stats["rw_loss"])


def test_scoring_ranks_held_out(trained_rm):
    eng, iface, _ = trained_rm
    seqs = [[50, 60, GOOD_TOKEN] * 2, [50, 60, BAD_TOKEN] * 2]
    lens = [len(s) for s in seqs]
    sample = SequenceSample(
        keys={"packed_input_ids"},
        ids=["h"],
        seqlens={"packed_input_ids": [lens]},
        data={"packed_input_ids": np.concatenate(
            [np.asarray(s, np.int64) for s in seqs]
        )},
    )
    out = iface.inference(eng, sample, MicroBatchSpec())
    scores = out.data["rewards"]
    assert out.seqlens["rewards"] == [[1, 1]]
    assert scores[0] > scores[1]          # good beats bad


def test_critic_checkpoint_roundtrips_value_head(tmp_path):
    """A critic / RM export keeps its trained scalar head (``score.weight``
    and the ``is_critic`` marker); reloading it from disk gives the same
    scores, and ``load_hf(init_critic_head=True)`` keeps the head."""
    params = tfm.init_params(TINY_RM, seed=3, device="cpu")
    host = tfm.params_to_numpy(params)
    path = str(tmp_path / "rm")
    hf_conv.save_hf_checkpoint(host, TINY_RM, "qwen2", path)
    cfg2, loaded = hf_conv.load_hf_checkpoint(path)
    assert cfg2.is_critic
    np.testing.assert_allclose(
        loaded["head"]["weight"], host["head"]["weight"], atol=1e-7
    )
    ids = torch.arange(1, 9)
    seg = torch.ones(8, dtype=torch.int32)
    pos = torch.arange(8, dtype=torch.int32)
    with torch.no_grad():
        v1 = tfm.forward_packed(params, TINY_RM, ids, seg, pos)
        v2 = tfm.forward_packed(tfm.params_from_numpy(loaded, device="cpu"),
                                TINY_RM, ids, seg, pos)
    assert v1.shape == (8, 1)
    np.testing.assert_allclose(v1.numpy(), v2.numpy(), atol=1e-6)
    eng = TrainEngine(TINY_RM, device="cpu")
    eng.load_hf(path, init_critic_head=True)
    np.testing.assert_allclose(eng.params["head"]["weight"].detach().numpy(),
                               host["head"]["weight"], atol=1e-7)


# --------------------------------------------------------------------------- #
# the entry points on the CPU
# --------------------------------------------------------------------------- #

TINY_ARCH = dict(
    n_layers=2, n_q_heads=4, n_kv_heads=2, head_dim=8, hidden_dim=32,
    intermediate_dim=64, vocab_size=128, use_attention_bias=True,
    dtype="float32",
)


def test_sft_experiment(tmp_path):
    from areal_tpu_torch.apps import launcher
    from areal_tpu_torch.experiments import SFTExperiment, load_config

    data = str(tmp_path / "sft.jsonl")
    _write_sft(data)
    cfg = load_config(SFTExperiment, None, [
        "experiment_name=sft-test",
        "trial_name=t0",
        f"fileroot={tmp_path}/files",
        f"dataset.path={data}",
        "dataset.name=prompt_answer",
        "batch_size=4",
        "max_tokens_per_mb=256",
        "control.total_train_steps=3",
        "control.save_freq_steps=3",
        "model.parallel=d1m1",
        f"model.arch={json.dumps(TINY_ARCH)}",
        "model.optimizer.lr=0.001",
        "trainer_device=cpu",
    ])
    assert cfg.model.arch["hidden_dim"] == 32
    assert launcher.run_sft(cfg) == 0
    save_dir = os.path.join(f"{tmp_path}/files", "checkpoints", "sft-test",
                            "t0", "step3")
    assert os.path.exists(os.path.join(save_dir, "model.safetensors"))
    metrics = os.path.join(f"{tmp_path}/files", "logs", "sft-test", "t0",
                           "metrics.jsonl")
    lines = [json.loads(l) for l in open(metrics)]
    assert len(lines) == 3 and "sft/loss" in lines[0]
    assert all(np.isfinite(ln["sft/loss"]) for ln in lines)
    assert lines[0]["sft/tflops_per_sec"] > 0


def test_rw_experiment_e2e(tmp_path):
    """Launcher-level RM training run: loss drops, the HF export lands."""
    from areal_tpu_torch.apps import launcher
    from areal_tpu_torch.experiments import RWExperiment, load_config

    data = str(tmp_path / "pairs.jsonl")
    _write_pairs(data, n=16)
    arch = dict(TINY_ARCH, use_attention_bias=False)
    cfg = load_config(RWExperiment, None, [
        "experiment_name=rw-test",
        "trial_name=t0",
        f"fileroot={tmp_path}/files",
        f"dataset.path={data}",
        "dataset.name=rw_paired",
        "batch_size=8",
        "max_tokens_per_mb=512",
        "control.total_train_steps=6",
        "control.save_freq_steps=6",
        "model.parallel=d1m1",
        f"model.arch={json.dumps(arch)}",
        "model.optimizer.lr=0.003",
        "trainer_device=cpu",
    ])
    assert launcher.run_rw(cfg) == 0
    metrics = os.path.join(f"{tmp_path}/files", "logs", "rw-test", "t0",
                           "metrics.jsonl")
    lines = [json.loads(l) for l in open(metrics)]
    assert len(lines) == 6
    assert lines[-1]["reward/rw_loss"] < lines[0]["reward/rw_loss"]
    save_dir = os.path.join(f"{tmp_path}/files", "checkpoints", "rw-test",
                            "t0", "step6")
    assert os.path.exists(os.path.join(save_dir, "model.safetensors"))
    assert json.load(open(os.path.join(save_dir, "config.json")))["is_critic"]


def test_run_profile_returns_the_reference_keys(monkeypatch):
    from areal_tpu.apps import profile as jax_profile
    from areal_tpu.experiments.config import ModelSpec as JaxSpec
    from areal_tpu_torch.apps import profile
    from areal_tpu_torch.experiments.config import ModelSpec

    arch = dict(TINY_ARCH)
    seqlens = [24, 40]
    got = profile.run_profile(ModelSpec(arch=arch), seqlens, n_steps=2,
                              n_warmup=1, device="cpu")
    want = jax_profile.run_profile(JaxSpec(arch=arch), seqlens, n_steps=2,
                                   n_warmup=1)
    assert sorted(got) == sorted(want)
    for k in ("metric", "n_params", "seqlens", "n_steps"):
        assert got[k] == want[k], k
    assert got["tokens_per_s"] > 0 and 0 <= got["mfu"] < 1
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        profile.run_profile(ModelSpec(arch=arch), seqlens, n_steps=1)
