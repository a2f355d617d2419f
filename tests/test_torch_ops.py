"""Port parity: norms, activations and rotary of ``areal_tpu_torch`` against
``areal_tpu`` on the same numpy inputs (float32 on the CPU).

Tolerance 1e-5 absolute and relative: both sides compute in float32 and
differ only in the order of reductions and in libm.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from areal_tpu.ops import activations as jax_act
from areal_tpu.ops import norms as jax_norms
from areal_tpu.ops import rotary as jax_rot
from areal_tpu_torch.ops import activations as pt_act
from areal_tpu_torch.ops import norms as pt_norms
from areal_tpu_torch.ops import rotary as pt_rot


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tensors here are tiny, so torch's intra-op thread pool buys nothing;
    one pool per test worker crowds out the timing-sensitive tests that
    other workers run beside this file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = dict(atol=1e-5, rtol=1e-5)


def _both(x):
    return jnp.asarray(x), torch.from_numpy(x)


@pytest.mark.parametrize("kind", ["rms", "gemma", "layer", "layer_nobias"])
def test_norms_match_jax(kind):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 5, 32)).astype(np.float32) * 3.0
    w = rng.normal(size=(32,)).astype(np.float32)
    b = rng.normal(size=(32,)).astype(np.float32)
    xj, xt = _both(x)
    if kind in ("rms", "gemma"):
        plus_one = kind == "gemma"
        want = jax_norms.rms_norm(xj, jnp.asarray(w), 1e-6, plus_one=plus_one)
        got = pt_norms.rms_norm(xt, torch.from_numpy(w), 1e-6,
                                plus_one=plus_one)
    else:
        bias = b if kind == "layer" else None
        want = jax_norms.layer_norm(
            xj, jnp.asarray(w), None if bias is None else jnp.asarray(bias)
        )
        got = pt_norms.layer_norm(
            xt, torch.from_numpy(w),
            None if bias is None else torch.from_numpy(bias),
        )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_norm_keeps_input_dtype():
    x = torch.randn(4, 16, dtype=torch.bfloat16)
    assert pt_norms.rms_norm(x, torch.ones(16)).dtype == torch.bfloat16
    assert pt_norms.layer_norm(x, torch.ones(16), None).dtype == torch.bfloat16


@pytest.mark.parametrize("name", sorted(pt_act.ACT2FN))
def test_activations_match_jax(name):
    x = np.linspace(-6, 6, 257, dtype=np.float32)
    want = np.asarray(jax_act.ACT2FN[name](jnp.asarray(x)))
    got = pt_act.ACT2FN[name](torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_activation_names_match_jax():
    assert set(pt_act.ACT2FN) == set(jax_act.ACT2FN)


ROPE_CASES = {
    "none": dict(dim=16),
    "linear": dict(dim=16, scaling_type="linear", scaling_factor=4.0),
    "dynamic": dict(dim=16, scaling_type="dynamic", scaling_factor=2.0,
                    max_position=512),
    "llama3": dict(dim=16, base=500000.0, scaling_type="llama3",
                   scaling_factor=8.0, low_freq_factor=1.0,
                   high_freq_factor=4.0, original_max_position=64),
    "partial": dict(dim=8),
}


@pytest.mark.parametrize("case", sorted(ROPE_CASES))
def test_rotary_matches_jax(case):
    kw = ROPE_CASES[case]
    rng = np.random.default_rng(1)
    positions = rng.integers(0, 4000, size=(2, 7)).astype(np.int32)
    x = rng.normal(size=(2, 7, 3, 16)).astype(np.float32)
    jcos, jsin = jax_rot.rotary_cos_sin(
        jax_rot.RotaryConfig(**kw), jnp.asarray(positions)
    )
    tcos, tsin = pt_rot.rotary_cos_sin(
        pt_rot.RotaryConfig(**kw), torch.from_numpy(positions)
    )
    # cos/sin of angles up to ~4000 rad: f32 argument rounding dominates
    np.testing.assert_allclose(tcos.numpy(), np.asarray(jcos), atol=2e-4)
    np.testing.assert_allclose(tsin.numpy(), np.asarray(jsin), atol=2e-4)
    # the rotation itself, on identical tables
    want = jax_rot.apply_rotary(jnp.asarray(x), jcos, jsin)
    got = pt_rot.apply_rotary(
        torch.from_numpy(x), torch.from_numpy(np.array(jcos)),
        torch.from_numpy(np.array(jsin)),
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
