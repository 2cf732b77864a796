"""The port's fused optimizer formula against the bit spec and JAX.

``optim.fused_apply_flat`` must equal ``golden_fused_apply`` (the port's
copy and the JAX package's) and the jitted JAX ``fused_apply_flat`` bit for
bit: torch on the CPU does not contract multiply-adds, so the port emulates
each ``fmaf`` site of the golden twin through float64.
"""

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

import jax
import jax.numpy as jnp

from fpga_ai_nic_tpu import optim as jax_optim
from fpga_ai_nic_tpu.utils.config import OptimizerConfig as JaxOptConfig
from fpga_ai_nic_tpu.utils.config import OptimizerSpec as JaxOptSpec
from fpga_ai_nic_tpu_torch import optim
from fpga_ai_nic_tpu_torch.utils.config import OptimizerConfig, OptimizerSpec

N = 8
KINDS = ("sgd", "momentum", "adamw")


def _kw(kind):
    return dict(kind=kind, learning_rate=0.1 if kind != "adamw" else 1e-3,
                weight_decay=0.01)


def _state(kind, C, rng):
    st = {}
    if kind in ("momentum", "adamw"):
        st["m"] = rng.standard_normal(C).astype(np.float32) * 0.01
    if kind == "adamw":
        st["v"] = np.abs(rng.standard_normal(C)).astype(np.float32) * 1e-4
    return st


@pytest.mark.parametrize("kind", KINDS)
def test_fused_apply_flat_bitexact(kind, rng):
    C = 8192
    g_sum = (rng.standard_normal(C) * N).astype(np.float32)
    w = rng.standard_normal(C).astype(np.float32) * 0.1
    st = _state(kind, C, rng)
    hyper = optim.fused_hyperparams(OptimizerConfig(**_kw(kind)), 0)
    w2, st2 = optim.fused_apply_flat(
        OptimizerSpec(kind=kind), torch.from_numpy(w),
        torch.from_numpy(g_sum), {k: torch.from_numpy(v)
                                  for k, v in st.items()}, hyper, N)
    hyp = hyper.numpy()
    wants = [optim.golden_fused_apply(kind, w, g_sum, st, hyp, N),
             jax_optim.golden_fused_apply(kind, w, g_sum, st, hyp, N)]
    jw, jst = jax.jit(jax_optim.fused_apply_flat, static_argnums=0)(
        JaxOptSpec(kind=kind), jnp.asarray(w), jnp.asarray(g_sum),
        {k: jnp.asarray(v) for k, v in st.items()}, jnp.asarray(hyp), N)
    wants.append((np.asarray(jw), {k: np.asarray(v) for k, v in jst.items()}))
    for w_want, st_want in wants:
        np.testing.assert_array_equal(w2.numpy(), w_want)
        for k in OptimizerSpec(kind=kind).state_keys:
            np.testing.assert_array_equal(st2[k].numpy(), st_want[k])


@pytest.mark.parametrize("kind,sched", [
    ("sgd", dict()),
    ("momentum", dict(schedule="linear", warmup_steps=2, decay_steps=10,
                      min_lr_ratio=0.1)),
    ("adamw", dict(warmup_steps=3)),
    ("sgd", dict(schedule="cosine", decay_steps=20)),
])
def test_fused_hyperparams_equal_jax(kind, sched):
    kw = dict(_kw(kind), **sched)
    for step in (0, 1, 4, 9):
        got = optim.fused_hyperparams(OptimizerConfig(**kw), step).numpy()
        want = np.asarray(jax_optim.fused_hyperparams(
            JaxOptConfig(**kw), jnp.int32(step)))
        assert got.shape == (optim.HYPER_LEN,) == want.shape
        if kw.get("schedule") == "cosine":
            # torch.cos and XLA's cos may round the schedule 1 ulp apart;
            # the fused formula reads whatever vector it is given
            np.testing.assert_allclose(got, want, rtol=2e-7)
        else:
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", KINDS)
def test_unfused_apply_close_to_jax(kind, rng):
    """optim.apply (the fused_optimizer=False route) is the same optimizer
    as the JAX package's, to float32 roundoff (rounding sites differ)."""
    C = 4096
    g = rng.standard_normal(C).astype(np.float32)
    w = rng.standard_normal(C).astype(np.float32) * 0.1
    st = _state(kind, C, rng)
    w2, _ = optim.apply(OptimizerConfig(**_kw(kind)), torch.from_numpy(w),
                        torch.from_numpy(g),
                        {k: torch.from_numpy(v) for k, v in st.items()}, 2)
    jw, _ = jax_optim.apply(JaxOptConfig(**_kw(kind)), jnp.asarray(w),
                            jnp.asarray(g),
                            {k: jnp.asarray(v) for k, v in st.items()},
                            jnp.int32(2))
    np.testing.assert_allclose(w2.numpy(), np.asarray(jw), rtol=1e-6,
                               atol=1e-7)


def test_init_state_shapes():
    st = optim.init_state(OptimizerConfig(kind="adamw"), (4, 2048),
                          device="cpu")
    assert set(st) == {"m", "v"} and st["m"].shape == (4, 2048)
    assert optim.init_state(OptimizerConfig(), (4, 2048), device="cpu") == {}
