"""The port's codec convergence eval against the JAX package's.

``run_codec_comparison("mlp", steps=10)`` trains the baseline, top-k (error
feedback) and int8 arms over 8 virtual ranks in both packages, from the
same initial weights (JAX's, carried across) and the same numpy batch
stream.  The static tables hold codecs that are bit-exact against JAX's on
the same data, so they must come out equal.
"""

import numpy as np
import pytest

import jax

from fpga_ai_nic_tpu.evals import codec_convergence as jax_cc
from fpga_ai_nic_tpu_torch.evals import codec_convergence as cc
from fpga_ai_nic_tpu_torch.models import mlp
from torch_threads import one_torch_thread  # noqa: F401

# AdamW divides each coordinate by its own running RMS, so the last-bit
# gradient differences between torch's and XLA's GEMMs move coordinates
# whose gradients are near zero by up to the learning rate per step; top-k
# may then select another coordinate and int8 draw another stochastic
# rounding.  Over these 10 steps the port's recorded losses came within
# 0.4% of JAX's on the CPU (the arm ratios within 0.13%); the tolerance
# is 2% of each loss and of each ratio.
RTOL = 0.02


def test_codec_comparison_matches_jax():
    params, _, _ = jax_cc._make_batches("mlp", 1, 32, 0)
    want = jax_cc.run_codec_comparison("mlp", 10)
    got = cc.run_codec_comparison(
        "mlp", 10, params=mlp.from_jax_params(
            jax.tree_util.tree_map(np.asarray, params), "cpu"),
        device="cpu")
    for arm in ("baseline", "topk", "int8"):
        assert got[arm]["steps"] == want[arm]["steps"]
        np.testing.assert_allclose(got[arm]["losses"], want[arm]["losses"],
                                   rtol=RTOL)
        assert all(np.isfinite(got[arm]["losses"]))
    for arm in ("topk", "int8"):
        np.testing.assert_allclose(got[arm]["final_loss_ratio"],
                                   want[arm]["final_loss_ratio"], rtol=RTOL)
        assert got[arm]["codec"] == want[arm]["codec"]
    assert got["topk"]["codec"]["error_feedback"]


def test_batches_are_the_reference_stream():
    _, _, want = jax_cc._make_batches("mlp_canonical", 2, 8, 3)
    got = cc._make_batches("mlp_canonical", 2, 8, 3)
    for (x, y), (jx, jy) in zip(got, want):
        np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
        np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
    assert cc.mlp_config("mlp_canonical").layer_sizes == (2048, 2048, 2048,
                                                          128)


def test_static_tables_equal_jax():
    assert cc.codec_static_table(n=1 << 12) == jax_cc.codec_static_table(
        n=1 << 12)
    assert cc.codec_error_table(n=1 << 12) == jax_cc.codec_error_table(
        n=1 << 12)


# the arms that raised until their ROADMAP item was ported keep their
# cases: ("bert", "dp") and ("resnet", "dp") (A.6, the BERT and ResNet
# models), ("mlp", "ddp") (A.4's bucketed DDP trainer) and ("mlp_fsdp",
# "dp") (A.5's ZeRO-3 trainer) now train
PORTED_ARMS = {("bert", "dp"), ("resnet", "dp"), ("mlp", "ddp"),
               ("mlp_fsdp", "dp")}


@pytest.mark.parametrize("model,trainer,roadmap", [
    ("bert", "dp", "A.6"), ("resnet", "dp", "A.6"), ("mlp_fsdp", "dp", "A.5"),
    ("mlp", "ddp", "A.4")])
def test_unported_arms_raise(model, trainer, roadmap):
    """Arms of unported items raise naming their ROADMAP item; the arms
    ported since run a short curve with finite losses."""
    if (model, trainer) in PORTED_ARMS:
        out = cc.run_curve(model, 3, trainer=trainer, record_every=1,
                           device="cpu")
        assert out["steps"] == [1, 2, 3]
        assert all(np.isfinite(out["losses"]))
        return
    with pytest.raises(NotImplementedError, match=roadmap):
        cc.run_curve(model, 1, trainer=trainer, device="cpu")


def test_bert_batches_are_the_reference_stream():
    """The bert arm's masked-LM stream is the JAX eval's, bit for bit."""
    _, _, want = jax_cc._make_batches("bert", 2, 8, 5)
    got = cc._make_batches("bert", 2, 8, 5)
    for (t, l), (jt, jl) in zip(got, want):
        np.testing.assert_array_equal(t.numpy(), np.asarray(jt))
        np.testing.assert_array_equal(l.numpy(), np.asarray(jl))


@pytest.mark.parametrize("trainer", ["dp", "ddp"])
def test_bert_curve_matches_jax(trainer):
    """The bert arm from JAX's initial weights against JAX's ``run_curve``
    (DDP over the explicit ring, or ZeRO-1), uncompressed, 4 steps over 8
    ranks: the recorded losses within 1e-4 (f32 GEMMs summed in other
    orders, carried through AdamW)."""
    from fpga_ai_nic_tpu_torch.models import bert
    params, _, _ = jax_cc._make_batches("bert", 1, 32, 0)
    want = jax_cc.run_curve("bert", 4, record_every=1, trainer=trainer)
    got = cc.run_curve("bert", 4, record_every=1, trainer=trainer,
                       params=bert.from_jax_params(
                           jax.tree_util.tree_map(np.asarray, params),
                           "cpu"), device="cpu")
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4)


def _jax_mlp_params(seed):
    params, _, _ = jax_cc._make_batches("mlp", 1, 32, seed)
    return mlp.from_jax_params(jax.tree_util.tree_map(np.asarray, params),
                               "cpu")


def test_bfp_comparison_matches_jax():
    """``run_comparison`` (the BFP mantissa sweep on DDPTrainer, JAX's
    ``run_curve`` default) against JAX's at a tiny size, through the
    ``evals.bfp_convergence`` shim as JAX's callers reach it."""
    from fpga_ai_nic_tpu.evals import bfp_convergence as jax_bc
    from fpga_ai_nic_tpu_torch.evals import bfp_convergence as bc
    assert bc.run_comparison is cc.run_comparison
    assert set(bc.__all__) == set(jax_bc.__all__)
    want = jax_bc.run_comparison("mlp", 6, mantissa_sweep=(8, 4))
    got = bc.run_comparison("mlp", 6, mantissa_sweep=(8, 4),
                            params=_jax_mlp_params(0), device="cpu")
    for arm in ("baseline", "bfp_m8", "bfp_m4"):
        assert got[arm]["steps"] == want[arm]["steps"]
        np.testing.assert_allclose(got[arm]["losses"], want[arm]["losses"],
                                   rtol=RTOL)
    for arm in ("bfp_m8", "bfp_m4"):
        np.testing.assert_allclose(got[arm]["final_loss_ratio"],
                                   want[arm]["final_loss_ratio"], rtol=RTOL)


def test_bfp_comparison_multiseed_matches_jax():
    want = jax_cc.run_comparison_multiseed("mlp", 5, seeds=(0, 1),
                                           mantissa_sweep=(6,), tail_k=1)
    got = cc.run_comparison_multiseed("mlp", 5, seeds=(0, 1),
                                      mantissa_sweep=(6,), tail_k=1,
                                      params_of=_jax_mlp_params,
                                      device="cpu")
    assert got["seeds"] == [0, 1] and len(got["per_seed"]) == 2
    np.testing.assert_allclose(got["bfp_m6"]["paired_ratios"],
                               want["bfp_m6"]["paired_ratios"], rtol=RTOL)
    for k in ("ratio_mean", "ratio_min", "ratio_max"):
        np.testing.assert_allclose(got["bfp_m6"][k], want["bfp_m6"][k],
                                   rtol=RTOL)
