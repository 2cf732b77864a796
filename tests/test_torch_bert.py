"""The port's BERT (``models/bert.py``) and its driver against the JAX
package.

Weights are JAX's, carried across with ``from_jax_params``; batches are
seeded numpy arrays handed to both.  Tolerances: the loss within rtol
1e-5 and the gradients within rtol 1e-4, atol 1e-6 (f32 GEMMs summed in
other orders by torch and XLA).  The flash route runs the port's plain
versions against JAX's Pallas kernels in interpret mode, as
``tests/test_flash_pallas.py::test_bert_attn_impl_parity`` runs them.
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

import jax
import jax.numpy as jnp

from fpga_ai_nic_tpu.models import bert as jax_bert
from fpga_ai_nic_tpu_torch import train_bert
from fpga_ai_nic_tpu_torch.models import bert
from fpga_ai_nic_tpu_torch.ops import fused_update

LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6


def _cfgs(**kw):
    return (dataclasses.replace(jax_bert.BertConfig.tiny(), **kw),
            dataclasses.replace(bert.BertConfig.tiny(), **kw))


def _params(jcfg, seed=0):
    p = jax_bert.init(jax.random.PRNGKey(seed), jcfg)
    return p, bert.from_jax_params(jax.tree_util.tree_map(np.asarray, p),
                                   "cpu")


def _padded_batch(rng, B, S, vocab, pad_from):
    """Tokens with a padding tail from ``pad_from`` and about a fifth of
    the positions labelled (the JAX test's batch)."""
    toks = rng.integers(4, vocab, (B, S)).astype(np.int32)
    toks[:, pad_from:] = 0
    labels = np.where(rng.integers(0, 5, (B, S)) == 0, toks,
                      -100).astype(np.int32)
    return toks, labels


def _torch_grads(params, batch, cfg, **kw):
    leaves = [t.requires_grad_() for t in fused_update.tree_leaves(params)]
    loss = bert.loss_fn(params, batch, cfg, **kw)
    return loss.detach(), torch.autograd.grad(loss, leaves)


def _assert_grads_close(got, want):
    for a, b in zip(got, jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_loss_and_grads_match_jax(impl):
    """max_pos 128, 2 heads (head_dim 32), a padding tail from position
    100: logits, loss and every gradient leaf; "pallas" sends the mask
    through the flash kernels' key-bias channel in both packages."""
    jcfg, cfg = _cfgs(max_pos=128, n_heads=2, attn_impl=impl)
    jp, tp = _params(jcfg)
    toks, labels = _padded_batch(np.random.default_rng(0), 2, 128,
                                 jcfg.vocab, 100)
    jb = (jnp.asarray(toks), jnp.asarray(labels))
    tb = (torch.from_numpy(toks), torch.from_numpy(labels))
    np.testing.assert_allclose(
        bert.apply(tp, tb[0], cfg).detach().numpy(),
        np.asarray(jax_bert.apply(jp, jb[0], jcfg)), rtol=1e-4, atol=1e-5)
    want_loss, want = jax.value_and_grad(
        lambda p: jax_bert.loss_fn(p, jb, jcfg))(jp)
    loss, got = _torch_grads(tp, tb, cfg)
    np.testing.assert_allclose(float(loss), float(want_loss),
                               rtol=LOSS_RTOL)
    _assert_grads_close(got, want)


def test_tiny_default_matches_jax():
    """The eval's tiny config at its own sequence of 32 (attn_impl auto:
    the plain softmax on the CPU in both packages), with a padded tail."""
    jcfg, cfg = _cfgs()
    jp, tp = _params(jcfg, seed=3)
    toks, labels = _padded_batch(np.random.default_rng(1), 4, 32,
                                 jcfg.vocab, 28)
    want_loss, want = jax.value_and_grad(lambda p: jax_bert.loss_fn(
        p, (jnp.asarray(toks), jnp.asarray(labels)), jcfg))(jp)
    loss, got = _torch_grads(tp, (torch.from_numpy(toks),
                                  torch.from_numpy(labels)), cfg)
    np.testing.assert_allclose(float(loss), float(want_loss),
                               rtol=LOSS_RTOL)
    _assert_grads_close(got, want)


def test_dp_weighting_matches_jax():
    """Four ranks whose masked counts differ: each rank's gradient with
    the global count in its batch equals JAX's ``dp_axis`` gradient, n *
    d(local_sum) / global_count, built from JAX's ``loss_fn`` without
    ``dp_axis`` (the local mean) scaled by n * local_count / global_count;
    the per-rank losses average to the global token-weighted loss; the
    uniform mean of per-rank means is another loss."""
    n, per = 4, 2
    jcfg, cfg = _cfgs()
    jp, tp = _params(jcfg, seed=1)
    rng = np.random.default_rng(2)
    toks = rng.integers(4, jcfg.vocab, (n * per, 32)).astype(np.int32)
    labels = np.full(toks.shape, -100, np.int32)
    for r in range(n):                        # 1, 3, 5, 7 targets a row
        labels[r * per:(r + 1) * per, :2 * r + 1] = \
            toks[r * per:(r + 1) * per, :2 * r + 1]
    tb = bert.with_global_count((torch.from_numpy(toks),
                                 torch.from_numpy(labels)), n)
    total = int((labels >= 0).sum())
    assert tb[2].tolist() == [total] * n
    vg = jax.value_and_grad(lambda p, b: jax_bert.loss_fn(p, b, jcfg))
    losses, local_means = [], []
    global_sum = 0.0
    for r in range(n):
        sl = slice(r * per, (r + 1) * per)
        count = int((labels[sl] >= 0).sum())
        mean, g = vg(jp, (jnp.asarray(toks[sl]), jnp.asarray(labels[sl])))
        want = jax.tree_util.tree_map(
            lambda x: x * (n * count / total), g)
        loss, got = _torch_grads(
            tp, (tb[0][sl], tb[1][sl], tb[2][r:r + 1]), cfg, dp_size=n)
        _assert_grads_close(got, want)
        losses.append(float(loss))
        local_means.append(float(mean))
        global_sum += float(mean) * count
    np.testing.assert_allclose(np.mean(losses), global_sum / total,
                               rtol=LOSS_RTOL)
    assert abs(np.mean(local_means) - global_sum / total) > 1e-3


def test_loss_fn_refuses_mismatched_weighting():
    cfg = bert.BertConfig.tiny()
    tp = bert.init(torch.Generator().manual_seed(0), cfg, "cpu")
    t = torch.ones((2, 32), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="dp_size"):
        bert.loss_fn(tp, (t, t), cfg, dp_axis="dp")
    with pytest.raises(ValueError, match="global count"):
        bert.loss_fn(tp, (t, t), cfg, dp_size=2)
    with pytest.raises(ValueError, match="dp_size"):
        bert.loss_fn(tp, bert.with_global_count((t, t), 1), cfg)
    with pytest.raises(ValueError, match="max_pos"):
        bert.apply(tp, torch.ones((1, 65), dtype=torch.int32), cfg)


@pytest.mark.parametrize("name", ["tiny", "bert_base"])
def test_config_tree_and_num_params_match_jax(name):
    """Same fields, the same tree (paths, shapes, dtypes) from ``init``,
    and the same parameter count (109,429,050 for BERT-base)."""
    jcfg = getattr(jax_bert.BertConfig, name)()
    cfg = getattr(bert.BertConfig, name)()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert bert.num_params(cfg) == jax_bert.num_params(jcfg)
    if name == "bert_base":
        assert bert.num_params(cfg) == 109_429_050
        return
    jp = jax.eval_shape(lambda: jax_bert.init(jax.random.PRNGKey(0), jcfg))
    tp = bert.init(torch.Generator().manual_seed(0), cfg, "cpu")
    jl = jax.tree_util.tree_leaves_with_path(jp)
    tl = fused_update._leaves(tp)
    assert len(jl) == len(tl)
    for (jpath, jleaf), (path, leaf) in zip(jl, tl):
        assert [getattr(k, "key", getattr(k, "idx", None))
                for k in jpath] == list(path)
        assert tuple(leaf.shape) == tuple(jleaf.shape)
        assert str(leaf.dtype).removeprefix("torch.") == str(jleaf.dtype)
    assert sum(t.numel() for t in fused_update.tree_leaves(tp)) == \
        bert.num_params(cfg)


def test_driver_runs_tiny_on_cpu():
    """``train_bert`` with the port's BFP wire over 2 ranks, both
    trainers: finite losses, valid tokens below the padded ones, the
    slice's collective and optimizer from ``--bfp=1`` and the defaults."""
    argv = ["--model=tiny", "--device=cpu", "--bfp=1", "--mesh.dp=2",
            "--iters=2"]
    mcfg, cfg, run = train_bert.parse(argv)
    coll = cfg.collective
    assert (coll.impl, coll.compression.codec, coll.fused_kernel) == (
        "ring", "pallas", True)
    assert (cfg.optimizer.kind, cfg.optimizer.learning_rate,
            cfg.optimizer.weight_decay) == ("adamw", 1e-4, 0.01)
    assert cfg.global_batch == 16 and run.pad_min == 32
    for trainer in ("ddp", "dp"):
        out = train_bert.main(argv + [f"--trainer={trainer}"])
        assert np.isfinite(out["loss_first"]) and np.isfinite(
            out["loss_last"])
        assert out["valid_tokens_per_sec"] < out["tokens_per_sec"]
        assert out["device"] == "cpu" and out["trainer"] == trainer


def test_driver_tokens_per_sec_is_jax_quantity():
    """``tokens_per_sec`` is what JAX's ``examples/train_bert.py`` prints
    under that key, ``iters * global_batch * seq / wall`` (every
    position); ``valid_tokens_per_sec`` is the valid tokens of the timed
    batches over the same wall time."""
    argv = ["--model=tiny", "--device=cpu", "--mesh.dp=2", "--iters=2",
            "--seq=64", "--pad-min=40", "--global_batch=8"]
    mcfg, cfg, run = train_bert.parse(argv)
    out = train_bert.main(argv)
    wall = out["wall_s"]
    assert out["tokens_per_sec"] == pytest.approx(
        cfg.iters * cfg.global_batch * run.seq / wall, rel=1e-12)
    valid = sum(v for _, v in train_bert.batches(mcfg, cfg, run,
                                                 cfg.iters + 1))
    first = next(train_bert.batches(mcfg, cfg, run, 1))[1]
    assert out["valid_tokens_per_sec"] == pytest.approx(
        (valid - first) / wall, rel=1e-12)
    assert "padded_tokens_per_sec" not in out


def test_driver_batches_pad_and_mask():
    """Valid lengths in [pad-min, seq], padding never a target, position
    0 always one, the global count in every rank's leaf."""
    mcfg, cfg, run = train_bert.parse(["--seq=64", "--pad-min=40",
                                       "--mesh.dp=4", "--global_batch=16"])
    (toks, labels, count), valid = next(train_bert.batches(mcfg, cfg, run,
                                                           1))
    pad = toks == mcfg.pad_id
    lens = 64 - pad.sum(1)
    assert int(lens.min()) >= 40 and int(lens.sum()) == valid
    assert not bool((labels[pad] >= 0).any())
    assert bool((labels[:, 0] >= 0).all())
    assert count.tolist() == [int((labels >= 0).sum())] * 4


def test_driver_raises_on_explicit_queue_and_without_card(monkeypatch):
    # the explicit queue is ported (tests/test_torch_queue.py); a bad mode
    # and the ZeRO-1 trainer with it raise
    assert train_bert.parse(["--queue=explicit"])[2].queue == "explicit"
    with pytest.raises(ValueError, match="fused or explicit"):
        train_bert.parse(["--queue=async"])
    with pytest.raises(ValueError, match="trainer=ddp"):
        train_bert.parse(["--queue=explicit", "--trainer=dp"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        train_bert.main(["--model=tiny", "--iters=1"])
