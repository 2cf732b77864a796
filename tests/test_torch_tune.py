"""The port's collective autotuner (``fpga_ai_nic_tpu_torch.tune``) against
the JAX package's ``tune``, on the CPU.

With the same calibration (JAX's ``fixture_calibration`` and variants,
built as equal records on both sides): the candidate grid, every
``score_candidate`` value (1e-12 relative; wire bytes exact), the
``tune`` / ``tune_topk`` argmin and ``resolve_collective``'s config equal
JAX's; ``DPTrainer``, ``DDPTrainer`` and ``FSDPTrainer`` resolve
``codec="auto"`` to JAX's config and plan; ``repad_flat`` equals JAX's
(values and refusals); ``load_calibration()`` reads the port's own banked
files and never an artifact of the JAX package.
"""

import builtins
import dataclasses
import json
import os

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

import jax
import jax.numpy as jnp

from fpga_ai_nic_tpu import tune as jtune
from fpga_ai_nic_tpu.models import mlp as jax_mlp
from fpga_ai_nic_tpu.ops import fused_update as jax_fused_update
from fpga_ai_nic_tpu.parallel import make_mesh
from fpga_ai_nic_tpu.parallel.ddp import DDPTrainer as JaxDDPTrainer
from fpga_ai_nic_tpu.parallel.fsdp import FSDPTrainer as JaxFSDPTrainer
from fpga_ai_nic_tpu.parallel.train import DPTrainer as JaxDPTrainer
from fpga_ai_nic_tpu.tune import calibration as jcal
from fpga_ai_nic_tpu.utils import config as jcfg
from fpga_ai_nic_tpu_torch import train_mlp, tune
from fpga_ai_nic_tpu_torch.models import mlp
from fpga_ai_nic_tpu_torch.ops import fused_update, ring_cost
from fpga_ai_nic_tpu_torch.parallel.ddp import DDPTrainer
from fpga_ai_nic_tpu_torch.parallel.fsdp import FSDPTrainer
from fpga_ai_nic_tpu_torch.parallel.mesh import VirtualRanks, make_ranks
from fpga_ai_nic_tpu_torch.parallel.train import DPTrainer
from fpga_ai_nic_tpu_torch.tune import calibration as pcal
from fpga_ai_nic_tpu_torch.utils import config as pcfg

REL = 1e-12
SIZES = (32, 64, 10)
# name -> kwargs of both packages' fixture_calibration
CALIBS = {"fixture": {}, "slow_wire": dict(inter_gbps=2.0),
          "slow_topk": dict(inter_gbps=2.0, topk_gbps=0.2),
          "fast_codec": dict(inter_gbps=5.0, codec_gbps=400.0)}
PAYLOADS = (4096, 100_000, 1 << 20, 41_975_808)


def _calibs(name):
    return (jcal.fixture_calibration(**CALIBS[name]),
            pcal.fixture_calibration(**CALIBS[name]))


def _cand_tuple(c):
    return (c.codec, c.pipeline_depth, c.bucket_elems, c.topology,
            c.intra_size)


def _close(a, b, path=""):
    """Nested dicts/lists of numbers equal: floats within REL relative,
    everything else exactly."""
    if isinstance(a, dict):
        assert set(a) == set(b), (path, set(a) ^ set(b))
        for k in a:
            _close(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{path}[{i}]")
    elif isinstance(a, float) and isinstance(b, float):
        assert abs(a - b) <= REL * max(abs(a), abs(b)), (path, a, b)
    else:
        assert a == b, (path, a, b)


# -- the grid, the scores, the argmin ------------------------------------------

@pytest.mark.parametrize("n,intra,topology", [
    (8, 0, None), (8, 2, None), (8, 0, "hier"), (8, 4, "hier"),
    (4, 0, "flat"), (4, 4, "hier"), (2, 0, None)])
@pytest.mark.parametrize("depths", [None, (1,)])
def test_candidate_grid_equals_jax(n, intra, topology, depths):
    want = jtune.enumerate_candidates(n, intra, None, topology, depths)
    got = tune.enumerate_candidates(n, intra, None, topology, depths)
    assert [_cand_tuple(c) for c in got] == [_cand_tuple(c) for c in want]
    assert len({c.codec for c in got}) == 4


@pytest.mark.parametrize("calib", sorted(CALIBS))
@pytest.mark.parametrize("n,intra", [(8, 2), (4, 2), (8, 4)])
def test_every_score_equals_jax(calib, n, intra):
    """Every candidate of the hier-admitting grid at every payload: each
    field of ``score_candidate`` (seconds within 1e-12 relative; bytes,
    buckets and classes exact)."""
    jc, pc = _calibs(calib)
    cands = tune.enumerate_candidates(n, intra)
    jcands = jtune.enumerate_candidates(n, intra)
    for E in PAYLOADS:
        for c, jcand in zip(cands, jcands):
            _close(tune.score_candidate(E, n, c, pc),
                   jtune.score_candidate(E, n, jcand, jc), f"{E}/{c}")


@pytest.mark.parametrize("calib", sorted(CALIBS))
@pytest.mark.parametrize("E", PAYLOADS)
def test_tune_and_topk_equal_jax(calib, E):
    jc, pc = _calibs(calib)
    for kw in (dict(depths=(1,)), dict(), dict(intra_size=2),
               dict(topology="hier")):
        got = tune.tune_topk(E, 8, 3, calibration=pc, **kw)
        want = jtune.tune_topk(E, 8, 3, calibration=jc, **kw)
        assert [_cand_tuple(p.candidate) for p in got] == \
            [_cand_tuple(p.candidate) for p in want]
        for g, w in zip(got, want):
            _close(g.describe(), w.describe())
        assert _cand_tuple(tune.tune(E, 8, calibration=pc, **kw).candidate) \
            == _cand_tuple(got[0].candidate)
        r = tune.rescore(got[0], E + 1000, calibration=pc)
        _close(r.describe(), jtune.rescore(want[0], E + 1000,
                                           calibration=jc).describe())


def _coll_fields(c):
    return (c.impl, c.codec, tuple(c.codec_opts), c.pipeline_depth,
            c.bucket_elems, c.topology, c.intra_size, c.fused_kernel,
            c.fused_optimizer, c.slice_elems)


@pytest.mark.parametrize("calib", sorted(CALIBS))
@pytest.mark.parametrize("kw", [dict(), dict(intra_size=2),
                                dict(topology="hier"),
                                dict(fused_optimizer=True)],
                         ids=["flat", "intra2", "hier", "fused_opt"])
def test_resolve_collective_equals_jax(calib, kw):
    jc, pc = _calibs(calib)
    for E in PAYLOADS:
        jres, jplan = jtune.resolve_collective(
            jcfg.CollectiveConfig(impl="ring", codec="auto", **kw), 8, E,
            calibration=jc)
        pres, pplan = tune.resolve_collective(
            pcfg.CollectiveConfig(impl="ring", codec="auto", **kw), 8, E,
            calibration=pc)
        assert _coll_fields(pres) == _coll_fields(jres)
        _close(pplan.describe(), jplan.describe())
    plain = pcfg.CollectiveConfig(impl="ring", codec="bfp")
    assert tune.resolve_collective(plain, 8, 4096) == (plain, None)


# -- the trainers ----------------------------------------------------------------

def _jax_params():
    return jax_mlp.init(jax.random.PRNGKey(0),
                        jcfg.MLPConfig(layer_sizes=SIZES))


def _cfg(mod, mesh, **coll):
    return mod.TrainConfig(global_batch=16, mesh=mesh,
                           collective=mod.CollectiveConfig(
                               impl="ring", codec="auto", **coll),
                           optimizer=mod.OptimizerConfig(kind="sgd"))


@pytest.mark.parametrize("calib", ["fixture", "slow_wire", "slow_topk"])
@pytest.mark.parametrize("kind", ["dp", "ddp", "fsdp"])
def test_trainers_resolve_auto_like_jax(monkeypatch, kind, calib):
    """The same calibration in both packages' loaders: the resolved
    collective config and the plan in ``obs_static_metrics()`` equal
    JAX's, and the port's trainer steps on it."""
    jc, pc = _calibs(calib)
    monkeypatch.setattr(jtune.autotune, "load_calibration", lambda: jc)
    monkeypatch.setattr(tune.autotune, "load_calibration", lambda: pc)
    n = 4
    jp = _jax_params()
    pp = mlp.from_jax_params(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    mc = pcfg.MLPConfig(layer_sizes=SIZES)
    loss = (lambda p, b: mlp.loss_fn(p, b, mc))
    jloss = (lambda p, b: jax_mlp.loss_fn(
        p, b, jcfg.MLPConfig(layer_sizes=SIZES)))
    if kind == "fsdp":
        jm, pm = jcfg.MeshConfig(fsdp=n), pcfg.MeshConfig(fsdp=n)
        jt = JaxFSDPTrainer(jloss, make_mesh(jm), _cfg(jcfg, jm))
        pt = FSDPTrainer(loss, make_ranks(pm, "cpu"), _cfg(pcfg, pm))
    else:
        jm, pm = jcfg.MeshConfig(dp=n), pcfg.MeshConfig(dp=n)
        cls = {"dp": (JaxDPTrainer, DPTrainer),
               "ddp": (JaxDDPTrainer, DDPTrainer)}[kind]
        jt = cls[0](jloss, make_mesh(jm), _cfg(jcfg, jm))
        pt = cls[1](loss, VirtualRanks(n, torch.device("cpu")),
                    _cfg(pcfg, pm))
    jt.init_state(jp)
    st = pt.init_state(pp)
    assert _coll_fields(pt.cfg.collective) == _coll_fields(
        jt.cfg.collective)
    _close(pt.obs_static_metrics()["tune"],
           jt.obs_static_metrics()["tune"])
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((16, SIZES[0])).astype(
        np.float32))
    y = torch.from_numpy(rng.integers(0, SIZES[-1], 16))
    _, l0 = pt.step(st, pt.shard_batch((x, y)))
    assert np.isfinite(float(l0))


def test_auto_config_validates_like_jax():
    for mod in (jcfg, pcfg):
        c = mod.CollectiveConfig(impl="ring", codec="auto")
        assert c.codec == "auto"
        mod.CollectiveConfig(impl="ring", codec="auto", topology="hier")
        with pytest.raises(ValueError, match="fused_kernel"):
            mod.CollectiveConfig(impl="ring", codec="auto",
                                 fused_kernel=True)
        with pytest.raises(ValueError, match="compression"):
            mod.CollectiveConfig(impl="ring", codec="auto",
                                 compression=mod.BFPConfig())
        with pytest.raises(ValueError, match="impl='ring'"):
            mod.CollectiveConfig(codec="auto")
    with pytest.raises(NotImplementedError, match="ShardedTrainer"):
        from fpga_ai_nic_tpu_torch.parallel.sharded import ShardedTrainer
        ShardedTrainer(lambda p, b: None, VirtualRanks(2, torch.device(
            "cpu")), _cfg(pcfg, pcfg.MeshConfig(dp=2)))


def test_train_mlp_prints_the_plan():
    out = train_mlp.main(["--device=cpu", "--model.layer_sizes=64,64,8",
                          "--global_batch=16", "--mesh.dp=4", "--iters=1",
                          "--collective.impl=ring",
                          "--collective.codec=auto"])
    assert np.isfinite(out["loss"])
    plan = out["tune"]
    assert plan["n_devices"] == 4 and plan["codec"] in (
        "none", "bfp", "int8", "topk")
    assert plan["calibration"]["calibrated"] in (False, True)


# -- repad_flat ------------------------------------------------------------------

@pytest.mark.parametrize("n_to", [2, 4, 8])
def test_repad_flat_equals_jax(n_to):
    """Re-fitting a flat vector onto another layout's padded length,
    value for value as JAX's; fewer than the live elements and a nonzero
    tail raise in both."""
    p = jax.tree_util.tree_map(np.asarray, _jax_params())
    jmeta = jax_fused_update.flat_meta(
        p, jcfg.CollectiveConfig(impl="ring", codec="bfp"), n_to)
    pmeta = fused_update.flat_meta(
        mlp.from_jax_params(p, "cpu"),
        pcfg.CollectiveConfig(impl="ring", codec="bfp"), n_to)
    assert pmeta.padded_len == jmeta.padded_len
    live = sum(pmeta.sizes)
    rng = np.random.default_rng(n_to)
    for L in (live, live + 3, jmeta.padded_len, jmeta.padded_len + 4096):
        v = np.zeros(L, np.float32)
        v[:live] = rng.standard_normal(live)
        want = np.asarray(jax_fused_update.repad_flat(jnp.asarray(v), jmeta))
        got = fused_update.repad_flat(torch.from_numpy(v), pmeta)
        np.testing.assert_array_equal(got.numpy(), want)
    for bad, match in ((np.ones(live - 1, np.float32), "live elements"),
                       (np.ones(jmeta.padded_len + 8, np.float32),
                        "nonzero")):
        with pytest.raises(ValueError, match=match):
            jax_fused_update.repad_flat(jnp.asarray(bad), jmeta)
        with pytest.raises(ValueError, match=match):
            fused_update.repad_flat(torch.from_numpy(bad), pmeta)


# -- the calibration loader ------------------------------------------------------

def test_load_calibration_reads_no_jax_artifact(monkeypatch):
    """From the repository root, where the JAX package's artifacts lie
    (``artifacts/``, ``BENCH_r*.json``, ``CODEC_BENCH_r*.json``,
    ``COLLECTIVE_r*.json``), the loader opens none of them: every file
    it opens is a banked file of the port's."""
    opened = []
    real_open = builtins.open

    def spy(path, *a, **kw):
        opened.append(os.fspath(path))
        return real_open(path, *a, **kw)

    monkeypatch.setattr(builtins, "open", spy)
    cal = tune.load_calibration()
    monkeypatch.setattr(builtins, "open", real_open)
    assert all(os.path.basename(os.path.dirname(p)) == "calibration"
               and os.path.basename(p).startswith("cuda_")
               for p in opened), opened
    assert all(a.platform in ("cuda", "cpu") for a in cal.artifacts)
    jax_names = [r.path for r in jtune.load_calibration().artifacts]
    assert not {a.path for a in cal.artifacts} & set(jax_names)


def test_banked_files_rank_and_fall_back(tmp_path):
    """Nothing banked: JAX's fallback constants, uncalibrated.  A CPU
    file is dryrun; a card file outranks it; a file of another platform
    (a TPU artifact's shape) is skipped; ``link_rate_candidates`` takes
    the banked rate."""
    empty = tune.load_calibration(root=str(tmp_path))
    jempty = jtune.load_calibration(artifacts=[])
    assert not empty.calibrated and empty.dryrun
    assert (empty.inter_gbps, empty.intra_gbps) == (
        jempty.inter_gbps, jempty.intra_gbps)
    _close(empty.describe(), jempty.describe())
    live = tune.apply_live(empty, inter_gbps=7.0, codec_rates={
        "bfp": {"streaming": tune.CodecRates(20.0, 30.0, "probe", True)}},
        dryrun=True)
    pcal.bank_calibration(live, str(tmp_path / "calibration" /
                                    "cuda_a_cpu.json"), platform="cpu")
    cpu = tune.load_calibration(root=str(tmp_path))
    assert cpu.calibrated and cpu.dryrun and cpu.inter_gbps == 7.0
    card = tune.apply_live(empty, inter_gbps=900.0, codec_rates={
        "bfp": {"streaming": tune.CodecRates(400.0, 500.0, "probe",
                                             False)}})
    pcal.bank_calibration(card, str(tmp_path / "calibration" /
                                    "cuda_b_card.json"), platform="cuda",
                          device="NVIDIA H100 80GB HBM3, 700.00 W",
                          git_sha="0" * 40)
    with open(tmp_path / "calibration" / "cuda_c_tpu.json", "w") as f:
        json.dump({"platform": "tpu", "inter_gbps": 1.0}, f)
    both = tune.load_calibration(root=str(tmp_path))
    assert both.inter_gbps == 900.0 and not both.dryrun
    assert both.codec_rates["bfp"]["streaming"].encode_gbps == 400.0
    assert "H100" in both.inter_source
    # the CPU file contributes nothing the card file does not outrank
    assert [a.platform for a in both.artifacts] == ["cuda"]
    rates = ring_cost.link_rate_candidates(both)
    assert rates["calibrated"] and 900.0 in rates["rates"]
    assert not ring_cost.link_rate_candidates(empty)["calibrated"]


def test_apply_live_equals_jax():
    """The live overlay's numbers and flags as JAX's (the source strings
    carry the same ``live:`` prefix)."""
    jc, pc = _calibs("fixture")
    rates = {"int8": {"streaming": (3.0, 4.0)}}
    got = tune.apply_live(pc, inter_gbps=3.5, dryrun=True, codec_rates={
        k: {c: tune.CodecRates(*v, "probe", True) for c, v in r.items()}
        for k, r in rates.items()})
    want = jtune.apply_live(jc, inter_gbps=3.5, dryrun=True, codec_rates={
        k: {c: jtune.CodecRates(*v, "probe", True) for c, v in r.items()}
        for k, r in rates.items()})
    gd, wd = got.describe(), want.describe()
    for d in (gd, wd):
        d.pop("inter_source")
    _close(gd, wd)
    assert got.inter_source.startswith("live:") and got.inter_live
    assert got.codec_rates["int8"]["streaming"].live
    assert dataclasses.replace(pc) == pc
