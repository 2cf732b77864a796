"""The port's BFP convergence driver (``fpga_ai_nic_tpu_torch.eval_bfp``)
and its committed artifact, on the CPU.

- (a) a short run into ``tmp_path`` gives the report keys of JAX's
  ``examples/eval_bfp.py`` (``steps``, ``n_devices``, ``codec_error``, a
  model entry each, ``_provenance``) and its per-model keys, writes the
  ``.md`` beside the JSON, shortens the multi-seed arms on request and
  refuses JAX's artifact as its output;
- (b) the committed ``docs/torch_bfp_convergence.json`` passes the gates
  of JAX's ``tests/test_bfp_convergence.py::test_committed_artifact_gates``
  (canonical arm: >= 5 CRN-paired seeds, >= 200 steps, mean paired m8
  ratio <= 1.05, its sigma < 0.10, m4 mean > 0.7; ZeRO-3 arm: >= 5 seeds,
  m8 mean <= 1.05, sigma < 0.05) and its provenance names the commit and
  an NVIDIA card with its power limit.
"""

import json
import os

import numpy as np
import pytest
from torch_threads import one_torch_thread  # noqa: F401

from fpga_ai_nic_tpu_torch import eval_bfp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_REPORT_KEYS = {"steps", "n_devices", "codec_error", "_provenance"}
SINGLE_KEYS = {"model", "steps", "tail_k", "baseline", "bfp_m8", "bfp_m6",
               "bfp_m4"}
MULTI_KEYS = {"model", "steps", "seeds", "tail_k", "pairing", "per_seed",
              "bfp_m8", "bfp_m6", "bfp_m4"}


def test_short_run_gives_jax_report_keys(tmp_path):
    out = tmp_path / "r.json"
    res = eval_bfp.main(["--device=cpu", "--steps=5", "--models=mlp",
                         f"--out={out}"])
    assert res["ok"] and res["device"] == "cpu"
    rep = json.loads(out.read_text())
    assert set(rep) == JAX_REPORT_KEYS | {"mlp"}
    assert set(rep["mlp"]) == SINGLE_KEYS
    assert np.isfinite(rep["mlp"]["baseline"]["final_loss"])
    assert [r["mantissa_bits"] for r in rep["codec_error"]] == [2, 3, 4, 6, 8]
    assert (tmp_path / "r.md").exists()
    eval_bfp.main(["--device=cpu", "--models=mlp_fsdp",
                   "--multiseed_steps=5", "--seeds=0,1", f"--out={out}"])
    rep = json.loads(out.read_text())
    assert set(rep) == JAX_REPORT_KEYS | {"mlp_fsdp"}
    assert set(rep["mlp_fsdp"]) == MULTI_KEYS
    assert rep["mlp_fsdp"]["seeds"] == [0, 1]
    assert rep["_provenance"]["models"] == ["mlp_fsdp"]
    with pytest.raises(ValueError, match="JAX package's artifact"):
        eval_bfp.main(["--device=cpu", "--models=mlp",
                       f"--out={eval_bfp.REFERENCE_ARTIFACT}"])


def test_committed_artifact_gates():
    with open(os.path.join(ROOT, "docs", "torch_bfp_convergence.json")) as f:
        rep = json.load(f)
    assert JAX_REPORT_KEYS <= set(rep)
    prov = rep["_provenance"]
    assert prov.get("git_sha") and prov.get("timestamp_utc")
    assert "NVIDIA" in (prov.get("nvidia_smi") or "")
    assert prov["nvidia_smi"].rstrip().endswith("W")     # its power limit
    can = rep["mlp_canonical"]
    assert len(can["seeds"]) >= 5 and can["steps"] >= 200
    assert can.get("pairing") == "common-random-numbers"
    m8 = can["bfp_m8"]
    assert m8["ratio_mean"] <= 1.05, m8
    assert m8["ratio_std"] < 0.10, m8
    assert can["bfp_m4"]["ratio_mean"] > 0.7, can["bfp_m4"]
    fsdp = rep["mlp_fsdp"]
    assert len(fsdp["seeds"]) >= 5 and fsdp["steps"] >= 200
    assert fsdp["bfp_m8"]["ratio_mean"] <= 1.05, fsdp["bfp_m8"]
    assert fsdp["bfp_m8"]["ratio_std"] < 0.05, fsdp["bfp_m8"]
    for model in ("mlp", "bert", "resnet"):
        assert set(rep[model]) == SINGLE_KEYS
        assert np.isfinite(rep[model]["baseline"]["final_loss"])
