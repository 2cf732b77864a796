"""The BFP accuracy-bounds artifact of the port — the counterpart of the
JAX package's ``examples/eval_bfp.py``.

    python -m fpga_ai_nic_tpu_torch.eval_bfp [--steps=200] \\
        [--models=mlp,bert,resnet,mlp_canonical,mlp_fsdp] \\
        [--out=docs/torch_bfp_convergence.json] [--device=cuda]

Each model trains on 8 virtual ranks through the explicit ring, compressed
(a BFP mantissa sweep, 8, 6 and 4 bits) and uncompressed, its arms paired
on common random numbers (``evals.bfp_convergence``, the port's
``evals.codec_convergence``); beside them the static codec roundtrip-error
table.  The report has JAX's keys: ``steps``, ``n_devices``,
``codec_error``, one entry a model and ``_provenance``.  ``mlp``,
``bert`` and ``resnet`` run one seed for ``--steps``; ``mlp_canonical``
(200 steps, 64 batches) and ``mlp_fsdp`` (ZeRO-3, 200 steps, 16 batches)
run seeds 0-4 whatever ``--steps`` says, as JAX's floors
(``--multiseed_steps=`` and ``--seeds=`` shorten them for a smoke run; the
gate test refuses such an artifact).  ``final_loss`` is the mean of the
last ``TAIL_K`` recorded losses.

It runs on the card by default (``--device=cpu`` for the plain
versions); its output is ``--out`` (default the port's own
``docs/torch_bfp_convergence.json``, beside it the ``.md`` table) and
never JAX's ``docs/bfp_convergence.json``.  The provenance
carries the commit (``git rev-parse HEAD``, or ``--git_sha=`` where the
checkout is not a git repository), whether the tree was dirty
(``--dirty=``), the card's ``nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader`` and the command line.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional, Sequence

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_OUT = os.path.join(ROOT, "docs", "torch_bfp_convergence.json")
REFERENCE_ARTIFACT = os.path.join(ROOT, "docs", "bfp_convergence.json")
N_DEV = 8
MODELS = ("mlp", "bert", "resnet", "mlp_canonical", "mlp_fsdp")
# ONE endpoint definition for every row: final_loss = mean of the last
# TAIL_K recorded losses (40 steps at record_every=5)
TAIL_K = 8
# the multi-seed arms (JAX's per_model): CRN-paired, >= 5 seeds; their
# step counts are floors the --steps flag does not lower
PER_MODEL = {
    "mlp_canonical": {"steps": 200, "n_batches": 64,
                      "seeds": (0, 1, 2, 3, 4)},
    "mlp_fsdp": {"steps": 200, "n_batches": 16, "seeds": (0, 1, 2, 3, 4)},
}
MANTISSA_SWEEP = (8, 6, 4)


def _git(args: Sequence[str]) -> Optional[str]:
    try:
        out = subprocess.run(["git", *args], capture_output=True, text=True,
                             timeout=10, cwd=ROOT)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip() if out.returncode == 0 else None


def nvidia_smi() -> Optional[str]:
    """The card's ``name, power.limit`` as ``nvidia-smi`` prints them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0] if out.returncode == 0 and lines else None


def provenance(argv: Sequence[str], device, git_sha: Optional[str] = None,
               dirty: Optional[bool] = None) -> dict:
    """Commit, dirty flag, card and command line of this run."""
    import torch
    sha = _git(["rev-parse", "HEAD"]) or git_sha
    if dirty is None:
        status = _git(["status", "--porcelain", "--", ".",
                       ":(exclude)PERF_LEDGER.jsonl"])
        dirty = None if status is None else bool(status)
    return {"timestamp_utc": time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                           time.gmtime()),
            "git_sha": sha, "working_tree_dirty": dirty,
            "device": (torch.cuda.get_device_name(device)
                       if device.type == "cuda" else "cpu"),
            "nvidia_smi": nvidia_smi() if device.type == "cuda" else None,
            "torch": torch.__version__, "argv": list(argv)}


def _flag(argv: Sequence[str], name: str, default=None):
    val = default
    for a in argv:
        key, _, v = a.partition("=")
        if key == name:
            val = v
    return val


def evaluate(models: Sequence[str], steps: int, device, *,
             multiseed_steps: Optional[int] = None,
             seeds: Optional[Sequence[int]] = None) -> Dict:
    """The report's model entries and its codec table."""
    from .evals import bfp_convergence as ev
    report: Dict = {"steps": steps, "n_devices": N_DEV,
                    "codec_error": ev.codec_error_table()}
    for model in models:
        if model not in MODELS:
            raise ValueError(f"--models: {model!r} is not one of {MODELS}")
        ov = PER_MODEL.get(model)
        if ov is not None:
            m_steps = multiseed_steps or ov["steps"]
            m_seeds = tuple(seeds) if seeds is not None else ov["seeds"]
            print(f"[eval_bfp] {model}: {m_steps} steps x 4 arms x "
                  f"{len(m_seeds)} seeds", file=sys.stderr, flush=True)
            report[model] = ev.run_comparison_multiseed(
                model, m_steps, seeds=m_seeds, mantissa_sweep=MANTISSA_SWEEP,
                n_batches=ov["n_batches"], tail_k=TAIL_K, device=device)
            for mb in MANTISSA_SWEEP:
                agg = report[model][f"bfp_m{mb}"]
                print(f"[eval_bfp]   m{mb}: ratio {agg['ratio_mean']:.4f} "
                      f"+/- {agg['ratio_std']:.4f}", file=sys.stderr,
                      flush=True)
            continue
        print(f"[eval_bfp] {model}: {steps} steps x 4 arms", file=sys.stderr,
              flush=True)
        report[model] = ev.run_comparison(
            model, steps, mantissa_sweep=MANTISSA_SWEEP, tail_k=TAIL_K,
            device=device)
        for k, v in report[model].items():
            if isinstance(v, dict) and "final_loss" in v:
                print(f"[eval_bfp]   {k}: final={v['final_loss']:.4f} "
                      f"ratio={v.get('final_loss_ratio', 1.0):.4f}",
                      file=sys.stderr, flush=True)
    return report


def write_md(path: str, report: dict) -> None:
    """JAX's table layout: the codec error, then a row a model."""
    prov = report.get("_provenance", {})
    lines = ["# BFP accuracy bounds of the PyTorch/CUDA port (measured)", "",
             "Generated by `python -m fpga_ai_nic_tpu_torch.eval_bfp` on "
             f"{prov.get('nvidia_smi') or prov.get('device')} (commit "
             f"{prov.get('git_sha')}, dirty {prov.get('working_tree_dirty')}"
             f", {prov.get('timestamp_utc')}), 8 virtual ranks; both arms "
             "use the explicit ring collective, so the only difference is "
             "per-hop BFP quantization.", "",
             "## Codec roundtrip error vs mantissa width", "",
             "| mantissa bits | rel L2 error | max abs error | wire B/value |",
             "|---|---|---|---|"]
    for r in report["codec_error"]:
        lines.append(f"| {r['mantissa_bits']} | {r['rel_l2_error']:.2e} "
                     f"| {r['max_abs_error']:.2e} "
                     f"| {r['wire_bytes_per_value']:.3f} |")
    lines += ["", f"## Training curves (adamw, fixed synthetic data, "
              f"{report['steps']} steps unless noted)", "",
              "Final loss (ratio against the uncompressed baseline), arms "
              "paired on common random numbers; a multi-seed row gives the "
              "mean paired ratio and its standard deviation.  The "
              "`mlp_fsdp` row is ZeRO-3: BFP on the weight all-gather and "
              "the gradient reduce-scatter.", "",
              "| model | baseline | bfp m8 | bfp m6 | bfp m4 |",
              "|---|---|---|---|---|"]
    for m in MODELS:
        rep = report.get(m)
        if rep is None:
            continue
        if "seeds" in rep:
            row = [f"| {m} ({rep['steps']} steps, {len(rep['seeds'])} "
                   "seeds) | mean ratio "]
            for mb in MANTISSA_SWEEP:
                agg = rep[f"bfp_m{mb}"]
                row.append(f"| {agg['ratio_mean']:.3f}x +/- "
                           f"{agg['ratio_std']:.3f} ")
        else:
            row = [f"| {m} ({rep['steps']} steps) "
                   f"| {rep['baseline']['final_loss']:.4f} "]
            for mb in MANTISSA_SWEEP:
                arm = rep[f"bfp_m{mb}"]
                row.append(f"| {arm['final_loss']:.4f} "
                           f"({arm['final_loss_ratio']:.3f}x) ")
        lines.append("".join(row) + "|")
    lines.append("")
    with open(path, "w") as f:
        f.write("\n".join(lines))


def main(argv: Sequence[str]) -> dict:
    from .device import resolve_device
    steps = int(_flag(argv, "--steps", 200))
    models: List[str] = _flag(argv, "--models", ",".join(MODELS)).split(",")
    out = os.path.abspath(_flag(argv, "--out", DEFAULT_OUT))
    if out == os.path.abspath(REFERENCE_ARTIFACT):
        raise ValueError(f"--out={out} is the JAX package's artifact")
    device = resolve_device(_flag(argv, "--device", "cuda"))
    if device.type == "cuda":
        import torch       # f32 products and convolutions, as on the CPU
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    ms = _flag(argv, "--multiseed_steps")
    seeds = _flag(argv, "--seeds")
    dirty = _flag(argv, "--dirty")
    report = evaluate(models, steps, device,
                      multiseed_steps=int(ms) if ms else None,
                      seeds=[int(s) for s in seeds.split(",")]
                      if seeds else None)
    prov = provenance(argv, device, _flag(argv, "--git_sha"),
                      None if dirty is None else dirty in ("1", "true"))
    prov["models"] = list(models)
    report["_provenance"] = prov
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump(report, f, indent=1)
    write_md(os.path.splitext(out)[0] + ".md", report)
    return {"ok": True, "models": models, "steps": steps, "out": out,
            "device": report["_provenance"]["device"]}


if __name__ == "__main__":
    print(json.dumps(main(sys.argv[1:])))
