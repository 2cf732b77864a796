"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA card (sm_90a) and ``nvcc``: the kernels have no
CPU mode, so without a card they skip.  Run them on the card with

    python -m pytest tests/test_torch_cuda.py -q

The file imports torch only (no JAX), so it runs where JAX is absent.
"""

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

from fpga_ai_nic_tpu_torch import optim
from fpga_ai_nic_tpu_torch.ops import (bfp_cuda, int8_cuda, integrity,
                                       paged_attend,
                                       ring_cuda)
from fpga_ai_nic_tpu_torch.utils.config import (BFPConfig, OptimizerConfig,
                                                OptimizerSpec)

TILE = 16 * 128


def _shards(n, C, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, n * C)) * 3).astype(np.float32)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _mixed(x, seed):
    """Magnitudes over 12 decades, zeros and subnormals: every scale and
    clamp branch of the BFP encode."""
    g = torch.Generator().manual_seed(seed)
    x = x * torch.pow(10.0, torch.randint(-6, 6, x.shape, generator=g)
                      .float()).to(x.device)
    x.view(-1)[::97] = 0
    x.view(-1)[5::131] *= 1e-39
    return x


def _launches():
    return [ring_cuda.RING_RS.launches, ring_cuda.RING_AG.launches]


# (n, block, mantissa_bits, rounding, tiles a chunk); 1 tile: a chunk of
# one tile; n * tiles * 32 threads that are not a multiple of 256 leave the
# last block of the launch part-filled
RING_CASES = [(2, 16, 8, "nearest", 4), (3, 16, 8, "nearest", 4),
              (8, 16, 8, "nearest", 4), (16, 16, 8, "nearest", 3),
              (3, 4, 8, "nearest", 1), (2, 32, 8, "nearest", 1),
              (8, 32, 8, "rtz", 3), (16, 4, 5, "rtz", 2),
              (3, 16, 6, "rtz", 5)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,block,mant,rounding,tiles", RING_CASES)
def test_kernels_bitexact_vs_plain_on_card(cuda_device, n, block, mant,
                                           rounding, tiles):
    """ring_rs_update (sgd, none), ring_ag, bfp_encode/decode on the card
    == their plain versions on the same card tensors, bit for bit; each
    ring collective one launch a call."""
    cfg = BFPConfig(codec="pallas", block_size=block, mantissa_bits=mant,
                    rounding=rounding)
    opt = OptimizerConfig(kind="sgd", learning_rate=0.1, weight_decay=0.01)
    C = tiles * block * 128
    x = _mixed(torch.from_numpy(_shards(n, C, seed=n)), n).to(cuda_device)
    w = torch.randn((n, C), generator=torch.Generator().manual_seed(n)
                    ).to(cuda_device)
    hyper = optim.fused_hyperparams(opt, 0, device=cuda_device)
    before = _launches()
    got = ring_cuda.ring_reduce_scatter_update_fused(
        x, w, {}, hyper, opt_kind="sgd", compression=cfg)
    g_only = ring_cuda.ring_reduce_scatter_fused(x, compression=cfg)
    ag = ring_cuda.ring_all_gather_fused(got[1], compression=cfg)
    torch.cuda.synchronize()
    assert _launches() == [before[0] + 2, before[1] + 1]
    want = ring_cuda.ring_reduce_scatter_update_plain(
        x, w, {}, hyper, opt_kind="sgd", compression=cfg)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(g_only, want[0])
    assert torch.equal(ag, ring_cuda.ring_all_gather_plain(got[1], cfg))
    assert bool((ag == ag[0]).all())
    assert torch.equal(ring_cuda.ring_all_gather_fused(got[1],
                                                       compression=cfg), ag)
    flat = x.reshape(-1)
    m, s = bfp_cuda.bfp_encode(flat, block, mant, rounding)
    pm, ps = bfp_cuda.bfp_encode_plain(flat, block, mant, rounding)
    assert torch.equal(m, pm) and torch.equal(s, ps)
    assert torch.equal(bfp_cuda.bfp_decode(m, s, block),
                       bfp_cuda.bfp_decode_plain(pm, ps, block))
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("n,block,mant,rounding", [
    (4, 16, 8, "nearest"), (3, 4, 8, "rtz"), (16, 32, 6, "nearest")])
@pytest.mark.parametrize("kind", ["momentum", "adamw"])
def test_rs_update_other_optimizers_on_card(cuda_device, kind, n, block, mant,
                                            rounding):
    cfg = BFPConfig(codec="pallas", block_size=block, mantissa_bits=mant,
                    rounding=rounding)
    opt = OptimizerConfig(kind=kind, learning_rate=1e-3, weight_decay=0.01)
    C = 2 * block * 128
    x = torch.from_numpy(_shards(n, C, seed=7)).to(cuda_device)
    g = torch.Generator().manual_seed(7)
    w = torch.randn((n, C), generator=g).to(cuda_device)
    st = {k: torch.rand((n, C), generator=g).to(cuda_device) * 1e-3
          for k in OptimizerSpec(kind=kind).state_keys}
    hyper = optim.fused_hyperparams(opt, 3, device=cuda_device)
    before = ring_cuda.RING_RS.launches
    got = ring_cuda.ring_reduce_scatter_update_fused(
        x, w, st, hyper, opt_kind=kind, compression=cfg)
    assert ring_cuda.RING_RS.launches == before + 1
    want = ring_cuda.ring_reduce_scatter_update_plain(
        x, w, st, hyper, opt_kind=kind, compression=cfg)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for k in st:
        assert torch.equal(got[2][k], want[2][k]), k


def _int8_edge_blocks(x, block, seed):
    """Blocks of x ([tiles >= 3] sublane tiles) set to the encode's edges:
    in tile 1, blocks of max 127 * 1.5 (scale 1.5 exactly) whose other
    values are quotients k + 1/2 (the ties of "nearest"), or 127 * 1.5 *
    (1 + 2^-9), whose scale still rounds to 1.5 (quotients past 127, which
    clip); in tile 2, NaN, +inf, -inf and NaN-with-inf blocks."""
    g = torch.Generator().manual_seed(seed)
    t = x.view(-1, block, 128)
    k = torch.randint(0, 127, (block, 32), generator=g).float()
    sign = torch.where(torch.rand((block, 32), generator=g) < 0.5, -1.0, 1.0)
    t[1, :, 9:41] = ((k + 0.5) * 1.5 * sign).to(x.device)
    t[1, :, 41:51] = -127 * 1.5 * (1 + 2.0 ** -9)
    t[1, 0, 9:51] = 127 * 1.5
    t[2, 0, 0] = float("nan")
    t[2, 0, 1] = float("inf")
    t[2, block - 1, 2] = -float("inf")
    t[2, 0, 3], t[2, block - 1, 3] = float("nan"), float("inf")
    return x


@pytest.mark.cuda
@pytest.mark.parametrize("block", [2, 4, 8, 16, 32])
@pytest.mark.parametrize("rounding,seed", [("stochastic", 0),
                                          ("stochastic", 7),
                                          ("nearest", 0)])
def test_int8_kernels_bitexact_vs_plain_on_card(cuda_device, block, rounding,
                                                seed):
    """int8_encode / int8_decode on the card == their plain versions on the
    same card tensors, bit for bit: mixed magnitudes, all-zero blocks,
    subnormals, negative zeros, quotients k + 1/2, values that clip at
    +-127, NaN and +-inf blocks; one launch each, and a second launch
    bit-equal to the first."""
    tiles = 7
    x = torch.from_numpy(_shards(1, tiles * block * 128, seed=block)
                         .reshape(-1)).to(cuda_device)
    x = x * torch.logspace(-3, 3, x.numel(), device=cuda_device)
    x[:block * 128] = 0                        # a whole tile of zero blocks
    x[5 * 128::128 * 3] *= 1e-39               # subnormals
    x[7::97] = -0.0
    x = _int8_edge_blocks(x, block, seed)
    counts = [int8_cuda.ENCODE.launches, int8_cuda.DECODE.launches]
    q, s = int8_cuda.int8_encode(x, block, rounding, seed)
    pq, ps = int8_cuda.int8_encode_plain(x, block, rounding, seed)
    d = int8_cuda.int8_decode(q, s, block)
    pd = int8_cuda.int8_decode_plain(pq, ps, block)
    torch.cuda.synchronize()
    assert [int8_cuda.ENCODE.launches, int8_cuda.DECODE.launches] == [
        c + 1 for c in counts]
    assert torch.equal(q, pq)
    assert torch.equal(s.view(torch.int16), ps.view(torch.int16))
    assert torch.equal(d.view(torch.int32), pd.view(torch.int32))
    q2, s2 = int8_cuda.int8_encode(x, block, rounding, seed)
    assert torch.equal(q2, q) and torch.equal(s2.view(torch.int16),
                                              s.view(torch.int16))
    assert torch.equal(int8_cuda.int8_decode(q, s, block).view(torch.int32),
                       d.view(torch.int32))


@pytest.mark.cuda
def test_int8_codec_routes_on_card(cuda_device):
    """Int8Codec(backend="pallas") launches the kernels on a card tensor;
    plain=True keeps the plain version there, with the same bits; a payload
    off the tile grid raises."""
    from fpga_ai_nic_tpu_torch.compress import Int8Codec
    x = torch.randn(4 * TILE, generator=torch.Generator().manual_seed(3)
                    ).to(cuda_device)
    before = int8_cuda.ENCODE.launches
    got = Int8Codec(backend="pallas", seed=1).roundtrip(x)
    assert int8_cuda.ENCODE.launches == before + 1
    want = Int8Codec(backend="pallas", seed=1, plain=True).roundtrip(x)
    assert int8_cuda.ENCODE.launches == before + 1
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="divisible"):
        int8_cuda.int8_encode(x[:TILE + 16])


PAGED_SHAPES = {
    # name: R, H, n_kv, T, hd, page_size, P, pool dtype
    "decode_gqa_ps16": (16, 32, 8, 1, 128, 16, 128, torch.bfloat16),
    "decode_mha_ps128": (4, 8, 8, 1, 128, 128, 16, torch.bfloat16),
    "prefill_gqa_ps16": (1, 32, 8, 256, 128, 16, 128, torch.bfloat16),
    "prefill_gqa_t33": (2, 8, 2, 33, 128, 16, 8, torch.bfloat16),
    # chip_smoke.py's PAGED_SHAPES, the serving path's
    "smoke_decode_gqa_ps16": (16, 32, 8, 1, 128, 16, 128, torch.bfloat16),
    "smoke_decode_mha_ps16": (16, 32, 32, 1, 128, 16, 128, torch.bfloat16),
    "smoke_decode_gqa_ps128": (16, 32, 8, 1, 128, 128, 16, torch.bfloat16),
    "smoke_prefill_gqa_ps16": (1, 32, 8, 256, 128, 16, 128, torch.bfloat16),
    "smoke_prefill_mha_ps128": (1, 32, 32, 256, 128, 128, 16,
                                torch.bfloat16),
}


def _paged_inputs(device, R, H, n_kv, T, hd, ps, P, dt, seed):
    """A shuffled table over a dirty pool (live pages O(1), dead ones 1e3
    garbage), ragged positions, f32 q."""
    g = torch.Generator(device=device).manual_seed(seed)
    n_pages = R * P + 1
    pk = (torch.randn((n_pages, n_kv, ps, hd), generator=g,
                      device=device) * 1e3).to(dt)
    pv = (torch.randn((n_pages, n_kv, ps, hd), generator=g,
                      device=device) * 1e3).to(dt)
    table = (torch.randperm(n_pages - 1, generator=g, device=device)
             [:R * P] + 1).to(torch.int32).reshape(R, P)
    pos = torch.randint(0, P * ps - T + 1, (R,), generator=g,
                        device=device, dtype=torch.int32)
    for r in range(R):
        n_live = min((int(pos[r]) + T - 1) // ps + 1, P)
        live = table[r, :n_live].long()
        pk[live] = (pk[live].float() * 1e-3).to(dt)
        pv[live] = (pv[live].float() * 1e-3).to(dt)
    q = torch.randn((R, H, T, hd), generator=g, device=device)
    return q, pk, pv, table, pos


@pytest.mark.cuda
@pytest.mark.parametrize("shape", sorted(PAGED_SHAPES))
def test_paged_attend_kernel_vs_plain_on_card(cuda_device, shape):
    """The paged gather-attend kernel against its plain version on the same
    card tensors: a shuffled table over a dirty pool, ragged positions.
    max abs error <= 5e-5 on O(1) outputs (f32 sums over at most 2048
    keys, taken in another order; at prefill q and p as bf16 hi + lo
    terms); a second launch gives the same bits."""
    R, H, n_kv, T, hd, ps, P, dt = PAGED_SHAPES[shape]
    q, pk, pv, table, pos = _paged_inputs(cuda_device, R, H, n_kv, T, hd,
                                          ps, P, dt, R * 1000 + T)
    before = paged_attend.PAGED_ATTEND.launches
    got = paged_attend.paged_gather_attend(q, pk, pv, table, pos,
                                           page_size=ps)
    again = paged_attend.paged_gather_attend(q, pk, pv, table, pos,
                                             page_size=ps)
    want = paged_attend.paged_gather_attend_plain(q, pk, pv, table, pos,
                                                  page_size=ps)
    torch.cuda.synchronize()
    assert paged_attend.PAGED_ATTEND.launches == before + 2
    assert bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= 5e-5
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["prefill_gqa_ps16", "prefill_gqa_t33",
                                   "decode_gqa_ps16"])
def test_paged_attend_bf16_q_on_card(cuda_device, shape):
    """A bf16 q (the serving path's) takes one bf16 term of q at prefill:
    its lo term would be exactly zero.  Within 5e-5 of the plain version
    on the same bf16 q."""
    R, H, n_kv, T, hd, ps, P, dt = PAGED_SHAPES[shape]
    q, pk, pv, table, pos = _paged_inputs(cuda_device, R, H, n_kv, T, hd,
                                          ps, P, dt, 7 + T)
    q = q.to(torch.bfloat16)
    got = paged_attend.paged_gather_attend(q, pk, pv, table, pos,
                                           page_size=ps)
    want = paged_attend.paged_gather_attend_plain(q, pk, pv, table, pos,
                                                  page_size=ps)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= 5e-5


FLASH_SHAPES = {
    # name: B, H, n_kv, S, causal
    "gqa_causal": (1, 8, 2, 256, True),
    "gqa_noncausal": (1, 8, 2, 192, False),
    "mha_causal": (2, 4, 4, 128, True),
    "gqa_causal_b2_s512": (2, 8, 2, 512, True),
    "gqa_causal_s320": (1, 8, 2, 320, True),     # an odd count of q tiles
    # chip_smoke.py's FLASH_SHAPES: the training path's, and MHA S=1024
    "path_gqa_causal_s4096": (1, 32, 8, 4096, True),
    "mha_noncausal_s1024": (1, 32, 32, 1024, False),
}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", sorted(FLASH_SHAPES))
def test_flash_kernels_vs_plain_on_card(cuda_device, shape):
    """flash_fwd, flash_dq and flash_dkv against their plain versions on
    the same bf16 card tensors (head_dim 128): out, dq, dk, dv within
    ``flash_attention.tol_ratio`` <= 1, lse within LSE_TOL; a second
    launch of each kernel gives the same bits."""
    from fpga_ai_nic_tpu_torch.ops import flash_attention as fa
    B, H, n_kv, S, causal = FLASH_SHAPES[shape]
    g = torch.Generator(device=cuda_device).manual_seed(S + H)

    def rand(*s):
        return torch.randn(s, generator=g, device=cuda_device).to(
            torch.bfloat16)

    q, k, v = rand(B, H, S, 128), rand(B, n_kv, S, 128), rand(B, n_kv, S, 128)
    do = rand(B, H, S, 128)
    kw = dict(causal=causal, sm_scale=128 ** -0.5)
    counts = [fa.FLASH_FWD.launches, fa.FLASH_DQ.launches,
              fa.FLASH_DKV.launches]
    out, lse = fa.flash_fwd_cuda(q, k, v, **kw)
    p_out, p_lse = fa.flash_fwd_plain(q, k, v, **kw)
    delta = (do.float() * out.float()).sum(-1)
    dq = fa.flash_dq_cuda(q, k, v, do, lse, delta, **kw)
    dk, dv = fa.flash_dkv_cuda(q, k, v, do, lse, delta, **kw)
    again = (*fa.flash_fwd_cuda(q, k, v, **kw),
             fa.flash_dq_cuda(q, k, v, do, lse, delta, **kw),
             *fa.flash_dkv_cuda(q, k, v, do, lse, delta, **kw))
    p_dq = fa.flash_dq_plain(q, k, v, do, lse, delta, **kw)
    p_dk, p_dv = fa.flash_dkv_plain(q, k, v, do, lse, delta, **kw)
    torch.cuda.synchronize()
    assert [fa.FLASH_FWD.launches, fa.FLASH_DQ.launches,
            fa.FLASH_DKV.launches] == [c + 2 for c in counts]
    for name, a, b in zip(("out", "lse", "dq", "dk", "dv"),
                          (out, lse, dq, dk, dv), again):
        assert torch.equal(a, b), f"{name}: a second launch differs"
    assert float((lse - p_lse).abs().max()) <= fa.LSE_TOL
    for name, a, b in (("out", out, p_out), ("dq", dq, p_dq),
                       ("dk", dk, p_dk), ("dv", dv, p_dv)):
        assert bool(torch.isfinite(a.float()).all()), name
        assert fa.tol_ratio(a, b) <= 1.0, name


@pytest.mark.cuda
def test_flash_kernels_raise_on_unbuilt_operands(cuda_device):
    """A CUDA tensor a kernel is not built for raises; it never takes the
    plain version: the tensor-core wrappers refuse f32, and the forward,
    dq and dk/dv refuse head_dim 96 (the entry sends it to the second
    family); the C entries themselves refuse a head dim they have no
    instantiation for, and nothing launches; the entry refuses a dtype no
    kernel takes."""
    from fpga_ai_nic_tpu_torch.ops import flash_attention as fa
    from fpga_ai_nic_tpu_torch.ops._build import ptr
    kw = dict(causal=True, sm_scale=0.125)
    f32 = torch.zeros((1, 2, 128, 128), device=cuda_device)
    with pytest.raises(TypeError):
        fa.flash_fwd_cuda(f32, f32, f32, **kw)

    def bf16(hd):
        return torch.zeros((1, 2, 128, hd), device=cuda_device,
                           dtype=torch.bfloat16)

    rows = torch.zeros((1, 2, 128), device=cuda_device)
    hd96 = bf16(96)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_dkv_cuda(hd96, hd96, hd96, hd96, rows, rows, **kw)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_fwd_cuda(hd96, hd96, hd96, **kw)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_dq_cuda(hd96, hd96, hd96, hd96, rows, rows, **kw)
    counts = [fa.FLASH_FWD.launches, fa.FLASH_DQ.launches,
              fa.FLASH_DKV.launches]
    head = (2, 1, 2, 128, 128, 1, 0.125)
    p96, pr = ptr(hd96), ptr(rows)
    with pytest.raises(RuntimeError, match="launch failed"):
        fa.FLASH_FWD(p96, p96, p96, None, p96, pr, *head, 96, 0, 0)
    with pytest.raises(RuntimeError, match="launch failed"):
        fa.FLASH_DQ(p96, p96, p96, p96, pr, pr, None, p96, *head, 96, 0,
                    0)
    with pytest.raises(RuntimeError, match="launch failed"):
        fa.FLASH_DKV(p96, p96, p96, p96, pr, pr, None, p96, p96, *head, 96,
                     0, 0)
    assert [fa.FLASH_FWD.launches, fa.FLASH_DQ.launches,
            fa.FLASH_DKV.launches] == counts
    f64 = torch.zeros((1, 2, 128, 128), device=cuda_device,
                      dtype=torch.float64)
    with pytest.raises(TypeError):
        fa.flash_attention(f64, f64, f64)


GENERIC_SHAPES = {
    # name: B, H, n_kv, S, hd, causal, dtype
    "tiny_f32_hd16": (2, 4, 2, 128, 16, True, torch.float32),
    "f32_hd64_noncausal": (1, 4, 2, 256, 64, False, torch.float32),
    "bf16_hd64": (1, 8, 2, 256, 64, True, torch.bfloat16),
    "f16_hd256_mha": (1, 2, 2, 128, 256, True, torch.float16),
    "f32_hd128_s512": (1, 4, 1, 512, 128, True, torch.float32),
}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", sorted(GENERIC_SHAPES))
def test_flash_generic_kernels_vs_plain_on_card(cuda_device, shape):
    """The second family (csrc/flash_generic.cu) through the entry and its
    autograd against the plain versions on the same card tensors: f32
    within the JAX tests' own tolerances (2e-5 forward, atol 5e-5 / rtol
    5e-4 gradients), bf16 and f16 within ``tol_ratio`` <= 1; one launch of
    each step's kernel a call, in the family its route picks (the second
    family everywhere but bf16 at head_dim 64, which takes the tensor
    cores for all three), none of the other family's; a second launch
    gives the same bits."""
    from fpga_ai_nic_tpu_torch.ops import flash_attention as fa
    B, H, n_kv, S, hd, causal, dt = GENERIC_SHAPES[shape]
    g = torch.Generator(device=cuda_device).manual_seed(S + hd)

    def rand(*s):
        return torch.randn(s, generator=g, device=cuda_device).to(dt)

    q, k, v = rand(B, H, S, hd), rand(B, n_kv, S, hd), rand(B, n_kv, S, hd)
    do = rand(B, H, S, hd)
    kw = dict(causal=causal, sm_scale=hd ** -0.5)
    picks = [fa.tensor_cores_take(kd, q.shape, [dt] * 3)
             for kd in ("fwd", "dq", "dkv")]
    assert picks == [dt == torch.bfloat16 and hd == 64] * 3
    tc = [fa.FLASH_FWD, fa.FLASH_DQ, fa.FLASH_DKV]
    gen = [fa.FLASH_FWD_GENERIC, fa.FLASH_DQ_GENERIC, fa.FLASH_DKV_GENERIC]
    fam = [t if p else g_ for p, t, g_ in zip(picks, tc, gen)]
    other = [g_ if p else t for p, t, g_ in zip(picks, tc, gen)]
    before = [k_.launches for k_ in fam]
    before_other = [k_.launches for k_ in other]
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = fa.flash_attention(*leaves, **kw)
    dq, dk, dv = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    assert [k_.launches for k_ in fam] == [b + 1 for b in before]
    assert [k_.launches for k_ in other] == before_other
    fwd, dq_fn, dkv_fn = (
        (t if p else g_) for p, t, g_ in zip(
            picks, (fa.flash_fwd_cuda, fa.flash_dq_cuda, fa.flash_dkv_cuda),
            (fa.flash_fwd_generic_cuda, fa.flash_dq_generic_cuda,
             fa.flash_dkv_generic_cuda)))
    p_out, p_lse = fa.flash_fwd_plain(q, k, v, **kw)
    o2, lse = fwd(q, k, v, **kw)
    delta = (do.float() * out.detach().float()).sum(-1)
    p_dq = fa.flash_dq_plain(q, k, v, do, lse, delta, **kw)
    p_dk, p_dv = fa.flash_dkv_plain(q, k, v, do, lse, delta, **kw)
    again = (dq_fn(q, k, v, do, lse, delta, **kw),
             *dkv_fn(q, k, v, do, lse, delta, **kw))
    torch.cuda.synchronize()
    assert torch.equal(o2, out.detach())
    for name, a, b in zip(("dq", "dk", "dv"), (dq, dk, dv), again):
        assert torch.equal(a, b), f"{name}: a second launch differs"
    assert float((lse - p_lse).abs().max()) <= fa.LSE_TOL
    for name, a, b, tol in (("out", out.detach(), p_out, (2e-5, 2e-5)),
                            ("dq", dq, p_dq, (5e-5, 5e-4)),
                            ("dk", dk, p_dk, (5e-5, 5e-4)),
                            ("dv", dv, p_dv, (5e-5, 5e-4))):
        assert bool(torch.isfinite(a.float()).all()), name
        if dt == torch.float32:
            torch.testing.assert_close(a, b, atol=tol[0], rtol=tol[1])
        else:
            assert fa.tol_ratio(a, b) <= 1.0, name


@pytest.mark.cuda
def test_auto_route_runs_an_f32_llama_step_on_card(cuda_device):
    """attn_impl="auto" on the tiny f32 config (head_dim 16) takes the
    flash kernels on the card, as the JAX route takes Pallas for it on a
    TPU: the second family's, which trains (ROADMAP C.1)."""
    from fpga_ai_nic_tpu_torch import train_llama
    from fpga_ai_nic_tpu_torch.ops import flash_attention as fa
    before = [fa.FLASH_FWD.launches, fa.FLASH_FWD_GENERIC.launches,
              fa.FLASH_DKV_GENERIC.launches]
    out = train_llama.main([
        "--model=tiny", "--model.attn_block=128", "--model.attn_impl=auto",
        "--seq=128", "--global_batch=4", "--mesh.dp=2", "--iters=1"])
    torch.cuda.synchronize()
    assert np.isfinite(out["loss_first"]) and np.isfinite(out["loss_last"])
    assert out["device"] == torch.cuda.get_device_name(cuda_device)
    assert fa.FLASH_FWD.launches == before[0]
    assert fa.FLASH_FWD_GENERIC.launches > before[1]
    assert fa.FLASH_DKV_GENERIC.launches > before[2]


# (n, block, tiles a chunk, tiles a frame, optimizer)
PAIR_CASES = [(2, 16, 4, 2, None), (8, 16, 3, 1, "sgd"), (3, 4, 6, 3, "sgd"),
              (4, 16, 4, 4, "momentum"), (5, 32, 2, 1, "adamw")]


@pytest.mark.cuda
@pytest.mark.parametrize("n,block,tiles,frame_tiles,kind", PAIR_CASES)
def test_ring_rs_checksum_pair_on_card(cuda_device, n, block, tiles,
                                       frame_tiles, kind):
    """The integrity launch of ring_rs: its (send, recv) pair equals the
    plain version's bit for bit, g, w and the moments equal the
    integrity-off launch's, a repeat launch gives the same pair, and the
    pair conserves."""
    cfg = BFPConfig(codec="pallas", block_size=block)
    C = tiles * block * 128
    se = frame_tiles * block * 128
    x = _mixed(torch.from_numpy(_shards(n, C, seed=n + 1)), n).to(cuda_device)
    g = torch.Generator().manual_seed(n)
    w = torch.randn((n, C), generator=g).to(cuda_device)
    st = {} if kind is None else {
        k: torch.rand((n, C), generator=g).to(cuda_device) * 1e-3
        for k in OptimizerSpec(kind=kind).state_keys}
    if kind is None:
        off = ring_cuda.ring_reduce_scatter_fused(x, compression=cfg)
        before = ring_cuda.RING_RS.launches
        got, pair = ring_cuda.ring_reduce_scatter_fused(
            x, compression=cfg, slice_elems=se, integrity=True)
        assert ring_cuda.RING_RS.launches == before + 1
        want = ring_cuda.ring_reduce_scatter_update_plain(
            x, None, {}, None, opt_kind=None, compression=cfg,
            slice_elems=se, integrity=True)
        assert torch.equal(got, off) and torch.equal(got, want[0])
        again = ring_cuda.ring_reduce_scatter_fused(
            x, compression=cfg, slice_elems=se, integrity=True)[1]
    else:
        hyper = optim.fused_hyperparams(
            OptimizerConfig(kind=kind, learning_rate=1e-2), 2,
            device=cuda_device)

        def run(integ):
            return ring_cuda.ring_reduce_scatter_update_fused(
                x, w, st, hyper, opt_kind=kind, compression=cfg,
                slice_elems=se, integrity=integ)
        off, on = run(False), run(True)
        pair = on[3]
        want = ring_cuda.ring_reduce_scatter_update_plain(
            x, w, st, hyper, opt_kind=kind, compression=cfg, slice_elems=se,
            integrity=True)
        assert torch.equal(on[0], off[0]) and torch.equal(on[1], off[1])
        for k in st:
            assert torch.equal(on[2][k], off[2][k]), k
        assert torch.equal(on[1], want[1])
        again = run(True)[3]
    torch.cuda.synchronize()
    assert pair.dtype == torch.int64 and pair.shape == (n, 2)
    assert torch.equal(pair, want[-1]), (pair, want[-1])
    assert torch.equal(again, pair)
    assert bool(integrity.conservation_ok(pair[:, 0], pair[:, 1]))
    assert bool((pair != 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.uint8, torch.int8, torch.bfloat16,
                                   torch.float16, torch.float32, torch.int32])
@pytest.mark.parametrize("rows,cols", [(1, 7), (5, 4096), (3, 6151),
                                       (2049, 24), (2, 70001)])
def test_row_checksums_vs_plain_on_card(cuda_device, dtype, rows, cols):
    """row_checksums on the card == the plain version, for each element
    size, rows of odd lengths (the word-by-word path) and of whole 16-byte
    runs (the vector path), one launch a call; a flipped bit changes its
    row's checksum and no other."""
    g = torch.Generator().manual_seed(rows * cols)
    raw = torch.randint(-2 ** 31, 2 ** 31 - 1, (rows, cols), dtype=torch.int64,
                        generator=g)
    size = torch.empty((), dtype=dtype).element_size()
    x = raw.to(torch.int32).view(torch.uint8)[:, :cols * size].contiguous()
    x = x.view(dtype).to(cuda_device)
    before = integrity.ROW_CHECKSUMS.launches
    got = integrity.row_checksums(x)
    assert integrity.ROW_CHECKSUMS.launches == before + 1
    assert torch.equal(got, integrity.row_checksums_plain([x], [1]))
    blocks = [x, x[:, : max(1, cols // 3)].contiguous(), x.flip(0)]
    assert torch.equal(integrity.row_checksums(blocks),
                       integrity.row_checksums_plain(blocks))
    flipped = x.clone()
    r = rows // 2
    flipped.view(torch.uint8)[r, -1] ^= 1
    diff = integrity.row_checksums(flipped) != got
    assert bool(diff[r]) and int(diff.sum()) == 1
    torch.cuda.synchronize()


BIAS_SHAPES = {
    # name: B, H, n_kv, S, hd, causal (bf16, a padding mask as key bias);
    # "generic_" cases call the second family's wrappers directly (the
    # entry sends bf16 at head_dim 64 to the tensor cores)
    "generic_bert_base": (8, 12, 12, 512, 64, False),
    "generic_gqa_causal": (2, 8, 2, 256, 64, True),
    "tensor_cores": (2, 8, 8, 1024, 128, False),
    "tensor_cores_causal_gqa": (2, 8, 2, 512, 128, True),
    "tensor_cores_bert_base": (8, 12, 12, 512, 64, False),
    "tensor_cores_hd64_causal_gqa": (2, 8, 2, 256, 64, True),
}


def _padding_bias(B, S, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    lens = torch.randint(S // 2, S + 1, (B,), generator=g, device=device)
    pos = torch.arange(S, device=device)
    return torch.where(pos[None, :] < lens[:, None], 0.0, -1e30)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", sorted(BIAS_SHAPES))
def test_flash_key_bias_vs_plain_on_card(cuda_device, shape):
    """The key-bias channel against the plain versions with the same
    bias: out, dq, dk, dv within ``tol_ratio`` <= 1, lse within LSE_TOL;
    one launch of each step's kernel a call, a second launch bit-equal.
    "tensor_cores" cases go through the entry and its autograd (the bias
    gets no gradient), each kernel's family picked per kernel (bf16 at
    head_dim 128 and 64: all three on the tensor cores); "generic_" cases
    call the second family's three wrappers."""
    from fpga_ai_nic_tpu_torch.ops import flash_attention as fa
    B, H, n_kv, S, hd, causal = BIAS_SHAPES[shape]
    g = torch.Generator(device=cuda_device).manual_seed(S + H + hd)

    def rand(*s):
        return torch.randn(s, generator=g, device=cuda_device).to(
            torch.bfloat16)

    q, k, v = rand(B, H, S, hd), rand(B, n_kv, S, hd), rand(B, n_kv, S, hd)
    do = rand(B, H, S, hd)
    bias = _padding_bias(B, S, cuda_device, S).requires_grad_()
    b = bias.detach()
    kw = dict(causal=causal, sm_scale=hd ** -0.5)
    direct = shape.startswith("generic_")
    tc = [not direct and fa.tensor_cores_take(kd, q.shape, [q.dtype] * 3)
          for kd in ("fwd", "dq", "dkv")]
    if shape == "tensor_cores_bert_base":
        assert tc == [True, True, True]
    fam = [tc_k if use else gen for use, tc_k, gen in zip(
        tc, (fa.FLASH_FWD, fa.FLASH_DQ, fa.FLASH_DKV),
        (fa.FLASH_FWD_GENERIC, fa.FLASH_DQ_GENERIC, fa.FLASH_DKV_GENERIC))]
    fwd = fa.flash_fwd_cuda if tc[0] else fa.flash_fwd_generic_cuda
    before = [k_.launches for k_ in fam]
    if direct:
        out, lse0 = fwd(q, k, v, key_bias=b, **kw)
        args0 = (q, k, v, do, lse0, (do.float() * out.float()).sum(-1))
        dq = fa.flash_dq_generic_cuda(*args0, key_bias=b, **kw)
        dk, dv = fa.flash_dkv_generic_cuda(*args0, key_bias=b, **kw)
    else:
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = fa.flash_attention(*leaves, key_bias=bias, **kw)
        dq, dk, dv = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    assert [k_.launches for k_ in fam] == [b_ + 1 for b_ in before]
    assert bias.grad is None
    o2, lse = fwd(q, k, v, key_bias=b, **kw)
    p_out, p_lse = fa.flash_fwd_plain(q, k, v, key_bias=b, **kw)
    delta = (do.float() * o2.float()).sum(-1)
    p_dq = fa.flash_dq_plain(q, k, v, do, lse, delta, key_bias=b, **kw)
    p_dk, p_dv = fa.flash_dkv_plain(q, k, v, do, lse, delta, key_bias=b,
                                    **kw)
    torch.cuda.synchronize()
    assert torch.equal(o2, out.detach()), "a second launch differs"
    assert float((lse - p_lse).abs().max()) <= fa.LSE_TOL
    for name, a, ref in (("out", o2, p_out), ("dq", dq, p_dq),
                         ("dk", dk, p_dk), ("dv", dv, p_dv)):
        assert bool(torch.isfinite(a.float()).all()), name
        assert fa.tol_ratio(a, ref) <= 1.0, name


DKV_HD64_SHAPES = {
    # name: B, H, n_kv, S, causal (bf16, head_dim 64)
    "bert_base": (8, 12, 12, 512, False),
    "gqa_causal": (2, 8, 2, 256, True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("shape", sorted(DKV_HD64_SHAPES))
def test_flash_dkv_hd64_vs_plain_on_card(cuda_device, shape, with_bias):
    """The tensor-core dk/dv at head_dim 64, with a padding mask as key
    bias and without, against ``flash_dkv_plain`` on the same card
    tensors: dk and dv within ``tol_ratio`` <= 1, one launch a call, a
    second launch bit-equal."""
    from fpga_ai_nic_tpu_torch.ops import flash_attention as fa
    B, H, n_kv, S, causal = DKV_HD64_SHAPES[shape]
    g = torch.Generator(device=cuda_device).manual_seed(S + H + 64)

    def rand(*s):
        return torch.randn(s, generator=g, device=cuda_device).to(
            torch.bfloat16)

    q, k, v = rand(B, H, S, 64), rand(B, n_kv, S, 64), rand(B, n_kv, S, 64)
    do = rand(B, H, S, 64)
    bias = _padding_bias(B, S, cuda_device, S) if with_bias else None
    kw = dict(causal=causal, sm_scale=64 ** -0.5, key_bias=bias)
    out, lse = fa.flash_fwd_plain(q, k, v, **kw)
    args = (q, k, v, do, lse, (do.float() * out.float()).sum(-1))
    before = fa.FLASH_DKV.launches
    dk, dv = fa.flash_dkv_cuda(*args, **kw)
    again = fa.flash_dkv_cuda(*args, **kw)
    p_dk, p_dv = fa.flash_dkv_plain(*args, **kw)
    torch.cuda.synchronize()
    assert fa.FLASH_DKV.launches == before + 2
    for name, a, b, ref in (("dk", dk, again[0], p_dk),
                            ("dv", dv, again[1], p_dv)):
        assert torch.equal(a, b), f"{name}: a second launch differs"
        assert bool(torch.isfinite(a.float()).all()), name
        assert fa.tol_ratio(a, ref) <= 1.0, name


@pytest.mark.cuda
def test_flash_generic_zero_bias_keeps_the_bias_free_bits(cuda_device):
    """The second family's bias is one f32 add (s + 0 is s): a zero bias
    gives the bias-free launch's bits in out, lse, dq, dk and dv."""
    from fpga_ai_nic_tpu_torch.ops import flash_attention as fa
    B, H, S, hd = 2, 4, 256, 64
    g = torch.Generator(device=cuda_device).manual_seed(11)
    q, k, v, do = (torch.randn((B, H, S, hd), generator=g,
                               device=cuda_device).to(torch.bfloat16)
                   for _ in range(4))
    zero = torch.zeros((B, S), device=cuda_device)
    kw = dict(causal=True, sm_scale=hd ** -0.5)
    got = {}
    for name, b in (("none", None), ("zero", zero)):
        out, lse = fa.flash_fwd_generic_cuda(q, k, v, key_bias=b, **kw)
        delta = (do.float() * out.float()).sum(-1)
        args = (q, k, v, do, lse, delta)
        got[name] = (out, lse, fa.flash_dq_generic_cuda(*args, key_bias=b,
                                                        **kw),
                     *fa.flash_dkv_generic_cuda(*args, key_bias=b, **kw))
    torch.cuda.synchronize()
    for a, b in zip(got["none"], got["zero"]):
        assert torch.equal(a, b)


# the q/k offset channel: name -> (Sq, Sk, q_offset, k_offset); the ring's
# past hop and diagonal, the gathered shape (k tiles no row sees), a shift
# that cuts through tiles either way, a chunk wholly in the future
OFFSET_CASES = {
    "past_hop": (256, 256, 256, 0),
    "diagonal": (256, 256, 512, 512),
    "gathered": (128, 512, 256, 0),
    "shift_100": (256, 256, 100, 0),
    "shift_minus_96": (256, 320, 0, 96),
    "future_chunk": (256, 256, 0, 256),
}


def _unseen(Sq, Sk, q_offset, k_offset, device):
    """([Sq] rows that see no key, [Sk] keys no row sees) under causal."""
    rows = q_offset + torch.arange(Sq, device=device) < k_offset
    keys = k_offset + torch.arange(Sk, device=device) > q_offset + Sq - 1
    return rows, keys


def _offset_check(fwd, dq_fn, dkv_fn, q, k, v, do, kw, close):
    """One offset case through a kernel family against the plain versions
    on the same card tensors; rows that see no key: out 0, lse -1e30, dq
    0, and keys no row sees: dk, dv 0."""
    from fpga_ai_nic_tpu_torch.ops import flash_attention as fa
    out, lse = fwd(q, k, v, **kw)
    delta = (do.float() * out.float()).sum(-1)
    dq = dq_fn(q, k, v, do, lse, delta, **kw)
    dk, dv = dkv_fn(q, k, v, do, lse, delta, **kw)
    again = (*fwd(q, k, v, **kw), dq_fn(q, k, v, do, lse, delta, **kw),
             *dkv_fn(q, k, v, do, lse, delta, **kw))
    p_out, p_lse = fa.flash_fwd_plain(q, k, v, **kw)
    p_dq = fa.flash_dq_plain(q, k, v, do, lse, delta, **kw)
    p_dk, p_dv = fa.flash_dkv_plain(q, k, v, do, lse, delta, **kw)
    torch.cuda.synchronize()
    for name, a, b in zip(("out", "lse", "dq", "dk", "dv"),
                          (out, lse, dq, dk, dv), again):
        assert torch.equal(a, b), f"{name}: a second launch differs"
    assert float((lse - p_lse).abs().max()) <= fa.LSE_TOL
    rows, keys = _unseen(q.shape[2], k.shape[2], kw["q_offset"],
                         kw["k_offset"], q.device)
    assert bool((lse[..., rows] == -1e30).all())
    for name, a in (("out", out), ("dq", dq)):
        assert not a[..., rows, :].any(), f"{name}: not 0 where unseen"
    for name, a in (("dk", dk), ("dv", dv)):
        assert not a[..., keys, :].any(), f"{name}: not 0 where unseen"
    for name, a, b in (("out", out, p_out), ("dq", dq, p_dq),
                       ("dk", dk, p_dk), ("dv", dv, p_dv)):
        assert bool(torch.isfinite(a.float()).all()), name
        if bool(b.any()):
            close(name, a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [128, 64])
@pytest.mark.parametrize("case", sorted(OFFSET_CASES))
def test_flash_offsets_vs_plain_on_card(cuda_device, case, hd):
    """The tensor-core forward, dq and dk/dv with q/k offsets (their OFF
    instantiations; the diagonal's zero shift takes the ones without)
    against the plain versions: within ``tol_ratio`` <= 1, lse within
    LSE_TOL, a second launch bit-equal, zeros where nothing is seen."""
    from fpga_ai_nic_tpu_torch.ops import flash_attention as fa
    Sq, Sk, qo, ko = OFFSET_CASES[case]
    g = torch.Generator(device=cuda_device).manual_seed(Sq + qo + hd)

    def rand(*s):
        return torch.randn(s, generator=g, device=cuda_device).to(
            torch.bfloat16)

    q, k, v = rand(1, 8, Sq, hd), rand(1, 2, Sk, hd), rand(1, 2, Sk, hd)
    kw = dict(causal=True, sm_scale=hd ** -0.5, q_offset=qo, k_offset=ko)

    def close(name, a, b):
        assert fa.tol_ratio(a, b) <= 1.0, name

    _offset_check(fa.flash_fwd_cuda, fa.flash_dq_cuda, fa.flash_dkv_cuda,
                  q, k, v, rand(1, 8, Sq, hd), kw, close)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(OFFSET_CASES))
def test_flash_generic_offsets_vs_plain_on_card(cuda_device, case):
    """The second family with q/k offsets (f32, head_dim 32) against the
    plain versions: the JAX tests' f32 limits (2e-5 forward, atol 5e-5 /
    rtol 5e-4 gradients), a second launch bit-equal, zeros where nothing
    is seen."""
    from fpga_ai_nic_tpu_torch.ops import flash_attention as fa
    Sq, Sk, qo, ko = OFFSET_CASES[case]
    g = torch.Generator(device=cuda_device).manual_seed(Sq + qo)

    def rand(*s):
        return torch.randn(s, generator=g, device=cuda_device)

    q, k, v = rand(1, 4, Sq, 32), rand(1, 2, Sk, 32), rand(1, 2, Sk, 32)
    kw = dict(causal=True, sm_scale=32 ** -0.5, q_offset=qo, k_offset=ko)

    def close(name, a, b):
        atol, rtol = (2e-5, 2e-5) if name == "out" else (5e-5, 5e-4)
        torch.testing.assert_close(a, b, atol=atol, rtol=rtol)

    _offset_check(fa.flash_fwd_generic_cuda, fa.flash_dq_generic_cuda,
                  fa.flash_dkv_generic_cuda, q, k, v, rand(1, 4, Sq, 32),
                  kw, close)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
def test_ring_flash_attention_on_card(cuda_device, causal):
    """``ring_flash_attention`` over 4 stacked sp ranks (GQA, head_dim
    128) on the card against the same call on CPU copies (the plain
    versions).  Causal in bf16 (the tensor-core kernels): output and
    q/k/v gradients within ``tol_ratio`` <= 1, one forward, dq and dk/dv
    launch a visible hop (10), the past hops counted on the offset
    wrappers.  Not causal in f32 (the second family): the JAX ring tests'
    limits (atol/rtol 3e-5 forward, 1e-4 / 1e-3 gradients); in bf16 each
    of the 4 hops' outputs is rounded once before the merge, which no
    elementwise bf16 limit of the merged value bounds."""
    from fpga_ai_nic_tpu_torch.ops import flash_attention as fa
    n, Sl = 4, 256
    g = torch.Generator(device=cuda_device).manual_seed(7)
    dt = torch.bfloat16 if causal else torch.float32

    def rand(*s):
        return torch.randn(s, generator=g, device=cuda_device).to(dt)

    q, k, v = rand(n, 1, 8, Sl, 128), rand(n, 1, 2, Sl, 128), rand(
        n, 1, 2, Sl, 128)
    do = rand(n, 1, 8, Sl, 128)
    kernels = ((fa.FLASH_FWD, fa.FLASH_DQ, fa.FLASH_DKV, fa.FLASH_FWD_OFFSETS,
                fa.FLASH_DQ_OFFSETS, fa.FLASH_DKV_OFFSETS) if causal else
               (fa.FLASH_FWD_GENERIC, fa.FLASH_DQ_GENERIC,
                fa.FLASH_DKV_GENERIC))
    before = [k_.launches for k_ in kernels]
    res = {}
    for dev in (cuda_device, torch.device("cpu")):
        leaves = [t.to(dev).requires_grad_() for t in (q, k, v)]
        out = fa.ring_flash_attention(*leaves, "sp", causal=causal)
        res[dev.type] = (out.detach(), *torch.autograd.grad(
            out, leaves, do.to(dev)))
    # causal: the n diagonal hops take the kernels without offsets, the
    # n (n - 1) / 2 past hops their OFF instantiation; without causal all
    # n^2 hops run (on the second family here)
    hops = (n, n * (n - 1) // 2) if causal else (n * n,)
    assert [k_.launches for k_ in kernels] == [
        b + hops[i // 3] for i, b in enumerate(before)]
    for name, a, b in zip(("out", "dq", "dk", "dv"), res["cuda"],
                          res["cpu"]):
        assert bool(torch.isfinite(a.float()).all()), name
        if causal:
            assert fa.tol_ratio(a.cpu(), b) <= 1.0, name
        else:
            atol, rtol = (3e-5, 3e-5) if name == "out" else (1e-4, 1e-3)
            torch.testing.assert_close(a.cpu(), b, atol=atol, rtol=rtol)


# sha256 of out, lse, dq, dk and dv of the tensor-core flash kernels
# without a key bias on ``codec_probe.flash_case``'s inputs (drawn with
# numpy from a seed, so no torch version changes them), as the kernels
# computed them before the key-bias channel existed (NVIDIA H100 80GB HBM3;
# ``codec_probe.py --flash`` on that tree and on this one gave these): the
# bias-free instantiations must keep these bits.  Another nvcc may compile
# other bits; then rerun the probe on both trees.
BIAS_FREE_DIGESTS = {
    "path GQA causal S4096":
        "ef1beb15fd830d8bf2468895f5f7abbff24bae5cff32d65ddbbc7cb5a7b7e409",
    "MHA non-causal S1024":
        "53fbdbb78277b08fd41c63957b573717cf7d1f57f4efee4e6d64109545a0c7da",
}


@pytest.mark.cuda
def test_flash_tensor_cores_bias_free_bits_unchanged(cuda_device):
    """The bias-free tensor-core kernels' outputs, bit for bit, are the
    kernels' from before the key-bias channel (``BIAS_FREE_DIGESTS``)."""
    import importlib.util
    import os
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    mods = {}
    for name in ("chip_smoke", "codec_probe"):
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(root, name + ".py"))
        mods[name] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mods[name])
    cs = mods["chip_smoke"]
    for si in range(len(cs.FLASH_SHAPES)):
        name, digest, *_ = mods["codec_probe"].flash_case(cs, cuda_device,
                                                          si)
        assert digest == BIAS_FREE_DIGESTS[name], (
            f"{name}: bits differ (CUDA {torch.version.cuda})")


@pytest.mark.cuda
def test_resnet_dp_step_on_card_matches_cpu(cuda_device):
    """The tiny f32 ResNet with sync-BN over 4 virtual ranks and the
    slice's collective (fused BFP ring kernels, fused momentum SGD, weight
    decay 1e-4), three steps on the card against the same steps on the
    CPU (the kernels' plain versions), cuDNN's TF32 off: one
    ring_rs_update and one ring_ag launch a step; losses within rtol 1e-4
    (f32 convolutions summed in other orders); masters within 1e-6 plus
    what BFP flips may carry (a value on a rounding boundary lands one
    grid step, 2^-6 of its block's max, away on any of the n hops; the
    momentum keeps 0.9 of each step's error); replicas bit-identical."""
    from fpga_ai_nic_tpu_torch.models import resnet
    from fpga_ai_nic_tpu_torch.parallel.mesh import VirtualRanks
    from fpga_ai_nic_tpu_torch.parallel.train import DPTrainer
    from fpga_ai_nic_tpu_torch.utils.config import (CollectiveConfig,
                                                    MeshConfig, TrainConfig)
    n, lr, mom = 4, 0.1, 0.9
    mcfg = resnet.ResNetConfig.tiny()
    cfg = TrainConfig(
        global_batch=16, mesh=MeshConfig(dp=n),
        collective=CollectiveConfig(
            impl="ring", compression=BFPConfig(codec="pallas"),
            fused_kernel=True, fused_optimizer=True),
        optimizer=OptimizerConfig(kind="momentum", learning_rate=lr,
                                  momentum=mom, weight_decay=1e-4))
    params = resnet.init(torch.Generator().manual_seed(0), mcfg, "cpu")
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((16, 16, 16, 3)).astype(
        np.float32))
    y = torch.from_numpy(rng.integers(0, 10, 16).astype(np.int32))
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        runs = {}
        for dev in ("cpu", "cuda"):
            tr = DPTrainer(resnet.dp_loss_fn(mcfg),
                           VirtualRanks(n, torch.device(dev)), cfg)
            st = tr.init_state(params)
            b = tr.shard_batch((x, y))
            before = _launches()
            losses, gmax = [], []
            for _ in range(3):
                g, loss = tr.grads(st, b)
                gmax.append(float(g.abs().max()))
                st = tr.apply_grads(st, g)
                losses.append(float(loss))
                assert bool((st.replicas == st.replicas[0]).all())
            if dev == "cuda":
                torch.cuda.synchronize()
                assert _launches() == [before[0] + 3, before[1] + 3]
            runs[dev] = (losses, st.w_own.cpu(), gmax)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    m_err = w_err = 0.0
    for gm in runs["cpu"][2]:
        # n hops, each at most 2^-6 of a block max <= n max|g|, over n
        m_err = mom * m_err + n * 2.0 ** -6 * gm
        w_err += lr * m_err
    np.testing.assert_allclose(runs["cuda"][0], runs["cpu"][0], rtol=1e-4)
    err = float((runs["cuda"][1] - runs["cpu"][1]).abs().max())
    assert err <= 1e-6 + w_err, (err, w_err)


@pytest.mark.cuda
def test_moe_llama_step_on_card_matches_cpu(cuda_device):
    """The tiny f32 MoE Llama (4 experts, top-2, capacity factor 16: no
    drops) over dp=2 x ep=2 virtual ranks with the slice's collective
    (fused BFP ring kernels within each ep group, SGD), attn_impl "auto"
    (the flash kernels on the card), two steps on the card against the
    same steps on the CPU (the plain versions): one ring_rs_update and
    one ring_ag launch an ep group a step; losses within rtol 1e-4 (f32
    sums in other orders); masters within 1e-6 plus what BFP flips may
    carry (one grid step, 2^-6 of a block's max, on any of the n hops,
    times lr); the replicas equal within each ep group."""
    import dataclasses
    from fpga_ai_nic_tpu_torch.models import llama
    from fpga_ai_nic_tpu_torch.parallel.mesh import VirtualRanks
    from fpga_ai_nic_tpu_torch.parallel.sharded import ShardedTrainer
    from fpga_ai_nic_tpu_torch.utils.config import (CollectiveConfig,
                                                    MeshConfig, TrainConfig)
    dp, ep, lr = 2, 2, 0.1
    mcfg = dataclasses.replace(llama.LlamaConfig.tiny(), moe_experts=4,
                               moe_capacity_factor=16.0, attn_block=128)
    cfg = TrainConfig(
        global_batch=4, mesh=MeshConfig(dp=dp, ep=ep),
        collective=CollectiveConfig(
            impl="ring", compression=BFPConfig(codec="pallas"),
            fused_kernel=True),
        optimizer=OptimizerConfig(kind="sgd", learning_rate=lr))
    params = llama.init(torch.Generator().manual_seed(0), mcfg, "cpu")
    toks = np.random.default_rng(0).integers(
        0, mcfg.vocab, (4, 129)).astype(np.int32)
    batch = (torch.from_numpy(toks[:, :-1]), torch.from_numpy(toks[:, 1:]))
    runs = {}
    for dev in ("cpu", "cuda"):
        tr = ShardedTrainer(llama.dp_loss_fn(mcfg, dp, ep),
                            VirtualRanks(dp, torch.device(dev), ep=ep), cfg,
                            param_specs=llama.param_specs(mcfg))
        st = tr.init_state(params)
        b = tr.shard_batch(batch)
        before = _launches()
        losses, gmax = [], []
        for _ in range(2):
            g, loss = tr.grads(st, b)
            gmax.append(float(g.abs().max()))
            st = tr.apply_grads(st, g)
            losses.append(float(loss))
            reps = st.replicas.view(ep, dp, -1)
            assert bool((reps == reps[:, :1]).all())
        if dev == "cuda":
            torch.cuda.synchronize()
            assert _launches() == [before[0] + 2 * ep, before[1] + 2 * ep]
        runs[dev] = (losses, st.w_own.cpu(), gmax)
    w_err = sum(lr * dp * 2.0 ** -6 * gm for gm in runs["cpu"][2])
    np.testing.assert_allclose(runs["cuda"][0], runs["cpu"][0], rtol=1e-4)
    err = float((runs["cuda"][1] - runs["cpu"][1]).abs().max())
    assert err <= 1e-6 + w_err, (err, w_err)


def _hd128_llama(**kw):
    """A small Llama at head_dim 128 (dim 256, 2 heads over 1 KV head),
    the tensor-core flash kernels' width."""
    import dataclasses
    from fpga_ai_nic_tpu_torch.models import llama
    return dataclasses.replace(
        llama.LlamaConfig.tiny(dim=256, n_heads=2, n_kv_heads=1,
                               ffn_dim=512), attn_block=128, **kw)


def _seeded_batch(vocab, B, S, seed=0):
    toks = np.random.default_rng(seed).integers(
        0, vocab, (B, S + 1)).astype(np.int32)
    return torch.from_numpy(toks[:, :-1]), torch.from_numpy(toks[:, 1:])


@pytest.mark.cuda
def test_remat_matches_no_remat_on_card(cuda_device):
    """dp=2 x sp=2, bf16, head_dim 128 (the flash ring kernels, offsets
    included): the trainer's loss with remat bit-equal to the loss
    without, the flat gradients within the flash kernels' limit
    (``tol_ratio``: REL_TOL of each element plus FLOOR_TOL of the
    largest; the difference is printed), and remat launching one more
    forward a hop and no more backward kernels."""
    from fpga_ai_nic_tpu_torch.models import llama
    from fpga_ai_nic_tpu_torch.ops import flash_attention as fa
    from fpga_ai_nic_tpu_torch.parallel.mesh import make_ranks
    from fpga_ai_nic_tpu_torch.parallel.sharded import ShardedTrainer
    from fpga_ai_nic_tpu_torch.utils.config import (CollectiveConfig,
                                                    MeshConfig, TrainConfig)
    mcfg = _hd128_llama(dtype="bfloat16")
    cfg = TrainConfig(global_batch=4, mesh=MeshConfig(dp=2, sp=2),
                      collective=CollectiveConfig(impl="xla"),
                      optimizer=OptimizerConfig(kind="sgd",
                                                learning_rate=0.1))
    params = llama.init(torch.Generator(device=cuda_device).manual_seed(0),
                        mcfg, cuda_device)
    kernels = (fa.FLASH_FWD, fa.FLASH_FWD_OFFSETS, fa.FLASH_DQ,
               fa.FLASH_DQ_OFFSETS, fa.FLASH_DKV, fa.FLASH_DKV_OFFSETS)
    out = {}
    for remat in (False, True):
        tr = ShardedTrainer(lambda p, b, r=remat: llama.loss_fn(
            p, b, mcfg, sp_axis="sp", remat=r), make_ranks(
                cfg.mesh, cuda_device), cfg)
        st = tr.init_state(params)
        before = [k.launches for k in kernels]
        g, loss = tr.grads(st, tr.shard_batch(_seeded_batch(mcfg.vocab, 4,
                                                            512)))
        torch.cuda.synchronize()
        out[remat] = (g, loss, [k.launches - b
                                for k, b in zip(kernels, before)])
    (g0, l0, n0), (g1, l1, n1) = out[False], out[True]
    # per dp rank and layer: 2 diagonal hops and 1 past hop at sp=2
    assert n0 == [8, 4, 8, 4, 8, 4]
    assert n1 == [16, 8, 8, 4, 8, 4]
    assert torch.equal(l0, l1)
    ratio = fa.tol_ratio(g1, g0)
    print(f"remat gradients: max |diff| {float((g1 - g0).abs().max())}, "
          f"bit-equal {torch.equal(g0, g1)}, tol_ratio {ratio}")
    assert ratio <= 1.0


@pytest.mark.cuda
def test_moe_sp_ep_step_on_card_kernel_vs_plain(cuda_device):
    """dp=2 x sp=2 x ep=2, the small f32 MoE Llama at head_dim 128 (4
    experts, top-2, capacity factor 4: nothing drops): the flash kernel
    route's gradients against the plain attention route's, the expert
    choices pinned to the kernel route's (near ties may flip between the
    routes), within the f32 route limit of ``chip_smoke.auto_route``
    (relative L2 1e-4) and the loss within rtol 1e-5; then one step on
    the kernel route: one ring reduce-scatter and one all-gather an ep
    group, the replicas equal within each group."""
    import dataclasses
    from fpga_ai_nic_tpu_torch.models import llama
    from fpga_ai_nic_tpu_torch.ops import moe
    from fpga_ai_nic_tpu_torch.parallel.mesh import make_ranks
    from fpga_ai_nic_tpu_torch.parallel.sharded import ShardedTrainer
    from fpga_ai_nic_tpu_torch.utils.config import (CollectiveConfig,
                                                    MeshConfig, TrainConfig)
    dp, sp, ep = 2, 2, 2
    base = _hd128_llama(moe_experts=4, moe_capacity_factor=4.0)
    cfg = TrainConfig(global_batch=4, mesh=MeshConfig(dp=dp, sp=sp, ep=ep),
                      collective=CollectiveConfig(
                          impl="ring", compression=BFPConfig(codec="pallas"),
                          fused_kernel=True),
                      optimizer=OptimizerConfig(kind="sgd", learning_rate=0.1,
                                                clip_norm=1.0))
    params = llama.init(torch.Generator().manual_seed(0), base, "cpu")
    batch = _seeded_batch(base.vocab, 4, 512)
    route = moe._route
    record, runs = [], {}
    for impl in ("pallas", "xla"):
        mcfg = dataclasses.replace(base, attn_impl=impl)
        pin = iter(record) if impl == "xla" else None

        def pinned(wr, xf, c, C, pin=pin):
            r = route(wr, xf, c, C)
            if pin is None:
                record.append(r.e_flat)
                return r
            e_flat = next(pin)
            g = r.probs.gather(-1, e_flat.reshape(r.gates.shape))
            return moe.Routing(g / g.sum(-1, keepdim=True), e_flat,
                               *moe.assign(e_flat, c.num_experts, C),
                               r.probs)

        tr = ShardedTrainer(llama.dp_loss_fn(mcfg, dp, ep, n_sp=sp),
                            make_ranks(cfg.mesh, cuda_device), cfg,
                            param_specs=llama.param_specs(mcfg))
        st = tr.init_state(params)
        b = tr.shard_batch(batch)
        moe._route = pinned
        try:
            g, loss = tr.grads(st, b)
        finally:
            moe._route = route
        runs[impl] = (g, float(loss), tr, st, b)
    g_k, l_k, tr, st, b = runs["pallas"]
    g_p, l_p = runs["xla"][:2]
    rel = float((g_k - g_p).norm() / g_p.norm())
    print(f"sp x ep kernel vs plain: loss {l_k} / {l_p}, grad rel {rel}")
    np.testing.assert_allclose(l_k, l_p, rtol=1e-5)
    assert rel <= 1e-4
    before = _launches()
    st = tr.apply_grads(st, g_k)
    torch.cuda.synchronize()
    assert _launches() == [before[0] + ep, before[1] + ep]
    reps = st.replicas.view(ep, dp, -1)
    assert bool((reps == reps[:, :1]).all())


def _pp_masters(tr, w_own, v):
    """A dp x pp trainer's f32 masters as one flat vector in model order:
    the stage rows' leaves joined over the stages (the layers
    deinterleaved when v > 1)."""
    from fpga_ai_nic_tpu_torch.ops import fused_update
    from fpga_ai_nic_tpu_torch.parallel import pipeline
    from fpga_ai_nic_tpu_torch.parallel.sharded import join_ep
    tree = join_ep([tr._grad_tree(r) for r in w_own.view(tr.n_shards, -1)],
                   tr.param_specs)
    if v > 1:
        tree["layers"] = pipeline.deinterleave_layers(tree["layers"],
                                                      tr.ranks.pp, v)
    return torch.cat([t.reshape(-1)
                      for t in fused_update.tree_leaves(tree)]).clone()


@pytest.mark.cuda
def test_pp_trainer_schedules_on_card(cuda_device):
    """dp=2 x pp=2, the small bf16 Llama at head_dim 128 (4 layers,
    sequence 256, 2 microbatches, remat) as ``train_llama.build`` builds
    it: under each schedule the flash kernel route's two SGD steps
    against the plain attention route's, and 1F1B and interleaved 1F1B
    against GPipe on the kernels: losses within 2e-3, the masters'
    distance within 0.05 of the reference's two-step update (the Llama
    parity limits of ``chip_smoke.py``); the kernel route launching the
    tensor-core flash kernels and the plain route none."""
    from fpga_ai_nic_tpu_torch import train_llama
    from fpga_ai_nic_tpu_torch.ops import flash_attention as fa
    from fpga_ai_nic_tpu_torch.utils.config import (CollectiveConfig,
                                                    MeshConfig, TrainConfig)
    cfg = TrainConfig(global_batch=4, mesh=MeshConfig(dp=2, pp=2),
                      collective=CollectiveConfig(impl="xla"),
                      optimizer=OptimizerConfig(kind="sgd",
                                                learning_rate=0.1))

    def run(impl, schedule):
        v = 2 if schedule == "1f1b-interleaved" else 1
        mcfg = _hd128_llama(dtype="bfloat16", n_layers=4, attn_impl=impl)
        before = fa.FLASH_FWD.launches
        tr, st = train_llama.build(mcfg, cfg, "cuda", True,
                                   train_llama.Pipeline(2, schedule, v))
        w0 = _pp_masters(tr, st.w_own, v)
        batch = tr.shard_batch(_seeded_batch(mcfg.vocab, 4, 256))
        losses = []
        for _ in range(2):
            st, loss = tr.step(st, batch)
            losses.append(float(loss))
        torch.cuda.synchronize()
        return (losses, w0, _pp_masters(tr, st.w_own, v),
                fa.FLASH_FWD.launches - before)

    def rel(a, b):
        return float((a[2] - b[2]).norm() / (b[2] - b[1]).norm())

    ref = run("pallas", "gpipe")
    for schedule in ("gpipe", "1f1b", "1f1b-interleaved"):
        kern = ref if schedule == "gpipe" else run("pallas", schedule)
        plain = run("xla", schedule)
        assert kern[3] > 0 and plain[3] == 0
        assert torch.equal(kern[1], ref[1])          # the same weights
        for other in (plain, ref):
            print(f"{schedule}: rel {rel(kern, other)}, losses {kern[0]} "
                  f"against {other[0]}")
            assert rel(kern, other) <= 0.05
            assert max(abs(a - b) for a, b in zip(kern[0], other[0])) <= 2e-3


@pytest.mark.cuda
def test_pp_axes_moe_on_card(cuda_device):
    """The MoE pipeline with every batch axis in small: dp=1 x pp=2 x ep=2
    x sp=2, the small f32 MoE Llama at head_dim 128 (2 layers, one a
    stage; 4 experts top-2, capacity factor 4: nothing drops), sequence
    512, batch 4, 2 microbatches, remat, as ``train_llama.build`` builds
    it: GPipe's gradient on the flash kernels against the plain attention
    route's (the expert choices pinned to the kernel route's, call by
    call: near ties may flip between the routes), 1F1B's on the kernels
    (the gathered attention) against GPipe's (the ring attention), and at
    4 layers interleaved 1F1B (v=2) against GPipe, the gradients joined
    into the whole tree in model order, within the Llama parity limits
    of ``chip_smoke.py`` (relative L2 0.05, losses 2e-3); the kernel
    routes launching the f32 flash family's kernels
    (``flash_generic.cu``, the q offsets of the past hop and of the
    gathered shards among them), the plain route none; then one step:
    one ring all-gather a (pp, ep) group and, at dp=1, no reduce-scatter
    launch."""
    from fpga_ai_nic_tpu_torch import train_llama
    from fpga_ai_nic_tpu_torch.ops import flash_attention as fa
    from fpga_ai_nic_tpu_torch.ops import fused_update, moe
    from fpga_ai_nic_tpu_torch.parallel import pipeline
    from fpga_ai_nic_tpu_torch.parallel.sharded import join_ep
    from fpga_ai_nic_tpu_torch.utils.config import (CollectiveConfig,
                                                    MeshConfig, TrainConfig)
    cfg = TrainConfig(global_batch=4, mesh=MeshConfig(dp=1, pp=2, sp=2, ep=2),
                      collective=CollectiveConfig(
                          impl="ring", compression=BFPConfig(codec="pallas"),
                          fused_kernel=True),
                      optimizer=OptimizerConfig(kind="sgd", learning_rate=0.1,
                                                clip_norm=1.0))
    batch = _seeded_batch(256, 4, 512)
    route = moe._route
    record = []

    def whole(tr, g, v):
        tree = join_ep([tr._grad_tree(r) for r in g], tr.param_specs,
                       tr._grid())
        if v > 1:
            tree["layers"] = pipeline.deinterleave_layers(tree["layers"], 2,
                                                          v)
        return torch.cat([t.reshape(-1)
                          for t in fused_update.tree_leaves(tree)])

    def run(impl, schedule, n_layers=2, pin=None):
        mcfg = _hd128_llama(n_layers=n_layers, moe_experts=4,
                            moe_capacity_factor=4.0, attn_impl=impl)
        v = 2 if schedule == "1f1b-interleaved" else 1
        pins = None if pin is None else iter(pin)

        def pinned(wr, xf, c, C):
            r = route(wr, xf, c, C)
            if pins is None:
                record.append(r.e_flat)
                return r
            e_flat = next(pins)
            g = r.probs.gather(-1, e_flat.reshape(r.gates.shape))
            return moe.Routing(g / g.sum(-1, keepdim=True), e_flat,
                               *moe.assign(e_flat, c.num_experts, C),
                               r.probs)

        tr, st = train_llama.build(mcfg, cfg, "cuda", True,
                                   train_llama.Pipeline(2, schedule, v))
        before = fa.FLASH_FWD_GENERIC.launches
        moe._route = pinned if (pin is not None or impl == "pallas"
                                and schedule == "gpipe"
                                and n_layers == 2) else route
        try:
            g, loss = tr.grads(st, tr.shard_batch(batch))
        finally:
            moe._route = route
        torch.cuda.synchronize()
        return (whole(tr, g, v), float(loss), tr, st,
                fa.FLASH_FWD_GENERIC.launches - before)

    ref = run("pallas", "gpipe")
    assert record and ref[4] > 0
    ref4 = run("pallas", "gpipe", 4)
    for name, other, want in (
            ("plain", run("xla", "gpipe", 2, list(record)), ref),
            ("1f1b", run("pallas", "1f1b"), ref),
            ("interleaved", run("pallas", "1f1b-interleaved", 4), ref4)):
        rel = float((other[0] - want[0]).norm() / want[0].norm())
        print(f"pp x ep x sp {name}: loss {other[1]} / {want[1]}, grad rel "
              f"{rel}")
        assert abs(other[1] - want[1]) <= 2e-3
        assert rel <= 0.05
        assert (other[4] == 0) == (name == "plain")
    _, _, tr, st = ref[:4]
    before = _launches()
    st, _ = tr.step(st, tr.shard_batch(batch))
    torch.cuda.synchronize()
    assert _launches() == [before[0], before[1] + 4]


# -- ZeRO-3, the hierarchical ring, the ring kernel's ablate= stages ----------

@pytest.mark.cuda
@pytest.mark.parametrize("streaming,opt", [(False, None), (True, None),
                                           (True, "sgd"), (False, "adamw")])
def test_ring_rs_ablate_stages_launch_on_card(cuda_device, streaming, opt):
    """Every ablate= stage of ``ring_cost.stages_for`` launches one ablated
    instantiation (counted by stage) and gives finite-shaped output;
    ablate=None is the kernel itself, bit-equal to its plain version; the
    validation is JAX's."""
    from fpga_ai_nic_tpu_torch.ops import ring_cost
    n, C = 4, 4 * TILE
    x = torch.from_numpy(_shards(n, C, 5)).to(cuda_device)
    cfg = BFPConfig(codec="pallas")
    if opt:
        def run(ab):
            return ring_cuda.loopback_update_microbench(
                x, n, opt_kind=opt, compression=cfg, slice_elems=TILE,
                streaming=streaming, ablate=ab)
        spec = OptimizerSpec(kind=opt)
        z = torch.zeros((n, C), device=cuda_device)
        want = ring_cuda.ring_reduce_scatter_update_plain(
            x, z, {k: z for k in spec.state_keys},
            optim.fused_hyperparams(OptimizerConfig(kind=opt,
                                                    learning_rate=1e-3),
                                    0, device=cuda_device),
            opt_kind=opt, compression=cfg)[1]
    else:
        def run(ab):
            return ring_cuda.loopback_microbench(
                x, n, compression=cfg, slice_elems=TILE, streaming=streaming,
                ablate=ab)
        want = ring_cuda.ring_reduce_scatter_update_plain(
            x, None, {}, None, opt_kind=None, compression=cfg)[0]
    assert torch.equal(run(None), want)
    for stage in ring_cost.stages_for(streaming, opt is not None):
        before = ring_cuda.ABLATE_LAUNCHES.get((streaming, stage), 0)
        out = run(stage)
        torch.cuda.synchronize()
        assert out.shape == (n, C)
        assert ring_cuda.ABLATE_LAUNCHES[(streaming, stage)] == before + 1
    if not streaming:
        with pytest.raises(ValueError, match="resident"):
            run("hbm")
    with pytest.raises(ValueError, match="fused optimizer"):
        ring_cuda.loopback_microbench(x, n, compression=cfg,
                                      slice_elems=TILE, ablate="update")


def _mlp_trainer(cls, coll, mesh, dev):
    from fpga_ai_nic_tpu_torch.models import mlp
    from fpga_ai_nic_tpu_torch.parallel.mesh import make_ranks
    from fpga_ai_nic_tpu_torch.utils.config import MLPConfig, TrainConfig
    m = MLPConfig(layer_sizes=(256,) * 4)
    cfg = TrainConfig(global_batch=64, mesh=mesh, collective=coll,
                      optimizer=OptimizerConfig(kind="sgd",
                                                learning_rate=0.1))
    tr = cls(lambda p, b: mlp.loss_fn(p, b, m), make_ranks(mesh, dev), cfg)
    st = tr.init_state(mlp.init(torch.Generator().manual_seed(1), m, dev))
    g = torch.Generator().manual_seed(2)
    batch = tr.shard_batch((torch.randn((64, 256), generator=g),
                            torch.randint(0, 256, (64,), generator=g)))
    return tr, st, batch


@pytest.mark.cuda
def test_fsdp_step_on_card_matches_cpu(cuda_device):
    """FSDPTrainer on the ring kernels (the gather's forward ``ring_ag``,
    its backward the RS kernel): one launch of each a step; two steps'
    masters against the same trainer on the CPU (the plain versions)
    within three BFP grid steps of an update, the losses within 1e-4."""
    from fpga_ai_nic_tpu_torch.parallel.fsdp import FSDPTrainer
    from fpga_ai_nic_tpu_torch.utils.config import (CollectiveConfig,
                                                    MeshConfig)
    coll = CollectiveConfig(impl="ring", compression=BFPConfig(
        codec="pallas"), fused_kernel=True, fused_optimizer=True)
    mesh = MeshConfig(fsdp=4)
    out = {}
    for d in ("cpu", "cuda"):
        tr, st, batch = _mlp_trainer(FSDPTrainer, coll, mesh,
                                     torch.device(d))
        w0 = st.w_own.cpu()
        before = _launches()
        for _ in range(2):
            st, loss = tr.step(st, batch)
        launched = [a - b for a, b in zip(_launches(), before)]
        out[d] = (st.w_own.cpu(), float(loss), launched)
    assert out["cuda"][2] == [2, 2] and out["cpu"][2] == [0, 0]
    np.testing.assert_allclose(out["cuda"][1], out["cpu"][1], rtol=1e-4)
    # a GEMM's other summation order may move a gradient across a BFP
    # rounding boundary: one grid step (2^-6 of a block max) of an update
    upd = float((out["cpu"][0] - w0).abs().max())
    assert float((out["cuda"][0] - out["cpu"][0]).abs().max()) <= \
        3 * 2.0 ** -6 * upd


@pytest.mark.cuda
@pytest.mark.parametrize("ni", [2, 4])
def test_hier_step_on_card_runs_the_codec_kernels(cuda_device, ni):
    """DPTrainer with topology="hier" and the sublane BFP codec: phase B
    runs the ``bfp_codec.cu`` kernels on every slow hop (their launches
    counted), and the masters equal the same step through the plain codec
    on the card."""
    from fpga_ai_nic_tpu_torch.parallel.train import DPTrainer
    from fpga_ai_nic_tpu_torch.utils.config import (CollectiveConfig,
                                                    MeshConfig)
    coll = CollectiveConfig(impl="ring", compression=BFPConfig(
        codec="pallas"), topology="hier", intra_size=ni,
        fused_optimizer=True)
    tr, st, batch = _mlp_trainer(DPTrainer, coll, MeshConfig(dp=8),
                                 cuda_device)
    flat_g, _ = tr.grads(st, batch)
    before = (bfp_cuda.ENCODE.launches, bfp_cuda.DECODE.launches)
    new = tr.apply_grads(st, flat_g)
    ng = 8 // ni
    assert (bfp_cuda.ENCODE.launches - before[0],
            bfp_cuda.DECODE.launches - before[1]) == (ng, 2 * ng - 1)
    saved = bfp_cuda.bfp_encode, bfp_cuda.bfp_decode
    bfp_cuda.bfp_encode = bfp_cuda.bfp_encode_plain
    bfp_cuda.bfp_decode = bfp_cuda.bfp_decode_plain
    try:
        plain = tr.apply_grads(st, flat_g)
    finally:
        bfp_cuda.bfp_encode, bfp_cuda.bfp_decode = saved
    assert torch.equal(new.w_own, plain.w_own)
    assert torch.equal(new.replicas, plain.replicas)


def _tp_trainer(mcfg, dp, tp, dev):
    from fpga_ai_nic_tpu_torch.models import llama
    from fpga_ai_nic_tpu_torch.parallel.mesh import make_ranks
    from fpga_ai_nic_tpu_torch.parallel.sharded import ShardedTrainer
    from fpga_ai_nic_tpu_torch.utils.config import MeshConfig, TrainConfig
    from fpga_ai_nic_tpu_torch.utils.config import CollectiveConfig
    cfg = TrainConfig(global_batch=4, mesh=MeshConfig(dp=dp, tp=tp),
                      collective=CollectiveConfig(
                          impl="ring", compression=BFPConfig(codec="pallas"),
                          fused_kernel=True),
                      optimizer=OptimizerConfig(kind="sgd",
                                                learning_rate=0.1))
    tp_axis = "tp" if tp > 1 else None
    return ShardedTrainer(
        lambda p, b: llama.loss_fn(p, b, mcfg, tp_axis=tp_axis),
        make_ranks(cfg.mesh, dev), cfg,
        param_specs=llama.param_specs(mcfg, tp_axis, tp_size=tp))


@pytest.mark.cuda
@pytest.mark.parametrize("tp", [2, 4])
def test_tp_llama_step_on_card_kernel_vs_plain(cuda_device, tp):
    """dp=2 x tp, bf16, head_dim 128 (4 heads over 2 kv heads: tp = 4
    replicates them): one flash launch of each kernel a layer and dp rank
    (every tp rank's heads in one call); the kernel route's loss and
    gradients against the plain attention route's (relative L2 within
    the Llama parity limit 0.05, loss within 2e-3); then one step: one
    ring reduce-scatter and one all-gather a tp group, the replicas equal
    within each group.  (At these widths a BFP block mixes a replicated
    leaf with split ones, so the tp groups' copies of it round apart;
    ``chip_smoke.py``'s full-width path holds them equal.)"""
    import dataclasses
    from fpga_ai_nic_tpu_torch.models import llama
    from fpga_ai_nic_tpu_torch.ops import flash_attention as fa
    base = dataclasses.replace(
        llama.LlamaConfig.tiny(dim=512, n_heads=4, n_kv_heads=2,
                               ffn_dim=512, dtype="bfloat16"),
        attn_block=128)
    params = llama.init(torch.Generator(device=cuda_device).manual_seed(0),
                        base, cuda_device)
    batch = _seeded_batch(base.vocab, 4, 512)
    kernels = (fa.FLASH_FWD, fa.FLASH_DQ, fa.FLASH_DKV)
    runs = {}
    for impl in ("pallas", "xla"):
        tr = _tp_trainer(dataclasses.replace(base, attn_impl=impl), 2, tp,
                         cuda_device)
        st = tr.init_state(params)
        b = tr.shard_batch(batch)
        before = [k.launches for k in kernels]
        g, loss = tr.grads(st, b)
        torch.cuda.synchronize()
        runs[impl] = (g, float(loss), [k.launches - n for k, n in
                                       zip(kernels, before)], tr, st)
    g_k, l_k, n_k, tr, st = runs["pallas"]
    g_p, l_p, n_p = runs["xla"][:3]
    assert n_k == [2 * base.n_layers] * 3 and n_p == [0, 0, 0]
    rel = float((g_k - g_p).norm() / g_p.norm())
    print(f"tp={tp} kernel vs plain: loss {l_k} / {l_p}, grad rel {rel}")
    assert abs(l_k - l_p) <= 2e-3 and rel <= 0.05
    before = _launches()
    st = tr.apply_grads(st, g_k)
    torch.cuda.synchronize()
    assert _launches() == [before[0] + tp, before[1] + tp]
    reps = st.replicas.view(tp, 2, -1)
    assert bool((reps == reps[:, :1]).all())


@pytest.mark.cuda
@pytest.mark.parametrize("tp", [2, 4])
def test_tp_forward_paged_on_card(cuda_device, tp):
    """The tp decode step on the card: every tp rank's kv heads in one
    paged_attend launch a layer, the logits within 1e-3 of the tp = 1
    kernel step's on the same pool (f32 model, bf16 pool; the tp sums in
    another order) and the kernel within the plain route's."""
    from fpga_ai_nic_tpu_torch.models import llama, llama_decode
    from fpga_ai_nic_tpu_torch.serve import ServeConfig, init_pool
    cfg = llama.LlamaConfig.tiny(dim=512, n_heads=4, n_kv_heads=2,
                                 ffn_dim=512)
    params = llama.init(torch.Generator(device=cuda_device).manual_seed(1),
                        cfg, cuda_device)
    shards = llama.shard_params(params, llama.param_specs(cfg, "tp", None, tp),
                                {"tp": tp})
    scfg = ServeConfig(max_reqs=4, page_size=16, max_pages_per_seq=4,
                       n_pages=17, prefill_chunk=16)
    rng = np.random.default_rng(2)
    table = torch.from_numpy(rng.permutation(np.arange(1, 17)).reshape(
        4, 4).astype(np.int32)).to(cuda_device)
    pos = torch.tensor([3, 20, 40, 63], dtype=torch.int32,
                       device=cuda_device)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 1)).astype(
        np.int32)).to(cuda_device)
    kv = llama_decode.kv_local_heads(cfg, tp) * tp
    g = torch.Generator(device=cuda_device).manual_seed(3)
    pool = [{k: torch.randn((17, kv, 16, 128), generator=g,
                            device=cuda_device).to(torch.bfloat16)
             for k in ("k", "v")} for _ in range(cfg.n_layers)]
    assert init_pool(cfg, scfg, dtype="bfloat16", device=cuda_device,
                     tp_size=tp)[0]["k"].shape == pool[0]["k"].shape
    # tp = 1 reads each rank's kv head block once: replicated heads (tp >
    # n_kv) hold equal copies, so give it the first of each group
    step = tp // cfg.n_kv_heads if tp > cfg.n_kv_heads else 1
    pool1 = [{k: v[:, ::step].contiguous() for k, v in lyr.items()}
             for lyr in pool]
    if step > 1:
        for lyr in pool:
            for k, v in lyr.items():
                v.copy_(v[:, ::step].repeat_interleave(step, dim=1))
    before = paged_attend.PAGED_ATTEND.launches
    got, _ = llama_decode.forward_paged(
        shards, toks, [{k: v.clone() for k, v in lyr.items()}
                       for lyr in pool], table, pos, cfg, page_size=16,
        tp_axis="tp")
    torch.cuda.synchronize()
    assert paged_attend.PAGED_ATTEND.launches - before == cfg.n_layers
    ref, _ = llama_decode.forward_paged(params, toks, pool1, table, pos, cfg,
                                        page_size=16)
    plain, _ = llama_decode.forward_paged(
        shards, toks, [{k: v.clone() for k, v in lyr.items()}
                       for lyr in pool], table, pos, cfg, page_size=16,
        tp_axis="tp", attend_impl="reference")
    err = float((got - ref).abs().max())
    print(f"tp={tp} paged decode: max |tp - tp1| {err}, max |kernel - "
          f"plain| {float((got - plain).abs().max())}")
    assert err <= 1e-3 and float((got - plain).abs().max()) <= 1e-3


@pytest.mark.cuda
def test_auto_codecs_dispatch_on_card_tensors(cuda_device):
    """BFPConfig(codec="auto") and Int8Codec(backend="auto") on card
    tensors: pinned on a payload of whole tiles it launches the sublane
    kernels and equals "pallas" bit for bit; pinned on one that does not
    it launches none and equals "xla"; unpinned it raises."""
    from fpga_ai_nic_tpu_torch import compress
    from fpga_ai_nic_tpu_torch.compress.bfp import BFPCodec
    g = torch.Generator(device=cuda_device).manual_seed(0)
    for n, tiles in ((2048 * 6, True), (2048 * 6 + 16, False)):
        x = torch.randn(n, generator=g, device=cuda_device)
        for auto, pallas, xla, enc in (
                (BFPCodec(BFPConfig(codec="auto")),
                 BFPCodec(BFPConfig(codec="pallas")),
                 BFPCodec(BFPConfig(codec="xla")), bfp_cuda.ENCODE),
                (compress.Int8Codec(backend="auto"),
                 compress.Int8Codec(backend="pallas"),
                 compress.Int8Codec(backend="xla"), int8_cuda.ENCODE)):
            with pytest.raises(ValueError, match="pin it"):
                auto.roundtrip(x)
            before = enc.launches
            got = auto.for_payload(n, x.device).roundtrip(x)
            torch.cuda.synchronize()
            assert (enc.launches - before == 1) == tiles
            want = (pallas if tiles else xla).roundtrip(x)
            assert torch.equal(got, want)


@pytest.mark.cuda
def test_queue_side_stream_orders_and_keeps_buffers(cuda_device):
    """An issue runs on the queue's side stream after the work queued
    before it; the wait orders the current stream after it; the inputs
    freed while the side stream still reads them are not reused early
    (record_stream): the result equals the synchronous collective."""
    from fpga_ai_nic_tpu_torch.runtime.queue import CollectiveQueue
    from fpga_ai_nic_tpu_torch.utils.config import CollectiveConfig
    streams = []

    def fn(x):
        streams.append(torch.cuda.current_stream(cuda_device))
        y = x
        for _ in range(20):              # long enough to overlap
            y = y * 1.0001 + 1.0
        return y

    q = CollectiveQueue(fn, CollectiveConfig(max_inflight=2))
    base = torch.randn(1 << 22, device=cuda_device)
    want = fn(base.clone())
    tickets = []
    for _ in range(4):
        x = base.clone() * 2 - base       # made on the current stream
        tickets.append(q.issue(x))
        del x                             # freed while the side reads it
        torch.empty(1 << 22, device=cuda_device).fill_(7.0)
    assert q.max_outstanding == 2
    outs = [q.wait(t) for t in tickets]
    assert all(s != torch.cuda.current_stream(cuda_device)
               for s in streams[1:])
    for o in outs:
        torch.testing.assert_close(o, want, rtol=0, atol=0)
    assert q.profiler.collectives.completed == 4


@pytest.mark.cuda
def test_handoff_bitexact_on_card(cuda_device):
    """A KV migration between two bf16 pools on the card: the moved pages
    land bit for bit, the destination's other pages and the source keep
    theirs, and the landed checksums (one ``row_checksums`` launch over
    the gathered blocks) equal the source ledger's and the CPU move's."""
    from fpga_ai_nic_tpu_torch.serve import handoff
    g = torch.Generator(device=cuda_device).manual_seed(5)
    shape = (33, 8, 16, 128)

    def pool():
        return [{k: torch.randn(shape, generator=g, device=cuda_device).to(
            torch.bfloat16) for k in ("k", "v")} for _ in range(3)]

    src, dst = pool(), pool()
    src_h = [{k: v.cpu() for k, v in lyr.items()} for lyr in src]
    dst_h = [{k: v.cpu() for k, v in lyr.items()} for lyr in dst]
    src_pages, dst_pages = [3, 17, 9, 32], [1, 30, 2, 11]
    plan = handoff.make_plan(n_layers=3, kv_local=8, page_size=16,
                             head_dim=128, n_pages=33, n_move=4,
                             dtype="bfloat16")
    ledger = integrity.page_checksums_plain(src_h).numpy().astype(np.uint32)
    before = integrity.ROW_CHECKSUMS.launches
    _, _, ok, landed = handoff.apply_handoff(
        plan, src, dst, src_pages, dst_pages, expect=ledger[src_pages])
    torch.cuda.synchronize()
    assert ok and integrity.ROW_CHECKSUMS.launches == before + 1
    np.testing.assert_array_equal(landed, ledger[src_pages])
    _, want_dst = handoff.apply_handoff(
        plan, [dict(lyr) for lyr in src_h],
        [{k: v.clone() for k, v in lyr.items()} for lyr in dst_h],
        src_pages, dst_pages)
    keep = [p for p in range(33) if p not in dst_pages]
    for li in range(3):
        for k in ("k", "v"):
            got = dst[li][k].cpu()
            assert torch.equal(got.view(torch.int16),
                               want_dst[li][k].view(torch.int16))
            assert torch.equal(got[dst_pages].view(torch.int16),
                               src_h[li][k][src_pages].view(torch.int16))
            assert torch.equal(got[keep].view(torch.int16),
                               dst_h[li][k][keep].view(torch.int16))
            assert torch.equal(src[li][k].cpu().view(torch.int16),
                               src_h[li][k].view(torch.int16))


@pytest.mark.cuda
def test_prefill_replica_never_launches_decode_on_card(cuda_device):
    """A 1-prefill, 1-decode fleet on the card (f32 model at head_dim 128,
    bf16 pools, both replicas slots of the card): the prefill replica's
    decode step is never called, the decode replica's prefill step never,
    one paged_attend launch a layer a step, and the streams equal the
    single engine's."""
    from fpga_ai_nic_tpu_torch.models import llama
    from fpga_ai_nic_tpu_torch.serve import (FleetConfig, ServeConfig,
                                             ServeEngine, ServeFleet)
    cfg = llama.LlamaConfig.tiny(dim=512, n_heads=4, n_kv_heads=2,
                                 ffn_dim=512)
    params = llama.init(torch.Generator(device=cuda_device).manual_seed(1),
                        cfg, cuda_device)
    scfg = ServeConfig(max_reqs=4, page_size=16, max_pages_per_seq=8,
                       n_pages=65, prefill_chunk=32)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab, int(n)).astype(np.int32)
               for n in rng.integers(20, 90, 5)]
    fleet = ServeFleet(params, cfg, scfg, FleetConfig(1, 1),
                       dtype="bfloat16", devices=[cuda_device] * 2)
    pre = fleet.replicas[0].engine

    def never(*args, **kwargs):
        raise AssertionError("a prefill replica ran a decode step")

    pre._decode_step = never
    reqs = [fleet.submit(p, max_new=6) for p in prompts]
    before = paged_attend.PAGED_ATTEND.launches
    s = fleet.run()
    torch.cuda.synchronize()
    calls = sum(r["prefill_calls"] + r["decode_calls"]
                for r in s["replicas"])
    assert paged_attend.PAGED_ATTEND.launches - before == \
        cfg.n_layers * calls
    roles = {r["role"]: r for r in s["replicas"]}
    assert roles["prefill"]["decode_calls"] == 0
    assert roles["decode"]["prefill_calls"] == 0
    assert s["handoffs"] == len(prompts) and s["fleet_replays"] == 0
    eng = ServeEngine(params, cfg, scfg, dtype="bfloat16",
                      device=cuda_device)
    single = [eng.submit(p, max_new=6) for p in prompts]
    eng.run()
    assert [r.generated for r in reqs] == [r.generated for r in single]


# -- A.8's restore tier on the card: elastic cells, durability, tick faults --


def _elastic_trainer(dev, fused):
    from fpga_ai_nic_tpu_torch.parallel.train import DPTrainer
    from fpga_ai_nic_tpu_torch.utils.config import (CollectiveConfig,
                                                    MeshConfig)
    coll = CollectiveConfig(impl="ring", compression=BFPConfig(codec="pallas"),
                            fused_kernel=fused, fused_optimizer=True,
                            integrity_check=True)
    return _mlp_trainer(DPTrainer, coll, MeshConfig(dp=8), dev)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,site,mode", [
    ("exception", "queue.issue", "nan"), ("preemption", "queue.issue", "nan"),
    ("hang", "queue.wait", "nan"), ("slowdown", "staging", "nan"),
    ("corruption", "staging", "nan"), ("corruption", "queue.wait", "nan"),
    ("corruption", "collective", "scale")])
def test_elastic_cells_on_card(cuda_device, tmp_path, kind, site, mode):
    """JAX's seven cells on the card at a small MLP, dp=8: the fused BFP
    ring kernels (the collective cell on the codec route, whose rings are
    tapped), a clean step before the plan is armed; the final masters
    bit-equal to the fault-free steps, every watchdog thread joined."""
    from fpga_ai_nic_tpu_torch.ops import bfp_cuda
    from fpga_ai_nic_tpu_torch.parallel.elastic import (ElasticConfig,
                                                        ElasticTrainer)
    from fpga_ai_nic_tpu_torch.runtime import chaos
    fused = site != "collective"
    tr, st0, batch = _elastic_trainer(cuda_device, fused)
    ref = st0
    for _ in range(4):
        ref, _ = tr.step(ref, batch)
    kernels = ((ring_cuda.RING_RS, ring_cuda.RING_AG) if fused else
               (bfp_cuda.ENCODE, bfp_cuda.DECODE))
    before = [k.launches for k in kernels]
    plan = chaos.FaultPlan([chaos.FaultSpec(
        kind, site, step=3, mode=mode,
        duration_s=3.0 if kind == "hang" else 0.2)], seed=11)
    cfg = ElasticConfig(step_timeout_s=2.0, max_retries=3, backoff_s=0.01,
                        ckpt_every=2, ckpt_keep_last=2)
    chaos.install_collective_tap()
    try:
        with chaos.activate(plan):
            et = ElasticTrainer(tr, str(tmp_path), cfg, plan=plan,
                                stage_fn=plan.stage)
            st, _ = et.run(st0, lambda i: batch, 4)
    finally:
        chaos.uninstall_collective_tap()
    assert et.join(30.0) == 0
    torch.cuda.synchronize()
    rec = et.profiler.recovery.as_dict()
    assert len(plan.fired) == 1 and st.step == 4
    assert torch.equal(st.w_own, ref.w_own)
    assert rec["faults_total"] == (0 if kind == "slowdown" else 1), rec
    assert all(k.launches > b for k, b in zip(kernels, before))


@pytest.mark.cuda
def test_durability_on_card(cuda_device, tmp_path):
    """A card state saved with shards and mirrors: a flipped primary bit
    repaired bit-exact, both copies flipped refused, a kill at ckpt.save
    leaving the previous step; the restored state's step bit-equal to the
    uninterrupted one, and a restore at dp=4 stepping finitely."""
    from fpga_ai_nic_tpu_torch.parallel.mesh import make_ranks
    from fpga_ai_nic_tpu_torch.parallel.train import DPTrainer
    from fpga_ai_nic_tpu_torch.runtime import chaos
    from fpga_ai_nic_tpu_torch.utils import checkpoint as ckpt
    from fpga_ai_nic_tpu_torch.utils.config import MeshConfig
    tr, st, batch = _elastic_trainer(cuda_device, True)
    st, _ = tr.step(st, batch)
    nxt, _ = tr.step(st, batch)
    plan = chaos.FaultPlan([chaos.FaultSpec("kill", "ckpt.save", step=2,
                                            fraction=0.5)])
    c = ckpt.Checkpointer(str(tmp_path), shards=8, mirror=True, chaos=plan)
    c.save(1, st)
    want = st.w_own.reshape(-1).cpu().numpy()
    entry = next(e for e in c.read_manifest(1)["leaves"]
                 if e["path"] == ["w_own"])
    shard = [c._path(1) + "/" + entry["shards"][j][k]
             for j, k in ((3, "file"), (5, "file"), (5, "mirror"))]
    ckpt.flip_stored_bit(shard[0], byte_off=64)
    rep = c.audit_step(1, repair=True)
    assert len(rep.repaired) == 1 and rep.repair_wire_bytes == want.nbytes // 8
    np.testing.assert_array_equal(c.restore(1)["w_own"], want)
    plan.begin_step(2)
    with pytest.raises(chaos.InjectedFault):
        c.save(2, nxt)
    assert c.latest_step(verified=True) == 1
    back = tr.restore_state(c.restore(1))
    got, _ = tr.step(back, batch)
    assert torch.equal(got.w_own, nxt.w_own)
    for f in shard[1:]:
        ckpt.flip_stored_bit(f)
    with pytest.raises(ckpt.CheckpointIntegrityError, match="also bad"):
        c.restore(1)
    tr4, _, _ = _mlp_trainer(DPTrainer, tr.cfg.collective, MeshConfig(dp=4),
                             cuda_device)
    st4 = tr4.restore_state({"w_own": want, "opt_state": {},
                             "step": np.int32(1)})
    _, diag = tr4.step(st4, tr4.shard_batch(tuple(
        b.reshape(-1, *b.shape[2:]).cpu() for b in batch)))
    assert np.isfinite(float(diag["loss"]))


@pytest.mark.cuda
def test_serve_tick_faults_on_card(cuda_device):
    """An f32 model at head_dim 128 with bf16 pools and the page ledger:
    a hang past step_timeout_s, an exception, a preemption and a wirebit
    of the pool, each recovered; the ledger trips on the wirebit; the
    streams equal the fault-free engine's; the timed-out tick's thread
    joined."""
    from fpga_ai_nic_tpu_torch.models import llama
    from fpga_ai_nic_tpu_torch.runtime import chaos
    from fpga_ai_nic_tpu_torch.serve import ServeConfig, ServeEngine
    cfg = llama.LlamaConfig.tiny(dim=512, n_heads=4, n_kv_heads=2,
                                 ffn_dim=512)
    params = llama.init(torch.Generator(device=cuda_device).manual_seed(1),
                        cfg, cuda_device)
    shape = dict(max_reqs=4, page_size=16, max_pages_per_seq=8, n_pages=65,
                 prefill_chunk=32, page_integrity=True, backoff_s=0.0)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab, int(n)).astype(np.int32)
               for n in rng.integers(20, 90, 5)]
    eng = ServeEngine(params, cfg, ServeConfig(**shape), dtype="bfloat16",
                      device=cuda_device)
    want = [eng.submit(p, max_new=6) for p in prompts]
    eng.run()
    plan = chaos.FaultPlan([
        chaos.FaultSpec("hang", "serve.step", step=1, duration_s=2.0),
        chaos.FaultSpec("exception", "serve.step", step=3),
        chaos.FaultSpec("preemption", "serve.step", step=5),
        chaos.FaultSpec("corruption", "serve.step", step=7, mode="wirebit")],
        seed=9)
    eng = ServeEngine(params, cfg, ServeConfig(step_timeout_s=1.0, **shape),
                      dtype="bfloat16", device=cuda_device, chaos=plan)
    got = [eng.submit(p, max_new=6) for p in prompts]
    before = paged_attend.PAGED_ATTEND.launches
    s = eng.run()
    assert eng.join_watchdog(30.0) == 0
    assert paged_attend.PAGED_ATTEND.launches > before
    assert len(plan.fired) == 4 and s["page_trips"] == 1
    assert s["serve_recoveries"] == 4
    assert [r.generated for r in got] == [r.generated for r in want]


# ---------------------------------------------------------------------------
# the live reshard tier and the step metrics (A.8, A.9) on the card
# ---------------------------------------------------------------------------

def _fused_coll(integrity=False):
    from fpga_ai_nic_tpu_torch.utils.config import CollectiveConfig
    return CollectiveConfig(impl="ring", compression=BFPConfig(codec="pallas"),
                            fused_kernel=True, fused_optimizer=True,
                            integrity_check=integrity)


@pytest.mark.cuda
def test_reshard_parity_on_card(cuda_device):
    """Two steps at dp=8 on the ring kernels, a move to dp=4 against the
    same state built at dp=4 by the restore path: masters and replicas
    bit-equal, the wire counter equal to the plan, the next step's masters
    and loss bit-equal; the checked transfer one ``row_checksums`` launch
    a side."""
    from fpga_ai_nic_tpu_torch.ops import fused_update
    from fpga_ai_nic_tpu_torch.parallel import reshard as rs
    from fpga_ai_nic_tpu_torch.parallel.train import DPTrainer
    from fpga_ai_nic_tpu_torch.utils.config import MeshConfig
    tr8, st, b8 = _mlp_trainer(DPTrainer, _fused_coll(), MeshConfig(dp=8),
                               cuda_device)
    for _ in range(2):
        st, _ = tr8.step(st, b8)
    tr4, _, b4 = _mlp_trainer(DPTrainer, _fused_coll(), MeshConfig(dp=4),
                              cuda_device)
    native = tr4.restore_state(
        {"w_own": st.w_own.reshape(-1).clone(), "opt_state": {},
         "step": st.step},
        params_like=fused_update.params_like_from_meta(tr8._meta))
    plan = rs.plan_for(tr8, tr4)
    rs.reset_wire_counters()
    before = integrity.ROW_CHECKSUMS.launches
    moved = rs.reshard_state(tr8, tr4, st, integrity=True)
    assert integrity.ROW_CHECKSUMS.launches - before == 2
    assert rs.WIRE["bytes"] == plan.wire_bytes()
    assert torch.equal(moved.w_own, native.w_own)
    assert torch.equal(moved.replicas, native.replicas)
    s_m, l_m = tr4.step(moved, b4)
    s_n, l_n = tr4.step(native, b4)
    assert torch.equal(s_m.w_own, s_n.w_own) and float(l_m) == float(l_n)


@pytest.mark.cuda
def test_reshard_wirebit_trips_on_card(cuda_device):
    """One flipped word on a segment's wire: the checked transfer raises
    before the state is handed over."""
    from fpga_ai_nic_tpu_torch.parallel import reshard as rs
    from fpga_ai_nic_tpu_torch.parallel.train import DPTrainer
    from fpga_ai_nic_tpu_torch.runtime import chaos
    from fpga_ai_nic_tpu_torch.utils.config import MeshConfig
    tr8, st, b8 = _mlp_trainer(DPTrainer, _fused_coll(), MeshConfig(dp=8),
                               cuda_device)
    st, _ = tr8.step(st, b8)
    tr4 = _mlp_trainer(DPTrainer, _fused_coll(), MeshConfig(dp=4),
                       cuda_device)[0]
    plan = chaos.FaultPlan([chaos.FaultSpec(
        "corruption", "reshard.transfer", step=0, mode="wirebit",
        fraction=1e-9)], seed=5)
    chaos.install_wire_tap()
    try:
        with chaos.activate(plan):
            plan.begin_step(0)
            with pytest.raises(chaos.WireIntegrityError):
                rs.reshard_state(tr8, tr4, st, integrity=True)
    finally:
        chaos.uninstall_wire_tap()
    assert len(plan.fired) == 1


@pytest.mark.cuda
def test_obs_metrics_launches_on_card(cuda_device):
    """``obs_metrics`` off launches what the step launches (one
    ``ring_rs_update`` and one ``ring_ag``, no codec kernel); on, one BFP
    roundtrip more (``codec_obs_rel_err``), the masters bit-equal and the
    observed error within the declared bound."""
    import dataclasses
    from fpga_ai_nic_tpu_torch.obs import metrics as obs_metrics
    from fpga_ai_nic_tpu_torch.parallel.train import DPTrainer
    from fpga_ai_nic_tpu_torch.utils.config import MeshConfig
    out = {}
    for obs in (False, True):
        tr, st, batch = _mlp_trainer(DPTrainer, _fused_coll(),
                                     MeshConfig(dp=8), cuda_device)
        tr.cfg = dataclasses.replace(tr.cfg, obs_metrics=obs)
        sink = obs_metrics.MetricsSink(static=tr.obs_static_metrics())
        ks = (ring_cuda.RING_RS, ring_cuda.RING_AG, bfp_cuda.ENCODE,
              bfp_cuda.DECODE)
        before = [k.launches for k in ks]
        with obs_metrics.use_sink(sink):
            st, loss = tr.step(st, batch)
            float(loss)
        out[obs] = ([k.launches - b for k, b in zip(ks, before)], st, sink)
    assert out[False][0] == [1, 1, 0, 0]
    assert out[True][0] == [1, 1, 1, 1]
    assert torch.equal(out[True][1].w_own, out[False][1].w_own)
    sink = out[True][2]
    assert out[False][2].n_updates == 0
    assert 0 < sink.latest["codec_obs_rel_err"] <= \
        sink.static["declared_error_bound"]


# -- the public helpers that run the ring kernels -----------------------------

def _plain_fused(monkeypatch):
    """The fused ring wrappers as their plain versions on the same card
    tensors (the plain route)."""
    def rs(x, *, compression=None, slice_elems=None, integrity=False):
        res = ring_cuda.ring_reduce_scatter_update_plain(
            x, None, {}, None, opt_kind=None, compression=compression,
            slice_elems=slice_elems, integrity=integrity)
        return (res[0], res[3]) if integrity else res[0]

    monkeypatch.setattr(ring_cuda, "ring_reduce_scatter_fused", rs)
    monkeypatch.setattr(ring_cuda, "ring_all_gather_fused",
                        lambda owned, *, compression=None:
                        ring_cuda.ring_all_gather_plain(owned, compression))


def _helper_tree(dev, dtype=torch.float32):
    g = torch.Generator(device=dev).manual_seed(5)
    return {"a": torch.randn((8, 64, 130), generator=g, device=dev)
            .to(dtype),
            "b": [torch.randn((8, 3000), generator=g, device=dev).to(dtype),
                  torch.randn((8, 7), generator=g, device=dev).to(dtype)]}


@pytest.mark.cuda
def test_all_reduce_mean_on_card(cuda_device, monkeypatch):
    from fpga_ai_nic_tpu_torch.ops import fused_update
    from fpga_ai_nic_tpu_torch.utils.config import CollectiveConfig
    coll = CollectiveConfig(impl="ring", compression=BFPConfig(codec="pallas"),
                            fused_kernel=True, fused_optimizer=True)
    tree = _helper_tree(cuda_device)
    before = _launches()
    got = fused_update.all_reduce_mean(tree, coll)
    assert [a - b for a, b in zip(_launches(), before)] == [1, 1]
    _plain_fused(monkeypatch)
    want = fused_update.all_reduce_mean(tree, coll)
    for a, b in zip(fused_update.tree_leaves(got),
                    fused_update.tree_leaves(want)):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_all_reduce_bucketed_on_card(cuda_device, monkeypatch, dtype):
    from fpga_ai_nic_tpu_torch.ops import bucketed, fused_update
    from fpga_ai_nic_tpu_torch.utils.config import CollectiveConfig
    coll = CollectiveConfig(impl="ring", compression=BFPConfig(codec="pallas"),
                            fused_kernel=True, fused_optimizer=True,
                            bucket_elems=4096)
    tree = _helper_tree(cuda_device, dtype)
    plan = bucketed.plan_buckets(fused_update.per_rank_tree(tree), coll, 8)
    before = _launches()
    got = bucketed.all_reduce_bucketed(tree, coll, plan)
    nb = len(plan.buckets)
    assert [a - b for a, b in zip(_launches(), before)] == [nb, nb]
    _plain_fused(monkeypatch)
    want = bucketed.all_reduce_bucketed(tree, coll, plan)
    for a, b in zip(fused_update.tree_leaves(got),
                    fused_update.tree_leaves(want)):
        assert a.dtype == dtype and torch.equal(a, b)


@pytest.mark.cuda
def test_bfp_ste_on_card(cuda_device):
    from fpga_ai_nic_tpu_torch.ops import bfp
    g = torch.Generator(device=cuda_device).manual_seed(6)
    x = _mixed(torch.randn(1 << 16, generator=g, device=cuda_device), 6)
    x.requires_grad_(True)
    y = bfp.bfp_ste(x)
    g_in = torch.randn(1 << 16, generator=g, device=cuda_device)
    y.backward(g_in)
    assert torch.equal(y.detach(), bfp.bfp_roundtrip(x.detach().cpu(),
                                                     BFPConfig()).cuda())
    assert torch.equal(x.grad, g_in)
