"""The port's paged gather-attend (plain version, on the CPU) and page
checksums against the JAX package.

``paged_gather_attend`` on CPU tensors takes its plain version; it is held
against JAX's Pallas kernel run in interpret mode and against JAX's
gathered-view oracle (``_cached_attend`` over the gathered pages) at
atol = rtol = 1e-5 (float32 sums taken in other orders by the two
frameworks), over GQA and MHA, ragged positions, T = 1 and T > 1, and
tables whose dead pages hold 1e6-sized garbage.  ``page_checksums`` must
equal ``ops/integrity.page_checksums`` bit for bit.  The kernel itself is
held against the plain version on the card (``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

import jax.numpy as jnp

from fpga_ai_nic_tpu.models import llama_decode as jax_dec
from fpga_ai_nic_tpu.ops import integrity as jax_integrity
from fpga_ai_nic_tpu.ops import paged_attend_pallas as jax_pa
from fpga_ai_nic_tpu_torch.ops import integrity, paged_attend

TOL = dict(atol=1e-5, rtol=1e-5)
CASES = {
    # name: R, H, n_kv, T, hd, page_size, P, n_pages, positions
    "gqa_decode": (2, 4, 2, 1, 8, 4, 3, 8, [5, 0]),
    "mha_decode": (2, 4, 4, 1, 8, 4, 3, 8, [11, 3]),
    "single_kv_head": (3, 4, 1, 1, 8, 4, 4, 16, [0, 7, 15]),
    "gqa_prefill": (2, 4, 2, 4, 8, 4, 3, 8, [4, 0]),
    "ragged_dead_pages": (4, 4, 2, 1, 8, 4, 4, 20, [0, 4, 9, 15]),
    "prefill_past_table": (1, 4, 2, 6, 16, 4, 3, 8, [8]),
}


def _inputs(seed, R, H, n_kv, T, hd, ps, P, n_pages, positions):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((R, H, T, hd)).astype(np.float32)
    pk = (rng.standard_normal((n_pages, n_kv, ps, hd)) * 1e6).astype(
        np.float32)
    pv = (rng.standard_normal((n_pages, n_kv, ps, hd)) * 1e6).astype(
        np.float32)
    # live K/V at O(1); everything else (dead pages) stays 1e6 garbage
    pk[1:] /= 1e6
    pv[1:] /= 1e6
    table = rng.permutation(np.arange(1, n_pages))[:R * P].reshape(R, P)
    pos = np.asarray(positions, np.int32)
    for r in range(R):
        n_live = min((pos[r] + T - 1) // ps + 1, P)
        dead = table[r, n_live:]
        pk[dead] = rng.standard_normal(pk[dead].shape) * 1e6
        pv[dead] = rng.standard_normal(pv[dead].shape) * 1e6
    return q, pk, pv, table.astype(np.int32), pos


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_jax_kernel_and_oracle(case):
    R, H, n_kv, T, hd, ps, P, n_pages, positions = CASES[case]
    q, pk, pv, table, pos = _inputs(7, R, H, n_kv, T, hd, ps, P, n_pages,
                                    positions)
    got = paged_attend.paged_gather_attend(
        torch.from_numpy(q), torch.from_numpy(pk), torch.from_numpy(pv),
        torch.from_numpy(table), torch.from_numpy(pos), page_size=ps)
    assert got.dtype == torch.float32 and tuple(got.shape) == q.shape
    assert bool(torch.isfinite(got).all())
    want_kernel = jax_pa.paged_gather_attend(
        jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv), jnp.asarray(table),
        jnp.asarray(pos), page_size=ps, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_kernel), **TOL)
    jt = jnp.asarray(table)
    ck = jnp.asarray(pk)[jt].transpose(0, 2, 1, 3, 4).reshape(
        R, n_kv, P * ps, hd)
    cv = jnp.asarray(pv)[jt].transpose(0, 2, 1, 3, 4).reshape(
        R, n_kv, P * ps, hd)
    want = jax_dec._cached_attend(jnp.asarray(q), ck, cv, jnp.asarray(pos),
                                  H, n_kv, hd ** -0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_bf16_pool_and_sm_scale():
    R, H, n_kv, T, hd, ps, P, n_pages, positions = CASES["gqa_prefill"]
    q, pk, pv, table, pos = _inputs(8, R, H, n_kv, T, hd, ps, P, n_pages,
                                    positions)
    tk = torch.from_numpy(pk).to(torch.bfloat16)
    tv = torch.from_numpy(pv).to(torch.bfloat16)
    got = paged_attend.paged_gather_attend(
        torch.from_numpy(q), tk, tv, torch.from_numpy(table),
        torch.from_numpy(pos), page_size=ps, sm_scale=0.3)
    want = jax_pa.paged_gather_attend(
        jnp.asarray(q), jnp.asarray(tk.float().numpy(), jnp.bfloat16),
        jnp.asarray(tv.float().numpy(), jnp.bfloat16), jnp.asarray(table),
        jnp.asarray(pos), page_size=ps, sm_scale=0.3, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("bad, match", [
    (dict(q=np.zeros((2, 4, 8), np.float32)), "q must be"),
    (dict(pv=np.zeros((8, 2, 4, 4), np.float32)), "share one"),
    (dict(page_size=8), "do not match"),
    (dict(q=np.zeros((2, 3, 1, 8), np.float32)), "multiple of"),
    (dict(table=np.zeros((3, 3), np.int32)), "page_table must be"),
    (dict(table=np.zeros((2, 3), np.int64)), "int32"),
    (dict(pos=np.zeros((3,), np.int32)), "pos must be"),
])
def test_validation_errors(bad, match):
    args = dict(q=np.zeros((2, 4, 1, 8), np.float32),
                pk=np.zeros((8, 2, 4, 8), np.float32),
                pv=np.zeros((8, 2, 4, 8), np.float32),
                table=np.zeros((2, 3), np.int32),
                pos=np.zeros((2,), np.int32), page_size=4)
    args.update(bad)
    with pytest.raises(ValueError, match=match):
        paged_attend.paged_gather_attend(
            torch.from_numpy(args["q"]), torch.from_numpy(args["pk"]),
            torch.from_numpy(args["pv"]), torch.from_numpy(args["table"]),
            torch.from_numpy(args["pos"]), page_size=args["page_size"])


def test_wrapper_counts_no_launch_on_cpu():
    R, H, n_kv, T, hd, ps, P, n_pages, positions = CASES["gqa_decode"]
    q, pk, pv, table, pos = _inputs(9, R, H, n_kv, T, hd, ps, P, n_pages,
                                    positions)
    before = paged_attend.PAGED_ATTEND.launches
    paged_attend.paged_gather_attend(
        torch.from_numpy(q), torch.from_numpy(pk), torch.from_numpy(pv),
        torch.from_numpy(table), torch.from_numpy(pos), page_size=ps)
    assert paged_attend.PAGED_ATTEND.launches == before


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_page_checksums_bitequal_to_jax(dtype):
    rng = np.random.default_rng(10)
    shape = (9, 2, 4, 16)
    pool_np = [{k: (rng.standard_normal(shape) * 3).astype(np.float32)
                for k in ("k", "v")} for _ in range(3)]
    pool_np[1]["k"][4] = 0
    pool_np[2]["v"][2, 0, 0, 0] = -0.0
    pool = [{k: torch.from_numpy(v).to(getattr(torch, dtype))
             for k, v in lyr.items()} for lyr in pool_np]
    jpool = [{k: jnp.asarray(v, jnp.dtype(dtype)) for k, v in lyr.items()}
             for lyr in pool_np]
    got = integrity.page_checksums(pool)
    want = np.asarray(jax_integrity.page_checksums(jpool))
    assert want.dtype == np.uint32 and got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    for lyr, jlyr in zip(pool, jpool):
        assert int(integrity.word_checksum(lyr["k"])) == int(
            jax_integrity.word_checksum(jlyr["k"]))
    zero = [{k: torch.zeros(shape) for k in ("k", "v")}]
    assert not bool(integrity.page_checksums(zero).any())


def test_words_u32_widths_and_rejects_8_byte():
    x = torch.tensor([-1, 0, 7], dtype=torch.int8)
    assert integrity.words_u32(x).tolist() == [255, 0, 7]
    h = torch.tensor([-2.0], dtype=torch.bfloat16)
    assert integrity.words_u32(h).tolist() == [0xC000]
    f = torch.tensor([-0.0])
    assert integrity.words_u32(f).tolist() == [0x80000000]
    with pytest.raises(TypeError):
        integrity.words_u32(torch.zeros(2, dtype=torch.float64))


# -- the CUDA kernel's two regimes, emulated on the CPU -------------------------
#
# The card check (chip_smoke.py) holds the kernel within PAGED_TOL of the
# plain version.  These emulations repeat each regime's algorithm and
# rounding points in torch: the prefill kernel's 64-key tiles gathered
# through the table (keys past the cell's last visible key never gathered,
# so dead pages are never read), q and p as bf16 terms into f32 products,
# an online softmax in f32; the decode kernel's chunks of whole pages, each
# a partial (m, l, o), combined in chunk order.

PAGED_TOL = 5e-5          # chip_smoke.py's limit for the kernel
KEY_TILE = 64


def _terms(x, n):
    """n bf16 terms of x (hi, lo, ...), as f32 values."""
    out, r = [], x
    for _ in range(n):
        h = r.to(torch.bfloat16).float()
        out.append(h)
        r = r - h
    return out


def _gather(pool, table_r, j, ok, n_pages, ps):
    """[kv, len(j), hd] f32 K or V rows of keys j through one slot's
    table; keys where ``ok`` is False are zero and touch no page."""
    page = table_r[torch.where(ok, j // ps, 0)].long().clamp(0, n_pages - 1)
    rows = pool[page, :, j % ps].float().transpose(0, 1)
    return torch.where(ok[None, :, None], rows, torch.zeros(()))


def _emulated_prefill(q, pk, pv, table, pos, ps, q_terms):
    R, H, T, hd = q.shape
    n_pages, n_kv = pk.shape[:2]
    P = table.shape[1]
    G, scale = H // n_kv, hd ** -0.5
    out = torch.empty((R, H, T, hd))
    t_row = torch.arange(G * T) % T
    for r in range(R):
        pos_r = max(int(pos[r]), 0)
        live_end = min((pos_r + T - 1) // ps + 1, P) * ps
        key_end = min(pos_r + T, live_end)
        lim = torch.clamp(pos_r + t_row, max=live_end - 1)
        qg = q[r].float().reshape(n_kv, G * T, hd)
        m = torch.full((n_kv, G * T, 1), -1e30)
        l = torch.zeros_like(m)
        acc = torch.zeros((n_kv, G * T, hd))
        for k0 in range(0, key_end, KEY_TILE):
            j = k0 + torch.arange(KEY_TILE)
            ok = j < key_end
            kt = _gather(pk, table[r], j, ok, n_pages, ps)
            vt = _gather(pv, table[r], j, ok, n_pages, ps)
            s = sum(torch.einsum("krd,kjd->krj", t, kt)
                    for t in _terms(qg, q_terms)) * scale
            s = s.masked_fill(j[None, None, :] > lim[None, :, None],
                              float("-inf"))
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new)
            l = l * alpha + p.sum(-1, keepdim=True)
            acc = acc * alpha + sum(torch.einsum("krj,kjd->krd", t, vt)
                                    for t in _terms(p, 2))
            m = m_new
        out[r] = (acc / l).reshape(H, T, hd)
    return out


def _emulated_decode(q, pk, pv, table, pos, ps):
    R, H, T, hd = q.shape
    n_pages, n_kv = pk.shape[:2]
    P = table.shape[1]
    G, scale = H // n_kv, hd ** -0.5
    cp = paged_attend.decode_split(T, G, ps, P)
    assert cp > 0
    out = torch.empty((R, H, T, hd))
    for r in range(R):
        pos_r = max(int(pos[r]), 0)
        n_live = min(pos_r // ps + 1, P)
        key_end = min(pos_r + 1, n_live * ps)
        qg = q[r].float().reshape(n_kv, G, hd)
        parts = []
        for c in range(-(-n_live // cp)):
            j = torch.arange(c * cp * ps, min((c + 1) * cp * ps, key_end))
            ok = torch.ones_like(j, dtype=torch.bool)
            kt = _gather(pk, table[r], j, ok, n_pages, ps)
            vt = _gather(pv, table[r], j, ok, n_pages, ps)
            s = torch.einsum("kgd,kjd->kgj", qg, kt) * scale
            mc = s.amax(-1, keepdim=True)
            p = torch.exp(s - mc)
            parts.append((mc, p.sum(-1, keepdim=True),
                          torch.einsum("kgj,kjd->kgd", p, vt)))
        mx = torch.stack([mc for mc, _, _ in parts]).amax(0)
        num = den = 0
        for mc, lc, oc in parts:           # chunk order
            f = torch.exp(mc - mx)
            num = num + oc * f
            den = den + lc * f
        out[r] = (num / den).reshape(H, T, hd)
    return out


def _emulated(q, pk, pv, table, pos, ps, q_terms=2):
    """The regime the wrapper picks for these shapes."""
    R, H, T, hd = q.shape
    if paged_attend.decode_split(T, H // pk.shape[1], ps, table.shape[1]):
        return _emulated_decode(q, pk, pv, table, pos, ps)
    return _emulated_prefill(q, pk, pv, table, pos, ps, q_terms)


def _serving_inputs(seed, R, H, n_kv, T, hd, ps, P):
    """chip_smoke.py's paged inputs in numpy: f32 q (rounded to bf16, the
    serving path's dtype, where a test says so), a bf16 pool with O(1)
    live pages and 1e3 garbage elsewhere, a shuffled table, ragged
    positions; returned with the dead pages' ids."""
    rng = np.random.default_rng(seed)
    n_pages = R * P + 1
    pk = rng.standard_normal((n_pages, n_kv, ps, hd)) * 1e3
    pv = rng.standard_normal((n_pages, n_kv, ps, hd)) * 1e3
    table = (rng.permutation(n_pages - 1)[:R * P] + 1).reshape(R, P)
    pos = rng.integers(0, P * ps - T + 1, R)
    live = np.zeros(n_pages, bool)
    for r in range(R):
        live[table[r, :min((pos[r] + T - 1) // ps + 1, P)]] = True
    pk[live] *= 1e-3
    pv[live] *= 1e-3
    q = rng.standard_normal((R, H, T, hd))
    return (torch.from_numpy(q.astype(np.float32)),
            torch.from_numpy(pk.astype(np.float32)).to(torch.bfloat16),
            torch.from_numpy(pv.astype(np.float32)).to(torch.bfloat16),
            torch.from_numpy(table.astype(np.int32)),
            torch.from_numpy(pos.astype(np.int32)), np.flatnonzero(~live))


EMU_SHAPES = {
    # name: R, H, n_kv, T, hd, page_size, P (chip_smoke.py's, scaled down)
    "decode_gqa_ps16": (4, 8, 2, 1, 128, 16, 48),
    "decode_mha_ps16": (4, 8, 8, 1, 128, 16, 48),
    "decode_gqa_ps128": (4, 8, 2, 1, 128, 128, 6),
    "prefill_gqa_ps16": (1, 8, 2, 256, 128, 16, 40),
    "prefill_mha_ps128": (1, 4, 4, 256, 128, 128, 5),
    "prefill_gqa_t33": (2, 8, 2, 33, 128, 16, 8),
}


@pytest.mark.parametrize("case", sorted(EMU_SHAPES))
def test_kernel_emulation_within_card_limit(case):
    """Each regime's emulation within PAGED_TOL of the plain version; at
    prefill with q as two bf16 terms (f32 q) and as one (bf16 q)."""
    q, pk, pv, table, pos, _ = _serving_inputs(11, *EMU_SHAPES[case])
    ps = EMU_SHAPES[case][5]
    want = paged_attend.paged_gather_attend_plain(q, pk, pv, table, pos,
                                                  page_size=ps)
    got = _emulated(q, pk, pv, table, pos, ps)
    assert float((got - want).abs().max()) <= PAGED_TOL
    qb = q.to(torch.bfloat16)
    want_b = paged_attend.paged_gather_attend_plain(qb, pk, pv, table, pos,
                                                    page_size=ps)
    got_b = _emulated(qb, pk, pv, table, pos, ps, q_terms=1)
    assert float((got_b - want_b).abs().max()) <= PAGED_TOL


@pytest.mark.parametrize("case", ["decode_gqa_ps16", "prefill_gqa_ps16",
                                  "prefill_gqa_t33"])
def test_kernel_emulation_reads_no_dead_page(case):
    """Dead pages filled with NaN change no bit of either regime's result:
    no byte of them is read (a NaN times a zero weight would show)."""
    q, pk, pv, table, pos, dead = _serving_inputs(12, *EMU_SHAPES[case])
    ps = EMU_SHAPES[case][5]
    clean = _emulated(q, pk, pv, table, pos, ps)
    pk, pv = pk.clone(), pv.clone()
    pk[dead] = float("nan")
    pv[dead] = float("nan")
    assert torch.equal(_emulated(q, pk, pv, table, pos, ps), clean)


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_emulation_matches_jax_kernel(case):
    """The emulated regime against JAX's Pallas kernel in interpret mode,
    within PAGED_TOL, at the small cases above (page tables past their
    span, a single KV head, ragged positions)."""
    R, H, n_kv, T, hd, ps, P, n_pages, positions = CASES[case]
    q, pk, pv, table, pos = _inputs(13, R, H, n_kv, T, hd, ps, P, n_pages,
                                    positions)
    tk = torch.from_numpy(pk).to(torch.bfloat16)
    tv = torch.from_numpy(pv).to(torch.bfloat16)
    got = _emulated(torch.from_numpy(q), tk, tv, torch.from_numpy(table),
                    torch.from_numpy(pos), ps)
    want = jax_pa.paged_gather_attend(
        jnp.asarray(q), jnp.asarray(tk.float().numpy(), jnp.bfloat16),
        jnp.asarray(tv.float().numpy(), jnp.bfloat16), jnp.asarray(table),
        jnp.asarray(pos), page_size=ps, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=PAGED_TOL)
