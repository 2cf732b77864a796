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
