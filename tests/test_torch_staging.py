"""The port's data epochs and native staging (``data.epochs_of``,
``runtime/staging.py``, ``runtime/native.py``) against the JAX package's.

* ``epochs_of`` yields JAX's batches, bit for bit, for the same arrays,
  seed and batch size (numpy ``permutation`` a epoch, ``drop_remainder``
  either way), on dicts and tuples.
* The native path equals the numpy path; it is built from the port's own
  ``csrc/staging.cpp`` into the package's ``_build/``, never from the
  JAX package's library, and raises (no numpy fallback) when it cannot be
  built.
* ``tests/test_staging.py``'s cases on the port's ``Stager``.
"""

import numpy as np
import pytest
from torch_threads import one_torch_thread  # noqa: F401

from fpga_ai_nic_tpu import data as jax_data
from fpga_ai_nic_tpu_torch import data
from fpga_ai_nic_tpu_torch.runtime import native, staging


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.mark.parametrize("drop", [True, False])
def test_epochs_of_matches_jax(rng, drop):
    arrays = {"x": rng.standard_normal((50, 3)).astype(np.float32),
              "y": rng.integers(0, 9, 50).astype(np.int32)}
    want = list(jax_data.epochs_of(arrays, 16, seed=5, epochs=3,
                                   drop_remainder=drop))
    got = list(data.epochs_of(arrays, 16, seed=5, epochs=3,
                              drop_remainder=drop))
    assert len(got) == len(want) == (9 if drop else 12)
    for w, g in zip(want, got):
        for k in arrays:
            np.testing.assert_array_equal(g[k], np.asarray(w[k]))


def test_epochs_of_tuple_and_forever(rng):
    x = rng.standard_normal((20, 2)).astype(np.float32)
    y = np.arange(20, dtype=np.int32)
    it = data.epochs_of((x, y), 8, seed=1)          # epochs=None: forever
    got = [next(it) for _ in range(7)]
    jit = jax_data.epochs_of((x, y), 8, seed=1)
    for g in got:
        w = next(jit)
        assert isinstance(g, tuple)
        np.testing.assert_array_equal(g[0], np.asarray(w[0]))
        np.testing.assert_array_equal(g[1], np.asarray(w[1]))
    with pytest.raises(ValueError, match="ragged"):
        next(data.epochs_of((x, y[:10]), 4))


def test_epochs_native_matches_numpy_path(rng):
    arrays = {"x": rng.standard_normal((64, 5)).astype(np.float32),
              "y": rng.integers(0, 9, 64).astype(np.int32)}
    a = list(data.epochs_of(arrays, 16, seed=3, epochs=2))
    b = list(data.epochs_of(arrays, 16, seed=3, epochs=2, native=True))
    assert len(a) == len(b) == 8
    for want, got in zip(a, b):
        np.testing.assert_array_equal(got["x"], want["x"])
        np.testing.assert_array_equal(got["y"], want["y"])
    with pytest.raises(ValueError, match="drop_remainder"):
        next(data.epochs_of(arrays, 16, native=True, drop_remainder=False))


def test_native_library_is_the_ports_own_build():
    lib = staging.lib()
    path = native.lib_path("staging.cpp")
    assert path.exists() and path.parent == native.BUILD_DIR
    assert native.CSRC.parent.name == "fpga_ai_nic_tpu_torch"
    assert lib is native._LIBS["staging.cpp"]
    assert "fpga_ai_nic_tpu/" not in str(path).replace(
        "fpga_ai_nic_tpu_torch", "")


def test_native_raises_when_it_cannot_build(monkeypatch, rng):
    """No fallback: epochs_of(native=True) raises where the library cannot
    be built (the JAX package falls back to numpy)."""
    def fail(source):
        raise RuntimeError(f"building {source} failed")

    monkeypatch.setattr(staging, "_lib", None)
    monkeypatch.setattr(staging, "load_native", fail)
    with pytest.raises(RuntimeError, match="building staging.cpp"):
        staging.lib()
    with pytest.raises(RuntimeError, match="building staging.cpp"):
        next(data.epochs_of({"x": np.zeros((8, 2), np.float32)}, 4,
                            native=True))


def test_gather_matches_numpy_take(rng):
    src = rng.standard_normal((500, 33)).astype(np.float32)
    st = staging.Stager(2, 64 * 33 * 4)
    try:
        for _ in range(5):
            idx = rng.integers(0, 500, 64)
            slot = st.submit(src, idx)
            np.testing.assert_array_equal(st.wait(slot), src[idx])
            st.release(slot)
    finally:
        st.close()


def test_gather_int_and_3d(rng):
    src = rng.integers(0, 1000, (200, 4, 7)).astype(np.int32)
    st = staging.Stager(2, 50 * 4 * 7 * 4)
    try:
        idx = rng.integers(0, 200, 50)
        slot = st.submit(src, idx)
        np.testing.assert_array_equal(st.wait(slot), src[idx])
        st.release(slot)
    finally:
        st.close()


def test_submit_rejects_oversized_batch(rng):
    src = rng.standard_normal((10, 8)).astype(np.float32)
    st = staging.Stager(1, 4 * 8 * 4)      # room for 4 rows
    try:
        with pytest.raises(ValueError, match="exceeds slot"):
            st.submit(src, np.arange(8))
    finally:
        st.close()


def test_submit_bounds_and_window(rng):
    src = rng.standard_normal((20, 8)).astype(np.float32)
    st = staging.Stager(1, 8 * 8 * 4)
    try:
        with pytest.raises(IndexError):
            st.submit(src, np.array([0, 20]))
        with pytest.raises(IndexError):
            st.submit(src, np.array([-1]))
        s = st.submit(src, np.arange(8))
        with pytest.raises(RuntimeError, match="no FREE slot fits"):
            st.submit(src, np.arange(8))
        st.wait(s)
        st.release(s)
    finally:
        st.close()


def test_epochs_native_batches_are_owned(rng):
    arrays = {"x": rng.standard_normal((32, 4)).astype(np.float32)}
    want = list(data.epochs_of(arrays, 8, seed=7, epochs=1))
    got = list(data.epochs_of(arrays, 8, seed=7, epochs=1, native=True))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g["x"], w["x"])


def test_sized_pool_guard_counts_fitting_slots(rng):
    src = rng.standard_normal((20, 8)).astype(np.float32)  # 32 B rows
    st = staging.Stager.sized([4 * 32, 10 * 32])
    try:
        s_big = st.submit(src, np.arange(8))
        with pytest.raises(RuntimeError, match="no FREE slot fits"):
            st.submit(src, np.arange(8))
        sm = st.submit(src, np.arange(4))
        np.testing.assert_array_equal(st.wait(sm), src[:4])
        np.testing.assert_array_equal(st.wait(s_big), src[:8])
        st.release(sm)
        st.release(s_big)
    finally:
        st.close()


def test_release_before_wait_is_safe(rng):
    src = rng.standard_normal((100, 16)).astype(np.float32)
    st = staging.Stager(1, 32 * 16 * 4)
    try:
        s = st.submit(src, np.arange(32))
        st.release(s)
        with pytest.raises(KeyError):
            st.release(s)
        s2 = st.submit(src, np.arange(10))
        np.testing.assert_array_equal(st.wait(s2), src[:10])
        st.release(s2)
    finally:
        st.close()


def test_stager_refuses_fault_plans():
    """A fault plan no longer refused: the staging site fires at submit
    (tests/test_torch_chaos_sites.py holds its corruption)."""
    from fpga_ai_nic_tpu_torch.runtime import chaos
    plan = chaos.FaultPlan([chaos.FaultSpec("preemption", "staging",
                                            step=0)])
    plan.begin_step(0)
    st = staging.Stager(1, 64, chaos=plan)
    try:
        with pytest.raises(chaos.InjectedPreemption):
            st.submit(np.zeros((4, 2), np.float32), np.arange(2))
    finally:
        st.close()
