"""The port's watchdog (``runtime/watchdog.py``) against the JAX package's:
JAX's nine cases run against both packages (``mod``), the donated-state
case as each package has it (JAX: a donated jit argument; the port: a
tensor whose storage was released, ``chaos.state_buffers_alive``), and
the port's ``join`` and its worker taking the caller's grad mode."""

import threading
import time

import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

from fpga_ai_nic_tpu.runtime import watchdog as jax_watchdog
from fpga_ai_nic_tpu_torch.runtime import chaos
from fpga_ai_nic_tpu_torch.runtime import watchdog

MODS = {"jax": jax_watchdog, "port": watchdog}


@pytest.fixture(params=sorted(MODS))
def mod(request):
    return MODS[request.param]


def test_watchdog_passes_results_through(mod):
    wd = mod.Watchdog(timeout_s=5.0)
    assert wd.run(lambda a, b: a + b, 2, 3) == 5


def test_watchdog_detects_hang_and_recovers_worker(mod):
    wd = mod.Watchdog(timeout_s=0.1)
    with pytest.raises(mod.DeviceHangError):
        wd.run(time.sleep, 0.5)
    # the wedged (daemon) worker does not block later healthy calls
    assert wd.run(lambda: "ok") == "ok"


def test_watchdog_propagates_exceptions(mod):
    wd = mod.Watchdog(timeout_s=5.0)
    with pytest.raises(ValueError, match="boom"):
        wd.run(lambda: (_ for _ in ()).throw(ValueError("boom")))


def test_heartbeat_staleness(mod):
    hb = mod.Heartbeat(stall_after_s=0.05)
    hb.beat()
    assert not hb.stalled()
    time.sleep(0.1)
    assert hb.stalled()
    with pytest.raises(mod.DeviceHangError):
        hb.assert_alive()
    hb.beat()
    hb.assert_alive()
    assert hb.beats == 2


def test_run_with_recovery_retries_transient_failure(mod):
    calls = {"n": 0}

    def flaky_step(state, batch):
        calls["n"] += 1
        if calls["n"] < 3:
            raise RuntimeError("transient")
        return state + batch, float(batch)

    failures = []
    out, loss = mod.run_with_recovery(flaky_step, 10, 5, max_retries=3,
                                      backoff_s=0.01,
                                      on_failure=failures.append)
    assert (out, loss) == (15, 5.0)
    assert calls["n"] == 3 and len(failures) == 2


def test_run_with_recovery_restores_state(mod):
    seen = []

    def step(state, batch):
        seen.append(state)
        if len(seen) < 2:
            raise RuntimeError("bad state")
        return state, 0.0

    out, _ = mod.run_with_recovery(step, "live", None, max_retries=2,
                                   backoff_s=0.01, restore_fn=lambda: "ckpt")
    assert seen == ["live", "ckpt"] and out == "ckpt"


def test_run_with_recovery_exhausts_and_raises(mod):
    def always_fail(state, batch):
        raise RuntimeError("permanent")

    with pytest.raises(RuntimeError, match="permanent"):
        mod.run_with_recovery(always_fail, None, None, max_retries=1,
                              backoff_s=0.01)


def _dead_state(mod):
    """A state whose buffers a failed step consumed, and the refusal's
    message: JAX's donated jit argument, the port's released storage."""
    if mod is jax_watchdog:
        import jax
        import jax.numpy as jnp
        step = jax.jit(lambda s, b: (s + b, jnp.sum(b)), donate_argnums=(0,))
        state = jnp.ones((4,))
        step(state, jnp.ones((4,)))          # donates `state`
        return state, "donated the state buffers"
    state = {"w": torch.ones(4), "m": torch.zeros(4)}
    state["w"].untyped_storage().resize_(0)
    assert not chaos.state_buffers_alive(state)
    return state, "released the state's buffers"


def test_recovery_refuses_donated_state_without_restore_fn(mod):
    state, msg = _dead_state(mod)
    calls = {"n": 0}

    def failing_step(s, b):
        calls["n"] += 1
        raise RuntimeError("transient")

    with pytest.raises(RuntimeError, match=msg):
        mod.run_with_recovery(failing_step, state, None, max_retries=2,
                              backoff_s=0.01)
    assert calls["n"] == 1               # no blind retry on dead buffers


def test_recovery_composes_with_watchdog(mod):
    calls = {"n": 0}

    def sometimes_hangs(state, batch):
        calls["n"] += 1
        if calls["n"] == 1:
            time.sleep(0.5)
        return state, 1.0

    out, loss = mod.run_with_recovery(sometimes_hangs, 7, None,
                                      max_retries=1, backoff_s=0.01,
                                      watchdog=mod.Watchdog(timeout_s=0.1))
    assert (out, loss) == (7, 1.0) and calls["n"] == 2


def test_join_waits_for_timed_out_workers():
    wd = watchdog.Watchdog(timeout_s=0.05)
    release = threading.Event()
    with pytest.raises(watchdog.DeviceHangError):
        wd.run(release.wait, 5.0)
    assert wd.join(0.05) == 1            # still wedged: the bound holds
    release.set()
    assert wd.join(5.0) == 0


def test_worker_takes_the_callers_grad_mode():
    wd = watchdog.Watchdog(timeout_s=5.0)
    assert wd.run(torch.is_grad_enabled) is True
    with torch.no_grad():
        assert wd.run(torch.is_grad_enabled) is False
