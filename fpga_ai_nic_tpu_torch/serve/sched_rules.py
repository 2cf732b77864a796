"""Every discrete policy decision of the serving control plane, as pure
functions of plain ints and strings — this port's own copy of the JAX
package's ``verify/opstream.py`` ``SchedEmitter`` and ``SCHED_RULES``
(that module needs no JAX, but the port imports nothing of the JAX
package; ``tests/test_torch_serve.py`` holds the two equal over an
exhaustive grid of small inputs).

The batcher (``serve.scheduler.ContinuousBatcher``) delegates admission,
eviction and ordering to these rules.  Selection rules take parallel value
sequences and return an INDEX into the caller's candidate list (or None
when it is empty).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

# request lifecycle vocabulary, the strings runtime.requests carries
SCHED_WAITING = "waiting"
SCHED_PREFILL = "prefill"
SCHED_DECODE = "decode"
SCHED_FINISHED = "finished"


class SchedEmitter:
    """One definition of each scheduling rule (see module docstring)."""

    # -- batcher: commitment-aware watermark admission ----------------------

    @staticmethod
    def replay_target(n_tokens: int) -> int:
        """Positions a (re)admission must prefill before decode resumes:
        prompt + generated minus the newest token, whose K/V the resuming
        decode step writes itself (== ``Request.n_tokens``)."""
        return n_tokens

    @staticmethod
    def admission_need(replay_len: int) -> int:
        """Positions the free-page watermark must cover to admit: the
        replay plus one decode step, so admission never thrashes."""
        return replay_len + 1

    @staticmethod
    def committed_target(state: str, replay_len: int,
                         n_tokens: int) -> int:
        """Positions a live request will claim without a new admission
        decision: its replay + first decode while prefilling, its next
        position while decoding."""
        return (replay_len + 1 if state == SCHED_PREFILL
                else n_tokens + 1)

    @staticmethod
    def committed_outstanding(entries: Sequence[Tuple[int, int]]) -> int:
        """Pages promised but not yet allocated (allocation is lazy), over
        (target_pages, held_pages) pairs of every live request."""
        return sum(max(0, target - held) for target, held in entries)

    @staticmethod
    def admit_ok(free: int, committed: int, need: int) -> bool:
        """The watermark: admit only while the uncommitted free pages
        cover the candidate's own need."""
        return free - committed >= need

    @staticmethod
    def pick_victim(admit_seqs: Sequence[int]) -> Optional[int]:
        """LIFO eviction: the newest-admitted candidate.  The oldest
        request then always progresses, so any workload whose single worst
        request fits the pool terminates."""
        if not admit_seqs:
            return None
        return max(range(len(admit_seqs)), key=lambda i: admit_seqs[i])

    @staticmethod
    def pick_oldest(admit_seqs: Sequence[int]) -> Optional[int]:
        """Oldest-admitted candidate — the prefill-chunk order."""
        if not admit_seqs:
            return None
        return min(range(len(admit_seqs)), key=lambda i: admit_seqs[i])

    @staticmethod
    def decode_order(admit_seqs: Sequence[int]) -> List[int]:
        """Decode-batch service order: oldest first."""
        return sorted(range(len(admit_seqs)), key=lambda i: admit_seqs[i])

    @staticmethod
    def prefill_chunk_len(chunk: int, replay_len: int, start: int) -> int:
        """True (unpadded) token count of this tick's prefill chunk."""
        return min(chunk, replay_len - start)

    # -- fleet: routing + membership ----------------------------------------

    @staticmethod
    def route_least_loaded(loads: Sequence[Tuple[int, int]]
                           ) -> Optional[int]:
        """Least-loaded routing with stable ties: index of the minimum
        (load, replica_idx) pair."""
        if not loads:
            return None
        return min(range(len(loads)), key=lambda i: loads[i])

    @staticmethod
    def pick_kill_victim(loads: Sequence[Tuple[int, int]]
                         ) -> Optional[int]:
        """Chaos kill target: the most loaded candidate, ties to the
        lowest replica idx."""
        if not loads:
            return None
        return max(range(len(loads)),
                   key=lambda i: (loads[i][0], -loads[i][1]))

    @staticmethod
    def migration_action(state: str, has_pages: bool,
                         migratable: bool) -> str:
        """Per request on a replica kill: 'migrate' live KV when the pool
        is still addressable, 'reroute' a pageless request, 'replay'
        otherwise."""
        if (migratable and state in (SCHED_DECODE, SCHED_PREFILL)
                and has_pages):
            return "migrate"
        if not has_pages:
            return "reroute"
        return "replay"

    # -- autoscaler: CUSUM detection + action gates -------------------------

    @staticmethod
    def load_residual(queue_depth: float, target_per_decode: float,
                      n_decode: int) -> float:
        """Relative queue-depth excess over what the decode pool should
        absorb."""
        return queue_depth / (target_per_decode * n_decode) - 1.0

    @staticmethod
    def cusum_step(pos: float, neg: float, cooldown: int, resid: float,
                   drift: float, threshold: float, cooldown_steps: int
                   ) -> Tuple[float, float, int,
                              Optional[Tuple[str, float]]]:
        """One two-sided CUSUM update with hysteresis; a trip resets both
        sides and arms the cooldown."""
        if cooldown > 0:
            return pos, neg, cooldown - 1, None
        r = float(resid)
        pos = max(0.0, pos + r - drift)
        neg = max(0.0, neg + (-r) - drift)
        if pos >= threshold:
            trip = ("slow", pos)
        elif neg >= threshold:
            trip = ("fast", neg)
        else:
            return pos, neg, 0, None
        return 0.0, 0.0, cooldown_steps, trip

    @staticmethod
    def scale_up_fallback(n_prefill_pure: int, rebalance_idx: int) -> str:
        """With no spare device, a 'slow' trip rebalances a surplus
        pure-prefill replica (never the last one), else is suppressed."""
        return ("rebalance"
                if n_prefill_pure >= 2 and rebalance_idx >= 0
                else "suppress")

    @staticmethod
    def scale_down_ok(n_decode_pure: int, min_decode: int,
                      queue_depth: float, scale_in_idx: int) -> bool:
        """A 'fast' trip drains a pure decode replica only above the
        floor, with an empty queue, and with a valid target."""
        return (n_decode_pure > min_decode and queue_depth == 0
                and scale_in_idx >= 0)

    @staticmethod
    def shed_action(hold: bool, free_frac: float, lo: float,
                    hi: float) -> Optional[str]:
        """The admission shed valve's hysteresis band on the free-page
        fraction."""
        if not hold and free_frac < lo:
            return "shed_on"
        if hold and free_frac > hi:
            return "shed_off"
        return None


SCHED_RULES = SchedEmitter()
