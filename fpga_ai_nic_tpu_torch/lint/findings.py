"""The finding record shared by the H1 pass and the model checker — the
port of the part of the JAX package's ``lint/findings.py`` they use."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Tuple

# one-line docs keyed by code
RULE_DOCS: Dict[str, str] = {
    "R0": "suppression hygiene: disable= needs a '-- reason' and a known code",
    "H1": "happens-before/lockset: an instance attribute written from two "
          "threads (trainer / watchdog worker / background thread) needs a "
          "common lock",
    "M1": "model check: a protocol cell (or fixture) violated — deadlock, "
          "slot overwrite, ordering, credit safety, termination or DMA "
          "discipline",
    "M2": "model check: the static checksum-weight pass (odd, paired, "
          "program-distinct conservation weights) failed",
}

# the codes a ``# graftlint: disable=`` comment may name
AST_CODES: Tuple[str, ...] = ("R0", "H1")


@dataclass(frozen=True)
class Finding:
    """One diagnostic.  ``suppressed`` findings are reported but do not fail
    the run; a suppression must carry a reason (else the scan emits R0)."""

    code: str
    path: str
    line: int
    message: str
    suppressed: bool = False
    suppress_reason: str = field(default="", compare=False)

    def format(self) -> str:
        tag = " (suppressed: %s)" % self.suppress_reason if self.suppressed \
            else ""
        return f"{self.path}:{self.line}: {self.code}: {self.message}{tag}"
