"""``# graftlint: disable=RN -- reason`` suppression comments — the port
of the JAX package's ``lint/suppress.py``.

Grammar (one comment, same line as the finding or the line directly above,
or ``disable-file`` anywhere at module top level):

    # graftlint: disable=R2 -- trace-time constant, read once per process
    # graftlint: disable=R1,R3 -- <reason covering both>
    # graftlint: disable-file=R5 -- this whole tool is a fixture generator

The reason is MANDATORY: a bare disable is itself an R0 error, as is an
unknown rule code.  Suppressed findings still print (marked suppressed) so
a blanket-suppression drift is visible in every lint run.
"""

from __future__ import annotations

import io
import re
import tokenize
from dataclasses import dataclass
from typing import Dict, List, Set, Tuple

from .findings import AST_CODES, Finding

_PAT = re.compile(
    r"#\s*graftlint:\s*(disable(?:-file)?)\s*=\s*"
    r"([A-Za-z0-9,\s]+?)\s*(?:--\s*(\S.*?))?\s*$")


@dataclass
class Suppressions:
    # line -> (codes, reason); a finding at line L checks L then L-1
    by_line: Dict[int, Tuple[Set[str], str]]
    file_wide: Dict[str, str]          # code -> reason
    errors: List[Finding]              # R0 findings (bad suppressions)

    def lookup(self, code: str, line: int) -> Tuple[bool, str]:
        for ln in (line, line - 1):
            if ln in self.by_line:
                codes, reason = self.by_line[ln]
                if code in codes:
                    return True, reason
        if code in self.file_wide:
            return True, self.file_wide[code]
        return False, ""


def scan(path: str, text: str) -> Suppressions:
    sup = Suppressions(by_line={}, file_wide={}, errors=[])
    try:
        tokens = tokenize.generate_tokens(io.StringIO(text).readline)
        comments = [(t.start[0], t.string) for t in tokens
                    if t.type == tokenize.COMMENT]
    except (tokenize.TokenError, IndentationError, SyntaxError):
        comments = [(i + 1, line[line.index("#"):])
                    for i, line in enumerate(text.splitlines()) if "#" in line]
    for line_no, comment in comments:
        # only colon-marked directives are parsed; prose that merely
        # mentions the linter (docs, rule references) is not a directive
        if not re.search(r"graftlint\s*:", comment):
            continue
        m = _PAT.search(comment)
        if not m:
            sup.errors.append(Finding(
                "R0", path, line_no,
                "malformed graftlint directive (want "
                "'# graftlint: disable=RN -- reason'): %r" % comment.strip()))
            continue
        kind, codes_s, reason = m.group(1), m.group(2), m.group(3) or ""
        codes = {c.strip().upper() for c in codes_s.split(",") if c.strip()}
        bad = codes - set(AST_CODES)
        if bad:
            sup.errors.append(Finding(
                "R0", path, line_no,
                "unknown rule code(s) %s in graftlint disable"
                % ",".join(sorted(bad))))
            codes -= bad
        if not reason:
            sup.errors.append(Finding(
                "R0", path, line_no,
                "graftlint disable without a reason — add "
                "'-- <why this is safe>'"))
            continue       # a reasonless disable suppresses nothing
        if not codes:
            continue
        if kind == "disable-file":
            for c in codes:
                sup.file_wide[c] = reason
        else:
            cur, cur_reason = sup.by_line.get(line_no, (set(), reason))
            sup.by_line[line_no] = (cur | codes, cur_reason)
    return sup
