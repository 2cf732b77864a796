"""What the H1 lockset pass (``verify.lockset``) needs of the JAX package's
``lint/``: the parsed-module context (``engine.ModuleCtx``), the finding
record (``findings.Finding``) and the suppression-comment scan
(``suppress.scan``).  The JAX package's lint rules and its jaxpr plane
check JAX programs and have no counterpart here."""
