"""llmd-lint over the port: the reference's contract-lint framework
(``tools/llmd_lint``) as a standard-library copy, configured for
``llmd_tpu_torch/`` and taught PyTorch's device syncs.

Run the full suite with ``python -m llmd_tpu_torch.tools.llmd_lint`` (add
``--json`` for machine-readable output, ``--analyzer NAME`` to run a subset).
The annotation grammar is the reference's (``docs/static-analysis.md``):
``# guarded-by: <lock>`` and ``# llmd-lint: allow[<check>] <justification>``.
"""

from .core import AllowEntry, Finding, Project  # noqa: F401

ANALYZER_NAMES = ("locks", "hotpath", "env-contract", "metrics-contract",
                  "events-contract")
