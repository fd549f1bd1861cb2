"""Static analysis for the port's HAM runtime: protocol linter + model checker.

The port of ``repro.analysis``, rule for rule: the same rule ids, titles,
exit codes and ``path:line:col: RULE message`` format.  Two differences:
HAM004 holds the port's own wire table (``repro_torch/core/flags.py``), and
HAM001 also knows how torch writes through and aliases memory (methods and
functions whose name ends in ``_``, views, methods that may return their
receiver, ``torch.from_numpy`` of a ``deref``'d array).

Two engines (see ``docs/static-analysis.md``):

* :mod:`repro_torch.analysis.hamlint` — AST-based protocol linter over
  every ``@handler`` / ``register(...)`` site.
  ``python -m repro_torch.analysis.hamlint src/repro_torch``.
* :mod:`repro_torch.analysis.modelcheck` — explicit-state
  exhaustive-interleaving checker for the torn-counter and doorbell
  protocols.  ``python -m repro_torch.analysis.modelcheck [--quick]``.

The HAM paper leans on the C++ type system to make handler dispatch safe at
compile time (§4); this package is the Python runtime's equivalent static
backstop, encoding the invariant classes behind every protocol bug this
codebase has shipped (PR 1 torn counters, PR 2 same-source divergence,
PR 5 undeclared-mutation replica divergence, PR 7 lost-wakeup races).
"""
