"""repro_torch.analysis — the port's contracts, machine-checked.

Counterpart of ``repro/analysis``. The port's campaign engine rests on the
same invariants as the reference's: atomic-rename ticket lifecycles in
``CellQueue``, never-creating in-place lease writes, ``write_json_atomic``
for every supervisor-polled JSON file, seeded-RNG determinism in
``repro_torch.search``, and torch-free supervisor processes. This package
checks them over ``src/repro_torch``, two ways:

* **Invariant linter** (``repro_torch.analysis.lint`` +
  ``repro_torch.analysis.rules``) — an AST pass with rules RPR001–RPR006
  (see ``rules.RULES`` or README.md's port section for the table), run as
  ``python -m repro_torch.analysis.lint --baseline
  analysis_baseline_torch.json``. The baseline is a *ratchet*:
  pre-existing debt is tolerated, new violations fail, and debt that
  disappears auto-tightens the baseline. RPR004 keeps ``torch`` and
  ``triton`` out of the supervisors' top-level imports, where the
  reference's keeps out jax.

* **Queue-protocol race explorer** (``repro_torch.analysis.race``) — a
  bounded model checker for the port's ``CellQueue``: it runs the real
  ``acquire`` / ``renew`` / ``complete`` / ``steal`` / ``reclaim_expired``
  / ``release_owner`` implementations against an instrumented in-memory
  filesystem (rename/link/unlink as atomic steps), exhaustively
  enumerates interleavings up to a bounded schedule depth, and asserts
  the one-state-per-ticket, ticket-conservation, and exactly-once-complete
  invariants — printing a minimized counterexample schedule on failure.
  Run as ``python -m repro_torch.analysis.race``.

Pure stdlib — no torch, no third-party imports — so both tools run on
supervisor hosts and in bare CI jobs at interactive speed. (No eager
re-exports here: ``python -m repro_torch.analysis.lint`` must not
pre-import the module runpy is about to execute.)
"""
