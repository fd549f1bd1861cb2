"""Step-function models of the runtime's shared-memory protocols.

Each model is a small explicit-state transition system consumed by
:mod:`repro_torch.analysis.modelcheck`.  The models do not re-invent the
protocols: layout offsets and step orders are imported from the
implementation modules (:mod:`repro_torch.comm.shm`, :mod:`repro_torch.comm.doorbell`)
so there is one source of truth — reordering the implementation reshapes
the model, and the checker catches the regression.

* :mod:`repro_torch.analysis.models.ring_counters` — torn 8-byte counter reads
  vs. the double-publish/confirm-compare mitigation (PR 1).
* :mod:`repro_torch.analysis.models.doorbell` — the arm/park/wake protocol and
  its two lost-wakeup windows (PR 7).
"""
